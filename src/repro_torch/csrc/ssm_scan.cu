// Kernel K3 of the PyTorch port: the Mamba S6 selective scan for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::_scan_kernel.  Per
// (batch, channel d, state n), with the state h kept in fp32:
//
//     h_l = exp(dt_l[d] * A[d, n]) * h_{l-1} + (dt_l[d] * x_l[d]) * B_l[n]
//     y_l[d] = sum_n h_l[d, n] * C_l[n] + x_l[d] * D[d]
//
// x/dt (Bt, L, Dm) and B/C (Bt, L, N) fp32 or bf16; A (Dm, N) and D (Dm,)
// fp32; y (Bt, L, Dm) in the inputs' dtype, h_last (Bt, Dm, N) fp32; h
// starts at zero (no h0, as in the Pallas kernel).
//
// Bound.  At the main shape (Bt 1, L 2048, Dm 16384, N 16, bf16) the scan
// reads x and dt once (134.2 MB), writes y (67.1 MB) and moves A, D, B, C
// and h_last (2.2 MB): 203.5 MB, 0.061 ms at 3.35 TB/s.  It does about 6
// fp32 flops per (l, d, n), 3.2 GFLOP, 0.048 ms at 67 TFLOP/s.  So by the
// card's two peak rates it is bytes-bound.  The floor that is likely real
// is neither: its 537 M exps run on the special-function units, at 16 per
// SM per clock, roughly 0.13 ms on 132 SMs.  The design therefore keeps
// every exp to one ex2 (log2(e) is folded into A once, and the exp is
// exp2f) and keeps the loads off the dependent path.
//
// Design.  The TPU grid carried h (bd, N) across L-chunks in VMEM scratch;
// a GPU grid cannot carry anything between blocks, so the whole L loop runs
// inside one block with h in registers for the whole sequence.  The (d, n)
// recurrences are independent: a thread owns one channel and 4 of its
// states, the N/4 lanes of a channel are neighbours in a warp and finish
// y = h.C with a warp-shuffle sum.  A block of 128 threads owns 128*4/N
// channels (32 at N = 16: 512 blocks, about 15 warps per SM at the main
// shape).  Chunks of CT time steps of the block's x and dt columns and of
// the B and C rows (shared by every channel) are staged in shared memory,
// converted to fp32: each thread loads its part of chunk c+1 from device
// memory into registers (neighbouring threads on neighbouring channels, so
// the loads coalesce) before it steps through chunk c, and stores it to
// shared memory after, so the loads are in flight during the compute.  y is
// collected per chunk in shared memory and written out row by row, also
// coalesced.  Any L and any Dm are taken: rows past L and channels past Dm
// are masked, nothing is padded, and a partial last chunk is stepped only
// as far as L.  N in {4, 8, 16} is built.  Tensor cores do not apply: the
// scan is elementwise.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STATES_PER_LANE = 4;
constexpr int LOADS = 8;            // x (and dt) elements a thread stages per chunk
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// the kernel: one block per (CPB channels, batch row)
// ---------------------------------------------------------------------------

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dskip,
                T* __restrict__ y, float* __restrict__ h_last, int L,
                int Dm) {
  constexpr int LPC = N / STATES_PER_LANE;   // lanes per channel: 1, 2 or 4
  constexpr int CPB = THREADS / LPC;         // channels per block
  constexpr int CT = LOADS * LPC;            // time steps per chunk
  constexpr int BC = CT * N;                 // B (and C) elements per chunk
  constexpr int BC_LOADS = (BC + THREADS - 1) / THREADS;
  static_assert(N % STATES_PER_LANE == 0 && 32 % LPC == 0, "N");
  static_assert(CT * CPB == LOADS * THREADS, "chunk shape");
  __shared__ __align__(16) float sx[CT][CPB];
  __shared__ __align__(16) float sdt[CT][CPB];
  __shared__ __align__(16) float sb[CT][N];
  __shared__ __align__(16) float sc[CT][N];
  __shared__ float sy[CT][CPB];

  const int tid = threadIdx.x;
  const int j = tid / LPC;                   // this thread's channel in the block
  const int p = tid % LPC;                   // its lane in the channel
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + j;
  const int64_t b = blockIdx.y;
  const bool live = d < Dm;

  float a[STATES_PER_LANE], h[STATES_PER_LANE];
#pragma unroll
  for (int i = 0; i < STATES_PER_LANE; ++i) {
    a[i] = live ? A[static_cast<int64_t>(d) * N + p * STATES_PER_LANE + i] * LOG2E
                : 0.f;
    h[i] = 0.f;
  }
  const float dsk = live ? Dskip[d] : 0.f;

  // chunk c of x, dt, B and C into registers (raw, so the loads stay in
  // flight until the values are stored); masked elements are zero
  T rx[LOADS], rdt[LOADS], rb[BC_LOADS], rc[BC_LOADS];
  auto fetch = [&](int c) {
    const int t0 = c * CT;
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int e = tid + k * THREADS;
      const int l = t0 + e / CPB, dd = d0 + e % CPB;
      const bool ok = l < L && dd < Dm;
      const int64_t g = (b * L + l) * Dm + dd;
      rx[k] = ok ? x[g] : T(0.f);
      rdt[k] = ok ? dt[g] : T(0.f);
    }
#pragma unroll
    for (int k = 0; k < BC_LOADS; ++k) {
      const int e = tid + k * THREADS;
      const int l = t0 + e / N;
      const bool ok = e < BC && l < L;
      const int64_t g = (b * L + l) * N + e % N;
      rb[k] = ok ? Bm[g] : T(0.f);
      rc[k] = ok ? Cm[g] : T(0.f);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int e = tid + k * THREADS;
      sx[e / CPB][e % CPB] = to_f(rx[k]);
      sdt[e / CPB][e % CPB] = to_f(rdt[k]);
    }
#pragma unroll
    for (int k = 0; k < BC_LOADS; ++k) {
      const int e = tid + k * THREADS;
      if (e < BC) {
        sb[e / N][e % N] = to_f(rb[k]);
        sc[e / N][e % N] = to_f(rc[k]);
      }
    }
  };

  const int n_chunks = (L + CT - 1) / CT;
  fetch(0);
  stash();
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) fetch(c + 1);
    const int t0 = c * CT;
    const int steps = min(CT, L - t0);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float xv = sx[s][j];
      const float dv = sdt[s][j];
      const float4 bb =
          *reinterpret_cast<const float4*>(&sb[s][p * STATES_PER_LANE]);
      const float4 cc =
          *reinterpret_cast<const float4*>(&sc[s][p * STATES_PER_LANE]);
      const float dx = dv * xv;
      h[0] = fmaf(exp2f(dv * a[0]), h[0], dx * bb.x);
      h[1] = fmaf(exp2f(dv * a[1]), h[1], dx * bb.y);
      h[2] = fmaf(exp2f(dv * a[2]), h[2], dx * bb.z);
      h[3] = fmaf(exp2f(dv * a[3]), h[3], dx * bb.w);
      float acc = fmaf(h[0], cc.x, fmaf(h[1], cc.y,
                                        fmaf(h[2], cc.z, h[3] * cc.w)));
#pragma unroll
      for (int o = 1; o < LPC; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (p == 0) sy[s][j] = fmaf(xv, dsk, acc);
    }
    __syncthreads();              // sy complete; the staged chunk is read
#pragma unroll
    for (int k = 0; k < LOADS; ++k) {
      const int e = tid + k * THREADS;
      const int t = e / CPB, dd = d0 + e % CPB;
      if (t < steps && dd < Dm)
        store1(y + (b * L + t0 + t) * Dm + dd, sy[t][e % CPB]);
    }
    if (c + 1 < n_chunks) stash();
    __syncthreads();              // the next chunk is staged; sy is free
  }

  if (live) {
    float4* hb = reinterpret_cast<float4*>(
        h_last + (b * Dm + d) * N + p * STATES_PER_LANE);
    *hb = make_float4(h[0], h[1], h[2], h[3]);
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* h_last, int Bt, int L, int Dm,
                   cudaStream_t stream) {
  constexpr int CPB = THREADS / (N / STATES_PER_LANE);
  const dim3 grid((Dm + CPB - 1) / CPB, Bt);
  ssm_scan_kernel<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), h_last, L, Dm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int N, const void* x, const void* dt, const float* A,
                     const void* B, const void* C, const float* D, void* y,
                     float* h_last, int Bt, int L, int Dm, cudaStream_t st) {
  if (N == 4) return launch<T, 4>(x, dt, A, B, C, D, y, h_last, Bt, L, Dm, st);
  if (N == 8) return launch<T, 8>(x, dt, A, B, C, D, y, h_last, Bt, L, Dm, st);
  if (N == 16)
    return launch<T, 16>(x, dt, A, B, C, D, y, h_last, Bt, L, Dm, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype of x, dt, B, C and y: 0 = float32,
// 1 = bfloat16; A, D and h_last are float32.  Built N: 4, 8, 16.  L >= 1.
// ---------------------------------------------------------------------------

extern "C" {

int lego_ssm_scan(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* D, void* y, void* h_last,
                  int dtype, int Bt, int L, int Dm, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0)
    return launch_n<float>(N, x, dt, Af, B, C, Df, y, hl, Bt, L, Dm, st);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(N, x, dt, Af, B, C, Df, y, hl, Bt, L, Dm,
                                   st);
  return cudaErrorInvalidValue;
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

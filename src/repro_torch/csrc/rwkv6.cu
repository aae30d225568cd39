// Kernel K4 of the PyTorch port: the RWKV-6 ("Finch") wkv recurrence for
// Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py::_rwkv_kernel.  Per
// (batch, head), with a (Dk, Dv) state S kept in fp32:
//
//     o_t = r_t . (S + diag(u) k_t v_t^T)
//     S   = diag(w_t) S + k_t v_t^T
//
// r/k/w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk), fp32 or bf16; o (B, H, T,
// Dv) in the inputs' dtype, S_last (B, H, Dk, Dv) in fp32; S starts at zero.
//
// Bound: operations, at the fp32 rate (the state must stay fp32, so the
// CUDA cores do the work).  Per head and token the recurrence does 4*Dk*Dv
// flops (the r.S product and the S update; the u-term folds into one Dk-dot
// times v) on 2*(3*Dk + 2*Dv) bytes in bf16: 25.6 flops per byte at
// Dk = Dv = 64, above the H100's 67 TFLOP/s / 3.35 TB/s = 20.  At the main
// shape (B*H = 64, T = 2048, Dk = Dv = 64, bf16) that is 0.032 ms of
// operations against 0.025 ms of bytes.
//
// Design.  The TPU grid carried S across T-chunks in VMEM scratch; a GPU grid
// cannot carry anything between blocks, so the whole T loop runs inside one
// block with S in registers for the whole sequence.  Columns of S are
// independent (column j of S and o[:, j] need only v[:, j] besides r, k, w
// and u), so one head's state is split by column across COLS_PER_BLOCK-wide
// blocks (grid (Dv / 16, H, B): 256 blocks at the main shape instead of 64,
// so all 132 SMs work), and within a block each column is split over
// LANES_PER_COL = 4 neighbouring lanes that own Dk/4 rows each; a two-step
// warp-shuffle sum finishes o_t[j].  A lane's rows come in pairs interleaved
// with its neighbours' (rows 2*(q*4 + p) and +1 for lane p), so the four
// lanes of a column read four consecutive 4- or 8-byte words of shared
// memory: no bank conflicts, and each load brings two rows.  Chunks of CT
// time steps of r, k, w and of the block's v columns are staged in shared
// memory with 16-byte cp.async copies (coalesced, double buffered: the next
// chunk lands while this one is stepped through).  Any T is taken: the last
// chunk is partial and nothing past T is read or written.  Each block walks
// T dependent steps, so the kernel is latency-bound at small B*H; tensor
// cores and a chunked (matrix) form of the recurrence are later work.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int LANES_PER_COL = 4;    // lanes that share one column of S
constexpr int COLS_PER_BLOCK = 16;  // columns of S per block
constexpr int THREADS = LANES_PER_COL * COLS_PER_BLOCK;   // two warps

// ---------------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---------------------------------------------------------------------------
// the kernel: one block per (16 columns of S, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const T* __restrict__ u, T* __restrict__ o,
             float* __restrict__ s_last, int H, int Tlen) {
  constexpr int CT = 64 / sizeof(T);        // time steps per staged chunk
  constexpr int E = 16 / sizeof(T);         // elements per 16-byte copy
  constexpr int ROWS = DK / LANES_PER_COL;  // rows of S per lane
  constexpr int PAIRS = ROWS / 2;
  static_assert(ROWS % 2 == 0 && DV % COLS_PER_BLOCK == 0, "shape");
  static_assert((DK * sizeof(T)) % 16 == 0 && (COLS_PER_BLOCK * sizeof(T)) % 16 == 0,
                "rows must be whole 16-byte copies");
  __shared__ __align__(16) T sr[2][CT * DK];
  __shared__ __align__(16) T sk[2][CT * DK];
  __shared__ __align__(16) T sw[2][CT * DK];
  __shared__ __align__(16) T sv[2][CT * COLS_PER_BLOCK];

  const int tid = threadIdx.x;
  const int p = tid % LANES_PER_COL;
  const int jj = tid / LANES_PER_COL;
  const int col0 = blockIdx.x * COLS_PER_BLOCK;
  const int h = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + h;
  const int64_t row0 = bh * Tlen;           // first (b, h, t = 0) row

  // this lane's rows of S: 2*(q*LANES_PER_COL + p) + e, e in {0, 1}
  float S[ROWS], uu[ROWS];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * (q * LANES_PER_COL + p) + e;
      S[2 * q + e] = 0.f;
      uu[2 * q + e] = load1(u + static_cast<int64_t>(h) * DK + i);
    }
  }

  // stage chunk c (time steps c*CT ..) into buffer `buf`; rows past T are
  // not copied (and never read)
  auto stage = [&](int c, int buf) {
    const int t0 = c * CT;
    const int rows = min(CT, Tlen - t0);
    const int n_rkw = rows * DK / E;
    const int64_t g0 = (row0 + t0) * DK;
    for (int x = tid; x < n_rkw; x += THREADS) {
      cp_async16(&sr[buf][x * E], r + g0 + x * E);
      cp_async16(&sk[buf][x * E], k + g0 + x * E);
      cp_async16(&sw[buf][x * E], w + g0 + x * E);
    }
    constexpr int VP = COLS_PER_BLOCK / E;  // 16-byte copies per v row
    for (int x = tid; x < rows * VP; x += THREADS) {
      const int t = x / VP, piece = x % VP;
      cp_async16(&sv[buf][t * COLS_PER_BLOCK + piece * E],
                 v + (row0 + t0 + t) * DV + col0 + piece * E);
    }
    cp_async_commit();
  };

  const int n_chunks = (Tlen + CT - 1) / CT;
  T* ob = o + row0 * DV + col0 + jj;
  stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks)
      stage(c + 1, buf ^ 1);
    else
      cp_async_commit();          // an empty group keeps the wait uniform
    cp_async_wait_prev();
    __syncthreads();
    const int steps = min(CT, Tlen - c * CT);
    const T* cr = sr[buf];
    const T* ck = sk[buf];
    const T* cw = sw[buf];
    const T* cv = sv[buf];
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float vj = load1(cv + s * COLS_PER_BLOCK + jj);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int i = s * DK + 2 * (q * LANES_PER_COL + p);
        const float2 rr = load2(cr + i);
        const float2 kk = load2(ck + i);
        const float2 ww = load2(cw + i);
        const float kv0 = kk.x * vj, kv1 = kk.y * vj;
        acc = fmaf(rr.x, fmaf(uu[2 * q], kv0, S[2 * q]), acc);
        acc = fmaf(rr.y, fmaf(uu[2 * q + 1], kv1, S[2 * q + 1]), acc);
        S[2 * q] = fmaf(ww.x, S[2 * q], kv0);
        S[2 * q + 1] = fmaf(ww.y, S[2 * q + 1], kv1);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) store1(ob + static_cast<int64_t>(c * CT + s) * DV, acc);
    }
    __syncthreads();              // the buffer is refilled two chunks on
  }

  float* sb = s_last + bh * DK * DV + col0 + jj;
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * (q * LANES_PER_COL + p) + e;
      sb[i * DV] = S[2 * q + e];
    }
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* o, float* s_last, int B, int H,
                   int Tlen, cudaStream_t stream) {
  const dim3 grid(DV / COLS_PER_BLOCK, H, B);
  rwkv6_kernel<T, DK, DV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<T*>(o), s_last, H, Tlen);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dims(int Dk, int Dv, const void* r, const void* k,
                        const void* v, const void* w, const void* u, void* o,
                        float* s_last, int B, int H, int Tlen,
                        cudaStream_t st) {
  if (Dk == 16 && Dv == 16)
    return launch<T, 16, 16>(r, k, v, w, u, o, s_last, B, H, Tlen, st);
  if (Dk == 64 && Dv == 64)
    return launch<T, 64, 64>(r, k, v, w, u, o, s_last, B, H, Tlen, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Built head sizes: Dk = Dv in {16, 64}.  T >= 1.
// ---------------------------------------------------------------------------

extern "C" {

int lego_rwkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* o, void* s_last, int dtype, int B, int H,
               int T, int Dk, int Dv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sl = static_cast<float*>(s_last);
  if (dtype == 0)
    return launch_dims<float>(Dk, Dv, r, k, v, w, u, o, sl, B, H, T, st);
  if (dtype == 1)
    return launch_dims<__nv_bfloat16>(Dk, Dv, r, k, v, w, u, o, sl, B, H, T,
                                      st);
  return cudaErrorInvalidValue;
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Kernel K2 of the PyTorch port: streaming-softmax attention for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (the score-stationary fused attention of LEGO Fig. 10: QK^T and PV share the
// score tile on chip, with the softmax between them).  Two entry points:
//
//  * lego_flash_prefill — any Tq, Tk.  One block per (q-tile, q-head, batch);
//    the kv tiles are a loop inside the block (on the TPU they were the
//    sequential innermost grid axis, which has no counterpart on a GPU).
//    Running (m, l, acc) in fp32, scale D^-0.5 unless given, optional softcap
//    c*tanh(s/c), causal mask with an absolute offset, sliding window
//    kpos > qpos - window, kv tiles that the causal/window bounds exclude are
//    never visited, GQA reads kv head h / group without repeating KV, and
//    l == 0 -> 1.  Rows q >= Tq and keys k >= Tk are masked here (keys past Tk
//    get exactly zero weight), so the caller pads nothing.
//    Bound: operations (4*D flops per unmasked (q, k) pair, far above the
//    H100's bytes-per-flop line at D >= 64).  This first version computes on
//    the CUDA cores in fp32 from fp32 tiles in shared memory; each thread owns
//    a 4 x (bk/16) score micro-tile and a 4 x (D/16) output micro-tile so that
//    every shared-memory load feeds several FMAs, and rows are padded to
//    D + 1 floats so the micro-tile reads are free of bank conflicts.  Tensor
//    cores (wgmma), TMA and warp specialisation are later work.
//
//  * lego_flash_decode — Tq = 1 over a KV cache at a run-time position read
//    from device memory (the host never syncs on it).  One block per
//    (b, kv-head, slice of <= 4 query rows of the head's GQA group): at
//    Mistral-NeMo width the group is 4 rows, so each KV row is read once per
//    group.  Bound: bytes of KV read (each cache row is used for 4*G*D flops).
//    The design keeps many rows in flight: each warp (or, at D < 128, each
//    sub-warp of D/4 lanes, D/6 at D = 96) streams its own strided share of
//    the positions max(0, pos-window+1) .. pos, U rows at a time, with a
//    private online softmax; the partial (m, l, acc) of all warps are merged
//    in shared memory at the end.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;   // the finite mask value of the reference

// ---------------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void load2(const float* p, float (&o)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  o[0] = x.x; o[1] = x.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = x.x; o[1] = x.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float cap_score(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK>
struct PrefillSmem {
  static constexpr int QS = D + 1;    // padded row strides (bank-conflict free)
  static constexpr int KS = D + 1;
  static constexpr int SS = BK + 1;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QS;
  static constexpr int V_OFF = K_OFF + BK * KS;
  static constexpr int S_OFF = V_OFF + BK * D;
  static constexpr int M_OFF = S_OFF + BQ * SS;
  static constexpr int L_OFF = M_OFF + BQ;
  static constexpr int C_OFF = L_OFF + BQ;
  // keep in step with repro_torch/kernels/autotile.py::attention_smem_bytes
  static constexpr int BYTES = 4 * (C_OFF + BQ);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(4 * BQ)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int Hq, int Hkv, int Tq, int Tk, int causal, int window,
                     float softcap, float scale, int offset) {
  using L = PrefillSmem<D, BQ, BK>;
  constexpr int NT = 4 * BQ;    // threads: 4 per q row
  constexpr int CJ = BK / 16;   // score columns per thread
  constexpr int DJ = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem + L::Q_OFF;
  float* Ks = smem + L::K_OFF;
  float* Vs = smem + L::V_OFF;
  float* Ss = smem + L::S_OFF;
  float* m_s = smem + L::M_OFF;
  float* l_s = smem + L::L_OFF;
  float* c_s = smem + L::C_OFF;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const T* qb = q + ((size_t)b * Hq + h) * (size_t)Tq * D;
  const T* kb = k + ((size_t)b * Hkv + kvh) * (size_t)Tk * D;
  const T* vb = v + ((size_t)b * Hkv + kvh) * (size_t)Tk * D;
  T* ob = o + ((size_t)b * Hq + h) * (size_t)Tq * D;

  for (int idx = tid * 4; idx < BQ * D; idx += NT * 4) {
    const int r = idx / D, c = idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Tq) load4(qb + (size_t)(q0 + r) * D + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[r * L::QS + c + e] = x[e];
  }
  if (tid < BQ) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  // kv positions any real row of this tile may attend to: [k_lo, k_hi)
  const int qpos_first = q0 + offset;
  const int qpos_last = min(q0 + BQ, Tq) - 1 + offset;
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(k_hi, qpos_last + 1);
  if (window > 0) k_lo = max(0, qpos_first - window + 1);
  const int kt_lo = k_lo / BK;
  const int kt_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : kt_lo;

  const int rg = tid / 16;   // micro-tile rows rg*4 .. rg*4+3
  const int cg = tid % 16;   // micro-tile columns cg, cg+16, ...
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K/V/S are no longer read
    for (int idx = tid * 4; idx < BK * D; idx += NT * 4) {
      const int r = idx / D, c = idx % D;
      float xk[4] = {0.f, 0.f, 0.f, 0.f}, xv[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < Tk) {
        load4(kb + (size_t)(k0 + r) * D + c, xk);
        load4(vb + (size_t)(k0 + r) * D + c, xv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[r * L::KS + c + e] = xk[e];
        Vs[r * D + c + e] = xv[e];
      }
    }
    __syncthreads();

    // S = Q K^T on the 4 x CJ micro-tile, then scale, softcap and mask
    float s[4][CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(cg + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qpos = q0 + r + offset;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = cg + 16 * j;
        const int kpos = k0 + c;
        float x = cap_score(s[i][j] * scale, softcap);
        bool keep = true;
        if (causal) keep = kpos <= qpos;
        if (window > 0) keep = keep && (kpos > qpos - window);
        x = keep ? x : NEG_INF;
        if (kpos >= Tk) x = -INFINITY;   // padding: exactly zero weight
        Ss[r * L::SS + c] = x;
      }
    }
    __syncthreads();

    // online softmax, four threads per row
    {
      const int r = tid / 4, sub = tid % 4;
      float mx = -INFINITY;
      for (int c = sub; c < BK; c += 4) mx = fmaxf(mx, Ss[r * L::SS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = sub; c < BK; c += 4) {
        const float p = expf(Ss[r * L::SS + c] - m_new);
        Ss[r * L::SS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr * acc + P V on the 4 x DJ micro-tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[rg * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(rg * 4 + i) * L::SS + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();   // l_s is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (q0 + r >= Tq) continue;
    float l = l_s[r];
    l = (l == 0.f) ? 1.f : l;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store1(ob + (size_t)(q0 + r) * D + cg + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, void* o,
                           int B, int Hq, int Hkv, int Tq, int Tk, int causal,
                           int window, float softcap, float scale, int offset,
                           cudaStream_t stream) {
  constexpr int bytes = PrefillSmem<D, BQ, BK>::BYTES;
  auto kernel = flash_prefill_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, 4 * BQ, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Tq, Tk, causal,
      window, softcap, scale, offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t prefill_tiles(int bq, int bk, const void* q, const void* k,
                          const void* v, void* o, int B, int Hq, int Hkv,
                          int Tq, int Tk, int causal, int window, float softcap,
                          float scale, int offset, cudaStream_t st) {
#define LEGO_PREFILL(BQ_, BK_)                                                \
  if (bq == BQ_ && bk == BK_)                                                 \
    return launch_prefill<T, D, BQ_, BK_>(q, k, v, o, B, Hq, Hkv, Tq, Tk,     \
                                          causal, window, softcap, scale,     \
                                          offset, st);
  LEGO_PREFILL(16, 32) LEGO_PREFILL(16, 64)
  LEGO_PREFILL(32, 32) LEGO_PREFILL(32, 64)
  LEGO_PREFILL(64, 32) LEGO_PREFILL(64, 64)
#undef LEGO_PREFILL
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t prefill_dims(int D, int bq, int bk, const void* q, const void* k,
                         const void* v, void* o, int B, int Hq, int Hkv, int Tq,
                         int Tk, int causal, int window, float softcap,
                         float scale, int offset, cudaStream_t st) {
  switch (D) {
    case 16: return prefill_tiles<T, 16>(bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk, causal, window, softcap, scale, offset, st);
    case 32: return prefill_tiles<T, 32>(bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk, causal, window, softcap, scale, offset, st);
    case 64: return prefill_tiles<T, 64>(bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk, causal, window, softcap, scale, offset, st);
    case 96: return prefill_tiles<T, 96>(bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk, causal, window, softcap, scale, offset, st);
    case 128: return prefill_tiles<T, 128>(bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk, causal, window, softcap, scale, offset, st);
    case 256: return prefill_tiles<T, 256>(bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk, causal, window, softcap, scale, offset, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_ROWS = 4;   // query rows per block

// A kv row is split over LANES lanes, which must divide the warp (the
// shuffle sums run within aligned groups of LANES).  D = 96 takes 16 lanes
// of 6 elements (with 4 elements a row would need 24 lanes).
template <int D>
struct DecodeShape {
  static constexpr int EPL =                          // elements per lane
      D >= 128 ? D / 32 : (D == 96 ? 6 : 4);
  static constexpr int VEC = EPL % 4 == 0 ? 4 : 2;    // elements per load
  static constexpr int LANES = D / EPL;               // lanes per kv row
  static constexpr int SLOTS = 32 / LANES;            // kv rows per warp step
  static constexpr int U = 32 / EPL;                  // steps in flight
  static constexpr int PARTS = DEC_WARPS * SLOTS;     // partial softmaxes
  static_assert(D % EPL == 0 && EPL % VEC == 0 && 32 % LANES == 0,
                "decode shape");
};

template <int V, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&o)[V]) {
  if constexpr (V == 4) load4(p, o); else load2(p, o);
}

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ pos_ptr, int Hq, int Hkv, int S,
                    int window, float softcap, float scale) {
  using DS = DecodeShape<D>;
  constexpr int EPL = DS::EPL, VEC = DS::VEC, LANES = DS::LANES;
  constexpr int SLOTS = DS::SLOTS;
  constexpr int U = DS::U, PARTS = DS::PARTS, R = DEC_ROWS;
  __shared__ float m_sm[PARTS][R];
  __shared__ float l_sm[PARTS][R];
  __shared__ float acc_sm[PARTS][R][D];

  const int group = Hq / Hkv;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, group - row0);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slot = lane / LANES, d0 = (lane % LANES) * EPL;
  const int part = warp * SLOTS + slot;

  const int pos = *pos_ptr;
  const int hi = min(pos, S - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;

  const T* kb = k + ((size_t)b * Hkv + kvh) * (size_t)S * D;
  const T* vb = v + ((size_t)b * Hkv + kvh) * (size_t)S * D;
  float qr[R][EPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t h = (size_t)kvh * group + row0 + r;
#pragma unroll
    for (int e = 0; e < EPL; e += VEC) {
      float x[VEC] = {};
      if (r < nrows) loadv<VEC>(q + ((size_t)b * Hq + h) * D + d0 + e, x);
#pragma unroll
      for (int t = 0; t < VEC; ++t) qr[r][e + t] = x[t];
    }
  }

  float m[R], l[R], acc[R][EPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  // every lane runs the same trip count: the shuffles below need the warp
  constexpr int STRIDE = DEC_WARPS * SLOTS;
  for (int base = lo + warp * SLOTS; base <= hi; base += STRIDE * U) {
    float kx[U][EPL], vx[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + slot + u * STRIDE;
#pragma unroll
      for (int e = 0; e < EPL; e += VEC) {
        float xk[VEC] = {}, xv[VEC] = {};
        if (p <= hi) {
          loadv<VEC>(kb + (size_t)p * D + d0 + e, xk);
          loadv<VEC>(vb + (size_t)p * D + d0 + e, xv);
        }
#pragma unroll
        for (int t = 0; t < VEC; ++t) { kx[u][e + t] = xk[t]; vx[u][e + t] = xv[t]; }
      }
    }
    float s[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part_dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part_dot = fmaf(qr[r][e], kx[u][e], part_dot);
#pragma unroll
        for (int off = LANES / 2; off > 0; off /= 2)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
        const bool valid = base + slot + u * STRIDE <= hi;
        s[u][r] = valid ? cap_score(part_dot * scale, softcap) : -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      const float corr = expf(m[r] - mx);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u][r] - mx);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vx[u][e], acc[r][e]);
      }
      m[r] = mx;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane % LANES == 0) { m_sm[part][r] = m[r]; l_sm[part][r] = l[r]; }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc_sm[part][r][d0 + e] = acc[r][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nrows * D; idx += DEC_THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = NEG_INF;
    for (int w = 0; w < PARTS; ++w) mx = fmaxf(mx, m_sm[w][r]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < PARTS; ++w) {
      const float c = expf(m_sm[w][r] - mx);
      lsum += l_sm[w][r] * c;
      osum += acc_sm[w][r][d] * c;
    }
    lsum = (lsum == 0.f) ? 1.f : lsum;
    const size_t h = (size_t)kvh * group + row0 + r;
    store1(o + ((size_t)b * Hq + h) * D + d, osum / lsum);
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, void* o,
                          const void* pos, int B, int Hq, int Hkv, int S,
                          int window, float softcap, float scale,
                          cudaStream_t stream) {
  const int group = Hq / Hkv;
  const dim3 grid((group + DEC_ROWS - 1) / DEC_ROWS, Hkv, B);
  flash_decode_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<const int*>(pos), Hq, Hkv, S, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decode_dims(int D, const void* q, const void* k, const void* v,
                        void* o, const void* pos, int B, int Hq, int Hkv, int S,
                        int window, float softcap, float scale,
                        cudaStream_t st) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, o, pos, B, Hq, Hkv, S, window, softcap, scale, st);
    case 32: return launch_decode<T, 32>(q, k, v, o, pos, B, Hq, Hkv, S, window, softcap, scale, st);
    case 64: return launch_decode<T, 64>(q, k, v, o, pos, B, Hq, Hkv, S, window, softcap, scale, st);
    case 96: return launch_decode<T, 96>(q, k, v, o, pos, B, Hq, Hkv, S, window, softcap, scale, st);
    case 128: return launch_decode<T, 128>(q, k, v, o, pos, B, Hq, Hkv, S, window, softcap, scale, st);
    case 256: return launch_decode<T, 256>(q, k, v, o, pos, B, Hq, Hkv, S, window, softcap, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window, softcap <= 0 means no softcap.
// ---------------------------------------------------------------------------

extern "C" {

int lego_flash_prefill(const void* q, const void* k, const void* v, void* o,
                       int dtype, int B, int Hq, int Hkv, int Tq, int Tk, int D,
                       int bq, int bk, int causal, int window, float softcap,
                       float scale, int offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return prefill_dims<float>(D, bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk,
                               causal, window, softcap, scale, offset, st);
  if (dtype == 1)
    return prefill_dims<__nv_bfloat16>(D, bq, bk, q, k, v, o, B, Hq, Hkv, Tq,
                                       Tk, causal, window, softcap, scale,
                                       offset, st);
  return cudaErrorInvalidValue;
}

int lego_flash_decode(const void* q, const void* k, const void* v, void* o,
                      const void* pos, int dtype, int B, int Hq, int Hkv, int S,
                      int D, int window, float softcap, float scale,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return decode_dims<float>(D, q, k, v, o, pos, B, Hq, Hkv, S, window,
                              softcap, scale, st);
  if (dtype == 1)
    return decode_dims<__nv_bfloat16>(D, q, k, v, o, pos, B, Hq, Hkv, S,
                                      window, softcap, scale, st);
  return cudaErrorInvalidValue;
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

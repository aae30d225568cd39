// Kernel K2 of the PyTorch port: streaming-softmax attention for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (the score-stationary fused attention of LEGO Fig. 10: QK^T and PV share the
// score tile on chip, with the softmax between them).  What every entry point
// computes is the reference's: scale D^-0.5 unless given, optional softcap
// c*tanh(s/c) after the scale, a causal mask at an absolute offset, a sliding
// window kpos > qpos - window, kv head h / (Hq/Hkv) without repeating KV,
// running (m, l, acc) in fp32 and l == 0 -> 1.  Kv tiles that the causal and
// window bounds exclude are never loaded.  Ragged Tq and Tk are masked here:
// keys at kpos >= Tk get exactly zero weight, rows q >= Tq are not stored,
// and the caller pads nothing.  Two entry points:
//
//  * lego_flash_prefill — any Tq, Tk.  One block per (q tile, q head, batch);
//    the kv tiles are a loop inside the block (on the TPU they were the
//    sequential innermost grid axis, which has no counterpart on a GPU).
//    Bound: operations (4*D flops per unmasked (q, k) pair, far above the
//    H100's ~295 flops per byte at D >= 64).  One route per dtype:
//
//    - bf16: tensor cores (flash_prefill_tc_kernel).  Each consumer
//      warpgroup owns 64 q rows; one producer warp issues TMA loads: Q once,
//      then K and V tiles through a ring of TC_STAGES stages with full and
//      empty mbarriers.  S = Q K^T is a wgmma.mma_async m64 n(BK) k16 with
//      both operands in shared memory (K-major); the scale, softcap, masks
//      and online softmax run on the fp32 accumulator registers, the row max
//      and sum reduced over the 4 threads that share a row; P is rounded to
//      bf16 in registers (the reference's p.astype(v.dtype)) and O += P V is
//      a wgmma m64 n(D) k16 with P from registers and V (stored (Tk, D))
//      from shared memory through the descriptor's transpose bit.  O stays
//      in fp32 registers, is divided by l and rounded to bf16 once.  The
//      tensor maps are 3-D (D, T, B*H), so a tile past T is zero-filled by
//      the copy engine and never reads the next head's rows; the output is
//      stored from registers row by row under the Tq mask.  Q tiles are
//      launched in reverse order, so the causal tiles with the most kv tiles
//      start first.  Of the tiles (bq, bk) in {64, 128}^2, autotile
//      builds those whose layout fits 227 KB and whose accumulators fit the
//      registers a thread gets; at D = 256 (a 64 x 256 fp32 O, 128
//      registers a thread) that is only bq = bk = 64, one consumer
//      warpgroup with up to 255 registers a thread, so no register
//      reallocation (setmaxnreg) is needed.
//    - fp32: CUDA-core FMAs (flash_prefill_f32_kernel).  wgmma takes fp32
//      operands only as TF32 (10-bit mantissa), which fails the fp32 gate
//      (2e-4 against the plain version) and the fp32 decode-vs-forward
//      checks, so fp32 stays in full fp32 here: a choice by dtype, not a
//      fallback (no bf16 input ever reaches this kernel).  Each
//      thread owns a 4 x (bk/16) score micro-tile and a 4 x (D/16) output
//      micro-tile, tiles are staged as fp32 rows padded to D + 1 floats.
//
//  * lego_flash_decode — Tq = 1 over a KV cache at a run-time position read
//    from device memory (the host never syncs on it, so a step that calls
//    it can be captured in a CUDA graph).  Bound: bytes of KV read (each
//    cache row is used for 4*G*D flops, G the rows of a GQA group), so the
//    arithmetic is fp32 on the CUDA cores in both dtypes.  Split KV
//    (flash-decoding), so that a batch of a few sequences over a few kv
//    heads still fills 132 SMs: the cache is cut into `splits` chunks of
//    `chunk` positions, both from the shapes alone
//    (repro_torch/kernels/autotile.py::decode_splits), and one block of 4
//    warps takes (a slice of <= R rows of a GQA group, a kv head, a batch
//    row, a chunk), so a kv row is read once per (b, kv head) at groups up
//    to 8 (autotile.decode_rows).  In the block a kv row is spread over a
//    power of two of lanes in 16-byte pieces; each lane copies its own
//    pieces of the rows it will use into a ring of shared memory with
//    cp.async, several stages ahead, so the loads stay in flight while it
//    computes and no barrier is needed in the loop.  Each warp slot keeps
//    an online softmax over its strided share of the chunk's rows within
//    max(0, pos-window+1) .. min(pos, S-1), in log2 units, rescaling acc
//    only when the running max grows by more than 2^8; the partial dot
//    products of a step's rows are summed over a row's lanes by a
//    reduce-scatter, so that each lane finishes and exponentiates only its
//    share of the scores, and the p are then shared by shuffles for P V.
//    The slots' (m, l, acc) are merged by shuffles, the warps' in shared
//    memory.  A block
//    whose chunk lies wholly outside that range writes an empty partial
//    (m = NEG_INF, l = 0, acc = 0).  With one split the block writes o;
//    else it writes its partial, in fp32, to a workspace the caller passes
//    (B*Hq*splits*(D + 2) floats), and a combine kernel launched after it
//    on the same stream (a programmatic dependent launch, so its launch
//    overlaps the split kernel's tail) merges the splits of each
//    (b, q head): M = max m_i, l = sum l_i e^(m_i - M) (0 -> 1),
//    o = sum acc_i e^(m_i - M) / l, rounded to o's dtype once.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (or the error of a refused set-up) so that a failure is
// reported to the caller.
//
// Which prefill tiles are instantiated is decided in Python
// (repro_torch/kernels/autotile.py::attention_built_tiles): _build.py
// includes a generated header before this file that lists them by dtype as
// LEGO_F32_TILES(X) and LEGO_BF16_TILES(X), X(D, bq, bk) a tile.  Each
// layout's static_assert refuses a listed tile that does not fit.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#if !defined(LEGO_F32_TILES) || !defined(LEGO_BF16_TILES)
#error "build with repro_torch.kernels._build, which includes the tile lists"
#endif

namespace {

constexpr float NEG_INF = -1e30f;   // the finite mask value of the reference
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one sm_90 block

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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float cap_score(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// the scaled, capped and masked score of one (q, k) pair, as the reference
// computes it: NEG_INF where causal/window mask it, -inf (zero weight) past Tk
__device__ __forceinline__ float masked_score(float s, int qpos, int kpos,
                                              int Tk, int causal, int window,
                                              float softcap, float scale) {
  float x = cap_score(s * scale, softcap);
  bool keep = true;
  if (causal) keep = kpos <= qpos;
  if (window > 0) keep = keep && (kpos > qpos - window);
  x = keep ? x : NEG_INF;
  return kpos >= Tk ? -INFINITY : x;
}

// the kv tiles [kt_lo, kt_hi) that rows q0 .. q_end-1 may attend to
__device__ __forceinline__ void kv_tile_range(int q0, int q_end, int Tk, int bk,
                                              int causal, int window,
                                              int offset, int& kt_lo,
                                              int& kt_hi) {
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(k_hi, q_end - 1 + offset + 1);
  if (window > 0) k_lo = max(0, q0 + offset - window + 1);
  kt_lo = k_lo / bk;
  kt_hi = k_hi > k_lo ? (k_hi + bk - 1) / bk : kt_lo;
}

// ---------------------------------------------------------------------------
// prefill, fp32: CUDA cores
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
  static_assert(BYTES <= SMEM_LIMIT, "fp32 tile exceeds the shared memory");
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(4 * BQ)
flash_prefill_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int Hq, int Hkv, int Tq, int Tk, int causal,
                         int window, float softcap, float scale, int offset) {
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
  const float* qb = q + ((size_t)b * Hq + h) * (size_t)Tq * D;
  const float* kb = k + ((size_t)b * Hkv + kvh) * (size_t)Tk * D;
  const float* vb = v + ((size_t)b * Hkv + kvh) * (size_t)Tk * D;
  float* ob = o + ((size_t)b * Hq + h) * (size_t)Tq * D;

  for (int idx = tid * 4; idx < BQ * D; idx += NT * 4) {
    const int r = idx / D, c = idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Tq) load4(qb + (size_t)(q0 + r) * D + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[r * L::QS + c + e] = x[e];
  }
  if (tid < BQ) { m_s[tid] = NEG_INF; l_s[tid] = 0.f; }

  int kt_lo, kt_hi;
  kv_tile_range(q0, min(q0 + BQ, Tq), Tk, BK, causal, window, offset, kt_lo,
                kt_hi);

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
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = cg + 16 * j;
        Ss[r * L::SS + c] = masked_score(s[i][j], q0 + r + offset, k0 + c, Tk,
                                         causal, window, softcap, scale);
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
      ob[(size_t)(q0 + r) * D + cg + 16 * j] = acc[i][j] / l;
  }
}

template <int D, int BQ, int BK>
cudaError_t launch_prefill_f32(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Tq, int Tk,
                               int causal, int window, float softcap,
                               float scale, int offset, cudaStream_t stream) {
  constexpr int bytes = PrefillSmem<D, BQ, BK>::BYTES;
  auto kernel = flash_prefill_f32_kernel<D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, 4 * BQ, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Tq, Tk,
      causal, window, softcap, scale, offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// prefill, bf16: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int TC_STAGES = 2;      // K/V ring depth (autotile.ATTN_STAGES)

constexpr int tc_swizzle_width(int D) {   // elements of one swizzled row
  return D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
}

// Shared memory of one block.  Every tile is stored as D/W column blocks of
// rows x W elements, W*2 bytes a row, in the copy engine's W*2-byte swizzle
// (W = 64, 32 or 16 elements: the 128-, 64- or 32-byte swizzle), which is
// the canonical layout wgmma reads: K-major for Q and K, MN-major for V.
template <int D, int BQ, int BK>
struct TcLayout {
  static constexpr int W = tc_swizzle_width(D);
  static constexpr int SWIZZLE_BYTES = 2 * W;
  static constexpr int NWG = BQ / 64;                // consumer warpgroups
  static constexpr int THREADS = NWG * 128 + 32;     // + one producer warp
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;        // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;      // TC_STAGES K tiles
  static constexpr int V_OFF = K_OFF + TC_STAGES * KV_BYTES;
  // barriers: q_full, then k_full, v_full and empty for each stage
  static constexpr int BAR_OFF = V_OFF + TC_STAGES * KV_BYTES;
  // + 1024 bytes to align the base to the 128-byte swizzle's 1024-byte
  // period; keep in step with autotile.py::attention_smem_bytes
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * TC_STAGES) + 1024;
  static_assert(BYTES <= SMEM_LIMIT, "bf16 tile exceeds the shared memory");
  static_assert(BQ % 64 == 0 && BK % 16 == 0 && D % 16 == 0, "tc tile");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tc alignment");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1: 128 B, 2: 64 B, 3: 32 B)
template <int SWIZZLE_BYTES>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  constexpr uint64_t layout =
      SWIZZLE_BYTES == 128 ? 1 : (SWIZZLE_BYTES == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

#define LEGO_F8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                 \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 64) += A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : LEGO_F8(0), LEGO_F8(8), LEGO_F8(16), LEGO_F8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// S (64 x 128) += A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : LEGO_F8(0), LEGO_F8(8), LEGO_F8(16), LEGO_F8(24), LEGO_F8(32),
        LEGO_F8(40), LEGO_F8(48), LEGO_F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x 16) += A (64 x 16, registers) * B (16 x 16, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : LEGO_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : LEGO_F8(0), LEGO_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : LEGO_F8(0), LEGO_F8(8), LEGO_F8(16), LEGO_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 96) += A (64 x 16, registers) * B (16 x 96, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : LEGO_F8(0), LEGO_F8(8), LEGO_F8(16), LEGO_F8(24), LEGO_F8(32),
        LEGO_F8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : LEGO_F8(0), LEGO_F8(8), LEGO_F8(16), LEGO_F8(24), LEGO_F8(32),
        LEGO_F8(40), LEGO_F8(48), LEGO_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O (64 x 256) += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : LEGO_F8(0), LEGO_F8(8), LEGO_F8(16), LEGO_F8(24), LEGO_F8(32),
        LEGO_F8(40), LEGO_F8(48), LEGO_F8(56), LEGO_F8(64), LEGO_F8(72),
        LEGO_F8(80), LEGO_F8(88), LEGO_F8(96), LEGO_F8(104), LEGO_F8(112),
        LEGO_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


#undef LEGO_F8

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(TcLayout<D, BQ, BK>::THREADS, 1)
flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Tq,
                        int Tk, int causal, int window, float softcap,
                        float scale, int offset) {
  using L = TcLayout<D, BQ, BK>;
  constexpr int W = L::W;
  constexpr int ROW = 2 * W;        // bytes of one swizzled row
  constexpr int SBO = 8 * ROW;      // 8-row groups
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + TC_STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * TC_STAGES + s); };
  auto k_s = [&](int s) { return base + L::K_OFF + s * L::KV_BYTES; };
  auto v_s = [&](int s) { return base + L::V_OFF + s * L::KV_BYTES; };

  // the causal tiles with the most kv tiles are launched first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  int kt_lo, kt_hi;
  kv_tile_range(q0, min(q0 + BQ, Tq), Tk, BK, causal, window, offset, kt_lo,
                kt_hi);
  const int n_tiles = kt_hi - kt_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), L::NWG * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == L::NWG * 4) {
    // producer: Q once, then K and V tile by tile through the ring
    if (lane == 0) {
      const int bh_q = b * Hq + h, bh_kv = b * Hkv + kvh;
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / W; ++c)
        tma_load(q_s + c * BQ * ROW, &q_map, q_full, c * W, q0, bh_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % TC_STAGES;
        const int k0 = (kt_lo + i) * BK;
        mbar_wait(empty(s), ((i / TC_STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / W; ++c)
          tma_load(k_s(s) + c * BK * ROW, &k_map, k_full(s), c * W, k0, bh_kv);
        mbar_expect_tx(v_full(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / W; ++c)
          tma_load(v_s(s) + c * BK * ROW, &v_map, v_full(s), c * W, k0, bh_kv);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread holds
  // rows r and r + 8 of its warp's 16, at columns 8 j + 2 (lane % 4) + {0, 1}
  const int wg = warp / 4;
  const int row = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int qpos[2] = {row + offset, row + 8 + offset};
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % TC_STAGES;
    const uint32_t parity = (i / TC_STAGES) & 1;
    const int k0 = (kt_lo + i) * BK;

    // S = Q K^T: D/16 steps of k16, K-major operands
    float s_acc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s_acc[j] = 0.f;
    fence_regs(s_acc);
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / W, e = kk * 16 % W;
      const uint64_t a = wgmma_desc<L::SWIZZLE_BYTES>(
          q_s + c * BQ * ROW + 64 * wg * ROW + 2 * e, 16, SBO);
      const uint64_t bd = wgmma_desc<L::SWIZZLE_BYTES>(
          k_s(s) + c * BK * ROW + 2 * e, 16, SBO);
      wgmma_ss(s_acc, a, bd, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // scale, softcap, masks and the online softmax on the registers
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int kpos = k0 + 8 * j + 2 * (lane % 4) + (x & 1);
        float& sv = s_acc[4 * j + x];
        sv = masked_score(sv, qpos[x >> 1], kpos, Tk, causal, window, softcap,
                          scale);
        mx[x >> 1] = fmaxf(mx[x >> 1], sv);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p = __expf(s_acc[4 * j + x] - m[x >> 1]);
        s_acc[4 * j + x] = p;
        sum[x >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = corr[r] * l[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) o_acc[4 * j + x] *= corr[x >> 1];

    // P as bf16 A fragments: the accumulator layout of keys 16 kk .. + 15
    // is the register-A layout of k step kk
    uint32_t p_frag[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        p_frag[kk][x] = pack_bf16(s_acc[8 * kk + 2 * x],
                                  s_acc[8 * kk + 2 * x + 1]);

    // O += P V: BK/16 steps of k16, V MN-major (transposed descriptor):
    // 8-key groups ROW * 8 apart, W-wide column blocks BK * ROW apart
    fence_regs(o_acc);
    mbar_wait(v_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o_acc, p_frag[kk], wgmma_desc<L::SWIZZLE_BYTES>(
                                      v_s(s) + kk * 16 * ROW, BK * ROW, SBO));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: divide by l (l == 0 -> 1), round to bf16, store rows < Tq
  __nv_bfloat16* ob = o + ((size_t)b * Hq + h) * (size_t)Tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= Tq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow = ob + (size_t)(row + 8 * r) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * r] * inv,
                                o_acc[4 * j + 2 * r + 1] * inv);
  }
}

// cuTensorMapEncodeTiled (libcuda), looked up through the runtime's
// entry-point query, so that nothing links against libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (D, T, BH) bf16 tensor (rows of D contiguous) read in boxes of W x rows
// x 1; coordinates past T read as zero, so a box never crosses into the
// next head
bool encode_map(CUtensorMap* map, const void* ptr, int D, int T, int BH,
                int W, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int BQ, int BK>
cudaError_t launch_prefill_tc(const void* q, const void* k, const void* v,
                              void* o, int B, int Hq, int Hkv, int Tq, int Tk,
                              int causal, int window, float softcap,
                              float scale, int offset, cudaStream_t stream) {
  using L = TcLayout<D, BQ, BK>;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, q, D, Tq, B * Hq, L::W, BQ) ||
      !encode_map(&k_map, k, D, Tk, B * Hkv, L::W, BK) ||
      !encode_map(&v_map, v, D, Tk, B * Hkv, L::W, BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_prefill_tc_kernel<D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Tq, Tk,
      causal, window, softcap, scale, offset);
  return cudaGetLastError();
}

// one route per dtype: fp32 on the CUDA cores, bf16 on the tensor cores, at
// the tiles of the generated lists; *kernel is set to the kernel launched
// (0: flash_prefill_f32_kernel, 1: flash_prefill_tc_kernel)
cudaError_t prefill_tiles(int dtype, int D, int bq, int bk, const void* q,
                          const void* k, const void* v, void* o, int B, int Hq,
                          int Hkv, int Tq, int Tk, int causal, int window,
                          float softcap, float scale, int offset,
                          cudaStream_t st, int* kernel) {
#define LEGO_PREFILL(DTYPE_, LAUNCH_, D_, BQ_, BK_)                            \
  if (dtype == DTYPE_ && D == D_ && bq == BQ_ && bk == BK_) {                 \
    *kernel = DTYPE_;                                                         \
    return LAUNCH_<D_, BQ_, BK_>(q, k, v, o, B, Hq, Hkv, Tq, Tk, causal,      \
                                 window, softcap, scale, offset, st);         \
  }
#define LEGO_F32(D_, BQ_, BK_) LEGO_PREFILL(0, launch_prefill_f32, D_, BQ_, BK_)
#define LEGO_BF16(D_, BQ_, BK_) LEGO_PREFILL(1, launch_prefill_tc, D_, BQ_, BK_)
  LEGO_F32_TILES(LEGO_F32)
  LEGO_BF16_TILES(LEGO_BF16)
#undef LEGO_BF16
#undef LEGO_F32
#undef LEGO_PREFILL
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// decode: split-KV (flash-decoding), then a combine pass
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_RING_BYTES = 48 * 1024;   // the cp.async ring of a block
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_SPLITS = 1024;            // autotile.decode_splits: <= 528
constexpr float LOG2E = 1.4426950408889634f;
// a row's reference max moves only when a score passes it by more than
// this (log2 units): p and l then stay below 2^8 times their exact sizes,
// which fp32 holds, and most steps skip the rescale of acc
constexpr float RESCALE_SLACK = 8.f;

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// A kv row is spread over LANES lanes (a power of two, so that the shuffle
// sums run within aligned groups), E = 8 elements each: one 16-byte piece
// in bf16, two in fp32.  A lane's piece j holds elements
// d0 + j*LANES*PER .. + PER, d0 = (lane % LANES)*PER, so that the LANES
// lanes of a row copy one contiguous span per instruction; a piece past D
// (at D = 96) is held by no lane.  SLOTS rows share a warp step, U steps
// make a stage of the ring (2 at 8 rows, where q and acc take 128
// registers, and in fp32), and the ring holds as many stages as
// DEC_RING_BYTES allows.  (16 elements a lane measured slower: twice the
// registers for q and acc, so fewer blocks fit an SM.)
template <typename T, int D, int R>
struct DecodeShape {
  static constexpr int E = 8;
  static constexpr int PER = 16 / (int)sizeof(T);   // elements a piece
  static constexpr int CH = E / PER;                 // pieces a lane-row
  static constexpr int LANES = pow2_at_least(D / E);
  static constexpr int SPAN = LANES * PER;           // elements a piece step
  static constexpr int SLOTS = 32 / LANES;
  static constexpr int STRIDE = DEC_WARPS * SLOTS;  // rows a block step
  static constexpr int U = (CH == 1 && R < 8) ? 4 : 2;
  // one stage: U rows of K and V a lane, CH pieces each
  static constexpr int STAGE_BYTES = DEC_THREADS * U * 2 * CH * 16;
  static constexpr int NS = DEC_RING_BYTES / STAGE_BYTES;
  static constexpr int MERGE_BYTES = 4 * DEC_WARPS * R * (D + 2);
  static constexpr int BYTES =
      MERGE_BYTES > DEC_RING_BYTES ? MERGE_BYTES : DEC_RING_BYTES;
  static_assert(D % E == 0 && E % PER == 0 && LANES <= 32 && NS >= 2,
                "decode shape");
  static_assert(BYTES <= 48 * 1024, "decode shared memory is static");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  // src-size 0 zero-fills the 16 bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the elements of one 16-byte piece as fp32
__device__ __forceinline__ void unpack16(const uint4& raw, const float*,
                                         float* o) {
  o[0] = __uint_as_float(raw.x); o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z); o[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw,
                                         const __nv_bfloat16*, float* o) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a lane's E elements from its pieces in the ring, where the 32 lanes'
// pieces lie side by side (so the reads are free of bank conflicts)
template <typename T, int E>
__device__ __forceinline__ void unpack_row(const uint4* p, float (&o)[E]) {
  constexpr int PER = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < E / PER; ++j)
    unpack16(p[32 * j], static_cast<const T*>(nullptr), o + j * PER);
}

// a[i] for a run-time i, and a[i] += x, without indexing registers at run
// time (which would put the array in local memory)
template <int R>
__device__ __forceinline__ float pick(const float (&a)[R], int i) {
  float x = a[0];
#pragma unroll
  for (int k = 1; k < R; ++k) x = k == i ? a[k] : x;
  return x;
}

template <int R>
__device__ __forceinline__ void add_at(float (&a)[R], int i, float x) {
#pragma unroll
  for (int k = 0; k < R; ++k) a[k] += k == i ? x : 0.f;
}

// Sums CNT values a lane holds over the lanes whose bits B, B/2, .., 1 differ
// (a group of 2B lanes), leaving each lane a share of the sums: while it
// holds two or more, a lane sends the half its bit B does not keep and adds
// the half its partner sends; past that, plain butterfly sums.  A lane g of
// the group ends with max(1, CNT / 2B) sums, those of indices j + K*(g / G)
// (K the count it keeps, G = max(1, 2B / CNT) lanes holding the same ones).
template <int CNT, int B, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (B >= 1) {
    if constexpr (CNT >= 2) {
      constexpr int H = CNT / 2;
      const bool upper = lane & B;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = upper ? v[j] : v[j + H];
        const float keep = upper ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, B);
      }
      reduce_scatter<H, B / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], B);
      reduce_scatter<1, B / 2>(v, lane);
    }
  }
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;          // partials (splits > 1): acc, then m, then l
  const int* pos;
  int B, Hq, Hkv, S, chunk, splits, window;
  float softcap, scale;
};

// One block per (slice of R query rows of a GQA group, kv head, batch x
// split c): it streams the cache rows [c*chunk, (c+1)*chunk) within
// [lo, hi] and writes its (m, l, acc) in fp32 to the workspace, or, when
// there is one split, o itself.  Scores and m are kept in log2 units (the
// scale times log2 e), so every exponential is one exp2.
//
// The rows reach shared memory through a ring of NS stages of cp.async
// copies that each lane issues for the 16-byte pieces it alone reads back:
// no barrier is needed in the loop, and NS - 1 stages stay in flight while
// the lane computes on the oldest.
template <typename T, int D, int R>
__global__ void __launch_bounds__(DEC_THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ ws,
                          const int* __restrict__ pos_ptr, int Hq, int Hkv,
                          int S, int chunk, int splits, int window,
                          float softcap, float scale) {
  using DS = DecodeShape<T, D, R>;
  constexpr int LANES = DS::LANES, SLOTS = DS::SLOTS;
  constexpr int STRIDE = DS::STRIDE, U = DS::U, CH = DS::CH, NS = DS::NS;
  constexpr int E = DS::E, PER = DS::PER, SPAN = DS::SPAN;
  // after the reduce-scatter a lane holds K of the slot's N = U*R scores,
  // and G lanes hold the same K
  constexpr int N = U * R;
  constexpr int K = N >= LANES ? N / LANES : 1;
  constexpr int G = N >= LANES ? 1 : LANES / N;
  __shared__ __align__(16) unsigned char smem[DS::BYTES];

  const int group = Hq / Hkv;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, group - row0);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / splits, c = blockIdx.z % splits;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slot = lane / LANES, d0 = (lane % LANES) * PER;
  auto holds = [&](int j) { return d0 + j * SPAN < D; };
  const int own = (lane % LANES) / G, src0 = slot * LANES;
  const bool counts = (lane % LANES) % G == 0;
  // (b, first q head of the block): o's row, and the partials' row / splits
  const size_t bh0 = (size_t)b * Hq + (size_t)kvh * group + row0;
  const size_t BH = (size_t)(gridDim.z / splits) * Hq;
  float* acc_ws = ws;
  float* m_ws = ws + BH * splits * D;
  float* l_ws = m_ws + BH * splits;

  const int pos = *pos_ptr;
  const int hi = min(min(pos, S - 1), (c + 1) * chunk - 1);
  const int lo = max(window > 0 ? max(0, pos - window + 1) : 0, c * chunk);
  if (lo > hi) {   // the chunk lies outside [lo, hi]: an empty partial
    for (int idx = threadIdx.x; idx < nrows * D; idx += DEC_THREADS) {
      if (splits == 1) {
        store1(o + (bh0 + idx / D) * D + idx % D, 0.f);
        continue;
      }
      const size_t pi = (bh0 + idx / D) * splits + c;
      if (idx % D == 0) { m_ws[pi] = NEG_INF; l_ws[pi] = 0.f; }
      acc_ws[pi * D + idx % D] = 0.f;
    }
    return;
  }

  const T* kb = k + ((size_t)b * Hkv + kvh) * (size_t)S * D;
  const T* vb = v + ((size_t)b * Hkv + kvh) * (size_t)S * D;
  // this lane's first piece of stage st, step u, K (kv = 0) or V (kv = 1)
  const uint4* ring = reinterpret_cast<const uint4*>(smem)
                      + warp * NS * U * 2 * CH * 32 + lane;
  auto piece = [&](int st, int u, int kv) {
    return ring + ((st * U + u) * 2 + kv) * CH * 32;
  };
  // every lane of a warp runs the same trip count: the shuffles need it
  const int first = lo + warp * SLOTS;
  const int n_it = first <= hi ? (hi - first) / (STRIDE * U) + 1 : 0;
  auto issue = [&](int it) {
    if (it < n_it) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = first + it * STRIDE * U + slot + u * STRIDE;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const bool full = holds(j) && p <= hi;
          const size_t off = full ? (size_t)p * D + d0 + j * SPAN : 0;
          cp_async16(smem_addr(piece(it % NS, u, 0) + 32 * j), kb + off,
                     full);
          cp_async16(smem_addr(piece(it % NS, u, 1) + 32 * j), vb + off,
                     full);
        }
      }
    }
    cp_async_commit();   // empty past the end, so the group count holds
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) issue(st);

  float qr[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float x[PER] = {};
      if (holds(j) && r < nrows)
        unpack16(*reinterpret_cast<const uint4*>(q + (bh0 + r) * D + d0
                                                 + j * SPAN), q, x);
#pragma unroll
      for (int e = 0; e < PER; ++e) qr[r][j * PER + e] = x[e];
    }

  float m[R], l[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    issue(it + NS - 1);
    cp_async_wait<NS - 1>();
    const int st = it % NS;
    const int base = first + it * STRIDE * U;
    // partial dots of this lane's elements, n = u*R + r, then summed over
    // the slot's lanes, each lane keeping K of the N scores
    float s[N];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[E];
      unpack_row<T, E>(piece(st, u, 0), kx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[r][e], kx[e], dot);
        s[u * R + r] = dot;
      }
    }
    reduce_scatter<N, LANES / 2>(s, lane);
    bool grow = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int n = j + K * own;
      const bool valid = base + slot + (n / R) * STRIDE <= hi;
      s[j] = valid ? cap_score(s[j] * scale, softcap) * LOG2E : -INFINITY;
      grow |= s[j] > pick(m, n % R) + RESCALE_SLACK;
    }
    // the slot's reference max moves (the first step; later, rarely): every
    // lane gathers the slot's N scores
    if (__any_sync(0xffffffffu, grow)) {
      float mx[R];
#pragma unroll
      for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
#pragma unroll
      for (int n = 0; n < N; ++n)
        mx[n % R] = fmaxf(mx[n % R], __shfl_sync(0xffffffffu, s[n % K],
                                                 src0 + (n / K) * G));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float mn = mx[r] > m[r] + RESCALE_SLACK ? mx[r] : m[r];
        const float corr = exp2f(m[r] - mn);
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= corr;
        m[r] = mn;
      }
    }
    // p for this lane's scores (l counts each score on one lane only), then
    // every p of the slot for P V
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int r = (j + K * own) % R;
      s[j] = exp2f(s[j] - pick(m, r));
      if (counts) add_at(l, r, s[j]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vx[E];
      unpack_row<T, E>(piece(st, u, 1), vx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = u * R + r;
        const float p = __shfl_sync(0xffffffffu, s[n % K],
                                    src0 + (n / K) * G);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vx[e], acc[r][e]);
      }
    }
  }

  // l is summed over the slot's lanes
#pragma unroll
  for (int off = 1; off < LANES; off *= 2)
#pragma unroll
    for (int r = 0; r < R; ++r)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

  // merge the SLOTS partials of a warp by shuffles (lanes LANES apart hold
  // the same elements of other rows), then the warps' in shared memory,
  // which the ring no longer uses once every warp is past its loop
#pragma unroll
  for (int off = LANES; off < 32; off *= 2)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float cs = exp2f(m[r] - mn), co = exp2f(mo - mn);
      l[r] = l[r] * cs + lo_ * co;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] = acc[r][e] * cs
                    + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * co;
      m[r] = mn;
    }
  cp_async_wait<0>();
  __syncthreads();
  float* m_sm = reinterpret_cast<float*>(smem);   // [DEC_WARPS][R]
  float* l_sm = m_sm + DEC_WARPS * R;              // [DEC_WARPS][R]
  float* acc_sm = l_sm + DEC_WARPS * R;            // [DEC_WARPS][R][D]
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        m_sm[warp * R + r] = m[r];
        l_sm[warp * R + r] = l[r];
      }
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (holds(j)) {
#pragma unroll
          for (int e = 0; e < PER; ++e)
            acc_sm[(warp * R + r) * D + d0 + j * SPAN + e] =
                acc[r][j * PER + e];
        }
    }
  }
  __syncthreads();
  // the combine kernel may be scheduled from here (it waits for the grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  for (int idx = threadIdx.x; idx < nrows * D; idx += DEC_THREADS) {
    const int r = idx / D, d = idx % D;
    float mb = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mb = fmaxf(mb, m_sm[w * R + r]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float cw = exp2f(m_sm[w * R + r] - mb);
      lsum += l_sm[w * R + r] * cw;
      osum += acc_sm[(w * R + r) * D + d] * cw;
    }
    if (splits == 1) {
      lsum = (lsum == 0.f) ? 1.f : lsum;
      store1(o + (bh0 + r) * D + d, osum / lsum);
      continue;
    }
    const size_t pi = (bh0 + r) * splits + c;
    if (d == 0) { m_ws[pi] = mb; l_ws[pi] = lsum; }
    acc_ws[pi * D + d] = osum;
  }
}

// One block per (b, q head): M = max_i m_i, w_i = e^(m_i - M) (an exp2: m
// is in log2 units), l = sum_i l_i w_i (0 -> 1), then o = sum_i acc_i w_i /
// l for each of the D elements, rounded to o's dtype once.  An empty
// partial (m = NEG_INF, l = 0, acc = 0) adds nothing.  Launched as a
// programmatic dependent of the split kernel: it may start before that
// grid ends and waits for it (and its writes) first.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
flash_decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                            int BH, int D, int splits) {
  __shared__ float w_sm[MAX_SPLITS];
  __shared__ float l_sm[MAX_SPLITS];
  __shared__ float red[COMBINE_THREADS / 32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* acc = ws + (size_t)bh * splits * D;
  const float* m = ws + (size_t)BH * splits * D + (size_t)bh * splits;
  const float* l = m + (size_t)BH * splits;

  float mx = NEG_INF;
  for (int i = tid; i < splits; i += COMBINE_THREADS) {
    w_sm[i] = m[i];
    l_sm[i] = l[i];
    mx = fmaxf(mx, w_sm[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < COMBINE_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  float lsum = 0.f;
  for (int i = tid; i < splits; i += COMBINE_THREADS) {
    const float ci = exp2f(w_sm[i] - mx);
    w_sm[i] = ci;
    lsum = fmaf(l_sm[i], ci, lsum);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  lsum = 0.f;
#pragma unroll
  for (int w = 0; w < COMBINE_THREADS / 32; ++w) lsum += red[w];
  lsum = (lsum == 0.f) ? 1.f : lsum;

  for (int d = tid; d < D; d += COMBINE_THREADS) {
    float osum = 0.f;
#pragma unroll 8
    for (int i = 0; i < splits; ++i)
      osum = fmaf(acc[(size_t)i * D + d], w_sm[i], osum);
    store1(o + (size_t)bh * D + d, osum / lsum);
  }
}

template <typename T, int D, int R>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  const int group = a.Hq / a.Hkv;
  const dim3 grid((group + R - 1) / R, a.Hkv, a.B * a.splits);
  flash_decode_split_kernel<T, D, R><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.ws, a.pos, a.Hq,
      a.Hkv, a.S, a.chunk, a.splits, a.window, a.softcap, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  // a programmatic dependent launch: the combine's launch overlaps the
  // split kernel's last blocks
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hq);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<T>,
                            static_cast<const float*>(a.ws),
                            static_cast<T*>(a.o), a.B * a.Hq, D, a.splits);
}

template <typename T, int D>
cudaError_t decode_rows(int rows, const DecodeArgs& a, cudaStream_t st) {
  switch (rows) {
    case 1: return launch_decode<T, D, 1>(a, st);
    case 2: return launch_decode<T, D, 2>(a, st);
    case 4: return launch_decode<T, D, 4>(a, st);
    case 8: return launch_decode<T, D, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t decode_dims(int D, int rows, const DecodeArgs& a,
                        cudaStream_t st) {
  switch (D) {
    case 16: return decode_rows<T, 16>(rows, a, st);
    case 32: return decode_rows<T, 32>(rows, a, st);
    case 64: return decode_rows<T, 64>(rows, a, st);
    case 96: return decode_rows<T, 96>(rows, a, st);
    case 128: return decode_rows<T, 128>(rows, a, st);
    case 256: return decode_rows<T, 256>(rows, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace


// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window, softcap <= 0 means no softcap.  The prefill
// writes the kernel it launched to *kernel (0: CUDA cores, 1: tensor cores).
// The decode takes its rows per block (1, 2, 4 or 8), chunk and splits from
// repro_torch/kernels/autotile.py (splits = ceil(S / chunk), at least 1) and,
// when splits > 1, a workspace of B*Hq*splits*(D + 2) floats.
// ---------------------------------------------------------------------------

extern "C" {

int lego_flash_prefill(const void* q, const void* k, const void* v, void* o,
                       int dtype, int B, int Hq, int Hkv, int Tq, int Tk, int D,
                       int bq, int bk, int causal, int window, float softcap,
                       float scale, int offset, void* stream, int* kernel) {
  *kernel = -1;
  return prefill_tiles(dtype, D, bq, bk, q, k, v, o, B, Hq, Hkv, Tq, Tk,
                       causal, window, softcap, scale, offset,
                       static_cast<cudaStream_t>(stream), kernel);
}

int lego_flash_decode(const void* q, const void* k, const void* v, void* o,
                      const void* pos, void* ws, int dtype, int B, int Hq,
                      int Hkv, int S, int D, int rows, int chunk, int splits,
                      int window, float softcap, float scale, void* stream) {
  if (chunk < 1 || splits != (S > chunk ? (S + chunk - 1) / chunk : 1)
      || splits > MAX_SPLITS || (splits > 1 && ws == nullptr)
      || B * splits > 65535 || Hkv < 1
      || Hq % Hkv)
    return cudaErrorInvalidValue;
  const DecodeArgs a{q, k, v, o, static_cast<float*>(ws),
                     static_cast<const int*>(pos), B, Hq, Hkv, S, chunk,
                     splits, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return decode_dims<float>(D, rows, a, st);
  if (dtype == 1) return decode_dims<__nv_bfloat16>(D, rows, a, st);
  return cudaErrorInvalidValue;
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

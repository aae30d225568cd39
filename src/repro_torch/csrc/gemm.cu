// Kernel K1 of the PyTorch port: the GEMM-JK tile, O = X W, for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/gemm.py::_gemm_kernel (LEGO's
// GEMM-JK, output-stationary design): X (M, K) times W (K, N) gives O (M, N)
// in X's dtype, fp32 or bf16.  On the TPU the grid was (M/bm, N/bn, K/bk)
// with K innermost and an fp32 accumulator tile resident in VMEM across the
// K sweep, cast to the output dtype on the last K step.  Here a block walks
// the K sweep of its output tile itself (a GPU grid carries nothing from one
// block to the next, so K is a loop inside the block) with the fp32
// accumulator in registers, and the output is rounded to its dtype once.
//
// Bound: operations for large products (2*M*N*K flops on 2*(MK + KN + MN)
// bytes in bf16: ~1,300 flops per byte at (2048 x 5120) . (5120 x 14336),
// far above the H100's ~295), bytes for decode-shaped ones (M <= 16).
//
// Three kernels, chosen by dtype and operand shape inside lego_gemm:
//  * gemm_bf16_wgmma_kernel (bf16, K % 8 == 0, N % 8 == 0, 16-byte-aligned
//    operands: what TMA takes).  Persistent and warp-specialised: min(work
//    units, SMs) blocks of three warpgroups walk the output tiles in a
//    grouped raster (GROUP_M tiles of M swept along N, so the W panels are
//    reused from L2).  One thread of the producer warpgroup issues TMA loads
//    of the X tile (128 x 64, K-major) and the W tile (64 x BN from the
//    row-major (K, N) W: the MN-major B operand) into a ring of STAGES
//    stages with full/empty mbarriers, running ahead into the next tile
//    while the consumers write the last one back.  Two consumer warpgroups
//    (64 rows each) run wgmma.mma_async m64nBNk16 from the 128-byte-swizzled
//    shared tiles, keep one k-step of products in flight (wait_group 1) and
//    release a stage once the products that read it have retired.  The
//    producer gives its registers to the consumers (setmaxnreg 40 / 232):
//    BN = 256 holds 128 fp32 accumulators a consumer thread.  The epilogue
//    rounds a tile into a shared staging tile, WG_EPI columns a pass, and
//    TMA stores write it while the next tile's products start.  TMA
//    zero-fills loads past M, N and K and skips stores past M and N.
//    Bound on this card: at the bf16 peak the products read ~80 bytes of
//    shared memory a clock and the TMA ring writes ~47, beside the SM's
//    128 (PERF.md, section 6).
//  * gemm_bf16_kernel (bf16 operands TMA cannot take): warp-level
//    mma.sync.m16n8k16 with ldmatrix fragments from a two-stage cp.async
//    ring, at the same tile, with element-wise loads.
//  * gemm_f32_kernel: true fp32 FMA on the CUDA cores (wgmma takes fp32
//    only as TF32): 256 threads, each with a (BM/16) x (BN/16) register
//    micro-tile, from a two-stage cp.async ring; element-wise loads where a
//    row is not whole 16-byte chunks or an operand is misaligned.
//
// Split-K.  When the output tiles are fewer than the SMs, the caller
// (repro_torch/kernels/autotile.py::gemm_splits) splits the K sweep into
// `splits` ranges of whole k-steps: range z covers steps [z*nk/splits,
// (z+1)*nk/splits).  Each range writes its fp32 partial tile to a
// workspace of splits*M*N floats, and gemm_combine_kernel, launched on the
// same stream as a programmatic dependent, sums the partials in the order
// z = 0, 1, ... and rounds once to X's dtype: no atomics, so two calls give
// the same bits.
//
// Which tiles are instantiated, the bf16 ring depth and the epilogue's
// columns a pass are decided in Python (repro_torch/kernels/autotile.py):
// _build.py includes a generated header before this file that lists them
// as LEGO_GEMM_F32_TILES(X), X(bm, bn, bk), and LEGO_GEMM_BF16_TILES(X),
// X(bm, bn, bk, stages), and defines LEGO_GEMM_EPI_COLS.  Each layout's
// static_assert refuses a listed tile that does not fit.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of a refused set-up) so that a
// failure is reported.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

#if !defined(LEGO_GEMM_F32_TILES) || !defined(LEGO_GEMM_BF16_TILES) || \
    !defined(LEGO_GEMM_EPI_COLS)
#error "build with repro_torch.kernels._build, which includes the tile lists"
#endif

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one sm_90 block

// first k-step of split z of `splits` over nk steps (the split's end is the
// next split's start): balanced, and no split is empty when splits <= nk
__device__ __forceinline__ int split_start(int z, int nk, int splits) {
  return static_cast<int>(static_cast<int64_t>(z) * nk / splits);
}

// ---------------------------------------------------------------------------
// copies (the cp.async kernels)
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; src_bytes = 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Fill the 16-byte shared chunk dst with the first `valid` (0 <= valid <=
// E = 16 / sizeof(T)) elements of src and zeros after; src is a valid
// global address even where valid = 0.  ALIGNED: valid is 0 or E and src
// is 16-byte aligned, so one cp.async moves the chunk; otherwise element by
// element.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int valid) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (ALIGNED) {
    cp_async16(dst, src, valid > 0 ? 16 : 0);
  } else {
    using Raw = typename std::conditional<sizeof(T) == 4, uint32_t,
                                          uint16_t>::type;
    const Raw* s = reinterpret_cast<const Raw*>(src);
    alignas(16) Raw tmp[E];
#pragma unroll
    for (int e = 0; e < E; ++e) tmp[e] = e < valid ? s[e] : Raw(0);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(tmp);
  }
}

// Stage the X tile (rows m0.., columns k0..) and the W tile (rows k0..,
// columns n0..) into shared memory; SA and SB are the padded row strides.
template <typename T, bool ALIGNED, int BM, int BN, int BK, int SA, int SB,
          int NT>
__device__ __forceinline__ void stage_tiles(T* As, T* Bs, const T* X,
                                            const T* W, int M, int N, int K,
                                            int m0, int n0, int k0, int tid) {
  constexpr int E = 16 / sizeof(T);
  constexpr int ACH = BK / E, BCH = BN / E;   // chunks per tile row
  for (int x = tid; x < BM * ACH; x += NT) {
    const int r = x / ACH, c = (x % ACH) * E;
    const int m = m0 + r, k = k0 + c;
    const int valid = m < M ? max(0, min(E, K - k)) : 0;
    copy_chunk<T, ALIGNED>(As + r * SA + c,
                           valid > 0 ? X + (int64_t)m * K + k : X, valid);
  }
  for (int x = tid; x < BK * BCH; x += NT) {
    const int r = x / BCH, c = (x % BCH) * E;
    const int k = k0 + r, n = n0 + c;
    const int valid = k < K ? max(0, min(E, N - n)) : 0;
    copy_chunk<T, ALIGNED>(Bs + r * SB + c,
                           valid > 0 ? W + (int64_t)k * N + n : W, valid);
  }
}

// ---------------------------------------------------------------------------
// bf16, operands TMA cannot take: mma.sync.m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
struct Bf16Tile {
  static constexpr int WM = BM < 64 ? BM : 64;   // rows per warp
  static constexpr int WN = 32;                  // columns per warp
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int NT = 32 * (BM / WM) * (BN / WN);
  static constexpr int SA = BK + 8, SB = BN + 8;   // padded strides
  static constexpr int STAGE = BM * SA + BK * SB;  // elements per stage
  static constexpr int BYTES = 2 * STAGE * 2;      // two stages
  static_assert(BM % WM == 0 && BN % WN == 0 && BK % 16 == 0, "tile");
  static_assert(NT <= 1024 && BYTES <= SMEM_LIMIT, "mma.sync tile");
};

// one output tile of one K range; with a workspace (split-K) the fp32
// partial goes to ws, else the rounded tile to O.  Only operands TMA cannot
// take come here, so the loads are element-wise.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Bf16Tile<BM, BN, BK>::NT)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ X,
                 const __nv_bfloat16* __restrict__ W,
                 __nv_bfloat16* __restrict__ O, float* __restrict__ ws, int M,
                 int N, int K) {
  using L = Bf16Tile<BM, BN, BK>;
  constexpr int MI = L::MI, NI = L::NI, SA = L::SA, SB = L::SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / (BN / L::WN)) * L::WM;
  const int wn0 = (warp % (BN / L::WN)) * L::WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  const int kt_lo = split_start(blockIdx.z, nk, gridDim.z);
  const int kt_hi = split_start(blockIdx.z + 1, nk, gridDim.z);
  auto stage = [&](int kt) {
    __nv_bfloat16* As = smem + (kt & 1) * L::STAGE;
    stage_tiles<__nv_bfloat16, false, BM, BN, BK, SA, SB, L::NT>(
        As, As + BM * SA, X, W, M, N, K, m0, n0, kt * BK, tid);
    cp_async_commit();
  };
  stage(kt_lo);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    if (kt + 1 < kt_hi)
      stage(kt + 1);
    else
      cp_async_commit();          // an empty group keeps the wait uniform
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* As = smem + (kt & 1) * L::STAGE;
    const __nv_bfloat16* Bs = As + BM * SA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // lane l addresses row l % 16, column (l / 16) * 8 of a 16 x 16 block
      const int lr = lane % 16, lc = (lane / 16) * 8;
      unsigned a[MI][4], b[NI / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], As + (wm0 + i * 16 + lr) * SA + kk + lc);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        ldmatrix_x4_trans(b[j], Bs + (kk + lr) * SB + wn0 + j * 16 + lc);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2],
                   b[j / 2][(j % 2) * 2 + 1]);
    }
    __syncthreads();              // the stage is refilled two steps on
  }

  // accumulator layout: c0, c1 at (g, 2t), (g, 2t + 1); c2, c3 eight rows on
  const int g = lane / 4, t = lane % 4;
  const bool pairs = (N % 2) == 0;   // a bf16x2 store is 4-byte aligned
  float* part = ws ? ws + (int64_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + 8 * h;
        const int n = n0 + wn0 + j * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
        if (part) {
          float* p = part + (int64_t)m * N + n;
          p[0] = x0;
          if (n + 1 < N) p[1] = x1;
          continue;
        }
        __nv_bfloat16* p = O + (int64_t)m * N + n;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
        } else {
          p[0] = __float2bfloat16(x0);
          if (n + 1 < N) p[1] = __float2bfloat16(x1);
        }
      }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;   // 16 x 16

template <int BM, int BN, int BK>
struct F32Tile {
  static constexpr int TM = BM / 16, TN = BN / 16;   // micro-tile
  static constexpr int SA = BK + 4, SB = BN + 4;     // padded strides
  static constexpr int STAGE = BM * SA + BK * SB;
  static constexpr int BYTES = 2 * STAGE * 4;        // two stages
  static_assert(BM % 16 == 0 && (TN == 4 || TN == 8) && BK % 4 == 0, "tile");
  static_assert(BYTES <= SMEM_LIMIT, "fp32 tile exceeds the shared memory");
};

template <int BM, int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(F32_THREADS)
gemm_f32_kernel(const float* __restrict__ X, const float* __restrict__ W,
                float* __restrict__ O, float* __restrict__ ws, int M, int N,
                int K) {
  using L = F32Tile<BM, BN, BK>;
  constexpr int TM = L::TM, TN = L::TN, SA = L::SA, SB = L::SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  const int kt_lo = split_start(blockIdx.z, nk, gridDim.z);
  const int kt_hi = split_start(blockIdx.z + 1, nk, gridDim.z);
  auto stage = [&](int kt) {
    float* As = smem + (kt & 1) * L::STAGE;
    stage_tiles<float, ALIGNED, BM, BN, BK, SA, SB, F32_THREADS>(
        As, As + BM * SA, X, W, M, N, K, m0, n0, kt * BK, tid);
    cp_async_commit();
  };
  stage(kt_lo);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    if (kt + 1 < kt_hi)
      stage(kt + 1);
    else
      cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* As = smem + (kt & 1) * L::STAGE;
    const float* Bs = As + BM * SA;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * SA + k];
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(Bs + k * SB + 64 * j + 4 * tx);
        b[4 * j] = v.x; b[4 * j + 1] = v.y; b[4 * j + 2] = v.z; b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = ws ? ws + (int64_t)blockIdx.z * M * N : O;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + 64 * (j / 4) + 4 * tx + j % 4;
      if (n < N) out[(int64_t)m * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma: persistent, warp-specialised, fed by TMA
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BK = 64;   // two consumer warpgroups of 64 rows
constexpr int WG_THREADS = 384;          // consumers 0-1, producer 2
constexpr int GROUP_M = 8;               // M tiles per band of the raster
constexpr int WG_EPI = LEGO_GEMM_EPI_COLS;   // output columns staged a pass
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared memory of one block: STAGES x (X tile, W tile), the staging tile
// of the epilogue, then the full and empty barriers.  The X tile is 128
// rows of 64 elements (128 bytes, the 128-byte swizzle); the W tile is
// BN/64 column blocks of 64 k-rows x 64 elements, 8 KB apart, each in the
// same swizzle: the canonical K-major layout for A and MN-major layout for
// B.  The staging tile holds WG_EPI columns of the 128 output rows in bf16,
// as WG_EPI/64 column blocks of 128 rows x 128 bytes in the same swizzle,
// which TMA stores read.  1024 bytes align the base to the swizzle's
// period; keep in step with autotile.py::gemm_smem_bytes.
template <int BN, int STAGES>
struct WgLayout {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;
  static constexpr int B_BLOCK = WG_BK * 128;        // one 64-column block
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI = BN < WG_EPI ? BN : WG_EPI;   // columns a pass
  static constexpr int EPI_OFF = STAGES * STAGE_BYTES;
  static constexpr int EPI_BLOCK = WG_BM * 128;      // one 64-column block
  static constexpr int BAR_OFF = EPI_OFF + (EPI / 64) * EPI_BLOCK;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(BN == 128 || BN == 256, "wgmma tile: BN is 128 or 256");
  static_assert(BN % EPI == 0 && EPI % 64 == 0, "epilogue passes");
  static_assert(STAGES >= 3, "the ring keeps at least three stages");
  static_assert(BYTES <= SMEM_LIMIT, "wgmma tile exceeds the shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Lane q of a quad holds v[i] from column block i; afterwards it holds
// block q, v[p] from lane p: a 4 x 4 transpose by two butterfly exchanges.
// Every lane of the warp takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int lane) {
  const bool hi2 = lane & 2, hi1 = lane & 1;
  uint32_t s0 = hi2 ? v[0] : v[2], s1 = hi2 ? v[1] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi2) { v[0] = s0; v[1] = s1; } else { v[2] = s0; v[3] = s1; }
  s0 = hi1 ? v[0] : v[1];
  s1 = hi1 ? v[2] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (hi1) { v[0] = s0; v[2] = s1; } else { v[1] = s0; v[3] = s1; }
}

// work unit u of a block: output tile (m0, n0) and its k-steps [k_lo, k_hi).
// Units are split-major; tiles run in bands of GROUP_M tiles of M, each band
// swept along N.
struct Unit {
  int m0, n0, split, k_lo, k_hi;
};

__device__ __forceinline__ Unit unit_at(int u, int tm, int tn, int bn, int nk,
                                        int splits) {
  const int tiles = tm * tn, tile = u % tiles, split = u / tiles;
  const int band = GROUP_M * tn;
  const int first = tile / band * GROUP_M;
  const int rows = min(tm - first, GROUP_M);
  const int r = tile % band;
  return Unit{(first + r % rows) * WG_BM, r / rows * bn, split,
              split_start(split, nk, splits),
              split_start(split + 1, nk, splits)};
}

template <int BN, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap o_map,
                       float* __restrict__ ws, int M, int N, int K,
                       int splits) {
  using L = WgLayout<BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto a_s = [&](int s) { return base + s * L::STAGE_BYTES; };
  auto b_s = [&](int s) { return base + s * L::STAGE_BYTES + L::A_BYTES; };

  const int tm = (M + WG_BM - 1) / WG_BM, tn = (N + BN - 1) / BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int units = tm * tn * splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the combine kernel (split-K) may be scheduled from here; it waits for
  // this grid and its writes before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp >= 8) {
    // producer: one thread keeps the ring full across the block's units
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {
      int it = 0;   // k-steps issued so far: stage it % STAGES
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_at(u, tm, tn, BN, nk, splits);
        for (int kt = t.k_lo; kt < t.k_hi; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), L::STAGE_BYTES);
          tma_load_2d(a_s(s), &x_map, full(s), kt * WG_BK, t.m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(b_s(s) + c * L::B_BLOCK, &w_map, full(s),
                        t.n0 + 64 * c, kt * WG_BK);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile;
    // this thread holds rows r and r + 8 of its warp's 16, at columns
    // 8 j + 2 (lane % 4) + {0, 1}
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4;
    float acc[BN / 2];
    int it = 0;   // k-steps consumed so far
    auto release = [&](int step) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(step % STAGES));
    };
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_at(u, tm, tn, BN, nk, splits);
      // every warpgroup issues its products, also where its 64 rows lie
      // past M (they multiply TMA's zeros): a wgmma in a divergent branch
      // is serialized by ptxas (C7518), which cost 15% at the
      // up-projection
      for (int kt = t.k_lo; kt < t.k_hi; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          // A: K-major, 16 k a step is 32 bytes into each 128-byte row;
          // B: MN-major, 16 k-rows a step, column blocks B_BLOCK apart
          const uint64_t a = wgmma_desc<128>(
              a_s(s) + 64 * wg * 128 + 32 * kk, 16, 1024);
          const uint64_t b = wgmma_desc<128>(
              b_s(s) + 16 * kk * 128, L::B_BLOCK, 1024);
          wgmma_ss_bt(acc, a, b, kt > t.k_lo || kk > 0);
        }
        wgmma_commit();
        // the previous step's products have retired: free their stage
        if (kt > t.k_lo) {
          wgmma_wait<1>();
          release(it - 1);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(it - 1);

      // rows r and r + 8 of the warp's 16 in the warpgroup's 64
      const int wrow = 16 * (warp % 4) + lane / 4;
      if (ws != nullptr) {   // split-K: the fp32 partial, stored directly
        const int col = t.n0 + 2 * (lane % 4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = t.m0 + 64 * wg + wrow + 8 * r;
          float* orow = ws + ((int64_t)t.split * M + m) * N;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            if (m < M && col + 8 * j < N)
              *reinterpret_cast<float2*>(orow + col + 8 * j) =
                  make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
        continue;
      }
      // bf16: rounded into the staging tile, L::EPI columns a pass, and
      // written by TMA stores that run on while the next tile's products
      // start (they skip rows past M and columns past N).  The quad's four
      // lanes hold columns 2 (lane % 4) of each 8-column chunk; a transpose
      // within the quad gives each lane whole 16-byte chunks.
      const int leader = threadIdx.x % 128 == 0;   // issues the warpgroup's
      const uint32_t stage_wg = base + L::EPI_OFF + 64 * wg * 128;  // stores
#pragma unroll
      for (int p = 0; p < BN / L::EPI; ++p) {
        if (leader) bulk_wait_read();   // the last pass's stores have read
        named_barrier_sync(1 + wg, 128);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = wrow + 8 * r;
#pragma unroll
          for (int g = p * L::EPI / 32; g < (p + 1) * L::EPI / 32; ++g) {
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = pack_bf16(acc[4 * (4 * g + i) + 2 * r],
                               acc[4 * (4 * g + i) + 2 * r + 1]);
            quad_transpose(v, lane);
            const int chunk = 4 * g + lane % 4 - p * L::EPI / 8;
            st_shared_v4(stage_wg + chunk / 8 * L::EPI_BLOCK + row * 128 +
                             ((chunk % 8) ^ (row % 8)) * 16,
                         v[0], v[1], v[2], v[3]);
          }
        }
        fence_proxy_async();
        named_barrier_sync(1 + wg, 128);
        if (leader) {
#pragma unroll
          for (int c = 0; c < L::EPI / 64; ++c)
            tma_store_2d(&o_map, stage_wg + c * L::EPI_BLOCK,
                         t.n0 + p * L::EPI + 64 * c, t.m0 + 64 * wg);
          bulk_commit();
        }
      }
    }
    // the stores must finish reading shared memory before the block ends
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// split-K: the combine pass
// ---------------------------------------------------------------------------

constexpr int COMBINE_THREADS = 256;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// o[i] = sum over z = 0, 1, ... of ws[z][i], in that order, rounded once.
// Launched as a programmatic dependent of the split kernel: it may start
// before that grid ends and waits for it (and its writes) first.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
gemm_combine_kernel(const float* __restrict__ ws, T* __restrict__ o,
                    int64_t MN, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int64_t i = (int64_t)blockIdx.x * COMBINE_THREADS + threadIdx.x;
       i < MN; i += (int64_t)gridDim.x * COMBINE_THREADS) {
    float sum = ws[i];
    for (int z = 1; z < splits; ++z) sum += ws[z * MN + i];
    store_out(o + i, sum);
  }
}

template <typename T>
cudaError_t launch_combine(const float* ws, void* o, int64_t MN, int splits,
                           cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const int64_t blocks = (MN + COMBINE_THREADS - 1) / COMBINE_THREADS;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks < 1056 ? blocks : 1056));
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemm_combine_kernel<T>, ws,
                            static_cast<T*>(o), MN, splits);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// sets the kernel's dynamic shared memory limit once per device (a
// launch's host cost is paid on every call, and small products are paced
// by it)
template <auto kernel>
cudaError_t allow_smem(int bytes) {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

// the current device's SM count, asked once per device
cudaError_t sm_count(int* sms) {
  static int counts[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && counts[dev] > 0) {
    *sms = counts[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < MAX_DEVICES) counts[dev] = *sms;
  return err;
}

template <int BM, int BN, int BK>
cudaError_t launch_bf16(const void* x, const void* w, void* o, float* ws,
                        int M, int N, int K, int splits, cudaStream_t stream) {
  using L = Bf16Tile<BM, BN, BK>;
  auto kernel = gemm_bf16_kernel<BM, BN, BK>;
  const cudaError_t err = allow_smem<gemm_bf16_kernel<BM, BN, BK>>(L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kernel<<<grid, L::NT, L::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(o), ws, M, N, K);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool ALIGNED>
cudaError_t launch_f32(const void* x, const void* w, void* o, float* ws,
                       int M, int N, int K, int splits, cudaStream_t stream) {
  using L = F32Tile<BM, BN, BK>;
  auto kernel = gemm_f32_kernel<BM, BN, BK, ALIGNED>;
  const cudaError_t err = allow_smem<gemm_f32_kernel<BM, BN, BK, ALIGNED>>(
      L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  kernel<<<grid, F32_THREADS, L::BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(o), ws, M, N, K);
  return cudaGetLastError();
}

template <int BN, int STAGES>
cudaError_t launch_wgmma(const void* x, const void* w, void* o, float* ws,
                         int M, int N, int K, int splits, cudaStream_t stream) {
  using L = WgLayout<BN, STAGES>;
  CUtensorMap x_map, w_map, o_map;
  if (!encode_bf16_2d(&x_map, x, K, M, WG_BK, WG_BM) ||
      !encode_bf16_2d(&w_map, w, N, K, 64, WG_BK) ||
      !encode_bf16_2d(&o_map, o, N, M, 64, 64))
    return cudaErrorInvalidValue;
  auto kernel = gemm_bf16_wgmma_kernel<BN, STAGES>;
  int sms = 0;
  cudaError_t err = allow_smem<gemm_bf16_wgmma_kernel<BN, STAGES>>(L::BYTES);
  if (err != cudaSuccess || (err = sm_count(&sms)) != cudaSuccess) return err;
  const int64_t units = (int64_t)((M + WG_BM - 1) / WG_BM) *
                        ((N + BN - 1) / BN) * splits;
  if (units > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, WG_THREADS, L::BYTES, stream>>>(x_map, w_map, o_map, ws, M,
                                                  N, K, splits);
  return cudaGetLastError();
}

// the built tiles, from the generated lists; *kernel is set to the kernel
// launched (0: gemm_f32_kernel, 1: gemm_bf16_kernel, 2: gemm_bf16_wgmma_kernel)
cudaError_t gemm_tiles(int dtype, bool aligned, int bm, int bn, int bk,
                       const void* x, const void* w, void* o, float* ws, int M,
                       int N, int K, int splits, cudaStream_t st, int* kernel) {
#define LEGO_F32(BM_, BN_, BK_)                                               \
  if (dtype == 0 && bm == BM_ && bn == BN_ && bk == BK_) {                    \
    *kernel = 0;                                                              \
    return aligned                                                            \
               ? launch_f32<BM_, BN_, BK_, true>(x, w, o, ws, M, N, K,        \
                                                 splits, st)                  \
               : launch_f32<BM_, BN_, BK_, false>(x, w, o, ws, M, N, K,       \
                                                  splits, st);                \
  }
#define LEGO_BF16(BM_, BN_, BK_, STAGES_)                                     \
  static_assert(BM_ == WG_BM && BK_ == WG_BK, "wgmma tiles are 128 x BN x 64"); \
  if (dtype == 1 && bm == BM_ && bn == BN_ && bk == BK_) {                    \
    *kernel = aligned ? 2 : 1;                                                \
    return aligned ? launch_wgmma<BN_, STAGES_>(x, w, o, ws, M, N, K, splits, \
                                                st)                           \
                   : launch_bf16<BM_, BN_, BK_>(x, w, o, ws, M, N, K, splits, \
                                                st);                          \
  }
  LEGO_GEMM_F32_TILES(LEGO_F32)
  LEGO_GEMM_BF16_TILES(LEGO_BF16)
#undef LEGO_BF16
#undef LEGO_F32
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// x (M, K), w (K, N), o (M, N), row-major and contiguous; M, N, K >= 1.
// splits (from repro_torch/kernels/autotile.py::gemm_splits) is in
// [1, ceil(K / bk)]; above 1 it needs a workspace of splits*M*N floats.
// *kernel is set to the kernel launched (0: fp32 CUDA cores, 1: bf16
// mma.sync, 2: bf16 wgmma), -1 if none.
// ---------------------------------------------------------------------------

extern "C" {

int lego_gemm(const void* x, const void* w, void* o, void* ws, int dtype,
              int M, int N, int K, int bm, int bn, int bk, int splits,
              void* stream, int* kernel) {
  *kernel = -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || M < 1 || N < 1 || K < 1 || bk < 1 ||
      splits < 1 || splits > (K + bk - 1) / bk || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  // whole 16-byte rows and 16-byte-aligned bases: what cp.async's 16-byte
  // copies and TMA's tensor maps need
  const int elems = dtype == 0 ? 4 : 8;
  const bool aligned = K % elems == 0 && N % elems == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const cudaError_t err = gemm_tiles(dtype, aligned, bm, bn, bk, x, w, o, part,
                                     M, N, K, splits, st, kernel);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t MN = (int64_t)M * N;
  return dtype == 0 ? launch_combine<float>(part, o, MN, splits, st)
                    : launch_combine<__nv_bfloat16>(part, o, MN, splits, st);
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Kernel K1 of the PyTorch port: the GEMM-JK tile, O = X W, for Hopper
// (sm_90a), written by hand in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/gemm.py::_gemm_kernel (LEGO's
// GEMM-JK, output-stationary design): X (M, K) times W (K, N) gives O (M, N)
// in X's dtype, fp32 or bf16.  On the TPU the grid was (M/bm, N/bn, K/bk)
// with K innermost and an fp32 accumulator tile resident in VMEM across the
// K sweep, cast to the output dtype on the last K step.  Here one block owns
// one (BM, BN) output tile and walks the whole K sweep itself (a GPU grid
// carries nothing from one block to the next, so K is a loop inside the
// block); the fp32 accumulator lives in registers for the whole sweep and
// the output is written once, rounded to its dtype.  K is never split
// across blocks.
//
// Bound: operations for large products (2*M*N*K flops on 2*(MK + KN + MN)
// bytes in bf16: ~1,300 flops per byte at (2048 x 5120) . (5120 x 14336),
// far above the H100's ~295), bytes for decode-shaped ones (M <= 16).
//
// Design.  X and W tiles are staged through shared memory in two stages:
// while the block computes on one stage, 16-byte cp.async copies fill the
// other (rows padded by one 16-byte chunk, which keeps the fragment loads
// free of bank conflicts).
//  * bf16: tensor cores through the warp-level mma.sync.m16n8k16 (bf16 in,
//    fp32 accumulate).  Each warp owns a WM x 32 slice of the tile (WM =
//    min(BM, 64)); A fragments come from shared memory by ldmatrix, B
//    fragments by ldmatrix.trans from the row-major (K, N) tile.
//  * fp32: true fp32 FMA on the CUDA cores (no TF32): 256 threads, each
//    with a (BM/16) x (BN/16) register micro-tile; rows ty + 16 i, columns
//    64 j + 4 tx + c, so a warp's A reads hit distinct banks and its B
//    reads are float4 broadcasts.
// Any M, N and K are taken, with no padding: loads past an edge are
// zero-filled and stores past an edge are skipped.  A row whose byte length
// is not a multiple of 16 (K or N not a multiple of 16 / sizeof(T)) or an
// operand that is not 16-byte aligned cannot use 16-byte cp.async, so the
// entry point picks an instantiation that loads element by element for
// such operands.  wgmma, TMA and clusters are later work.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 fills the chunk with zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(src_bytes));
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
// bf16: mma.sync.m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, int BK>
struct Bf16Tile {
  static constexpr int WM = BM < 64 ? BM : 64;   // rows per warp
  static constexpr int WN = 32;                  // columns per warp
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int NT = 32 * (BM / WM) * (BN / WN);
  static constexpr int SA = BK + 8, SB = BN + 8;   // padded strides
  static constexpr int STAGE = BM * SA + BK * SB;  // elements per stage
  static_assert(BM % WM == 0 && BN % WN == 0 && BK % 16 == 0, "tile");
};

template <int BM, int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(Bf16Tile<BM, BN, BK>::NT)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ X,
                 const __nv_bfloat16* __restrict__ W,
                 __nv_bfloat16* __restrict__ O, int M, int N, int K) {
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
  auto stage = [&](int kt) {
    __nv_bfloat16* As = smem + (kt & 1) * L::STAGE;
    stage_tiles<__nv_bfloat16, ALIGNED, BM, BN, BK, SA, SB, L::NT>(
        As, As + BM * SA, X, W, M, N, K, m0, n0, kt * BK, tid);
    cp_async_commit();
  };
  stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
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
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm0 + i * 16 + g + 8 * h;
        const int n = n0 + wn0 + j * 8 + 2 * t;
        if (m >= M || n >= N) continue;
        __nv_bfloat16* p = O + (int64_t)m * N + n;
        const float x0 = acc[i][j][2 * h], x1 = acc[i][j][2 * h + 1];
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
  static_assert(BM % 16 == 0 && (TN == 4 || TN == 8) && BK % 4 == 0, "tile");
};

template <int BM, int BN, int BK, bool ALIGNED>
__global__ void __launch_bounds__(F32_THREADS)
gemm_f32_kernel(const float* __restrict__ X, const float* __restrict__ W,
                float* __restrict__ O, int M, int N, int K) {
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
  auto stage = [&](int kt) {
    float* As = smem + (kt & 1) * L::STAGE;
    stage_tiles<float, ALIGNED, BM, BN, BK, SA, SB, F32_THREADS>(
        As, As + BM * SA, X, W, M, N, K, m0, n0, kt * BK, tid);
    cp_async_commit();
  };
  stage(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + 64 * (j / 4) + 4 * tx + j % 4;
      if (n < N) O[(int64_t)m * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// keep the shared-memory sizes in step with
// repro_torch/kernels/autotile.py::gemm_smem_bytes (two stages)
template <int BM, int BN, int BK, bool ALIGNED>
cudaError_t launch_bf16(const void* x, const void* w, void* o, int M, int N,
                        int K, cudaStream_t stream) {
  using L = Bf16Tile<BM, BN, BK>;
  constexpr int bytes = 2 * L::STAGE * (int)sizeof(__nv_bfloat16);
  auto kernel = gemm_bf16_kernel<BM, BN, BK, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, L::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(o), M, N, K);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, bool ALIGNED>
cudaError_t launch_f32(const void* x, const void* w, void* o, int M, int N,
                       int K, cudaStream_t stream) {
  using L = F32Tile<BM, BN, BK>;
  constexpr int bytes = 2 * L::STAGE * (int)sizeof(float);
  auto kernel = gemm_f32_kernel<BM, BN, BK, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(o), M, N, K);
  return cudaGetLastError();
}

// the built tiles: repro_torch/kernels/autotile.py::GEMM_TILES
template <bool ALIGNED>
cudaError_t gemm_tiles(int dtype, int bm, int bn, int bk, const void* x,
                       const void* w, void* o, int M, int N, int K,
                       cudaStream_t st) {
#define LEGO_GEMM(DT, LAUNCH, BM_, BN_, BK_)                                \
  if (dtype == DT && bm == BM_ && bn == BN_ && bk == BK_)                   \
    return LAUNCH<BM_, BN_, BK_, ALIGNED>(x, w, o, M, N, K, st);
  LEGO_GEMM(0, launch_f32, 16, 64, 16) LEGO_GEMM(0, launch_f32, 16, 128, 16)
  LEGO_GEMM(0, launch_f32, 64, 64, 16) LEGO_GEMM(0, launch_f32, 64, 128, 16)
  LEGO_GEMM(0, launch_f32, 128, 128, 16)
  LEGO_GEMM(1, launch_bf16, 16, 64, 32) LEGO_GEMM(1, launch_bf16, 16, 128, 32)
  LEGO_GEMM(1, launch_bf16, 64, 64, 32) LEGO_GEMM(1, launch_bf16, 64, 128, 32)
  LEGO_GEMM(1, launch_bf16, 128, 128, 32)
#undef LEGO_GEMM
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// x (M, K), w (K, N), o (M, N), row-major and contiguous; M, N, K >= 1.
// ---------------------------------------------------------------------------

extern "C" {

int lego_gemm(const void* x, const void* w, void* o, int dtype, int M, int N,
              int K, int bm, int bn, int bk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const int elems = dtype == 0 ? 4 : 8;   // elements per 16-byte chunk
  const bool aligned = K % elems == 0 && N % elems == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (aligned) return gemm_tiles<true>(dtype, bm, bn, bk, x, w, o, M, N, K, st);
  return gemm_tiles<false>(dtype, bm, bn, bk, x, w, o, M, N, K, st);
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

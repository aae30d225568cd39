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
// The TPU grid carried S across T-chunks in VMEM scratch.  A GPU grid cannot
// carry anything between blocks, and a block that walks T dependent steps
// (the step is a chain of FMAs, warp shuffles and a store, ~300 cycles) is
// bound by latency: at the main shape (B*H = 64, T = 2048, Dk = Dv = 64)
// that took 0.32 ms against a 0.025 ms bytes bound.  One kernel per dtype,
// no knob:
//
//  * bf16: the chunked matrix form on the tensor cores (rwkv6_tc_kernel).
//    T is cut into chunks of C = 64 steps and each chunk into four
//    sub-chunks of 16 (one mma.sync row tile).  Inside a chunk that starts
//    with state S_0,
//
//        o_t = (r_t . prod_{tau<t} w_tau) S_0 + sum_{s<=t} A_ts v_s
//        S_C = diag(prod_tau w_tau) S_0 + sum_s (k_s . prod_{tau>s} w_tau) v_s^T
//
//    with A_ts = sum_i r_ti k_si prod_{s<tau<t} w_tau,i for s < t and the u
//    term r_t . u . k_t on the diagonal.  Every decay is a product of w over
//    an explicit range, never a ratio of products and never a logarithm:
//    each factor is at most 1, w = 0 gives exact zeros and nothing
//    overflows.  Between sub-chunks J < I the scores are one product
//    (r_t . prod_{I_0<=tau<t} w)(k_s . prod_{s<tau<I_0} w)^T factored at
//    the start I_0 of the row's sub-chunk; inside a sub-chunk the same
//    factoring at its middle gives the 8 x 8 block of rows 8..15 by columns
//    0..7, and the two diagonal 8 x 8 blocks are summed element by element
//    in fp32.  Then o = A V + R_state S_0 and S_C = diag(W) S_0 +
//    sum_J diag(prod_{J'>J} W_J') K_J^T V_J, with S kept in the fp32
//    accumulators of the warps that own its rows.  Every product's bf16
//    operands are split into a rounded high part and the rounded rest
//    (hi.hi + hi.lo + lo.hi; v is exact in bf16, so A V and K^T V take
//    hi.v + lo.v): one bf16 rounding of A, of the state or of a decayed
//    operand moves o by ~1% of its row's rms and S_last past the 1e-4
//    gate, while the split products leave ~2^-16 and o is rounded once.
//
//    Filling the card: the chunks of a head are cut into `segments` runs
//    (autotile.rwkv6_tiles; two at B*H = 64), one block of 16 warps each
//    (grid (segments, H, B)); a block first carries the state over the
//    chunks before its run (the state's update alone, ~3/8 of a chunk's
//    cost) and then computes its run, the runs shrinking so that every
//    block takes about as long.  Per chunk, in three phases between syncs:
//    chunk c + 2 is copied by cp.async into the third of three stages
//    while c is computed and c + 1 is prepared (padded past T, its decay
//    factors tabled); (1) the operands are built by 8-step walks over two
//    channels (hi/lo bf16 into shared memory); (2) on different warps at
//    once, so that the CUDA cores and the tensor cores overlap: the
//    diagonal blocks (one warp each, its rows in registers, a
//    reduce-scatter over the lanes), A's 16 other tiles (mma.sync, two a
//    warp), then on every warp R_state S_0 into its tile of o and the
//    state's update; (3) A V into o, stored.  Bound: bytes (r, k, w, v
//    read and o written once in bf16, S_last in fp32, 0.025 ms at the main
//    shape); the products run ~10 GFLOP there (0.010 ms at the bf16 rate)
//    and the element-wise work ~0.3 GFLOP.  What holds it back (PERF.md):
//    shared-memory instructions and ldmatrix traffic in every phase, and
//    the syncs between the phases of each chunk step.
//    Steps past T (the ragged last chunk) decay by 1 and add nothing.
//  * fp32: the recurrence on the CUDA cores (rwkv6_f32_kernel).  The tensor
//    cores take fp32 only as TF32, which fails the 1e-4 gate, so the whole T
//    loop runs inside one block with S in registers; the state is split by
//    column over blocks of 16 columns and each column over 4 lanes joined
//    by a warp-shuffle sum, with chunks of r/k/w/v staged in shared memory
//    by double-buffered cp.async copies.  Bound: operations (4 Dk Dv flops
//    per head and step at the fp32 rate).
//
// The entry point launches on the caller's stream, allocates nothing, writes
// the kernel it launched to its last argument, and returns
// cudaGetLastError() so that a refused launch is reported.  The chunk, the
// sub-chunk, the carried chunk's relative cost and the built (Dk, Dv) come
// from the header that repro_torch.kernels.autotile writes (LEGO_RWKV_*),
// included before this file by the build.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

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
// fp32: one block per (16 columns of S, head, batch), the T loop inside
// ---------------------------------------------------------------------------

constexpr int LANES_PER_COL = 4;    // lanes that share one column of S
constexpr int COLS_PER_BLOCK = 16;  // columns of S per block
constexpr int F32_THREADS = LANES_PER_COL * COLS_PER_BLOCK;   // two warps

template <int DK, int DV>
__global__ void __launch_bounds__(F32_THREADS)
rwkv6_f32_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ o,
                 float* __restrict__ s_last, int H, int Tlen) {
  constexpr int CT = 16;                    // time steps per staged chunk
  constexpr int E = 4;                      // elements per 16-byte copy
  constexpr int ROWS = DK / LANES_PER_COL;  // rows of S per lane
  constexpr int PAIRS = ROWS / 2;
  static_assert(ROWS % 2 == 0 && DV % COLS_PER_BLOCK == 0, "shape");
  __shared__ __align__(16) float sr[2][CT * DK];
  __shared__ __align__(16) float sk[2][CT * DK];
  __shared__ __align__(16) float sw[2][CT * DK];
  __shared__ __align__(16) float sv[2][CT * COLS_PER_BLOCK];

  const int tid = threadIdx.x;
  const int p = tid % LANES_PER_COL;
  const int jj = tid / LANES_PER_COL;
  const int col0 = blockIdx.x * COLS_PER_BLOCK;
  const int h = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + h;
  const int64_t row0 = bh * Tlen;           // first (b, h, t = 0) row

  // this lane's rows of S: 2*(q*LANES_PER_COL + p) + e, e in {0, 1}; the
  // four lanes of a column read four consecutive 8-byte words of shared
  // memory (no bank conflicts, two rows a load)
  float S[ROWS], uu[ROWS];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * (q * LANES_PER_COL + p) + e;
      S[2 * q + e] = 0.f;
      uu[2 * q + e] = u[static_cast<int64_t>(h) * DK + i];
    }
  }

  // stage chunk c (time steps c*CT ..) into buffer `buf`; rows past T are
  // not copied (and never read)
  auto stage = [&](int c, int buf) {
    const int t0 = c * CT;
    const int rows = min(CT, Tlen - t0);
    const int n_rkw = rows * DK / E;
    const int64_t g0 = (row0 + t0) * DK;
    for (int x = tid; x < n_rkw; x += F32_THREADS) {
      cp_async16(&sr[buf][x * E], r + g0 + x * E);
      cp_async16(&sk[buf][x * E], k + g0 + x * E);
      cp_async16(&sw[buf][x * E], w + g0 + x * E);
    }
    constexpr int VP = COLS_PER_BLOCK / E;  // 16-byte copies per v row
    for (int x = tid; x < rows * VP; x += F32_THREADS) {
      const int t = x / VP, piece = x % VP;
      cp_async16(&sv[buf][t * COLS_PER_BLOCK + piece * E],
                 v + (row0 + t0 + t) * DV + col0 + piece * E);
    }
    cp_async_commit();
  };

  const int n_chunks = (Tlen + CT - 1) / CT;
  float* ob = o + row0 * DV + col0 + jj;
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
    const float* cr = sr[buf];
    const float* ck = sk[buf];
    const float* cw = sw[buf];
    const float* cv = sv[buf];
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float vj = cv[s * COLS_PER_BLOCK + jj];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < PAIRS; ++q) {
        const int i = s * DK + 2 * (q * LANES_PER_COL + p);
        const float2 rr = *reinterpret_cast<const float2*>(cr + i);
        const float2 kk = *reinterpret_cast<const float2*>(ck + i);
        const float2 ww = *reinterpret_cast<const float2*>(cw + i);
        const float kv0 = kk.x * vj, kv1 = kk.y * vj;
        acc = fmaf(rr.x, fmaf(uu[2 * q], kv0, S[2 * q]), acc);
        acc = fmaf(rr.y, fmaf(uu[2 * q + 1], kv1, S[2 * q + 1]), acc);
        S[2 * q] = fmaf(ww.x, S[2 * q], kv0);
        S[2 * q + 1] = fmaf(ww.y, S[2 * q + 1], kv1);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) ob[static_cast<int64_t>(c * CT + s) * DV] = acc;
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

// ---------------------------------------------------------------------------
// bf16: the chunked matrix form on the tensor cores
// ---------------------------------------------------------------------------

constexpr int C = LEGO_RWKV_CHUNK;       // steps per chunk
constexpr int SUB = LEGO_RWKV_SUB;       // steps per sub-chunk (mma rows)
constexpr int NSUB = C / SUB;
static_assert(C == 64 && SUB == 16,
              "one warp per 16-row sub-chunk, four sub-chunks a chunk");

// per channel i, the decay factors of a chunk (W_J = prod of w over
// sub-chunk J), F_* * DK + i in the table:
constexpr int F_BEFORE = 0;   // + J: prod_{J'<J} W_J'        (R from the start)
constexpr int F_PAIR = 4;     // + 0, 1, 2: W_1, W_1 W_2, W_2 (the K of the
                              //   pairs (2,0), (3,0), (3,1))
constexpr int F_AFTER = 7;    // + J: prod_{J'>J} W_J'        (the state's K)
constexpr int F_TOTAL = 11;   // prod_J W_J
constexpr int NF = 12;

// shared memory of one block, in bf16 elements then fp32 words; every
// region starts on 16 bytes.  Rows read by ldmatrix are padded by 8
// elements (16 bytes), so the 8 rows of one 8x8 matrix fall in 8 distinct
// groups of 4 banks.  autotile.rwkv6_smem_bytes counts the same.
template <int DK, int DV>
struct TcLayout {
  static constexpr int WH = DV / 16 < 4 ? DV / 16 : 4;   // warps a sub-chunk
  static constexpr int WARPS = NSUB * WH;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NTW = DV / 8 / WH;  // n8 tiles of o and S a warp
  static constexpr int SK = DK + 8, SV = DV + 8, SA = C + 8;
  static constexpr int RKW = C * DK;       // one staged r, k or w chunk
  static constexpr int STAGE = 3 * RKW + C * SV;
  // each of these is a hi half followed by a lo half of HALF_* elements
  static constexpr int HALF_R = C * SK;    // R_J; R from the chunk start; K_J
  static constexpr int HALF_X = 3 * SUB * SK;   // K of the pairs 2, 3 apart
  static constexpr int HALF_8 = NSUB * 8 * SK;  // R, K of the inner halves
  static constexpr int HALF_A = C * SA;    // the scores A, [t][s]
  static constexpr int HALF_S = DK * SV;   // the state, [i][j]
  static constexpr int OFF_RJ = 3 * STAGE;   // three stages
  static constexpr int OFF_RS = OFF_RJ + 2 * HALF_R;
  static constexpr int OFF_K = OFF_RS + 2 * HALF_R;
  static constexpr int OFF_X = OFF_K + 2 * HALF_R;
  static constexpr int OFF_R8 = OFF_X + 2 * HALF_X;
  static constexpr int OFF_K8 = OFF_R8 + 2 * HALF_8;
  static constexpr int OFF_A = OFF_K8 + 2 * HALF_8;
  static constexpr int OFF_SB = OFF_A + 2 * HALF_A;
  static constexpr int OFF_ZERO = OFF_SB + 2 * HALF_S;   // 8 zeros
  static constexpr int BF16_END = OFF_ZERO + 8;
  static constexpr int BYTES = 2 * BF16_END + 4 * 2 * NF * DK;
  static_assert(DK % 16 == 0 && DV % 16 == 0, "shape");
  static_assert(NTW % 2 == 0, "B fragments come in pairs of n8 tiles");
  static_assert(BF16_END % 8 == 0, "fp32 area on 16 bytes");
  static_assert(BYTES <= 227 * 1024, "shared memory of one block");
};

// a pair of fp32 values as packed bf16 hi and lo parts (lo = the rest)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const bf162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// ... stored at `at` of a hi half and of the lo half `lo_off` elements on
__device__ __forceinline__ void put_split2(bf16* base, int lo_off, int at,
                                           float2 x) {
  uint32_t hi, lo;
  split2(x.x, x.y, hi, lo);
  *reinterpret_cast<uint32_t*>(base + at) = hi;
  *reinterpret_cast<uint32_t*>(base + lo_off + at) = lo;
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(a.x * b.x, a.y * b.y);
}

// two consecutive bf16 of shared memory at `at` as fp32
__device__ __forceinline__ float2 ld_bf2(const bf16* base, int at) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(base + at));
}

// A fragment (16 x 16) at rows m0.., columns k0.. of [m][k] storage
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* base,
                                       int stride, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, base + (m0 + lane % 16) * stride + k0 + (lane / 16) * 8);
}
// ... whose rows 0..7 are zero and rows 8..15 the 8 rows at `base`
__device__ __forceinline__ void ldsm_a_low_zero(uint32_t (&a)[4],
                                                const bf16* base, int stride,
                                                int k0, const bf16* zero) {
  const int lane = threadIdx.x % 32, row = lane % 16;
  ldmatrix_x4(a, row < 8 ? zero
                         : base + (row - 8) * stride + k0 + (lane / 16) * 8);
}
// the same from [k][m] storage (the transpose)
__device__ __forceinline__ void ldsm_a_t(uint32_t (&a)[4], const bf16* base,
                                         int stride, int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(a, base + (k0 + (lane / 16) * 8 + lane % 8) * stride
                           + m0 + ((lane / 8) % 2) * 8);
}
// B fragments of the n8 tiles n0.. and n0+8.. (b[0..1] and b[2..3]) at
// k0.., from [n][k] storage
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4], const bf16* base,
                                          int stride, int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, base + (n0 + (lane / 16) * 8 + lane % 8) * stride + k0
                     + ((lane / 8) % 2) * 8);
}
// the same from [k][n] storage
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4], const bf16* base,
                                          int stride, int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, base + (k0 + lane % 16) * stride + n0
                           + (lane / 16) * 8);
}

// (ah + al)(bh + bl) less the lo.lo term over the n8 tile pair: hi.hi into
// d0, d1 and the cross terms into e0, e1 (two chains of dependent products)
__device__ __forceinline__ void mma3(float (&d0)[4], float (&d1)[4],
                                     float (&e0)[4], float (&e1)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[4],
                                     const uint32_t (&bl)[4]) {
  mma_bf16(d0, ah, bh[0], bh[1]);
  mma_bf16(d1, ah, bh[2], bh[3]);
  mma_bf16(e0, ah, bl[0], bl[1]);
  mma_bf16(e1, ah, bl[2], bl[3]);
  mma_bf16(e0, al, bh[0], bh[1]);
  mma_bf16(e1, al, bh[2], bh[3]);
}
// the same on the first n8 tile of b only
__device__ __forceinline__ void mma3_one(float (&d0)[4], float (&e0)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[4],
                                         const uint32_t (&bl)[4]) {
  mma_bf16(d0, ah, bh[0], bh[1]);
  mma_bf16(e0, ah, bl[0], bl[1]);
  mma_bf16(e0, al, bh[0], bh[1]);
}
// (ah + al) b over the n8 tile pair, b exact: ah b into d0, d1 and al b
// into e0, e1
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     float (&e0)[4], float (&e1)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&b)[4]) {
  mma_bf16(d0, ah, b[0], b[1]);
  mma_bf16(d1, ah, b[2], b[3]);
  mma_bf16(e0, al, b[0], b[1]);
  mma_bf16(e1, al, b[2], b[3]);
}

template <int N>
__device__ __forceinline__ void set_zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// the diagonal 8 x 8 block of A that starts at row and column `base`: for
// t > s, sum_i r_ti k_si prod_{s<tau<t} w_tau,i, and the u term r_t . u .
// k_t at t = s, in fp32.  The warp's lanes split the channels (CPL each);
// the block's 8 rows of r, k and w are read once into registers, the 36
// sums of each lane are added over the warp by a reduce-scatter that leaves
// entry `lane` to each lane (and the last four to every lane), and written
// as bf16 hi/lo.  Entries above the diagonal are never written (zero).
template <int DK>
__device__ __forceinline__ void diag_block(const bf16* sr, const bf16* sk,
                                           const bf16* sw, bf16* sa,
                                           int half_a, int sa_stride,
                                           int base, int lane,
                                           const float (&uu)[DK >= 32 ? DK / 32 : 1]) {
  constexpr int CPL = DK >= 32 ? DK / 32 : 1;   // channels of one lane
  const bool act = lane * CPL < DK;
  const int c0 = act ? lane * CPL : 0;
  float rr[8][CPL], kk[8][CPL], ww[8][CPL];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int at = (base + t) * DK + c0 + c;
      rr[t][c] = act ? __bfloat162float(sr[at]) : 0.f;
      kk[t][c] = act ? __bfloat162float(sk[at]) : 0.f;
      ww[t][c] = act ? __bfloat162float(sw[at]) : 0.f;
    }
  // entries in the order s = 0..7, t = s..7
  float acc[36];
#pragma unroll
  for (int s = 0, e = 0; s < 8; ++s) {
    float kd[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) kd[c] = kk[s][c];
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) a = fmaf(rr[s][c] * uu[c], kd[c], a);
    acc[e++] = a;
#pragma unroll
    for (int t = s + 1; t < 8; ++t) {
      if (t > s + 1) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) kd[c] *= ww[t - 1][c];
      }
      float b = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) b = fmaf(rr[t][c], kd[c], b);
      acc[e++] = b;
    }
  }
  // entries 0..31: reduce-scatter (lane keeps entry `lane`); 32..35: sums
  // on every lane
  float v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool up = lane & 16;
    const float give = up ? acc[j] : acc[j + 16];
    v[j] = (up ? acc[j + 16] : acc[j]) + __shfl_xor_sync(0xffffffffu, give, 16);
  }
#pragma unroll
  for (int lv = 0; lv < 4; ++lv) {
    const int m = 8 >> lv;
    const bool up = lane & m;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const float give = up ? v[j] : v[j + m];
      v[j] = (up ? v[j + m] : v[j]) + __shfl_xor_sync(0xffffffffu, give, m);
    }
  }
  float tail = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x = acc[32 + j];
#pragma unroll
    for (int lv = 0; lv < 5; ++lv)
      x += __shfl_xor_sync(0xffffffffu, x, 16 >> lv);
    if (lane == j) tail = x;
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && lane >= 4) break;
    int e = pass == 0 ? lane : 32 + lane, s = 0;
    while (e >= 8 - s) {
      e -= 8 - s;
      ++s;
    }
    const float a = pass == 0 ? v[0] : tail;
    const bf16 hi = __float2bfloat16(a);
    const int at = (base + s + e) * sa_stride + base + s;
    sa[at] = hi;
    sa[half_a + at] = __float2bfloat16(a - __bfloat162float(hi));
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(TcLayout<DK, DV>::THREADS, 1)
rwkv6_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ w,
                const bf16* __restrict__ u, bf16* __restrict__ o,
                float* __restrict__ s_last, int H, int Tlen) {
  using L = TcLayout<DK, DV>;
  constexpr int SK = L::SK, SV = L::SV, SA = L::SA, NTW = L::NTW;
  constexpr int CPL = DK >= 32 ? DK / 32 : 1;   // channels of one lane in
                                                // the diagonal sums
  constexpr int NPT = NSUB * DK / 2;   // operand walks of one direction
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* rj = sm + L::OFF_RJ;       // hi, then lo at + HALF_R
  bf16* rs = sm + L::OFF_RS;
  bf16* kj = sm + L::OFF_K;
  bf16* kx = sm + L::OFF_X;        // hi, then lo at + HALF_X
  bf16* r8 = sm + L::OFF_R8;       // hi, then lo at + HALF_8
  bf16* k8 = sm + L::OFF_K8;
  bf16* sa = sm + L::OFF_A;        // hi, then lo at + HALF_A
  bf16* sb = sm + L::OFF_SB;       // hi, then lo at + HALF_S
  const bf16* zero = sm + L::OFF_ZERO;
  // the decay factors of this chunk and of the next, [2][NF][DK]
  float* facs = reinterpret_cast<float*>(sm + L::BF16_END);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the warp's sub-chunk (rows of o) and row tile of S (when mt < DK / 16)
  // and its columns of both; the warps of a scheduler (w, w + 4, ..) take
  // sub-chunks s and 3 - s in turn
  const int col_q = warp / NSUB;
  const int mt = col_q % 2 ? NSUB - 1 - warp % NSUB : warp % NSUB;
  const int jw0 = col_q * NTW * 8;      // the warp's first column of o, S
  const int g = lane / 4, tg = lane % 4;
  const bool owns_state = mt < DK / 16;
  const int h = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * H + h;
  const int64_t row0 = bh * Tlen;
  // this block writes o for the chunks [c_begin, c_end) and first carries
  // the state over the chunks before them; a chunk carried costs about
  // LEGO_RWKV_PRE_COST of one computed, so the runs shrink geometrically
  // (autotile.rwkv6_segment_starts) and every block takes about as long
  const int n_chunks = (Tlen + C - 1) / C;
  auto start = [&](int p) {
    const int P = gridDim.x;
    if (p == 0 || p == P) return p == 0 ? 0 : n_chunks;
    const float q = 1.f - LEGO_RWKV_PRE_COST;
    return static_cast<int>(
        rintf(n_chunks * (1.f - powf(q, p)) / (1.f - powf(q, P))));
  };
  const int c_begin = start(blockIdx.x), c_end = start(blockIdx.x + 1);

  // u on the lane's channels of the diagonal sums
  float uu[CPL];
#pragma unroll
  for (int e = 0; e < CPL; ++e)
    uu[e] = lane * CPL < DK
                ? __bfloat162float(u[static_cast<int64_t>(h) * DK + lane * CPL + e])
                : 0.f;

  // A's blocks that are never written (above the diagonal) stay zero
  for (int x = tid; x < 2 * L::HALF_A + 8; x += L::THREADS)
    (x < 2 * L::HALF_A ? sa : sm + L::OFF_ZERO - 2 * L::HALF_A)[x] =
        __float2bfloat16(0.f);

  // the state rows mt*16 + g (+8), columns jw0 + nt*8 + 2*tg (+1)
  float S[NTW][4];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[nt][e] = 0.f;

  // chunk c into stage `buf` (r only where its outputs are computed); rows
  // past T are not copied (and are padded before they are read)
  auto stage = [&](int c, int buf) {
    bf16* st = sm + buf * L::STAGE;
    const int t0 = c * C, rows = min(C, Tlen - t0);
    const int64_t g0 = (row0 + t0) * DK;
    const bool with_r = c >= c_begin;
    for (int x = tid; x < rows * DK / 8; x += L::THREADS) {
      if (with_r) cp_async16(st + x * 8, r + g0 + x * 8);
      cp_async16(st + L::RKW + x * 8, k + g0 + x * 8);
      cp_async16(st + 2 * L::RKW + x * 8, w + g0 + x * 8);
    }
    constexpr int VP = DV / 8;   // 16-byte copies per v row
    for (int x = tid; x < rows * VP; x += L::THREADS) {
      const int t = x / VP, piece = x % VP;
      cp_async16(st + 3 * L::RKW + t * SV + piece * 8,
                 v + (row0 + t0 + t) * DV + piece * 8);
    }
    cp_async_commit();
  };

  // chunk cc made ready to read: steps past T padded (r = k = v = 0, w =
  // 1) and its decay factors into table cc % 2 (W_J of channel i = x / 4
  // on lane J = x % 4, then each of the four lanes writes its share; the
  // shuffles need whole warps, the first ones of the block)
  auto prepare = [&](int cc) {
    bf16* st = sm + (cc % 3) * L::STAGE;
    const bf16* sw = st + 2 * L::RKW;
    const int rows = min(C, Tlen - cc * C);
    float* fac = facs + (cc & 1) * NF * DK;
    if (rows < C) {
      for (int x = tid; x < (C - rows) * DK; x += L::THREADS) {
        const int at = rows * DK + x;
        st[at] = __float2bfloat16(0.f);
        st[L::RKW + at] = __float2bfloat16(0.f);
        st[2 * L::RKW + at] = __float2bfloat16(1.f);
      }
      for (int x = tid; x < (C - rows) * DV; x += L::THREADS)
        st[3 * L::RKW + (rows + x / DV) * SV + x % DV] = __float2bfloat16(0.f);
    }
    for (int x = tid; x < ((NSUB * DK + 31) / 32) * 32; x += L::THREADS) {
      const int i = x / NSUB, J = x % NSUB;
      float p = 1.f;
      if (i < DK) {
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          const int tt = J * SUB + t;
          p *= tt < rows ? __bfloat162float(sw[tt * DK + i]) : 1.f;
        }
      }
      float W[NSUB];
#pragma unroll
      for (int q = 0; q < NSUB; ++q)
        W[q] = __shfl_sync(0xffffffffu, p, (lane & ~(NSUB - 1)) + q);
      if (i < DK) {
        if (J == 0) {
          fac[(F_BEFORE + 0) * DK + i] = 1.f;
          fac[(F_BEFORE + 1) * DK + i] = W[0];
          fac[(F_BEFORE + 2) * DK + i] = W[0] * W[1];
          fac[(F_BEFORE + 3) * DK + i] = W[0] * W[1] * W[2];
        } else if (J == 1) {
          fac[(F_PAIR + 0) * DK + i] = W[1];
          fac[(F_PAIR + 1) * DK + i] = W[1] * W[2];
          fac[(F_PAIR + 2) * DK + i] = W[2];
          fac[F_TOTAL * DK + i] = W[0] * W[1] * W[2] * W[3];
        } else if (J == 2) {
          fac[(F_AFTER + 0) * DK + i] = W[1] * W[2] * W[3];
          fac[(F_AFTER + 1) * DK + i] = W[2] * W[3];
        } else {
          fac[(F_AFTER + 2) * DK + i] = W[3];
          fac[(F_AFTER + 3) * DK + i] = 1.f;
        }
      }
    }
  };

  // three stages: chunk c is computed while c + 1 lands (and is prepared)
  // and c + 2 is copied
  stage(0, 0);
  if (1 < c_end)
    stage(1, 1);
  else
    cp_async_commit();            // an empty group keeps the waits uniform
  cp_async_wait_prev();
  __syncthreads();
  prepare(0);
  for (int c = 0; c < c_end; ++c) {
    if (c + 2 < c_end)
      stage(c + 2, (c + 2) % 3);
    else
      cp_async_commit();
    cp_async_wait_prev();         // chunk c + 1 has landed
    __syncthreads();
    const bool full = c >= c_begin;   // o of this chunk, or the state only
    const bf16* st = sm + (c % 3) * L::STAGE;
    const bf16* sr = st;
    const bf16* sk = st + L::RKW;
    const bf16* sw = st + 2 * L::RKW;
    const bf16* sv = st + 3 * L::RKW;
    const float* fac = facs + (c & 1) * NF * DK;

    // (1) the state S_0 as bf16 hi/lo operands, the next chunk prepared
    if (full && owns_state) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = mt * 16 + g + 8 * hh, j = jw0 + nt * 8 + 2 * tg;
          put_split2(sb, L::HALF_S, i * SV + j,
                     make_float2(S[nt][2 * hh], S[nt][2 * hh + 1]));
        }
    }
    if (c + 1 < c_end) prepare(c + 1);

    // (2) operands as bf16 hi/lo, two channels and half a sub-chunk (8
    // steps) a walk, the other half's decay taken first: forward walks
    // write R_J = r . prod_{J_0 <= tau < t} w, R from the chunk start and,
    // in the second half, R from its start (R8); backward walks K_J = k .
    // prod_{s < tau <= J_end} w, its copies rescaled to the start of the
    // sub-chunk two and three on (pairs (2,0), (3,0), (3,1)) and, in the
    // first half, K to its end (K8).  The two warps of a scheduler take
    // sub-chunks J and 3 - J
    for (int x = tid; x < 4 * NPT; x += L::THREADS) {
      const bool fwd = x < 2 * NPT;
      const int hf = (x / NPT) % 2;
      const int jj = (x % NPT) / (DK / 2);
      const int J = hf ? NSUB - 1 - jj : jj;
      const int i = 2 * (x % (DK / 2));
      const int t0 = J * SUB + hf * 8;     // this half's first step
      if (fwd && !full) continue;
      float2 av[8], wv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        av[m] = ld_bf2(fwd ? sr : sk, (t0 + m) * DK + i);
        wv[m] = ld_bf2(sw, (t0 + m) * DK + i);
      }
      // the decay over the other half: before this one (forward, second
      // half) or after it (backward, first half)
      float2 p = make_float2(1.f, 1.f);
      if (fwd == (hf == 1)) {
        const int o0 = J * SUB + (hf ? 0 : 8);
#pragma unroll
        for (int m = 0; m < 8; ++m) p = mul2(p, ld_bf2(sw, (o0 + m) * DK + i));
      }
      float2 p8 = make_float2(1.f, 1.f);
      if (fwd) {
        float2 pb = mul2(p, *reinterpret_cast<const float2*>(
                                fac + (F_BEFORE + J) * DK + i));
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int tt = t0 + m;
          put_split2(rj, L::HALF_R, tt * SK + i, mul2(av[m], p));
          put_split2(rs, L::HALF_R, tt * SK + i, mul2(av[m], pb));
          if (hf) {
            put_split2(r8, L::HALF_8, (J * 8 + m) * SK + i, mul2(av[m], p8));
            p8 = mul2(p8, wv[m]);
          }
          p = mul2(p, wv[m]);
          pb = mul2(pb, wv[m]);
        }
      } else {
        // J = 0 -> pairs (2,0), (3,0) at slots 0, 1; J = 1 -> (3,1) at 2
        const int n_x = full ? (J == 0 ? 2 : J == 1 ? 1 : 0) : 0;
        const float2 m0 = *reinterpret_cast<const float2*>(
            fac + (F_PAIR + (J == 0 ? 0 : 2)) * DK + i);
        const float2 m1 = *reinterpret_cast<const float2*>(
            fac + (F_PAIR + 1) * DK + i);
        const int slot0 = J == 0 ? 0 : 2;
#pragma unroll
        for (int m = 7; m >= 0; --m) {
          const int t = hf * 8 + m, ss = t0 + m;
          const float2 x0 = mul2(av[m], p);
          put_split2(kj, L::HALF_R, ss * SK + i, x0);
          if (n_x > 0)
            put_split2(kx, L::HALF_X, (slot0 * SUB + t) * SK + i, mul2(x0, m0));
          if (n_x > 1)
            put_split2(kx, L::HALF_X, (1 * SUB + t) * SK + i, mul2(x0, m1));
          if (full && !hf) {
            put_split2(k8, L::HALF_8, (J * 8 + m) * SK + i, mul2(av[m], p8));
            p8 = mul2(p8, wv[m]);
          }
          p = mul2(p, wv[m]);
        }
      }
    }
    __syncthreads();

    // (3) the tensor cores and the CUDA cores at once, on different warps:
    // the diagonal 8 x 8 blocks of A in fp32 (second half of the warps),
    // A's 16 other tiles (first half), then everywhere R_state S_0 into
    // the warp's rows and columns of o and the state's update (the V
    // fragments and o's accumulators are taken up only then: the diagonal
    // sums need the registers)
    if (full) {
      for (int blk = (warp + L::WARPS / 2) % L::WARPS; blk < 2 * NSUB;
           blk += L::WARPS)
        diag_block<DK>(sr, sk, sw, sa, L::HALF_A, SA,
                       (blk % NSUB) * SUB + (blk / NSUB) * 8, lane, uu);
      // one 16 x 8 tile per item (12 products each): items 0..11 the pair
      // (I, J) = pair item / 2, columns J*16 + (item % 2)*8.., R_I K^T;
      // items 12..15 the inner tile of sub-chunk item - 12, R8 K8^T (rows
      // 8..15 by columns 0..7)
      for (int item = warp; item < 16 && warp < L::WARPS / 2;
           item += L::WARPS / 2) {
        const bool inner = item >= 12;
        const int pair = item / 2;
        const int I = inner ? item - 12 : pair < 1 ? 1 : pair < 3 ? 2 : 3;
        const int J = inner ? I : pair - (I == 1 ? 0 : I == 2 ? 1 : 3);
        const int e = inner ? 0 : item % 2;
        const bf16 *ah_base, *kh;
        int kl_off;
        if (!inner) {
          // K_J itself for the neighbour, else its rescaled copy
          const bool near = J == I - 1;
          const int kslot = I == 2 ? 0 : J == 0 ? 1 : 2;
          kh = (near ? kj + J * SUB * SK : kx + kslot * SUB * SK) + e * 8 * SK;
          kl_off = near ? L::HALF_R : L::HALF_X;
          ah_base = rj;
        } else {
          kh = k8 + J * 8 * SK;
          kl_off = L::HALF_8;
          ah_base = r8 + J * 8 * SK;
        }
        // the lanes of the unused second n8 tile read the first's rows
        const int back = (lane / 16) * 8 * SK;
        float d[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          uint32_t ah[4], al[4], bh[4], bl[4];
          if (!inner) {
            ldsm_a(ah, ah_base, SK, I * 16, kk * 16);
            ldsm_a(al, ah_base + L::HALF_R, SK, I * 16, kk * 16);
          } else {
            ldsm_a_low_zero(ah, ah_base, SK, kk * 16, zero);
            ldsm_a_low_zero(al, ah_base + L::HALF_8, SK, kk * 16, zero);
          }
          ldsm_b_nk(bh, kh - back, SK, 0, kk * 16);
          ldsm_b_nk(bl, kh + kl_off - back, SK, 0, kk * 16);
          mma3_one(d, x, ah, al, bh, bl);
        }
        // rows I*16 + g (+8), columns J*16 + e*8 + 2*tg (+1); an inner
        // tile only rows 8..
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (inner && hh == 0) continue;
          const int t = I * 16 + g + 8 * hh, s0 = J * 16 + e * 8 + 2 * tg;
          put_split2(sa, L::HALF_A, t * SA + s0,
                     make_float2(d[2 * hh] + x[2 * hh],
                                 d[2 * hh + 1] + x[2 * hh + 1]));
        }
      }
    }
    uint32_t vf[NSUB][NTW / 2][4];   // V (k = step, n = column), all steps
#pragma unroll
    for (int J = 0; J < NSUB; ++J)
#pragma unroll
      for (int q = 0; q < NTW / 2; ++q)
        ldsm_b_kn(vf[J][q], sv, SV, J * 16, jw0 + q * 16);
    float oy[NTW][4], oz[NTW][4];    // R_state S_0 (hi.hi; cross terms)
    set_zero(oy);
    set_zero(oz);
    if (full) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t rh[4], rl[4];
        ldsm_a(rh, rs, SK, mt * 16, kk * 16);
        ldsm_a(rl, rs + L::HALF_R, SK, mt * 16, kk * 16);
#pragma unroll
        for (int q = 0; q < NTW / 2; ++q) {
          uint32_t sh[4], sl[4];
          ldsm_b_kn(sh, sb, SV, kk * 16, jw0 + q * 16);
          ldsm_b_kn(sl, sb + L::HALF_S, SV, kk * 16, jw0 + q * 16);
          mma3(oy[2 * q], oy[2 * q + 1], oz[2 * q], oz[2 * q + 1], rh, rl, sh,
               sl);
        }
      }
    }

    // S_C = diag(W) S_0 + sum_J diag(prod_{J'>J} W_J') K_J^T V_J on the
    // warp's rows of S
    if (owns_state) {
      const int i0 = mt * 16 + g, i1 = i0 + 8;
      const float w0 = fac[F_TOTAL * DK + i0], w1 = fac[F_TOTAL * DK + i1];
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        S[nt][0] *= w0;
        S[nt][1] *= w0;
        S[nt][2] *= w1;
        S[nt][3] *= w1;
      }
#pragma unroll
      for (int J = 0; J < NSUB; ++J) {
        uint32_t kh[4], kl[4];
        ldsm_a_t(kh, kj, SK, mt * 16, J * 16);
        ldsm_a_t(kl, kj + L::HALF_R, SK, mt * 16, J * 16);
        float part[NTW][4], plo[NTW][4];
        set_zero(part);
        set_zero(plo);
#pragma unroll
        for (int q = 0; q < NTW / 2; ++q)
          mma2(part[2 * q], part[2 * q + 1], plo[2 * q], plo[2 * q + 1], kh,
               kl, vf[J][q]);
        const float m0 = fac[(F_AFTER + J) * DK + i0];
        const float m1 = fac[(F_AFTER + J) * DK + i1];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          S[nt][0] = fmaf(m0, part[nt][0] + plo[nt][0], S[nt][0]);
          S[nt][1] = fmaf(m0, part[nt][1] + plo[nt][1], S[nt][1]);
          S[nt][2] = fmaf(m1, part[nt][2] + plo[nt][2], S[nt][2]);
          S[nt][3] = fmaf(m1, part[nt][3] + plo[nt][3], S[nt][3]);
        }
      }
    }
    if (full) {
      __syncthreads();
      // (4) o = A V + R_state S_0, on four chains of products summed at
      // the end
      float oacc[NTW][4], ox[NTW][4];
      set_zero(oacc);
      set_zero(ox);
#pragma unroll
      for (int J = 0; J < NSUB; ++J)
        if (J <= mt) {
          uint32_t fh[4], fl[4];
          ldsm_a(fh, sa, SA, mt * 16, J * 16);
          ldsm_a(fl, sa + L::HALF_A, SA, mt * 16, J * 16);
#pragma unroll
          for (int q = 0; q < NTW / 2; ++q)
            mma2(oacc[2 * q], oacc[2 * q + 1], ox[2 * q], ox[2 * q + 1], fh,
                 fl, vf[J][q]);
        }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          oacc[nt][e] += ox[nt][e] + (oy[nt][e] + oz[nt][e]);
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = c * C + mt * 16 + g + 8 * hh;
          if (t < Tlen)
            *reinterpret_cast<bf162*>(o + (row0 + t) * DV + jw0 + nt * 8
                                      + 2 * tg) =
                __floats2bfloat162_rn(oacc[nt][2 * hh], oacc[nt][2 * hh + 1]);
        }
    }
    __syncthreads();              // the stage is refilled, the operands
                                  // rewritten, in the next chunk
  }

  if (owns_state && blockIdx.x == gridDim.x - 1) {
    float* sl = s_last + bh * DK * DV;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = mt * 16 + g + 8 * hh;
        const int j = jw0 + nt * 8 + 2 * tg;
        *reinterpret_cast<float2*>(sl + i * DV + j) =
            make_float2(S[nt][2 * hh], S[nt][2 * hh + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *r, *k, *v, *w, *u;
  void* o;
  float* s_last;
  int B, H, T;
};

template <int DK, int DV>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const dim3 grid(DV / COLS_PER_BLOCK, a.H, a.B);
  rwkv6_f32_kernel<DK, DV><<<grid, F32_THREADS, 0, stream>>>(
      static_cast<const float*>(a.r), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.w),
      static_cast<const float*>(a.u), static_cast<float*>(a.o), a.s_last,
      a.H, a.T);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_tc(const Args& a, int segments, cudaStream_t stream) {
  using L = TcLayout<DK, DV>;
  auto kernel = rwkv6_tc_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(segments, a.H, a.B);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.w),
      static_cast<const bf16*>(a.u), static_cast<bf16*>(a.o), a.s_last, a.H,
      a.T);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype: 0 = float32 (the CUDA-core
// kernel; segments is not read), 1 = bfloat16 (the tensor-core kernel over
// `segments` runs of T's chunks a head, 1 <= segments <= ceil(T / C)).
// Built head sizes: Dk = Dv in {16, 64}.  T >= 1.  *kernel: 0 = CUDA cores, 1 = tensor
// cores, -1 = nothing launched.
// ---------------------------------------------------------------------------

extern "C" {

int lego_rwkv6(const void* r, const void* k, const void* v, const void* w,
               const void* u, void* o, void* s_last, int dtype, int B, int H,
               int T, int Dk, int Dv, int segments, void* stream,
               int* kernel) {
  *kernel = -1;
  if (segments < 1 || segments > (T + C - 1) / C) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{r, k, v, w, u, o, static_cast<float*>(s_last), B, H, T};
  if (dtype == 0) {
    *kernel = 0;
    if (Dk == 16 && Dv == 16) return launch_f32<16, 16>(a, st);
    if (Dk == 64 && Dv == 64) return launch_f32<64, 64>(a, st);
  }
  if (dtype == 1) {
    *kernel = 1;
#define LEGO_RWKV_TC(DK_, DV_) \
    if (Dk == DK_ && Dv == DV_) return launch_tc<DK_, DV_>(a, segments, st);
    LEGO_RWKV_TC_TILES(LEGO_RWKV_TC)
#undef LEGO_RWKV_TC
  }
  *kernel = -1;
  return cudaErrorInvalidValue;
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

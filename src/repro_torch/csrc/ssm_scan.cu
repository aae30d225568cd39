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
// and h_last (2.2 MB): 203.5 MB, 0.061 ms at 3.35 TB/s; its ~6 fp32 flops
// per (l, d, n) take 0.048 ms at 67 TFLOP/s.  Neither is the floor: its
// 537 M exps run on the special-function units (MUFU), 16 per SM per
// clock, about 0.13 ms on 132 SMs at 1.98 GHz.  A MUFU.EX2 per exp is 8
// cycles of a scheduler's MUFU pipe per warp, so the kernel is built to
// keep that pipe busy: every other instruction of a state's step has to
// fit in the same 8 cycles of issue.
//
// Design.  The (d, n) recurrences are independent and there are as many of
// them (Bt*Dm*N = 262,144 at the main shape) as threads the card holds, so
// the kernel keeps one pass over L (a segmented scan would need each decay
// twice) and spends its effort on the instructions of one step:
//  * one MUFU per exp: log2(e) is folded into A once and the exp is the
//    PTX ex2.approx.ftz.f32 (exp2f would add a denormal guard of three
//    instructions); a decay below 2^-126 flushes to zero, which moves h
//    by less than 1e-38 of its size;
//  * a consumer thread owns S consecutive states of one channel, so the
//    per-step loads of x, dt, B and C and the step's y are shared by S
//    states; the N / S lanes of a channel sit in different warps (lane p
//    of every channel in warp-sized runs), so a warp reads one B and C row
//    as a broadcast, and each lane writes its partial y to shared memory,
//    summed when the chunk is written out, so no shuffle sits on the
//    step's path.  One S is built for each N (the pairs come from the
//    header autotile writes: S = 8 at N = 16);
//  * per step a consumer reads x and dt (in the inputs' dtype, converted
//    at use) and B, C as fp32 float4 broadcasts from shared memory, then
//    per state: dt*a, ex2, dx*B, the h FMA and the y FMA (5 instructions;
//    about 6.5 a state at S = 8 with the step's own);
//  * the steps are software-pipelined: iteration g loads x, dt and B of
//    step g + 2 and C of step g + 1, computes the decays and inputs of
//    step g + 1, and updates h and y of step g.  The compiler does not do
//    this by itself (the loads of a step stay at its start and each warp
//    pays the load -> exp -> FMA -> y chain every step, ~250 cycles at the
//    main shape on an H100, whatever S or the warps a scheduler holds);
//    pipelined, the only chain between steps is the h FMA.  Whole chunks
//    are unrolled with every shared-memory offset a constant (the ring's
//    row arithmetic cost a quarter of the step's instructions); the last
//    one or two chunks take a generic loop;
//  * producer warps beside the 4 consumer warps keep device memory off
//    the consumers' path: into a ring of NST stages they copy chunks of CT
//    time steps of the block's x and dt columns with cp.async as they are
//    (a conversion pass cost more than the consumers' conversion at use)
//    and the B and C rows, converted to fp32 (read as broadcasts, 4 a
//    load), and they write each stepped chunk's y (the partials summed) in
//    16-byte stores; named barriers (full and empty per stage) order the
//    two sides.  Where x's rows are not 16-byte aligned (Dm not a multiple
//    of 16 bytes), or B's and C's rows not 16-byte aligned, the producers
//    load those element by element instead.
// Any L and any Dm are taken: rows past L and channels past Dm are masked,
// nothing is padded, and a partial last chunk is stepped only as far as L.
// Tensor cores do not apply: the decay differs per (d, n).
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#ifndef LEGO_SSM_TILES
#error "include the header written by repro_torch.kernels.autotile"
#endif

namespace {

constexpr int CT = LEGO_SSM_CHUNK;          // time steps per chunk
constexpr int CONS = LEGO_SSM_THREADS;      // consumer threads per block
constexpr int THREADS = CONS + 32 * LEGO_SSM_PRODUCERS;   // and producers
constexpr int NST = LEGO_SSM_STAGES;        // stages of the ring
constexpr float LOG2E = 1.4426950408889634f;
static_assert(CONS % 32 == 0 && 2 * NST < 16, "warps and named barriers");

// 2^v on the special-function unit, one MUFU.EX2; below 2^-126 it is 0
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// named barriers of the whole block: stage s is full (staged by the
// producers) or empty (stepped by the consumers, its partial y left)
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + NST + s; }
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(THREADS) : "memory");
}

// 16 bytes from global to shared memory, asynchronously; `bytes` of them
// are read, the rest zero-filled (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of raw elements to fp32
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// fp32 to 16 bytes of the output dtype (round to nearest even)
__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the block's shared memory: a ring of NST stages, each with the partial
// y [CT][CONS] and the B and C rows [CT][2N] in fp32 and the x and dt rows
// [2][CT][CPB] of the block's channels in the inputs' dtype (as copied);
// then two raw stages of the producers' copies of B and C [2][CT][N]
template <typename T, int N, int S>
struct Smem {
  static constexpr int LPC = N / S;            // lanes per channel
  static constexpr int CPB = CONS / LPC;       // channels per block
  static constexpr int Y = NST * CT * CONS;    // floats
  static constexpr int BC = NST * CT * 2 * N;
  static constexpr int XD = NST * 2 * CT * CPB;   // elements
  static constexpr int RAW_BC = 2 * CT * N;       // elements of one raw stage
  static constexpr int BYTES = 4 * (Y + BC) +
                               static_cast<int>(sizeof(T)) *
                                   (XD + 2 * RAW_BC);
  static_assert(N % S == 0 && S % 4 == 0 && CPB % 32 == 0, "tile");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// ---------------------------------------------------------------------------
// the kernel: one block per (CPB channels, batch row); VEC: x, dt and y rows
// are 16-byte aligned (Dm a multiple of 16 bytes, aligned bases); bc_async:
// B and C are copied asynchronously in 16-byte pieces (aligned bases, each
// batch row's start aligned), else loaded element by element
// ---------------------------------------------------------------------------

template <typename T, int N, int S, bool VEC>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dskip,
                T* __restrict__ y, float* __restrict__ h_last, int L,
                int Dm, bool bc_async) {
  using M = Smem<T, N, S>;
  constexpr int LPC = M::LPC, CPB = M::CPB;
  constexpr int EPL = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int ROWV = CPB / EPL;               // pieces of a row of the block

  extern __shared__ __align__(16) unsigned char smem[];
  float* sy = reinterpret_cast<float*>(smem);           // [NST][CT][CONS]
  float* sbc = sy + M::Y;                               // [NST][CT][2N]
  T* sxd = reinterpret_cast<T*>(sbc + M::BC);           // [NST][x|dt][CT][CPB]
  T* raw_bc = sxd + M::XD;                              // [2][B|C][CT][N]

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * CPB;
  const int64_t b = blockIdx.y;
  const int n_chunks = (L + CT - 1) / CT;

  if (tid >= CONS) {
    // ---- the producer warps -----------------------------------------------
    // Producer thread pt owns pieces pt, pt + PT, ... of each chunk: 16
    // bytes of x's and dt's rows (EPL elements) and of the contiguous B and
    // C rows (BPL elements); it converts only the B and C pieces it copied
    // (cp.async's wait makes them visible to it), and the full barrier
    // makes every copy visible to the consumers
    constexpr int PT = THREADS - CONS;
    constexpr int XD_PIECES = CT * ROWV;
    constexpr int BPL = 16 / static_cast<int>(sizeof(T));
    constexpr int BC_PIECES = CT * N / BPL;
    const int pt = tid - CONS;
    // chunk c's x and dt into stage s of the ring (copies where VEC, else
    // element by element) and B and C into raw stage c & 1 (copies where
    // bc_async), one commit group
    auto issue = [&](int c, int s) {
      const int t0 = c * CT;
      T* rx = sxd + s * 2 * CT * CPB;
      if constexpr (VEC) {
#pragma unroll
        for (int it = 0; it < (XD_PIECES + PT - 1) / PT; ++it) {
          const int e = pt + it * PT;
          if (XD_PIECES % PT != 0 && e >= XD_PIECES) break;
          const int t = e / ROWV, cv = (e % ROWV) * EPL;
          const bool ok = t0 + t < L && d0 + cv < Dm;
          const int64_t g = ok ? (b * L + t0 + t) * Dm + d0 + cv : 0;
          cp_async16(rx + t * CPB + cv, x + g, ok ? 16 : 0);
          cp_async16(rx + CT * CPB + t * CPB + cv, dt + g, ok ? 16 : 0);
        }
      } else {
        for (int u = pt; u < CT * CPB; u += PT) {
          const int t = u / CPB, cv = u % CPB;
          const bool ok = t0 + t < L && d0 + cv < Dm;
          const int64_t g = (b * L + t0 + t) * Dm + d0 + cv;
          rx[u] = ok ? x[g] : T(0.f);
          rx[CT * CPB + u] = ok ? dt[g] : T(0.f);
        }
      }
      if (bc_async) {
        // the chunk's valid B (and C) elements: whole rows up to L
        const int valid = max(0, min(CT, L - t0)) * N;
        const int64_t g0 = (b * L + t0) * N;
        T* rb = raw_bc + (c & 1) * M::RAW_BC;
#pragma unroll
        for (int it = 0; it < (BC_PIECES + PT - 1) / PT; ++it) {
          const int e = pt + it * PT;
          if (BC_PIECES % PT != 0 && e >= BC_PIECES) break;
          const int o = e * BPL;     // the rest of a piece past L zero-filled
          const int bytes =
              max(0, min(BPL, valid - o)) * static_cast<int>(sizeof(T));
          cp_async16(rb + o, Bm + (bytes ? g0 + o : 0), bytes);
          cp_async16(rb + CT * N + o, Cm + (bytes ? g0 + o : 0), bytes);
        }
      }
      cp_async_commit();
    };
    // chunk c's B and C, landed in raw stage c & 1 (or read from device
    // memory), in fp32 into stage s of the ring; a thread converts the
    // pieces it copied
    auto convert = [&](int c, int s) {
      const int t0 = c * CT;
      const T* rb = raw_bc + (c & 1) * M::RAW_BC;
      const int valid = max(0, min(CT, L - t0)) * N;
      const int64_t g0 = (b * L + t0) * N;
#pragma unroll
      for (int it = 0; it < (BC_PIECES + PT - 1) / PT; ++it) {
        const int e = pt + it * PT;
        if (BC_PIECES % PT != 0 && e >= BC_PIECES) break;
        const int o = e * BPL;
        float fb[BPL], fc[BPL];
        if (bc_async) {
          unpack(*reinterpret_cast<const uint4*>(rb + o), fb,
                 static_cast<const T*>(nullptr));
          unpack(*reinterpret_cast<const uint4*>(rb + CT * N + o), fc,
                 static_cast<const T*>(nullptr));
        } else {
#pragma unroll
          for (int i = 0; i < BPL; ++i) {
            fb[i] = o + i < valid ? to_f(Bm[g0 + o + i]) : 0.f;
            fc[i] = o + i < valid ? to_f(Cm[g0 + o + i]) : 0.f;
          }
        }
        // four elements at a time: one row's B (and C) run (4 divides N)
#pragma unroll
        for (int i = 0; i < BPL; i += 4) {
          float* row = sbc + (s * CT + (o + i) / N) * 2 * N + (o + i) % N;
          *reinterpret_cast<float4*>(row) =
              make_float4(fb[i], fb[i + 1], fb[i + 2], fb[i + 3]);
          *reinterpret_cast<float4*>(row + N) =
              make_float4(fc[i], fc[i + 1], fc[i + 2], fc[i + 3]);
        }
      }
    };
    // chunk c's y from stage s: the LPC partials of each channel summed,
    // rows past L and channels past Dm masked
    auto write_out = [&](int c, int s) {
      const int t0 = c * CT;
#pragma unroll
      for (int it = 0; it < (XD_PIECES + PT - 1) / PT; ++it) {
        const int e = pt + it * PT;
        if (XD_PIECES % PT != 0 && e >= XD_PIECES) break;
        const int t = e / ROWV, cv = (e % ROWV) * EPL, dd = d0 + cv;
        if (t0 + t >= L || dd >= Dm) continue;
        const float* part = sy + (s * CT + t) * CONS + cv;
        float f[EPL];
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          f[i] = part[i];
#pragma unroll
          for (int q = 1; q < LPC; ++q) f[i] += part[q * CPB + i];
        }
        T* out = y + (b * L + t0 + t) * Dm + dd;
        if constexpr (VEC)
          *reinterpret_cast<uint4*>(out) =
              pack(f, static_cast<const T*>(nullptr));
        else
          store1(out, f[0]);
      }
    };

    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % NST;
      if (c >= NST) {
        bar_sync(empty_bar(s));   // the consumers are done with chunk c - NST
        write_out(c - NST, s);
      }
      issue(c, s);
      cp_async_wait_all();        // this thread's copies of chunk c landed
      convert(c, s);
      bar_arrive(full_bar(s));
    }
    for (int c = n_chunks > NST ? n_chunks - NST : 0; c < n_chunks; ++c) {
      bar_sync(empty_bar(c % NST));
      write_out(c, c % NST);
    }
    return;
  }

  // ---- the consumer warps --------------------------------------------------
  const int p = tid / CPB;                   // this thread's lane in its channel
  const int j = tid % CPB;                   // and its channel
  const int d = d0 + j;
  const bool live = d < Dm;

  float a[S], h[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    a[i] = live ? A[static_cast<int64_t>(d) * N + p * S + i] * LOG2E : 0.f;
    h[i] = 0.f;
  }
  // lane 0 of a channel adds the skip x*D to its partial y
  const float dsk = live && p == 0 ? Dskip[d] : 0.f;

  // The steps are software-pipelined: iteration g loads the x, dt and B of
  // step g + 2 and the C of step g + 1, computes the decays and inputs of
  // step g + 1, and only then updates h and writes the partial y of step g
  // from what the two iterations before it prepared.  So no load's or
  // exp's latency sits on a step's path (the chain from one step to the
  // next is the h FMA).  Step k is row k & (RING - 1) of the ring; the
  // buffers of even and odd steps alternate, two steps a pass, so that
  // they are fixed registers.
  constexpr int RING = NST * CT;
  static_assert((RING & (RING - 1)) == 0 && CT % 2 == 0, "ring rows");
  struct Ahead { T x, dt; float4 b[S / 4]; };     // x, dt and B of a step
  struct Ready { float e[S], u[S], y0; };          // its decays and inputs
  Ahead P0, P1;                 // steps of even and odd index
  Ready R0, R1;
  float4 C0[S / 4], C1[S / 4];
  const T* sx = sxd + j;
  const float* sb = sbc + p * S;
  float* syp = sy + tid;

  auto load_ahead = [&](Ahead& q, int k) {
    const int r = k & (RING - 1);
    const T* xr = sx + (r / CT) * 2 * CT * CPB + (r % CT) * CPB;
    q.x = xr[0];
    q.dt = xr[CT * CPB];
#pragma unroll
    for (int i = 0; i < S / 4; ++i)
      q.b[i] = *reinterpret_cast<const float4*>(sb + r * 2 * N + 4 * i);
  };
  auto load_c = [&](float4 (&c)[S / 4], int k) {
    const int r = k & (RING - 1);
#pragma unroll
    for (int i = 0; i < S / 4; ++i)
      c[i] = *reinterpret_cast<const float4*>(sb + r * 2 * N + N + 4 * i);
  };
  auto prepare = [&](Ready& q, const Ahead& in) {
    const float xv = to_f(in.x), dv = to_f(in.dt);
    const float dx = dv * xv;
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      q.e[4 * i] = ex2(dv * a[4 * i]);
      q.e[4 * i + 1] = ex2(dv * a[4 * i + 1]);
      q.e[4 * i + 2] = ex2(dv * a[4 * i + 2]);
      q.e[4 * i + 3] = ex2(dv * a[4 * i + 3]);
      q.u[4 * i] = dx * in.b[i].x;
      q.u[4 * i + 1] = dx * in.b[i].y;
      q.u[4 * i + 2] = dx * in.b[i].z;
      q.u[4 * i + 3] = dx * in.b[i].w;
    }
    q.y0 = xv * dsk;
  };
  // a step's h and this lane's partial y from the prepared step and its C
  auto update = [&](const Ready& q, const float4 (&c)[S / 4]) -> float {
    float acc0 = q.y0, acc1 = 0.f;
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
      h[4 * i] = fmaf(q.e[4 * i], h[4 * i], q.u[4 * i]);
      h[4 * i + 1] = fmaf(q.e[4 * i + 1], h[4 * i + 1], q.u[4 * i + 1]);
      h[4 * i + 2] = fmaf(q.e[4 * i + 2], h[4 * i + 2], q.u[4 * i + 2]);
      h[4 * i + 3] = fmaf(q.e[4 * i + 3], h[4 * i + 3], q.u[4 * i + 3]);
      acc0 = fmaf(h[4 * i], c[i].x, acc0);
      acc1 = fmaf(h[4 * i + 1], c[i].y, acc1);
      acc0 = fmaf(h[4 * i + 2], c[i].z, acc0);
      acc1 = fmaf(h[4 * i + 3], c[i].w, acc1);
    }
    return acc0 + acc1;
  };
  // step k of any chunk (``pa`` receives step k + 2 and holds step k,
  // whose preparation is done; ``pb`` holds step k + 1), rows found by mask
  auto iter = [&](int k, Ahead& pa, const Ahead& pb, Ready& rk, Ready& rn,
                  float4 (&ck)[S / 4], float4 (&cn)[S / 4]) {
    if (k + 2 < L) {
      if (((k + 2) & (CT - 1)) == 0) bar_sync(full_bar(((k + 2) / CT) % NST));
      load_ahead(pa, k + 2);
    }
    if (k + 1 < L) {
      load_c(cn, k + 1);
      prepare(rn, pb);
    }
    syp[(k & (RING - 1)) * CONS] = update(rk, ck);
    if ((k & (CT - 1)) == CT - 1 || k == L - 1)
      bar_arrive(empty_bar((k / CT) % NST));
  };

  // a whole chunk c whose successor holds at least two steps, unrolled:
  // every row is a constant offset from the chunk's stage or the next one
  auto chunk = [&](int c) {
    const int s = c % NST, sn = (c + 1) % NST;
    const T* xc = sx + s * 2 * CT * CPB;
    const T* xn = sx + sn * 2 * CT * CPB;
    const float* bcur = sb + s * CT * 2 * N;
    const float* bnxt = sb + sn * CT * 2 * N;
    float* yc = syp + s * CT * CONS;
    auto fixed = [&](int t, Ahead& pa, const Ahead& pb, Ready& rk,
                     Ready& rn, float4 (&ck)[S / 4], float4 (&cn)[S / 4]) {
      if (t + 2 == CT) bar_sync(full_bar(sn));
      const T* xr = t + 2 < CT ? xc + (t + 2) * CPB : xn + (t + 2 - CT) * CPB;
      const float* br = t + 2 < CT ? bcur + (t + 2) * 2 * N
                                   : bnxt + (t + 2 - CT) * 2 * N;
      pa.x = xr[0];
      pa.dt = xr[CT * CPB];
#pragma unroll
      for (int i = 0; i < S / 4; ++i)
        pa.b[i] = *reinterpret_cast<const float4*>(br + 4 * i);
      const float* cr = t + 1 < CT ? bcur + (t + 1) * 2 * N + N
                                   : bnxt + N;
#pragma unroll
      for (int i = 0; i < S / 4; ++i)
        cn[i] = *reinterpret_cast<const float4*>(cr + 4 * i);
      prepare(rn, pb);
      yc[t * CONS] = update(rk, ck);
      if (t == CT - 1) bar_arrive(empty_bar(s));
    };
#pragma unroll
    for (int t = 0; t < CT; t += 2) {
      fixed(t, P0, P1, R0, R1, C0, C1);
      fixed(t + 1, P1, P0, R1, R0, C1, C0);
    }
  };

  bar_sync(full_bar(0));
  load_ahead(P0, 0);
  load_c(C0, 0);
  prepare(R0, P0);
  if (L > 1) load_ahead(P1, 1);
  int k = 0;
  for (; k + CT + 2 <= L; k += CT) chunk(k / CT);
  // the rest (at most CT + 1 steps), one step at a time
  for (; k + 1 < L; k += 2) {
    iter(k, P0, P1, R0, R1, C0, C1);
    iter(k + 1, P1, P0, R1, R0, C1, C0);
  }
  if (k < L) iter(k, P0, P1, R0, R1, C0, C1);

  if (live) {
    float4* hb = reinterpret_cast<float4*>(h_last + (b * Dm + d) * N + p * S);
#pragma unroll
    for (int i = 0; i < S; i += 4)
      hb[i / 4] = make_float4(h[i], h[i + 1], h[i + 2], h[i + 3]);
  }
}

// the kernel's dynamic shared memory (above the default 48 KB)
template <typename K>
cudaError_t configure(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int N, int S, bool VEC>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* B, const void* C, const float* D, void* y,
                   float* h_last, int Bt, int L, int Dm, bool bc_async,
                   cudaStream_t stream) {
  using M = Smem<T, N, S>;
  auto kernel = ssm_scan_kernel<T, N, S, VEC>;
  cudaError_t err = configure(kernel, M::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((Dm + M::CPB - 1) / M::CPB, Bt);
  kernel<<<grid, THREADS, M::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), h_last, L, Dm, bc_async);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int N, bool vec, bool bc_async, const void* x,
                        const void* dt, const float* A, const void* B,
                        const void* C, const float* D, void* y,
                        float* h_last, int Bt, int L, int Dm,
                        cudaStream_t st) {
#define LEGO_SSM_TILE(N_, S_)                                               \
  if (N == N_)                                                              \
    return vec ? launch<T, N_, S_, true>(x, dt, A, B, C, D, y, h_last, Bt,  \
                                         L, Dm, bc_async, st)               \
               : launch<T, N_, S_, false>(x, dt, A, B, C, D, y, h_last, Bt, \
                                          L, Dm, bc_async, st);
  LEGO_SSM_TILES(LEGO_SSM_TILE)
#undef LEGO_SSM_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (loaded with ctypes).  dtype of x, dt, B, C and y: 0 = float32,
// 1 = bfloat16; A, D and h_last are float32.  N: a state size the header
// lists.  L >= 1.
// ---------------------------------------------------------------------------

extern "C" {

int lego_ssm_scan(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, const void* D, void* y, void* h_last,
                  int dtype, int Bt, int L, int Dm, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* hl = static_cast<float*>(h_last);
  const int esize = dtype == 0 ? 4 : 2;
  const bool vec = (static_cast<int64_t>(Dm) * esize) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const uintptr_t bc = reinterpret_cast<uintptr_t>(B) |
                       reinterpret_cast<uintptr_t>(C);
  const bool bc_async =
      bc % 16 == 0 && (static_cast<int64_t>(L) * N * esize) % 16 == 0;
  if (dtype == 0)
    return launch_tile<float>(N, vec, bc_async, x, dt, Af, B, C, Df, y, hl,
                              Bt, L, Dm, st);
  if (dtype == 1)
    return launch_tile<__nv_bfloat16>(N, vec, bc_async, x, dt, Af, B, C, Df,
                                      y, hl, Bt, L, Dm, st);
  return cudaErrorInvalidValue;
}

const char* lego_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

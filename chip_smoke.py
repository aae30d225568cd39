#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Phases, each of which stops the run with a non-zero exit on failure:

1. device: one sm_90 card; prints ``nvidia-smi``'s name and power limit;
2. build: compiles every ``src/repro_torch/csrc/*.cu`` with nvcc (one process
   per source, all at once) and prints the build time, registers and
   spills;
3. each CUDA kernel against its plain PyTorch version on the card: the
   GEMM over the reference's shapes, ragged, decode-shaped (M = 1, 7),
   unaligned and one large product, in both dtypes, each aligned bf16 one
   checked to have gone to the wgmma kernel, and the wgmma kernel's edge
   shapes, split-K and a walk over more tiles than SMs at every built tile
   over 1 and 3 splits, every bf16 product also against the fp32 product
   relative to its row scale (``ref.gemm_rel_err``); flash attention over
   GQA / window / softcap / ragged / dtype / head_dim cases (head_dim 96
   causal, non-causal over 1500 keys, and in decode), every instantiation
   of each dtype's prefill kernel (bf16 on the tensor cores, fp32 on the
   CUDA cores), and ragged multi-head, Tq = 1, offset + window, GQA group
   1 / 4 / 32 and softcap at head_dim 256 cases at each built tile, head
   by head, every bf16 prefill also against the plain version in fp32
   relative to the output's row scale; K2 decode (split across blocks)
   at GQA groups 1 / 2 / 4 / 8, S = 4096 and 4097, pos at 0, 100, the
   chunk edges, S/2 and S - 1, windows and softcap, and Gemma-2's 4096
   window over 8192 positions, bf16 also against the fp32 plain version;
   the RWKV-6 recurrence
   over dtype / head size / (B, H) / ragged T; the Mamba selective scan over
   dtype / state size / (Bt, L, Dm);
4. the main paths, in bf16 with random weights from a seeded generator, the
   kernels' launch counters reset before and read after each run (and
   every K2 prefill launch checked to have been reported by the library as
   a launch of the tensor-core kernel):
   a. Mistral-NeMo-12B at full width and depth — ``forward`` on a
      2048-token prompt and ``generate`` (batch 4, prompt 16, 24 new);
      then decode steps at batch 4 over a 4096-position cache (every K2
      decode call split), on the host clock and, for one step, its
      device-busy time and K2 decode's part of it from ``torch.profiler``;
   b. RWKV-6 7B at full width and depth — the same two runs (``forward``
      through the wkv kernel once per layer, ``generate`` through the plain
      recurrence step, as in the reference);
   c. Jamba-1.5-Large at full width, the first 7 layers of its 8-layer
      period (a whole period does not fit the card) — the same two runs
      (``forward`` through the scan kernel once per Mamba layer and the
      attention kernel once; ``generate`` through the plain Mamba step);
   d. Whisper-base at full width and depth — ``forward_encdec`` over 4 x
      1500 frames and 128 tokens, ``encode``, and a teacher-forced + greedy
      loop (batch 4, prompt 16, 24 new) through ``build_serve_step``;
   e. Phi-3-vision 4.2B at full width and depth — ``forward`` on a
      576-patch prefix + 1472 tokens and ``generate`` (batch 4, 16 + 24);
   f. ``ops.gemm``, K1's entry point (no model path runs it, as in the
      reference): the micro-bench's 512^3 fp32 product and Mistral-NeMo's
      up-projection at T = 2048 in bf16, the latter checked to have gone to
      the wgmma kernel as the library reports it;
5. fp32 consistency at Mistral-NeMo and RWKV-6 width (depth 2), at Jamba
   width (Mamba, Mamba + MoE and attention layers, capacity factor 8.0),
   at Whisper-base's full width and at Phi-3-vision's width (depth 2, with
   the prefix): teacher-forced decode steps against the forward, and the
   forward through the kernels against the plain path on the card;
6. Gemma-2 smoke width (window, softcap, post-norms, tied head) and Jamba
   smoke width in fp32 at its own capacity factor (MoE drops in decode)
   through ``generate``, kernels against the plain path;
7. each kernel timed with CUDA events (after 0.1 s of warm-up calls) at the
   main paths' shapes beside its bound, its plain version and, where there
   is one, one PyTorch library call (a yardstick the port never calls),
   with the card's clock, power and temperature logged before and after;
   K1 also at 512^3 fp32 and the decode-shaped (1 and 7) x 5120 . (5120 x
   5120) in bf16 (as CUDA graphs, eager calls logged), with every built
   tile's time at each, K2 prefill also at Phi-3-vision's, Whisper's
   encoder and Whisper's cross-attention step shapes, with every built
   tile's time at each and the output also held to the fp32 plain version;
   K2 decode at Mistral-NeMo's, Phi-3-vision's, Jamba's, Gemma-2's
   (window 4096 over 8192) and phase 4's (40 positions) shapes, the kernel
   and SDPA timed as CUDA graphs (the eager calls are paced by the host).

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.
Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_TOL, BF16_TOL = 2e-4, 3e-2
SCAN_TOL = 1e-4             # tests/test_kernels.py's fp32 tolerance for scans
GEMM_F32_TOL, GEMM_BF16_TOL = 1e-5, 2e-2   # ... and for the GEMM
GEMM = dict(source="src/repro_torch/csrc/gemm.cu",
            replaces="src/repro/kernels/gemm.py:26")
FLASH = dict(source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:34")
RWKV = dict(source="src/repro_torch/csrc/rwkv6.cu",
            replaces="src/repro/kernels/rwkv6.py:25")
SSM = dict(source="src/repro_torch/csrc/ssm_scan.cu",
           replaces="src/repro/kernels/ssm_scan.py:28")
BF16_ULP = 2.0 ** -7        # one bf16 ulp, relative
# bf16 K2 prefill against the plain version in fp32 from the same inputs,
# relative to |want| plus the rms of want's row (ref.attention_rel_err):
# the reference's own roundings (P and O to bf16) read up to 2.6 x 2^-8 on
# this file's cases, a kv tile skipped in long rows or late rows 10% off
# read 0.08 and more; the 3e-2 gate alone does not see the latter
BF16_REL_TOL = 3 * BF16_ULP
# bf16 K1 against the product in fp32 from the same inputs, relative to
# |want| plus the rms of want's row (ref.gemm_rel_err): one rounding reads
# at most 2^-8; a k16 slice dropped or a stale ring stage at K = 5120 reads
# a few hundredths, which the 2e-2 gate can miss where |want| is large
GEMM_REL_TOL = 2 * BF16_ULP
# K1 cases (M, K, N): the reference's shapes, ragged, decode-shaped, K and
# N not multiples of 8, and the up-projection; then the wgmma kernel's
# edges (tests/test_torch_cuda.py holds the same): M, N, K not multiples
# of the tile, K below a k-step, M below a warpgroup's rows, M = 1, N = 8,
# 512^3 (split-K in fp32), and more output tiles than SMs
GEMM_CASES = ((32, 64, 32), (64, 32, 48), (16, 16, 128), (33, 70, 45),
              (1, 5120, 5120), (7, 5120, 5120), (100, 77, 123),
              (257, 1001, 250), (2048, 5120, 14336))
GEMM_EDGES = ((200, 328, 392), (130, 40, 264), (33, 136, 520),
              (1, 2000, 1000), (64, 8, 136), (129, 72, 8), (512, 512, 512),
              (2176, 200, 4104))
# K2 prefill edge cases, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap,
# offset); tests/test_torch_cuda.py holds the same
EDGE_CASES = (
    (2, 4, 2, 77, 150, 64, False, None, None, 0),
    (3, 4, 4, 33, 333, 96, True, None, None, 300),
    (4, 8, 8, 1, 1500, 64, False, None, None, 0),
    (1, 8, 2, 64, 512, 128, True, 256, None, 448),
    (1, 4, 1, 100, 612, 128, True, 40, None, 512),
    (2, 4, 4, 130, 130, 64, True, None, None, 0),
    (2, 16, 4, 130, 130, 64, True, None, None, 0),
    (1, 32, 1, 130, 130, 32, True, None, None, 0),
    (2, 8, 4, 200, 200, 256, True, None, 50.0, 0),
    (1, 4, 2, 77, 130, 256, False, 30, 30.0, 0),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check_close(name, got, want, tol, quiet=False) -> float:
    """|got - want| <= tol + tol*|want| everywhere; returns the max abs error
    (logged unless ``quiet``; a failure is always reported)."""
    import torch
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    diff = (got.float() - want.float()).abs()
    excess = (diff - tol * want.float().abs()).max().item()
    err = diff.max().item()
    if not quiet or excess > tol:
        log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g})")
    if excess > tol:
        fail(f"{name}: outside tolerance {tol}")
    return err


def check_rel(name, got, q, k, v, kw, quiet=False) -> float:
    """A bf16 K2 output (prefill, or decode as Tq = 1 at offset pos) within
    ``BF16_REL_TOL`` of the plain version computed in fp32
    (``ref.attention_rel_err``); returns the reading."""
    from repro_torch.kernels import ref as R
    err = R.attention_rel_err(got, q, k, v, **kw)
    if not quiet or err > BF16_REL_TOL:
        log(f"  {name}: rel_err={err:.3e} (tol {BF16_REL_TOL:g} of |want| "
            "+ row rms, fp32 plain)")
    if err > BF16_REL_TOL:
        fail(f"{name}: outside {BF16_REL_TOL:g} of the fp32 plain version")
    return err


def check_gemm(name, got, x, w, quiet=False) -> float:
    """A K1 output against the plain version on the same inputs: fp32
    within 1e-5 of the output's scale; bf16 within 2e-2 and within
    ``GEMM_REL_TOL`` of the product in fp32 (``ref.gemm_rel_err``).
    Returns the max abs error."""
    import torch

    from repro_torch.kernels import ref as R
    want = R.gemm_ref(x, w)
    if got.dtype != want.dtype:
        fail(f"{name}: dtype {got.dtype}, want {want.dtype}")
    if want.dtype == torch.float32:
        return check_scaled(name, got, want, GEMM_F32_TOL, quiet=quiet)
    err = check_close(name, got, want, GEMM_BF16_TOL, quiet=True)
    rel = R.gemm_rel_err(got, x, w)
    if not quiet or rel > GEMM_REL_TOL:
        log(f"  {name}: max_abs_err={err:.3e} (tol {GEMM_BF16_TOL:g}), "
            f"rel_err={rel:.3e} (tol {GEMM_REL_TOL:g} of |want| + row rms, "
            "fp32 product)")
    if rel > GEMM_REL_TOL:
        fail(f"{name}: outside {GEMM_REL_TOL:g} of the fp32 product")
    return err


def check_scaled(name, got, want, tol, quiet=False) -> float:
    """max |got - want| <= tol * max(1, max |want|): an fp32 product of K
    terms summed in another order than cuBLAS's differs near zero by far
    more than tol, so the tolerance is relative to the output's scale.
    Returns the max abs error."""
    import torch
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype}, want "
             f"{tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if not quiet or err > tol * scale:
        log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g} x scale "
            f"{scale:.3g})")
    if err > tol * scale:
        fail(f"{name}: outside tolerance {tol} x {scale:.3g}")
    return err


def time_ms(fn, reps: int = 20, warm_s: float = 0.1,
            graph: bool = False) -> float:
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, after at
    least 3 calls and ``warm_s`` seconds of them (the clocks settle).  With
    ``graph`` the ``reps`` calls are captured once in a CUDA graph and 5
    replays are timed: the device's time per call, where an eager call
    that the host issues slower than the card runs it is timed at the
    host's pace."""
    import torch
    t0, n = time.perf_counter(), 0
    while n < 3 or time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        n += 1
    run, runs, calls = fn, reps, reps
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        run, runs, calls = g.replay, 5, 5 * reps
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < warm_s:
            g.replay()
            torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def on_tensor_cores(n: int) -> str:
    """Fails unless all ``n`` K2 prefill launches since the counters were
    reset went, as the library reports, to the tensor-core kernel (the only
    bf16 route); returns the log's note."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    tc = flash_attention_cuda.tensor_core_launches
    if tc != n:
        fail(f"{tc} of {n} bf16 K2 prefill launches took the tensor-core "
             "kernel")
    return f"K2 prefill on the tensor-core kernel: {tc} of {n}"


def bound(flops: float, nbytes: float,
          dtype_bytes: int) -> tuple[float, str]:
    """The least time (ms) for ``flops`` at the H100's peak rate for the
    element size (dense bf16 tensor cores, fp32 outside them) and ``nbytes``
    at its HBM3 rate, and which of the two bounds it.  The rates are
    ``autotile``'s, which its split-K model uses too."""
    from repro_torch.kernels.autotile import PEAK_BYTES, PEAK_FLOPS
    t_ops = flops / PEAK_FLOPS[dtype_bytes]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, autotile, ops
    from repro_torch.kernels import ref as R
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     decode_attention_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.gemm import gemm_cuda
    from repro_torch.kernels.rwkv6 import HEAD_DIMS as RWKV_HEAD_DIMS
    from repro_torch.kernels.rwkv6 import rwkv6_cuda
    from repro_torch.kernels.ssm_scan import STATE_DIMS, ssm_scan_cuda
    from repro_torch.models import blocks
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import generate

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs the card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        fail(f"need an sm_90 card, got {torch.cuda.get_device_capability(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    # fp32 products run in full fp32 (no TF32) in the projections and refs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"phase 2 build: {', '.join(_build.sources())} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        spills = [ln for ln in text.splitlines()
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln]
        regs = [int(ln.split("Used ")[1].split()[0])
                for ln in text.splitlines() if "Used " in ln]
        # ptxas's note that it serialized a kernel's wgmma (C7518), e.g.
        # for a wgmma issued in a divergent branch
        serial = sum("C7518" in ln for ln in text.splitlines())
        log(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, {len(spills)} with spills, {serial} with wgmma "
            f"serialized (log: {_build.lib_path(name).with_suffix('.log')})")

    gen = torch.Generator(dev).manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rwkv_inputs(B, H, T, D, dtype):
        """r, k, v, w, u as tests/test_kernels.py draws them: w in (0, 1)."""
        r, v = rand(B, H, T, D, dtype=dtype), rand(B, H, T, D, dtype=dtype)
        k = (0.3 * rand(B, H, T, D, dtype=torch.float32)).to(dtype)
        w = torch.sigmoid(rand(B, H, T, D, dtype=torch.float32) + 2.0)
        u = (0.1 * rand(H, D, dtype=torch.float32)).to(dtype)
        return r, k, v, w.to(dtype), u

    def ssm_inputs(Bt, L, Dm, N, dtype):
        """x, dt, A, B, C, D as tests/test_kernels.py draws them (dt after a
        softplus, A < 0); A and D fp32, as the Mamba block passes them."""
        x = rand(Bt, L, Dm, dtype=dtype)
        dt = torch.nn.functional.softplus(
            rand(Bt, L, Dm, dtype=torch.float32) - 1.0).to(dtype)
        A = -torch.exp(0.5 * rand(Dm, N, dtype=torch.float32))
        B, C = rand(Bt, L, N, dtype=dtype), rand(Bt, L, N, dtype=dtype)
        return x, dt, A, B, C, torch.full((Dm,), 0.5, device=dev)

    # ---- 3. kernels against their plain versions ---------------------------
    log("phase 3 kernels vs plain")
    t0 = time.perf_counter()
    # K1: (M, K, N); fp32 within 1e-5 of the output's scale, bf16 2e-2 and
    # 2 bf16 ulps of the fp32 product (ref.gemm_rel_err).  Through ops.gemm
    # (the picked tile and split; every aligned bf16 product on the wgmma
    # kernel, as the library reports it), and the wgmma edge and split
    # shapes also at every built tile over 1 and 3 splits
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for (M, K, N), edge in [(c, False) for c in GEMM_CASES] + \
                [(c, True) for c in GEMM_EDGES]:
            x, w = rand(M, K, dtype=dtype), rand(K, N, dtype=dtype)
            t = autotile.gemm_tiles(M, N, K, x.element_size())
            splits = autotile.gemm_splits(M, N, K, t, x.element_size())
            name = (f"gemm {tag} ({M}x{K})@({K}x{N}) tiles=({t.bm},{t.bn},"
                    f"{t.bk}) splits={splits}")
            tc = gemm_cuda.wgmma_launches
            got = ops.gemm(x, w)
            aligned = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
            if gemm_cuda.wgmma_launches - tc != int(aligned):
                fail(f"{name}: {gemm_cuda.wgmma_launches - tc} launches of "
                     f"the wgmma kernel, want {int(aligned)}")
            runs = [(name, got)]
            if edge:
                for tb, tn, tk in autotile.GEMM_TILES[x.element_size()]:
                    for sp in sorted({1, min(3, -(-K // tk))}):
                        runs.append((f"  at ({tb},{tn},{tk}) splits={sp}",
                                     gemm_cuda(x, w, bm=tb, bn=tn, bk=tk,
                                               splits=sp)))
            for label, out in runs:
                check_gemm(label, out, x, w, quiet=label != name)
            del x, w, got, runs
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        cases = [((32, 8, 128), 384, 384, True, None, None, 0),
                 ((32, 32, 96), 2048, 2048, True, None, None, 0),
                 ((8, 8, 96), 333, 1500, False, None, None, 0),
                 ((8, 8, 64), 1, 1500, False, None, None, 0),
                 ((16, 8, 256), 384, 384, True, None, None, 0),
                 ((4, 1, 128), 384, 384, True, None, None, 0)]
        for window in (None, 16, 4096):
            for cap in (None, 50.0):
                T = 4224 if window == 4096 else 640
                heads = (16, 8, 256) if cap else (32, 8, 128)
                cases.append((heads, T, T, True, window, cap, 0))
        cases += [((32, 8, 128), 200, 333, False, None, None, 0),
                  ((16, 8, 256), 77, 130, False, None, 50.0, 0),
                  ((32, 8, 128), 64, 512, True, 256, None, 448)]
        for (Hq, Hkv, D), Tq, Tk, causal, window, cap, off in cases:
            q, k, v = (rand(1, Hq, Tq, D, dtype=dtype),
                       rand(1, Hkv, Tk, D, dtype=dtype),
                       rand(1, Hkv, Tk, D, dtype=dtype))
            kw = dict(causal=causal, window=window, softcap=cap, offset=off)
            got = ops.flash_attention(q, k, v, **kw)
            name = (f"prefill {tag} H=({Hq},{Hkv}) D={D} Tq={Tq} Tk={Tk} "
                    f"causal={causal} window={window} softcap={cap} "
                    f"offset={off}")
            check_close(name, got, R.attention_ref(q, k, v, **kw), tol)
            if dtype == torch.bfloat16:
                check_rel(name, got, q, k, v, kw)
        # every built (head_dim, bq, bk) instantiation of the dtype's
        # kernel, ragged and windowed
        route = "tensor-core" if dtype == torch.bfloat16 else "CUDA-core"
        for D in HEAD_DIMS:
            q, k, v = (rand(2, 4, 150, D, dtype=dtype),
                       rand(2, 2, 150, D, dtype=dtype),
                       rand(2, 2, 150, D, dtype=dtype))
            want = R.attention_ref(q, k, v, window=40, softcap=30.0)
            for bq, bk in autotile.attention_built_tiles(D, q.element_size()):
                got = flash_attention_cuda(q, k, v, bq=bq, bk=bk, window=40,
                                           softcap=30.0)
                name = (f"prefill {tag} {route} D={D} tiles=({bq},{bk}) "
                        "T=150 window=40 softcap=30")
                check_close(name, got, want, tol)
                if dtype == torch.bfloat16:
                    check_rel(name, got, q, k, v,
                              dict(window=40, softcap=30.0))
            q1 = q[:, :, :1].contiguous()
            pos = torch.tensor(97, dtype=torch.int32, device=dev)
            check_close(f"decode {tag} D={D} S=150 pos=97 window=40",
                        decode_attention_cuda(q1, k, v, pos, window=40),
                        R.decode_attention_ref(q1, k, v, window=40, pos=97),
                        tol)
        # ragged Tq and Tk with B*H > 1 (a tile past T reads and writes no
        # row of the next head), Whisper's cross step, offset + window, GQA
        # groups 1 / 4 / 32 and softcap at D = 256: every head, every tile
        for B, Hq, Hkv, Tq, Tk, D, causal, window, cap, off in EDGE_CASES:
            q, k, v = (rand(B, Hq, Tq, D, dtype=dtype),
                       rand(B, Hkv, Tk, D, dtype=dtype),
                       rand(B, Hkv, Tk, D, dtype=dtype))
            kw = dict(causal=causal, window=window, softcap=cap, offset=off)
            want = R.attention_ref(q, k, v, **kw)
            rel = []
            for bq, bk in autotile.attention_built_tiles(D, q.element_size()):
                got = flash_attention_cuda(q, k, v, bq=bq, bk=bk, **kw)
                name = (f"prefill {tag} {route} B={B} H=({Hq},{Hkv}) D={D} "
                        f"Tq={Tq} Tk={Tk} causal={causal} window={window} "
                        f"softcap={cap} offset={off} tiles=({bq},{bk})")
                if dtype == torch.bfloat16:
                    rel.append(check_rel(name, got, q, k, v, kw, quiet=True))
                for b in range(B):
                    for h in range(Hq):
                        check_close(f"{name} b={b} h={h}", got[b, h],
                                    want[b, h], tol, quiet=True)
            log(f"  prefill {tag} {route} B={B} H=({Hq},{Hkv}) D={D} Tq={Tq} "
                f"Tk={Tk} causal={causal} window={window} softcap={cap} "
                f"offset={off}: every head within {tol:g} at tiles "
                f"{autotile.attention_built_tiles(D, q.element_size())}"
                + (f", rel_err at most {max(rel):.3e} (tol "
                   f"{BF16_REL_TOL:g})" if rel else ""))
        # K2 decode, split across blocks: GQA groups 4 / 2 / 1 / 8
        # (Mistral-NeMo, Gemma-2, Phi-3-vision, Jamba), S whole and ragged
        # (4097: a last chunk of one row), pos at 0, 100, the chunk edges
        # L - 1 and L, S/2 and S - 1, windows that leave whole chunks out
        # or cross an edge, softcap; and Gemma-2's 4096 window over 8192
        # positions; bf16 also against the fp32 plain version
        dec_cases = [(heads, S, window, cap)
                     for heads in ((32, 8, 128), (16, 8, 256), (32, 32, 96),
                                   (64, 8, 128))
                     for S in (4096, 4097)
                     for window, cap in ((None, None), (16, 50.0),
                                         (1000, None))]
        dec_cases.append(((16, 8, 256), 8192, 4096, 50.0))
        for (Hq, Hkv, D), S, window, cap in dec_cases:
            q = rand(4, Hq, 1, D, dtype=dtype)
            k, v = rand(4, Hkv, S, D, dtype=dtype), rand(4, Hkv, S, D,
                                                         dtype=dtype)
            L, splits = autotile.decode_splits(4, Hkv, Hq // Hkv, S, D,
                                               q.element_size())
            name = (f"decode {tag} H=({Hq},{Hkv}) D={D} S={S} "
                    f"window={window} softcap={cap} chunk={L} "
                    f"splits={splits}")
            errs, rel = [], []
            for pos in sorted({0, 100, L - 1, L, S // 2, S - 1}):
                pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
                kw = dict(window=window, softcap=cap)
                got = ops.decode_attention(q, k, v, pos=pos_t, **kw)
                errs.append(check_close(
                    f"{name} pos={pos}", got,
                    R.decode_attention_ref(q, k, v, pos=pos, **kw), tol,
                    quiet=True))
                if dtype == torch.bfloat16:
                    rel.append(check_rel(
                        f"{name} pos={pos}", got, q, k, v,
                        dict(causal=True, offset=pos, **kw), quiet=True))
            log(f"  {name}: pos 0, 100, L-1, L, S/2, S-1 within {tol:g}, "
                f"max_abs_err {max(errs):.3e}"
                + (f", rel_err at most {max(rel):.3e} (tol "
                   f"{BF16_REL_TOL:g})" if rel else ""))
    # the RWKV-6 recurrence: o at the dtype's tolerance; S_last is fp32 from
    # the same rounded inputs on both sides, so it is held at the scan's
    for dtype, tol in ((torch.float32, SCAN_TOL), (torch.bfloat16, BF16_TOL)):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for Dk, _ in RWKV_HEAD_DIMS:
            for B, H in ((1, 64), (2, 4)):
                for T in (1, 16, 77, 2048):
                    args = rwkv_inputs(B, H, T, Dk, dtype)
                    o, s_last = rwkv6_cuda(*args)
                    o_ref, s_ref = R.rwkv6_ref(*args)
                    name = f"rwkv6 {tag} D={Dk} B={B} H={H} T={T}"
                    check_close(f"{name} o", o, o_ref, tol)
                    check_close(f"{name} S_last", s_last, s_ref, SCAN_TOL)
    # the Mamba selective scan: y and h_last are fp32 sums of the same
    # inputs on both sides (1e-4); a bf16 y is rounded once from them, so
    # the two may differ by one bf16 ulp
    for dtype, tol in ((torch.float32, SCAN_TOL), (torch.bfloat16, BF16_ULP)):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for N in STATE_DIMS:
            for Bt, L, Dm in ((1, 2048, 16384), (2, 77, 48), (2, 1, 32),
                              (2, 16, 32)):
                args = ssm_inputs(Bt, L, Dm, N, dtype)
                y, h_last = ssm_scan_cuda(*args)
                y_ref, h_ref = R.selective_scan_ref(*args)
                name = f"ssm_scan {tag} N={N} Bt={Bt} L={L} Dm={Dm}"
                check_close(f"{name} y", y, y_ref, tol)
                check_close(f"{name} h_last", h_last, h_ref, SCAN_TOL)
    torch.cuda.synchronize()
    log(f"phase 3 done in {time.perf_counter() - t0:.1f}s")

    # ---- 4. main paths at full width and depth, bf16 ----------------------
    counters = (flash_attention_cuda, decode_attention_cuda, rwkv6_cuda,
                ssm_scan_cuda, gemm_cuda)

    def reset():
        for c in counters:
            c.launches = 0
        flash_attention_cuda.tensor_core_launches = 0
        decode_attention_cuda.split_launches = 0
        gemm_cuda.wgmma_launches = 0

    def launches():
        """(flash prefill, flash decode, rwkv6, ssm_scan, gemm) launches
        since reset()."""
        return tuple(c.launches for c in counters)

    # a. Mistral-NeMo-12B: K2 prefill once per layer in forward, K2 decode
    #    once per layer and step in generate (one split: the cache holds
    #    40 positions); then decode steps over a 4096-position cache, where
    #    every K2 decode call splits
    cfg = get_config("mistral_nemo_12b")
    L = cfg.n_layers
    log(f"phase 4a main path: {cfg.name} d_model={cfg.d_model} "
        f"heads=({cfg.n_heads},{cfg.n_kv_heads}) head_dim={cfg.hd} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} depth {L} of {L} (no cut) "
        f"dtype={cfg.dtype}")
    fwd_launches, gen_launches = _serve(
        cfg, 0, dev, gen, reset, launches, want_fwd=(L, 0, 0, 0, 0),
        want_gen=lambda steps: (0, L * steps, 0, 0, 0),
        then=lambda params: _long_cache(cfg, params, dev, gen, reset,
                                        launches))

    # b. RWKV-6 7B: K4 once per layer in forward; generate runs the plain
    #    recurrence step (as the reference does) and launches no kernel
    rcfg = get_config("rwkv6_7b")
    RL = rcfg.n_layers
    log(f"phase 4b main path: {rcfg.name} d_model={rcfg.d_model} heads="
        f"{rcfg.d_model // rcfg.rwkv_head_dim}x{rcfg.rwkv_head_dim} "
        f"decay_rank={rcfg.rwkv_decay_rank} d_ff={rcfg.d_ff} "
        f"vocab={rcfg.vocab_size} depth {RL} of {RL} (no cut) "
        f"dtype={rcfg.dtype}")
    rwkv_fwd_launches, _ = _serve(
        rcfg, 3, dev, gen, reset, launches, want_fwd=(0, 0, RL, 0, 0),
        want_gen=lambda steps: (0, 0, 0, 0, 0))

    # c. Jamba-1.5-Large: K3 once per Mamba layer and K2 prefill once in
    #    forward; generate runs the plain Mamba step (as the reference does)
    #    and K2 decode once per step in its attention layer
    full = get_config("jamba_1_5_large_398b")
    jcfg = dataclasses.replace(full, layer_pattern=full.layer_pattern[:7],
                               n_periods=1)
    kinds = ", ".join(f"{i}:{s.kind}{'+moe' if s.moe else ''}"
                      for i, s in enumerate(jcfg.layer_pattern))
    n_mamba = sum(s.kind == "mamba" for s in jcfg.layer_pattern)
    n_attn = sum(s.kind == "attn" for s in jcfg.layer_pattern)
    one_period = dataclasses.replace(full, n_periods=1)
    log(f"phase 4c main path: {jcfg.name} d_model={jcfg.d_model} "
        f"d_inner={jcfg.d_inner} d_state={jcfg.d_state} dt_rank={jcfg.dtr} "
        f"d_conv={jcfg.d_conv} heads=({jcfg.n_heads},{jcfg.n_kv_heads})x"
        f"{jcfg.hd} experts={jcfg.n_experts} top-{jcfg.top_k} "
        f"d_ff={jcfg.d_ff} vocab={jcfg.vocab_size} dtype={jcfg.dtype}")
    log(f"  cut: layers [{kinds}] of the first period, {jcfg.n_layers} of "
        f"{full.n_layers}: one whole period is "
        f"{one_period.n_params() / 1e9:.2f}B parameters, "
        f"{one_period.n_params() * 2 / 2**30:.2f} GiB in bf16, more than "
        "the card holds; the first 7 layers keep every layer kind (Mamba, "
        "Mamba + MoE, attention) at full width")
    jamba_fwd_launches, _ = _serve(
        jcfg, 5, dev, gen, reset, launches,
        want_fwd=(n_attn, 0, 0, n_mamba, 0),
        want_gen=lambda steps: (0, n_attn * steps, 0, 0, 0))

    # d. Whisper-base: K2 prefill in every attention of forward_encdec (6
    #    encoder, 6 decoder, 6 cross); per serve step K2 decode in each
    #    decoder self-attention and K2 prefill in each cross-attention
    wcfg = get_config("whisper_base")
    log(f"phase 4d main path: {wcfg.name} encoder {wcfg.n_enc_layers} + "
        f"decoder {wcfg.n_layers} layers (no cut) d_model={wcfg.d_model} "
        f"heads=({wcfg.n_heads},{wcfg.n_kv_heads})x{wcfg.hd} "
        f"d_ff={wcfg.d_ff} vocab={wcfg.vocab_size} frames="
        f"{wcfg.enc_seq_len} dtype={wcfg.dtype}")
    _whisper(wcfg, 10, dev, gen, reset, launches)

    # e. Phi-3-vision 4.2B: K2 prefill once per layer over prefix + tokens,
    #    K2 decode once per layer and step in generate (no prefix, as in the
    #    reference)
    pcfg = get_config("phi_3_vision_4_2b")
    PL = pcfg.n_layers
    log(f"phase 4e main path: {pcfg.name} d_model={pcfg.d_model} "
        f"heads=({pcfg.n_heads},{pcfg.n_kv_heads})x{pcfg.hd} "
        f"d_ff={pcfg.d_ff} vocab={pcfg.vocab_size} prefix={pcfg.prefix_len} "
        f"depth {PL} of {PL} (no cut) dtype={pcfg.dtype}")
    phi_fwd_launches, _ = _serve(
        pcfg, 11, dev, gen, reset, launches, want_fwd=(PL, 0, 0, 0, 0),
        want_gen=lambda steps: (0, PL * steps, 0, 0, 0),
        prefix=pcfg.prefix_len)

    # f. K1's path, ops.gemm: the micro-bench's product
    #    (benchmarks/run.py:435-449) and Mistral-NeMo's up-projection at
    #    T = 2048; no model path launches K1 (the projections are plain
    #    products, as the reference's are XLA dots)
    log("phase 4f K1 path: ops.gemm (each model path above launched K1 "
        "0 times, as its checked counts show)")
    gemm_path = ((512, 512, 512, torch.float32),
                 (2048, cfg.d_model, cfg.d_ff, torch.bfloat16))
    operands = [(rand(M, K, dtype=dt), rand(K, N, dtype=dt))
                for M, K, N, dt in gemm_path]
    reset()
    outs = [ops.gemm(x, w) for x, w in operands]
    torch.cuda.synchronize()
    gemm_launches = launches()
    if gemm_launches != (0, 0, 0, 0, len(gemm_path)):
        fail(f"ops.gemm launches {gemm_launches}, want "
             f"{(0, 0, 0, 0, len(gemm_path))}")
    if gemm_cuda.wgmma_launches != 1:
        fail(f"{gemm_cuda.wgmma_launches} of ops.gemm's launches took the "
             "wgmma kernel, want 1 (the bf16 product)")
    log("  K1 on the wgmma kernel: 1 of 1 bf16 launch (the fp32 product "
        "on the CUDA cores)")
    for (x, w), out in zip(operands, outs):
        check_gemm(f"ops.gemm ({x.shape[0]}x{x.shape[1]})@({w.shape[0]}x"
                   f"{w.shape[1]}) {str(x.dtype)[6:]}", out, x, w)
    del operands, outs

    # ---- 5. fp32 consistency at mistral and rwkv width, depth 2 ------------
    log("phase 5 fp32 consistency (tol 1e-3: cuBLAS sums in another order "
        "for the 128-row forward than for the 2-row decode step, and the "
        "kernels than the plain versions)")
    _consistency(dataclasses.replace(cfg, n_periods=2, dtype="float32"), 1,
                 dev, gen, reset, launches, want_fwd=(2, 0, 0, 0, 0))
    log("  (the RWKV decode step keeps w in fp32, as the forward does in "
        "fp32)")
    _consistency(dataclasses.replace(rcfg, n_periods=2, dtype="float32"), 4,
                 dev, gen, reset, launches, want_fwd=(0, 0, 2, 0, 0))
    pat = full.layer_pattern
    log("  (Jamba: layers 0, 1 and 4 — Mamba, Mamba + MoE, attention — at "
        "capacity factor 8.0, so neither the forward nor a decode step "
        "drops a token; the Mamba decode step keeps dt in fp32, as the "
        "forward does in fp32)")
    _consistency(dataclasses.replace(full, layer_pattern=(pat[0], pat[1],
                                                          pat[4]),
                                     n_periods=1, dtype="float32",
                                     capacity_factor=8.0), 6,
                 dev, gen, reset, launches, want_fwd=(1, 0, 0, 2, 0))
    log("  (Whisper-base at full width and depth: forward_encdec over 2 x "
        "1500 frames, kernels vs plain, and 64 teacher-forced serve steps "
        "vs forward_encdec)")
    _whisper_consistency(dataclasses.replace(wcfg, dtype="float32"), 12, dev,
                         gen, reset, launches)
    log("  (Phi-3-vision at depth 2 with its 576-patch prefix: forward "
        "kernels vs plain)")
    p2 = dataclasses.replace(pcfg, n_periods=2, dtype="float32")
    params = TF.init_params(p2, torch.Generator(dev).manual_seed(13), dev)
    with torch.inference_mode():
        toks = torch.randint(0, p2.vocab_size, (2, 64), generator=gen,
                             device=dev, dtype=torch.int32)
        prefix = rand(2, p2.prefix_len, p2.d_model, dtype=torch.float32)
        reset()
        lk, _ = TF.forward(params, toks, p2, prefix_embeds=prefix)
        if launches() != (2, 0, 0, 0, 0):
            fail(f"{p2.name} fp32 forward launches {launches()}, want "
                 "(2, 0, 0, 0, 0)")
        lr, _ = TF.forward(params, toks, p2, prefix_embeds=prefix,
                           backend="ref")
        check_close(f"{p2.name} depth 2 prefix {p2.prefix_len} + 64 forward "
                    "kernel vs plain", lk, lr, 1e-3)
    del params, lk, lr
    torch.cuda.empty_cache()

    # ---- 6. gemma2_9b smoke width through generate --------------------------
    cfg3 = dataclasses.replace(get_config("gemma2_9b", reduced=True),
                               dtype="float32")
    log(f"phase 6 {cfg3.name}: window {cfg3.layer_pattern[0].window}, "
        f"softcap {cfg3.attn_softcap}/{cfg3.final_softcap}, post-norm, tied")
    params3 = TF.init_params(cfg3, torch.Generator(dev).manual_seed(2), dev)
    with torch.inference_mode():
        prompts3 = torch.randint(0, cfg3.vocab_size, (2, 24), generator=gen,
                                 device=dev, dtype=torch.int32)
        got = generate(params3, cfg3, prompts3, max_new=16)
        want = generate(params3, cfg3, prompts3, max_new=16, backend="ref")
        if not torch.equal(got, want):
            fail("gemma2 smoke: kernel and plain generate disagree")
        log(f"  generate kernel == plain: {got.shape[1] - 24} new tokens, "
            f"sample {got[0, -8:].tolist()}")
        seq = got[:, :-1]
        check_close("gemma2 forward kernel vs plain",
                    TF.forward(params3, seq, cfg3)[0],
                    TF.forward(params3, seq, cfg3, backend="ref")[0], F32_TOL)
    del params3
    # Jamba smoke in fp32 at its own capacity factor: at batch 4 a decode
    # step has capacity 3 per expert for 8 choices, so MoE drops happen on
    # the card and must pick the same tokens as the plain path
    cfg4 = dataclasses.replace(get_config("jamba_1_5_large_398b",
                                          reduced=True), dtype="float32")
    log(f"phase 6 {cfg4.name}: fp32, capacity factor "
        f"{cfg4.capacity_factor}, d_state {cfg4.d_state}")
    params4 = TF.init_params(cfg4, torch.Generator(dev).manual_seed(7), dev)
    with torch.inference_mode():
        prompts4 = torch.randint(0, cfg4.vocab_size, (4, 24), generator=gen,
                                 device=dev, dtype=torch.int32)
        got = generate(params4, cfg4, prompts4, max_new=16)
        want = generate(params4, cfg4, prompts4, max_new=16, backend="ref")
        if not torch.equal(got, want):
            fail("jamba smoke: kernel and plain generate disagree")
        log(f"  generate kernel == plain: {got.shape[1] - 24} new tokens, "
            f"sample {got[0, -8:].tolist()}")
        seq = got[:, :-1]
        want4 = tuple(cfg4.n_periods * sum(s.kind == kind
                                           for s in cfg4.layer_pattern)
                      for kind in ("attn", "", "", "mamba", ""))
        reset()
        lk, aux_k = TF.forward(params4, seq, cfg4)
        if launches() != want4:
            fail(f"jamba smoke forward launches {launches()}, want {want4}")
        lr, aux_r = TF.forward(params4, seq, cfg4, backend="ref")
        check_close("jamba smoke forward kernel vs plain", lk, lr, F32_TOL)
        check_close("jamba smoke aux kernel vs plain", aux_k, aux_r, F32_TOL)
    del params4

    # ---- 7. timings at the main paths' shapes -----------------------------
    log("phase 7 timings (CUDA events; bf16 unless marked)")
    log(f"  card at the start: {_clocks()}")
    bf = torch.bfloat16
    kernels = []
    # K1 at Mistral-NeMo's up-projection at T = 2048 in bf16 (the row, with
    # every built tile's time), the micro-bench's 512^3 in fp32 and the
    # decode-shaped (1 and 7) x 5120 . (5120 x 5120) in bf16 (logged);
    # 2MNK flops, each operand read and the product written once; the
    # library call is torch.matmul (cuBLAS, TF32 off).  The small products
    # (split across blocks) are also timed as CUDA graphs: their eager
    # calls are paced by the host
    for tag, (M, K, N, dt) in (
            ("Mistral-NeMo's up-projection", gemm_path[1]),
            ("the micro-bench's shape", gemm_path[0]),
            ("decode shape M=1", (1, cfg.d_model, cfg.d_model, bf)),
            ("decode shape M=7", (7, cfg.d_model, cfg.d_model, bf))):
        x, w = rand(M, K, dtype=dt), rand(K, N, dtype=dt)
        eb = x.element_size()
        t = autotile.gemm_tiles(M, N, K, eb)
        splits = autotile.gemm_splits(M, N, K, t, eb)
        kern = lambda: gemm_cuda(x, w, bm=t.bm, bn=t.bn, bk=t.bk,
                                 splits=splits)
        plain = lambda: R.gemm_ref(x, w)
        lib = lambda: torch.matmul(x, w)
        err = check_gemm(f"gemm at {tag}", kern(), x, w)
        flops = 2 * M * N * K
        nbytes = eb * (M * K + K * N + M * N)
        b_ms, b_by = bound(flops, nbytes, eb)
        small = M * N < 2 ** 20
        row = _row("gemm", gemm_launches[4], err, kern, plain, lib, b_ms,
                   b_by, f"{tag}: ({M}x{K})@({K}x{N}) {str(dt)[6:]} tiles=("
                   f"{t.bm},{t.bn},{t.bk}) splits={splits}"
                   + ("; ms and library ms as CUDA graphs" if small else ""),
                   graph=small, **GEMM)
        log(f"    {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{nbytes / row['ms'] / 1e6:.0f} GB/s, "
            f"{b_ms / row['ms'] * 100:.1f}% of the bound")
        if small:
            log(f"    eager (host-paced) calls: kernel {time_ms(kern):.4f} "
                f"ms, torch.matmul {time_ms(lib):.4f} ms")
        for tb, tn, tk in autotile.GEMM_TILES[eb]:
            sp = autotile.gemm_splits(M, N, K, (tb, tn, tk), eb)
            ms = time_ms(lambda: gemm_cuda(x, w, bm=tb, bn=tn, bk=tk,
                                           splits=sp), graph=small)
            picked = " (picked)" if (tb, tn, tk) == (t.bm, t.bn, t.bk) else ""
            log(f"    tiles ({tb},{tn},{tk}) splits={sp}{picked}: {ms:.4f} "
                f"ms, {flops / ms / 1e9:.1f} TFLOP/s")
        if tag == "Mistral-NeMo's up-projection":
            kernels.append(row)
        del x, w
    # K2 prefill in bf16 (the tensor-core kernel) at the main paths' shapes:
    # Mistral-NeMo's forward (the row), Phi-3-vision's, Whisper's encoder
    # and Whisper's cross-attention step (Tq = 1 over the 1500 frames), each
    # beside its bound, the plain version and SDPA, with every built tile's
    # time so that the intensity objective's pick can be judged.  4·D flops
    # per unmasked (q, k) pair; q, k, v read and o written once
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for tag, Bp, Hp, Hkvp, Tqp, Tkp, Dp, causal in (
            ("Mistral-NeMo", 1, Hq, Hkv, 2048, 2048, D, True),
            ("Phi-3-vision", 1, pcfg.n_heads, pcfg.n_kv_heads, 2048, 2048,
             pcfg.hd, True),
            ("Whisper encoder", 4, wcfg.n_heads, wcfg.n_kv_heads,
             wcfg.enc_seq_len, wcfg.enc_seq_len, wcfg.hd, False),
            ("Whisper cross-attention step", 4, wcfg.n_heads,
             wcfg.n_kv_heads, 1, wcfg.enc_seq_len, wcfg.hd, False)):
        q = rand(Bp, Hp, Tqp, Dp, dtype=bf)
        k, v = (rand(Bp, Hkvp, Tkp, Dp, dtype=bf) for _ in range(2))
        bq, bk = autotile.attention_tiles(Tqp, Tkp, Dp, q.element_size())
        kern = lambda: flash_attention_cuda(q, k, v, bq=bq, bk=bk,
                                            causal=causal)
        plain = lambda: R.attention_ref(q, k, v, causal=causal)
        got = kern()
        err = check_close(f"prefill at the {tag} shape", got, plain(),
                          BF16_TOL)
        check_rel(f"prefill at the {tag} shape", got, q, k, v,
                  dict(causal=causal))
        del got
        pairs = Tqp * (Tqp + 1) / 2 if causal else Tqp * Tkp
        flops = 4 * Bp * Hp * Dp * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound(flops, nbytes, 2)
        row = _row("flash_attention_prefill",
                   fwd_launches[0] if tag == "Mistral-NeMo" else None, err,
                   kern, plain, _sdpa(q, k, v, causal=causal), b_ms, b_by,
                   f"{tag}: B={Bp} Hq={Hp} Hkv={Hkvp} Tq={Tqp} Tk={Tkp} "
                   f"D={Dp} causal={causal} tiles=({bq},{bk})", **FLASH)
        log(f"    {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{b_ms / row['ms'] * 100:.1f}% of the bound")
        for tb, tk in autotile.attention_built_tiles(Dp, q.element_size()):
            ms = time_ms(lambda: flash_attention_cuda(q, k, v, bq=tb, bk=tk,
                                                      causal=causal))
            picked = " (picked)" if (tb, tk) == (bq, bk) else ""
            log(f"    tiles ({tb},{tk}){picked}: {ms:.4f} ms, "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
        if tag == "Mistral-NeMo":
            kernels.append(row)
        del q, k, v
    # K2 decode (split across blocks) in bf16 at the main paths' decode
    # shapes, batch 4: Mistral-NeMo over 4096 positions (the row),
    # Phi-3-vision, Jamba's attention layer, Gemma-2's 4096 window over 8192
    # positions (half the splits empty; timed without its softcap, which
    # SDPA does not take) and phase 4's 40-position cache.  The eager call
    # is bound by the host's launch cost, so the kernel and SDPA (over the
    # keys the mask keeps) are also timed as CUDA graphs of 20 calls: the
    # device's time, which the row reports.  Bound: q, the kept K and V
    # rows read and o written once; 4·D flops per (q head, key), fp32
    g2 = get_config("gemma2_9b")
    for tag, Hqd, Hkvd, Dd, S, pos_i, window in (
            ("Mistral-NeMo", Hq, Hkv, D, 4096, 4095, None),
            ("Phi-3-vision", pcfg.n_heads, pcfg.n_kv_heads, pcfg.hd, 4096,
             4095, None),
            ("Jamba attention", jcfg.n_heads, jcfg.n_kv_heads, jcfg.hd, 4096,
             4095, None),
            ("Gemma-2 window", g2.n_heads, g2.n_kv_heads, g2.hd, 8192, 8191,
             g2.layer_pattern[0].window),
            ("phase 4 generate", Hq, Hkv, D, 40, 39, None)):
        Bd = 4
        q = rand(Bd, Hqd, 1, Dd, dtype=bf)
        k, v = rand(Bd, Hkvd, S, Dd, dtype=bf), rand(Bd, Hkvd, S, Dd,
                                                     dtype=bf)
        pos = torch.tensor(pos_i, dtype=torch.int32, device=dev)
        lo = 0 if window is None else max(0, pos_i - window + 1)
        kern = lambda: decode_attention_cuda(q, k, v, pos, window=window)
        plain = lambda: R.decode_attention_ref(q, k, v, pos=pos,
                                               window=window)
        kept_k, kept_v = k[:, :, lo:pos_i + 1], v[:, :, lo:pos_i + 1]
        lib = _sdpa(q, kept_k, kept_v, causal=False)
        got = kern()
        err = check_close(f"decode at the {tag} shape", got, plain(),
                          BF16_TOL)
        check_rel(f"decode at the {tag} shape", got, q, k, v,
                  dict(causal=True, offset=pos_i, window=window))
        rows = pos_i + 1 - lo
        flops = 4 * Bd * Hqd * Dd * rows
        nbytes = 2 * (2 * q.numel() + 2 * Bd * Hkvd * rows * Dd)
        b_ms, b_by = bound(flops, nbytes, 4)
        chunk, splits = autotile.decode_splits(Bd, Hkvd, Hqd // Hkvd, S, Dd,
                                               2)
        row = _row("flash_attention_decode",
                   gen_launches[1] if tag == "Mistral-NeMo" else None, err,
                   kern, plain, lib, b_ms, b_by,
                   f"{tag}: B={Bd} Hq={Hqd} Hkv={Hkvd} cache={S} D={Dd} "
                   f"pos={pos_i} window={window} chunk={chunk} "
                   f"splits={splits}; ms and library ms as CUDA graphs",
                   graph=True, **FLASH)
        log(f"    eager (host-paced) calls: kernel {time_ms(kern):.4f} ms, "
            f"SDPA {time_ms(lib):.4f} ms; {nbytes / row['ms'] / 1e6:.0f} "
            f"GB/s, {b_ms / row['ms'] * 100:.1f}% of the bound")
        if tag == "Mistral-NeMo":
            kernels.append(row)
        del q, k, v, kept_k, kept_v
    # K4 at rwkv6_7b's forward shape: B=1, H=64, T=2048, Dk=Dv=64, bf16
    Bw, Hw, Tw = 1, rcfg.d_model // rcfg.rwkv_head_dim, 2048
    Dw = rcfg.rwkv_head_dim
    args = rwkv_inputs(Bw, Hw, Tw, Dw, bf)
    kern = lambda: rwkv6_cuda(*args)
    plain = lambda: R.rwkv6_ref(*args)
    (o, s_last), (o_ref, s_ref) = kern(), plain()
    err = check_close("rwkv6 at the main path's shape o", o, o_ref, BF16_TOL)
    check_close("rwkv6 at the main path's shape S_last", s_last, s_ref,
                SCAN_TOL)
    # the r.S product and the S update, 2 flops per state element each, in
    # fp32 (the state is fp32); r, k, v, w, u read and o written in bf16,
    # S_last written in fp32
    flops = 4 * Bw * Hw * Tw * Dw * Dw
    nbytes = 2 * (5 * Bw * Hw * Tw * Dw + Hw * Dw) + 4 * Bw * Hw * Dw * Dw
    b_ms, b_by = bound(flops, nbytes, 4)
    kernels.append(_row("rwkv6_wkv", rwkv_fwd_launches[2], err, kern, plain,
                        None, b_ms, b_by,
                        f"B={Bw} H={Hw} T={Tw} Dk=Dv={Dw} bf16", **RWKV,
                        no_library="no single PyTorch call computes the wkv "
                        "recurrence"))
    # K3 at jamba's forward shape: Bt=1, L=2048, Dm=d_inner, N=d_state, bf16
    Bs, Ls, Ds, Ns = 1, 2048, jcfg.d_inner, jcfg.d_state
    args = ssm_inputs(Bs, Ls, Ds, Ns, bf)
    kern = lambda: ssm_scan_cuda(*args)
    plain = lambda: R.selective_scan_ref(*args)
    (y, h_last), (y_ref, h_ref) = kern(), plain()
    err = check_close("ssm_scan at the main path's shape y", y, y_ref,
                      BF16_ULP)
    check_close("ssm_scan at the main path's shape h_last", h_last, h_ref,
                SCAN_TOL)
    # per (l, d, n): dt*A, dA*h, (dt*x)*B, the add, h*C and its sum, in
    # fp32 (the exps run on the special-function units, not counted); x,
    # dt, B, C read and y written in bf16, A, D read and h_last written in
    # fp32
    flops = 6 * Bs * Ls * Ds * Ns
    nbytes = (2 * (3 * Bs * Ls * Ds + 2 * Bs * Ls * Ns)
              + 4 * (Ds * Ns + Ds + Bs * Ds * Ns))
    b_ms, b_by = bound(flops, nbytes, 4)
    kernels.append(_row("ssm_scan", jamba_fwd_launches[3], err, kern, plain,
                        None, b_ms, b_by,
                        f"Bt={Bs} L={Ls} Dm={Ds} N={Ns} bf16", **SSM,
                        no_library="no PyTorch call computes the selective "
                        "scan"))
    # one Jamba decode step's MoE FFN and Mamba step at full width (batch 4:
    # MoE capacity 1, so every expert's weights are read for one row),
    # each against reading its weights once
    with torch.inference_mode():
        xm = rand(4, 1, jcfg.d_model, dtype=bf)
        moe_p = blocks.moe_init(jcfg, torch.Generator(dev).manual_seed(8),
                                dev)
        _step_vs_weights(f"MoE FFN decode step [B=4 C="
                         f"{blocks.moe_capacity(jcfg, 4)}]", moe_p,
                         lambda: blocks.moe_fwd(jcfg, moe_p, xm))
        del moe_p
        mamba_p = blocks.mamba_init(jcfg, torch.Generator(dev).manual_seed(9),
                                    dev)
        state = blocks.mamba_init_state(jcfg, 4, dev)
        _step_vs_weights("Mamba decode step [B=4]", mamba_p,
                         lambda: blocks.mamba_step(jcfg, mamba_p, xm, state))
        del mamba_p, state

    log(f"  card at the end: {_clocks()}")
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _serve(cfg, seed, dev, gen, reset, launches, *, want_fwd, want_gen,
           prefix=0, then=None):
    """One main path: ``cfg`` at full width with random weights from
    ``seed``, ``forward`` on 2048 positions (``prefix`` random patch
    embeddings, then tokens) and ``generate`` (batch 4, prompt 16, 24 new),
    each between ``reset()`` and ``launches()``, which must read
    ``want_fwd`` and ``want_gen(decode steps)``; then ``then(params)`` if
    given.  Returns the two launch counts; frees the weights."""
    import torch

    from repro_torch.kernels.flash_attention import decode_attention_cuda
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import generate

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = TF.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  init: {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}B "
        f"parameters, {weight_bytes / 2**30:.2f} GiB, "
        f"{time.perf_counter() - t0:.1f}s")
    with torch.inference_mode():
        T = 2048
        prompt = torch.randint(0, cfg.vocab_size, (1, T - prefix),
                               generator=gen, device=dev, dtype=torch.int32)
        pre = (torch.randn((1, prefix, cfg.d_model), generator=gen,
                           device=dev).to(cfg.torch_dtype) if prefix
               else None)
        TF.forward(params, prompt[:, :128], cfg,   # warm-up (cuBLAS etc.)
                   prefix_embeds=pre)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        logits, _ = TF.forward(params, prompt, cfg, prefix_embeds=pre)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd_launches = launches()
        if fwd_launches != want_fwd:
            fail(f"{cfg.name} forward launches (flash prefill, flash decode, "
                 f"rwkv6, ssm_scan, gemm) = {fwd_launches}, want {want_fwd}")
        if logits.shape != (1, T, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"{cfg.name} forward logits: wrong shape or non-finite")
        del logits
        mm_flops = _weight_flops(cfg, T)
        log(f"  forward B=1 T={T} (prefix {prefix}): {fwd_ms:.1f} ms "
            f"({T / fwd_ms * 1e3:.0f} "
            f"prompt tok/s), logits finite, launches {fwd_launches} "
            f"({on_tensor_cores(fwd_launches[0])}); weight "
            f"products {mm_flops / 1e12:.2f} TFLOP, bound "
            f"{bound(mm_flops, 0, 2)[0]:.2f} ms at the bf16 peak")

        B, Tp, new = 4, 16, 24
        prompts = torch.randint(0, cfg.vocab_size, (B, Tp), generator=gen,
                                device=dev, dtype=torch.int32)
        generate(params, cfg, prompts, max_new=2)   # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, max_new=new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        steps = Tp + new - 1
        gen_launches = launches()
        if gen_launches != want_gen(steps):
            fail(f"{cfg.name} generate launches (flash prefill, flash "
                 f"decode, rwkv6, ssm_scan, gemm) = {gen_launches}, want "
                 f"{want_gen(steps)}")
        if out.shape != (B, Tp + new) or not torch.equal(out[:, :Tp], prompts) \
                or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{cfg.name} generate: wrong shape, prompt not kept or "
                 "token out of range")
        log(f"  generate B={B} prompt={Tp} new={new}: {gen_s * 1e3:.1f} ms, "
            f"{gen_s * 1e3 / steps:.2f} ms per decode step ({steps} steps; "
            f"weight-read bound {bound(0, weight_bytes, 2)[0]:.2f} ms), "
            f"{B * new / gen_s:.1f} tok/s, launches {gen_launches}, K2 "
            f"decode calls over more than one split "
            f"{decode_attention_cuda.split_launches}")
        log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            "GiB")
        if then is not None:
            then(params)
    del params
    torch.cuda.empty_cache()
    return fwd_launches, gen_launches


def long_cache_step(cfg, params, dev, gen, *, S: int = 4096, B: int = 4,
                    steps: int = 6) -> dict:
    """Decode steps of ``cfg`` (batch ``B``) over an ``S``-position cache
    filled with random keys and values, at pos = S - steps - 1 .. S - 1:
    each step's host-clock ms (synchronised), then one more step under
    ``torch.profiler``: its device-busy ms (the sum of the kernels'
    durations), the part of it in K2 decode (split and combine kernels),
    the step's ms on the host clock inside the trace, and the K2 decode
    calls (and, where the package counts them, split ones) of the timed
    steps.  Also used by tools/k2_ab.py on an older tree."""
    import torch

    from repro_torch.kernels.flash_attention import decode_attention_cuda
    from repro_torch.models import transformer as TF

    with torch.inference_mode():
        state = TF.init_decode_state(cfg, B, S, device=dev)
        for leaf in _leaves(state):
            leaf.normal_(generator=gen)
        kv_bytes = sum(t.numel() * t.element_size() for t in _leaves(state))
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                            device=dev, dtype=torch.int32)
        pos = torch.tensor(S - steps - 2, dtype=torch.int32, device=dev)
        TF.decode_step(params, state, tok, pos, cfg)   # warm-up
        pos += 1
        torch.cuda.synchronize()
        before = (decode_attention_cuda.launches,
                  getattr(decode_attention_cuda, "split_launches", None))
        host_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            logits, state = TF.decode_step(params, state, tok, pos, cfg)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            pos += 1
        calls = decode_attention_cuda.launches - before[0]
        split = (None if before[1] is None
                 else decode_attention_cuda.split_launches - before[1])
        finite = bool(torch.isfinite(logits).all())
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
            t0 = time.perf_counter()
            TF.decode_step(params, state, tok, pos, cfg)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in dev_events) / 1e3
    k2 = sum(e.device_time for e in dev_events
             if "flash_decode" in e.name) / 1e3
    del state
    torch.cuda.empty_cache()
    return {"S": S, "B": B, "kv_bytes": kv_bytes, "host_ms": host_ms,
            "traced_ms": traced_ms, "device_events": len(dev_events),
            "busy_ms": busy, "k2_decode_ms": k2, "decode_calls": calls,
            "split_calls": split, "logits_finite": finite}


def _long_cache(cfg, params, dev, gen, reset, launches) -> None:
    """Phase 4a's long-cache step: Mistral-NeMo at full width and depth,
    batch 4, over a 4096-position cache; fails unless every K2 decode call
    of the timed steps split the cache and the logits are finite."""
    from repro_torch.kernels.flash_attention import decode_attention_cuda

    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    reset()
    r = long_cache_step(cfg, params, dev, gen)
    steps = len(r["host_ms"])
    # the timed steps, a warm-up step and the profiled one
    want = (0, cfg.n_layers * (steps + 2), 0, 0, 0)
    if launches() != want or r["decode_calls"] != cfg.n_layers * steps:
        fail(f"long-cache decode launches {launches()}, want {want}")
    if r["split_calls"] != cfg.n_layers * steps or \
            decode_attention_cuda.split_launches != want[1]:
        fail(f"{decode_attention_cuda.split_launches} of {want[1]} "
             "long-cache K2 decode calls split the cache")
    if not r["logits_finite"]:
        fail("long-cache decode step: non-finite logits")
    host = sorted(r["host_ms"])
    log(f"  decode step B={r['B']} over a {r['S']}-position cache "
        f"({r['kv_bytes'] / 2**30:.2f} GiB of KV beside "
        f"{weight_bytes / 2**30:.2f} GiB of weights; bound "
        f"{bound(0, weight_bytes + r['kv_bytes'], 2)[0]:.2f} ms): host "
        f"clock {', '.join(f'{t:.2f}' for t in r['host_ms'])} ms (median "
        f"{host[len(host) // 2]:.2f}), launches {launches()} (with a "
        f"warm-up and the profiled step), every K2 decode call split "
        f"({decode_attention_cuda.split_launches})")
    if r["device_events"] == 0:
        log("  profiler: the trace holds no device event, so device-busy "
            "time is not measured")
        return
    log(f"  profiled step: {r['traced_ms']:.2f} ms on the host clock, "
        f"device busy {r['busy_ms']:.3f} ms over {r['device_events']} "
        f"device events (idle {1 - r['busy_ms'] / r['traced_ms']:.1%}), "
        f"K2 decode {r['k2_decode_ms']:.3f} ms "
        f"({r['k2_decode_ms'] / r['busy_ms']:.1%} of busy)")


def _encdec_generate(step, params, state, prompts, enc_out, new: int):
    """Greedy decoding of an encoder-decoder model through its serve step:
    the prompt teacher-forced, then ``new`` tokens; ``pos`` lives on the
    device.  Returns (B, Tp + new) int32 tokens."""
    import torch

    pos = torch.zeros((), dtype=torch.int32, device=prompts.device)
    logits = None
    for t in range(prompts.shape[1]):
        logits, state = step(params, state, prompts[:, t], pos, enc_out)
        pos += 1
    out = [prompts]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(new):
        out.append(tok[:, None])
        if i == new - 1:
            break
        logits, state = step(params, state, tok, pos, enc_out)
        pos += 1
        tok = logits.argmax(-1).to(torch.int32)
    return torch.cat(out, dim=1)


def _whisper(cfg, seed, dev, gen, reset, launches) -> None:
    """Whisper at full width: ``forward_encdec`` (batch 4, all frames, 128
    tokens), ``encode``, and greedy decoding through ``build_serve_step``
    (batch 4, prompt 16, 24 new), each between ``reset()`` and
    ``launches()``."""
    import torch

    from repro_torch.models import encdec as ED
    from repro_torch.serve.engine import build_serve_step

    torch.cuda.reset_peak_memory_stats()
    params = ED.init_params_encdec(cfg, torch.Generator(dev).manual_seed(seed),
                                   dev)
    leaves = list(_leaves(params))
    log(f"  init: {sum(t.numel() for t in leaves) / 1e6:.2f}M parameters "
        f"counted from the tree's leaves (ModelConfig.n_params(), which "
        f"leaves out the encoder, says {cfg.n_params() / 1e6:.2f}M), "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 2**20:.1f} "
        "MiB")
    L = cfg.n_layers
    B, Te, Td = 4, cfg.enc_seq_len, 128
    with torch.inference_mode():
        frames = torch.randn((B, Te, cfg.d_model), generator=gen,
                             device=dev).to(cfg.torch_dtype)
        toks = torch.randint(0, cfg.vocab_size, (B, Td), generator=gen,
                             device=dev, dtype=torch.int32)
        ED.forward_encdec(params, toks, frames, cfg)   # warm-up
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        logits = ED.forward_encdec(params, toks, frames, cfg)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        want = (cfg.n_enc_layers + 2 * L, 0, 0, 0, 0)
        if launches() != want:
            fail(f"{cfg.name} forward_encdec launches {launches()}, want "
                 f"{want}")
        if logits.shape != (B, Td, cfg.vocab_size) or \
                not torch.isfinite(logits).all():
            fail(f"{cfg.name} forward_encdec logits: wrong shape or "
                 "non-finite")
        del logits
        log(f"  forward_encdec B={B} frames={Te} tokens={Td}: {fwd_ms:.1f} "
            f"ms, logits finite, launches {want} "
            f"({on_tensor_cores(want[0])})")
        reset()
        t0 = time.perf_counter()
        enc_out = ED.encode(params, frames, cfg)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        if launches() != (cfg.n_enc_layers, 0, 0, 0, 0):
            fail(f"{cfg.name} encode launches {launches()}")
        step = build_serve_step(cfg)
        Tp, new = 16, 24
        prompts = toks[:, :Tp]
        _encdec_generate(step, params, ED.init_decode_state_encdec(
            cfg, B, Tp + 2, device=dev), prompts, enc_out, 2)   # warm-up
        torch.cuda.synchronize()
        state = ED.init_decode_state_encdec(cfg, B, Tp + new, device=dev)
        reset()
        t0 = time.perf_counter()
        out = _encdec_generate(step, params, state, prompts, enc_out, new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        steps = Tp + new - 1
        if launches() != (L * steps, L * steps, 0, 0, 0):
            fail(f"{cfg.name} serve-step launches {launches()}, want "
                 f"{(L * steps, L * steps, 0, 0, 0)}")
        if out.shape != (B, Tp + new) or not torch.equal(out[:, :Tp],
                                                        prompts) \
                or out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{cfg.name} decoding: wrong shape, prompt not kept or "
                 "token out of range")
        log(f"  encode B={B} frames={Te}: {enc_ms:.1f} ms; serve steps "
            f"B={B} prompt={Tp} new={new}: {gen_s * 1e3:.1f} ms, "
            f"{gen_s * 1e3 / steps:.2f} ms per step ({steps} steps), "
            f"{B * new / gen_s:.1f} tok/s, launches {launches()} "
            f"({on_tensor_cores(L * steps)})")
        log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            "GiB")
    del params, enc_out, state
    torch.cuda.empty_cache()


def _whisper_consistency(cfg, seed, dev, gen, reset, launches) -> None:
    """fp32 Whisper: ``forward_encdec`` through the kernels against the
    plain path, and 64 teacher-forced serve steps against it, within
    1e-3."""
    import torch

    from repro_torch.models import encdec as ED
    from repro_torch.serve.engine import build_serve_step

    tol = 1e-3
    params = ED.init_params_encdec(cfg, torch.Generator(dev).manual_seed(seed),
                                   dev)
    with torch.inference_mode():
        frames = torch.randn((2, cfg.enc_seq_len, cfg.d_model), generator=gen,
                             device=dev)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device=dev, dtype=torch.int32)
        reset()
        lk = ED.forward_encdec(params, toks, frames, cfg)
        want = (cfg.n_enc_layers + 2 * cfg.n_layers, 0, 0, 0, 0)
        if launches() != want:
            fail(f"{cfg.name} fp32 forward_encdec launches {launches()}, "
                 f"want {want}")
        lr = ED.forward_encdec(params, toks, frames, cfg, backend="ref")
        check_close(f"{cfg.name} forward_encdec kernel vs plain", lk, lr, tol)
        enc_out = ED.encode(params, frames, cfg)
        step = build_serve_step(cfg)
        state = ED.init_decode_state_encdec(cfg, 2, 64, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        steps = []
        for t in range(64):
            lt, state = step(params, state, toks[:, t], pos, enc_out)
            pos += 1
            steps.append(lt)
        check_close(f"{cfg.name} serve steps vs forward_encdec",
                    torch.stack(steps, 1), lk, tol)
    del params, state, enc_out
    torch.cuda.empty_cache()


def _weight_flops(cfg, n_tok: int) -> float:
    """Flops (2 per multiply-add) of the weight products of one ``forward``
    over ``n_tok`` tokens, as the code computes them: an MoE layer's
    experts run on their E·C capacity rows (``moe_capacity``), not on every
    token times every expert, beside the router and the shared experts per
    token; a Mamba layer's in, x, dt and out projections; the untied
    embedding is a gather, the head one product.  Attention scores and the
    scans are not counted."""
    from repro_torch.models.blocks import moe_capacity

    d, V = cfg.d_model, cfg.vocab_size
    per_tok, rows = 0, 0        # multiply-adds per token, and per MoE layer
    for spec in cfg.layer_pattern:
        if spec.kind == "rwkv":  # rkvwg, out, cr, decay LoRA, channel mix
            per_tok += 6 * d * d + 2 * d * cfg.rwkv_decay_rank \
                + 2 * d * cfg.d_ff
            continue
        if spec.kind == "attn":
            per_tok += d * cfg.hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                + cfg.n_heads * cfg.hd * d
        else:
            di, r, N = cfg.d_inner, cfg.dtr, cfg.d_state
            per_tok += d * 2 * di + di * (r + 2 * N) + r * di + di * d
        if spec.moe:
            f = cfg.d_ff_e
            per_tok += d * cfg.n_experts + cfg.n_shared_experts * 3 * d * f
            rows += cfg.n_experts * moe_capacity(cfg, n_tok) * 3 * d * f
        else:
            per_tok += (3 if cfg.glu else 2) * d * cfg.d_ff
    return 2 * (cfg.n_periods * (n_tok * per_tok + rows) + n_tok * d * V)


def _consistency(cfg, seed, dev, gen, reset, launches, *, want_fwd):
    """fp32 at ``cfg``'s width: ``forward`` through the kernels (launching
    ``want_fwd``) against the plain path, and 64 teacher-forced
    ``decode_step`` calls against ``forward``, within 1e-3."""
    import torch

    from repro_torch.models import transformer as TF

    tol = 1e-3
    params = TF.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    with torch.inference_mode():
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                             device=dev, dtype=torch.int32)
        reset()
        lk, _ = TF.forward(params, toks, cfg)
        if launches() != want_fwd:
            fail(f"{cfg.name} fp32 forward launches {launches()}, want "
                 f"{want_fwd}")
        lr, _ = TF.forward(params, toks, cfg, backend="ref")
        check_close(f"{cfg.name} depth {cfg.n_layers} forward kernel vs "
                    "plain", lk, lr, tol)
        state = TF.init_decode_state(cfg, 2, 64, device=dev)
        steps = []
        for t in range(64):
            lt, state = TF.decode_step(params, state, toks[:, t], t, cfg)
            steps.append(lt)
        check_close(f"{cfg.name} depth {cfg.n_layers} decode_step vs "
                    "forward", torch.stack(steps, 1), lk, tol)
    del params, state
    torch.cuda.empty_cache()


def _step_vs_weights(name, params, fn) -> None:
    """Logs ``fn``'s time (CUDA events) beside the time to read ``params``
    once at the HBM rate."""
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ms = time_ms(fn)
    log(f"  {name}: {ms:.4f} ms, weight-read bound "
        f"{bound(0, nbytes, 2)[0]:.4f} ms ({nbytes / 1e9:.2f} GB)")


def _clocks() -> str:
    """The card's SM clock, power draw and temperature, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _sdpa(q, k, v, causal):
    """One PyTorch call computing the same attention (the yardstick)."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)


def _row(name, launches, err, kern, plain, lib, b_ms, b_by, shape, *,
         source, replaces, no_library=None, graph=False):
    """One entry of the ``kernels`` line (logged too); ``lib`` is None
    (with the reason in ``no_library``) where no PyTorch call computes the
    same function.  With ``graph`` the kernel and the library call are
    timed as CUDA graphs (``time_ms``), the plain version eagerly."""
    ms, plain_ms = time_ms(kern, graph=graph), time_ms(plain, reps=5)
    lib_ms = time_ms(lib, graph=graph) if lib is not None else None
    lib_txt = (f"{lib_ms:.4f} ms" if lib_ms is not None
               else f"none ({no_library})")
    log(f"  {name} [{shape}]: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"plain {plain_ms:.4f} ms, library {lib_txt}, max_abs_err {err:.3e}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


if __name__ == "__main__":
    sys.exit(main())

"""Where K3's time goes: variant builds of a tree's ``csrc/ssm_scan.cu``,
each timed at the main shape beside its SASS instruction mix.

    python src/repro_torch/tools/k3_probe.py --src DIR --label NAME \\
        [--variants base,ftz,...] [--decay long_memory] [--dtype fp32]

DIR is the directory holding the tree's ``repro_torch`` (a parent commit
unpacked with ``git archive``, or ``src``).  Each variant is the tree's
source, with the header ``autotile`` writes for it prepended, and with the
text replacements of ``VARIANTS`` (the tree's files are never changed; a
variant whose anchors the source lacks is skipped).  All variants are
compiled at once with the tree's ``nvcc`` flags into
``.chipscratch/k3_probe/<label>/<variant>/``, and each is loaded in place of
the tree's library and called through the tree's ``ssm_scan_cuda`` at
Bt = 1, L = 2048, Dm = 16384, N = 16 in bf16 or, with ``--dtype fp32``,
fp32 (inputs drawn as ``chip_smoke.py`` draws them, or with ``--decay
long_memory`` |A| from 1e-3 to 5e-2).  Per variant one JSON line: the
states a thread the tree builds at N = 16 (``autotile.SSM_TILES``; none
before the redesign), ms as a CUDA graph (``chip_smoke.time_ms``), the
largest error of y and h_last against the plain version (a variant that
removes work is a timing only) and, over a long memory, against the scan
in float64 (the tree's ``ref.selective_scan_ref`` on float64 inputs, where
it runs in float64; ``f64_y`` and ``f64_h`` are [max |got - want|, max
|got - want| / (1e-4 + 1e-4 |want|)]), ptxas's
registers and spill bytes, and the opcode counts of the kernel that ran
(``cuobjdump -sass``; with ``--sass-dir`` its text too).  The card's name,
power limit and SM clock are printed first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]

_EX2_FTZ = ('__device__ __forceinline__ float lego_ex2_ftz(float v) {\n'
            '  float r;\n'
            '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));\n'
            '  return r;\n}\n')
# 2^v on the FMA pipe: v = k + f with k = rint(v) (by the 1.5 * 2^23 add)
# and f in [-0.5, 0.5], 2^f by a degree-5 polynomial (relative error 1.9e-7
# in fp32, exactly 1 at 0), 2^k added to the exponent bits; v is clamped at
# -126 (2^-126 ~ 1.2e-38 where ex2.ftz gives 0)
_EX2_POLY = (
    "__device__ __forceinline__ float ex2_poly(float v) {\n"
    "  v = fmaxf(v, -126.f);\n"
    "  const float r = v + 12582912.f;\n"
    "  const float f = v - (r - 12582912.f);\n"
    "  float p = 0.0013264722656458616f;\n"
    "  p = fmaf(p, f, 0.009671512991189957f);\n"
    "  p = fmaf(p, f, 0.05550733581185341f);\n"
    "  p = fmaf(p, f, 0.24022242426872253f);\n"
    "  p = fmaf(p, f, 0.6931470036506653f);\n"
    "  p = fmaf(p, f, 1.0f);\n"
    "  return __int_as_float(__float_as_int(p) + (__float_as_int(r) << 23));\n"
    "}\n")
# e^v on the FMA pipe (for the fp32 route): v = k ln 2 + r, k = rint(v
# log2 e), r by Cody and Waite's two-part ln 2; e^r - 1 = r + r^2 P(r), P
# Taylor's terms 1/2! .. 1/8!; e^r = 1 + (e^r - 1) rounded once, scaled by
# 2^k; 0 below 2^-126.  Within 1 ulp and without bias near 1
# (tests/test_torch_kernels.py models it from this text); ~19 instructions
_EXP_FMA = (
    "__device__ __forceinline__ float exp_fma(float v) {\n"
    "  v = fminf(fmaxf(v, -104.f), 88.f);\n"
    "  const float k = rintf(v * 1.44269504f);\n"
    "  float r = fmaf(k, -0.693145751953125f, v);\n"
    "  r = fmaf(k, -1.42860677e-06f, r);\n"
    "  float p = 2.48015873e-05f;\n"
    "  p = fmaf(p, r, 1.98412698e-04f);\n"
    "  p = fmaf(p, r, 1.38888889e-03f);\n"
    "  p = fmaf(p, r, 8.33333333e-03f);\n"
    "  p = fmaf(p, r, 4.16666667e-02f);\n"
    "  p = fmaf(p, r, 1.66666667e-01f);\n"
    "  p = fmaf(p, r, 0.5f);\n"
    "  const float e = 1.f + fmaf(p * r, r, r);\n"
    "  return e * __int_as_float(max(static_cast<int>(k) + 127, 0) << 23);\n"
    "}\n")
_FP32 = "std::is_same<T, float>::value"
_TO_F = "__device__ __forceinline__ float to_f(float v) { return v; }"
_FIRST = "q.e[4 * i] = ex2(dv * a[4 * i]);"
# variant: (anchor, replacement) pairs, each anchor replaced wherever it
# occurs; "timing only" variants drop work and give wrong outputs
VARIANTS = {
    "base": (),
    # the parent: one MUFU.EX2 per exp instead of exp2f's guarded expansion
    "ftz": (("constexpr float LOG2E = 1.4426950408889634f;",
             "constexpr float LOG2E = 1.4426950408889634f;\n" + _EX2_FTZ),
            ("exp2f(", "lego_ex2_ftz(")),
    # the parent: no y shuffle (timing only)
    "no_shuffle": (("acc += __shfl_xor_sync(0xffffffffu, acc, o);",
                    "acc += 0.f * o;"),),
    # the parent: B and C read from one row, so the compiler can hoist
    # the reads out of the step loop (timing only)
    "bc_hoisted": (("&sb[s][", "&sb[0]["), ("&sc[s][", "&sc[0][")),
    # no exp at all, the decay is its argument (timing only): the parent,
    # the redesign
    "no_exp": (("exp2f(", "("),),
    "no_ex2": (("ex2(dv", "(dv"),),
    # the redesign with exp2f's guarded expansion instead of ex2.ftz
    "exp2f": (('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));',
               "r = exp2f(v);"),),
    # the redesign whose producers skip the y write-out, or the conversion
    # of B and C into the ring (timing only)
    "no_write_out": (("        write_out(c - NST, s);\n", ""),
                     ("      write_out(c, c % NST);\n", "")),
    "no_convert": (("      convert(c, s);\n", ""),),
    # the redesign whose producer stages nothing and writes no y (the
    # consumers step stale data; timing only)
    "idle_producer": (("      convert(c, s);\n", ""),
                      ("        write_out(c - NST, s);\n", ""),
                      ("      write_out(c, c % NST);\n", "")),
    # the redesign with the lanes of a channel next to each other in a
    # warp (a warp's B and C reads are no broadcast)
    "lanes_adjacent": (("  const int p = tid / CPB;", "  const int p = tid % LPC;"),
                       ("  const int j = tid % CPB;", "  const int j = tid / LPC;"),
                       ("const float* part = sy + (s * CT + t) * CONS + cv;",
                        "const float* part = sy + (s * CT + t) * CONS + cv * LPC;"),
                       ("f[i] = part[i];", "f[i] = part[i * LPC];"),
                       ("f[i] += part[q * CPB + i];", "f[i] += part[i * LPC + q];")),
    # the redesign with chunks of 16 time steps
    "chunk16": (("#define LEGO_SSM_CHUNK 32", "#define LEGO_SSM_CHUNK 16"),),
    # the redesign with clock64() around the consumers' waits for a staged
    # chunk, summed, and around their whole run; consumer thread 0 of
    # block 0 writes both (cycles) to its first two states of h_last
    # (outputs wrong)
    "clock": (("  constexpr int RING = NST * CT;\n",
               "  constexpr int RING = NST * CT;\n"
               "  long long t0_ = clock64(), t_wait_ = 0;\n"),
              ("      if (t + 2 == CT) bar_sync(full_bar(sn));",
               "      if (t + 2 == CT) { long long ta_ = clock64(); "
               "bar_sync(full_bar(sn)); t_wait_ += clock64() - ta_; }"),
              ("  if (k < L) iter(k, P0, P1, R0, R1, C0, C1);\n",
               "  if (k < L) iter(k, P0, P1, R0, R1, C0, C1);\n"
               "  h[0] = t_wait_; h[1] = clock64() - t0_;\n")),
    # the redesign with one or four producer warps a block
    "producers1": (("#define LEGO_SSM_PRODUCERS 2", "#define LEGO_SSM_PRODUCERS 1"),),
    "producers4": (("#define LEGO_SSM_PRODUCERS 2", "#define LEGO_SSM_PRODUCERS 4"),),
    # the redesign with the exps of one state in 4 (or 8) on the FMA pipe
    # (ex2_poly)
    "poly4": ((_TO_F, _EX2_POLY + _TO_F),
              (_FIRST, "q.e[4 * i] = ex2_poly(dv * a[4 * i]);")),
    # fp32 decays from exp_fma (e^v of the unscaled dt * A), bf16's
    # unchanged
    "exp_fma": ((_TO_F, _EXP_FMA + _TO_F),
                ("A[static_cast<int64_t>(d) * N + p * S + i] * LOG2E",
                 f"A[static_cast<int64_t>(d) * N + p * S + i] * ({_FP32} "
                 "? 1.f : LOG2E)"),
                *((f"q.e[4 * i{k}] = ex2(dv * a[4 * i{k}]);",
                   f"q.e[4 * i{k}] = {_FP32} ? exp_fma(dv * a[4 * i{k}]) "
                   f": ex2(dv * a[4 * i{k}]);")
                  for k in ("", " + 1", " + 2", " + 3"))),
    "poly8": ((_TO_F, _EX2_POLY + _TO_F),
              (_FIRST, "q.e[4 * i] = i % 2 ? ex2(dv * a[4 * i]) : "
                       "ex2_poly(dv * a[4 * i]);")),
}
TIMING_ONLY = {"no_shuffle", "bc_hoisted", "no_exp", "no_ex2", "clock",
               "idle_producer", "no_write_out", "no_convert"}


def variant_source(text: str, variant: str) -> str | None:
    """``text`` with the variant's replacements, or None if an anchor is
    missing (the variant does not apply to this tree)."""
    for anchor, repl in VARIANTS[variant]:
        if anchor not in text:
            return None
        text = text.replace(anchor, repl)
    return text


def _kernel_tag(states: int | None, fp32: bool) -> str:
    """The mangled template arguments of the N = 16 kernel the call runs
    (``states`` a thread, the 16-byte-load one)."""
    return (("fLi16E" if fp32 else "13__nv_bfloat16Li16E")
            + (f"Li{states}ELb1E" if states else "E"))


def sass_mix(cuobjdump: str, lib: Path, states: int | None,
             fp32: bool = False) -> tuple:
    """Opcode counts (without modifiers) of the N = 16 kernel in ``lib``
    that the call runs, and its SASS text."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    want = _kernel_tag(states, fp32)
    counts, name, text = collections.Counter(), None, []
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        if name and want in name:
            text.append(line)
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts.most_common()), "\n".join(text)


def ptxas_info(log: str, states: int | None, fp32: bool = False) -> dict:
    """Registers and spill bytes ptxas reported for the same kernel."""
    want = _kernel_tag(states, fp32)
    name, info = None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and want in name:
            if "spill stores" in line:
                info["spill_store_bytes"] = int(line.split("bytes spill stores")[0].split()[-1])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                info["registers"] = int(m.group(1))
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--label", required=True)
    ap.add_argument("--variants", default="base")
    ap.add_argument("--decay", default="softplus",
                    choices=("softplus", "long_memory"),
                    help="long_memory: |A| log-uniform in [1e-3, 5e-2], "
                    "decays within ~1e-3 of 1 for most steps")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--sass-dir", type=Path,
                    help="also write each run kernel's SASS here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from chip_smoke import time_ms   # puts REPO/src first
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    import repro_torch
    from repro_torch.kernels import _build, autotile
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssm_scan as K3

    if not torch.cuda.is_available():
        raise SystemExit("k3_probe times the card: torch.cuda.is_available() "
                         "is False")
    pkg = Path(repro_torch.__file__).resolve().parent
    if pkg != args.src.resolve() / "repro_torch":
        raise SystemExit(f"imported {pkg}, not the tree under {args.src}")
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi('name,power.limit')}; clocks.sm {smi('clocks.sm')}",
          flush=True)

    text = (_build.CSRC_DIR / "ssm_scan.cu").read_text()
    header = _build.header("ssm_scan")
    text = header + text if header else text
    out_dir = REPO / ".chipscratch" / "k3_probe" / args.label
    procs = {}
    for v in args.variants.split(","):
        src = variant_source(text, v)
        if src is None:
            print(json.dumps({"label": args.label, "variant": v,
                              "skipped": "anchor not in this source"}))
            continue
        d = out_dir / v
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssm_scan.cu").write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC_DIR), "-o", str(d / "lib.so"),
               str(d / "ssm_scan.cu")]
        procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    logs = {}
    for v, p in procs.items():
        logs[v] = p.communicate()[0]
        if p.returncode:
            print(json.dumps({"label": args.label, "variant": v,
                              "build_failed": logs[v][-2000:]}))

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    fp32 = args.dtype == "fp32"
    Bt, L, Dm, N = 1, 2048, 16384, 16
    bf = torch.float32 if fp32 else torch.bfloat16
    rand = lambda *s: torch.randn(s, generator=gen, device=dev)
    x = rand(Bt, L, Dm).to(bf)
    dt = torch.nn.functional.softplus(rand(Bt, L, Dm) - 1.0).to(bf)
    A = -torch.exp(0.5 * rand(Dm, N))
    if args.decay == "long_memory":
        A = -1e-3 * 50.0 ** torch.rand((Dm, N), generator=gen, device=dev)
    B, C = rand(Bt, L, N).to(bf), rand(Bt, L, N).to(bf)
    D = torch.full((Dm,), 0.5, device=dev)
    y_ref, h_ref = R.selective_scan_ref(x, dt, A, B, C, D)
    y64 = h64 = None
    if args.decay == "long_memory":
        y64, h64 = R.selective_scan_ref(*(t.double() for t in
                                          (x, dt, A, B, C, D)))
        if h64.dtype != torch.float64:   # a tree without the float64 scan
            y64 = h64 = None
    S = dict(getattr(autotile, "SSM_TILES", ())).get(N)
    call = lambda: K3.ssm_scan_cuda(x, dt, A, B, C, D)
    for v, p in procs.items():
        if p.returncode:
            continue
        lib = ctypes.CDLL(str(out_dir / v / "lib.so"))
        for sym, (restype, argtypes) in K3._PROTOTYPES.items():
            getattr(lib, sym).restype = restype
            getattr(lib, sym).argtypes = argtypes
        _build._LOADED["ssm_scan"] = lib
        y, h = call()
        mix, sass = sass_mix(cuobjdump, out_dir / v / "lib.so", S, fp32)
        if args.sass_dir:
            args.sass_dir.mkdir(parents=True, exist_ok=True)
            (args.sass_dir / f"{args.label}-{v}.sass").write_text(sass)
        row = {"label": args.label, "variant": v, "states": S,
               "decay": args.decay, "dtype": args.dtype,
               "timing_only": v in TIMING_ONLY,
               "graph_ms": time_ms(call, graph=True),
               "y_max_abs_err": (y.float() - y_ref.float()).abs().max().item(),
               "h_last_max_abs_err": (h - h_ref).abs().max().item(),
               **ptxas_info(logs[v], S, fp32),
               "sass": mix}
        for name, got, want in (("f64_y", y, y64), ("f64_h", h, h64)):
            if want is not None:
                err = (got.double() - want).abs()
                row[name] = [err.max().item(),
                             (err / (1e-4 + 1e-4 * want.abs())).max().item()]
        if v.startswith("clock"):
            row["cycles"] = dict(zip(("full_wait", "consumer"),
                                     h[0, 0, :2].tolist()))
        print(json.dumps(row), flush=True)
    print(f"clocks.sm at the end {smi('clocks.sm')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

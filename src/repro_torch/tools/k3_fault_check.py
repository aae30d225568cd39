"""How the bf16 K3 checks see the selective scan sound and faulty.

Plants faults in a copy of :func:`repro_torch.kernels.ref.selective_scan_ref`
(the plain version the kernel is held to; the package's own file is never
changed):

  * ``sound``      — no change;
  * ``decay_late`` — every step decays h with the previous step's dt
    (exp(dt_{l-1}·A) instead of exp(dt_l·A));
  * ``skip_dropped`` — the skip x·D left out of y;
  * ``lane_lost``  — the last lane's 4 states left out of y (their share of
    h·C never summed);
  * ``h_bf16``     — h rounded to bf16 once per chunk of ``SSM_CHUNK``
    steps.

Each variant runs on the same bf16 inputs, drawn as ``chip_smoke.py``
draws them, over two decay draws: ``softplus`` (A = -exp(0.5·randn)) and
``long_memory`` (|A| log-uniform in [1e-3, 5e-2]: decays within ~1e-3 of
1, h remembering hundreds to thousands of steps, as in a trained Mamba).
Each is held to the K3 gates: y within one bf16 ulp (2^-7 + 2^-7·|want|)
of :func:`~repro_torch.kernels.ref.selective_scan_ref` on the bf16 inputs;
y within one bf16 ulp of it run in fp32 relative to |want| plus the row's
rms (``ref.scan_rel_err``); h_last within 2^-10 of it relative to |want|
plus the rms of its (b, d) row (``ref.state_rel_err``); and, for the
softplus draw only, h_last within 1e-4 (over a long memory the exps' own
rounding compounds past 1e-4, so that draw holds h by its size alone).
On the card (the default; ``--device cpu`` runs the plain variants
alone) the kernel (``ops.ssm_scan``) is held to the same
gates on the same inputs as a ``kernel`` row.  Prints one JSON line per
(variant, draw) with the gates that caught it, and exits 1 unless the sound
variant and the kernel pass every gate and every fault is caught by at
least one gate in each draw:

    PYTHONPATH=src python -m repro_torch.tools.k3_fault_check [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.autotile import SSM_CHUNK

BF16_ULP, SCAN_TOL = 2.0 ** -7, 1e-4
# h_last against the fp32 plain version relative to its (b, d) row
# (ref.state_rel_err): over ~2000 steps of decays within 1e-3 of 1 the
# kernel's ex2.approx (a bias of up to 2 ulps a step) reads ~3.8e-4 in a
# plain-version model of it; h rounded to bf16 once a chunk reads ~3e-2
STATE_ROW_TOL = 2.0 ** -10
DECAYS = ("softplus", "long_memory")

# variant: (anchor, replacement) pairs planted in selective_scan_ref's source
VARIANTS = {
    "sound": (),
    "decay_late": (("torch.exp(dtf[:, l, :, None] * Af)",
                    "torch.exp(dtf[:, max(l - 1, 0), :, None] * Af)"),),
    "skip_dropped": (("(y + xf * D_skip.to(acc))", "(y + 0.0 * xf)"),),
    "lane_lost": (('torch.einsum("bdn,bn->bd", h, Cf[:, l])',
                   'torch.einsum("bdn,bn->bd", h[..., :-4], '
                   'Cf[:, l, :-4])'),),
    "h_bf16": (("        ys.append(",
                f"        if (l + 1) % {SSM_CHUNK} == 0:\n"
                "            h = h.to(torch.bfloat16).float()\n"
                "        ys.append("),),
}


def planted(variant: str):
    """selective_scan_ref with the variant's faults, compiled in the ref
    module's namespace."""
    code = inspect.getsource(R.selective_scan_ref)
    for anchor, text in VARIANTS[variant]:
        if code.count(anchor) != 1:
            raise RuntimeError(f"{variant}: anchor not found once: {anchor!r}")
        code = code.replace(anchor, text)
    space = dict(vars(R))
    exec(compile(code, f"<selective_scan_ref:{variant}>", "exec"), space)
    return space["selective_scan_ref"]


def inputs(Bt: int, L: int, Dm: int, N: int, device, decay: str,
           seed: int = 0):
    """x, dt, A, B, C, D as chip_smoke.py draws them: x, dt, B, C in bf16
    (dt after a softplus), A < 0 (for ``long_memory`` |A| log-uniform in
    [1e-3, 5e-2]) and D in fp32."""
    gen = torch.Generator(device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = rand(Bt, L, Dm).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(rand(Bt, L, Dm) - 1.0).to(
        torch.bfloat16)
    A = -torch.exp(0.5 * rand(Dm, N))
    if decay == "long_memory":
        A = -1e-3 * 50.0 ** torch.rand((Dm, N), generator=gen, device=device)
    B, C = (rand(Bt, L, N).to(torch.bfloat16) for _ in range(2))
    return x, dt, A, B, C, torch.full((Dm,), 0.5, device=device)


def check(variant: str, decay: str, y, h, args, want_y, want_h) -> dict:
    """The readings of (y, h_last) against the gates of the decay draw."""
    excess = ((y.float() - want_y.float()).abs()
              - BF16_ULP * want_y.float().abs()).max().item()
    rel = R.scan_rel_err(y, *args)
    h_rel = R.state_rel_err(h, *args)
    h_excess = ((h - want_h).abs() - SCAN_TOL * want_h.abs()).max().item()
    gates = [("ulp", excess > BF16_ULP), ("rel_err", rel > BF16_ULP),
             ("h_row", h_rel > STATE_ROW_TOL)]
    if decay != "long_memory":
        gates.append(("h_last 1e-4", h_excess > SCAN_TOL))
    return {"variant": variant, "decay": decay,
            "y_excess_over_ulp_gate": excess, "rel_err_ulps": rel / BF16_ULP,
            "h_row_err": h_rel, "h_last_excess": h_excess,
            "caught_by": [name for name, hit in gates if hit]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--Bt", type=int, default=1)
    ap.add_argument("--L", type=int, default=300)
    ap.add_argument("--Dm", type=int, default=64)
    ap.add_argument("--N", type=int, default=16)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False")
    if args.L < SSM_CHUNK or args.N < 8:
        raise SystemExit(f"--L must be at least one chunk ({SSM_CHUNK}) for "
                         "h_bf16 and --N at least 8 for lane_lost")
    shape = (f"Bt={args.Bt} L={args.L} Dm={args.Dm} N={args.N} bf16 on "
             f"{args.device}")
    ok = True
    for decay in DECAYS:
        x = inputs(args.Bt, args.L, args.Dm, args.N,
                   torch.device(args.device), decay)
        want_y, want_h = R.selective_scan_ref(*x)
        runs = {v: lambda v=v: planted(v)(*x) for v in VARIANTS}
        if args.device == "cuda":
            from repro_torch.kernels import ops
            runs["kernel"] = lambda: ops.ssm_scan(*x)
        for variant, run in runs.items():
            row = check(variant, decay, *run(), x, want_y, want_h)
            row["shape"] = shape
            print(json.dumps(row), flush=True)
            ok &= bool(row["caught_by"]) == (variant not in ("sound",
                                                             "kernel"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""How the bf16 K4 checks see the chunked matrix form sound and faulty.

Plants faults in a copy of :func:`repro_torch.kernels.ref.rwkv6_chunked_ref`
(the plain version of the bf16 tensor-core kernel, same algorithm and
rounding points; the package's own file is never changed):

  * ``sound``         — no change;
  * ``u_dropped``     — the u term r_t . u . k_t left out of the diagonal;
  * ``decay_at_t``    — every decay on the r side taken through step t
    instead of t - 1 (the state decays before it is read);
  * ``state_dropped`` — the carried state lost at the middle chunk boundary;
  * ``state_bf16``    — the carried state rounded to bf16 after every
    chunk's update.

Each variant runs on the same bf16 inputs (drawn as ``chip_smoke.py`` draws
them) and is held to the three K4 gates: o within 3e-2 of
:func:`~repro_torch.kernels.ref.rwkv6_ref` on the bf16 inputs, o within one
bf16 ulp of it run in fp32 relative to |want| plus the row's rms
(``ref.rwkv6_rel_err``), and S_last within 1e-4.  Prints one JSON line per
variant with the gates that caught it, and exits 1 unless the sound variant
passes every gate and every fault is caught by at least one:

    PYTHONPATH=src python -m repro_torch.tools.k4_fault_check [--device cpu]
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys

import torch

from repro_torch.kernels import ref as R

BF16_TOL, SCAN_TOL = 3e-2, 1e-4
RWKV_REL_TOL = 2.0 ** -7       # one bf16 ulp, relative

# variant: (anchor, replacement) pairs planted in rwkv6_chunked_ref's source
VARIANTS = {
    "sound": (),
    "u_dropped": (("(rs[..., I, s, :] * uf * kd).sum(-1)",
                   "(rs[..., I, s, :] * 0.0 * kd).sum(-1)"),),
    "decay_at_t": (
        ("pex = torch.cat([ones, cp[..., :-1, :]], -2)", "pex = cp"),
        ("                if t > s + 1:\n"
         "                    kd = kd * ws[..., I, t - 1, :]\n",
         "                kd = kd * ws[..., I, t, :]\n")),
    "state_dropped": (("    for c in range(n):\n        outs.append(",
                       "    for c in range(n):\n"
                       "        if c == n // 2:\n"
                       "            S = torch.zeros_like(S)\n"
                       "        outs.append("),),
    "state_bf16": (("                vc[:, :, c, J * SUB:(J + 1) * SUB])\n",
                    "                vc[:, :, c, J * SUB:(J + 1) * SUB])\n"
                    "        S = S.to(torch.bfloat16).float()\n"),),
}


def planted(variant: str):
    """rwkv6_chunked_ref with the variant's faults, compiled in the ref
    module's namespace."""
    code = inspect.getsource(R.rwkv6_chunked_ref)
    for anchor, text in VARIANTS[variant]:
        if code.count(anchor) != 1:
            raise RuntimeError(f"{variant}: anchor not found once: {anchor!r}")
        code = code.replace(anchor, text)
    space = dict(vars(R))
    exec(compile(code, f"<rwkv6_chunked_ref:{variant}>", "exec"), space)
    return space["rwkv6_chunked_ref"]


def inputs(B: int, H: int, T: int, D: int, device, seed: int = 0):
    """r, k, v, w, u in bf16 as chip_smoke.py draws them: w in (0, 1)."""
    gen = torch.Generator(device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device)

    r, v = rand(B, H, T, D), rand(B, H, T, D)
    k = 0.3 * rand(B, H, T, D)
    w = torch.sigmoid(rand(B, H, T, D) + 2.0)
    u = 0.1 * rand(H, D)
    return tuple(t.to(torch.bfloat16) for t in (r, k, v, w, u))


def check(variant: str, args, want_o, want_s) -> dict:
    """The variant's readings against the three gates."""
    o, s = planted(variant)(*args)
    excess = ((o.float() - want_o.float()).abs()
              - BF16_TOL * want_o.float().abs()).max().item()
    rel = R.rwkv6_rel_err(o, *args)
    s_excess = ((s - want_s).abs() - SCAN_TOL * want_s.abs()).max().item()
    caught = [name for name, hit in (("3e-2", excess > BF16_TOL),
                                     ("ulp", rel > RWKV_REL_TOL),
                                     ("S_last 1e-4", s_excess > SCAN_TOL))
              if hit]
    return {"variant": variant, "o_excess_over_3e-2_gate": excess,
            "rel_err_ulps": rel / RWKV_REL_TOL, "S_last_excess": s_excess,
            "caught_by": caught}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--H", type=int, default=8)
    ap.add_argument("--T", type=int, default=300)
    ap.add_argument("--D", type=int, default=64)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: torch.cuda.is_available() is "
                             "False")
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.T <= 64:
        raise SystemExit("--T must exceed one chunk (64) for state_dropped")
    x = inputs(args.B, args.H, args.T, args.D, torch.device(args.device))
    want_o, want_s = R.rwkv6_ref(*x)
    ok = True
    for variant in VARIANTS:
        row = check(variant, x, want_o, want_s)
        row["shape"] = (f"B={args.B} H={args.H} T={args.T} Dk=Dv={args.D} "
                        f"bf16 on {args.device}")
        print(json.dumps(row), flush=True)
        ok &= bool(row["caught_by"]) == (variant != "sound")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The readings that the correctness limits are set from, on several seeds
in one process (the timed runs do not run this).

    python3 bench/control.py --workload nemo_serve --seeds 11,12,13

For each seed, at the cell's own size and through its own entry:

- serve cells: the check's sample of a window of ``--calls`` calls (the
  list's first calls in order), run through the program;
  ``served_gap`` and ``served_gap_mean`` of the program, and of the
  control: the reference at fp8
  (``reference.common.FP8``), judged by the token it puts first at each
  position of the same prompts and tokens;
- train cells: the entry's run with a window of ``--seconds`` (its
  set-up steps checked), the program's numbers, and on the first
  ``--control-seeds`` seeds also the control's (the reference at fp8 in
  the program's place, from the same weights) and, unless
  ``--no-faults``, two faults planted in the program: half of each batch
  left out (the loss's mean over the first half of the rows) and one
  leaf's gradient doubled where the step makes it.

Prints one JSON line a seed.  ``--device cpu --smoke`` runs the CPU
tests' sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(cell, calls_in_window: int, control: bool) -> dict:
    """Only the calls that the check's sample of a window of
    ``calls_in_window`` calls picks are run: each call's tokens depend on
    nothing but its own prompts."""
    from bench.entries import serve
    ctx = serve.prepare(cell)
    pairs = ctx["pairs"]
    calls = [{"key": f"{i}", "prompt": p, "output": o,
              "batch": cell.traffic["batch"]}
             for i, (p, o) in enumerate(pairs[i % len(pairs)]
                                        for i in range(calls_in_window))]
    picks = serve.sample(cell, calls)
    outs = [None] * len(calls)
    for j in sorted({j for j, _ in picks}):
        outs[j], _ = serve.call(cell, ctx["weights"], calls[j]["key"],
                                (calls[j]["prompt"], calls[j]["output"]))
    out = serve.readings(cell, ctx["weights"], calls, outs, picks)
    if control:
        ctrl = serve.readings(cell, ctx["weights"], calls, outs, picks,
                              control="fp8")
        out["control"] = {k: ctrl[k] for k in ("served_gap",
                                               "served_gap_mean")}
    return out


def half_batch(loss_fn):
    """The program's loss on the first half of each batch's rows."""
    def half(params, batch, cfg, *a, **kw):
        n = batch["tokens"].shape[0] // 2
        return loss_fn(params, {k: v[:n] for k, v in batch.items()}, cfg,
                       *a, **kw)
    return half


def gradient_doubled(loss_and_grads):
    """The program's step with the output projection's gradient doubled
    where the step makes it."""
    def doubled(*a, **kw):
        loss, metrics, grads = loss_and_grads(*a, **kw)
        grads["layers"]["pos0"]["core"]["out_proj"]["w"].mul_(2)
        return loss, metrics, grads
    return doubled


def _train(cell, control: bool = False, patch=None) -> dict:
    """The train entry's readings; ``patch`` = (module, name, fault)
    replaces ``module.name`` by ``fault(module.name)`` meanwhile."""
    from bench.entries import train
    if patch:
        module, name, fault = patch
        orig = getattr(module, name)
        setattr(module, name, fault(orig))
    try:
        rec = train.run(cell, control=control)
    finally:
        if patch:
            setattr(module, name, orig)
    cell.free()
    return rec["readings"]


def train_readings(cell, control: bool, faults: bool = True) -> dict:
    from repro_torch.models import transformer as TF
    from repro_torch.train import step as S
    r = _train(cell, control=control)
    out = {"program": {k: v for k, v in r.items() if k != "control"}}
    if control:
        out["control"] = r["control"]
    if control and faults:
        out["half_batch"] = _train(cell, patch=(TF, "loss_fn", half_batch))
        out["gradient_doubled"] = _train(
            cell, patch=(S, "loss_and_grads", gradient_doubled))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=10,
                    help="calls a serve window holds")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="a train cell's window")
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also read the control "
                    "(and the train cells' half-batch fault)")
    ap.add_argument("--no-faults", action="store_true",
                    help="train cells: the control without the faults")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from bench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(ROOT, args.workload, seed, args.seconds,
                                 False, args.device, args.smoke)
        control = n < args.control_seeds
        if cell.traffic["entry"] == "serve":
            out = serve_readings(cell, args.calls, control)
        else:
            out = train_readings(cell, control, not args.no_faults)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        del cell
    return 0


if __name__ == "__main__":
    # the checkout's root and the program's sources in place of this
    # script's folder, whose module names would shadow the standard
    # library's
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())

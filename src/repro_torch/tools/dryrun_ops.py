"""Where a dry-run cell's FLOPs go, per device: one cell traced as
``python -m repro_torch.launch.dryrun`` traces it, its products summed by
(op, local operand shapes), largest first.  A product that reads the
whole of a dim that a mesh dim splits elsewhere (a batch of 2048 where the
device holds 64 rows, say) is work repeated on every device of that mesh
dim.

    PYTHONPATH=src python -m repro_torch.tools.dryrun_ops --arch whisper_base --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.tools.dryrun_ops --arch mistral_nemo_12b --shape train_4k --top 12

Prints the cell's status, its counted / model FLOPs a device, then one
line per (op, shapes): share of the device's FLOPs, FLOPs, op, shapes.
"""

from __future__ import annotations

import argparse
import collections

import torch
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..launch import opcount
from ..launch.dryrun import run_cell


def ops_by_shape(arch: str, shape: str, multi_pod: bool = False,
                 mesh_shape=None, reduced: bool = False):
    """(the cell's record, [(flops, op, shapes)] largest first): the
    per-device FLOPs of each product the traced step ran."""
    by = collections.Counter()
    count = opcount.OpCounter._count

    def _count(self, func, args, kwargs, out):
        count(self, func, args, kwargs, out)
        if func.overloadpacket in flop_registry and not func.is_view:
            f = flop_registry[func.overloadpacket](*args, **(kwargs or {}),
                                                    out_val=out)
            shapes = tuple(tuple(a.shape) for a in tree_flatten(args)[0]
                           if isinstance(a, torch.Tensor))
            by[(str(func.overloadpacket), shapes)] += f

    opcount.OpCounter._count = _count
    try:
        rec = run_cell(arch, shape, multi_pod, None, verbose=False,
                       mesh_shape=mesh_shape, reduced=reduced)
    finally:
        opcount.OpCounter._count = count
    return rec, [(f, op, sh) for (op, sh), f in by.most_common()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    rec, rows = ops_by_shape(args.arch, args.shape, args.multi_pod)
    print(f"{args.arch} {args.shape} {rec['mesh']}: {rec['status']} "
          f"{rec.get('error', '')}")
    if rec["status"] != "ok":
        return 1
    rl = rec["roofline"]
    print(f"counted / model FLOPs a device: "
          f"{rl['flops_global'] / rl['model_flops']:.4f}")
    total = sum(f for f, _, _ in rows) or 1.0
    for f, op, shapes in rows[:args.top]:
        print(f"{f / total * 100:6.2f}% {f:.3e} {op} {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

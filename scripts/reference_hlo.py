#!/usr/bin/env python
"""Lower one of the reference's (JAX) dry-run cells on this machine's CPU
and keep its post-SPMD HLO, to read how GSPMD lays a cell out.

``python -m repro.launch.dryrun`` builds its production mesh with
``jax.make_mesh``, whose axes are Explicit on jax 0.9, where the
reference's ``with_sharding_constraint`` refuses them; this script lowers
the same cell (``repro.launch.cells.build_cell``) on a mesh of the same
shape with Auto axes, as the reference was written for.  It reads the
reference and edits nothing of it.  Writes ``<out>/<arch>__<shape>__<mesh>.hlo``
(``compiled.as_text()``) and ``.json`` (``repro.launch.roofline.analyze``'s
record: ``flops_global / model_flops`` is the counted FLOPs a device over
the model's), and prints the dots whose operands are 3-D or more (the
attention's products among them), each with its per-device shape.

    PYTHONPATH=src python scripts/reference_hlo.py --arch mistral-nemo-12b --shape train_4k --out /tmp/refhlo
    PYTHONPATH=src python scripts/reference_hlo.py --arch whisper-base --shape train_4k --multi-pod --out /tmp/refhlo

A train_4k cell takes seconds on the CPU (512 host devices).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import jax
    from jax.sharding import AxisType

    from repro.launch.cells import build_cell
    from repro.launch.roofline import analyze
    from repro.parallel.sharding import set_profile

    set_profile("tp")
    shape = (2, 16, 16) if args.multi_pod else (16, 16)
    axes = ("pod", "data", "model") if args.multi_pod else ("data", "model")
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
    with mesh:
        cell = build_cell(args.arch, args.shape, mesh)
        compiled = cell.lower().compile()
        text = compiled.as_text()
        record = analyze(args.arch, args.shape, cell.cfg, compiled,
                         mesh.size).as_dict()
    name = "pod2x16x16" if args.multi_pod else "pod16x16"
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"{args.arch}__{args.shape}__{name}")
    with open(stem + ".hlo", "w") as f:
        f.write(text)
    with open(stem + ".json", "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"{args.arch} {args.shape} {name}: counted / model FLOPs a device "
          f"{record['flops_global'] / record['model_flops']:.4f}; HLO in "
          f"{stem}.hlo")
    seen = set()
    for line in text.splitlines():
        m = re.search(r"= (\w+\[[\d,]+\])\{[\d,]*\} dot\(", line)
        if m and m.group(1).count(",") >= 2 and m.group(1) not in seen:
            seen.add(m.group(1))
            print(" ", line.strip().split(", metadata")[0][:200])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-pod dry run (the counterpart of ``repro.launch.dryrun``).

Shows the distribution config is coherent without hardware: every
(architecture × input shape) cell is traced once on fake tensors over a
``DeviceMesh`` of the ``"fake"`` process group, on either production mesh:

  * single-pod 16×16 = 256 devices, axes (data, model)   → ``pod16x16``
  * multi-pod 2×16×16 = 512 devices, axes (pod, data, model)
                                                         → ``pod2x16x16``

and records the memory one device holds and the per-device operation
counts (:mod:`repro_torch.launch.opcount`) against the H100's roofline
(:mod:`repro_torch.launch.roofline`).  The record's layout is the
reference's; ``memory.argument_size`` is what a device holds of the
parameters, state and batch, ``temp_size`` the peak of what the step
allocates beyond what is alive at its end, ``output_size`` what is, and
``alias_size`` 0 (the port writes its state in place).

Usage (PYTHONPATH=src):
  python -m repro_torch.launch.dryrun --arch mistral_nemo_12b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
  python -m repro_torch.launch.dryrun --all --both-meshes

Exits 1 if any cell fails; each cell's failure is its record's result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

__all__ = ["run_cell", "main"]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str | None,
             verbose: bool = True, profile: str = "tp", tag: str = "",
             mesh_shape=None, reduced: bool = False) -> dict:
    """One cell's record.  ``mesh_shape`` ((sizes), (names)) replaces the
    production mesh and ``reduced`` takes the config's smoke size (both
    for tests)."""
    from .cells import build_cell, cell_is_applicable
    from .mesh import fake_group, make_production_mesh, shape_mesh
    from .roofline import analyze
    from ..parallel.sharding import set_profile

    set_profile(profile)
    ok, why = cell_is_applicable(arch, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape[0]))
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "skip",
           "why": why, "profile": profile, "tag": tag}
    if not ok:
        return rec

    t0 = time.time()
    try:
        size = (math.prod(mesh_shape[0]) if mesh_shape is not None
                else 512 if multi_pod else 256)
        with fake_group(size):
            mesh = (shape_mesh(*mesh_shape) if mesh_shape is not None
                    else make_production_mesh(multi_pod=multi_pod))
            cell = build_cell(arch, shape, mesh, reduced=reduced)
            res = cell.trace()
            counts = res["counts"]
            out = counts.end_live_bytes
            temp = max(0, counts.peak_live_bytes - out)
            mem = {"argument_size": res["argument_bytes"],
                   "output_size": out, "temp_size": temp, "alias_size": 0}
            peak = res["argument_bytes"] + counts.peak_live_bytes
            rl = analyze(arch, shape, cell.cfg, counts, mesh.size(), peak)
        rec.update(status="ok", seconds=time.time() - t0, memory=mem,
                   roofline=rl.as_dict())
        if verbose:
            _log(f"[ok] {arch:<26} {shape:<12} {mesh_name}: "
                 f"{peak / 1e9:6.2f} GB/dev  "
                 f"Tc={rl.t_compute * 1e3:8.2f}ms "
                 f"Tm={rl.t_memory * 1e3:8.2f}ms "
                 f"Tx={rl.t_collective * 1e3:8.2f}ms -> {rl.bottleneck}  "
                 f"useful={rl.useful_flops_ratio:5.2f}  "
                 f"roofline={rl.roofline_fraction * 100:5.1f}%  "
                 f"({time.time() - t0:.0f} s)")
    except Exception as e:  # noqa: BLE001 — failures ARE the result here
        rec.update(status="fail", seconds=time.time() - t0,
                   error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            _log(f"[FAIL] {arch} {shape} {mesh_name}: {rec['error'][:200]}")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = f"{arch}__{shape}__{mesh_name}{suffix}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", default="tp")
    ap.add_argument("--tag", default="")
    ap.add_argument("--shapes", default=None,
                    help="comma list filter when using --all")
    args = ap.parse_args(argv)

    from .cells import all_cells

    if args.all:
        cells = all_cells()
        if args.shapes:
            keep = set(args.shapes.split(","))
            cells = [(a, sh) for a, sh in cells if sh in keep]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out, profile=args.profile,
                           tag=args.tag)
            n_fail += rec["status"] == "fail"
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

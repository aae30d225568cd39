"""Quickstart: generate a spatial accelerator with LEGO and validate it on
the card — the twin of the reference's ``examples/quickstart.py``.

The paper's Fig. 1 flow end to end:

  1. describe the workload (GEMM) and two spatial dataflows (the paper's
     switchable GEMM-MJ design: TPU-style K-J systolic + output-stationary
     I-J) as affine relations;
  2. front end: solve the reuse equations, span, fuse, bank;
  3. back end: lower to the primitive DAG and run the LP/ILP passes;
  4. report area/power;
  5. execute BOTH dataflows cycle by cycle on the generated architecture and
     check bit-exactness against the loop-nest oracle.

Standard output is the example's, line for line.  Beyond the example, each
dataflow also runs through the netlist simulator on the optimized DAG
(bit-exact against the same oracle); those lines go to standard error.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
(the card by default; ``--device cpu`` runs the same on the CPU).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .core import workload as W
from .core.adg import generate_adg
from .core.cost import dag_area_um2, dag_power_mw
from .core.dag import codegen
from .core.dataflow import build_dataflow
from .core.funcsim import oracle, simulate
from .core.passes import run_backend
from .core.rtlsim import simulate_rtl
from .models.common import check_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the simulators run (default: cuda)")
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    wl = W.gemm()
    df_jk = build_dataflow(wl, spatial=[("k", 8), ("j", 8)],
                           temporal=[("i", 4), ("j", 2), ("k", 2), ("i", 4)],
                           c=(1, 1), name="gemm-jk")
    df_ij = build_dataflow(wl, spatial=[("i", 8), ("j", 8)],
                           temporal=[("i", 2), ("j", 2), ("k", 16)],
                           c=(1, 1), name="gemm-ij")

    print("== front end: interconnect + banking ==")
    adg = generate_adg([(wl, df_jk), (wl, df_ij)], name="gemm-mj")
    for k, v in adg.summary().items():
        print(f"  {k}: {v}")

    print("== back end: LP/ILP optimization ==")
    base = codegen(adg)
    run_backend(base, optimize=False)
    opt = codegen(adg)
    report = run_backend(opt, optimize=True)
    a0, a1 = dag_area_um2(base).total_um2, dag_area_um2(opt).total_um2
    p0 = dag_power_mw(base).total_mw
    p1 = dag_power_mw(opt, active_df="gemm-jk").total_mw
    print(f"  area  : {a0/1e3:.0f} -> {a1/1e3:.0f} kum2  ({a0/a1:.2f}x)")
    print(f"  power : {p0:.1f} -> {p1:.1f} mW  ({p0/p1:.2f}x)")
    print(f"  passes: {list(report)}")

    print("== functional validation on the generated architecture ==")
    rng = np.random.default_rng(0)
    sizes = df_jk.sizes()
    X = rng.integers(-4, 5, (sizes["i"], sizes["k"])).astype(np.float64)
    Wm = rng.integers(-4, 5, (sizes["k"], sizes["j"])).astype(np.float64)
    inputs = {"X": torch.from_numpy(X).to(dev),
              "W": torch.from_numpy(Wm).to(dev)}
    ref = oracle(wl, sizes, inputs)
    for df in (df_jk, df_ij):
        res = simulate(adg, df.name, inputs)
        ok = bool(torch.equal(res.output, ref))
        print(f"  {df.name}: exact={ok}  cycles={res.cycles} "
              f"mem_reads={res.mem_reads}")
        assert ok
        net = simulate_rtl(opt, adg, df.name, inputs)
        ok = bool(torch.equal(net.output, ref))
        print(f"  {df.name} netlist: exact={ok}  cycles={net.cycles} "
              f"device={dev}", file=sys.stderr)
        assert ok
    print("OK: one architecture, two dataflows, bit-exact.")
    return 0


if __name__ == "__main__":
    sys.exit(main())

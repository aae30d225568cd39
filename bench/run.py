#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload nemo_serve --seed 7 --seconds 30 --trace 0

Loads the cell (``BENCHMARK.json`` and the files under ``bench/``), sets
up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and ``checks`` (each number compared, with its limit; also
the last lines on standard error).  Exits non-zero, printing no result,
without enough CUDA cards, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _since_process_start() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _since_process_start()
ROOT = Path(__file__).resolve().parent.parent


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program at a fixed path inside the checkout (the
    # port's own nvcc builds go to src/repro_torch/build/)
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; known: "
              f"{', '.join(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 3

    from bench import harness
    print(f"card: {_power_limit()}; peaks: bf16 989 TFLOP/s, HBM 3.35 TB/s "
          "(data sheet, 700 W)", file=sys.stderr)
    try:
        line, summary = harness.run(ROOT, args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    device="cuda", t_start=T_START)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 4
    print("run " + json.dumps(summary), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root and the program's sources in place of this
    # script's folder, whose module names would shadow the standard
    # library's
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())

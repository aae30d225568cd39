"""What the benchmark's CPU tests share: the checkout's root on the path,
and a run of a cell at the smoke sizes on the CPU (the harness without
its look for a card)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SERVE_CELLS = ("nemo_serve",)
TRAIN_CELLS = ("rwkv6_train",)
CELLS = SERVE_CELLS + TRAIN_CELLS


def run_smoke(workload: str, seed: int = 12345678901, trace: bool = False,
              root: Path = ROOT, seconds: float = 0.5) -> dict:
    from bench import harness
    return harness.run(root, workload, seed, seconds, trace, device="cpu",
                       smoke=True)[0]

"""K1 timed for the ``repro_torch`` of a given source tree with
``chip_smoke.py``'s timer, so that two trees (a parent commit unpacked with
``git archive`` and the change) are compared under one method in one call
to the card:

    python src/repro_torch/tools/k1_ab.py --src DIR --label NAME

DIR is the directory holding the tree's ``repro_torch``.  At phase 7's K1
shapes — Mistral-NeMo's up-projection at T = 2048 and the decode-shaped
(1 and 7) x 5120 . (5120 x 5120) in bf16, the micro-bench's 512^3 in fp32
— and at bf16 shapes that TMA cannot take (K or N not a multiple of 8:
phase 3's (257 x 1001) . (1001 x 250), and (1 and 64) x 5120 . (5120 x
5121), which run on the ``mma.sync`` kernel) it times ``ops.gemm`` (each
tree picks its own tile and split) and
``torch.matmul`` on the same operands: CUDA events over 20 calls after
0.1 s of warm-up (``ms``, ``matmul_ms``), and the same calls captured in a
CUDA graph (``graph_ms``, ``matmul_graph_ms``: the device's time where an
eager call is paced by the host).  Prints one JSON line.  Run it as
parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]

# (name, M, K, N, dtype): chip_smoke.py's phase 7, then the mma.sync route
SHAPES = (
    ("up-projection", 2048, 5120, 14336, "bfloat16"),
    ("micro-bench 512^3", 512, 512, 512, "float32"),
    ("decode M=1", 1, 5120, 5120, "bfloat16"),
    ("decode M=7", 7, 5120, 5120, "bfloat16"),
    ("unaligned 257x1001x250", 257, 1001, 250, "bfloat16"),
    ("unaligned M=1 N=5121", 1, 5120, 5121, "bfloat16"),
    ("unaligned M=64 N=5121", 64, 5120, 5121, "bfloat16"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--label", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from chip_smoke import time_ms   # puts REPO/src first
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    import repro_torch
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise SystemExit("k1_ab times the card: torch.cuda.is_available() "
                         "is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = Path(repro_torch.__file__).resolve().parent
    if pkg != args.src.resolve() / "repro_torch":
        raise SystemExit(f"imported {pkg}, not the tree under {args.src}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label, "package": str(pkg), "card": card,
           "ms": {}, "graph_ms": {}, "matmul_ms": {}, "matmul_graph_ms": {}}
    for name, M, K, N, dtype in SHAPES:
        dt = getattr(torch, dtype)
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        w = torch.randn((K, N), generator=gen, device=dev).to(dt)
        call = lambda: ops.gemm(x, w)
        lib = lambda: torch.matmul(x, w)
        out["ms"][name] = time_ms(call)
        out["graph_ms"][name] = time_ms(call, graph=True)
        out["matmul_ms"][name] = time_ms(lib)
        out["matmul_graph_ms"][name] = time_ms(lib, graph=True)
        del x, w
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

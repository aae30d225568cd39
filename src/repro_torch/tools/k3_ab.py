"""K3 timed for the ``repro_torch`` of a given source tree with
``chip_smoke.py``'s timer, so that two trees (a parent commit unpacked with
``git archive`` and the change) are compared under one method in one call
to the card:

    python src/repro_torch/tools/k3_ab.py --src DIR --label NAME

DIR is the directory holding the tree's ``repro_torch``.  At Jamba's
forward shape (Bt = 1, L = 2048, Dm = d_inner = 16384, N = d_state = 16,
bf16, inputs drawn as ``chip_smoke.py`` draws them) it times
``ops.ssm_scan``: CUDA events over 20 calls after 0.1 s of warm-up (``ms``)
and the same calls captured in a CUDA graph (``graph_ms``: the device's
time where an eager call is paced by the host), and the same two in fp32
on the same values (``fp32_ms``, ``fp32_graph_ms``: the fp32 route that
the depth-2 consistency forwards run).  Then one Mamba layer of
Jamba-1.5-Large at full width, ``blocks.mamba_fwd`` on 2048 tokens with
random weights (``mamba_fwd_ms``, 20 calls after a warm-up, CUDA events),
with the K3 calls it made.  Prints one JSON line.  Run it as parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]


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
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    from repro_torch.models import blocks

    if not torch.cuda.is_available():
        raise SystemExit("k3_ab times the card: torch.cuda.is_available() "
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
    cfg = get_config("jamba_1_5_large_398b")
    Bt, L, Dm, N = 1, 2048, cfg.d_inner, cfg.d_state
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rand(Bt, L, Dm).to(bf)
    dt = torch.nn.functional.softplus(rand(Bt, L, Dm) - 1.0).to(bf)
    A = -torch.exp(0.5 * rand(Dm, N))
    B, C = rand(Bt, L, N).to(bf), rand(Bt, L, N).to(bf)
    D = torch.full((Dm,), 0.5, device=dev)
    call = lambda: ops.ssm_scan(x, dt, A, B, C, D)
    out = {"label": args.label, "package": str(pkg), "card": card,
           "shape": f"Bt={Bt} L={L} Dm={Dm} N={N} bf16",
           "ms": time_ms(call), "graph_ms": time_ms(call, graph=True)}
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    out["fp32_ms"] = time_ms(call)
    out["fp32_graph_ms"] = time_ms(call, graph=True)
    del x, dt, A, B, C, D

    p = blocks.mamba_init(cfg, torch.Generator(dev).manual_seed(9), dev)
    with torch.inference_mode():
        xm = rand(1, L, cfg.d_model).to(bf)
        fwd = lambda: blocks.mamba_fwd(cfg, p, xm)
        fwd()
        torch.cuda.synchronize()
        before = ssm_scan_cuda.launches
        fwd()
        torch.cuda.synchronize()
        out["mamba_fwd_k3_calls"] = ssm_scan_cuda.launches - before
        out["mamba_fwd_ms"] = time_ms(fwd)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K4 timed for the ``repro_torch`` of a given source tree with
``chip_smoke.py``'s timer, so that two trees (a parent commit unpacked with
``git archive`` and the change) are compared under one method in one call
to the card:

    python src/repro_torch/tools/k4_ab.py --src DIR --label NAME

DIR is the directory holding the tree's ``repro_torch``.  At RWKV-6 7B's
forward shape (B = 1, H = 64, T = 2048, Dk = Dv = 64, bf16, inputs drawn
as ``chip_smoke.py`` draws them) it times ``ops.rwkv6``: CUDA events over
20 calls after 0.1 s of warm-up (``ms``) and the same calls captured in a
CUDA graph (``graph_ms``: the device's time where an eager call is paced
by the host).  Then one RWKV-6 7B ``forward`` at full width and depth on
2048 tokens with random weights (``forward_ms``, 5 calls after a warm-up,
CUDA events), with the K4 calls it made and, where the tree counts them,
those on the tensor-core kernel.  Prints one JSON line.  Run it as parent,
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
    from repro_torch.kernels.rwkv6 import rwkv6_cuda
    from repro_torch.models import transformer as TF

    if not torch.cuda.is_available():
        raise SystemExit("k4_ab times the card: torch.cuda.is_available() "
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
    cfg = get_config("rwkv6_7b")
    B, H, T, D = 1, cfg.d_model // cfg.rwkv_head_dim, 2048, cfg.rwkv_head_dim
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, v = rand(B, H, T, D).to(bf), rand(B, H, T, D).to(bf)
    k = (0.3 * rand(B, H, T, D)).to(bf)
    w = torch.sigmoid(rand(B, H, T, D) + 2.0).to(bf)
    u = (0.1 * rand(H, D)).to(bf)
    call = lambda: ops.rwkv6(r, k, v, w, u)
    out = {"label": args.label, "package": str(pkg), "card": card,
           "shape": f"B={B} H={H} T={T} Dk=Dv={D} bf16",
           "ms": time_ms(call), "graph_ms": time_ms(call, graph=True)}
    del r, k, v, w, u

    params = TF.init_params(cfg, torch.Generator(dev).manual_seed(3), dev)
    with torch.inference_mode():
        toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                             device=dev, dtype=torch.int32)
        fwd = lambda: TF.forward(params, toks, cfg)
        fwd()
        torch.cuda.synchronize()
        before = (rwkv6_cuda.launches,
                  getattr(rwkv6_cuda, "tensor_core_launches", None))
        fwd()
        torch.cuda.synchronize()
        out["forward_k4_calls"] = rwkv6_cuda.launches - before[0]
        out["forward_k4_tensor_core_calls"] = (
            None if before[1] is None
            else rwkv6_cuda.tensor_core_launches - before[1])
        out["forward_ms"] = time_ms(fwd, reps=5)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

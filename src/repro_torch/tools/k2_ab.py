"""K2 prefill in bf16, and the forwards that launch it most, timed for the
``repro_torch`` of a given source tree with ``chip_smoke.py``'s timer, so
that two trees (a parent commit unpacked with ``git archive`` and the
change) are compared under one method in one call to the card:

    python src/repro_torch/tools/k2_ab.py --src DIR --label NAME

DIR is the directory holding the tree's ``repro_torch``.  Prints one JSON
line: ``ops.flash_attention``'s mean ms at the four shapes of
``chip_smoke.py``'s phase 7 (each tree picks its own tile), and the mean ms
and K2 prefill launches of ``forward`` on 2048 positions for Mistral-NeMo
12B and Phi-3-vision (576 patch embeddings, then 1472 tokens) at full width
and depth with random weights.  Run it as parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]

# (name, B, Hq, Hkv, Tq, Tk, D, causal), as chip_smoke.py's phase 7
SHAPES = (
    ("Mistral-NeMo", 1, 32, 8, 2048, 2048, 128, True),
    ("Phi-3-vision", 1, 32, 32, 2048, 2048, 96, True),
    ("Whisper encoder", 4, 8, 8, 1500, 1500, 64, False),
    ("Whisper cross step", 4, 8, 8, 1, 1500, 64, False),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--label", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from chip_smoke import time_ms   # puts REPO/src first on the path
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    pkg = Path(repro_torch.__file__).resolve().parent
    if pkg != args.src.resolve() / "repro_torch":
        raise SystemExit(f"imported {pkg}, not the tree under {args.src}")
    out = {"label": args.label, "package": str(pkg), "prefill_ms": {},
           "forward_ms": {}, "forward_prefill_launches": {}}
    for name, B, Hq, Hkv, Tq, Tk, D, causal in SHAPES:
        q = torch.randn((B, Hq, Tq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, Tk, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        out["prefill_ms"][name] = time_ms(
            lambda: ops.flash_attention(q, k, v, causal=causal))
        del q, k, v
    for arch, seed in (("mistral_nemo_12b", 0), ("phi_3_vision_4_2b", 11)):
        cfg = get_config(arch)
        prefix = cfg.prefix_len
        params = TF.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                                dev)
        with torch.inference_mode():
            toks = torch.randint(0, cfg.vocab_size, (1, 2048 - prefix),
                                 generator=gen, device=dev, dtype=torch.int32)
            pre = (torch.randn((1, prefix, cfg.d_model), generator=gen,
                               device=dev).to(cfg.torch_dtype)
                   if prefix else None)
            fwd = lambda: TF.forward(params, toks, cfg, prefix_embeds=pre)
            fwd()
            torch.cuda.synchronize()
            before = flash_attention_cuda.launches
            fwd()
            out["forward_prefill_launches"][arch] = (
                flash_attention_cuda.launches - before)
            out["forward_ms"][arch] = time_ms(fwd, reps=5)
        del params
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

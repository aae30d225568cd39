"""K2 in bf16, and the model steps that launch it most, timed for the
``repro_torch`` of a given source tree with ``chip_smoke.py``'s timer, so
that two trees (a parent commit unpacked with ``git archive`` and the
change) are compared under one method in one call to the card:

    python src/repro_torch/tools/k2_ab.py --src DIR --label NAME

DIR is the directory holding the tree's ``repro_torch``.  Prints one JSON
line:

  * ``prefill_ms``: ``ops.flash_attention``'s mean ms at the four prefill
    shapes of ``chip_smoke.py``'s phase 7 (each tree picks its own tile);
  * ``decode_ms``: ``ops.decode_attention``'s ms per call at phase 7's five
    decode shapes, as CUDA graphs of 20 calls (the device's time; an eager
    call is paced by the host), ``decode_eager_ms`` the eager calls, and
    ``decode_host_us`` the host's µs per call issued back to back without
    a synchronisation at the 40-position shape (where the card keeps up);
  * ``forward_ms`` and ``forward_prefill_launches``: ``forward`` on 2048
    positions for Mistral-NeMo 12B and Phi-3-vision (576 patch embeddings,
    then 1472 tokens) at full width and depth with random weights;
  * ``long_cache``: Mistral-NeMo's decode step at batch 4 over a
    4096-position cache (``chip_smoke.long_cache_step``): host-clock ms of
    each of 12 steps, and one profiled step's device-busy ms and K2
    decode ms.

Run it as parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]

# (name, B, Hq, Hkv, Tq, Tk, D, causal), as chip_smoke.py's phase 7
SHAPES = (
    ("Mistral-NeMo", 1, 32, 8, 2048, 2048, 128, True),
    ("Phi-3-vision", 1, 32, 32, 2048, 2048, 96, True),
    ("Whisper encoder", 4, 8, 8, 1500, 1500, 64, False),
    ("Whisper cross step", 4, 8, 8, 1, 1500, 64, False),
)
# (name, B, Hq, Hkv, S, D, pos, window), as chip_smoke.py's phase 7
DECODE_SHAPES = (
    ("Mistral-NeMo", 4, 32, 8, 4096, 128, 4095, None),
    ("Phi-3-vision", 4, 32, 32, 4096, 96, 4095, None),
    ("Jamba attention", 4, 64, 8, 4096, 128, 4095, None),
    ("Gemma-2 window", 4, 16, 8, 8192, 256, 8191, 4096),
    ("phase 4 generate", 4, 32, 8, 40, 128, 39, None),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--label", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from chip_smoke import long_cache_step, time_ms   # puts REPO/src first
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
           "decode_ms": {}, "decode_eager_ms": {}, "forward_ms": {},
           "decode_host_us": {},
           "forward_prefill_launches": {}}
    for name, B, Hq, Hkv, Tq, Tk, D, causal in SHAPES:
        q = torch.randn((B, Hq, Tq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, Tk, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        out["prefill_ms"][name] = time_ms(
            lambda: ops.flash_attention(q, k, v, causal=causal))
        del q, k, v
    for name, B, Hq, Hkv, S, D, pos, window in DECODE_SHAPES:
        q = torch.randn((B, Hq, 1, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, S, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        call = lambda: ops.decode_attention(q, k, v, pos=pos_t, window=window)
        out["decode_ms"][name] = time_ms(call, graph=True)
        out["decode_eager_ms"][name] = time_ms(call)
        if S <= 40:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            out["decode_host_us"][name] = (time.perf_counter() - t0) * 5e3
            torch.cuda.synchronize()
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
        if arch == "mistral_nemo_12b":
            r = long_cache_step(cfg, params, dev, gen, steps=12)
            out["long_cache"] = {key: r[key] for key in (
                "S", "B", "host_ms", "traced_ms", "busy_ms", "k2_decode_ms",
                "device_events", "decode_calls", "split_calls")}
        del params
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

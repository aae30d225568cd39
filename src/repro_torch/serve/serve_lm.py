"""Batched serving example of the port: prefill + greedy decode with KV
caches or recurrent states, the twin of ``examples/serve_lm.py``.  Serves
the reduced (smoke) config of a decoder LM the port runs (the dense LMs,
RWKV-6, the Jamba hybrid, the MoE LMs or Phi-3-vision's decoder, without
its image prefix, as the reference example serves it).  The
encoder-decoder (whisper_base) has no ``generate``: it is refused here, as
the reference example cannot serve it either.

Run:  PYTHONPATH=src python -m repro_torch.serve.serve_lm \
          --arch mistral_nemo_12b --batch 4 --new 24
      (--arch rwkv6_7b, jamba_1_5_large_398b, deepseek_moe_16b,
       llama4_scout_17b_a16e or phi_3_vision_4_2b for the others)
      (add --device cpu to run the plain path on the CPU)
"""

import argparse
import time

import torch

from ..configs import PORTED_IDS, get_config
from ..models import transformer as TF
from ..models.common import check_device
from .engine import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral_nemo_12b",
                    help=f"one of {', '.join(PORTED_IDS)}")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # fp32 products stay full fp32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch, reduced=True)
    if cfg.is_encoder_decoder:
        ap.error(f"{args.arch} is an encoder-decoder model; serve_lm serves "
                 "decoder LMs through generate (drive it through "
                 "serve.engine.build_serve_step with encdec.encode's output)")
    device = check_device(args.device)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = TF.init_params(cfg, gen, device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new=args.new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    toks = args.batch * args.new
    print(f"arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new}")
    print(f"generated {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s on {where}, first call included)")
    print("sample token ids:", out[0, -args.new:].tolist()[:12], "...")
    return out


if __name__ == "__main__":
    main()

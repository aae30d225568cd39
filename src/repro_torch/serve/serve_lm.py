"""Batched serving example of the port: prefill + greedy decode with KV
caches or recurrent states, the twin of ``examples/serve_lm.py``.  Serves
the reduced (smoke) config of a decoder LM the port runs, by default the
Jamba hybrid as the reference example does (attention KV caches, Mamba
conv/ssm states and MoE routing all on the decode path); also the dense
LMs, RWKV-6, the MoE LMs or Phi-3-vision's decoder, without its image
prefix, as the reference example serves it.  The encoder-decoder
(whisper_base) has no ``generate``: it is refused here, as the reference
example cannot serve it either.

:func:`serve` takes the parameters and prompts and returns the tokens and
the printed lines, so that the reference example's converted parameters
and prompts can be served and its output compared line by line.

Run:  PYTHONPATH=src python -m repro_torch.serve.serve_lm --batch 4 --new 24
      (--arch rwkv6_7b, mistral_nemo_12b, deepseek_moe_16b,
       llama4_scout_17b_a16e or phi_3_vision_4_2b for the others)
      (add --device cpu to run the plain path on the CPU; --trace
       OUT.json writes generate's spans as a Chrome trace, device times
       in ``args``, and the counters ``engine.calls``, ``engine.captures``
       and ``engine.replays`` as counter tracks)
"""

import argparse
import time

import torch

from ..configs import PORTED_IDS, get_config
from ..models import transformer as TF
from ..models.common import ModelConfig, check_device
from ..obs import METRICS, counter_events, enable_tracing, save_trace
from .engine import generate


def serve(params, cfg: ModelConfig, prompts: torch.Tensor,
          new: int) -> tuple[torch.Tensor, list[str]]:
    """Greedy generation of ``new`` tokens after ``prompts`` (B, Tp) int32,
    timed; returns the tokens (B, Tp + new) and the lines the reference
    example prints (arch, throughput, sample token ids)."""
    device = prompts.device
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new=new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    batch, prompt_len = prompts.shape
    toks = batch * new
    lines = [f"arch={cfg.name} batch={batch} prompt={prompt_len} new={new}",
             f"generated {toks} tokens in {dt:.3f}s "
             f"({toks / dt:.1f} tok/s on {where}, first call included)",
             f"sample token ids: {out[0, -new:].tolist()[:12]} ..."]
    return out, lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba_1_5_large_398b",
                    help=f"one of {', '.join(PORTED_IDS)}")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", metavar="OUT.json",
                    help="record generate's spans and write them, with "
                         "the run's counters, here as Chrome trace-event "
                         "JSON")
    args = ap.parse_args(argv)
    if args.trace:
        enable_tracing()

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
    out, lines = serve(params, cfg, prompts, args.new)
    for line in lines:
        print(line)
    if args.trace:
        save_trace(args.trace,
                   counter_events(METRICS.snapshot()["counters"]))
        print(f"trace: {args.trace}")
    return out


if __name__ == "__main__":
    main()

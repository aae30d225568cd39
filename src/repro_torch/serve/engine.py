"""Batched serving on one device: teacher-forced prefill + greedy decode
(``repro.serve.engine``'s counterpart with ``mesh=None``; the port has no
sharding yet).

The decode position lives in a 0-d int32 tensor on the device and is
advanced there, so the decode kernels read it without the host waiting on
the device between steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import encdec as ED
from ..models import transformer as TF
from ..models.common import ModelConfig

__all__ = ["ServeConfig", "build_serve_step", "generate"]


@dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_len: int
    temperature: float = 0.0


def build_serve_step(cfg: ModelConfig, backend: str = "kernel"):
    """Returns the one-token step → (next-token logits, state):
    ``step(params, state, token, pos)`` for a decoder LM (the step of
    :func:`generate`), ``step(params, state, token, pos, enc_out)`` for an
    encoder-decoder model, ``enc_out`` from ``encdec.encode``."""

    if cfg.is_encoder_decoder:
        def step(params, state, token, pos, enc_out):
            return ED.decode_step_encdec(params, state, token, pos, enc_out,
                                         cfg, backend)
    else:
        def step(params, state, token, pos):
            return TF.decode_step(params, state, token, pos, cfg, backend)

    return step


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, max_new: int,
             backend: str = "kernel") -> torch.Tensor:
    """Greedy batched generation (decoder-only models).
    prompts (B, Tp) int32 → (B, Tp + max_new), on the prompts' device."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"generate serves decoder-only models; drive "
                         f"{cfg.name} through build_serve_step with the "
                         "encoder's output")
    Bsz, Tp = prompts.shape
    state = TF.init_decode_state(cfg, Bsz, Tp + max_new,
                                 device=prompts.device)
    step = build_serve_step(cfg, backend)
    pos = torch.zeros((), dtype=torch.int32, device=prompts.device)

    # teacher-forced prefill through the decode path (exact, cache-filling)
    logits = None
    for t in range(Tp):
        logits, state = step(params, state, prompts[:, t], pos)
        pos += 1

    out = [prompts]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(max_new):
        out.append(tok[:, None])
        if i == max_new - 1:
            break
        logits, state = step(params, state, tok, pos)
        pos += 1
        tok = logits.argmax(-1).to(torch.int32)
    return torch.cat(out, dim=1)

"""The train cells' batches, worked out again by the reference: a frozen
copy of the arithmetic of the program's ``data/pipeline.py`` ``batch_at``
(a CPU generator seeded by splitmix64 over (seed, step); tokens the floor
of V·u³, with probability 0.3 the predecessor's base token + 1 mod V;
labels shifted by one, −1 at the last position).  The harness's checks
hold the program's batches to it."""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, step: int) -> int:
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mul) & _MASK64
    return (z ^ (z >> 31)) >> 1


def batch(seed: int, step: int, batch_size: int, seq_len: int,
          vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels), each (batch_size, seq_len) int32, on the CPU."""
    gen = torch.Generator().manual_seed(stream_seed(seed, step))
    B, T, V = batch_size, seq_len, vocab
    u = torch.rand((B, T), generator=gen) * (1.0 - 1e-6) + 1e-6
    base = torch.floor(V * u.pow(3.0)).to(torch.int32).clamp_max(V - 1)
    rep = torch.roll(base, 1, dims=1) + 1
    mix = torch.rand((B, T), generator=gen) < 0.3
    tokens = torch.where(mix, rep % V, base)
    labels = torch.cat([tokens[:, 1:],
                        torch.full((B, 1), -1, dtype=torch.int32)], dim=1)
    return tokens, labels

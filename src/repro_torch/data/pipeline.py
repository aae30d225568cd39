"""Deterministic, stateless synthetic token pipeline (``repro.data.pipeline``'s
counterpart).

``batch_at(ds, step)`` is a pure function of ``(seed, step)``: any process
can make any step's batch without coordination or stored iterator state,
so a restart resumes at step N with exactly the data it would have seen.
The reference draws with threefry, which torch cannot reproduce, so the
port keeps its contract, not its bits: the same marginal (the floor of
V·u³, u uniform in [1e-6, 1)), the same local structure (with probability
0.3 a token is its predecessor's base token + 1, mod V; at t = 0 the
predecessor wraps around to the row's last), labels shifted by one with −1
at the last position, and a (B, P, d) fp32 prefix of N(0, 0.02²) stubs
when ``prefix_len`` is set.  Everything is drawn on the CPU from a
generator seeded by (seed, step) and then moved to ``device``, so the CPU
and a card see the same batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SyntheticLM", "batch_at"]

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefix_len: int = 0
    d_model: int = 0  # for prefix-embed stubs


def _stream_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step): splitmix64's finalizer
    over the pair, so neighbouring steps and seeds get unrelated
    streams."""
    z = (seed * 0x9E3779B97F4A7C15 + step + 1) & _MASK64
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        z = ((z ^ (z >> shift)) * mul) & _MASK64
    return (z ^ (z >> 31)) >> 1


def batch_at(ds: SyntheticLM, step: int, device="cpu") -> dict:
    """Pure: (dataset spec, step) → the global batch {tokens (B, T) int32,
    labels (B, T) int32[, prefix_embeds (B, P, d) fp32]} on ``device``."""
    gen = torch.Generator().manual_seed(_stream_seed(ds.seed, step))
    B, T, V = ds.global_batch, ds.seq_len, ds.vocab_size
    u = torch.rand((B, T), generator=gen) * (1.0 - 1e-6) + 1e-6
    base = torch.floor(V * u.pow(3.0)).to(torch.int32).clamp_max(V - 1)
    rep = torch.roll(base, 1, dims=1) + 1
    mix = torch.rand((B, T), generator=gen) < 0.3
    tokens = torch.where(mix, rep % V, base)
    labels = torch.cat([tokens[:, 1:],
                        torch.full((B, 1), -1, dtype=torch.int32)], dim=1)
    batch = {"tokens": tokens, "labels": labels}
    if ds.prefix_len:
        batch["prefix_embeds"] = torch.randn(
            (B, ds.prefix_len, ds.d_model), generator=gen) * 0.02
    return {k: v.to(device) for k, v in batch.items()}

"""The serve cells' (prompt, output) length list: clipped exponentials
drawn once from a seed kept in the traffic file.

A frozen copy of the length draw of the program's ``serve/trace.py``
(``_clipped_exp_length``: 1 + Exp(mean − 1), clipped to [1, max], from
NumPy's PCG64), so that a later change to the program cannot move the
traffic.  Only the lengths are drawn: no arrival times, no model mix.
"""

from __future__ import annotations

import numpy as np


def clipped_exp(rng: np.random.Generator, mean: int, mx: int) -> int:
    if mean <= 1:
        return 1
    return min(1 + int(rng.exponential(mean - 1)), mx)


def length_pairs(spec: dict) -> list[tuple[int, int]]:
    """``spec``: {"count", "seed", "prompt": {"mean", "max"}, "output":
    {"mean", "max"}} → ``count`` (prompt, output) pairs, prompt drawn
    before output for each."""
    p, o = spec["prompt"], spec["output"]
    for what, d in (("prompt", p), ("output", o)):
        if not 1 <= d["mean"] <= d["max"]:
            raise ValueError(f"{what} lengths need 1 <= mean <= max: {d}")
    rng = np.random.default_rng(spec["seed"])
    pairs = []
    for _ in range(spec["count"]):
        prompt = clipped_exp(rng, p["mean"], p["max"])
        output = clipped_exp(rng, o["mean"], o["max"])
        pairs.append((prompt, output))
    return pairs

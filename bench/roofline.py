"""The yardstick: the H100's peaks and the operation and byte counts the
metrics divide by, worked out from shapes alone.

Frozen here so that a later change to the program cannot move it.  The
peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense,
no sparsity), as the program's ``kernels/autotile.py`` has them; each run
logs the card's ``power.limit`` beside its numbers.
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, bf16 and fp16 on the tensor cores
PEAK_BYTES = 3.35e12         # bytes/s of HBM3


def serve_call_flops(arch, hp: dict, batch: int, steps: int) -> float:
    """Model FLOPs of ``steps`` one-token steps at positions 0 … steps − 1
    for ``batch`` sequences: 2 per multiplying parameter and token (the
    embedding lookup does none), plus the architecture's mixer at each
    position (:func:`arch.mixer_flops`)."""
    per_tok = 2 * arch.matmul_params(hp)
    total = 0.0
    for pos in range(steps):
        total += batch * (per_tok + arch.mixer_flops(hp, pos))
    return total


def train_step_flops(arch, hp: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` × ``seq`` tokens:
    6 per multiplying parameter and token (forward 2, backward 4), plus
    three times the mixer's forward work summed over the positions; work
    that rematerialization repeats is not counted."""
    tokens = batch * seq
    mixer = sum(arch.mixer_flops(hp, pos) for pos in range(seq))
    return 6 * arch.matmul_params(hp) * tokens + 3 * batch * mixer


def k2_decode_bound_s(batch: int, hq: int, hkv: int, hd: int, pos: int,
                      elem: int = 2) -> float:
    """The least time of one K2 decode call at query position ``pos``: the
    larger of its bytes (K and V read once at positions 0 … pos, q read
    and o written once) over the HBM peak and its operations (QKᵀ and PV,
    2 FLOPs a multiply-add) over the bf16 peak."""
    n = pos + 1
    nbytes = (2 * batch * hkv * n * hd + 2 * batch * hq * hd) * elem
    ops = 4 * batch * hq * n * hd
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS_BF16)


def weight_read_bound_s(arch, hp: dict, elem: int = 2) -> float:
    """A decode step's floor from reading every parameter once."""
    return arch.param_count(hp) * elem / PEAK_BYTES

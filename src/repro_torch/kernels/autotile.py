"""LEGO-derived tile selection for the Hopper attention kernel.

The objective is ``repro.kernels.autotile.attention_tiles``'s: maximize the
arithmetic intensity ``bq·bk·D / (bq·D + bk·D + bq·bk)`` of one (q-tile,
kv-tile) step, subject to the working set fitting on chip.  What changes is
the chip: the budget is one thread block's shared memory on an H100
(227 KB), and the tile shapes are those the CUDA kernel is built for —
``bq`` rows with four threads per row (so 4·bq threads, whole warps) and
``bk`` columns in steps of 16 (each thread owns bk/16 score columns).
"""

from __future__ import annotations

SMEM_BYTES = 227 * 1024   # dynamic shared memory one block may use (sm_90)

BQ_CHOICES = (16, 32, 64)
BK_CHOICES = (32, 64)


def attention_smem_bytes(bq: int, bk: int, D: int) -> int:
    """Shared memory of one prefill block, as ``csrc/flash_attention.cu``
    lays it out: fp32 Q (bq×(D+1)), K (bk×(D+1)), V (bk×D) and scores
    (bq×(bk+1)) tiles plus three bq-long softmax state vectors.  Tiles are
    staged in fp32 whatever the input dtype."""
    return 4 * (bq * (D + 1) + bk * (D + 1) + bk * D + bq * (bk + 1) + 3 * bq)


def attention_tiles(Tq: int, Tk: int, D: int,
                    smem_budget: int = SMEM_BYTES) -> tuple[int, int]:
    """(bq, bk) for the prefill kernel: the largest-intensity pair whose
    working set fits ``smem_budget``, with no tile wider than the problem
    needs."""
    best, best_ai = None, -1.0
    for bq in BQ_CHOICES:
        if bq > max(BQ_CHOICES[0], Tq):
            continue
        for bk in BK_CHOICES:
            if bk > max(BK_CHOICES[0], Tk):
                continue
            if attention_smem_bytes(bq, bk, D) > smem_budget:
                continue
            ai = (bq * bk * D) / (bq * D + bk * D + bq * bk)
            if ai > best_ai:
                best_ai, best = ai, (bq, bk)
    if best is None:
        raise ValueError(f"no attention tile fits {smem_budget} bytes "
                         f"of shared memory at head_dim {D}")
    return best

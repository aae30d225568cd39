"""LEGO-derived tile selection for the Hopper GEMM and attention kernels.

The objectives are ``repro.kernels.autotile``'s: maximize the arithmetic
intensity of one tile step — ``bm·bn·bk / (bm·bk + bk·bn + bm·bn)`` for the
GEMM, divided by the share of the grid that ragged edge tiles waste, and
``bq·bk·D / (bq·D + bk·D + bq·bk)`` for attention — subject to the working
set fitting on chip.  What changes is the chip: the budget is one thread
block's shared memory on an H100 (227 KB), counted as the CUDA kernels lay
it out, and the candidates are only the tile shapes the kernels are built
for (``GEMM_TILES``; for attention ``bq`` rows with four threads per row,
so 4·bq threads, whole warps, and ``bk`` columns in steps of 16, each
thread owning bk/16 score columns).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

SMEM_BYTES = 227 * 1024   # dynamic shared memory one block may use (sm_90)

# (bm, bn, bk) instantiated in csrc/gemm.cu, by element size in bytes: fp32
# on the CUDA cores (bm/16 x bn/16 outputs per thread, 256 threads), bf16
# on the tensor cores (a warp per min(bm, 64) x 32 slice)
GEMM_TILES = {
    4: ((16, 64, 16), (16, 128, 16), (64, 64, 16), (64, 128, 16),
        (128, 128, 16)),
    2: ((16, 64, 32), (16, 128, 32), (64, 64, 32), (64, 128, 32),
        (128, 128, 32)),
}
GEMM_STAGES = 2

BQ_CHOICES = (16, 32, 64)
BK_CHOICES = (32, 64)


@dataclass(frozen=True)
class GemmTiles:
    bm: int
    bn: int
    bk: int


def gemm_smem_bytes(bm: int, bn: int, bk: int, dtype_bytes: int,
                    stages: int = GEMM_STAGES) -> int:
    """Shared memory of one GEMM block, as ``csrc/gemm.cu`` lays it out:
    ``stages`` copies of the X tile (bm rows) and the W tile (bk rows), each
    row padded by one 16-byte chunk, in the input dtype."""
    pad = 16 // dtype_bytes
    return stages * dtype_bytes * (bm * (bk + pad) + bk * (bn + pad))


def gemm_tiles(M: int, N: int, K: int, dtype_bytes: int = 2,
               smem_budget: int = SMEM_BYTES) -> GemmTiles:
    """(bm, bn, bk) for the GEMM kernel: among the built tiles of the dtype,
    the highest intensity per ragged waste whose stages fit
    ``smem_budget``, with no tile side wider than the problem needs (the
    tile of the smallest built sides always qualifies).  Raises if none
    fits."""
    if dtype_bytes not in GEMM_TILES:
        raise ValueError(f"no GEMM tiles built for {dtype_bytes}-byte "
                         f"elements (built: {sorted(GEMM_TILES)})")
    tiles = GEMM_TILES[dtype_bytes]
    small = [min(t[i] for t in tiles) for i in range(3)]
    best, best_score = None, -1.0
    for bm, bn, bk in tiles:
        if bm > max(small[0], M) or bn > max(small[1], N) \
                or bk > max(small[2], K):
            continue
        if gemm_smem_bytes(bm, bn, bk, dtype_bytes) > smem_budget:
            continue
        ai = (bm * bn * bk) / (bm * bk + bk * bn + bm * bn)
        waste = (math.ceil(M / bm) * bm / max(M, 1)
                 * math.ceil(N / bn) * bn / max(N, 1))
        if ai / waste > best_score:
            best_score, best = ai / waste, GemmTiles(bm, bn, bk)
    if best is None:
        raise ValueError(f"no GEMM tile fits {smem_budget} bytes of shared "
                         f"memory at {dtype_bytes}-byte elements")
    return best


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

"""LEGO-derived tile selection for the Hopper GEMM and attention kernels.

The objectives are ``repro.kernels.autotile``'s: maximize the arithmetic
intensity of one tile step — ``bm·bn·bk / (bm·bk + bk·bn + bm·bn)`` for the
GEMM, divided by the share of the grid that ragged edge tiles waste, and
``bq·bk·D / (bq·D + bk·D + bq·bk)`` for attention — subject to the working
set fitting on chip.  What changes is the chip: the budget is one thread
block's shared memory on an H100 (227 KB), counted as the CUDA kernels lay
it out, and the candidates are only the tile shapes the kernels are built
for, by element size (``GEMM_TILES``, ``ATTN_TILES``).  Attention in fp32
runs on the CUDA cores (``bq`` rows with four threads per row, ``bk``
columns in steps of 16); in bf16 on the tensor cores (a warpgroup per 64
q rows, ``bk`` keys per ``wgmma``, K and V through a ring of
``ATTN_STAGES`` tiles), where a tile is built only if its layout fits the
shared memory and its accumulators the registers a thread gets.  This
module is where the attention tiles are decided: ``_build`` writes
``attention_tiles_header()`` into the header that ``nvcc`` includes before
``csrc/flash_attention.cu``, which instantiates exactly those tiles.
"""

from __future__ import annotations

import functools
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

HEAD_DIMS = (16, 32, 64, 96, 128, 256)   # head_dims K2 is built for

# K2 decode (flash-decoding): blocks of DECODE_ROWS query rows of one GQA
# group over one chunk of the cache; the chunk is cut so that at least
# DECODE_WAVES blocks per SM are launched, and no shorter than
# DECODE_MIN_BYTES of K and V a block (its start-up and its partial's write
# are then small beside its reads)
H100_SMS = 132
DECODE_ROWS = (1, 2, 4, 8)
DECODE_WAVES = 2
DECODE_MIN_BYTES = 64 * 1024
DECODE_MAX_SPLITS = 1024   # MAX_SPLITS of csrc/flash_attention.cu

# (bq, bk) candidates of csrc/flash_attention.cu, by element size in
# bytes: fp32 prefill on the CUDA cores (4·bq threads, bk/16 score columns
# a thread), bf16 prefill on the tensor cores (bq/64 consumer warpgroups)
ATTN_TILES = {
    4: ((16, 32), (16, 64), (32, 32), (32, 64), (64, 32), (64, 64)),
    2: ((64, 64), (64, 128), (128, 64), (128, 128)),
}
ATTN_STAGES = 2        # K/V ring depth of the tensor-core kernel
ATTN_SPARE_REGS = 8    # registers a thread needs beside its accumulators


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


def attention_smem_bytes(bq: int, bk: int, D: int, dtype_bytes: int) -> int:
    """Shared memory of one prefill block, as ``csrc/flash_attention.cu``
    lays it out.  fp32 (``PrefillSmem``): Q (bq×(D+1)), K (bk×(D+1)), V
    (bk×D) and scores (bq×(bk+1)) tiles plus three bq-long softmax state
    vectors.  bf16 (``TcLayout``): the Q tile and ``ATTN_STAGES`` K and V
    tiles, the full/empty barriers (8 bytes each: one for Q, three a
    stage), and 1024 bytes to align the base to the swizzle's period.  Each
    layout's ``static_assert`` refuses to build a tile that this counts
    below its size or that exceeds the card's limit."""
    if dtype_bytes == 4:
        return 4 * (bq * (D + 1) + bk * (D + 1) + bk * D + bq * (bk + 1)
                    + 3 * bq)
    if dtype_bytes == 2:
        return (2 * (bq * D + 2 * ATTN_STAGES * bk * D)
                + 8 * (1 + 3 * ATTN_STAGES) + 1024)
    raise ValueError(f"no attention kernel built for {dtype_bytes}-byte "
                     f"elements (built: {sorted(ATTN_TILES)})")


def attention_acc_registers(bk: int, D: int) -> int:
    """fp32 registers a consumer thread of the tensor-core kernel holds for
    one warpgroup's 64 rows: the score tile (bk/2), the output (D/2) and P
    as bf16 fragments (bk/4)."""
    return bk // 2 + D // 2 + bk // 4


def attention_register_limit(bq: int) -> int:
    """Registers a thread of the tensor-core kernel gets: its block has
    bq/64 consumer warpgroups and one producer warp, and each of the SM's
    4 schedulers splits its 16,384 registers among its ceil(warps / 4)
    warps, in steps of 8, at most 255 a thread (168 at bq = 128).  ptxas
    agrees (``-Xptxas -v`` on the H100 machine): the bq = 128 instantiations
    use 77 to 164 registers, the bq = 64 ones up to 198 (D = 256), with no
    spills."""
    warps = bq // 64 * 4 + 1
    return min(255, 16384 // (32 * math.ceil(warps / 4)) // 8 * 8)


def attention_built_tiles(D: int, dtype_bytes: int) -> tuple:
    """The (bq, bk) that ``csrc/flash_attention.cu`` instantiates at
    ``head_dim`` D for the element size: ``ATTN_TILES`` whose layout fits
    the card's shared memory and, on the tensor cores, whose accumulators
    and ``ATTN_SPARE_REGS`` fit the registers a thread gets."""
    if dtype_bytes not in ATTN_TILES:
        raise ValueError(f"no attention kernel built for {dtype_bytes}-byte "
                         f"elements (built: {sorted(ATTN_TILES)})")
    return tuple(
        (bq, bk) for bq, bk in ATTN_TILES[dtype_bytes]
        if attention_smem_bytes(bq, bk, D, dtype_bytes) <= SMEM_BYTES
        and (dtype_bytes == 4
             or attention_acc_registers(bk, D) + ATTN_SPARE_REGS
             <= attention_register_limit(bq)))


def attention_tiles(Tq: int, Tk: int, D: int, dtype_bytes: int,
                    smem_budget: int = SMEM_BYTES) -> tuple[int, int]:
    """(bq, bk) for the prefill kernel of the element size: among its built
    tiles, the largest-intensity pair whose working set fits
    ``smem_budget``, with no tile wider than the problem needs (the
    smallest built sides always qualify).  Raises if none fits."""
    built = attention_built_tiles(D, dtype_bytes)
    small_q = min(t[0] for t in ATTN_TILES[dtype_bytes])
    small_k = min(t[1] for t in ATTN_TILES[dtype_bytes])
    best, best_ai = None, -1.0
    for bq, bk in built:
        if bq > max(small_q, Tq) or bk > max(small_k, Tk):
            continue
        if attention_smem_bytes(bq, bk, D, dtype_bytes) > smem_budget:
            continue
        ai = (bq * bk * D) / (bq * D + bk * D + bq * bk)
        if ai > best_ai:
            best_ai, best = ai, (bq, bk)
    if best is None:
        raise ValueError(f"no attention tile fits {smem_budget} bytes "
                         f"of shared memory at head_dim {D} and "
                         f"{dtype_bytes}-byte elements")
    return best


@functools.cache
def decode_rows(group: int) -> int:
    """Query rows of one GQA group that a K2 decode block takes: the
    smallest of ``DECODE_ROWS`` that holds the group, else the largest (a
    group of 16 or 32 takes 2 or 4 blocks, which share the KV rows through
    L2)."""
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    return next((r for r in DECODE_ROWS if r >= group), DECODE_ROWS[-1])


@functools.cache
def decode_splits(B: int, Hkv: int, group: int, S: int, D: int,
                  dtype_bytes: int) -> tuple[int, int]:
    """(chunk length L, split count ceil(S / L)) of K2 decode over a cache
    of S positions, from the static shapes alone (never the position, which
    lives on the device: reading it would make the host wait and break a
    CUDA-graph capture).  L is a power of two, at least the chunk that holds
    ``DECODE_MIN_BYTES`` of K and V; from the whole cache down, it is halved
    while fewer than ``DECODE_WAVES`` x ``H100_SMS`` blocks would run, so
    there are fewer than twice that many splits (the kernel takes up to
    ``DECODE_MAX_SPLITS``).  A cache of at most L positions takes one
    split, which writes the output itself.  Cached: the decode wrapper asks
    on every call."""
    if min(B, Hkv, group, D, dtype_bytes) < 1 or S < 0:
        raise ValueError(f"bad decode shape B={B} Hkv={Hkv} group={group} "
                         f"S={S} D={D} dtype_bytes={dtype_bytes}")
    blocks = -(-group // decode_rows(group)) * Hkv * B
    min_chunk = max(16, _pow2_at_least(DECODE_MIN_BYTES
                                       // (2 * D * dtype_bytes)))
    chunk = max(min_chunk, _pow2_at_least(S))
    while chunk > min_chunk and blocks * -(-S // chunk) < \
            DECODE_WAVES * H100_SMS:
        chunk //= 2
    return chunk, max(1, -(-S // chunk))


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def attention_tiles_header() -> str:
    """The header ``nvcc`` includes before ``csrc/flash_attention.cu``: for
    each dtype an X-macro list of the (D, bq, bk) that
    :func:`attention_built_tiles` gives at each of ``HEAD_DIMS``."""
    def tiles(dtype_bytes):
        return " ".join(f"X({D}, {bq}, {bk})" for D in HEAD_DIMS
                        for bq, bk in attention_built_tiles(D, dtype_bytes))
    return ("// written by repro_torch.kernels.autotile; do not edit\n"
            f"#define LEGO_F32_TILES(X) {tiles(4)}\n"
            f"#define LEGO_BF16_TILES(X) {tiles(2)}\n")

"""LEGO-derived tile selection for the Hopper GEMM and attention kernels.

The objectives are ``repro.kernels.autotile``'s: maximize the arithmetic
intensity of one tile step — ``bm·bn·bk / (bm·bk + bk·bn + bm·bn)`` for the
GEMM, divided by the share of the grid that ragged edge tiles waste, and
``bq·bk·D / (bq·D + bk·D + bq·bk)`` for attention — subject to the working
set fitting on chip.  What changes is the chip: the budget is one thread
block's shared memory on an H100 (227 KB), counted as the CUDA kernels lay
it out, and the candidates are only the tile shapes the kernels are built
for, by element size (``GEMM_TILES``, ``ATTN_TILES``).  A GEMM tile is also
scored by how well it and its split of K (``gemm_splits``) fill the card's
132 SMs, which a TPU's sequential grid never had to.  Attention in fp32
runs on the CUDA cores (``bq`` rows with four threads per row, ``bk``
columns in steps of 16); in bf16 on the tensor cores (a warpgroup per 64
q rows, ``bk`` keys per ``wgmma``, K and V through a ring of
``ATTN_STAGES`` tiles), where a tile is built only if its layout fits the
shared memory and its accumulators the registers a thread gets.  This
module is where the tiles are decided: ``_build`` writes
``attention_tiles_header()`` and ``gemm_tiles_header()`` into the headers
that ``nvcc`` includes before ``csrc/flash_attention.cu`` and
``csrc/gemm.cu``, which instantiate exactly those tiles.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

SMEM_BYTES = 227 * 1024   # dynamic shared memory one block may use (sm_90)

# (bm, bn, bk) instantiated in csrc/gemm.cu, by element size in bytes: fp32
# on the CUDA cores (bm/16 x bn/16 outputs per thread, 256 threads, a
# two-stage cp.async ring); bf16 on the tensor cores, wgmma from a TMA ring
# of gemm_stages() stages (two consumer warpgroups of 64 rows, 128 bytes of
# K a row), or mma.sync at the same tile for operands TMA cannot take
GEMM_TILES = {
    4: ((16, 64, 16), (16, 128, 16), (64, 64, 16), (64, 128, 16),
        (128, 128, 16)),
    2: ((128, 128, 64), (128, 256, 64)),
}
GEMM_STAGES = 2          # the cp.async ring of the CUDA-core kernels
GEMM_MAX_STAGES = 5      # the deepest TMA ring of the wgmma kernel
GEMM_EPI_COLS = 64       # output columns its epilogue stages a pass
# split-K: a split takes at least GEMM_SPLIT_MIN_STEPS k-steps, and its own
# work takes at least as long as writing its fp32 partial and reading it
# back (gemm_max_splits), by the H100's published rates: dense bf16 tensor
# cores, fp32 outside them, HBM3
GEMM_SPLIT_MIN_STEPS = 4
PEAK_FLOPS = {2: 989e12, 4: 67e12}
PEAK_BYTES = 3.35e12

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


class GemmTiles(NamedTuple):
    bm: int
    bn: int
    bk: int


def _gemm_staging_bytes(bm: int, bn: int) -> int:
    """The bf16 epilogue's staging tile: bm rows of min(bn, GEMM_EPI_COLS)
    columns."""
    return 2 * bm * min(bn, GEMM_EPI_COLS)


def gemm_stages(bm: int, bn: int, bk: int, dtype_bytes: int) -> int:
    """Ring depth of the GEMM kernel of the element size at this tile: the
    cp.async double buffer in fp32; in bf16 the TMA ring, as deep as fits
    the card's shared memory beside the epilogue's staging tile, the
    barriers and the swizzle's alignment, at most ``GEMM_MAX_STAGES``."""
    if dtype_bytes == 2:
        stage = 2 * (bm * bk + bk * bn) + 16
        return min(GEMM_MAX_STAGES, (SMEM_BYTES - 1024
                                     - _gemm_staging_bytes(bm, bn)) // stage)
    return GEMM_STAGES


def gemm_smem_bytes(bm: int, bn: int, bk: int, dtype_bytes: int,
                    stages: int | None = None) -> int:
    """Shared memory of one GEMM block, as ``csrc/gemm.cu`` lays it out, at
    ``stages`` (default: ``gemm_stages``).  fp32 (``F32Tile``): copies of
    the X tile (bm rows) and the W tile (bk rows), each row padded by one
    16-byte chunk.  bf16 (``WgLayout``): the X and W tiles of each stage,
    the epilogue's staging tile, a full and an empty barrier a stage (8
    bytes each), and 1024 bytes to align the base to the 128-byte
    swizzle's period."""
    if stages is None:
        stages = gemm_stages(bm, bn, bk, dtype_bytes)
    if dtype_bytes == 2:
        return (stages * (2 * (bm * bk + bk * bn) + 16)
                + _gemm_staging_bytes(bm, bn) + 1024)
    pad = 16 // dtype_bytes
    return stages * dtype_bytes * (bm * (bk + pad) + bk * (bn + pad))


def _tile_count(M: int, N: int, bm: int, bn: int) -> int:
    return -(-M // bm) * -(-N // bn)


def _split_costs(M: int, N: int, tile, dtype_bytes: int) -> tuple:
    """(seconds per row of K, seconds of the partial) of one work unit at
    this tile, by the card's published rates: a row of K costs the unit's
    products (2·m·n flops at the dtype's peak) or its share of the
    operands' bytes at the HBM rate (each of X's rows and W's panel read
    once over the tiles that share them), whichever is longer; the partial
    is m·n fp32 values written and read back.  m, n: the tile's rows below
    M and columns below N."""
    bm, bn, _ = tile
    m, n = min(bm, M), min(bn, N)
    tm, tn = -(-M // bm), -(-N // bn)
    per_k = max(2 * m * n / PEAK_FLOPS[dtype_bytes],
                (n / tm + m / tn) * dtype_bytes / PEAK_BYTES)
    return per_k, 8 * m * n / PEAK_BYTES


def gemm_max_splits(M: int, N: int, K: int, tile, dtype_bytes: int) -> int:
    """The most ranges K may be split into at the tile (bm, bn, bk): each
    takes at least ``GEMM_SPLIT_MIN_STEPS`` k-steps (its start-up, the ring
    filling, stays small beside its loop), and its own work takes at least
    as long as its partial (``_split_costs``); never more than the
    k-steps."""
    bk = tile[2]
    per_k, partial = _split_costs(M, N, tile, dtype_bytes)
    k_floor = max(GEMM_SPLIT_MIN_STEPS * bk, math.ceil(partial / per_k))
    return max(1, min(-(-K // bk), K // k_floor))


def gemm_fill(units: int) -> float:
    """The share of the SM slots that ``units`` equal blocks keep busy over
    the waves they take on ``H100_SMS`` SMs: 1 when they fill every wave."""
    return units / (H100_SMS * -(-units // H100_SMS))


@functools.cache
def gemm_splits(M: int, N: int, K: int, tile, dtype_bytes: int) -> int:
    """How many ranges the K sweep is split into at this tile, from the
    shapes alone.  One when the output tiles already fill the SMs.  Else,
    among the counts that make tiles x splits at least ``H100_SMS`` and no
    more than ``gemm_max_splits``, the one of least modelled time

        ceil(tiles x splits / H100_SMS) x (K / splits x per_k + partial),

    the waves times one unit's work and partial (``_split_costs``; the
    fewest splits on a tie).  Where the floor stops short of the SMs, as
    many as it allows.  tile: (bm, bn, bk)."""
    if min(M, N) < 1 or K < 1:
        return 1
    tiles = _tile_count(M, N, tile[0], tile[1])
    if tiles >= H100_SMS:
        return 1
    most = gemm_max_splits(M, N, K, tile, dtype_bytes)
    least = -(-H100_SMS // tiles)
    if most < least:
        return most
    per_k, partial = _split_costs(M, N, tile, dtype_bytes)
    return min(range(least, most + 1),
               key=lambda s: (-(-tiles * s // H100_SMS)
                              * (K / s * per_k + partial), s))


@functools.cache
def gemm_tiles(M: int, N: int, K: int, dtype_bytes: int = 2,
               smem_budget: int = SMEM_BYTES) -> GemmTiles:
    """(bm, bn, bk) for the GEMM kernel of the element size.  The
    candidates are its built tiles whose ring fits ``smem_budget`` and
    whose sides are no wider than the problem needs (the tile of the
    smallest built sides always qualifies).  Among those whose tiles x
    ``gemm_splits`` fill the ``H100_SMS`` SMs (all of them if none does),
    the one with the highest

        intensity / ragged waste x fill,

    LEGO's objective — ``bm·bn·bk / (bm·bk + bk·bn + bm·bn)`` over the share
    of the grid's area that lies inside the product — times the share of
    the SM slots that the tiles and splits keep busy over their waves
    (``gemm_fill``).  Raises if none fits.  Cached: ``ops.gemm`` asks on
    every call."""
    if dtype_bytes not in GEMM_TILES:
        raise ValueError(f"no GEMM tiles built for {dtype_bytes}-byte "
                         f"elements (built: {sorted(GEMM_TILES)})")
    tiles = GEMM_TILES[dtype_bytes]
    small = [min(t[i] for t in tiles) for i in range(3)]
    scored = []
    for bm, bn, bk in tiles:
        if bm > max(small[0], M) or bn > max(small[1], N) \
                or bk > max(small[2], K):
            continue
        if gemm_smem_bytes(bm, bn, bk, dtype_bytes) > smem_budget:
            continue
        ai = (bm * bn * bk) / (bm * bk + bk * bn + bm * bn)
        waste = (math.ceil(M / bm) * bm / max(M, 1)
                 * math.ceil(N / bn) * bn / max(N, 1))
        units = _tile_count(M, N, bm, bn) * gemm_splits(
            M, N, K, (bm, bn, bk), dtype_bytes)
        scored.append((units >= H100_SMS, ai / waste * gemm_fill(units),
                       GemmTiles(bm, bn, bk)))
    if not scored:
        raise ValueError(f"no GEMM tile fits {smem_budget} bytes of shared "
                         f"memory at {dtype_bytes}-byte elements")
    fills = any(f for f, _, _ in scored)
    return max((s for s in scored if s[0] == fills),
               key=lambda s: s[1])[2]


def gemm_tiles_header() -> str:
    """The header ``nvcc`` includes before ``csrc/gemm.cu``: X-macro lists
    of the fp32 tiles, X(bm, bn, bk), and of the bf16 tiles with their ring
    depth, X(bm, bn, bk, stages), and the columns the bf16 epilogue stages a
    pass (``GEMM_EPI_COLS``, which ``gemm_smem_bytes`` counts)."""
    f32 = " ".join(f"X({bm}, {bn}, {bk})" for bm, bn, bk in GEMM_TILES[4])
    bf16 = " ".join(f"X({bm}, {bn}, {bk}, {gemm_stages(bm, bn, bk, 2)})"
                    for bm, bn, bk in GEMM_TILES[2])
    return ("// written by repro_torch.kernels.autotile; do not edit\n"
            f"#define LEGO_GEMM_F32_TILES(X) {f32}\n"
            f"#define LEGO_GEMM_BF16_TILES(X) {bf16}\n"
            f"#define LEGO_GEMM_EPI_COLS {GEMM_EPI_COLS}\n")


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

"""Kernel K1 on Hopper: the wrapper of ``csrc/gemm.cu``.

Replaces ``repro.kernels.gemm`` (the Pallas ``_gemm_kernel``,
``src/repro/kernels/gemm.py:26``), LEGO's GEMM-JK output-stationary tile:
``O = X·W`` with an fp32 accumulator that stays on chip for the whole K
sweep (or, split across blocks, for each K range) and is rounded to X's
dtype once.  bf16 operands that TMA can take (K and N multiples of 8,
16-byte-aligned bases) run on ``wgmma`` in a persistent, warp-specialised
kernel fed by a TMA ring; other bf16 operands on ``mma.sync`` at the same
tile; fp32 on the CUDA cores in true fp32 (no TF32).  Any M, N and K
(masked; no padding).  When the output tiles are fewer than the SMs, the K
sweep is split into ``autotile.gemm_splits`` ranges whose fp32 partials go
to a workspace from the caching allocator and are summed, in a fixed order,
by a combine kernel on the same stream: deterministic, and capturable in a
CUDA graph.

Bound: operations for large products (at (2048 × 5120)·(5120 × 14336) in
bf16, 300.6 GFLOP in 0.304 ms at 989 TFLOP/s against 226 MB in 0.068 ms at
3.35 TB/s), bytes for decode-shaped ones (M ≤ 16).

``gemm_cuda`` checks its inputs and raises on anything the kernel does not
take, launches on the current stream, raises if the launch was refused,
and counts its launches in ``gemm_cuda.launches`` and, of those, the ones
that the library reports on the ``wgmma`` kernel in
``gemm_cuda.wgmma_launches``.  The plain version is
:func:`repro_torch.kernels.ref.gemm_ref`; :mod:`repro_torch.kernels.ops`
picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .autotile import GEMM_TILES, gemm_splits

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_KERNEL = 2   # what lego_gemm reports for gemm_bf16_wgmma_kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    # x, w, o, workspace, dtype, M, N, K, bm, bn, bk, splits, stream,
    # &kernel launched (0: fp32, 1: bf16 mma.sync, 2: bf16 wgmma)
    "lego_gemm": (_I, [_P] * 4 + [_I] * 8 + [_P, ctypes.POINTER(_I)]),
    "lego_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _lib() -> ctypes.CDLL:
    return _build.load("gemm", _PROTOTYPES)


def _check(x: torch.Tensor, w: torch.Tensor, tile) -> None:
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA gemm kernel takes CUDA tensors, got "
                             f"{name} on {t.device}")
        if t.ndim != 2:
            raise ValueError(f"gemm operand {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gemm operand {name} must be contiguous")
    if w.device != x.device:
        raise ValueError("both gemm operands must be on one device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    if w.dtype != x.dtype:
        raise ValueError(f"mixed dtypes {x.dtype} and {w.dtype}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"inner dimensions differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    built = GEMM_TILES[x.element_size()]
    if tile not in built:
        raise ValueError(f"tile {tile} not built for {x.dtype} (built: "
                         f"{built})")
    if -(-w.shape[1] // tile[1]) > 65535:   # the grid's y extent
        raise ValueError(f"N = {w.shape[1]} is too wide for tile {tile}")


def gemm_cuda(x: torch.Tensor, w: torch.Tensor, *, bm: int, bn: int,
              bk: int, splits: int | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) on the card, both fp32 or both bf16; tiles
    (bm, bn, bk) from :func:`repro_torch.kernels.autotile.gemm_tiles`, the
    K sweep split into ``splits`` ranges (default:
    :func:`repro_torch.kernels.autotile.gemm_splits` of the shapes).
    Returns (M, N) in x's dtype."""
    _build.refuse_autograd("gemm", x, w)
    _check(x, w, (bm, bn, bk))
    (M, K), N = x.shape, w.shape[1]
    if splits is None:
        splits = gemm_splits(M, N, K, (bm, bn, bk), x.element_size())
    steps = -(-K // bk)
    if not 1 <= splits <= max(1, min(steps, 65535)):
        raise ValueError(f"splits = {splits} outside [1, {steps}] (the "
                         f"k-steps of tile {(bm, bn, bk)})")
    if K == 0:
        return torch.zeros((M, N), dtype=x.dtype, device=x.device)
    o = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o
    ws = (torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    kernel = _I()
    args = (x.data_ptr(), w.data_ptr(), o.data_ptr(),
            None if ws is None else ws.data_ptr(), _DTYPES[x.dtype], M, N, K,
            bm, bn, bk, splits)
    with torch.cuda.device(x.device):
        # the current stream's raw handle, as PyTorch's generated code takes
        # it: torch.cuda.current_stream() builds a Stream object a call, and
        # small products are paced by the host's cost a call
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        err = _lib().lego_gemm(*args, stream, ctypes.byref(kernel))
    if err:
        msg = _lib().lego_cuda_error_string(err).decode()
        raise RuntimeError(f"gemm kernel launch failed: {msg} ({err})")
    gemm_cuda.launches += 1
    gemm_cuda.wgmma_launches += int(kernel.value == WGMMA_KERNEL)
    return o


gemm_cuda.launches = 0
gemm_cuda.wgmma_launches = 0

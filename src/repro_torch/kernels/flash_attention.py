"""Kernel K2 on Hopper: the wrappers of ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention`` (the Pallas ``_flash_kernel``,
score-stationary fused attention of LEGO Fig. 10) with hand-written CUDA
kernels:

  * ``flash_attention_cuda`` — prefill: q (B, Hq, Tq, D) against k/v
    (B, Hkv, Tk, D), causal with an absolute ``offset``, sliding window,
    softcap, GQA; ragged Tq/Tk are masked inside the kernel.  One kernel
    per dtype: bf16 on the tensor cores (``wgmma`` fed by TMA), fp32 on
    the CUDA cores (``wgmma`` would take fp32 only as TF32); the tile
    (bq, bk) must be one that the dtype's kernel builds
    (``autotile.attention_built_tiles``).
  * ``decode_attention_cuda`` — one query token per head over a KV cache,
    at a position read from a 0-d int32 device tensor (no host sync):
    split-KV (flash-decoding), the cache cut into chunks by
    ``autotile.decode_splits`` from the shapes alone, each chunk's partial
    softmax written to an fp32 workspace and merged by a combine kernel on
    the same stream.

Each wrapper checks its inputs and raises on anything the kernel does not
take, launches on the current stream, raises if the launch was refused,
and counts its launches in ``<wrapper>.launches`` (one a call); the prefill
also counts, in ``.tensor_core_launches``, those that the library reports
to have gone to the tensor-core kernel, the decode, in ``.split_launches``,
the calls that ran more than one split (and so the combine kernel).  The plain versions live
in :mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks
between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .autotile import (HEAD_DIMS, attention_built_tiles, decode_rows,
                       decode_splits)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROTOTYPES = {
    # q, k, v, o, dtype, B, Hq, Hkv, Tq, Tk, D, bq, bk, causal, window,
    # softcap, scale, offset, stream, &kernel launched (1: tensor cores)
    "lego_flash_prefill": (_I, [_P, _P, _P, _P] + [_I] * 11
                           + [_F, _F, _I, _P, ctypes.POINTER(_I)]),
    # q, k, v, o, pos, workspace, dtype, B, Hq, Hkv, S, D, rows, chunk,
    # splits, window, softcap, scale, stream
    "lego_flash_decode": (_I, [_P] * 6 + [_I] * 10 + [_F, _F, _P]),
    "lego_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _PROTOTYPES)


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _lib().lego_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _check(q: torch.Tensor, *others: torch.Tensor) -> None:
    for t in (q, *others):
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA attention kernels take CUDA tensors, "
                             f"got one on {t.device}")
        if t.device != q.device:
            raise ValueError("all attention operands must be on one device")
        if t.dtype != q.dtype:
            raise ValueError(f"mixed dtypes {q.dtype} and {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"expected a (B, H, T, D) tensor, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("attention operands must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, Hq, _, D = q.shape
    for t in others:
        if t.shape[0] != B or t.shape[3] != D:
            raise ValueError(f"shape {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built (built: {HEAD_DIMS})")
    k, v = others[0], others[1]
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")


def _window_softcap(window, softcap) -> tuple[int, float]:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return (window or 0), (softcap or 0.0)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, bq: int, bk: int, causal: bool = True,
                         window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None,
                         offset: int = 0) -> torch.Tensor:
    """Prefill attention on the card; tiles (bq, bk) from
    :func:`repro_torch.kernels.autotile.attention_tiles`.  Counts its
    launches in ``.launches`` and, of those, the ones the library reports
    on the tensor-core kernel in ``.tensor_core_launches``."""
    _build.refuse_autograd("flash attention", q, k, v)
    _check(q, k, v)
    B, Hq, Tq, D = q.shape
    built = attention_built_tiles(D, q.element_size())
    if (bq, bk) not in built:
        raise ValueError(f"tile ({bq}, {bk}) not built for {q.dtype} at "
                         f"head_dim {D} (built: {built})")
    _, Hkv, Tk, _ = k.shape
    win, cap = _window_softcap(window, softcap)
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    kernel = _I()
    with torch.cuda.device(q.device):
        err = _lib().lego_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, Tq, Tk, D, bq, bk, int(causal), win,
            cap, scale, offset, _stream(q), ctypes.byref(kernel))
    _raise_on(err, "flash prefill")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.tensor_core_launches += int(kernel.value == 1)
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.tensor_core_launches = 0


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, *, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """One-token decode on the card: q (B, Hq, 1, D) over the cache
    (B, Hkv, S, D) at position ``pos`` (0-d int32 tensor on q's device,
    0 <= pos < S).  The splits come from the shapes alone, the workspace
    from the caching allocator: nothing makes the host wait, so the call
    can be captured in a CUDA graph.  Counts its calls in ``.launches`` and,
    of those, the ones over more than one split in ``.split_launches``."""
    _build.refuse_autograd("flash decode", q, k, v)
    _check(q, k, v)
    B, Hq, Tq, D = q.shape
    _, Hkv, S, _ = k.shape
    if Tq != 1:
        raise ValueError(f"decode takes one query token, got Tq={Tq}")
    if (pos.device != q.device or pos.dtype != torch.int32
            or pos.numel() != 1):
        raise ValueError("pos must be a one-element int32 tensor on "
                         f"{q.device}, got {pos.dtype} {tuple(pos.shape)} "
                         f"on {pos.device}")
    win, cap = _window_softcap(window, softcap)
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    group = Hq // Hkv
    chunk, splits = decode_splits(B, Hkv, group, S, D, q.element_size())
    ws = (torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        err = _lib().lego_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            pos.data_ptr(), None if ws is None else ws.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, S, D, decode_rows(group), chunk,
            splits, win, cap, scale, _stream(q))
    _raise_on(err, "flash decode")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.split_launches += int(splits > 1)
    return o


decode_attention_cuda.launches = 0
decode_attention_cuda.split_launches = 0

"""Kernel K4 on Hopper: the wrapper of ``csrc/rwkv6.cu``.

Replaces ``repro.kernels.rwkv6`` (the Pallas ``_rwkv_kernel``,
``src/repro/kernels/rwkv6.py:25``), the RWKV-6 wkv recurrence with a
(Dk, Dv) fp32 state per (batch, head):

    o_t = r_t · (S + diag(u)·k_t v_tᵀ),    S = diag(w_t)·S + k_t v_tᵀ

One kernel per dtype, no knob.  bf16 runs the chunked matrix form on the
tensor cores: T in chunks of 64 steps, the chunks cut into segments, a
block of 16 warps per (segment, head, batch) that carries the state over
the chunks before its segment (the state's update alone) and then marches
over its own (at T = 2048 and B·H = 64, two segments: 20 chunk steps, and
12 after 20 cheap ones, instead of 2,048 token steps).  Inside a chunk the
decays are products of w over explicit ranges (never a ratio, never a
logarithm, so w = 0 is exact), the scores between 16-step sub-chunks are a
product factored at the later sub-chunk's start, those inside a sub-chunk
fp32 sums, and A·V, R·S and the state's update are ``mma.sync`` products
of split bf16 operands (hi + lo), so the carried state stays fp32-exact
and o is rounded once (:func:`repro_torch.kernels.ref.rwkv6_chunked_ref`
is the same algorithm in PyTorch).  Bound: bytes (r, k, w, v read and o
written once, S_last in fp32; 0.025 ms at B·H = 64, T = 2048, Dk = Dv =
64).  fp32 keeps the recurrence on the CUDA cores (TF32 would miss the
1e-4 gate): the T loop inside one block with S in registers, split by
column over blocks of 16 columns and each column over 4 lanes, bound by
operations (4·Dk·Dv flops per head and step).  Any T; Dk = Dv ∈ {16, 64}
are built; the chunk and the segments come from
:func:`repro_torch.kernels.autotile.rwkv6_tiles`.  The state starts at
zero (no ``s0``, as in the Pallas kernel).

``rwkv6_cuda`` checks its inputs and raises on anything the kernel does not
take, launches on the current stream, raises if the launch was refused,
counts its launches in ``rwkv6_cuda.launches`` and, of those, the ones the
library reports on the tensor-core kernel in
``rwkv6_cuda.tensor_core_launches``.  The plain version is
:func:`repro_torch.kernels.ref.rwkv6_ref`; :mod:`repro_torch.kernels.ops`
picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .autotile import RWKV_HEAD_DIMS as HEAD_DIMS
from .autotile import rwkv6_tiles

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    # r, k, v, w, u, o, s_last, dtype, B, H, T, Dk, Dv, segments, stream,
    # &kernel launched (0: CUDA cores, 1: tensor cores)
    "lego_rwkv6": (_I, [_P] * 7 + [_I] * 7 + [_P, ctypes.POINTER(_I)]),
    "lego_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _lib() -> ctypes.CDLL:
    return _build.load("rwkv6", _PROTOTYPES)


def _check(r, k, v, w, u) -> None:
    named = dict(r=r, k=k, v=v, w=w, u=u)
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA rwkv6 kernel takes CUDA tensors, got "
                             f"{name} on {t.device}")
        if t.device != r.device:
            raise ValueError("all rwkv6 operands must be on one device")
        if t.dtype != r.dtype:
            raise ValueError(f"mixed dtypes {r.dtype} and {t.dtype} ({name})")
        if not t.is_contiguous():
            raise ValueError(f"rwkv6 operand {name} must be contiguous")
    if r.dtype not in _DTYPES:
        raise ValueError(f"dtype {r.dtype} not supported (float32, bfloat16)")
    if r.ndim != 4:
        raise ValueError(f"expected r of shape (B, H, T, Dk), got "
                         f"{tuple(r.shape)}")
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    for name, t, want in (("k", k, r.shape), ("w", w, r.shape),
                          ("v", v, (B, H, T, Dv)), ("u", u, (H, Dk))):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    if (Dk, Dv) not in HEAD_DIMS:
        raise ValueError(f"head size (Dk, Dv) = ({Dk}, {Dv}) not built "
                         f"(built: {HEAD_DIMS})")
    for name in ("r", "k", "v", "w"):
        if named[name].data_ptr() % 16:
            raise ValueError(f"rwkv6 operand {name} must be 16-byte aligned")


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk) on the card, all
    fp32 or all bf16.  Returns (o (B, H, T, Dv) in r.dtype, S_last
    (B, H, Dk, Dv) fp32).  Counts the call in ``.launches`` and, where the
    library reports the tensor-core kernel, in ``.tensor_core_launches``."""
    _build.refuse_autograd("rwkv6", r, k, v, w, u)
    _check(r, k, v, w, u)
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    o = torch.empty_like(v)
    s_last = torch.empty((B, H, Dk, Dv), dtype=torch.float32,
                         device=r.device)
    if B * H * T == 0:
        return o, s_last.zero_()
    kernel = ctypes.c_int(-1)
    with torch.cuda.device(r.device):
        err = _lib().lego_rwkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s_last.data_ptr(), _DTYPES[r.dtype],
            B, H, T, Dk, Dv, rwkv6_tiles(B, H, T, Dk, Dv).segments,
            torch.cuda.current_stream(r.device).cuda_stream,
            ctypes.byref(kernel))
    if err:
        msg = _lib().lego_cuda_error_string(err).decode()
        raise RuntimeError(f"rwkv6 kernel launch failed: {msg} ({err})")
    rwkv6_cuda.launches += 1
    rwkv6_cuda.tensor_core_launches += int(kernel.value == 1)
    return o, s_last


rwkv6_cuda.launches = 0
rwkv6_cuda.tensor_core_launches = 0

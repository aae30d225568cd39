"""Kernel K4 on Hopper: the wrapper of ``csrc/rwkv6.cu``.

Replaces ``repro.kernels.rwkv6`` (the Pallas ``_rwkv_kernel``,
``src/repro/kernels/rwkv6.py:25``), the RWKV-6 wkv recurrence with a
(Dk, Dv) fp32 state per (batch, head):

    o_t = r_t · (S + diag(u)·k_t v_tᵀ),    S = diag(w_t)·S + k_t v_tᵀ

Bound: operations at the fp32 rate (4·Dk·Dv flops per head and token; at
B·H = 64, T = 2048, Dk = Dv = 64 in bf16, 0.032 ms at 67 TFLOP/s against
0.025 ms of bytes).  Design: the TPU grid carried S across T-chunks in
VMEM, which a GPU grid cannot, so the whole T loop runs inside one block
with S in registers; the state is split by column over blocks of 16
columns (columns are independent) and each column over 4 lanes joined by a
warp-shuffle sum, with chunks of r/k/w/v staged in shared memory by
double-buffered ``cp.async`` copies.  Any T; Dk = Dv ∈ {16, 64} are built.
The state starts at zero (no ``s0``, as in the Pallas kernel).

``rwkv6_cuda`` checks its inputs and raises on anything the kernel does not
take, launches on the current stream, raises if the launch was refused,
and counts its launches in ``rwkv6_cuda.launches``.  The plain version is
:func:`repro_torch.kernels.ref.rwkv6_ref`; :mod:`repro_torch.kernels.ops`
picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = ((16, 16), (64, 64))   # built (Dk, Dv)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    # r, k, v, w, u, o, s_last, dtype, B, H, T, Dk, Dv, stream
    "lego_rwkv6": (_I, [_P] * 7 + [_I] * 6 + [_P]),
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
    (B, H, Dk, Dv) fp32)."""
    _check(r, k, v, w, u)
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    o = torch.empty_like(v)
    s_last = torch.empty((B, H, Dk, Dv), dtype=torch.float32,
                         device=r.device)
    if B * H * T == 0:
        return o, s_last.zero_()
    with torch.cuda.device(r.device):
        err = _lib().lego_rwkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s_last.data_ptr(), _DTYPES[r.dtype],
            B, H, T, Dk, Dv, torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        msg = _lib().lego_cuda_error_string(err).decode()
        raise RuntimeError(f"rwkv6 kernel launch failed: {msg} ({err})")
    rwkv6_cuda.launches += 1
    return o, s_last


rwkv6_cuda.launches = 0

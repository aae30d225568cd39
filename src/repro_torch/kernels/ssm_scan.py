"""Kernel K3 on Hopper: the wrapper of ``csrc/ssm_scan.cu``.

Replaces ``repro.kernels.ssm_scan`` (the Pallas ``_scan_kernel``,
``src/repro/kernels/ssm_scan.py:28``), the Mamba S6 selective scan with an
fp32 state h (Dm, N) per batch row:

    h_l = exp(dt_l·A)·h_{l-1} + (dt_l·x_l)·B_l,    y_l = h_l·C_l + x_l·D

Bound: its 537 M exps at Bt = 1, L = 2048, Dm = 16384, N = 16 run on the
special-function units, 16 per SM per clock (~0.13 ms on 132 SMs), above
both of the card's peak-rate bounds (203.5 MB in 0.061 ms at 3.35 TB/s;
3.2 GFLOP in 0.048 ms at 67 TFLOP/s).  Design: one pass over L (the TPU
grid carried h across L-chunks in VMEM; here the whole L loop runs inside
one block with h in registers), built so that a step costs issue slots
and not latency: one ``ex2.approx.ftz`` per exp (log2(e) folded into A); a
consumer thread owns S states of one channel, so that the step's loads and
its y are shared by S states, and the N / S lanes of a channel sum their
partial y when the chunk is written out (no shuffle in the step); the
steps are software-pipelined (loads two steps ahead, decays one step
ahead), whole chunks unrolled with constant shared-memory offsets; two
producer warps copy chunks of x, dt, B and C into a ring of shared memory
with cp.async and write y back, so the consumers never wait on device
memory.  One S is built for each N
(:data:`repro_torch.kernels.autotile.SSM_TILES`: 8 at N = 16).  Any L and
Dm (masked); N ∈ {4, 8, 16} are built.  The state starts at zero (no
``h0``, as in the Pallas kernel).

``ssm_scan_cuda`` checks its inputs and raises on anything the kernel does
not take, launches on the current stream, raises if the launch was refused,
and counts its launches in ``ssm_scan_cuda.launches``.  The plain version is
:func:`repro_torch.kernels.ref.selective_scan_ref`;
:mod:`repro_torch.kernels.ops` picks between them by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .autotile import SSM_STATE_DIMS as STATE_DIMS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_PROTOTYPES = {
    # x, dt, A, B, C, D, y, h_last, dtype, Bt, L, Dm, N, stream
    "lego_ssm_scan": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "lego_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _lib() -> ctypes.CDLL:
    return _build.load("ssm_scan", _PROTOTYPES)


def _check(x, dt, A, B, C, D) -> None:
    named = dict(x=x, dt=dt, A=A, B=B, C=C, D=D)
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA ssm_scan kernel takes CUDA tensors, "
                             f"got {name} on {t.device}")
        if t.device != x.device:
            raise ValueError("all ssm_scan operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan operand {name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    for name in ("dt", "B", "C"):
        if named[name].dtype != x.dtype:
            raise ValueError(f"mixed dtypes {x.dtype} and "
                             f"{named[name].dtype} ({name})")
    for name in ("A", "D"):
        if named[name].dtype != torch.float32:
            raise ValueError(f"ssm_scan operand {name} must be float32, got "
                             f"{named[name].dtype}")
    if x.ndim != 3 or A.ndim != 2:
        raise ValueError(f"expected x (Bt, L, Dm) and A (Dm, N), got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    Bt, L, Dm = x.shape
    N = A.shape[1]
    for name, t, want in (("dt", dt, x.shape), ("A", A, (Dm, N)),
                          ("B", B, (Bt, L, N)), ("C", C, (Bt, L, N)),
                          ("D", D, (Dm,))):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
    if N not in STATE_DIMS:
        raise ValueError(f"state size N = {N} not built (built: "
                         f"{STATE_DIMS})")


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x/dt (Bt, L, Dm) and B/C (Bt, L, N) on the card, all fp32 or all
    bf16; A (Dm, N) and D (Dm,) fp32.  Returns (y (Bt, L, Dm) in x.dtype,
    h_last (Bt, Dm, N) fp32)."""
    _build.refuse_autograd("ssm_scan", x, dt, A, B, C, D)
    _check(x, dt, A, B, C, D)
    Bt, L, Dm = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_last = torch.empty((Bt, Dm, N), dtype=torch.float32, device=x.device)
    if Bt * L * Dm == 0:
        return y, h_last.zero_()
    with torch.cuda.device(x.device):
        err = _lib().lego_ssm_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            _DTYPES[x.dtype], Bt, L, Dm, N,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = _lib().lego_cuda_error_string(err).decode()
        raise RuntimeError(f"ssm_scan kernel launch failed: {msg} ({err})")
    ssm_scan_cuda.launches += 1
    return y, h_last


ssm_scan_cuda.launches = 0

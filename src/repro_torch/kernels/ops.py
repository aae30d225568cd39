"""Public kernel API of the port (``repro.kernels.ops``'s counterpart):
the GEMM, attention, the Mamba selective scan and the RWKV-6 recurrence.

The device of the tensors picks the path: a CPU tensor takes the plain
version of :mod:`repro_torch.kernels.ref`; any other tensor goes to the CUDA
kernel, whose wrapper launches it or raises.  Nothing falls back.  No
kernel has a backward pass, so a CUDA wrapper also raises when autograd
would record its call (``_build.refuse_autograd``): training runs the
plain path (``backend="ref"``), as the reference's does.  The
kernels mask ragged shapes themselves, so unlike the reference's Pallas
path these wrappers pad nothing and assert no multiple of a tile (``gemm``
takes any M, N and K with ``gemm_tiles``' tiles and ``gemm_splits``' split
of K as they are, where the reference pads X and W to its tiles and slices
the product back; the
ragged non-causal attention case is masked, where the reference's padding
leaked weight onto zero keys; ``rwkv6`` takes any T, where the reference
asserts ``T % 64 == 0`` above 64; ``ssm_scan`` takes any L and Dm, where
the reference asserts multiples of its 128-wide blocks).

A wrapper given DTensors (the model under a ``DeviceMesh``) runs on each
device's shards (:func:`repro_torch.parallel.sharding.local_call`): the
kernel, or on the CPU the plain version, takes the local tensors where the
op is independent along every sharded dim — batch and heads for
attention, batch and channels for the scan and the recurrence, rows and
columns for the GEMM — and any other sharded dim is gathered first.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from ..parallel.sharding import local_call
from . import ref as R
from .autotile import attention_tiles, gemm_tiles
from .flash_attention import decode_attention_cuda, flash_attention_cuda
from .gemm import gemm_cuda
from .rwkv6 import rwkv6_cuda
from .ssm_scan import ssm_scan_cuda

__all__ = ["gemm", "flash_attention", "decode_attention", "ssm_scan",
           "rwkv6", "launch_counts", "add_launch_counts"]

# every launch counter of the wrappers, (wrapper, attribute): a CUDA graph
# replays launches without calling a wrapper, so the captured serve step
# (serve.engine) adds what its capture counted on each replay
COUNTERS = ((flash_attention_cuda, "launches"),
            (flash_attention_cuda, "tensor_core_launches"),
            (decode_attention_cuda, "launches"),
            (decode_attention_cuda, "split_launches"),
            (gemm_cuda, "launches"), (gemm_cuda, "wgmma_launches"),
            (rwkv6_cuda, "launches"), (rwkv6_cuda, "tensor_core_launches"),
            (ssm_scan_cuda, "launches"))


def launch_counts() -> tuple[int, ...]:
    """The counters of :data:`COUNTERS`, in order."""
    return tuple(getattr(fn, name) for fn, name in COUNTERS)


def add_launch_counts(counts) -> None:
    """Adds ``counts`` (one int per counter of :data:`COUNTERS`, negative to
    take back what a capture counted) to the counters."""
    if len(counts) != len(COUNTERS):
        raise ValueError(f"{len(counts)} counts for {len(COUNTERS)} "
                         "counters")
    for (fn, name), n in zip(COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + n)


def gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) → (M, N) in x's dtype, accumulated in fp32.  On
    the card the K sweep is split across blocks (``gemm_splits``, from the
    shapes alone) when the output tiles alone would not fill the SMs; the
    workspace comes from the caching allocator, so the call can be
    captured in a CUDA graph."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return local_call(gemm, (x, w), (("b", None), (None, "c")),
                          (("b", "c"),))
    if x.device.type == "cpu":
        return R.gemm_ref(x, w)
    t = gemm_tiles(x.shape[0], w.shape[-1], x.shape[-1], x.element_size())
    return gemm_cuda(x, w, bm=t.bm, bn=t.bn, bk=t.bk)


_BHTD = ("b", "c", None, None)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None, offset: int = 0) -> torch.Tensor:
    if isinstance(q, DTensor):
        fn = functools.partial(flash_attention, causal=causal, window=window,
                               softcap=softcap, scale=scale, offset=offset)
        return local_call(fn, (q, k, v), (_BHTD,) * 3, (_BHTD,))
    if q.device.type == "cpu":
        return R.attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, offset=offset)
    bq, bk = attention_tiles(q.shape[2], k.shape[2], q.shape[3],
                             q.element_size())
    return flash_attention_cuda(q, k, v, bq=bq, bk=bk, causal=causal,
                                window=window, softcap=softcap, scale=scale,
                                offset=offset)


def decode_attention(q, k, v, *, window=None, softcap=None, scale=None,
                     pos=None) -> torch.Tensor:
    """Single-token decode over a KV cache: q (B, Hq, 1, D), kv (B, Hkv, S, D).
    ``pos`` = the query's absolute position, an int or a 0-d int32 tensor on
    q's device (a tensor keeps the host from waiting on the device);
    cache entries beyond it are masked (defaults to S − 1, full cache).  On
    the card the kernel splits the cache across blocks (flash-decoding, the
    splits from ``autotile.decode_splits``, never from ``pos``) and merges
    the partial softmaxes in a combine pass, so with a tensor ``pos`` the
    call can be captured in a CUDA graph."""
    if isinstance(q, DTensor):
        fn = functools.partial(decode_attention, window=window,
                               softcap=softcap, scale=scale, pos=pos)
        return local_call(fn, (q, k, v), (_BHTD,) * 3, (_BHTD,))
    if q.device.type == "cpu":
        return R.decode_attention_ref(q, k, v, window=window,
                                      softcap=softcap, scale=scale, pos=pos)
    if pos is None:
        pos = k.shape[2] - 1
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=q.device)
    return decode_attention_cuda(q, k, v, pos, window=window,
                                 softcap=softcap, scale=scale)


# the dims each argument's shards may split (see local_call): "b" batch,
# "c" channels or heads
SCAN_ROLES = (("b", None, "c"), ("b", None, "c"), ("c", None),
              ("b", None, None), ("b", None, None), ("c",))
SCAN_OUT_ROLES = (("b", None, "c"), ("b", "c", None))
WKV_ROLES = (_BHTD,) * 4 + (("c", None),)
WKV_OUT_ROLES = (_BHTD, _BHTD)


def ssm_scan(x, dt, A, B, C, D) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba S6 scan: x/dt (Bt, L, Dm), A (Dm, N), B/C (Bt, L, N), D (Dm,)
    → (y (Bt, L, Dm) in x.dtype, h_last (Bt, Dm, N) fp32)."""
    if isinstance(x, DTensor):
        return local_call(ssm_scan, (x, dt, A, B, C, D), SCAN_ROLES,
                          SCAN_OUT_ROLES)
    if x.device.type == "cpu":
        return R.selective_scan_ref(x, dt, A, B, C, D)
    return ssm_scan_cuda(x, dt, A, B, C, D)


def rwkv6(r, k, v, w, u) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 wkv: r/k/w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk) →
    (o (B, H, T, Dv) in r.dtype, S_last (B, H, Dk, Dv) fp32)."""
    if isinstance(r, DTensor):
        return local_call(rwkv6, (r, k, v, w, u), WKV_ROLES, WKV_OUT_ROLES)
    if r.device.type == "cpu":
        return R.rwkv6_ref(r, k, v, w, u)
    return rwkv6_cuda(r, k, v, w, u)

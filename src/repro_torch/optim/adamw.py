"""AdamW with global-norm clipping and a cosine schedule, the port's
counterpart of ``repro.optim.adamw``.

The moments mirror the parameter tree (fp32, or bf16 in the low-memory
mode), the step count is a 0-d int32 tensor, and the bias corrections are
fp32 tensors on the parameters' device, so they round as the reference's
do and the update never waits on the host.  :func:`adamw_update` writes the
parameters and the moments in place under ``torch.no_grad()`` (the port's
donation of the state, where the reference returns new arrays), one slice
of at most ``_CHUNK`` elements at a time, so that a 671M-element embedding
needs no full-size fp32 temporaries.  Element-wise arithmetic does not
depend on the slicing.

DTensor parameters (the train step under a mesh) are updated on each
device's shards, their moments laid out as they are; the global norm sums
every shard once (DTensor's reduction of the per-leaf sums).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm"]

_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32: updates taken so far
    mu: dict
    nu: dict


def adamw_init(params) -> AdamWState:
    """fp32 zero moments with the parameters' shapes and devices, step 0."""
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def local(t):
    """A DTensor's own local tensor (outside autograd), else ``t``."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def _flat_chunks(*ts):
    """Matching slices of at most ``_CHUNK`` elements of the flattened
    tensors (the first ones written in place, so contiguous)."""
    flats = [t.reshape(-1) for t in ts]
    for s in range(0, flats[0].numel(), _CHUNK):
        yield [f[s:s + _CHUNK] for f in flats]


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf, leaves in flatten
    order."""
    leaves = tree_leaves(grads)
    sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        if isinstance(g, DTensor):
            sq = sq + g.float().square().sum().full_tensor()
            continue
        for (gc,) in _flat_chunks(g):
            sq = sq + gc.float().square().sum()
    return sq.sqrt()


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return (max_norm / gnorm.clamp_min(1e-9)).clamp_max(1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(fp32 gradients scaled to a global norm of at most ``max_norm``,
    the norm before scaling)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def adamw_update(params, grads, state: AdamWState, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, max_grad_norm=1.0):
    """One AdamW step on ``params`` with ``grads`` clipped to
    ``max_grad_norm``; ``lr`` a float or a 0-d fp32 tensor.  Updates the
    parameters, the moments and the step in place and returns (params,
    state, {"grad_norm"}): the decay is decoupled and acts on the fp32
    parameter, the moments are computed in fp32 and stored in their own
    dtype, the parameter is rounded once to its dtype."""
    with torch.no_grad():
        gnorm = _global_norm(grads)
        scale = _clip_scale(gnorm, max_grad_norm)
        state.step.add_(1)
        stepf = local(state.step).float()

        def one_minus_pow(b):
            base = torch.full((), b, dtype=torch.float32, device=stepf.device)
            return 1.0 - base ** stepf

        bc1, bc2 = one_minus_pow(b1), one_minus_pow(b2)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            if isinstance(p, DTensor):
                if tuple(g.placements) != tuple(p.placements):
                    g = g.redistribute(p.device_mesh, p.placements)
                p, g, m, v = (local(t) for t in (p, g, m, v))
            if not all(t.is_contiguous() for t in (p, m, v)):
                raise ValueError("adamw_update writes parameters and moments "
                                 "in place: they must be contiguous")
            for pc, gc, mc, vc in _flat_chunks(p, g, m, v):
                g32 = gc.float() * scale
                m32 = b1 * mc.float() + (1 - b1) * g32
                v32 = b2 * vc.float() + (1 - b2) * g32.square()
                delta = ((m32 / bc1) / ((v32 / bc2).sqrt() + eps)
                         + weight_decay * pc.float())
                pc.copy_(pc.float() - lr * delta)
                mc.copy_(m32)
                vc.copy_(v32)
    return params, state, {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr_at(step)``: linear warm-up over ``warmup`` steps, then a cosine
    decay to 0 at ``total``; a 0-d fp32 tensor on the step's device (an int
    step gives one on the CPU)."""
    def lr_at(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1, warmup)
        prog = ((step - warmup) / max(1, total - warmup)).clamp(0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr_at

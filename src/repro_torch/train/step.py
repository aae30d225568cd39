"""The train step of the port: forward and backward by autograd, optional
gradient accumulation and bf16 gradient compression with fp32 error
feedback, then AdamW in place (``repro.train.step``'s counterpart).

With a ``mesh`` the state is laid out by :func:`state_shardings` (the
parameters by ``shard_params_spec``, the AdamW moments by the parameters'
specs, the step count replicated) as DTensors, the batch on ``batch``, and
forward and backward run on DTensors: the gradient reduction is DTensor's.
Checkpoints keep full tensors (``full_tensor()``).

The model runs its plain path (``backend="ref"``), as the reference trains
with ``KB = "ref"``: no kernel of :mod:`repro_torch.kernels` has a backward
pass, and each refuses to run under autograd.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import encdec as ED
from ..models import transformer as TF
from ..models.common import ModelConfig, check_device
from ..optim.adamw import AdamWState, adamw_init, adamw_update, local
from ..parallel.sharding import (Spec, distribute_tree, sharded_region,
                                 shard_params_spec)
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainState", "make_train_state", "build_train_step",
           "loss_and_grads", "state_shardings"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any  # error-feedback residuals (None when compression is off)


def make_train_state(cfg: ModelConfig,
                     generator: torch.Generator | None = None,
                     device="cuda", compress_grads: bool = False,
                     opt_dtype: torch.dtype = torch.float32) -> TrainState:
    """Random parameters from ``generator`` (seeded 0 when omitted), zero
    moments in ``opt_dtype`` (bf16 halves the optimizer's memory) and, with
    ``compress_grads``, zero fp32 residuals; ``device="meta"`` gives the
    shapes and dtypes only (a template for a restore)."""
    device = check_device(device)
    init = ED.init_params_encdec if cfg.is_encoder_decoder else TF.init_params
    params = init(cfg, generator, device)
    opt = adamw_init(params)
    if opt_dtype != torch.float32:
        opt = AdamWState(opt.step,
                         tree_map(lambda m: m.to(opt_dtype), opt.mu),
                         tree_map(lambda v: v.to(opt_dtype), opt.nu))
    ef = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
          if compress_grads else None)
    return TrainState(params, opt, ef)


def _loss_impl(cfg: ModelConfig):
    return ED.loss_fn_encdec if cfg.is_encoder_decoder else TF.loss_fn


def loss_and_grads(cfg: ModelConfig, params, batch, accum_steps: int = 1,
                   mesh=None):
    """(loss, {"ce", "aux"}, gradients in the parameters' tree).

    ``accum_steps`` > 1 cuts the batch into that many contiguous leading
    microbatches (the reference's ``x.reshape((accum, B // accum) + …)``),
    runs one backward each, sums the gradients in fp32 and divides; the
    loss reported is then the microbatches' mean CE, where the reference
    reports the last microbatch's CE + aux.  Otherwise the gradients are in
    the parameters' dtype.  With a ``mesh`` (DTensor params; the batch
    given whole, each microbatch laid out on ``batch``) forward and
    backward run on DTensors."""
    with sharded_region(mesh):
        return _loss_and_grads(cfg, params, batch, accum_steps, mesh)


def _loss_and_grads(cfg: ModelConfig, params, batch, accum_steps, mesh):
    def loss_fn(p, b):
        return _loss_impl(cfg)(p, b, cfg, mesh=mesh)

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    if accum_steps == 1:
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))
    B = batch["tokens"].shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not a multiple of accum_steps "
                         f"{accum_steps}")
    mb = B // accum_steps
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    ce = aux = 0.0
    for i in range(accum_steps):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics = loss_fn(live, part)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
        ce = ce + metrics["ce"].detach()
        aux = aux + metrics["aux"].detach()
    for a in acc:
        a.div_(accum_steps)
    ce, aux = ce / accum_steps, aux / accum_steps
    return ce, {"ce": ce, "aux": aux}, tree_unflatten(params, acc)


def _compress(grads, ef):
    """EF-bf16: t = g + r (fp32); the gradient becomes t rounded to bf16
    (to nearest even) and the residual ``ef`` (updated in place) t − that."""
    def comp(g, r):
        r.add_(g)
        q = r.to(torch.bfloat16)
        r.sub_(q)
        return q
    with torch.no_grad():
        return tree_map(comp, grads, ef)


def state_shardings(state: TrainState, mesh) -> TrainState:
    """The :class:`~repro_torch.parallel.sharding.Spec` tree of a train
    state: the parameters by ``shard_params_spec``, the moments (and the
    error-feedback residuals) by the parameters' specs, ``step``
    replicated."""
    pspec = shard_params_spec(state.params, mesh)
    opt = AdamWState(Spec(), pspec, pspec)
    return TrainState(pspec, opt, pspec if state.ef is not None else None)


def build_train_step(cfg: ModelConfig, mesh=None, *, lr=3e-4,
                     accum_steps: int = 1, compress_grads: bool = False,
                     backend: str = "ref"):
    """Returns ``step(state, batch) -> (state, metrics)``.  ``lr`` a float
    or a callable of the optimizer's step count (a 0-d int32 tensor);
    ``batch`` a dict of tensors on the parameters' device.  The state is
    updated in place and returned; ``metrics`` ("ce", "aux", "grad_norm",
    "loss") are 0-d tensors, read without waiting on the device.

    ``backend`` must be "ref": the kernels have no backward pass (see
    :func:`repro_torch.kernels._build.refuse_autograd`).

    With a ``mesh`` the step has ``jit_with(state)``, the twin of the
    reference's: it returns (step, the state laid out by
    :func:`state_shardings` as DTensors, each rank keeping its shards).
    The step takes the batch whole (the same on every rank) and lays each
    microbatch out on ``batch``."""
    if backend != "ref":
        raise ValueError(
            f"backend={backend!r}: a train step runs the plain path "
            "(backend='ref'), as the reference trains with KB='ref'; no "
            "kernel has a backward pass")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def step(state: TrainState, batch):
        if compress_grads and state.ef is None:
            raise ValueError("compress_grads needs a state made with "
                             "make_train_state(..., compress_grads=True)")
        loss, metrics, grads = loss_and_grads(cfg, state.params, batch,
                                              accum_steps, mesh)
        ef = state.ef
        if compress_grads:
            grads = _compress(grads, ef)
        lr_val = lr(local(state.opt.step)) if callable(lr) else lr
        params, opt, om = adamw_update(state.params, grads, state.opt,
                                       lr_val)
        metrics = {**metrics, **om, "loss": metrics["ce"]}
        return TrainState(params, opt, ef), metrics

    if mesh is not None:
        def jit_with(state: TrainState):
            specs = state_shardings(state, mesh)
            return step, TrainState(
                distribute_tree(state.params, specs.params, mesh),
                AdamWState(distribute_tree(state.opt.step, Spec(), mesh),
                           distribute_tree(state.opt.mu, specs.opt.mu, mesh),
                           distribute_tree(state.opt.nu, specs.opt.nu, mesh)),
                distribute_tree(state.ef, specs.ef, mesh))
        step.jit_with = jit_with
    return step

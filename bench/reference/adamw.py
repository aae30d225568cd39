"""Plain reference of the train cells' optimizer and steps: AdamW with
global-norm clipping, decoupled weight decay and bias corrections, the
moments in float32 and each parameter stored back in its own dtype after
every update (the configuration keeps its parameters in bfloat16), as
the traffic file's ``optimizer`` states.  Gradients come from autograd
through a reference ``loss`` in float32."""

from __future__ import annotations

import torch

from .common import Exact


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _paths(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def _tree(pairs):
    out: dict = {}
    for path, t in pairs:
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def _loss_and_grads(loss_fn, p: dict, tokens, labels, hp, P, rows):
    """The mean loss over every row of the batch and its gradients,
    worked out ``rows`` rows at a time: each block's mean weighted by its
    share of the counted labels."""
    counted = (labels >= 0).sum().clamp_min(1)
    total, grads = 0.0, None
    for s in range(0, tokens.shape[0], rows or tokens.shape[0]):
        lb = labels[s:s + (rows or tokens.shape[0])]
        live = {k: t.detach().requires_grad_() for k, t in p.items()}
        loss = loss_fn(_tree(live.items()), tokens[s:s + lb.shape[0]], lb,
                       hp, P) * ((lb >= 0).sum() / counted)
        block = torch.autograd.grad(loss, list(live.values()))
        total += float(loss.detach())
        del live, loss
        if grads is None:
            grads = list(block)
        else:
            for g, b in zip(grads, block):
                g.add_(b)
        del block
    return total, grads


def train_steps(loss_fn, weights: dict, batches, hp: dict, opt: dict,
                P=Exact, rows: int | None = None) -> dict:
    """Steps 1 … len(batches) of AdamW from ``weights`` (a tree in the
    stored dtype), one a batch of ``batches`` [(tokens, labels)], the loss
    at precision ``P`` worked out ``rows`` rows at a time (all at once
    when None).  Returns {"losses": [float], "grad_norms": {path: norm of
    the first step's clipped gradient}, "delta_norms": {path: norm of the
    stored parameter's change over the steps}, "nu_norms": {path: norm of
    the second moment after them}}."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd, max_norm = opt["lr"], opt["weight_decay"], opt["max_grad_norm"]
    start = _paths(weights)
    stored = {k: t.dtype for k, t in start}
    p = {k: t.float() for k, t in start}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses, grad_norms = [], {}
    for step, (tokens, labels) in enumerate(batches, 1):
        loss, grads = _loss_and_grads(loss_fn, p, tokens, labels, hp, P,
                                      rows)
        losses.append(loss)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = (max_norm / gnorm.clamp_min(1e-9)).clamp_max(1.0)
            stepf = torch.tensor(float(step), device=gnorm.device)
            bc1 = 1.0 - torch.tensor(b1, device=gnorm.device) ** stepf
            bc2 = 1.0 - torch.tensor(b2, device=gnorm.device) ** stepf
            for (k, _), g in zip(p.items(), grads):
                g = g * scale
                if step == 1:
                    grad_norms[k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                delta = (m[k] / bc1) / ((v[k] / bc2).sqrt() + eps) \
                    + wd * p[k]
                p[k] = (p[k] - lr * delta).to(stored[k]).float()
            del grads
    delta_norms = {k: float((p[k] - t.float()).norm()) for k, t in start}
    return {"losses": losses, "grad_norms": grad_norms,
            "delta_norms": delta_norms,
            "nu_norms": {k: float(t.norm()) for k, t in v.items()}}

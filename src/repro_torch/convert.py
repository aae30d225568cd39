"""Convert ``repro`` parameters into the port's.

``repro`` initializes with ``jax.random`` (threefry), which torch cannot
reproduce, so the parity tests initialize in JAX and hand the period-stacked
pytree over as NumPy arrays.  The port keeps the reference's layout, so the
conversion is leaf by leaf: the same nested keys, ``(d_in, d_out)`` weights
used as ``x @ w``, the fused ``wkv`` with k in its first half and v in its
second.  Every leaf is checked against the shapes and dtypes the port's
``init_params`` (``init_params_encdec`` for an encoder-decoder ``cfg``)
makes for ``cfg``; :func:`train_state_from_jax` maps a whole
``repro.train.step.TrainState`` (parameters, AdamW moments and step, error
feedback residuals) with the same checks.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import encdec as ED
from .models import transformer as TF
from .models.common import ModelConfig
from .optim.adamw import AdamWState
from .train.step import TrainState
from .tree import tree_leaves


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(src, ref, path: str, device, dtype=None):
    """``src`` (nested dicts of array-likes) as tensors on ``device``, each
    checked against the shape and dtype (``dtype`` in place of the
    template's, when given) of ``ref``'s leaf at its path."""
    if isinstance(ref, dict):
        if not isinstance(src, dict) or set(src) != set(ref):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(ref)}, got {got}")
        return {k: _convert(src[k], ref[k], f"{path}/{k}", device, dtype)
                for k in ref}
    t = _to_tensor(src, device)
    want = dtype or ref.dtype
    if t.shape != ref.shape or t.dtype != want:
        raise ValueError(f"{path}: expected {tuple(ref.shape)} "
                         f"{want}, got {tuple(t.shape)} {t.dtype}")
    return t


def _template(cfg: ModelConfig) -> dict:
    init = ED.init_params_encdec if cfg.is_encoder_decoder else TF.init_params
    return init(cfg, device="meta")


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> dict:
    """``tree``: the nested dict of ``repro.models.transformer.init_params``
    (``repro.models.encdec.init_params_encdec`` for an encoder-decoder
    ``cfg``) with NumPy (or array-like) leaves.  Returns the port's
    parameters."""
    return _convert(tree, _template(cfg), "", device)


def train_state_from_jax(state, cfg: ModelConfig, device="cuda") -> TrainState:
    """``state``: a ``repro.train.step.TrainState`` (``params``, ``opt`` =
    ``AdamWState(step, mu, nu)``, ``ef`` or None) with NumPy (or
    array-like) leaves.  The parameters are checked as by
    :func:`params_from_jax`; the moments against the parameters' shapes in
    one dtype of their own (fp32, or bf16 moments); the step is a 0-d int32;
    the residuals are fp32 with the parameters' shapes."""
    ref = _template(cfg)
    params = _convert(state.params, ref, "params", device)
    first = np.asarray(tree_leaves(state.opt.mu)[0])
    mdt = torch.bfloat16 if first.dtype.name == "bfloat16" else torch.float32
    mu = _convert(state.opt.mu, ref, "opt/mu", device, mdt)
    nu = _convert(state.opt.nu, ref, "opt/nu", device, mdt)
    step = _to_tensor(state.opt.step, device)
    if step.shape != () or step.dtype != torch.int32:
        raise ValueError(f"opt/step: expected a 0-d int32, got "
                         f"{tuple(step.shape)} {step.dtype}")
    ef = (None if state.ef is None else
          _convert(state.ef, ref, "ef", device, torch.float32))
    return TrainState(params, AdamWState(step, mu, nu), ef)

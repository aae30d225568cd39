"""Convert ``repro`` parameters into the port's.

``repro`` initializes with ``jax.random`` (threefry), which torch cannot
reproduce, so the parity tests initialize in JAX and hand the period-stacked
pytree over as NumPy arrays.  The port keeps the reference's layout, so the
conversion is leaf by leaf: the same nested keys, ``(d_in, d_out)`` weights
used as ``x @ w``, the fused ``wkv`` with k in its first half and v in its
second.  Every leaf is checked against the shapes and dtypes the port's
``init_params`` (``init_params_encdec`` for an encoder-decoder ``cfg``)
makes for ``cfg``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import encdec as ED
from .models import transformer as TF
from .models.common import ModelConfig


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> dict:
    """``tree``: the nested dict of ``repro.models.transformer.init_params``
    (``repro.models.encdec.init_params_encdec`` for an encoder-decoder
    ``cfg``) with NumPy (or array-like) leaves.  Returns the port's
    parameters."""
    init = ED.init_params_encdec if cfg.is_encoder_decoder else TF.init_params
    want = init(cfg, device="meta")

    def conv(src, ref, path):
        if isinstance(ref, dict):
            if not isinstance(src, dict) or set(src) != set(ref):
                got = sorted(src) if isinstance(src, dict) else type(src)
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(ref)}, got {got}")
            return {k: conv(src[k], ref[k], f"{path}/{k}") for k in ref}
        t = _to_tensor(src, device)
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(f"{path}: expected {tuple(ref.shape)} "
                             f"{ref.dtype}, got {tuple(t.shape)} {t.dtype}")
        return t

    return conv(tree, want, "")

"""Shared pieces of the port's training parity tests: configs and
parameters made by ``repro`` and converted, numpy batches from a seed, and
the check of the loss and its gradients against ``jax.value_and_grad``.

Tolerances: the loss within 1e-5 relative, each gradient leaf within 1e-4
of the leaf's largest magnitude (both packages sum in other orders; a
gradient at rounding level can differ in sign, which a per-element relative
bound would reject)."""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as JED
from repro.models import transformer as JTF
from repro_torch.configs import PORTED_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_paths

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
DECODER_IDS = [a for a in PORTED_IDS
               if not get_config(a, reduced=True).is_encoder_decoder]
# the MoE LMs (attention layers only; Jamba's MoE is held in its own test)
MOE_LM_IDS = [a for a in DECODER_IDS
              if all(s.kind == "attn" for s in
                     get_config(a, reduced=True).layer_pattern)
              and any(s.moe for s in
                      get_config(a, reduced=True).layer_pattern)]


def setup_pair(arch, **over):
    """(jax cfg, jax params, port cfg, port params), fp32."""
    over = dict(dtype="float32", **over)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **over)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    init = JED.init_params_encdec if jcfg.is_encoder_decoder \
        else JTF.init_params
    jparams = init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


def make_batch(cfg, B, T, seed=0):
    """Tokens, next-token labels (−1 at the last position and at one more),
    and the prefix or the frames a config takes, as numpy arrays."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    labels[0, T // 2] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.prefix_len:
        batch["prefix_embeds"] = (0.02 * rs.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = rs.standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    return batch


def reference_grads(jcfg, jparams, batch):
    loss = JED.loss_fn_encdec if jcfg.is_encoder_decoder else JTF.loss_fn
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (l, m), g = jax.value_and_grad(loss, has_aux=True)(jparams, jb, jcfg)
    return float(l), {k: float(v) for k, v in m.items()}, \
        dict(tree_paths(jax.tree.map(np.asarray, g)))


def port_grads(tcfg, tparams, batch):
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    l, m, g = loss_and_grads(tcfg, tparams, batch)
    return float(l), {k: float(v) for k, v in m.items()}, g


def check_grads(jcfg, jparams, tcfg, tparams, batch):
    jl, jm, jg = reference_grads(jcfg, jparams, batch)
    tl, tm, tg = port_grads(tcfg, tparams, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["ce"], jm["ce"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["aux"], jm["aux"], rtol=LOSS_RTOL, atol=0)
    paths = tree_paths(tg)
    assert sorted(p for p, _ in paths) == sorted(jg)
    for path, g in paths:
        want = jg[path]
        assert g.shape == want.shape and g.dtype == torch.float32, path
        tol = GRAD_TOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol,
                                   err_msg=path)
    return tl, tg

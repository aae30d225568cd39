"""Training paths of the port beside the plain one, against the JAX
reference on the CPU (tolerances in ``_train_parity``): remat, which must
change no number, the period-stacked leaves cut once per forward, the MoE
FFN's gradients at capacity factors 1.25 and 8.0 with dropped tokens, and
the reference's chunked forms above ``chunk_threshold``."""

import jax
import numpy as np
import pytest
import torch

from _train_parity import (DECODER_IDS, MOE_LM_IDS, check_grads, make_batch,
                           setup_pair)
from repro_torch.convert import params_from_jax
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TF
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import tree_paths, tree_unflatten


@pytest.mark.parametrize("arch", ["glm4_9b", "phi_3_vision_4_2b"])
def test_remat_matches_reference(arch):
    """remat on, in both packages (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``, the port's ``torch.utils.checkpoint``)."""
    jcfg, jparams, tcfg, tparams = setup_pair(arch, remat=True)
    check_grads(jcfg, jparams, tcfg, tparams, make_batch(tcfg, 2, 12))


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_remat_keeps_the_numbers_and_saves_less(arch):
    """remat changes no number (loss and every gradient bit for bit) and
    keeps fewer tensors for the backward pass."""
    runs = {}
    for remat in (False, True):
        _, _, tcfg, tparams = setup_pair(arch, remat=remat)
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(tcfg, 2, 12).items()}
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _, grads = loss_and_grads(tcfg, tparams, batch)
        runs[remat] = (loss, tree_paths(grads), sum(saved))
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for (p, a), (_, b) in zip(g0, g1):
        assert torch.equal(a, b), p
    assert s1 < s0


def test_stacked_leaves_are_cut_once_per_forward():
    """The forward unbinds each period-stacked leaf once, so the backward
    gathers each stack's gradient with one ``stack``, not one full-size
    zero stack per period; the forward's numbers are those of indexing
    period by period."""
    _, _, tcfg, tparams = setup_pair("glm4_9b", n_periods=3)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(tcfg, 1, 8).items()}
    leaves = [t.detach().requires_grad_()
              for _, t in tree_paths(tparams["layers"])]
    params = dict(tparams, layers=tree_unflatten(tparams["layers"], leaves))
    loss, _ = TF.loss_fn(params, batch, tcfg)
    # the backward nodes that feed each stacked leaf's gradient
    feeds, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if type(nxt).__name__ == "AccumulateGrad":
                feeds.setdefault(id(nxt.variable), []).append(
                    type(fn).__name__)
            todo.append(nxt)
    assert [feeds[id(t)] for t in leaves] == [["UnbindBackward0"]] * len(
        leaves)
    # the same logits as the forward that indexes each period
    with torch.no_grad():
        logits, _ = TF.forward(tparams, batch["tokens"], tcfg)
        x = TF._embed(tparams, batch["tokens"], tcfg)
        pos = torch.arange(8, dtype=torch.int32).expand(1, 8)
        aux = torch.zeros(())
        for per in range(tcfg.n_periods):
            x, aux = TF._period_fwd(tcfg, TF._period(tparams["layers"], per),
                                    x, aux, pos, "ref")
        assert torch.equal(logits, TF._logits(tparams, x, tcfg))


def _zero_routers(tree):
    for pos in tree["layers"].values():
        if "router" in pos.get("ffn", {}):
            pos["ffn"]["router"]["w"] = np.zeros_like(
                pos["ffn"]["router"]["w"])
    return tree


@pytest.mark.parametrize("arch", MOE_LM_IDS)
@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("routers", ["random", "zero"])
def test_moe_grads_at_capacity_match_reference(arch, factor, routers):
    """The MoE's scatter into expert slots (``index_put_`` accumulating
    into a zero buffer), the sorted gate values and the aux loss carry the
    reference's gradients at capacity factors 1.25 (tokens dropped) and
    8.0 (none dropped); zeroed routers make every expert tie, so the top-k
    takes the lowest indices and at 1.25 every token past capacity C is
    dropped."""
    jcfg, jparams, tcfg, tparams = setup_pair(arch, capacity_factor=factor)
    if routers == "zero":
        tree = _zero_routers(jax.tree.map(np.asarray, jparams))
        jparams = jax.tree.map(jax.numpy.asarray, tree)
        tparams = params_from_jax(tree, tcfg, device="cpu")
    batch = make_batch(tcfg, 3, 8, seed=5)
    check_grads(jcfg, jparams, tcfg, tparams, batch)
    n_tok = 24
    C = TB.moe_capacity(tcfg, n_tok)
    if factor == 8.0:
        assert C == n_tok   # nothing can be dropped
    elif routers == "zero":
        assert C < n_tok    # tokens past C dropped at experts 0 … k−1


@pytest.mark.parametrize("arch,over", [
    ("gemma2_9b", dict(chunk_threshold=8, attn_kv_chunk=4)),
    ("rwkv6_7b", dict(chunk_threshold=8, scan_chunk=4)),
    ("jamba_1_5_large_398b", dict(chunk_threshold=8, scan_chunk=4,
                                  attn_kv_chunk=4)),
])
def test_chunked_forms_grads_match_reference(arch, over):
    """Above ``chunk_threshold`` the reference differentiates its chunked
    attention, chunked RWKV-6 recurrence and chunked selective scan (below,
    the associative scan); the port differentiates its streaming attention
    and its twins of the chunked forms, with the same gradients."""
    jcfg, jparams, tcfg, tparams = setup_pair(arch, **over)
    check_grads(jcfg, jparams, tcfg, tparams, make_batch(tcfg, 1, 16, seed=7))

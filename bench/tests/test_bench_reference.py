"""The plain references against the program at the smoke widths on the
CPU: in float32 the two compute the same functions, so they agree to
rounding; the frozen copies (the batches, the lengths) equal the
program's draws."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchlib import ROOT

from bench import harness
from bench import weights as W
from bench.lengths import clipped_exp
from bench.reference import adamw as ref_adamw
from bench.reference import feed as ref_feed
from bench.reference import rwkv6 as ref_rwkv6

# (cell, configuration) per architecture; the train configuration's
# smoke preset takes the chunked forms (chunk_threshold 32)
ARCHS = [("nemo_serve", "dense_gqa"), ("rwkv6_train", "rwkv6")]


def _fp32_cell(workload, layers=None):
    cell = harness.load_cell(ROOT, workload, 5, 0.0, False, "cpu", True)
    cfg = dataclasses.replace(cell.cfg, dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, n_periods=layers)
    hp = dict(cell.hp, torch_dtype="float32")
    weights = W.make(cell.arch, cfg, 5, torch.device("cpu"))
    return cell, cfg, hp, weights


@pytest.mark.parametrize("workload,arch", ARCHS)
def test_logits_equal_the_programs_forward_and_decode(workload, arch,
                                                       monkeypatch):
    from repro_torch.models import transformer as TF

    from bench.reference import dense_gqa
    monkeypatch.setattr(dense_gqa, "QUERY_BLOCK", 16)    # several blocks
    cell, cfg, hp, weights = _fp32_cell(workload)
    T = 80          # three of the reference's chunks, five of the port's
    toks = torch.randint(0, cfg.vocab_size, (2, T),
                         generator=torch.Generator().manual_seed(1))
    rows = torch.tensor([(n, t) for n in range(2) for t in range(T)])
    with torch.no_grad():
        ref = cell.ref.logits_at(weights, toks, rows, hp).view(2, T, -1)
        fwd = TF.forward(weights, toks, cfg, backend="ref")[0]
        state = TF.init_decode_state(cfg, 2, T, device="cpu")
        pos = torch.zeros((), dtype=torch.int32)
        steps = []
        for t in range(T):
            lg, state = TF.decode_step(weights, state, toks[:, t].int(), pos,
                                       cfg, backend="ref")
            steps.append(lg)
            pos += 1
    assert ref.std() > 0.5
    torch.testing.assert_close(fwd, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(torch.stack(steps, 1), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("workload,arch", ARCHS)
def test_loss_and_gradients_equal_the_programs(workload, arch):
    from repro_torch.train.step import loss_and_grads
    cell, cfg, hp, weights = _fp32_cell(workload)
    cfg = dataclasses.replace(cfg, chunk_threshold=32, attn_kv_chunk=16,
                              scan_chunk=16)
    tokens, labels = ref_feed.batch(9, 0, 2, 64, cfg.vocab_size)
    loss, _, grads = loss_and_grads(cfg, weights,
                                    {"tokens": tokens, "labels": labels})
    live = {k: t.detach().clone().requires_grad_()
            for k, t in W.paths(weights)}
    tree: dict = {}
    for k, t in live.items():
        W.set_path(tree, k, t)
    want = cell.ref.loss(tree, tokens, labels, hp)
    want.backward()
    assert abs(float(loss) - float(want.detach())) < 1e-5
    for k, g in W.paths(grads):
        ref_g = live[k].grad
        scale = float(ref_g.abs().max()) + 1e-12
        assert float((g - ref_g).abs().max()) / scale < 1e-4, k


def test_adamw_steps_equal_the_programs():
    """Three steps of the reference's AdamW (the parameters stored in their
    dtype, here float32) against the program's train step."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState, build_train_step
    cell, cfg, hp, weights = _fp32_cell("nemo_serve")
    opt = {"lr": 5e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "max_grad_norm": 1.0}
    batches = [ref_feed.batch(3, s, 2, 16, cfg.vocab_size) for s in range(3)]
    ref = ref_adamw.train_steps(cell.ref.loss, weights, batches, hp, opt)
    p0 = {k: t.clone() for k, t in W.paths(weights)}
    state = TrainState(weights, adamw_init(weights), None)
    step = build_train_step(cfg, lr=opt["lr"])
    losses = []
    for tokens, labels in batches:
        state, m = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(m["loss"]))
        if len(losses) == 1:
            first = {k: float(mu.norm()) / (1 - opt["b1"])
                     for k, mu in W.paths(state.opt.mu)}
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for k, t in W.paths(state.params):
        assert abs(first[k] - ref["grad_norms"][k]) <= \
            1e-4 * ref["grad_norms"][k] + 1e-9, k
        d = float((t - p0[k]).norm())
        assert abs(d - ref["delta_norms"][k]) <= \
            1e-3 * ref["delta_norms"][k] + 1e-9, k


def test_adamw_steps_in_row_blocks_equal_the_whole_batch():
    """The loss worked out a row at a time, each block weighted by its
    share of the counted labels, gives the whole batch's steps."""
    cell, cfg, hp, weights = _fp32_cell("nemo_serve")
    opt = {"lr": 5e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "max_grad_norm": 1.0}
    batches = [ref_feed.batch(4, s, 3, 16, cfg.vocab_size) for s in range(2)]
    batches[1][1][0, :9] = -1                 # rows count unequal labels
    whole = ref_adamw.train_steps(cell.ref.loss, weights, batches, hp, opt)
    rows = ref_adamw.train_steps(cell.ref.loss, weights, batches, hp, opt,
                                 rows=1)
    np.testing.assert_allclose(rows["losses"], whole["losses"], rtol=1e-5)
    for what in ("grad_norms", "delta_norms", "nu_norms"):
        for k, x in whole[what].items():
            assert abs(rows[what][k] - x) <= 1e-3 * x + 1e-12, (what, k)


def test_chunked_wkv_equals_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, H, T, K = 2, 3, 70, 8
    r, k, v = (torch.randn(B, H, T, K, generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn(B, H, T, K, generator=g) - 1.0)
    u = torch.randn(H, K, generator=g) * 0.3
    S = torch.zeros(B, H, K, K)
    want = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        want.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                 S + u[None, :, :, None] * kv))
        S = logw[:, :, t, :, None].exp() * S + kv
    got = ref_rwkv6.wkv(r, k, v, logw, u, chunk=32)
    torch.testing.assert_close(got, torch.stack(want, 2), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 3000000101])
def test_reference_batches_equal_the_programs(seed):
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    for step in (0, 1, 5):
        got = batch_at(SyntheticLM(1000, 32, 2, seed=seed), step, "cpu")
        tokens, labels = ref_feed.batch(seed, step, 2, 32, 1000)
        assert torch.equal(got["tokens"], tokens)
        assert torch.equal(got["labels"], labels)


def test_length_draw_equals_the_programs():
    from repro_torch.serve.trace import _clipped_exp_length
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for mean, mx in ((48, 128), (96, 256), (1, 4), (6, 12)) * 20:
        assert clipped_exp(a, mean, mx) == _clipped_exp_length(b, mean, mx)

"""The port's data pipeline, checkpoints and straggler monitor, on the CPU:
``batch_at``'s contract (pure in (seed, step), the reference's marginal and
repeat structure, shifted labels, the prefix stub), ``CheckpointManager``
(a checkpoint of the reference's ``repro.ckpt.CheckpointManager`` restored
into the port bit for bit, the port's own save and resume continuing the
trajectory bit for bit, the asynchronous snapshot, keep-N and the removal
of partial writes), the leaf order of ``repro_torch.tree`` against JAX's
flatten order, and the copy of ``StragglerMonitor`` against the original."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import batch_at as jbatch_at
from repro.ft.straggler import StragglerMonitor as JStragglerMonitor
from repro.train import step as JS
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.data.pipeline import SyntheticLM, batch_at
from repro_torch.ft import StragglerMonitor
from repro_torch.train import step as TS
from repro_torch.train import train_lm
from repro_torch.tree import tree_leaves, tree_paths


def _cfgs(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(jax_get_config("glm4_9b", reduced=True),
                                **over),
            dataclasses.replace(get_config("glm4_9b", reduced=True), **over))


def _equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_batch_at_is_pure_and_shaped():
    ds = SyntheticLM(1000, 64, 4, seed=3, prefix_len=5, d_model=16)
    a, b = batch_at(ds, 7, "cpu"), batch_at(ds, 7, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"], batch_at(ds, 8, "cpu")["tokens"])
    assert not torch.equal(
        a["tokens"],
        batch_at(dataclasses.replace(ds, seed=4), 7, "cpu")["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (4, 64)
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    t = a["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    assert torch.equal(a["labels"][:, :-1], t[:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    pe = a["prefix_embeds"]
    assert pe.shape == (4, 5, 16) and pe.dtype == torch.float32
    assert 0.01 < float(pe.std()) < 0.03
    assert "prefix_embeds" not in batch_at(SyntheticLM(10, 4, 1), 0, "cpu")


def _stats(tokens: np.ndarray, V: int):
    """(share of tokens equal to the predecessor's base + 1 mod V … as
    read from the tokens, mean of tokens / V, share below V / 8)."""
    rep = (tokens[:, 1:] == (tokens[:, :-1] + 1) % V).mean()
    return rep, (tokens / V).mean(), (tokens < V / 8).mean()


def test_batch_at_matches_the_reference_distribution():
    """Large draws of both pipelines: the marginal of floor(V·u³) (mean
    V/4, half the mass below V/8) and the 30% of tokens that repeat their
    predecessor's base + 1 agree within sampling error."""
    V, B, T = 4096, 64, 512
    got = np.concatenate([batch_at(SyntheticLM(V, T, B, seed=1), s, "cpu")
                          ["tokens"].numpy() for s in range(2)])
    want = np.concatenate([np.asarray(jbatch_at(JSyntheticLM(V, T, B, seed=1),
                                                s)["tokens"])
                           for s in range(2)])
    for g, w in zip(_stats(got, V), _stats(want, V)):
        assert abs(g - w) < 0.01, (g, w)
    g_rep, g_mean, g_low = _stats(got, V)
    assert abs(g_mean - 0.25) < 0.01 and abs(g_low - 0.5) < 0.01
    assert 0.2 < g_rep < 0.4


# ---------------------------------------------------------------------------
# the tree order and the checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_leaf_order_is_jax_flatten_order(compress):
    jcfg, tcfg = _cfgs()
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(0),
                                 compress_grads=compress)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                  device="cpu")
    jl = jax.tree_util.tree_leaves(jstate)
    tl = tree_leaves(tstate)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (tstate.ef is None) != compress


@pytest.mark.parametrize("compress,moments", [(False, "float32"),
                                              (True, "float32"),
                                              (False, "bfloat16")])
def test_reference_checkpoint_restores_into_the_port(tmp_path, compress,
                                                     moments):
    """A state the reference trained a step and saved: the port reads it
    into its own template leaf by leaf, bit for bit (bf16 moments stored as
    uint16 too), and resumes from it."""
    jcfg, tcfg = _cfgs()
    mdt = getattr(jax.numpy, moments)
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(0),
                                 compress_grads=compress, opt_dtype=mdt)
    jstep = JS.build_train_step(jcfg, lr=1e-3, compress_grads=compress,
                                donate=False)
    batch = jbatch_at(JSyntheticLM(jcfg.vocab_size, 16, 2, seed=0), 0)
    jstate, _ = jstep(jstate, batch)
    JCheckpointManager(str(tmp_path)).save(1, jstate)
    template = TS.make_train_state(tcfg, device="meta",
                                   compress_grads=compress,
                                   opt_dtype=getattr(torch, moments))
    step, got = CheckpointManager(str(tmp_path)).restore(template,
                                                         device="cpu")
    assert step == 1 and int(got.opt.step) == 1
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                device="cpu")
    _equal(got, want)
    tstep = TS.build_train_step(tcfg, lr=1e-3, compress_grads=compress)
    got, m = tstep(got, {k: torch.from_numpy(np.array(v))
                         for k, v in batch.items()})
    assert int(got.opt.step) == 2 and np.isfinite(float(m["loss"]))


def test_port_checkpoint_needs_jax_to_restore_in_the_reference(tmp_path):
    """The port writes key paths, not a pickled JAX treedef, so the
    reference's restore (which unpickles one) cannot read it; the layout is
    otherwise the reference's."""
    _, tcfg = _cfgs()
    state = TS.make_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    CheckpointManager(str(tmp_path)).save(4, state)
    path = tmp_path / "step_000000004"
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert manifest["n_leaves"] == len(tree_leaves(state))
    assert manifest["paths"][0] == "params/embed/table"
    assert "treedef" not in manifest
    assert len(list(path.glob("arr_*.npy"))) == manifest["n_leaves"]
    with pytest.raises(KeyError, match="treedef"):
        JCheckpointManager(str(tmp_path)).restore()


def test_save_and_resume_continue_the_trajectory_bit_for_bit(tmp_path):
    """Four steps in one run against two, a save, a restore into a fresh
    template and two more: every leaf of the states and every loss equal,
    bit for bit (compression on, so the residuals are carried too).  At
    ``train_lm``'s tiny preset (vocabulary 8192) the CPU's indexing backward
    would add the embedding's gradient rows with atomics, in no fixed
    order; the model's ``F.embedding`` sums them in one."""
    tcfg = train_lm.preset("tiny")
    ds = SyntheticLM(tcfg.vocab_size, 32, 4, seed=5)
    step = TS.build_train_step(tcfg, lr=1e-3, compress_grads=True)

    def fresh():
        return TS.make_train_state(tcfg, torch.Generator().manual_seed(0),
                                   "cpu", compress_grads=True)

    a, la = fresh(), []
    for i in range(4):
        a, m = step(a, batch_at(ds, i, "cpu"))
        la.append(float(m["loss"]))
    b, lb = fresh(), []
    for i in range(2):
        b, m = step(b, batch_at(ds, i, "cpu"))
        lb.append(float(m["loss"]))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, b)
    template = TS.make_train_state(tcfg, device="meta", compress_grads=True)
    start, c = mgr.restore(template, device="cpu")
    _equal(c, b)
    for i in range(start, 4):
        c, m = step(c, batch_at(ds, i, "cpu"))
        lb.append(float(m["loss"]))
    assert la == lb
    _equal(a, c)


def test_async_snapshot_survives_an_in_place_update(tmp_path):
    """``save(blocking=False)`` copies every leaf before it returns (on the
    CPU ``.cpu()`` would return the leaf itself): the step that updates the
    state in place right after it does not reach the checkpoint."""
    _, tcfg = _cfgs()
    state = TS.make_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    before = [t.clone() for t in tree_leaves(state)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    step = TS.build_train_step(tcfg, lr=1e-2)
    state, _ = step(state,
                    batch_at(SyntheticLM(tcfg.vocab_size, 8, 2), 0, "cpu"))
    assert not torch.equal(tree_leaves(state)[0], before[0])
    mgr.wait()
    _, got = mgr.restore(TS.make_train_state(tcfg, device="meta"),
                         device="cpu")
    for x, y in zip(tree_leaves(got), before):
        assert torch.equal(x, y)


def test_keep_n_partial_writes_and_mismatched_templates(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.bfloat16)}
    (tmp_path / "step_000000009.tmp-dead").mkdir()
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    assert not (tmp_path / "step_000000009.tmp-dead").exists()
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(tree)
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    step, got = mgr.restore(tree)
    assert step == 3 and torch.equal(got["b"], tree["b"])
    with pytest.raises(ValueError, match="stored float32"):
        mgr.restore({"a": torch.zeros(3, 2), "b": tree["b"]})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": tree["a"]})
    with pytest.raises(ValueError, match="key paths"):
        mgr.restore({"a": tree["a"], "c": tree["b"]})
    with pytest.raises(ValueError, match="meta"):
        mgr.restore({k: v.to("meta") for k, v in tree.items()})
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]


# ---------------------------------------------------------------------------
# the straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_copy_matches_the_original():
    """The same step-time records (a slow host, a host that misses
    heartbeats, a recovery) through both monitors: the same stragglers,
    dead and healthy hosts after every step, and the same EWMAs."""
    rs = np.random.RandomState(0)
    mine, ref = StragglerMonitor(6, patience=2, dead_after=3), \
        JStragglerMonitor(6, patience=2, dead_after=3)
    flagged = set()
    for step in range(30):
        times = {h: float(1.0 + 0.1 * rs.rand()) for h in range(6)}
        if 5 <= step < 15:
            times[2] *= 3.0          # a straggler, then it recovers
        if 10 <= step < 16:
            del times[4]             # missed heartbeats, then back
        mine.record(times)
        ref.record(times)
        assert mine.stragglers() == ref.stragglers()
        assert mine.dead() == ref.dead()
        assert mine.healthy() == ref.healthy()
        np.testing.assert_array_equal(mine.ewma, ref.ewma)
        flagged |= {("slow", h) for h in mine.stragglers()}
        flagged |= {("dead", h) for h in mine.dead()}
    assert flagged == {("slow", 2), ("dead", 4)}
    assert StragglerMonitor.__init__.__defaults__ == \
        JStragglerMonitor.__init__.__defaults__

"""The port's optimizer, train step and training script against the JAX
reference on the CPU: ``adamw_update`` fed identical numpy gradients,
``clip_by_global_norm`` and ``cosine_schedule``; one ``build_train_step``
step (accumulation 1 and 2, EF-bf16 compression on and off, bf16 moments)
against the reference's ``build_train_step(..., donate=False)`` from the
same converted state; and the ``train_lm`` twin's per-step losses against
the reference's steps on the reference's batches.

Tolerances: ``adamw_update`` 1e-6 (fp32 moments; bf16 moments one bf16
ulp); after a train step the loss and the gradient norm within 1e-5
relative, every updated parameter within 2e-5 + 2e-4 · |x| (the reference's
own accumulation tolerance, ``tests/test_runtime.py``) except where the
gradient is below 1e-4 of its leaf's largest magnitude (AdamW's first step
moves an element by about lr · sign(g), so a gradient at rounding level
that differs in sign moves it by 2 · lr), the moments within 1e-4 (mu) and
2e-4 (nu, a square) of the leaf's largest magnitude."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.pipeline import batch_at as jbatch_at
from repro.configs import get_config as jax_get_config
from repro.models import transformer as JTF
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.kernels._build import refuse_autograd
from repro_torch.kernels.flash_attention import (decode_attention_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.gemm import gemm_cuda
from repro_torch.kernels.rwkv6 import rwkv6_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda
from repro_torch.optim import adamw as TA
from repro_torch.train import step as TS
from repro_torch.train import train_lm
from repro_torch.tree import tree_paths

ROOT = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7   # one bf16 ulp is at most this much of |x|
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _example():
    """examples/train_lm.py, loaded as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _tree(rs, scale=1.0):
    w = scale * rs.standard_normal((6, 5))
    return {"a": {"w": w.astype(np.float32)},
            "b": (scale * rs.standard_normal((7,))).astype(np.float32)}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("gscale", [0.01, 10.0])
def test_adamw_update_matches_reference(moments, gscale):
    """Two updates from identical gradients (at scale 10 the global norm
    clips them); the step count, the bias corrections and the decoupled
    decay as the reference's."""
    rs = np.random.RandomState(0)
    params = _tree(rs)
    jp = jax.tree.map(jax.numpy.asarray, params)
    jst = JA.adamw_init(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    tp = {"a": {"w": tp["a"]["w"].clone()}, "b": tp["b"].clone()}
    tst = TA.adamw_init(tp)
    mdt = getattr(jax.numpy, moments)
    jst = JA.AdamWState(jst.step,
                        jax.tree.map(lambda m: m.astype(mdt), jst.mu),
                        jax.tree.map(lambda m: m.astype(mdt), jst.nu))
    tdt = getattr(torch, moments)
    tst = TA.AdamWState(tst.step,
                        {"a": {"w": tst.mu["a"]["w"].to(tdt)},
                         "b": tst.mu["b"].to(tdt)},
                        {"a": {"w": tst.nu["a"]["w"].to(tdt)},
                         "b": tst.nu["b"].to(tdt)})
    for i in range(2):
        grads = _tree(rs, gscale)
        jp, jst, jm = JA.adamw_update(jp, jax.tree.map(jax.numpy.asarray,
                                                       grads), jst, lr=1e-2)
        tp, tst, tm = TA.adamw_update(
            tp, {"a": {"w": torch.from_numpy(grads["a"]["w"])},
                 "b": torch.from_numpy(grads["b"])}, tst, lr=1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(tst.step) == int(jst.step) == i + 1
        mtol = 1e-6 if moments == "float32" else BF16_ULP
        for (path, got), (_, want) in zip(
                tree_paths({"p": tp, "mu": tst.mu, "nu": tst.nu}),
                tree_paths(_np({"p": jp, "mu": jst.mu, "nu": jst.nu}))):
            tol = 1e-6 if path.startswith("p/") else mtol
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=1e-6, err_msg=path)


def test_clip_by_global_norm_matches_reference():
    rs = np.random.RandomState(1)
    for scale, max_norm in ((0.01, 1.0), (10.0, 1.0), (1.0, 0.5)):
        grads = _tree(rs, scale)
        jg, jn = JA.clip_by_global_norm(
            jax.tree.map(jax.numpy.asarray, grads), max_norm)
        tg, tn = TA.clip_by_global_norm(
            {"a": {"w": torch.from_numpy(grads["a"]["w"])},
             "b": torch.from_numpy(grads["b"])}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for (_, got), (_, want) in zip(tree_paths(tg), tree_paths(_np(jg))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(20, 200), (10, 100), (20, 5),
                                          (0, 30)])
def test_cosine_schedule_matches_reference(warmup, total):
    """Within 1e-6 relative, or 1e-6 of the base rate where 1 + cos(π·p)
    cancels near the end of the decay (an ulp of the cosine there is a
    large part of the result)."""
    jlr = JA.cosine_schedule(3e-3, warmup, total)
    tlr = TA.cosine_schedule(3e-3, warmup, total)
    for s in range(total + 5):
        got = tlr(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jlr(s)), rtol=1e-6,
                                   atol=1e-6 * 3e-3)
        assert float(tlr(s)) == float(got)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _cfgs(**over):
    over = dict(dtype="float32", **over)
    return (dataclasses.replace(jax_get_config("glm4_9b", reduced=True),
                                **over),
            dataclasses.replace(get_config("glm4_9b", reduced=True), **over))


def _batch(cfg, B=4, T=16, step=0):
    return _np(jbatch_at(JSyntheticLM(cfg.vocab_size, T, B, seed=2), step))


@pytest.mark.parametrize("accum,compress,moments", [
    (1, False, "float32"), (2, False, "float32"), (1, True, "float32"),
    (2, True, "float32"), (1, False, "bfloat16")])
def test_train_step_matches_reference(accum, compress, moments):
    jcfg, tcfg = _cfgs()
    mdt = getattr(jax.numpy, moments)
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(0),
                                 compress_grads=compress, opt_dtype=mdt)
    tstate = train_state_from_jax(_np(jstate), tcfg, device="cpu")
    assert tstate.opt.mu["embed"]["table"].dtype == getattr(torch, moments)
    batch = _batch(tcfg)
    lr = 1e-3
    jstep = JS.build_train_step(jcfg, lr=lr, accum_steps=accum,
                                compress_grads=compress, donate=False)
    tstep = TS.build_train_step(tcfg, lr=lr, accum_steps=accum,
                                compress_grads=compress)
    # the reference's gradients, for the sign rule of the module docstring
    (_, _), jgrads = jax.value_and_grad(JTF.loss_fn, has_aux=True)(
        jstate.params, jax.tree.map(jax.numpy.asarray, batch), jcfg)
    jgrads = dict(tree_paths(_np(jgrads)))
    jnew, jm = jstep(jstate, jax.tree.map(jax.numpy.asarray, batch))
    tnew, tm = tstep(tstate, _t(batch))
    assert tnew.params is tstate.params   # updated in place
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    if accum == 1:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(tnew.opt.step) == int(jnew.opt.step) == 1
    jnew = _np(jnew)
    for (path, got), (_, want) in zip(tree_paths(tnew.params),
                                      tree_paths(jnew.params)):
        bad = np.abs(got.numpy() - want) > 2e-5 + 2e-4 * np.abs(want)
        g = np.abs(jgrads[path])
        assert (g[bad] < GRAD_TOL * g.max()).all(), (path, bad.sum())
    scale = {"mu": 1e-4, "nu": 2e-4}
    for name in ("mu", "nu"):
        for (path, got), (_, want) in zip(
                tree_paths(getattr(tnew.opt, name)),
                tree_paths(getattr(jnew.opt, name))):
            want = np.asarray(want, np.float32)
            tol = scale[name] * np.abs(want).max()
            # bf16 moments, or a compressed gradient rounded to bf16 the
            # other way: one bf16 ulp (two for nu, a square) more
            ulps = (moments == "bfloat16") + compress * (1 + (name == "nu"))
            tol = tol + ulps * BF16_ULP * np.abs(want)
            err = np.abs(got.float().numpy() - want)
            i = np.argmax(err - tol)
            assert (err <= tol).all(), (name, path, err.flat[i],
                                        want.flat[i], tol.flat[i])
    if compress:
        # residuals: t − bf16(t); bf16(t) may round the other way where t
        # differs in its last bits, so each residual within one bf16 ulp
        # of |t|, and not all zero
        for (path, got), (_, want) in zip(tree_paths(tnew.ef),
                                          tree_paths(jnew.ef)):
            t = np.abs(jgrads[path]).max()
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=BF16_ULP * t, err_msg=path)
        assert sum(float(e.abs().sum()) for _, e in tree_paths(tnew.ef)) > 0


def test_accumulated_loss_is_the_microbatches_mean_ce():
    """Under accumulation the port reports the mean CE of its microbatches
    (the reference reports the last one's CE + aux), and the gradient is
    the mean of theirs."""
    _, tcfg = _cfgs()
    batch = _t(_batch(tcfg))
    state = TS.make_train_state(tcfg, torch.Generator().manual_seed(0),
                                "cpu")
    loss, metrics, grads = TS.loss_and_grads(tcfg, state.params, batch, 2)
    halves = [TS.loss_and_grads(tcfg, state.params,
                                {k: v[i * 2:(i + 1) * 2]
                                 for k, v in batch.items()})
              for i in range(2)]
    np.testing.assert_allclose(float(loss), (float(halves[0][1]["ce"])
                                             + float(halves[1][1]["ce"])) / 2,
                               rtol=1e-6)
    assert torch.equal(loss, metrics["ce"])
    for (path, g), (_, a), (_, b) in zip(tree_paths(grads),
                                         tree_paths(halves[0][2]),
                                         tree_paths(halves[1][2])):
        torch.testing.assert_close(g, (a + b) / 2, rtol=1e-6, atol=1e-9,
                                   msg=path)


def test_train_step_refuses_the_kernel_backend():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="backend='ref'"):
        TS.build_train_step(tcfg, backend="kernel")
    with pytest.raises(ValueError, match="accum_steps"):
        TS.build_train_step(tcfg, accum_steps=0)
    step = TS.build_train_step(tcfg, compress_grads=True)
    state = TS.make_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="compress_grads"):
        step(state, _t(_batch(tcfg)))


@pytest.mark.parametrize("wrapper,n_args", [
    (lambda x, w: gemm_cuda(x, w, bm=128, bn=128, bk=64), 2),
    (lambda q, k, v: flash_attention_cuda(q, k, v, bq=64, bk=64), 3),
    (lambda q, k, v: decode_attention_cuda(q, k, v, torch.zeros(
        (), dtype=torch.int32)), 3),
    (rwkv6_cuda, 5), (ssm_scan_cuda, 6)],
    ids=["gemm", "flash_attention", "decode_attention", "rwkv6",
         "ssm_scan"])
def test_kernel_wrappers_refuse_autograd(wrapper, n_args):
    """No kernel has a backward pass: each wrapper refuses an input that
    requires grad while autograd records, before it looks at anything else
    (so this holds on the CPU too); under no_grad the refusal is off."""
    args = [torch.zeros(2, 2) for _ in range(n_args)]
    args[-1].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward pass"):
        wrapper(*args)
    with torch.no_grad():
        refuse_autograd("any", *args)
    refuse_autograd("any", *(a.detach() for a in args))


# ---------------------------------------------------------------------------
# the training script, examples/train_lm.py's twin
# ---------------------------------------------------------------------------

def test_train_lm_presets_equal_the_examples():
    ref = _example()
    for name in ("tiny", "100m"):
        assert dataclasses.asdict(train_lm.preset(name)) == \
            dataclasses.asdict(ref.preset(name))


def test_train_lm_twin_losses_match_the_reference():
    """``train_lm --preset tiny --steps 5 --seq 32`` (batch 8, lr 3e-3,
    cosine warm-up 20): the reference example's steps from PRNGKey(0) on
    its own batches, and the twin's loop from the converted initial state
    on the same batches, give the same loss at every step."""
    ref = _example()
    jcfg = ref.preset("tiny")
    tcfg = train_lm.preset("tiny")
    steps, B, T = 5, 8, 32
    ds = JSyntheticLM(jcfg.vocab_size, T, B, seed=0)
    batches = [_np(jbatch_at(ds, i)) for i in range(steps)]
    jlr = JA.cosine_schedule(3e-3, warmup=20, total=steps)
    jstep = JS.build_train_step(jcfg, lr=jlr)
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = train_state_from_jax(_np(jstate), tcfg, device="cpu")
    want = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jax.numpy.asarray, b))
        want.append(float(m["loss"]))
    tstep = TS.build_train_step(
        tcfg, lr=TA.cosine_schedule(3e-3, warmup=20, total=steps))
    lines = []
    _, losses = train_lm.train(tstep, tstate, lambda i: _t(batches[i]), 0,
                               steps, tokens_per_step=B * T, log=lines.append)
    np.testing.assert_allclose([losses[i] for i in range(steps)], want,
                               rtol=1e-5)
    assert lines[0].startswith("step    0  loss ") and len(lines) == 2


def test_train_lm_twin_runs_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    first = train_lm.main(["--device", "cpu", "--steps", "3", "--seq", "16",
                           "--batch", "2", "--ckpt", ck,
                           "--ckpt-every", "2"])
    assert first.start == 0 and sorted(first.losses) == [0, 1, 2]
    again = train_lm.main(["--device", "cpu", "--steps", "5", "--seq", "16",
                           "--batch", "2", "--ckpt", ck,
                           "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert again.start == 3 and sorted(again.losses) == [3, 4]
    assert int(again.state.opt.step) == 5
    assert "checkpoints at" in out and "steps [4, 5]" in out

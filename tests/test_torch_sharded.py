"""The port's sharded paths on a 2×2 mesh of 4 ``gloo`` ranks on the CPU,
held to ``repro``'s unsharded outputs (and, for the MoE's ``shard_map``
dispatch, to ``repro`` under its own 4-device mesh).

- Dense: a Mistral-NeMo smoke in fp32 with one kv head, so that the KV
  cache's ``tensor`` axis falls back and the cache is sequence-sharded (the
  reference's layout for 8 kv heads on a 16-wide model axis): the forward,
  every decode step of a teacher-forced then greedy generation (the
  step's ``jit_with``), the loss and every gradient, and one
  ``build_train_step`` step, each with the mesh.
- Scans: RWKV-6 and Jamba smokes in fp32 with ``chunk_threshold`` 8 and
  ``scan_chunk`` 4, so that T = 16 takes the chunked recurrence and the
  chunked selective scan on each device's shards (the token shift and the
  causal conv with T whole, their inputs' T split moved to channels): the
  forward, the loss and every gradient.
- Multi-pod: the RWKV-6, Jamba, Mistral-NeMo, Whisper (one head) and
  GLM-4 (one kv head) smokes' loss and every gradient on a 2×2×2 ("pod",
  "data", "model") mesh of 8 ranks, where a product's rows B·T would split
  over three mesh dims and T's split moves to the contracted dim first,
  and where the attention's query rows split over model, held to the
  port's unsharded step.
- MoE: ``moe_fwd`` of a DeepSeekMoE smoke at B·T = 8192 (the shard_map
  path) at capacity factor 1.0, where the local capacity drops tokens, and
  its aux loss; the reference runs in a subprocess with 4 host devices.

Tolerances (ROADMAP, fp32): forward and decode logits 1e-4 of the
largest magnitude, losses 1e-5 relative, gradients 1e-4 of each leaf's
largest magnitude; the MoE output 1e-4 of its largest, its aux 1e-5.
The ranks run ``tests/_sharded_worker.py``.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.models import blocks as JB
from repro.models import transformer as JTF
from repro.train import step as JS

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DENSE = "mistral_nemo_12b"
DENSE_OVER = dict(dtype="float32", n_kv_heads=1)
MOE = "deepseek_moe_16b"
MOE_OVER = dict(dtype="float32", capacity_factor=1.0)
B, T, TP, NEW = 2, 16, 5, 3
SCANS = {"rwkv6_7b": dict(dtype="float32", chunk_threshold=8, scan_chunk=4),
         "jamba_1_5_large_398b": dict(dtype="float32", chunk_threshold=8,
                                      scan_chunk=4, attn_kv_chunk=4)}

_MOE_REF = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import blocks as B
import dataclasses
cfg = dataclasses.replace(get_config(sys.argv[1], reduced=True),
                          **eval(sys.argv[2]))
assert jax.device_count() == 4
z = dict(np.load(sys.argv[3]))
p = {}
for k, v in z.items():
    if k.startswith("p/"):
        *keys, last = k[2:].split("/")
        node = p
        for kk in keys:
            node = node.setdefault(kk, {})
        node[last] = jnp.asarray(v)
mesh = jax.make_mesh((2, 2), ("data", "model"))
y = B.moe_fwd(cfg, p, jnp.asarray(z["x"]), mesh)
np.savez(sys.argv[4], y=np.asarray(y), aux=np.asarray(B.moe_fwd.aux))
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def run():
    """The reference's outputs and the 4 ranks' results, computed once."""
    tmp = tempfile.mkdtemp()
    # the MoE reference under its own 4-device mesh, in a subprocess that
    # runs beside the ranks
    jmoe = dataclasses.replace(jax_get_config(MOE, reduced=True), **MOE_OVER)
    p = JB.moe_init(jmoe, jax.random.PRNGKey(3))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4),
                                     (4, 2048, jmoe.d_model)))
    moe_in, moe_out = (os.path.join(tmp, f) for f in ("in.npz", "out.npz"))
    np.savez(moe_in, x=x, **{"p/" + k: v for k, v in _paths(_np(p))})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _MOE_REF, MOE,
                             repr(MOE_OVER), moe_in, moe_out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    # the dense reference, unsharded
    jcfg = dataclasses.replace(jax_get_config(DENSE, reduced=True),
                               **DENSE_OVER)
    params = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    prompts = tokens[:, :TP]
    batch = {"tokens": tokens,
             "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
    ref = {"forward": np.asarray(JTF.forward(params, tokens, jcfg)[0])}
    state = JTF.init_decode_state(jcfg, B, TP + NEW)
    steps, tok = [], None
    for t in range(TP + NEW - 1):
        tok = prompts[:, t] if t < TP else tok
        lg, state = JTF.decode_step(params, state, tok, t, jcfg)
        steps.append(np.asarray(lg))
        tok = steps[-1].argmax(-1).astype(np.int32)
    ref["decode"] = np.stack(steps)
    (loss, _), grads = jax.value_and_grad(JTF.loss_fn, has_aux=True)(
        params, jax.tree.map(jax.numpy.asarray, batch), jcfg)
    ref["loss"] = float(loss)
    ref["grads"] = dict(_paths(_np(grads)))
    jstate = JS.make_train_state(jcfg, jax.random.PRNGKey(0))
    jstate = jstate._replace(params=params)
    _, jm = JS.build_train_step(jcfg, lr=1e-3, donate=False)(
        jstate, jax.tree.map(jax.numpy.asarray, batch))
    ref["step_loss"] = float(jm["loss"])
    ref["step_grad_norm"] = float(jm["grad_norm"])

    # the RWKV-6 and Jamba smokes through their chunked forms, unsharded
    scans = {}
    for i, (arch, over) in enumerate(SCANS.items()):
        scfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                                   **over)
        sparams = JTF.init_params(scfg, jax.random.PRNGKey(10 + i))
        stok = rs.randint(0, scfg.vocab_size, (B, T)).astype(np.int32)
        sbatch = {"tokens": stok,
                  "labels": np.roll(stok, -1, axis=1).astype(np.int32)}
        (sloss, _), sgrads = jax.value_and_grad(JTF.loss_fn, has_aux=True)(
            sparams, jax.tree.map(jax.numpy.asarray, sbatch), scfg)
        ref[arch] = {"forward": np.asarray(JTF.forward(sparams, stok,
                                                       scfg)[0]),
                     "loss": float(sloss), "grads": dict(_paths(_np(sgrads)))}
        scans[arch] = {"over": over, "params": _np(sparams),
                       "batch": sbatch}

    job = {"arch": DENSE, "over": DENSE_OVER, "params": _np(params),
           "tokens": tokens, "prompts": prompts, "max_new": NEW,
           "batch": batch, "moe_arch": MOE, "moe_over": MOE_OVER,
           "moe_p": _np(p), "moe_x": x, "scans": scans}
    out_path = os.path.join(tmp, "ranks.npz")
    sys.path.insert(0, str(HERE))
    import _sharded_worker
    mp.spawn(_sharded_worker.run,
             args=(os.path.join(tmp, "store"), job, out_path), nprocs=4)
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return ref, dict(np.load(moe_out)), dict(np.load(out_path))


# Whisper with one head and GLM-4 with one kv head: at batch 4 over
# (pod, data) neither leaves model a batch row or a head to split, so the
# attention splits its query rows over model (causal ones at each shard's
# offset); GLM-4's kv head is repeated for the q heads model splits
MULTI_POD = {"rwkv6_7b": SCANS["rwkv6_7b"],
             "jamba_1_5_large_398b": SCANS["jamba_1_5_large_398b"],
             "mistral_nemo_12b": dict(dtype="float32"),
             "whisper_base": dict(dtype="float32", n_heads=1, n_kv_heads=1),
             "glm4_9b": dict(dtype="float32")}


@pytest.fixture(scope="module")
def run_multi_pod():
    """The 8 ranks' unsharded and multi-pod results, computed once."""
    tmp = tempfile.mkdtemp()
    tokens = np.random.RandomState(2).randint(0, 1 << 30, (4, T)).astype(
        np.int32)
    job = {"multi_pod": MULTI_POD, "multi_pod_tokens": tokens}
    out_path = os.path.join(tmp, "ranks.npz")
    sys.path.insert(0, str(HERE))
    import _sharded_worker
    mp.spawn(_sharded_worker.run_multi_pod,
             args=(os.path.join(tmp, "store"), job, out_path), nprocs=8)
    return dict(np.load(out_path))


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def test_cache_is_sequence_sharded(run):
    _, _, got = run
    placements = list(got["cache_placements"])
    assert "S(3)" in placements, placements   # S over a mesh dim


def test_sharded_forward_matches_reference(run):
    ref, _, got = run
    _close(got["forward"], ref["forward"], 1e-4)


def test_every_sharded_decode_step_matches_reference(run):
    ref, _, got = run
    assert got["decode"].shape == ref["decode"].shape
    for i in range(ref["decode"].shape[0]):
        _close(got["decode"][i], ref["decode"][i], 1e-4)


def test_sharded_loss_and_gradients_match_reference(run):
    ref, _, got = run
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
    names = {k[5:] for k in got if k.startswith("grad/")}
    assert names == set(ref["grads"])
    for name in sorted(names):
        want = ref["grads"][name]
        err = np.abs(got[f"grad/{name}"] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), name


def test_sharded_train_step_matches_reference(run):
    ref, _, got = run
    np.testing.assert_allclose(float(got["step_loss"]), ref["step_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["step_grad_norm"]),
                               ref["step_grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("arch", list(SCANS))
def test_sharded_chunked_scans_match_reference(run, arch):
    """The chunked forms ran on the mesh (counted on each rank), and the
    forward, the loss and every gradient equal the reference's."""
    ref, _, got = run
    assert int(got[f"{arch}/chunked_calls"]) > 0
    _close(got[f"{arch}/forward"], ref[arch]["forward"], 1e-4)
    np.testing.assert_allclose(float(got[f"{arch}/loss"]), ref[arch]["loss"],
                               rtol=1e-5)
    prefix = f"{arch}/grad/"
    names = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert names == set(ref[arch]["grads"])
    for name in sorted(names):
        want = ref[arch]["grads"][name]
        err = np.abs(got[prefix + name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_moe_shard_map_twin_matches_reference_with_drops(run):
    _, moe, got = run
    _close(got["moe_y"], moe["y"], 1e-4)
    np.testing.assert_allclose(float(got["moe_aux"]), float(moe["aux"]),
                               rtol=1e-5)
    # capacity counts each device's tokens, so with drops the sharded
    # result is not the unsharded one (the reference's behaviour)
    assert np.abs(got["moe_y_unsharded"] - moe["y"]).max() > \
        1e-3 * np.abs(moe["y"]).max()


@pytest.mark.parametrize("arch", list(MULTI_POD))
def test_multi_pod_mesh_matches_one_device(run_multi_pod, arch):
    got = run_multi_pod
    np.testing.assert_allclose(float(got[f"{arch}/loss"]),
                               float(got[f"{arch}/loss0"]), rtol=1e-5)
    names = {k.split("/grad/", 1)[1] for k in got
             if k.startswith(f"{arch}/grad/")}
    assert names and names == {k.split("/grad0/", 1)[1] for k in got
                               if k.startswith(f"{arch}/grad0/")}
    for name in sorted(names):
        want = got[f"{arch}/grad0/{name}"]
        err = np.abs(got[f"{arch}/grad/{name}"] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)

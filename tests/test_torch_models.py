"""The port's decoder LMs (dense and RWKV-6; repro_torch.models / serve)
against the JAX reference (repro.models / serve) on the CPU: parameters
initialized by ``repro`` and converted, token inputs made by numpy from a
seed.  Plus the guards that keep the port apart from JAX and from
``repro``.

fp32 tolerance 1e-4 (tests/test_arch_smoke.py's decode-vs-forward bound)."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JTF
from repro.serve import engine as jengine
from repro_torch.configs import ARCH_IDS, PORTED_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as TF
from repro_torch.models.common import BlockSpec
from repro_torch.serve import engine, serve_lm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _setup(arch, dtype="float32", **over):
    """(jax cfg, jax params, port cfg, port params) for a smoke config."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype=dtype, **over)
    tcfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype,
                               **over)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, B, T, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_reference(arch, reduced):
    mine = get_config(arch, reduced=reduced)
    ref = jax_get_config(arch, reduced=reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.n_layers == ref.n_layers and mine.hd == ref.hd
    assert mine.n_params() == ref.n_params()


def test_unported_configs_raise():
    for arch in set(ARCH_IDS) - set(PORTED_IDS):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt5")
    assert get_config("mistral-nemo-12b").name == "mistral-nemo-12b"


# ---------------------------------------------------------------------------
# model parity, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED_IDS)
def test_forward_and_decode_match_reference(arch):
    jcfg, jparams, tcfg, tparams = _setup(arch)
    toks = _tokens(tcfg, 2, 12, seed=1)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    tlog, aux = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    assert tlog.dtype == torch.float32 and aux == 0.0
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)

    # every teacher-forced decode step against the reference's step
    jstep = jax.jit(lambda p, s, t, pos: JTF.decode_step(p, s, t, pos, jcfg))
    jstate = JTF.init_decode_state(jcfg, 2, 12)
    tstate = TF.init_decode_state(tcfg, 2, 12, device="cpu")
    for t in range(12):
        jl, jstate = jstep(jparams, jstate, jax.numpy.asarray(toks[:, t]), t)
        pos = t if t % 2 else torch.tensor(t, dtype=torch.int32)
        tl, tstate = TF.decode_step(tparams, tstate,
                                    torch.from_numpy(toks[:, t]), pos, tcfg)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_f32(tl), _f32(tlog[:, t]), rtol=TOL,
                                   atol=TOL)
    # every leaf of the state: KV caches, or RWKV's token shifts and wkv
    for key in jstate:
        assert set(tstate[key]) == set(jstate[key]), key
        for leaf in jstate[key]:
            assert tstate[key][leaf].dtype == \
                getattr(torch, np.asarray(jstate[key][leaf]).dtype.name)
            np.testing.assert_allclose(_f32(tstate[key][leaf]),
                                       _f32(jstate[key][leaf]),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_generate_matches_reference(arch):
    jcfg, jparams, tcfg, tparams = _setup(arch)
    prompts = _tokens(tcfg, 2, 5, seed=2)
    want = jengine.generate(jparams, jcfg, jax.numpy.asarray(prompts),
                            max_new=4)
    got = engine.generate(tparams, tcfg, torch.from_numpy(prompts), max_new=4)
    assert got.dtype == torch.int32 and got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_prefill_path_matches_reference():
    """Above chunk_threshold the CPU path streams attention over kv chunks,
    as the reference does."""
    over = dict(chunk_threshold=8, attn_kv_chunk=4)
    jcfg, jparams, tcfg, tparams = _setup("gemma2_9b", **over)
    toks = _tokens(tcfg, 1, 24, seed=3)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    for backend in ("kernel", "ref"):
        tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg,
                             backend=backend)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)


def _check_forward_bf16(arch):
    """bf16 weights and activations: both sides round every product and
    norm to bf16 (eps 2^-8 ≈ 3.9e-3), but XLA and PyTorch round at
    different places and sum in different orders, so logits of magnitude
    ~1 agree to a few bf16 ulps: 5e-2."""
    jcfg, jparams, tcfg, tparams = _setup(arch, "bfloat16")
    toks = _tokens(tcfg, 2, 8, seed=4)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=5e-2, atol=5e-2)


def test_forward_bf16_matches_reference():
    _check_forward_bf16("mistral_nemo_12b")


def test_rwkv_forward_bf16_matches_reference():
    """RWKV-6 in bf16: w is rounded to bf16 before the recurrence, as in
    the reference's forward."""
    _check_forward_bf16("rwkv6_7b")


def test_rwkv_chunked_path_matches_reference():
    """Above chunk_threshold the reference runs the recurrence over
    ``scan_chunk``-long chunks; the port's one loop over T gives the same
    logits, on either backend and at a T that is no multiple of the chunk."""
    over = dict(chunk_threshold=8, scan_chunk=4)
    jcfg, jparams, tcfg, tparams = _setup("rwkv6_7b", **over)
    toks = _tokens(tcfg, 1, 24, seed=3)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    for backend in ("kernel", "ref"):
        tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg,
                             backend=backend)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    # the reference's chunks need T % scan_chunk == 0; its unchunked
    # recurrence takes the ragged T the port takes above the threshold
    ragged = _tokens(tcfg, 1, 23, seed=3)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(ragged),
                          dataclasses.replace(jcfg, chunk_threshold=0))
    tlog, _ = TF.forward(tparams, torch.from_numpy(ragged), tcfg)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# entry points and guards
# ---------------------------------------------------------------------------

def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mistral_nemo_12b", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TF.init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_lm.main(["--new", "2"])


def _check_init_params(arch):
    cfg = get_config(arch, reduced=True)
    a = TF.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TF.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    meta = TF.init_params(cfg, device="meta")
    ref = jax.eval_shape(lambda: JTF.init_params(
        jax_get_config(arch, reduced=True), jax.random.PRNGKey(0)))
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(ref)}
    flat, flat_b, flat_meta = (
        {jax.tree_util.keystr(k): v for k, v in
         jax.tree_util.tree_leaves_with_path(tree)} for tree in (a, b, meta))
    assert set(flat) == set(flat_ref) == set(flat_meta)
    for k, v in flat.items():
        assert tuple(v.shape) == flat_ref[k].shape, k
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, flat_b[k]), k     # same seed, same weights
        assert flat_meta[k].device.type == "meta"
    return a, flat_ref


def test_init_params_shapes_and_seed():
    a, _ = _check_init_params("gemma2_9b")
    assert "ffn" in a["layers"]["pos0"]


def test_rwkv_init_params_shapes_and_seed():
    a, flat_ref = _check_init_params("rwkv6_7b")
    assert set(a["layers"]["pos0"]) == {"core"}     # channel mix inside
    core = a["layers"]["pos0"]["core"]
    assert torch.equal(core["time_decay"],
                       torch.full_like(core["time_decay"], -4.0))
    assert any("w_lora_a" in k for k in flat_ref)


def test_params_from_jax_takes_the_rwkv_tree():
    """The RWKV pytree converts leaf by leaf, unchanged: the same keys,
    shapes, dtypes and bits as repro's init."""
    jcfg = jax_get_config("rwkv6_7b", reduced=True)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, jparams)
    got = params_from_jax(tree, get_config("rwkv6_7b", reduced=True),
                          device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(got)}
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(tree)}
    assert set(flat) == set(flat_ref) and len(flat) == 15
    for k, v in flat.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      flat_ref[k].astype(np.float32))
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["pos0"]["ffn"] = bad["layers"]["pos0"]["core"]["ck"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(bad, get_config("rwkv6_7b", reduced=True),
                        device="cpu")


def test_unsupported_features_raise():
    cfg = get_config("mistral_nemo_12b", reduced=True)
    params = TF.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="prefix_embeds"):
        TF.forward(params, toks, cfg, prefix_embeds=torch.zeros(1, 2, 64))
    with pytest.raises(ValueError, match="backend"):
        TF.forward(params, toks, cfg, backend="pallas")
    for spec in (BlockSpec(kind="mamba"), BlockSpec(moe=True)):
        bad = dataclasses.replace(cfg, layer_pattern=(spec,))
        with pytest.raises(NotImplementedError):
            TF.init_params(bad, device="cpu")


def test_convert_rejects_mismatched_tree():
    jcfg = _fp32(jax_get_config("glm4_9b", reduced=True))
    tree = jax.tree.map(np.asarray, JTF.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = _fp32(get_config("mistral_nemo_12b", reduced=True))
    with pytest.raises(ValueError, match="expected"):
        params_from_jax(tree, tcfg, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, _fp32(get_config("glm4_9b", reduced=True)),
                        device="cpu")


def test_serve_lm_twin_runs_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu", "--batch", "2",
                         "--prompt-len", "3", "--new", "2"])
    assert out.shape == (2, 5)
    assert "tok/s on CPU" in capsys.readouterr().out


def test_serve_lm_twin_runs_rwkv_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", "rwkv6_7b",
                         "--batch", "2", "--prompt-len", "3", "--new", "2"])
    assert out.shape == (2, 5)
    printed = capsys.readouterr().out
    assert "arch=rwkv6-smoke" in printed and "tok/s on CPU" in printed


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro_ast():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_port_imports_neither_jax_nor_repro_at_runtime():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15

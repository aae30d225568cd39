"""The five decoder configs that serve at full width on the card — Gemma-7B,
GLM-4-9B, Gemma-2-9B, DeepSeek-MoE-16B and Llama-4-Scout — held to the JAX
reference on the CPU at their full models' attention and expert geometry
(heads, kv heads, head_dim, softcaps, post-block norms, activation, tied and
scaled embeddings, experts, top-k, shared experts, capacity factor,
``rope_theta``) and narrow widths: d_model 64, d_ff 128, expert d_ff 32,
vocab 512, one period, T = 48.  Weights are made by ``repro`` and
converted; tokens come from numpy with a seed.

fp32 tolerance 1e-4 (tests/test_arch_smoke.py:86)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JTF
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import autotile
from repro_torch.models import transformer as TF
from repro_torch.models.common import BlockSpec

TOL = 1e-4
T = 48
GEOMETRY_IDS = ("gemma_7b", "glm4_9b", "gemma2_9b", "deepseek_moe_16b",
                "llama4_scout_17b_a16e")
MOE = ("deepseek_moe_16b", "llama4_scout_17b_a16e")


def _narrow(cfg, window=None, **over):
    """``cfg`` at d_model 64, d_ff 128, expert d_ff 32, vocab 512 and one
    period, in fp32; everything else as the full model has it.  ``window``
    replaces the window of the pattern's windowed layers."""
    narrow = dict(d_model=64, d_ff=128, vocab_size=512, n_periods=1,
                  dtype="float32", remat=False)
    if cfg.n_experts:
        narrow["d_ff_expert"] = 32
    if window is not None:
        narrow["layer_pattern"] = tuple(
            dataclasses.replace(s, window=window) if s.window else s
            for s in cfg.layer_pattern)
    return dataclasses.replace(cfg, **{**narrow, **over})


def _setup(arch, **over):
    """(jax cfg, jax params, port cfg, port params)."""
    jcfg = _narrow(jax_get_config(arch), **over)
    tcfg = _narrow(get_config(arch), **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, B, n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, cfg.vocab_size, size=(B, n)).astype(np.int32)


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _decode_steps(jcfg, jparams, tcfg, tparams, toks):
    """Every teacher-forced decode step of both packages: (port logits,
    reference logits), each (B, n, V)."""
    B, n = toks.shape
    jstep = jax.jit(lambda p, s, t, pos: JTF.decode_step(p, s, t, pos, jcfg))
    jstate = JTF.init_decode_state(jcfg, B, n)
    tstate = TF.init_decode_state(tcfg, B, n, device="cpu")
    got, want = [], []
    for t in range(n):
        jl, jstate = jstep(jparams, jstate, jax.numpy.asarray(toks[:, t]), t)
        pos = t if t % 2 else torch.tensor(t, dtype=torch.int32)
        tl, tstate = TF.decode_step(tparams, tstate,
                                    torch.from_numpy(toks[:, t]), pos, tcfg)
        got.append(_f32(tl))
        want.append(_f32(jl))
    return np.stack(got, 1), np.stack(want, 1)


def test_geometries_are_the_full_models():
    """What the narrow configs keep of the full ones, and the K2 cases they
    reach on the card."""
    for arch in GEOMETRY_IDS:
        full, cfg = get_config(arch), _narrow(get_config(arch))
        for f in ("n_heads", "n_kv_heads", "hd", "attn_softcap",
                  "final_softcap", "post_block_norm", "activation", "glu",
                  "tie_embeddings", "scale_embeddings", "n_experts", "top_k",
                  "n_shared_experts", "capacity_factor", "rope_theta",
                  "layer_pattern"):
            assert getattr(cfg, f) == getattr(full, f), (arch, f)
    group = {a: get_config(a).n_heads // get_config(a).n_kv_heads
             for a in GEOMETRY_IDS}
    assert group == {"gemma_7b": 1, "glm4_9b": 16, "gemma2_9b": 2,
                     "deepseek_moe_16b": 1, "llama4_scout_17b_a16e": 5}
    # GLM-4's group takes two decode blocks of 8 rows, Llama-4-Scout's one
    # block of 8 with 3 rows padded; head_dim 256 prefill on one bf16 tile
    assert autotile.decode_rows(16) == 8 and autotile.decode_rows(5) == 8
    assert autotile.attention_built_tiles(256, 2) == ((64, 64),)
    assert get_config("gemma2_9b").layer_pattern[0].window == 4096


@pytest.mark.parametrize("arch", GEOMETRY_IDS)
def test_forward_and_decode_match_reference(arch):
    """The fp32 forward and MoE aux loss, and every teacher-forced decode
    step (batch 2, T = 48), against the reference's; without MoE each step
    also against the port's own forward."""
    jcfg, jparams, tcfg, tparams = _setup(arch)
    toks = _tokens(tcfg, 2, T, seed=1)
    jlog, jaux = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    tlog, aux = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    assert tlog.shape == (2, T, tcfg.vocab_size)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    assert (arch in MOE) == (float(aux) > 0)
    got, want = _decode_steps(jcfg, jparams, tcfg, tparams, toks)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if arch not in MOE:
        np.testing.assert_allclose(got, _f32(tlog), rtol=TOL, atol=TOL)


def no_drop_factor(cfg) -> float:
    """The capacity factor E / k, at which every capacity is the token count
    (``moe_capacity``), so nothing drops at any batch.  8.0 is not enough
    for Llama-4-Scout's top-1 of 16 experts: a decode step at batch 2 then
    has one slot an expert, and two tokens choosing one expert drop one."""
    return cfg.n_experts / cfg.top_k


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward_without_drops(arch):
    """At capacity factor E / k neither the forward nor a decode step drops
    a token, so every teacher-forced step equals the forward (as
    tests/test_arch_smoke.py holds the reference)."""
    factor = no_drop_factor(get_config(arch))
    jcfg, jparams, tcfg, tparams = _setup(arch, capacity_factor=factor)
    toks = _tokens(tcfg, 2, T, seed=2)
    tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    got, want = _decode_steps(jcfg, jparams, tcfg, tparams, toks)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _f32(tlog), rtol=TOL, atol=TOL)


def test_gemma2_window_bites_at_head_dim_256():
    """Gemma-2 with its local layers' window cut to 16 (T = 48 reaches past
    it) at head_dim 256 and GQA group 2: forward and every decode step
    against the reference; the window changes the logits."""
    jcfg, jparams, tcfg, tparams = _setup("gemma2_9b", window=16)
    assert tcfg.hd == 256 and tcfg.n_heads // tcfg.n_kv_heads == 2
    assert [s.window for s in tcfg.layer_pattern] == [16, None]
    toks = _tokens(tcfg, 2, T, seed=3)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    got, want = _decode_steps(jcfg, jparams, tcfg, tparams, toks)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _f32(tlog), rtol=TOL, atol=TOL)
    # the same weights without the window: the logits past position 16 move
    wide = dataclasses.replace(tcfg, layer_pattern=(BlockSpec(kind="attn"),) * 2)
    full, _ = TF.forward(tparams, torch.from_numpy(toks), wide)
    assert np.allclose(_f32(full)[:, :16], _f32(tlog)[:, :16], rtol=TOL,
                       atol=TOL)
    assert not np.allclose(_f32(full)[:, 16:], _f32(tlog)[:, 16:],
                           rtol=TOL, atol=TOL)


def test_deepseek_decode_drops_match_reference():
    """DeepSeek-MoE at batch 4 and its capacity factor 1.25: a decode step
    routes 4 tokens, so each of the 64 experts takes one (capacity
    max(1, ceil(4·6·1.25/64)) = 1) and a second token choosing it is
    dropped.  Every step equals the reference's (the same tokens dropped),
    and the drops are real: the steps differ from those at capacity
    factor E / k, which drop nothing."""
    jcfg, jparams, tcfg, tparams = _setup("deepseek_moe_16b")
    assert tcfg.capacity_factor == 1.25
    toks = _tokens(tcfg, 4, 16, seed=4)
    got, want = _decode_steps(jcfg, jparams, tcfg, tparams, toks)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    factor = no_drop_factor(tcfg)
    undropped, _ = _decode_steps(
        dataclasses.replace(jcfg, capacity_factor=factor), jparams,
        dataclasses.replace(tcfg, capacity_factor=factor), tparams, toks)
    moved = ~np.isclose(got, undropped, rtol=TOL, atol=TOL).all(-1)
    assert moved.any(), "no decode step dropped a token"
    assert moved.sum() < moved.size

"""The port's models (the decoder LMs — dense, RWKV-6, the Jamba hybrid,
the MoE LMs, Phi-3-vision with its prefix — and the Whisper
encoder-decoder; repro_torch.models / serve) against the JAX reference
(repro.models / serve) on the CPU: parameters initialized by ``repro`` and
converted, token and embedding inputs made by numpy from a seed.  Plus the
guards that keep the port apart from JAX and from ``repro``.

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
from repro.models import blocks as JB
from repro.models import encdec as JED
from repro.models import transformer as JTF
from repro.serve import engine as jengine
from repro_torch.configs import ARCH_IDS, PORTED_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import blocks as TB
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.common import BlockSpec, ModelConfig
from repro_torch.serve import engine, serve_lm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
DECODER_IDS = [a for a in PORTED_IDS
               if not get_config(a, reduced=True).is_encoder_decoder]
MOE_IDS = [a for a in PORTED_IDS
           if any(s.moe for s in get_config(a, reduced=True).layer_pattern)]


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
    assert get_config("whisper-base").is_encoder_decoder
    assert get_config("phi-3-vision-4.2b").prefix_len == 576


# ---------------------------------------------------------------------------
# model parity, fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_IDS)
def test_forward_and_decode_match_reference(arch):
    jcfg, jparams, tcfg, tparams = _setup(arch)
    toks = _tokens(tcfg, 2, 12, seed=1)
    jlog, jaux = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    tlog, aux = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    assert tlog.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    # the MoE aux loss summed over layers; 0 without MoE layers
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    assert (arch in MOE_IDS) == (float(aux) > 0)

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
        if arch not in MOE_IDS:   # see test_decode_matches_forward_moe
            np.testing.assert_allclose(_f32(tl), _f32(tlog[:, t]), rtol=TOL,
                                       atol=TOL)
    # every leaf of the state: KV caches, Mamba's conv window and ssm
    # state, or RWKV's token shifts and wkv
    for key in jstate:
        assert set(tstate[key]) == set(jstate[key]), key
        for leaf in jstate[key]:
            assert tstate[key][leaf].dtype == \
                getattr(torch, np.asarray(jstate[key][leaf]).dtype.name)
            np.testing.assert_allclose(_f32(tstate[key][leaf]),
                                       _f32(jstate[key][leaf]),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_generate_matches_reference(arch):
    jcfg, jparams, tcfg, tparams = _setup(arch)
    prompts = _tokens(tcfg, 2, 5, seed=2)
    want = jengine.generate(jparams, jcfg, jax.numpy.asarray(prompts),
                            max_new=4)
    got = engine.generate(tparams, tcfg, torch.from_numpy(prompts), max_new=4)
    assert got.dtype == torch.int32 and got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE_IDS)
def test_decode_matches_forward_moe(arch):
    """A decode step routes B tokens, the forward B·T, so their capacities
    and drops differ by design (at batch 2 and the config's factor a step
    drops nothing, the forward may).  At capacity_factor 8.0 neither drops,
    and every teacher-forced step matches the forward, as
    tests/test_arch_smoke.py:68-89 holds the reference."""
    jcfg, jparams, tcfg, tparams = _setup(arch, capacity_factor=8.0)
    toks = _tokens(tcfg, 2, 10, seed=5)
    tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)
    state = TF.init_decode_state(tcfg, 2, 10, device="cpu")
    for t in range(10):
        tl, state = TF.decode_step(tparams, state,
                                   torch.from_numpy(toks[:, t]), t, tcfg)
        np.testing.assert_allclose(_f32(tl), _f32(tlog[:, t]), rtol=TOL,
                                   atol=TOL)


def _zero_routers(tree):
    for pos in tree["layers"].values():
        if "router" in pos.get("ffn", {}):
            pos["ffn"]["router"]["w"] = np.zeros_like(pos["ffn"]["router"]["w"])
    return tree


@pytest.mark.parametrize("arch", MOE_IDS)
@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_moe_ties_and_drops_match_reference(arch, factor):
    """Router weights zeroed in both packages: every expert ties, so top-k
    must take the lowest indices (jax.lax.top_k's rule), every token picks
    experts 0…k−1, and at capacity_factor 1.25 the tokens past capacity C
    are dropped — the same tokens in both."""
    jcfg, jparams, tcfg, _ = _setup(arch, capacity_factor=factor)
    tree = _zero_routers(jax.tree.map(np.asarray, jparams))
    tparams = params_from_jax(tree, tcfg, device="cpu")
    i = next(i for i, s in enumerate(tcfg.layer_pattern) if s.moe)
    pj = jax.tree.map(lambda a: jax.numpy.asarray(a[0]),
                      tree["layers"][f"pos{i}"]["ffn"])
    pt = TF._period(tparams["layers"], 0)[f"pos{i}"]["ffn"]
    x = np.random.RandomState(6).standard_normal(
        (3, 8, tcfg.d_model)).astype(np.float32)
    got, aux = TB.moe_fwd(tcfg, pt, torch.from_numpy(x))
    want = JB.moe_fwd(jcfg, pj, jax.numpy.asarray(x))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(JB.moe_fwd.aux), rtol=1e-6)
    # the routed experts alone (no shared path): a dropped token's row is
    # exactly zero in both
    n_tok, k, E = 24, tcfg.top_k, tcfg.n_experts
    ht = torch.from_numpy(x.reshape(n_tok, -1))
    routed = {key: v for key, v in pt.items() if key != "shared"}
    y, _ = TB._moe_local(tcfg, routed, ht)
    y_j, _ = JB._moe_local(jcfg, {key: v for key, v in pj.items()
                                  if key != "shared"}, jax.numpy.asarray(ht))
    np.testing.assert_allclose(_f32(y), _f32(y_j), rtol=TOL, atol=TOL)
    C = max(1, min(int(np.ceil(n_tok * k * factor / E)), n_tok))
    dropped = (y == 0).all(dim=-1)
    assert dropped.tolist() == [t >= C for t in range(n_tok)]
    assert dropped.tolist() == (_f32(y_j) == 0).all(-1).tolist()
    assert dropped.any() == (factor == 1.25)


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


def test_jamba_forward_bf16_matches_reference():
    """Jamba in bf16: dt enters the scan in bf16, A_log and D stay fp32,
    and every silu and softplus rounds op by op, as the reference's code
    does.  Held against the reference run op by op (``jax.disable_jit``):
    inside its compiled period scan XLA keeps fp32 excess precision in
    fused elementwise chains, and at this input a router near-tie then
    flips a top-2 choice, so the compiled reference differs from its own
    op-by-op run by far more than the bound (0.43 past it at this input).
    The fp32 tests hold the compiled forward at 1e-4."""
    jcfg, jparams, tcfg, tparams = _setup("jamba_1_5_large_398b", "bfloat16")
    toks = _tokens(tcfg, 2, 8, seed=4)
    with jax.disable_jit():
        jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg)
    tlog, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    core = tparams["layers"]["pos0"]["core"]
    assert core["in_proj"]["w"].dtype == torch.bfloat16
    assert core["A_log"].dtype == core["D"].dtype == torch.float32
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=5e-2, atol=5e-2)


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
# vision prefix (Phi-3-vision) and encoder-decoder (Whisper)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", 5e-2)])
def test_prefix_forward_matches_reference(dtype, tol):
    """Phi-3-vision's patch embeddings go before the token embeddings and
    the positions run over both; bf16 at _check_forward_bf16's bound."""
    jcfg, jparams, tcfg, tparams = _setup("phi_3_vision_4_2b", dtype)
    toks = _tokens(tcfg, 2, 8, seed=8)
    prefix = np.random.RandomState(9).standard_normal(
        (2, tcfg.prefix_len, tcfg.d_model)).astype(np.float32)
    jlog, _ = JTF.forward(jparams, jax.numpy.asarray(toks), jcfg,
                          prefix_embeds=jax.numpy.asarray(prefix))
    tlog, aux = TF.forward(tparams, torch.from_numpy(toks), tcfg,
                           prefix_embeds=torch.from_numpy(prefix))
    assert tlog.shape == (2, tcfg.prefix_len + 8, tcfg.vocab_size)
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=tol, atol=tol)
    # the tokens' logits differ from a forward without the prefix
    plain, _ = TF.forward(tparams, torch.from_numpy(toks), tcfg)
    assert not torch.allclose(plain, tlog[:, tcfg.prefix_len:], atol=1e-2)


def _setup_encdec(dtype="float32"):
    """(jax cfg, jax params, port cfg, port params) for whisper's smoke
    config."""
    jcfg = dataclasses.replace(jax_get_config("whisper_base", reduced=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(get_config("whisper_base", reduced=True),
                               dtype=dtype)
    jparams = JED.init_params_encdec(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _frames(cfg, B, T, seed=10):
    return np.random.RandomState(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def test_encdec_forward_and_decode_match_reference():
    """Whisper smoke in fp32 over a ragged encoder length (30 of 32
    frames): encode, forward_encdec, every teacher-forced decode step and
    every cache leaf against the reference, and the steps against the
    port's own forward."""
    jcfg, jparams, tcfg, tparams = _setup_encdec()
    frames, toks = _frames(tcfg, 2, 30), _tokens(tcfg, 2, 10, seed=11)
    jenc = JED.encode(jparams, jax.numpy.asarray(frames), jcfg)
    enc = ED.encode(tparams, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(_f32(enc), _f32(jenc), rtol=TOL, atol=TOL)
    jlog = JED.forward_encdec(jparams, jax.numpy.asarray(toks),
                              jax.numpy.asarray(frames), jcfg)
    tlog = ED.forward_encdec(tparams, torch.from_numpy(toks),
                             torch.from_numpy(frames), tcfg)
    assert tlog.shape == (2, 10, tcfg.vocab_size)
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=TOL, atol=TOL)

    jstep = jax.jit(lambda p, s, t, pos, e: JED.decode_step_encdec(
        p, s, t, pos, e, jcfg))
    jstate = JED.init_decode_state_encdec(jcfg, 2, 10)
    tstate = ED.init_decode_state_encdec(tcfg, 2, 10, device="cpu")
    for t in range(10):
        jl, jstate = jstep(jparams, jstate, jax.numpy.asarray(toks[:, t]), t,
                           jenc)
        pos = t if t % 2 else torch.tensor(t, dtype=torch.int32)
        tl, tstate = ED.decode_step_encdec(
            tparams, tstate, torch.from_numpy(toks[:, t]), pos, enc, tcfg)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_f32(tl), _f32(tlog[:, t]), rtol=TOL,
                                   atol=TOL)
    assert set(tstate) == set(jstate) == {"k", "v"}
    for leaf in jstate:
        assert tstate[leaf].shape == jstate[leaf].shape
        np.testing.assert_allclose(_f32(tstate[leaf]), _f32(jstate[leaf]),
                                   rtol=TOL, atol=TOL)


def test_encdec_serve_step_matches_reference():
    """build_serve_step's encoder-decoder step, step(params, state, token,
    pos, enc_out) (the contract of tests/test_serve_sim.py:674), driven
    through a teacher-forced + greedy loop in both packages: the same
    tokens."""
    jcfg, jparams, tcfg, tparams = _setup_encdec()
    frames, prompt = _frames(tcfg, 2, 32, seed=12), _tokens(tcfg, 2, 4, 13)
    jstep, _ = jengine.build_serve_step(jcfg)
    tstep = engine.build_serve_step(tcfg)
    jenc = JED.encode(jparams, jax.numpy.asarray(frames), jcfg)
    enc = ED.encode(tparams, torch.from_numpy(frames), tcfg)
    jstate = JED.init_decode_state_encdec(jcfg, 2, 9)
    tstate = ED.init_decode_state_encdec(tcfg, 2, 9, device="cpu")
    before = {k: v.shape for k, v in tstate.items()}
    pos = torch.zeros((), dtype=torch.int32)
    jtoks, ttoks = [prompt[:, 0]], [prompt[:, 0]]
    for t in range(8):
        jl, jstate = jstep(jparams, jstate, jax.numpy.asarray(jtoks[-1]), t,
                           jenc)
        tl, tstate = tstep(tparams, tstate, torch.from_numpy(ttoks[-1]), pos,
                           enc)
        pos += 1
        assert tl.shape == (2, tcfg.vocab_size) and tl.dtype == torch.float32
        nxt = t + 1 < 4
        jtoks.append(prompt[:, t + 1] if nxt else
                     np.asarray(jax.numpy.argmax(jl, -1), np.int32))
        ttoks.append(prompt[:, t + 1] if nxt else
                     tl.argmax(-1).to(torch.int32).numpy())
    np.testing.assert_array_equal(np.stack(ttoks, 1), np.stack(jtoks, 1))
    assert {k: v.shape for k, v in tstate.items()} == before


def test_encdec_forward_bf16_matches_reference():
    """Whisper in bf16 (plain tanh GELU, no GLU), at _check_forward_bf16's
    bound; logits stay in the model dtype, as the reference returns them."""
    jcfg, jparams, tcfg, tparams = _setup_encdec("bfloat16")
    frames, toks = _frames(tcfg, 2, 32, seed=14), _tokens(tcfg, 2, 8, 15)
    jlog = JED.forward_encdec(jparams, jax.numpy.asarray(toks),
                              jax.numpy.asarray(frames), jcfg)
    tlog = ED.forward_encdec(tparams, torch.from_numpy(toks),
                             torch.from_numpy(frames), tcfg)
    assert tlog.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), rtol=5e-2, atol=5e-2)


def test_encdec_init_params_shapes_and_seed():
    cfg = get_config("whisper_base", reduced=True)
    a = ED.init_params_encdec(cfg, torch.Generator().manual_seed(3), "cpu")
    b = ED.init_params_encdec(cfg, torch.Generator().manual_seed(3), "cpu")
    meta = ED.init_params_encdec(cfg, device="meta")
    ref = jax.eval_shape(lambda: JED.init_params_encdec(
        jax_get_config("whisper_base", reduced=True), jax.random.PRNGKey(0)))
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(ref)}
    flat, flat_b, flat_meta = (
        {jax.tree_util.keystr(k): v for k, v in
         jax.tree_util.tree_leaves_with_path(tree)} for tree in (a, b, meta))
    assert set(flat) == set(flat_ref) == set(flat_meta)
    for k, v in flat.items():
        assert tuple(v.shape) == flat_ref[k].shape, k
        assert v.dtype == getattr(torch, flat_ref[k].dtype.name), k
        assert torch.equal(v, flat_b[k]), k
        assert flat_meta[k].device.type == "meta"
    assert a["enc"]["self"]["wq"]["w"].shape[0] == cfg.n_enc_layers
    assert a["dec"]["cross"]["wkv"]["w"].shape == \
        (cfg.n_layers, cfg.d_model, 2 * cfg.n_kv_heads * cfg.hd)


def test_params_from_jax_takes_the_encdec_tree():
    """The encoder-decoder pytree converts leaf by leaf, bits unchanged; a
    decoder LM's tree, or one missing the cross block, is refused."""
    jcfg = jax_get_config("whisper_base", reduced=True)
    cfg = get_config("whisper_base", reduced=True)
    tree = jax.tree.map(np.asarray, JED.init_params_encdec(
        jcfg, jax.random.PRNGKey(7)))
    got = params_from_jax(tree, cfg, device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(got)}
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(tree)}
    assert set(flat) == set(flat_ref) and len(flat) == 23
    for k, v in flat.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(v.float().numpy(),
                                      flat_ref[k].astype(np.float32))
    dec_tree = jax.tree.map(np.asarray, JTF.init_params(
        jax_get_config("phi_3_vision_4_2b", reduced=True),
        jax.random.PRNGKey(7)))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(dec_tree, cfg, device="cpu")
    del tree["dec"]["cross"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, cfg, device="cpu")


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
    ed_cfg = get_config("whisper_base", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        ED.init_params_encdec(ed_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        ED.init_decode_state_encdec(ed_cfg, 1, 8)


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
        assert v.dtype == getattr(torch, flat_ref[k].dtype.name), k
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


def test_jamba_init_params_shapes_and_seed():
    a, _ = _check_init_params("jamba_1_5_large_398b")
    cfg = get_config("jamba_1_5_large_398b", reduced=True)
    core = a["layers"]["pos0"]["core"]
    assert core["A_log"].dtype == core["D"].dtype == torch.float32
    assert torch.equal(core["A_log"][0, 3],
                       torch.log(torch.arange(1, cfg.d_state + 1,
                                              dtype=torch.float32)))
    assert torch.equal(core["D"], torch.ones_like(core["D"]))
    assert torch.equal(core["dt_proj"]["bias"],
                       torch.full_like(core["dt_proj"]["bias"], -3.0))
    assert a["layers"]["pos1"]["ffn"]["experts"]["w_up"].shape == \
        (1, cfg.n_experts, cfg.d_model, cfg.d_ff_e)


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "deepseek_moe_16b",
                                  "llama4_scout_17b_a16e"])
def test_params_from_jax_takes_the_hybrid_and_moe_trees(arch):
    """Stacked (n_periods, E, d, f) experts, the fp32 A_log and D of a bf16
    model and the ``shared`` sub-tree convert leaf by leaf, bits unchanged."""
    jcfg = jax_get_config(arch, reduced=True)
    tree = jax.tree.map(np.asarray, JTF.init_params(jcfg,
                                                    jax.random.PRNGKey(7)))
    got = params_from_jax(tree, get_config(arch, reduced=True), device="cpu")
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(got)}
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(tree)}
    assert set(flat) == set(flat_ref)
    for k, v in flat.items():
        assert v.dtype == getattr(torch, flat_ref[k].dtype.name), k
        np.testing.assert_array_equal(v.float().numpy(),
                                      flat_ref[k].astype(np.float32))
    dtypes = {k.split("']['")[-1].rstrip("']"): v.dtype
              for k, v in flat.items()}
    if jcfg.n_shared_experts:
        assert any("['shared']" in k for k in flat)
    if arch.startswith("jamba"):
        assert dtypes["A_log"] == dtypes["D"] == torch.float32
    w_up = got["layers"]["pos1" if arch.startswith("jamba") else "pos0"][
        "ffn"]["experts"]["w_up"]
    assert w_up.shape == (jcfg.n_periods, jcfg.n_experts, jcfg.d_model,
                          jcfg.d_ff_e)


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
    with pytest.raises(ValueError, match="backend"):
        TF.forward(params, toks, cfg, backend="pallas")
    # an encoder-decoder config (whisper_base's, rebuilt from the
    # reference's in the port's types) belongs to models/encdec.py
    ref = jax_get_config("whisper_base", reduced=True)
    fields = {f.name: getattr(ref, f.name)
              for f in dataclasses.fields(ModelConfig)}
    fields["layer_pattern"] = tuple(BlockSpec(**dataclasses.asdict(s))
                                    for s in ref.layer_pattern)
    ed_cfg = ModelConfig(**fields)
    assert ed_cfg == get_config("whisper_base", reduced=True)
    for fn in (lambda: TF.init_params(ed_cfg, device="cpu"),
               lambda: TF.forward(params, toks, ed_cfg),
               lambda: TF.init_decode_state(ed_cfg, 1, 4, device="cpu")):
        with pytest.raises(ValueError, match="models/encdec.py"):
            fn()
    with pytest.raises(ValueError, match="decoder-only"):
        engine.generate(params, ed_cfg, toks, max_new=2)


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
    """With no --arch the twin serves Jamba, as examples/serve_lm.py does."""
    out = serve_lm.main(["--device", "cpu", "--batch", "2",
                         "--prompt-len", "3", "--new", "2"])
    assert out.shape == (2, 5)
    printed = capsys.readouterr().out
    assert "tok/s on CPU" in printed
    jamba = get_config("jamba_1_5_large_398b", reduced=True).name
    assert printed.startswith(f"arch={jamba} ")


def test_serve_lm_twin_prints_the_reference_examples_tokens():
    """examples/serve_lm.py at its defaults (Jamba smoke config in bf16,
    batch 4, prompt 16, 24 new tokens, parameters from PRNGKey(0), prompts
    from PRNGKey(1)): the twin, given the same parameters converted and the
    same prompts, prints the same sample token ids as the reference's
    compiled ``generate``, which the example prints.  Every token of every
    row is held against the reference run op by op (``jax.disable_jit``):
    the compiled step keeps fp32 excess precision inside its fusions, and
    at these inputs a bf16 router near-tie flips a later token (past the
    printed 12) against its own op-by-op run."""
    arch, B, Tp, new = "jamba_1_5_large_398b", 4, 16, 24
    jcfg = jax_get_config(arch, reduced=True)
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    jprompts = jax.random.randint(jax.random.PRNGKey(1), (B, Tp), 0,
                                  jcfg.vocab_size)
    printed = np.asarray(jengine.generate(jparams, jcfg, jprompts,
                                          max_new=new))
    with jax.disable_jit():
        op_by_op = np.asarray(jengine.generate(jparams, jcfg, jprompts,
                                               max_new=new))
    tcfg = get_config(arch, reduced=True)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    prompts = torch.from_numpy(np.array(jprompts, np.int32))
    out, lines = serve_lm.serve(tparams, tcfg, prompts, new)
    assert lines[0] == f"arch={tcfg.name} batch={B} prompt={Tp} new={new}"
    assert lines[-1] == (f"sample token ids: "
                         f"{printed[0, -new:].tolist()[:12]} ...")
    np.testing.assert_array_equal(out.numpy(), op_by_op)


def test_serve_lm_twin_runs_rwkv_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", "rwkv6_7b",
                         "--batch", "2", "--prompt-len", "3", "--new", "2"])
    assert out.shape == (2, 5)
    printed = capsys.readouterr().out
    assert "arch=rwkv6-smoke" in printed and "tok/s on CPU" in printed


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "deepseek_moe_16b",
                                  "llama4_scout_17b_a16e"])
def test_serve_lm_twin_runs_hybrid_and_moe_on_cpu(arch, capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                         "--prompt-len", "3", "--new", "2"])
    assert out.shape == (2, 5)
    printed = capsys.readouterr().out
    assert f"arch={get_config(arch, reduced=True).name}" in printed


def test_serve_lm_twin_runs_phi3v_on_cpu(capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", "phi_3_vision_4_2b",
                         "--batch", "2", "--prompt-len", "3", "--new", "2"])
    assert out.shape == (2, 5)
    assert "arch=phi3v-smoke" in capsys.readouterr().out


def test_serve_lm_twin_refuses_the_encoder_decoder(capsys):
    with pytest.raises(SystemExit):
        serve_lm.main(["--device", "cpu", "--arch", "whisper_base"])
    assert "encoder-decoder" in capsys.readouterr().err


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
        "print(' '.join(m for m in sys.modules "
        "if m.startswith('repro_torch')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 15
    # the training modules are among those walked
    assert {"repro_torch.optim.adamw", "repro_torch.train.step",
            "repro_torch.train.train_lm", "repro_torch.data.pipeline",
            "repro_torch.ckpt.manager", "repro_torch.ft.straggler",
            "repro_torch.tree", "repro_torch.convert"} <= mods
    # and the DSE scoring engine's
    assert {f"repro_torch.core.{m}" for m in (
        "affine", "workload", "dataflow", "cost", "perf_model", "mapper",
        "fusion", "perf_model_torch", "mapper_batch")} <= mods
    assert {"repro_torch.frontend.model_graph", "repro_torch.frontend.lower",
            "repro_torch.dse.space", "repro_torch.dse.cache",
            "repro_torch.dse.batch_sweep"} <= mods

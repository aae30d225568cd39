"""The port's serve step (repro_torch.serve.engine) on the CPU: what a CUDA
graph can hold, and the step against the reference's jitted step.

On a card ``build_serve_step`` captures one decode step in a CUDA graph
and replays it (tests/test_torch_cuda.py holds the replays to the eager
step there).  A graph cannot hold an op that makes the host read the
device (``.item()``, ``int(t)``, ``nonzero``), an output whose shape
depends on values, or a tensor made from Python data (a host-to-device
copy from pageable memory).  ``CaptureGuard`` records each of them while
one decode step runs on the CPU, through the same model code as on the
card and the kernels' plain versions.  On the CPU the step stays eager.

fp32 tolerance 1e-4, as tests/test_torch_models.py holds the models."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JTF
from repro.serve import engine as jengine
from repro_torch.configs import ARCH_IDS, PORTED_IDS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.serve import engine

TOL = 1e-4
DECODER_IDS = [a for a in PORTED_IDS
               if not get_config(a, reduced=True).is_encoder_decoder]
aten = torch.ops.aten
# a tensor made from Python data (torch.tensor, torch.as_tensor of a list)
FROM_HOST_DATA = (aten.lift_fresh.default, aten.lift_fresh_copy.default,
                  aten.lift.default)


def uncapturable(func, args) -> bool:
    """Whether a CUDA graph cannot hold ``func`` on ``args``: the host
    reads a value (``data_dependent_output``: ``.item()``, ``equal``), the
    output's shape depends on values (``dynamic_output_shape``: nonzero,
    unique, masked_select, indexing by a mask; indexing by integer tensors
    keeps its shape), or a tensor is made from Python data."""
    if func in FROM_HOST_DATA or torch.Tag.data_dependent_output in func.tags:
        return True
    if torch.Tag.dynamic_output_shape not in func.tags:
        return False
    if func is aten.index.Tensor:
        return any(i is not None and i.dtype in (torch.bool, torch.uint8)
                   for i in args[1])
    return True


class CaptureGuard(TorchDispatchMode):
    """Records every op it sees that a CUDA graph cannot hold."""

    def __init__(self):
        super().__init__()
        self.refused = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if uncapturable(func, args):
            self.refused.append(str(func))
        return func(*args, **(kwargs or {}))


def _guarded(fn, *args):
    with CaptureGuard() as guard:
        out = fn(*args)
    return out, guard.refused


# ---------------------------------------------------------------------------
# the guard itself
# ---------------------------------------------------------------------------

def _embed_before(x, d):
    """The embedding scale as the port built it before the captured step:
    a tensor from the host's float, on every call."""
    return x * torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)


@pytest.mark.parametrize("name,fn", [
    ("item", lambda x: x.sum().item()),
    ("int", lambda x: int(x[0] > 0)),
    ("nonzero", lambda x: x.nonzero()),
    ("mask_index", lambda x: x[x > 0]),
    ("equal", lambda x: torch.equal(x, x)),
    ("tensor_from_host", lambda x: x + torch.tensor([1.0, 2.0, 3.0])),
    ("embed_scale_before", lambda x: _embed_before(x, 3072)),
    ("one_hot", lambda x: F.one_hot(torch.arange(3), 4)),
])
def test_guard_refuses_what_a_graph_cannot_hold(name, fn):
    """Each op that makes the host wait on the card, shapes an output by
    values or copies Python data to the card, among them the embedding
    scale and the MoE one-hot as the port built them before."""
    x = torch.tensor([1.0, -2.0, 3.0])
    _, refused = _guarded(fn, x)
    assert refused, name


def test_guard_admits_integer_indexing_and_scalars():
    """Gathers by integer tensors, Python scalars and factories with a
    shape keep a graph's shapes and addresses."""
    table = torch.randn(10, 4)
    ids = torch.tensor([3, 1], dtype=torch.int32)

    def step(t, i):
        x = t[i.long()] * 1.5 + torch.zeros(2, 4)
        return x[torch.arange(2), torch.arange(2)].sum()

    _, refused = _guarded(step, table, ids)
    assert refused == []


# ---------------------------------------------------------------------------
# one decode step of every smoke config under the guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_IDS)
def test_decode_step_can_be_captured(arch):
    """Two decode steps (pos 0 and 1, a 0-d int32 tensor as generate passes
    it) of the smoke config in its own dtype take no op that a CUDA graph
    cannot hold: attention's cache write and masks, the Mamba and RWKV
    steps, MoE routing, drops and combine, Gemma's embedding scale."""
    cfg = get_config(arch, reduced=True)
    params = TF.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = TF.init_decode_state(cfg, 3, 4, device="cpu")
    tok = torch.tensor([1, 5, 7], dtype=torch.int32)
    pos = torch.zeros((), dtype=torch.int32)
    for _ in range(2):
        (logits, state), refused = _guarded(TF.decode_step, params, state,
                                            tok, pos, cfg)
        assert refused == [], refused
        assert logits.shape == (3, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        pos += 1


def test_encdec_decode_step_can_be_captured():
    """Whisper's step (self-attention over the cache, cross-attention over
    the encoder's output, recomputing its keys and values) likewise."""
    cfg = get_config("whisper_base", reduced=True)
    params = ED.init_params_encdec(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    enc = ED.encode(params, torch.randn(2, 30, cfg.d_model), cfg)
    state = ED.init_decode_state_encdec(cfg, 2, 4, device="cpu")
    tok = torch.tensor([1, 5], dtype=torch.int32)
    pos = torch.zeros((), dtype=torch.int32)
    for _ in range(2):
        (logits, state), refused = _guarded(ED.decode_step_encdec, params,
                                            state, tok, pos, enc, cfg)
        assert refused == [], refused
        assert torch.isfinite(logits.float()).all()
        pos += 1


# ---------------------------------------------------------------------------
# the CPU serve step against the reference's jitted step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_IDS)
def test_cpu_serve_step_matches_reference_jitted_step(arch):
    """build_serve_step on CPU tensors runs eagerly (no capture) and gives
    the reference's ``jax.jit(step, donate_argnums=(1,))``'s logits and
    every leaf of its state, step by step, in fp32."""
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32")
    jparams = JTF.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jstep, _ = jengine.build_serve_step(jcfg)
    tstep = engine.build_serve_step(tcfg)
    toks = np.random.RandomState(4).randint(0, tcfg.vocab_size, (2, 5)
                                            ).astype(np.int32)
    jstate = JTF.init_decode_state(jcfg, 2, 5)
    tstate = TF.init_decode_state(tcfg, 2, 5, device="cpu")
    pos = torch.zeros((), dtype=torch.int32)
    for t in range(5):
        jl, jstate = jstep(jparams, jstate, jax.numpy.asarray(toks[:, t]), t)
        tl, tstate = tstep(tparams, tstate, torch.from_numpy(toks[:, t]), pos)
        pos += 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   rtol=TOL, atol=TOL)
    assert tstep.captures == tstep.replays == 0
    for key in jstate:
        for leaf in jstate[key]:
            np.testing.assert_allclose(
                tstate[key][leaf].float().numpy(),
                np.asarray(jstate[key][leaf], np.float32), rtol=TOL, atol=TOL)


def test_cpu_serve_step_is_the_eager_step():
    """On the CPU the serve step is decode_step itself: the same logits and
    state, bit for bit, and nothing captured."""
    cfg = get_config("jamba_1_5_large_398b", reduced=True)
    params = TF.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    step = engine.build_serve_step(cfg)
    s1 = TF.init_decode_state(cfg, 2, 3, device="cpu")
    s2 = TF.init_decode_state(cfg, 2, 3, device="cpu")
    tok = torch.tensor([4, 9], dtype=torch.int32)
    for t in range(3):
        pos = torch.tensor(t, dtype=torch.int32)
        l1, s1 = step(params, s1, tok, pos)
        l2, s2 = TF.decode_step(params, s2, tok, pos, cfg)
        assert torch.equal(l1, l2)
    for key in s1:
        for leaf in s1[key]:
            assert torch.equal(s1[key][leaf], s2[key][leaf])
    assert step.captures == 0


# ---------------------------------------------------------------------------
# the pieces the captured step rests on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_embedding_scale_rounds_as_a_model_dtype_tensor(dtype):
    """The embedding scale, a Python float now, is the value the model
    dtype holds (as torch.tensor(v, dtype=dtype) rounds it), and x times
    it equals x times that 0-d tensor, bit for bit."""
    rs = np.random.RandomState(0)
    values = [math.sqrt(d) for d in range(1, 5000)] + \
        list(rs.uniform(0, 300, 2000))
    for v in values:
        assert TF._rounded(v, dtype) == torch.tensor(v, dtype=dtype).item()
    x = torch.from_numpy(rs.standard_normal((64, 3072)).astype(np.float32)
                         ).to(dtype)
    for d in (2048, 3072, 3584):
        s = math.sqrt(d)
        assert torch.equal(x * TF._rounded(s, dtype),
                           x * torch.tensor(s, dtype=dtype))


def test_launch_counts_add_and_take_back():
    """ops.launch_counts reads every wrapper's counter in COUNTERS' order;
    add_launch_counts adds to each (a capture takes back what it counted
    and a replay adds it), and refuses a count of the wrong length."""
    before = ops.launch_counts()
    assert len(before) == len(ops.COUNTERS)
    delta = tuple(range(1, len(before) + 1))
    try:
        ops.add_launch_counts(delta)
        assert ops.launch_counts() == tuple(b + d for b, d in
                                            zip(before, delta))
        fn, name = ops.COUNTERS[2]
        assert getattr(fn, name) == before[2] + 3
        with pytest.raises(ValueError):
            ops.add_launch_counts(delta[:-1])
    finally:
        ops.add_launch_counts([-d for d in delta])
    assert ops.launch_counts() == before


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shapes_match_reference(arch):
    """serve.decode_state_shapes at full width (batch 4, 4096 positions):
    every leaf's path, shape and dtype those of the reference's
    jax.eval_shape, on the meta device (nothing allocated)."""
    from repro_torch.serve import ServeConfig, decode_state_shapes
    want = jengine.decode_state_shapes(
        jax_get_config(arch), jengine.ServeConfig(batch=4, max_len=4096))
    got = decode_state_shapes(get_config(arch),
                              ServeConfig(batch=4, max_len=4096))
    want = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    flat = dict(leaves(got))
    assert all(t.device.type == "meta" for t in flat.values())
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in flat.items()} == want

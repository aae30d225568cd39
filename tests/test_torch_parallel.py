"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``) on the CPU.

The rules are pure functions of (shape, mesh shape), so each is held
entry for entry to the reference's on the same mesh shape: the port's on a
``DeviceMesh`` of the ``"fake"`` process group (a fixture starts and
destroys it at the mesh's world size), the reference's on a
``jax.sharding.AbstractMesh``.  Meshes 2×2, 16×16 and 2×16×16, under both
profiles; every config of ``ARCH_IDS`` at full size, the port's trees made
under ``FakeTensorMode`` and the reference's by ``jax.eval_shape``.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import encdec as JED
from repro.models import transformer as JTF
from repro.parallel import sharding as JS
from repro.serve import engine as JE
from repro_torch.configs import get_config
from repro_torch.launch.mesh import fake_group, shape_mesh
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.parallel import sharding as S
from repro_torch.serve.engine import state_sharding_spec

MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
# decode_32k's batch and cache length
STATE_B, STATE_S = 128, 32768


def _abstract_mesh(shape, axes):
    """AbstractMesh across JAX API drift (as tests/test_runtime.py
    builds it)."""
    try:
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return jax.sharding.AbstractMesh(shape, axes)


@pytest.fixture(params=list(MESHES))
def meshes(request):
    """(the port's DeviceMesh on a fake group, the reference's
    AbstractMesh) of one mesh shape."""
    shape, axes = MESHES[request.param]
    with fake_group(math.prod(shape)):
        yield shape_mesh(shape, axes), _abstract_mesh(shape, axes)


@pytest.fixture(params=["tp", "fsdp"])
def profile(request):
    S.set_profile(request.param)
    JS.set_profile(request.param)
    yield request.param
    S.set_profile("tp")
    JS.set_profile("tp")


def _entries(spec):
    return tuple(spec)


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    cfg = get_config(arch)
    init = ED.init_params_encdec if cfg.is_encoder_decoder else TF.init_params
    with FakeTensorMode():
        return init(cfg, torch.Generator().manual_seed(0), "cpu")


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = jget_config(arch)
    init = JED.init_params_encdec if cfg.is_encoder_decoder \
        else JTF.init_params
    return jax.eval_shape(lambda: init(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    cfg = get_config(arch)
    with FakeTensorMode():
        if cfg.is_encoder_decoder:
            return ED.init_decode_state_encdec(cfg, STATE_B, STATE_S, "cpu")
        return TF.init_decode_state(cfg, STATE_B, STATE_S, "cpu")


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return JE.decode_state_shapes(jget_config(arch),
                                  JE.ServeConfig(STATE_B, STATE_S))


def _port_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _ref_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(JS._key_str(k) for k in path): leaf
            for path, leaf in flat}


# ---------------------------------------------------------------------------
# logical_to_spec on seeded draws
# ---------------------------------------------------------------------------

_DIMS = (1, 2, 3, 4, 6, 7, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512,
         1000, 1024, 4096, 5120, 32768)


def test_logical_to_spec_matches_reference(meshes, profile):
    mesh, amesh = meshes
    rng = np.random.default_rng(0)
    names = list(S.PROFILES["tp"])
    for _ in range(400):
        nd = int(rng.integers(1, 6))
        logical = tuple(str(rng.choice(names)) for _ in range(nd))
        shape = tuple(int(rng.choice(_DIMS)) for _ in range(nd))
        got = S.logical_to_spec(logical, shape, mesh)
        want = JS.logical_to_spec(logical, shape, amesh)
        assert _entries(got) == _entries(want), (logical, shape)


def test_choose_axes_matches_reference(meshes, profile):
    mesh, amesh = meshes
    for name in S.PROFILES["tp"]:
        for dim in _DIMS:
            assert S.choose_axes(dim, name, mesh) == \
                JS.choose_axes(dim, name, amesh), (name, dim)


# ---------------------------------------------------------------------------
# parameter and decode-state specs, every config, leaf by path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, meshes, profile):
    mesh, amesh = meshes
    got = _port_paths(S.shard_params_spec(_port_params(arch), mesh))
    want = _ref_paths(JS.shard_params_spec(_ref_params(arch), amesh))
    assert set(got) == set(want)
    bad = {p: (got[p], want[p]) for p in got
           if _entries(got[p]) != _entries(want[p])}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match_reference(arch, meshes, profile):
    mesh, amesh = meshes
    got = _port_paths(state_sharding_spec(_port_state(arch), mesh))
    want = _ref_paths(JE.state_sharding_spec(_ref_state(arch), amesh))
    assert set(got) == set(want)
    bad = {p: (got[p], want[p]) for p in got
           if _entries(got[p]) != _entries(want[p])}
    assert not bad, bad


def test_mistral_cache_falls_back_to_the_sequence():
    """8 kv heads do not divide the 16-wide model axis: the cache's
    ``tensor`` falls back and ``seq`` takes ``model`` (the reference's
    flash-decoding layout)."""
    with fake_group(256):
        mesh = shape_mesh((16, 16), ("data", "model"))
        spec = state_sharding_spec(_port_state("mistral_nemo_12b"), mesh)
    assert tuple(spec["pos0"]["k"]) == (None, "data", None, "model", None)


# ---------------------------------------------------------------------------
# DTensor layouts
# ---------------------------------------------------------------------------

def test_local_shard_shapes_follow_the_spec(meshes, profile):
    mesh, _ = meshes
    sizes = S.mesh_axes(mesh)
    rng = np.random.default_rng(1)
    names = list(S.PROFILES["tp"])
    with FakeTensorMode():
        for _ in range(40):
            nd = int(rng.integers(1, 5))
            logical = tuple(str(rng.choice(names)) for _ in range(nd))
            shape = tuple(int(rng.choice((4, 16, 32, 48, 256)))
                          for _ in range(nd))
            spec = S.logical_to_spec(logical, shape, mesh)
            t = S.distribute(torch.zeros(shape), mesh, logical)
            want = []
            for dim, entry in zip(shape, spec):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                want.append(dim // math.prod(sizes[a] for a in axes))
            assert tuple(t.to_local().shape) == tuple(want), (logical, shape)
            assert tuple(t.shape) == shape


def test_placements_are_per_mesh_dim():
    with fake_group(512):
        mesh = shape_mesh((2, 16, 16), ("pod", "data", "model"))
        spec = S.Spec(("pod", "data"), None, "model")
        assert S.placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
        assert S.placements(S.Spec(None, None), mesh) == (Replicate(),) * 3
        # a DTensor splits one dim over mesh dims only in mesh order
        with pytest.raises(AssertionError):
            S.placements(S.Spec(("model", "data")), mesh)


def test_with_constraint_is_a_no_op_without_a_sharded_mesh():
    x = torch.randn(4, 8)
    assert S.with_constraint(x, None, ("batch", "none")) is x
    with fake_group(1):
        mesh = shape_mesh((1, 1), ("data", "model"))
        assert S.with_constraint(x, mesh, ("batch", "none")) is x


def test_with_constraint_redistributes(meshes):
    mesh, _ = meshes
    with FakeTensorMode():
        x = S.distribute(torch.zeros(32, 64), mesh, ("none", "none"))
        y = S.with_constraint(x, mesh, ("batch", "tensor"))
        spec = S.logical_to_spec(("batch", "tensor"), (32, 64), mesh)
        assert tuple(y.placements) == S.placements(spec, mesh)


# ---------------------------------------------------------------------------
# twins of tests/test_runtime.py::TestShardingRules
# ---------------------------------------------------------------------------

class TestShardingRules:
    def test_divisibility_fallback(self):
        with fake_group(4):
            mesh = shape_mesh((2, 2), ("data", "model"))
            # divisible: sharded
            assert tuple(S.logical_to_spec(("tensor",), (8,), mesh)) == \
                ("model",)
            # not divisible: replicated
            assert tuple(S.logical_to_spec(("tensor",), (7,), mesh)) == \
                (None,)
            # seq falls back to whatever axes remain
            spec = S.logical_to_spec(("batch", "seq"), (4, 8), mesh)
            assert spec[0] == "data" and spec[1] == "model"

    def test_param_rules_cover_all_archs(self):
        with fake_group(4):
            mesh = shape_mesh((2, 2), ("data", "model"))
            for arch in ("jamba_1_5_large_398b", "rwkv6_7b",
                         "deepseek_moe_16b"):
                cfg = get_config(arch, reduced=True)
                with FakeTensorMode():
                    shapes = TF.init_params(cfg, torch.Generator(), "cpu")
                specs = _port_paths(S.shard_params_spec(shapes, mesh))
                assert len(specs) > 0
                assert any(any(e is not None for e in s)
                           for s in specs.values())

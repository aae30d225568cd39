"""The port's launch tools (``repro_torch.launch``) on the CPU: twins of
``tests/test_dryrun_tools.py``'s cell plumbing and roofline tests against
the H100's constants, the per-device operation counts of ``opcount``, one
traced cell per kind on a fake 2×2 mesh (records keyed as the
reference's), the copies of ``ElasticPlanner`` and ``MeshPlan``, and the
fault-check tools' device default."""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.ft import straggler as JST
from repro.launch import roofline as JR
from repro_torch.configs import get_config
from repro_torch.ft import straggler as ST
from repro_torch.kernels import autotile
from repro_torch.launch import cells as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (fake_group, make_production_mesh,
                                     shape_mesh)
from repro_torch.launch.opcount import OpCounter, wire_bytes
from repro_torch.parallel.sharding import distribute


# ---------------------------------------------------------------------------
# cells and meshes (twins of TestCellsPlumbing)
# ---------------------------------------------------------------------------

class TestCellsPlumbing:
    def test_skip_rules(self):
        ok, _ = C.cell_is_applicable("jamba_1_5_large_398b", "long_500k")
        assert ok
        ok, why = C.cell_is_applicable("gemma_7b", "long_500k")
        assert not ok and "full-attention" in why
        ok, _ = C.cell_is_applicable("rwkv6_7b", "long_500k")
        assert ok

    def test_all_cells_count(self):
        cells = C.all_cells()
        assert len(cells) == 40
        skips = [c for c in cells if not C.cell_is_applicable(*c)[0]]
        assert len(skips) == 8

    def test_shapes_are_the_reference_shapes(self):
        from repro.launch.cells import SHAPES as J_SHAPES  # noqa: F401
        assert C.SHAPES == J_SHAPES
        assert C.LONG_OK == {"jamba_1_5_large_398b", "rwkv6_7b"}

    @pytest.mark.parametrize("multi_pod,shape,axes", [
        (False, (16, 16), ("data", "model")),
        (True, (2, 16, 16), ("pod", "data", "model"))])
    def test_production_meshes_on_the_fake_group(self, multi_pod, shape,
                                                 axes):
        with fake_group(math.prod(shape)):
            mesh = make_production_mesh(multi_pod=multi_pod)
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == axes
            assert mesh.size() == math.prod(shape)


# ---------------------------------------------------------------------------
# roofline (twins of TestRoofline, H100 constants)
# ---------------------------------------------------------------------------

class TestRoofline:
    def _mk(self, tc, tm, tx):
        return R.Roofline("a", "train_4k", 256,
                          flops_global=tc * 256 * 989e12,
                          bytes_global=tm * 256 * 3.35e12,
                          collective_bytes_global=tx * 256 * 450e9,
                          model_flops=tc * 256 * 989e12 * 0.8)

    def test_h100_constants(self):
        assert R.PEAK_FLOPS == autotile.PEAK_FLOPS[2] == 989e12
        assert R.HBM_BW == autotile.PEAK_BYTES == 3.35e12
        assert R.LINK_BW == 450e9
        assert R.HBM_GB == 80.0

    def test_terms_roundtrip(self):
        r = self._mk(0.1, 0.2, 0.05)
        assert r.t_compute == pytest.approx(0.1)
        assert r.t_memory == pytest.approx(0.2)
        assert r.t_collective == pytest.approx(0.05)
        assert r.bottleneck == "memory"
        assert r.useful_flops_ratio == pytest.approx(0.8)

    def test_roofline_fraction(self):
        r = self._mk(0.2, 0.1, 0.1)
        assert r.roofline_fraction == pytest.approx(0.8)

    def test_as_dict_keys_are_the_reference_keys(self):
        j = JR.Roofline("a", "train_4k", 256, 1.0, 1.0, 1.0, 1.0)
        assert set(self._mk(0.1, 0.1, 0.1).as_dict()) == set(j.as_dict())

    @pytest.mark.parametrize("arch", J_ARCH_IDS)
    def test_model_flops_equal_the_reference(self, arch):
        for shape, info in C.SHAPES.items():
            assert R.model_flops_for(get_config(arch), info) == \
                JR.model_flops_for(jget_config(arch), info), shape

    def test_model_flops_decode_counts_tokens_not_cache(self):
        cfg = get_config("glm4_9b")
        f_dec = R.model_flops_for(cfg, dict(kind="decode", global_batch=128,
                                            seq_len=32768))
        f_tr = R.model_flops_for(cfg, dict(kind="train", global_batch=256,
                                           seq_len=4096))
        assert f_dec == pytest.approx(2.0 * cfg.n_active_params() * 128)
        assert f_tr > 1000 * f_dec


# ---------------------------------------------------------------------------
# opcount
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(64, 32, 16), (128, 256, 512)])
def test_matmul_flops_are_2mnk(m, n, k):
    a, b = torch.randn(m, k), torch.randn(k, n)
    with OpCounter() as oc:
        a @ b
    assert oc.counts.flops == 2 * m * n * k
    # inputs read once, the output written once (fp32)
    assert oc.counts.bytes == 4 * (m * k + k * n + m * n)


def test_counts_are_per_device_under_dtensor():
    """A product split over both mesh dims with nothing replicated: each
    device does a quarter, so per device × 4 is the global count, which is
    what FlopCounterMode reads on the same DTensor product."""
    m, k, n = 64, 32, 48
    with fake_group(4):
        mesh = shape_mesh((2, 2), ("data", "model"))
        with FakeTensorMode():
            a = distribute(torch.zeros(m, k), mesh, ("batch", "none"))
            w = distribute(torch.zeros(k, n), mesh, ("none", "tensor"))
            with OpCounter() as oc:
                a @ w
            with FlopCounterMode(display=False) as fc:
                a @ w
    assert oc.counts.flops * 4 == 2 * m * n * k
    assert fc.get_total_flops() == 2 * m * n * k


def test_in_place_index_copy_is_charged_as_the_update():
    buf = torch.zeros(4096, 256)
    row = torch.ones(1, 256)
    with OpCounter() as oc:
        buf.index_copy_(0, torch.tensor([7]), row)
    assert oc.counts.bytes < 4096 * 256 * 4 / 100
    assert oc.counts.bytes == 256 * 4 * 2 + 8


@pytest.mark.parametrize("kind,g", [("all-reduce", 4), ("all-gather", 16),
                                    ("reduce-scatter", 2),
                                    ("all-to-all", 8),
                                    ("collective-permute", 2)])
def test_wire_bytes_follow_the_reference(kind, g):
    s = 1000.0
    want = {"all-reduce": 2 * s * (g - 1) / g,
            "all-gather": s * (g - 1) / g,
            "reduce-scatter": s * (g - 1),
            "all-to-all": s * (g - 1) / g,
            "collective-permute": s}[kind]
    assert wire_bytes(kind, s, g) == pytest.approx(want)


@pytest.mark.parametrize("src,dst,kind", [
    ((Shard(0),), (Replicate(),), "all-gather"),
    ((Partial(),), (Replicate(),), "all-reduce"),
    ((Partial(),), (Shard(0),), "reduce-scatter")])
def test_redistributions_are_charged_by_kind(src, dst, kind):
    """A DTensor redistribution over 4 devices, traced: its collective is
    counted once with the wire bytes of the reference's formula on its
    result."""
    from torch.distributed.tensor import DTensor
    with fake_group(4):
        mesh = shape_mesh((4,), ("data",))
        with FakeTensorMode():
            local = torch.zeros(8, 16) if src[0] == Shard(0) \
                else torch.zeros(32, 16)
            x = DTensor.from_local(local, mesh, src, run_check=False)
            with OpCounter() as oc:
                y = x.redistribute(mesh, dst)
            res = y.to_local().numel() * 4
    c = oc.counts
    assert c.coll_counts[kind] == 1
    assert c.coll_bytes[kind] == pytest.approx(wire_bytes(kind, res, 4))


# ---------------------------------------------------------------------------
# one traced cell per kind on a fake 2×2 mesh, at smoke size
# ---------------------------------------------------------------------------

def _reference_record_keys():
    memory = {"argument_size", "output_size", "temp_size", "alias_size"}
    top = {"arch", "shape", "mesh", "status", "why", "profile", "tag",
           "seconds", "memory", "roofline"}
    rl = set(JR.Roofline("a", "s", 1, 1.0, 1.0, 1.0, 1.0).as_dict())
    return top, memory, rl


@pytest.mark.parametrize("arch,shape", [
    ("mistral_nemo_12b", "train_4k"), ("mistral_nemo_12b", "prefill_32k"),
    ("mistral_nemo_12b", "decode_32k"), ("whisper_base", "decode_32k")])
def test_traced_cell_record(arch, shape, tmp_path):
    rec = D.run_cell(arch, shape, False, str(tmp_path), verbose=False,
                     mesh_shape=((2, 2), ("data", "model")), reduced=True)
    assert rec["status"] == "ok", rec.get("trace")
    top, memory, rl = _reference_record_keys()
    assert set(rec) == top
    assert set(rec["memory"]) == memory
    assert set(rec["roofline"]) == rl
    r = rec["roofline"]
    assert r["chips"] == 4 and r["flops_global"] > 0
    assert r["bytes_global"] > 0 and r["collective_bytes_global"] > 0
    assert rec["memory"]["argument_size"] > 0
    assert (tmp_path / f"{arch}__{shape}__2x2.json").exists()


def test_skipped_cell_record():
    rec = D.run_cell("gemma_7b", "long_500k", False, None, verbose=False)
    assert rec["status"] == "skip" and "full-attention" in rec["why"]


# ---------------------------------------------------------------------------
# ElasticPlanner and MeshPlan against the reference
# ---------------------------------------------------------------------------

def _plans(healthy, total, **kw):
    a = ST.ElasticPlanner(**kw).plan(healthy, total)
    b = JST.ElasticPlanner(**kw).plan(healthy, total)
    return a, b


@pytest.mark.parametrize("healthy", [
    list(range(128)),                                   # full fleet
    list(range(64)),                                    # pod 1 lost
    [h for h in range(128) if h not in (3, 70)]])       # one bad in each
def test_elastic_plan_matches_reference(healthy):
    a, b = _plans(healthy, 128, devices_per_host=4, model_axis=16, pods=2,
                  hosts_per_pod=64)
    assert (a.shape, a.axes, a.n_hosts, a.n_devices) == \
        (b.shape, b.axes, b.n_hosts, b.n_devices)


def test_elastic_plan_matches_reference_on_random_fleets():
    rng = np.random.default_rng(0)
    for _ in range(50):
        total = int(rng.choice([8, 16, 64, 128]))
        healthy = sorted(rng.choice(total, int(rng.integers(1, total + 1)),
                                    replace=False).tolist())
        a, b = _plans(healthy, total, devices_per_host=4, model_axis=16,
                      pods=2)
        assert (a.shape, a.axes, a.n_hosts) == (b.shape, b.axes, b.n_hosts)


def test_a_plan_builds_a_device_mesh():
    plan = ST.ElasticPlanner(devices_per_host=4, model_axis=16, pods=2,
                             hosts_per_pod=64).plan(list(range(64)), 128)
    with fake_group(plan.n_devices):
        mesh = shape_mesh(plan.shape, plan.axes)
        assert tuple(mesh.shape) == plan.shape


# ---------------------------------------------------------------------------
# the fault-check tools run on the card unless told otherwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["k3_fault_check", "k4_fault_check"])
def test_fault_checks_default_to_the_card(tool, monkeypatch):
    import importlib
    mod = importlib.import_module(f"repro_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda"):
        mod.main([])

"""The port's DSE scoring engine (repro_torch.core / frontend / dse) against
the reference's NumPy engine (repro.core.perf_model.perf_kernel and the
modules around it) on the CPU.

The reference's JAX engine is not the oracle: on the installed jax it
cannot import ``enable_x64``.  The port is held to that engine's own
contract instead, against the NumPy ``perf_kernel``: every integer-derived
output bit-identical, ``energy_pj`` within ENERGY_RTOL = 1e-9 relative, and
everything reported (mappings, cache entries, frontiers) byte-identical.
No other tolerance is used.  Each copied module is held equal to its
original.  Inputs are drawn from seeded ``random.Random`` streams over the
menus of tests/test_engine_parity.py.

    PYTHONPATH=src python -m pytest -q tests/test_torch_dse.py
"""

import json
import random

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.core import cost as RC
from repro.core import fusion as RF
from repro.core import mapper as RM
from repro.core import mapper_batch as RMB
from repro.core import perf_model as RP
from repro.core import workload as RW
from repro.dse import cache as RCache
from repro.dse import space as RS
from repro.dse.evaluate import Evaluator, load_zoo as ref_load_zoo
from repro.dse.search import exhaustive_search
from repro.frontend import lower_zoo as ref_lower_zoo
from repro_torch.configs import ARCH_IDS
from repro_torch.core import cost as PC
from repro_torch.core import fusion as PF
from repro_torch.core import mapper as PM
from repro_torch.core import mapper_batch as PMB
from repro_torch.core import perf_model as PP
from repro_torch.core import workload as PW
from repro_torch.core.perf_model_torch import (ENERGY_RTOL, ENGINES,
                                               RESULT_KEYS,
                                               perf_kernel_torch,
                                               perf_kernel_torch_design)
from repro_torch.dse import batch_sweep as PB
from repro_torch.dse import cache as PCache
from repro_torch.dse import evaluate as PEv
from repro_torch.dse import space as PS
from repro_torch.frontend import lower_zoo
from repro_torch.serve import sim as PSim

CPU = "cpu"
_EXACT = tuple(k for k in RESULT_KEYS if k != "energy_pj")
_FACTORIES = ("gemm", "conv2d", "depthwise_conv2d", "attention_qk",
              "attention_pv", "mttkrp")
# the menus of tests/test_engine_parity.py, attention_pv added
_SP_MENU = {
    "gemm": [("i", "j"), (1, 1), "ij", ("k", "j"), (1, 1), "jk",
             ("j",), (1,), "j1"],
    "conv2d": [("ow", "oh"), (0, 0), "ohow", ("ic", "oc"), (1, 1), "icoc"],
    "dwconv2d": [("ow", "oh"), (0, 0), "ohow"],
    "attention_qk": [("m", "n"), (1, 1), "mn", ("d", "n"), (1, 1), "nd"],
    "attention_pv": [("m", "n"), (0, 0), "attn-mn", ("b", "n"), (0, 0),
                     "attn-bn"],
    "mttkrp": [("i", "j"), (1, 1), "ij"],
}
_DIM_VALUES = (1, 3, 7, 16, 56, 130, 512)
_HW_MENU = dict(n_fus=(64, 256), buffer_bytes=(64 * 1024, 512 * 1024),
                dram_gbps=(8.0, 64.0))


def _menu(mod, name):
    """The spatial menu of workload ``name`` as ``mod.SpatialChoice``s."""
    m = _SP_MENU[name]
    return [mod.SpatialChoice(m[i], m[i + 1], m[i + 2])
            for i in range(0, len(m), 3)]


def _wls(mod):
    return {w.name: w for w in (getattr(mod, f)() for f in _FACTORIES)}


_RWL, _PWL = _wls(RW), _wls(PW)


def _hw(mod, **kw):
    return mod.HWConfig(**kw)


def _random_case(rng):
    """(name, dims, hw kwargs, data nodes, ppu, objective), as
    tests/test_engine_parity.py draws them."""
    name = rng.choice(sorted(_RWL))
    wl = _RWL[name]
    dims = {d: rng.choice(_DIM_VALUES) for d in wl.iter_dims}
    hw = dict(n_fus=rng.choice(_HW_MENU["n_fus"]),
              buffer_bytes=rng.choice(_HW_MENU["buffer_bytes"]),
              dram_gbps=rng.choice(_HW_MENU["dram_gbps"]))
    obj = rng.choice(["cycles", "energy", "edp"])
    dn = ({t.name: rng.choice([8, 16]) for t in wl.tensors}
          if rng.random() < 0.5 else None)
    ppu = rng.choice([0.0, 4096.0])
    return name, dims, hw, dn, ppu, obj


def _assert_scores(got, want, ctx=""):
    """The engine contract: exact but for energy_pj within ENERGY_RTOL."""
    for k in _EXACT:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), \
            (k, ctx)
    np.testing.assert_allclose(got["energy_pj"], want["energy_pj"],
                               rtol=ENERGY_RTOL, atol=0, err_msg=str(ctx))


def _assert_same_mapping(mp, mr, ctx=""):
    """Byte-identical reported mapping (the dataflow by its name: the two
    packages memoize their own objects)."""
    for f in ("cycles", "energy_pj", "macs", "utilization", "dram_bytes",
              "sram_reads", "ppu_cycles"):
        assert getattr(mp.perf, f) == getattr(mr.perf, f), (f, ctx)
    assert mp.perf.bound == mr.perf.bound, ctx
    assert mp.spatial.name == mr.spatial.name, ctx
    assert mp.dataflow.name == mr.dataflow.name, ctx


def _assert_same_batch(bp, br):
    for f in ("loop_dim", "loop_size", "S", "n_fus", "fill", "layer_id",
              "offsets"):
        assert np.array_equal(getattr(bp, f), getattr(br, f)), f
    assert [(c.spatial_idx, c.facs, c.temporal) for c in bp.candidates] == \
        [(c.spatial_idx, c.facs, c.temporal) for c in br.candidates]


# ---------------------------------------------------------------------------
# the copies equal their originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factory,kw", [(f, {}) for f in _FACTORIES] + [
    ("conv2d", {"stride": 2}), ("depthwise_conv2d", {"stride": 2})])
def test_workload_copy(factory, kw):
    p, r = getattr(PW, factory)(**kw), getattr(RW, factory)(**kw)
    assert (p.name, p.iter_dims) == (r.name, r.iter_dims)
    assert (p.compute, p.flops_per_iter) == (r.compute, r.flops_per_iter)
    assert len(p.tensors) == len(r.tensors)
    for tp, tr in zip(p.tensors, r.tensors):
        assert (tp.name, tp.role, tp.dim_names) == \
            (tr.name, tr.role, tr.dim_names)
        assert np.array_equal(tp.fmap.M, tr.fmap.M)
        assert np.array_equal(tp.fmap.b, tr.fmap.b)


def test_dataflow_sets_copy():
    def flat(sets):
        return {s: {w: [(c.dims, c.c, c.name) for c in cs]
                    for w, cs in menu.items()} for s, menu in sets.items()}
    assert flat(PS.DATAFLOW_SETS) == flat(RS.DATAFLOW_SETS)


@pytest.mark.parametrize("space", ("tiny", "small", "medium", "large"))
def test_space_enumeration_copy(space):
    got = [p.as_dict() for p in PS.SPACES[space].enumerate()]
    want = [p.as_dict() for p in RS.SPACES[space].enumerate()]
    assert got == want and got
    for pp, pr in zip(PS.SPACES[space].enumerate(),
                      RS.SPACES[space].enumerate()):
        assert pp.hw_config().signature() == pr.hw_config().signature()
        assert pp.n_ppus == pr.n_ppus and pp.n_dataflows == pr.n_dataflows


@pytest.mark.parametrize("seed", range(3))
def test_space_sample_and_mutate_copy(seed):
    rp, rr = random.Random(seed), random.Random(seed)
    for _ in range(20):
        a = PS.SPACES["huge"].sample(rp)
        b = RS.SPACES["huge"].sample(rr)
        assert a.as_dict() == b.as_dict()
        assert PS.SPACES["huge"].mutate(a, rp).as_dict() == \
            RS.SPACES["huge"].mutate(b, rr).as_dict()


@pytest.mark.parametrize("kw", [
    {}, {"n_fus": 1024, "buffer_bytes": 2 << 20, "dram_gbps": 64.0},
    {"n_fus": 64, "n_ppus": 16, "data_bytes": 2, "acc_bytes": 8,
     "freq_ghz": 1.5, "static_mw": 40.0, "e_mac_pj": 0.5}])
def test_hwconfig_signature_copy(kw):
    p, r = PP.HWConfig(**kw), RP.HWConfig(**kw)
    assert p.signature() == r.signature()
    assert p.bytes_per_cycle == r.bytes_per_cycle


def test_cost_copy_over_a_grid():
    assert PC.DRAM_PJ_PER_BYTE == RC.DRAM_PJ_PER_BYTE
    for nb in (0, 100, 512, 8 << 10, 64 << 10, 1 << 20, 3 << 20, 17 << 20):
        assert PC.sram_read_pj_per_byte(nb) == RC.sram_read_pj_per_byte(nb)
        for banks in (1, 16):
            assert PC.sram_area_um2(nb, banks) == RC.sram_area_um2(nb, banks)
    for nf in (16, 64, 256, 1000, 4096, 16384):
        for nb in (64 << 10, 1 << 20, 4 << 20):
            for ndf in (1, 2, 3):
                for npp in (8, 128):
                    assert PC.estimate_design_area_mm2(nf, nb, ndf, npp) == \
                        RC.estimate_design_area_mm2(nf, nb, ndf, npp)
                    assert PC.estimate_design_power_mw(nf, nb, ndf, npp) == \
                        RC.estimate_design_power_mw(nf, nb, ndf, npp)


def test_estimate_data_nodes_copy():
    for nf in (1, 2, 16, 63, 64, 100, 4096, 16384):
        for names in (("Y", "X", "W"), ("O",), ()):
            assert PF.estimate_data_nodes(nf, names) == \
                RF.estimate_data_nodes(nf, names)


def test_arch_ids_copy():
    assert list(ARCH_IDS) == list(REF_ARCH_IDS)


@pytest.mark.parametrize("seq", (512, 4096))
def test_lower_zoo_copy_default_zoo(seq):
    got = lower_zoo(PB.DEFAULT_ZOO, seq=seq)
    assert got == ref_lower_zoo(PB.DEFAULT_ZOO, seq=seq)
    assert PB.load_zoo(seq=seq) == ref_load_zoo(seq=seq)


@pytest.mark.parametrize("fused", (True, False))
def test_lower_zoo_copy_reduced_all_phases(fused):
    kw = dict(seq=64, batch=2, phases=("prefill", "decode"), reduced=True,
              fused_attention=fused)
    assert lower_zoo(None, **kw) == ref_lower_zoo(None, **kw)


def test_sweep_zoo_keys_as_benchmarks_dse():
    zoo = PB.sweep_zoo(("gemma_7b",), (512, 4096))
    assert list(zoo) == ["gemma_7b@s512", "gemma_7b@s4096"]
    assert zoo["gemma_7b@s4096"] == ref_load_zoo(("gemma_7b",), seq=4096)[
        "gemma_7b"]


@pytest.mark.parametrize("seed", range(4))
def test_enumerate_candidates_copy(seed):
    rng = random.Random(300 + seed)
    for _ in range(12):
        name, dims, hw, _, _, _ = _random_case(rng)
        ts = rng.random() < 0.8
        got = PM.enumerate_candidates(_PWL[name], dims, _menu(PM, name),
                                      _hw(PP, **hw), tile_search=ts)
        want = RM.enumerate_candidates(_RWL[name], dims, _menu(RM, name),
                                       _hw(RP, **hw), tile_search=ts)
        assert [(c.spatial_idx, c.facs, c.temporal) for c in got] == \
            [(c.spatial_idx, c.facs, c.temporal) for c in want]


@pytest.mark.parametrize("seed", range(4))
def test_mapping_key_copy(seed):
    rng = random.Random(400 + seed)
    for _ in range(25):
        name, dims, hw, dn, ppu, obj = _random_case(rng)
        got = PCache.mapping_key(_PWL[name], dims, _menu(PM, name),
                                 _hw(PP, **hw), dn, ppu, obj)
        want = RCache.mapping_key(_RWL[name], dims, _menu(RM, name),
                                  _hw(RP, **hw), dn, ppu, obj)
        assert got == want
        assert PCache.entry_checksum({"k": got, "v": [1.5, None]}) == \
            RCache.entry_checksum({"k": got, "v": [1.5, None]})


# ---------------------------------------------------------------------------
# the scoring engine against the reference's NumPy perf_kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_perf_kernel_torch_matches_numpy(seed):
    """30 seeded batches a seed, 240 in all: the port's batch equals the
    reference's, and the port's engine scores it as the reference's NumPy
    kernel does."""
    rng = random.Random(100 + seed)
    for _ in range(30):
        name, dims, hw, dn, ppu, _ = _random_case(rng)
        n_layers = rng.choice([1, 2, 3])
        dims_list = [dims] + [
            {d: rng.choice(_DIM_VALUES) for d in _RWL[name].iter_dims}
            for _ in range(n_layers - 1)]
        ppu_list = [ppu] * n_layers
        hp, hr = _hw(PP, **hw), _hw(RP, **hw)
        bp = PMB.build_batch(_PWL[name], dims_list, _menu(PM, name), hp)
        br = RMB.build_batch(_RWL[name], dims_list, _menu(RM, name), hr)
        _assert_same_batch(bp, br)
        want = RMB.evaluate_batch(br, hr, dims_list, ppu_list,
                                  data_nodes_per_tensor=dn, engine="numpy")
        got = PMB.evaluate_batch(bp, hp, dims_list, ppu_list,
                                 data_nodes_per_tensor=dn, engine="torch",
                                 device=CPU)
        _assert_scores(got, want, (name, dims_list))
        plain = PMB.evaluate_batch(bp, hp, dims_list, ppu_list,
                                   data_nodes_per_tensor=dn, engine="numpy")
        for k in RESULT_KEYS:
            assert np.array_equal(plain[k], want[k]), k


def test_perf_kernel_torch_edge_rows():
    """No temporal loop at all (L = 0), a batch of one, and the empty batch
    (answered through NumPy, as the reference's engine answers it)."""
    wl_p, wl_r = _PWL["gemm"], _RWL["gemm"]
    hp, hr = PP.HWConfig(n_fus=64), RP.HWConfig(n_fus=64)
    dims = {"i": 8, "j": 8, "k": 1}
    bp = PMB.build_batch(wl_p, [dims], _menu(PM, "gemm"), hp,
                         tile_search=False)
    rows = [i for i, c in enumerate(bp.candidates) if not c.temporal]
    assert rows, "a candidate without temporal loops"
    for idx in (np.array(rows[:1]), np.arange(bp.n_candidates),
                np.array([], dtype=np.int64)):
        L = 0 if len(idx) == 1 else bp.loop_size.shape[1]
        args = (bp.loop_dim[idx, :L], bp.loop_size[idx, :L], bp.S[idx],
                bp.n_fus[idx], bp.fill[idx],
                np.full((len(idx), 3), RP.NO_TRUE_SIZE, dtype=np.int64),
                np.full((len(idx), 3), 8, dtype=np.int64),
                np.zeros(len(idx)))
        want = RP.perf_kernel(wl_r, hr, *args)
        _assert_scores(perf_kernel_torch(wl_p, hp, *args, device=CPU), want)
        got = perf_kernel_torch_design(wl_p, [hp, hp], *args[:6],
                                       np.full((2, 3), 8, dtype=np.int64),
                                       args[7], device=CPU)
        for d in range(2):
            _assert_scores({k: v[d] for k, v in got.items()}, want)


def test_perf_kernel_torch_refuses_mixed_data_node_rows():
    wl = _PWL["gemm"]
    hp = PP.HWConfig(n_fus=64)
    b = PMB.build_batch(wl, [{"i": 64, "j": 64, "k": 64}], _menu(PM, "gemm"),
                        hp)
    dn = np.full((b.n_candidates, 3), 8, dtype=np.int64)
    dn[1, 0] = 9
    with pytest.raises(AssertionError, match="one shared data-node row"):
        perf_kernel_torch(wl, hp, b.loop_dim, b.loop_size, b.S, b.n_fus,
                          b.fill, np.full_like(b.S, RP.NO_TRUE_SIZE), dn,
                          np.zeros(b.n_candidates), device=CPU)


@pytest.mark.parametrize("n_designs", (1, 2, 3, 4, 5))
@pytest.mark.parametrize("seed", range(3))
def test_perf_kernel_torch_design_matches_numpy(n_designs, seed):
    """D designs of one FU count, mixed buffers, bandwidths and data nodes,
    in one dispatch, against the NumPy kernel design by design."""
    rng = random.Random(1000 * n_designs + seed)
    name, _, hw, _, ppu, _ = _random_case(rng)
    wl_p, wl_r = _PWL[name], _RWL[name]
    dims_list = [{d: rng.choice(_DIM_VALUES) for d in wl_r.iter_dims}
                 for _ in range(rng.choice([1, 2, 3]))]
    hws = [dict(n_fus=hw["n_fus"],
                buffer_bytes=rng.choice((16 << 10, 64 << 10, 512 << 10,
                                         4 << 20)),
                dram_gbps=rng.choice((4.0, 8.0, 16.0, 64.0)),
                n_ppus=rng.choice((8, 32)))
           for _ in range(n_designs)]
    dns = [({t.name: rng.choice([1, 8, 16, 1024]) for t in wl_r.tensors}
            if rng.random() < 0.7 else None) for _ in range(n_designs)]
    bp = PMB.build_batch(wl_p, dims_list, _menu(PM, name),
                         _hw(PP, **hws[0]))
    true = PMB._true_rows(wl_p, dims_list)[bp.layer_id]
    ppu_c = np.full(bp.n_candidates, ppu)
    got = perf_kernel_torch_design(
        wl_p, [_hw(PP, **h) for h in hws], bp.loop_dim, bp.loop_size, bp.S,
        bp.n_fus, bp.fill, true,
        np.array([PMB._dn_row(wl_p, _hw(PP, **h), dn)
                  for h, dn in zip(hws, dns)]), ppu_c, device=CPU)
    for di, (h, dn) in enumerate(zip(hws, dns)):
        hr = _hw(RP, **h)
        row = [h["n_fus"] if dn is None else dn.get(t.name, h["n_fus"])
               for t in wl_r.tensors]
        want = RP.perf_kernel(
            wl_r, hr, bp.loop_dim, bp.loop_size, bp.S, bp.n_fus, bp.fill,
            true, np.broadcast_to(np.array([row]), (bp.n_candidates,
                                                    len(row))), ppu_c)
        _assert_scores({k: v[di] for k, v in got.items()}, want, (name, di))


@pytest.mark.parametrize("objective", ("cycles", "energy", "edp"))
@pytest.mark.parametrize("seed", range(2))
def test_best_mappings_torch_matches_reference(objective, seed):
    rng = random.Random(50 + seed)
    for _ in range(8):
        name, dims, hw, dn, ppu, _ = _random_case(rng)
        queries = [(dims, ppu)] + [
            ({d: rng.choice(_DIM_VALUES) for d in _RWL[name].iter_dims}, ppu)
            for _ in range(2)]
        want = RMB.best_mappings(_RWL[name], queries, _menu(RM, name),
                                 _hw(RP, **hw), data_nodes_per_tensor=dn,
                                 objective=objective, engine="numpy")
        for engine in ("torch", "numpy"):
            got = PMB.best_mappings(_PWL[name], queries, _menu(PM, name),
                                    _hw(PP, **hw), data_nodes_per_tensor=dn,
                                    objective=objective, engine=engine,
                                    device=CPU)
            for qi, (mp, mr) in enumerate(zip(got, want)):
                _assert_same_mapping(mp, mr, (engine, name, qi, objective))


@pytest.mark.parametrize("objective", ("cycles", "energy", "edp"))
def test_best_mapping_every_engine_matches_reference(objective):
    rng = random.Random(7)
    assert ENGINES == ("numpy", "torch", "scalar")
    for _ in range(6):
        name, dims, hw, dn, ppu, _ = _random_case(rng)
        want = RM.best_mapping(_RWL[name], dims, _menu(RM, name),
                               _hw(RP, **hw), data_nodes_per_tensor=dn,
                               ppu_elements=ppu, objective=objective)
        for engine in ENGINES + ("batch",):
            got = PM.best_mapping(_PWL[name], dims, _menu(PM, name),
                                  _hw(PP, **hw), data_nodes_per_tensor=dn,
                                  ppu_elements=ppu, objective=objective,
                                  engine=engine, device=CPU)
            _assert_same_mapping(got, want, (engine, name, objective))


@pytest.mark.parametrize("objective", ("cycles", "energy", "edp"))
@pytest.mark.parametrize("engine", ("torch", "numpy"))
def test_best_mappings_design_matches_reference(objective, engine):
    rng = random.Random({"cycles": 1, "energy": 2, "edp": 3}[objective])
    for _ in range(4):
        name, _, hw, _, ppu, _ = _random_case(rng)
        wl_r = _RWL[name]
        queries = [({d: rng.choice(_DIM_VALUES) for d in wl_r.iter_dims},
                    ppu) for _ in range(rng.choice([1, 2, 3]))]
        hws = [dict(n_fus=hw["n_fus"],
                    buffer_bytes=rng.choice(_HW_MENU["buffer_bytes"]),
                    dram_gbps=rng.choice(_HW_MENU["dram_gbps"]))
               for _ in range(rng.choice([1, 3, 4]))]
        dns = [PF.estimate_data_nodes(hw["n_fus"],
                                      [t.name for t in wl_r.tensors])
               if i % 2 else None for i in range(len(hws))]
        timing = {}
        got = PMB.best_mappings_design(
            _PWL[name], queries, _menu(PM, name), [_hw(PP, **h) for h in hws],
            data_nodes_per_tensor_list=dns, objective=objective,
            engine=engine, device=CPU, timing=timing)
        assert set(timing) >= {"dispatch_s", "select_s"}
        for di, (h, dn) in enumerate(zip(hws, dns)):
            want = RMB.best_mappings(_RWL[name], queries, _menu(RM, name),
                                     _hw(RP, **h), data_nodes_per_tensor=dn,
                                     objective=objective, engine="numpy")
            for qi, (mp, mr) in enumerate(zip(got[di], want)):
                _assert_same_mapping(mp, mr, (name, di, qi, objective))


def test_best_mappings_design_refuses_mixed_fu_counts():
    with pytest.raises(AssertionError, match="share n_fus"):
        PMB.best_mappings_design(
            _PWL["gemm"], [({"i": 8, "j": 8, "k": 8}, 0.0)],
            _menu(PM, "gemm"), [PP.HWConfig(n_fus=64),
                                PP.HWConfig(n_fus=128)], device=CPU)


@pytest.mark.parametrize("engine", ("jax", "cuda", ""))
def test_unknown_engines_are_refused(engine):
    b = PMB.build_batch(_PWL["gemm"], [{"i": 8, "j": 8, "k": 8}],
                        _menu(PM, "gemm"), PP.HWConfig(n_fus=64))
    with pytest.raises(ValueError, match="unknown engine"):
        PMB.evaluate_batch(b, PP.HWConfig(n_fus=64),
                           [{"i": 8, "j": 8, "k": 8}], [0.0], engine=engine,
                           device=CPU)


# ---------------------------------------------------------------------------
# no quiet CPU fallback
# ---------------------------------------------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _gemm_batch():
    hp = PP.HWConfig(n_fus=64)
    b = PMB.build_batch(_PWL["gemm"], [{"i": 64, "j": 64, "k": 64}],
                        _menu(PM, "gemm"), hp)
    args = (b.loop_dim, b.loop_size, b.S, b.n_fus, b.fill,
            np.full_like(b.S, RP.NO_TRUE_SIZE),
            np.full((b.n_candidates, 3), 8, dtype=np.int64),
            np.zeros(b.n_candidates))
    return hp, args


@pytest.mark.parametrize("entry", ("perf_kernel_torch",
                                   "perf_kernel_torch_design",
                                   "best_mappings", "prefill_sweep",
                                   "best_mapping_perfs", "Evaluator",
                                   "batch_sweep", "DecodeCostModel",
                                   "simulate"))
def test_entry_points_default_to_the_card(no_card, entry, tmp_path):
    hp, args = _gemm_batch()
    zoo = PB.sweep_zoo(("gemma_7b",), (64,), True)
    point = next(PS.SPACES["tiny"].enumerate())
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if entry == "best_mapping_perfs":
            PCache.MappingCache().best_mapping_perfs(
                _PWL["gemm"], [({"i": 8, "j": 8, "k": 8}, 0.0)],
                _menu(PM, "gemm"), hp, engine="torch")
        elif entry == "Evaluator":
            PEv.Evaluator(zoo=zoo, engine="torch")
        elif entry == "batch_sweep":
            # the sweep prefills on the evaluator's device, whatever its
            # engine: the card unless the CPU is named
            PB.batch_sweep(PS.SPACES["tiny"], PEv.Evaluator(zoo=zoo))
        elif entry == "DecodeCostModel":
            PSim.DecodeCostModel(point, engine="torch")
        elif entry == "simulate":
            PSim.simulate(point, engine="torch")
        elif entry == "perf_kernel_torch":
            perf_kernel_torch(_PWL["gemm"], hp, *args)
        elif entry == "perf_kernel_torch_design":
            perf_kernel_torch_design(_PWL["gemm"], [hp], *args[:6],
                                     args[6][:1], args[7])
        elif entry == "best_mappings":
            PMB.best_mappings(_PWL["gemm"], [({"i": 8, "j": 8, "k": 8}, 0.0)],
                              _menu(PM, "gemm"), hp, engine="torch")
        else:
            PB.prefill_sweep(PS.SPACES["tiny"],
                             PB.sweep_zoo(("gemma_7b",), (64,), True),
                             PCache.MappingCache(tmp_path / "c.json"))


def test_cli_refuses_a_missing_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PB.main(["--space", "tiny", "--configs", "gemma_7b", "--reduced",
                 "--seq", "64", "--cache-path", str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()


# ---------------------------------------------------------------------------
# the mapping cache carried across: port prefill <-> reference evaluation
# ---------------------------------------------------------------------------

_TINY_ZOO = dict(configs=("gemma_7b",), seq=64, reduced=True)


def _ref_zoo():
    return ref_load_zoo(_TINY_ZOO["configs"], seq=_TINY_ZOO["seq"],
                        reduced=True)


def _ref_sweep(cache):
    ev = Evaluator(zoo=_ref_zoo(), cache=cache, engine="numpy")
    res = exhaustive_search(RS.SPACES["tiny"], ev)
    evals = json.dumps([e.as_dict() for e in res.evals], sort_keys=True)
    front = json.dumps([e.as_dict() for e in res.frontier], sort_keys=True)
    return ev, evals, front


@pytest.fixture(scope="module")
def cold_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref_cache.json"
    cache = RCache.MappingCache(path)
    _, evals, front = _ref_sweep(cache)
    cache.save()
    return path, evals, front


def _port_prefill(path, d_tile=2):
    zoo = PB.sweep_zoo(_TINY_ZOO["configs"], (_TINY_ZOO["seq"],),
                       reduced=True)
    assert zoo == _ref_zoo()
    cache = PCache.MappingCache(path)
    stats = PB.prefill_sweep(PS.SPACES["tiny"], zoo, cache, d_tile=d_tile,
                             device=CPU)
    cache.save()
    return stats


def test_port_prefill_makes_the_reference_evaluator_hit_everything(
        cold_reference, tmp_path):
    _, cold_evals, cold_front = cold_reference
    path = tmp_path / "port_cache.json"
    stats = _port_prefill(path)
    assert stats["designs"] == len(list(RS.SPACES["tiny"].enumerate()))
    assert stats["entries_added"] > 0 and stats["dispatches"] > 0
    assert stats["tiles"] == len(PB.plan_tiles(
        list(PS.SPACES["tiny"].enumerate()), 2))
    ev, evals, front = _ref_sweep(RCache.MappingCache(path))
    assert ev.cache.misses == 0 and ev.cache.hits > 0
    assert evals == cold_evals
    assert front == cold_front


def test_port_prefill_writes_the_reference_entries(cold_reference, tmp_path):
    """Entry for entry, the port's prefill is the reference's cold sweep."""
    ref_path = cold_reference[0]
    path = tmp_path / "port_cache.json"
    _port_prefill(path, d_tile=32)
    got, want = json.loads(path.read_text()), json.loads(ref_path.read_text())
    assert got["schema"] == want["schema"] == 3
    assert got["entries"] == want["entries"]
    assert got["sums"] == want["sums"]


def test_reference_cache_leaves_the_port_nothing_to_add(cold_reference,
                                                        tmp_path):
    path = tmp_path / "ref_copy.json"
    path.write_text(cold_reference[0].read_text())
    n = len(PCache.MappingCache(path))
    stats = _port_prefill(path)
    assert stats["entries_added"] == 0 and stats["dispatches"] == 0
    assert len(PCache.MappingCache(path)) == n


def test_port_cache_quarantines_a_corrupt_entry_as_the_reference(tmp_path):
    path = tmp_path / "c.json"
    _port_prefill(path)
    payload = json.loads(path.read_text())
    k = sorted(payload["entries"])[0]
    payload["entries"][k]["perf"]["cycles"] += 1.0
    path.write_text(json.dumps(payload))
    port, ref = PCache.MappingCache(path), RCache.MappingCache(path)
    assert len(port) == len(ref) == len(payload["entries"]) - 1
    assert not port.contains(k) and port.get(k) is None
    assert port.stats["misses"] == 1


def test_port_cache_save_merges_what_another_writer_saved(tmp_path):
    path = tmp_path / "c.json"
    a, b = PCache.MappingCache(path), RCache.MappingCache(path)
    a.put("a", {"perf": {"cycles": 1.0}})
    b.put("b", {"perf": {"cycles": 2.0}})
    b.save()
    a.save()
    assert set(json.loads(path.read_text())["entries"]) == {"a", "b"}
    assert RCache.MappingCache(path).get("a") == {"perf": {"cycles": 1.0}}


def test_cli_prefills_the_cache(tmp_path, capsys):
    path = tmp_path / "c.json"
    to = ["--out", str(tmp_path / "sweep.json")]
    assert PB.main(["--space", "tiny", "--configs", "gemma_7b", "--reduced",
                    "--seq", "64", "--design-batch", "--d-tile", "4",
                    "--device", "cpu", "--cache-path", str(path)] + to) == 0
    out = capsys.readouterr().out
    assert "designs in" in out and "candidates/s" in out
    n = len(RCache.MappingCache(path))
    assert n > 0
    PB.main(["--space", "tiny", "--configs", "gemma_7b", "--reduced",
             "--seq", "64", "--design-batch", "--device", "cpu",
             "--cache-path", str(path)] + to)
    assert "0 entries added" in capsys.readouterr().out

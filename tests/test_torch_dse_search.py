"""The port's DSE evaluation half (repro_torch.dse: Evaluator, searches,
supervised pool, batch_sweep, serving replay, report text) against the
reference's (repro.dse) on the CPU.

The reference runs its NumPy engine (its "jax" engine cannot import
``enable_x64`` on the installed jax); the port runs ``engine="torch",
device="cpu"`` and ``engine="numpy"``.  Integers, names, visit orders and
frontiers must be identical, energies within ENERGY_RTOL = 1e-9 relative;
no other tolerance is used.  Sizes: the DSE's default zoo in its smoke
configs at seq 64, the ``tiny`` and ``small`` spaces (``huge`` for the
guided search under a small budget).

    PYTHONPATH=src python -m pytest -q tests/test_torch_dse_search.py
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import baselines as RBase
from repro.core import fusion as RF
from repro.core import perf_model as RP
from repro.core import workload as RW
from repro.dse import cache as RCache
from repro.dse import evaluate as REv
from repro.dse import report as RR
from repro.dse import search as RSearch
from repro.dse import space as RS
from repro.serve import sim as RSim
from repro_torch.core import baselines as PBase
from repro_torch.core import fusion as PF
from repro_torch.core import mapper_batch as PMB
from repro_torch.core import workload as PW
from repro_torch.core.perf_model_torch import ENERGY_RTOL
from repro_torch.dse import batch_sweep as PB
from repro_torch.dse import cache as PCache
from repro_torch.dse import evaluate as PEv
from repro_torch.dse import report as PR
from repro_torch.dse import search as PSearch
from repro_torch.dse import space as PS
from repro_torch.dse import supervisor as PSup
from repro_torch.dse.faults import FaultPlan
from repro_torch.serve import sim as PSim

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent
# the port's engines on the CPU, each held to the reference's NumPy engine
ENGINES = ("torch", "numpy")
ZOO_KW = dict(seq=64, reduced=True)
# keys whose values are energies or derive from them: held within
# ENERGY_RTOL, every other number exactly
_ENERGY = ("energy_pj", "energy_vs_gemmini", "energy_fused_attention",
           "gops_per_w")


def _same(got, want, path="", energy=False):
    """Recursive equality: names, integers and other floats exact, energy
    floats within ENERGY_RTOL relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", energy or k in _ENERGY)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]", energy)
    elif isinstance(want, float) and energy:
        assert isinstance(got, float), path
        assert abs(got - want) <= ENERGY_RTOL * abs(want), \
            f"{path}: {got!r} vs {want!r}"
    else:
        assert type(got) is type(want) and got == want, \
            f"{path}: {got!r} vs {want!r}"


def _evals(res):
    return [e.as_dict() for e in res.evals]


def _same_result(got, want):
    """Two SearchResults: the same designs in the same order, the same
    scorecards and the same frontier."""
    assert [e.point.name for e in got.evals] == \
        [e.point.name for e in want.evals]
    assert [e.point.name for e in got.frontier] == \
        [e.point.name for e in want.frontier]
    _same(_evals(got), _evals(want))
    _same([e.as_dict() for e in got.frontier],
          [e.as_dict() for e in want.frontier])


@pytest.fixture(scope="module")
def zoo():
    z = PEv.load_zoo(PEv.DEFAULT_ZOO, **ZOO_KW)
    assert z == REv.load_zoo(REv.DEFAULT_ZOO, **ZOO_KW)
    return z


def _port_ev(zoo, engine, **kw):
    return PEv.Evaluator(zoo=zoo, cache=PCache.MappingCache(), engine=engine,
                         device=CPU, **kw)


def _ref_ev(zoo, **kw):
    return REv.Evaluator(zoo=zoo, cache=RCache.MappingCache(),
                         engine="numpy", **kw)


@pytest.fixture(scope="module")
def ref_small(zoo):
    """The reference's cold exhaustive sweep of ``small`` with the Gemmini
    baseline (the acceptance sweep, reduced)."""
    return RSearch.exhaustive_search(RS.SPACES["small"],
                                     _ref_ev(zoo, baseline="gemmini"))


@pytest.fixture(scope="module")
def port_small(zoo):
    return PSearch.exhaustive_search(
        PS.SPACES["small"], _port_ev(zoo, "numpy", baseline="gemmini"))


# ---------------------------------------------------------------------------
# the scoring half of core: baselines and fusion
# ---------------------------------------------------------------------------

_GEMMINI_GRID = {
    "gemm": [{"i": i, "j": j, "k": k} for i in (1, 7, 64, 513)
             for j in (16, 100) for k in (3, 256)],
    "conv": [{"n": 1, "oh": o, "ow": o, "ic": ic, "oc": 32, "kh": kh,
              "kw": kh} for o in (7, 28) for ic in (3, 64) for kh in (1, 3)],
    "dwconv": [{"n": n, "oh": o, "ow": o, "c": c, "kh": 3, "kw": 3}
               for n in (1, 2) for o in (14, 56) for c in (32, 96)],
}


@pytest.mark.parametrize("kind", sorted(_GEMMINI_GRID))
def test_gemmini_layer_perf_copy(kind):
    assert PBase.GEMMINI_HW.signature() == RBase.GEMMINI_HW.signature()
    for dims in _GEMMINI_GRID[kind]:
        for ppu in (0.0, 4096.0):
            got = PBase.gemmini_layer_perf(kind, dims, ppu_elements=ppu)
            want = RBase.gemmini_layer_perf(kind, dims, ppu_elements=ppu)
            _same(got.as_dict(), want.as_dict(), f"{kind} {dims} {ppu}")


@pytest.mark.parametrize("engine", ENGINES + ("default",))
def test_score_design_over_zoo_matches_reference(zoo, engine):
    """Every design of ``tiny`` (fused and unfused lowerings), through the
    cache's front door on each engine and through the default batched
    solver."""
    for p in RS.SPACES["tiny"].enumerate():
        pp = PS.DesignPoint.from_dict(p.as_dict())
        fused = p.supports("attention_qk") and p.supports("attention_pv")
        if engine == "default":
            pfn = rfn = None
        else:
            pfn = functools.partial(PCache.MappingCache().best_mapping_perfs,
                                    engine=engine, device=CPU)
            rfn = functools.partial(RCache.MappingCache().best_mapping_perfs,
                                    engine="numpy")
        got = PF.score_design_over_zoo(
            PEv.zoo_layers(zoo, fused), pp.spatials, pp.hw_config(),
            batch_mapping_fn=pfn)
        want = RF.score_design_over_zoo(
            REv.Evaluator(zoo=zoo)._zoo_layers(fused), p.spatials,
            p.hw_config(), batch_mapping_fn=rfn)
        assert list(got) == list(want)
        for m in want:
            _same(vars(got[m]), vars(want[m]), f"{p.name} {m}")
            _same(got[m].gops_per_w, want[m].gops_per_w, m, energy=True)


def test_apply_attention_fusion_credits_as_the_reference(zoo):
    """The P-residency credit on each fused pair, at a buffer the score
    slice fits in and one it does not: the same pairs fused, the same
    perfs after."""
    rows = [r for r in PEv.zoo_layers(zoo, True)["gemma_7b"]
            if r[0].name in ("attention_qk", "attention_pv")]
    ref_rows = [r for r in REv.Evaluator(zoo=zoo)._zoo_layers(True)[
        "gemma_7b"] if r[0].name in ("attention_qk", "attention_pv")]
    assert len(rows) == 2
    fused = []
    for kb in (1, 1024):
        p = PS.DesignPoint(n_fus=256, buffer_kb=kb, dram_gbps=16.0,
                           dataflow_set="attention_fused")
        hw = p.hw_config()
        perfs = [PMB.best_mappings(
            wl, [(dims, ppu)], p.spatials(wl.name), hw,
            data_nodes_per_tensor=PF.estimate_data_nodes(
                p.n_fus, [t.name for t in wl.tensors]))[0].perf
            for wl, dims, _, ppu in rows]
        rperfs = [RP.LayerPerf.from_dict(q.as_dict()) for q in perfs]
        n = PF.apply_attention_fusion(rows, perfs, hw)
        assert n == RF.apply_attention_fusion(ref_rows, rperfs, hw)
        assert n == int(PF.attention_fusion_viable(rows[1][1], hw))
        _same([q.as_dict() for q in perfs], [q.as_dict() for q in rperfs])
        fused.append(n)
    assert fused == [0, 1]


# ---------------------------------------------------------------------------
# the cache's mapper front door
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES + ("scalar",))
def test_best_mapping_perfs_entries_and_keys(engine):
    """The port's front door writes the reference's entries under the
    reference's keys, answers hits from the store and ships only new
    entries through drain_new."""
    p = RS.DesignPoint(n_fus=64, buffer_kb=128, dram_gbps=16.0,
                       dataflow_set="attention_fused")
    hw = p.hw_config()
    port, ref = PCache.MappingCache(), RCache.MappingCache()
    queries = [({"i": 64, "j": 96, "k": 32}, 0.0),
               ({"i": 7, "j": 512, "k": 130}, 512.0),
               ({"i": 64, "j": 96, "k": 32}, 0.0)]
    pwl, rwl = PW.gemm(), RW.gemm()
    dn = PF.estimate_data_nodes(p.n_fus, ["X", "W", "Y"])
    got = port.best_mapping_perfs(pwl, queries, p.spatials("gemm"), hw, dn,
                                  engine=engine, device=CPU)
    want = ref.best_mapping_perfs(rwl, queries, p.spatials("gemm"), hw, dn,
                                  engine="numpy")
    _same([g.as_dict() for g in got], [w.as_dict() for w in want])
    _same(port.snapshot(), ref.snapshot())
    assert (port.hits, port.misses) == (ref.hits, ref.misses) == (0, 3)
    new = port.drain_new()
    assert list(new) == list(ref.drain_new()) and port.drain_new() == {}
    d, ppu = queries[1]
    assert port.lookup_spatial(pwl, d, p.spatials("gemm"), hw, dn, ppu) == \
        ref.lookup_spatial(rwl, d, p.spatials("gemm"), hw, dn, ppu) is not None
    h0 = port.hits
    again = port.best_mapping_perf(pwl, d, p.spatials("gemm"), hw, dn, ppu,
                                   engine=engine, device=CPU)
    assert port.hits == h0 + 1 and again == got[1]
    other = PCache.MappingCache()
    assert other.merge(new) == len(new) == 2 and other.merge(new) == 0
    assert other.drain_new() == {}


# ---------------------------------------------------------------------------
# the Evaluator and the searches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_evaluator_per_design_matches_reference(zoo, ref_small, engine):
    """Every design of ``small``, Gemmini baseline and fused-attention
    speedups included, evaluated one at a time on a cold cache."""
    ev = _port_ev(zoo, engine, baseline="gemmini")
    for e in ref_small.evals:
        got = ev.evaluate(PS.DesignPoint.from_dict(e.point.as_dict()))
        _same(got.as_dict(), e.as_dict(), e.point.name)
    # the records compared above are there: Gemmini on every model, the
    # fused-attention speedup on the attention-bearing ones
    rec = next(e for e in ref_small.evals
               if e.point.dataflow_set == "attention_fused").per_config
    assert sorted(m for m, r in rec.items()
                  if "speedup_fused_attention" in r) == \
        ["deepseek_moe_16b", "gemma_7b", "glm4_9b"]
    assert all("speedup_vs_gemmini" in r for r in rec.values())
    assert ev.baselines == PEv.gemmini_zoo_baseline(zoo)
    _same(ev.baselines, REv.gemmini_zoo_baseline(zoo))


def test_evaluator_refuses_an_unknown_engine(zoo):
    with pytest.raises(ValueError, match="unknown engine"):
        PEv.Evaluator(zoo=zoo, engine="jax")
    assert PEv.Evaluator(zoo=zoo, engine="batch").engine == "batch"


@pytest.mark.parametrize("engine", ENGINES)
def test_exhaustive_search_matches_reference(zoo, ref_small, engine):
    got = PSearch.exhaustive_search(
        PS.SPACES["small"], _port_ev(zoo, engine, baseline="gemmini"))
    _same_result(got, ref_small)
    assert got.cache_stats["misses"] > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_evolutionary_search_matches_reference(zoo, engine):
    kw = dict(population=6, generations=3, seed=5)
    got = PSearch.evolutionary_search(PS.SPACES["small"],
                                      _port_ev(zoo, engine), **kw)
    want = RSearch.evolutionary_search(RS.SPACES["small"], _ref_ev(zoo),
                                       **kw)
    _same_result(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_evolve_search_matches_reference(zoo, engine):
    """The guided search over the 10^5-point space: the same visit order,
    prefilter and frontier per (seed, budget)."""
    kw = dict(budget=40, seed=3, population=8)
    got = PSearch.evolve_search(PS.SPACES["huge"], _port_ev(zoo, engine),
                                **kw)
    want = RSearch.evolve_search(RS.SPACES["huge"], _ref_ev(zoo), **kw)
    assert got.extra == want.extra
    assert got.extra["prefilter_evals"] > 0 and got.extra["spent"] == 40
    _same_result(got, want)


@pytest.mark.parametrize("strategy", ("auto", "exhaustive", "evolve"))
def test_run_search_dispatches_as_the_reference(zoo, strategy):
    kw = {"budget": 8} if strategy == "evolve" else {}
    got = PSearch.run_search(PS.SPACES["tiny"], _port_ev(zoo, "torch"),
                             strategy=strategy, **kw)
    want = RSearch.run_search(RS.SPACES["tiny"], _ref_ev(zoo),
                              strategy=strategy, **kw)
    assert got.strategy == want.strategy
    _same_result(got, want)


# ---------------------------------------------------------------------------
# batch_sweep: prefill then evaluate, against exhaustive_search
# ---------------------------------------------------------------------------

def test_batch_sweep_is_exhaustive_search(zoo, ref_small, port_small,
                                          tmp_path):
    """Byte-identical evals and frontier, every evaluation a hit, and a
    frontier snapshot in the ledger every ``snapshot_every`` tiles."""
    ev = _port_ev(zoo, "numpy", baseline="gemmini")
    ledger = PSup.RunLedger(tmp_path / "run.ledger")
    stats = PB.new_stats()
    with PSup.Supervisor(ev, ledger=ledger) as sup:
        got = PB.batch_sweep(PS.SPACES["small"], ev, supervisor=sup,
                             d_tile=8, snapshot_every=2, stats=stats)
    assert json.dumps(_evals(got), sort_keys=True) == \
        json.dumps(_evals(port_small), sort_keys=True)
    assert [e.as_dict() for e in got.frontier] == \
        [e.as_dict() for e in port_small.frontier]
    _same_result(got, ref_small)
    assert got.strategy == "exhaustive" and got.space == "small"
    assert got.cache_stats["misses"] == 0 and got.cache_stats["hits"] > 0
    assert stats["tiles"] == 20 and stats["designs"] == 60
    assert stats["entries_added"] == len(ev.cache) > 0
    assert stats["prefill_s"] > 0 and stats["eval_s"] > 0
    snaps = ledger.frontier_snapshots()
    assert [s["n_evals"] for s in snaps] == list(range(6, 61, 6))
    assert snaps[-1]["frontier"] == [e.point.name for e in got.frontier]
    assert len(ledger) == 60


def test_batch_sweep_resumes_from_the_ledger(zoo, port_small, tmp_path):
    """Designs the ledger completed skip prefill and evaluation."""
    done = {e.point.name: e for e in port_small.evals[:20]}
    ev = _port_ev(zoo, "numpy", baseline="gemmini")
    with PSup.Supervisor(ev, completed=done) as sup:
        got = PB.batch_sweep(PS.SPACES["small"], ev, supervisor=sup)
    assert sup.stats["resumed"] == 20 and sup.stats["evaluated"] == 40
    assert [e.as_dict() for e in got.frontier] == \
        [e.as_dict() for e in port_small.frontier]


def test_batch_sweep_refuses_workers_and_runs_in_process(zoo, caplog):
    ev = _port_ev(zoo, "torch")
    with caplog.at_level("WARNING", logger="repro_torch.dse.batch_sweep"):
        got = PB.batch_sweep(PS.SPACES["tiny"], ev, workers=3)
    assert "batch_sweep ignores workers=3" in caplog.text
    assert got.supervisor["evaluated"] == 6
    _same_result(got, RSearch.exhaustive_search(RS.SPACES["tiny"],
                                                _ref_ev(zoo)))


def test_batch_sweep_prefills_on_the_evaluators_device(zoo):
    """The prefill runs where the evaluator was told to score, whatever its
    engine; a second sweep over the warm cache adds nothing."""
    ev = _port_ev(zoo, "numpy")
    s1, s2 = PB.new_stats(), PB.new_stats()
    PB.batch_sweep(PS.SPACES["tiny"], ev, stats=s1)
    PB.batch_sweep(PS.SPACES["tiny"], ev, stats=s2)
    assert s1["dispatches"] > 0 and s1["candidates_scored"] > 0
    assert s2["dispatches"] == s2["entries_added"] == 0


# ---------------------------------------------------------------------------
# the supervised pool
# ---------------------------------------------------------------------------

def _tiny_clean(zoo):
    with PSup.Supervisor(_port_ev(zoo, "numpy")) as sup:
        return sup.map(list(PS.SPACES["tiny"].enumerate()))


def test_pool_frontier_is_worker_count_independent(zoo, port_small):
    ev = _port_ev(zoo, "torch", baseline="gemmini")
    got = PSearch.exhaustive_search(PS.SPACES["small"], ev, workers=2)
    assert got.supervisor["evaluated"] == 60
    assert json.dumps(_evals(got), sort_keys=True) == \
        json.dumps(_evals(port_small), sort_keys=True)
    assert [e.point.name for e in got.frontier] == \
        [e.point.name for e in port_small.frontier]
    # the workers' new entries merged back into the parent's cache
    assert got.cache_stats["entries"] == port_small.cache_stats["entries"]


def test_pool_crash_converges_to_the_clean_frontier(zoo):
    """A worker that dies mid-evaluation is respawned and its design
    retried; the answers are the clean run's (tests/test_robustness.py's
    bar for the reference)."""
    clean = _tiny_clean(zoo)
    ev = _port_ev(zoo, "numpy")
    with PSup.Supervisor(ev, workers=2, fault_plan=FaultPlan(crash=1, seed=0),
                         cfg=PSup.SupervisorConfig(backoff_base_s=0.0)) \
            as sup:
        evals = sup.map(list(PS.SPACES["tiny"].enumerate()))
    assert sup.stats["respawns"] >= 1 and sup.stats["retries"] == 1
    assert sup.stats["quarantined"] == 0
    assert [e.as_dict() for e in evals] == [e.as_dict() for e in clean]
    assert [e.point.name for e in PSearch.pareto_frontier(evals)] == \
        [e.point.name for e in PSearch.pareto_frontier(clean)]


def test_pool_spawns_once_cuda_is_up(zoo, monkeypatch):
    ev = _port_ev(zoo, "numpy")
    assert PSup.Supervisor(ev, workers=2)._ctx.get_start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    sup = PSup.Supervisor(ev, workers=2)
    assert sup._ctx.get_start_method() == "spawn"


def test_spawned_pool_gives_the_clean_answers(zoo, monkeypatch):
    """A spawned worker starts from a fresh import (what the pool does on
    the card): everything it is sent pickles and its answers are the
    in-process ones."""
    clean = _tiny_clean(zoo)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with PSup.Supervisor(_port_ev(zoo, "numpy"), workers=2) as sup:
        assert sup._ctx.get_start_method() == "spawn"
        evals = sup.map(list(PS.SPACES["tiny"].enumerate()))
    assert sup.stats["respawns"] == 0 and sup.stats["evaluated"] == 6
    assert [e.as_dict() for e in evals] == [e.as_dict() for e in clean]


# ---------------------------------------------------------------------------
# the serving replay
# ---------------------------------------------------------------------------

def _serving_spec(mod):
    trace = mod.TraceSpec(requests=12, rate_rps=2.0,
                          models=(("gemma_7b", 2.0), ("rwkv6_7b", 1.0)),
                          prompt_mean=24, prompt_max=64, output_mean=6,
                          output_max=16)
    return mod.ServingSpec(trace=trace, kv_capacity_bytes=1 << 20,
                           max_batch=4, reduced=True)


@pytest.mark.parametrize("engine", ENGINES)
def test_simulate_summary_matches_reference(engine):
    from repro.serve import trace as RT
    from repro_torch.serve import trace as PT
    rspec, pspec = _serving_spec(RSim), _serving_spec(PSim)
    pspec = PSim.ServingSpec(trace=PT.TraceSpec(**vars(rspec.trace)),
                             **{k: v for k, v in vars(pspec).items()
                                if k != "trace"})
    assert PT.generate_trace(pspec.trace) == [
        PT.Request(**r.as_dict()) for r in RT.generate_trace(rspec.trace)]
    for p in RS.SPACES["tiny"].enumerate():
        pp = PS.DesignPoint.from_dict(p.as_dict())
        got = PSim.simulate(pp, spec=pspec, engine=engine, device=CPU,
                            record_steps=True)
        want = RSim.simulate(p, spec=rspec, engine="numpy",
                             record_steps=True)
        _same(got.summary(), want.summary(), p.name)
        assert got.requests == want.requests and got.steps == want.steps


def test_evaluator_serving_matches_reference(zoo):
    """``Evaluator(serving=...)``: every design's serving scorecard and the
    goodput axis of the frontier."""
    pspec = PSim.ServingSpec(trace=PSim.TraceSpec(requests=6),
                             reduced=True)
    rspec = RSim.ServingSpec(trace=RSim.TraceSpec(requests=6), reduced=True)
    got = PSearch.exhaustive_search(
        PS.SPACES["tiny"], _port_ev(zoo, "torch", serving=pspec))
    want = RSearch.exhaustive_search(RS.SPACES["tiny"],
                                     _ref_ev(zoo, serving=rspec))
    _same_result(got, want)
    assert all(e.serving is not None for e in got.evals)
    assert PR.format_serving(got) == RR.format_serving(want)
    assert got.best("goodput").point.name == want.best("goodput").point.name


# ---------------------------------------------------------------------------
# report text and writers
# ---------------------------------------------------------------------------

def test_report_text_matches_reference(port_small, ref_small):
    assert PR.format_frontier(port_small) == RR.format_frontier(ref_small)
    assert PR.format_scorecard(port_small.evals) == \
        RR.format_scorecard(ref_small.evals)
    assert PR.format_scorecard(port_small.evals, limit=5) == \
        RR.format_scorecard(ref_small.evals, limit=5)
    assert PR.format_models(port_small) == RR.format_models(ref_small)
    pw, pg, pm = PR.cross_model_winner(port_small.frontier)
    rw, rg, rm = RR.cross_model_winner(ref_small.frontier)
    assert (pw.point.name, pm) == (rw.point.name, rm)
    _same(pg, rg, energy=False)
    for obj in ("cycles", "energy", "area", "edp"):
        assert port_small.best(obj).point.name == \
            ref_small.best(obj).point.name


def test_cross_model_winner_without_a_baseline(zoo):
    got = PSearch.exhaustive_search(PS.SPACES["tiny"], _port_ev(zoo, "torch"))
    want = RSearch.exhaustive_search(RS.SPACES["tiny"], _ref_ev(zoo))
    pw, pg, pm = PR.cross_model_winner(got.evals)
    rw, rg, rm = RR.cross_model_winner(want.evals)
    assert (pw.point.name, pg, pm) == (rw.point.name, rg, rm)
    assert pm == "geomean_normalized_cycles"


def test_writers_write_the_reference_layout(port_small, ref_small, tmp_path):
    """The sweep and cross-model JSON: the reference's keys and the same
    designs, frontier, winner and best (provenance and metrics differ by
    nature: host, time, counters of this process)."""
    prov = {"schema": 1}
    for writer in ("write_bench_json", "write_models_json"):
        kw = {"model_ids": list(REv.DEFAULT_ZOO)} \
            if writer == "write_models_json" else {}
        got = getattr(PR, writer)(str(tmp_path / "p.json"), port_small,
                                  metrics={}, provenance=prov, **kw)
        want = getattr(RR, writer)(str(tmp_path / "r.json"), ref_small,
                                   metrics={}, provenance=prov, **kw)
        for k in ("wall_s", "cache", "supervisor"):
            got.pop(k), want.pop(k)
        if writer == "write_models_json":
            _same(got["baseline"], want["baseline"])
            got.pop("baseline"), want.pop("baseline")
        _same(got, want)
        assert json.loads((tmp_path / "p.json").read_text())["bench"] == \
            want["bench"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["p.json", "r.json"]


def test_provenance_records_torch_without_initialising_cuda():
    from repro_torch.obs import provenance_record
    rec = provenance_record(argv=["x"])
    assert rec["torch"] == torch.__version__ and rec["device"] is None
    assert rec["argv"] == ["x"] and not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_CLI = ["--space", "small", "--reduced", "--seq", "64", "--d-tile", "8"]


@pytest.mark.parametrize("strategy", ("exhaustive", "evolve"))
def test_cli_refuses_a_missing_card(monkeypatch, tmp_path, strategy):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PB.main(_CLI + ["--strategy", strategy, "--cache-path",
                        str(tmp_path / "c.json"), "--out",
                        str(tmp_path / "o.json")])
    assert list(tmp_path.iterdir()) == []


def test_cli_on_the_cpu_prints_the_reference_frontier(ref_small, tmp_path,
                                                      capsys, monkeypatch):
    """--device cpu: prefill, evaluate, the reference's frontier text (the
    reference's sweep here has the Gemmini baseline, which does not move
    the frontier) and the sweep's JSON at --out.  The engine
    micro-benchmark's design-axis section sweeps ``tiny``."""
    monkeypatch.setattr(PB, "DESIGN_AXIS_SPACE", "tiny")
    out = tmp_path / "sweep.json"
    assert PB.main(_CLI + ["--design-batch", "--device", "cpu",
                           "--cache-path", str(tmp_path / "c.json"),
                           "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert RR.format_frontier(ref_small) in text
    assert "60 designs in 20 tiles" in text and "0 misses" in text
    payload = json.loads(out.read_text())
    assert payload["bench"] == "dse" and payload["n_designs"] == 60
    assert [d["design"]["name"] for d in payload["frontier"]] == \
        [e.point.name for e in ref_small.frontier]
    assert payload["meta"]["device"] == "cpu"
    assert payload["meta"]["prefill"]["entries_added"] > 0
    assert payload["provenance"]["torch"] == torch.__version__


def test_cli_evolve_runs_the_guided_search(zoo, tmp_path, capsys):
    assert PB.main(["--space", "huge", "--reduced", "--seq", "64",
                    "--strategy", "evolve", "--budget", "12", "--seed", "2",
                    "--engine", "numpy", "--device", "cpu", "--cache-path",
                    str(tmp_path / "c.json"), "--out",
                    str(tmp_path / "o.json")]) == 0
    want = RSearch.evolve_search(RS.SPACES["huge"], _ref_ev(zoo), budget=12,
                                 seed=2)
    assert RR.format_frontier(want) in capsys.readouterr().out


# ---------------------------------------------------------------------------
# imports: torch, never jax or repro, and CUDA left alone
# ---------------------------------------------------------------------------

def test_dse_chain_imports_torch_but_never_initialises_cuda():
    """Importing the DSE chain (and running a search on the CPU) never
    initialises CUDA: the pool may fork until the caller brings CUDA up.
    Run in a fresh interpreter with CUDA's lazy init made to raise."""
    code = (
        "import sys, torch\n"
        "def boom(*a, **k): raise AssertionError('CUDA initialised')\n"
        "torch.cuda._lazy_init = boom\n"
        "torch.cuda.init = boom\n"
        "import repro_torch.dse, repro_torch.dse.batch_sweep\n"
        "import repro_torch.serve.sim, repro_torch.obs\n"
        "from repro_torch.dse import (SPACES, Evaluator, exhaustive_search,\n"
        "                             load_zoo)\n"
        "zoo = load_zoo(('gemma_7b',), seq=64, reduced=True)\n"
        "r = exhaustive_search(SPACES['tiny'], Evaluator(zoo=zoo), workers=2)\n"
        "assert r.supervisor['evaluated'] == 6\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', 'torch' in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["ok", "True"]

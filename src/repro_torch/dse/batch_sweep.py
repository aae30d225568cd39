"""Design-axis batched sweep on the card, and the design search's command
line: the twin of the reference's ``repro.dse.batch_sweep`` and of its
``benchmarks/dse.py``.

Candidate enumeration depends on a design only through its FU count, so:

1. **Group** the space by ``(n_fus, dataflow_set)``: every design in a
   group enumerates the identical candidate batch, shares its PPU count and
   √N data-node estimate, and differs only in its runtime HW parameters
   (buffer, bandwidth).
2. **Tile** each group along the design axis (:func:`plan_tiles`) and
   *prefill* the mapping cache: one
   :func:`~repro_torch.core.mapper_batch.best_mappings_design` dispatch per
   (tile, workload kind) scores every candidate of every missing (design,
   layer-shape) query on the card, selects on the host and re-scores the
   winners through NumPy; the entries are written in the reference's
   ``best_mapping_perfs`` entry format.
3. **Evaluate** each tile in-process through the ordinary
   :class:`~repro_torch.dse.supervisor.Supervisor` →
   :class:`~repro_torch.dse.evaluate.Evaluator` path on the now-warm
   cache.  Every query hits, so the evaluator only aggregates (fusion
   credits, baselines, area/power, serving replay), and the evals and the
   Pareto frontier are byte-identical to a per-design
   :func:`~repro_torch.dse.search.exhaustive_search`.
4. **Snapshot** the frontier into the supervisor's
   :class:`~repro_torch.dse.supervisor.RunLedger` every ``snapshot_every``
   tiles; designs the ledger already holds skip prefill and evaluation.

:func:`main` is the command line, with the reference's flags and meanings
plus ``--device``; the engine is ``torch`` on the card by default, and
without a card it raises.  ``--engine-bench`` (implied by ``--engine
torch``, the default, and by ``--design-batch``) records
:func:`engine_microbench` under ``meta["engine_bench"]``, the reference's
layout with ``torch`` where it has ``jax``.  ``--design-batch`` (with
``--d-tile`` and ``--snapshot-every``) runs :func:`batch_sweep`; otherwise
:func:`~repro_torch.dse.search.run_search` does the work, each miss scored
on the card.  It writes the reference's ``BENCH_dse.json`` layout (or
``BENCH_models.json`` with ``--models``) and, with ``--emit-dir``, one
Verilog netlist per wiring class on the frontier::

    python -m repro_torch.dse.batch_sweep --space small
    python -m repro_torch.dse.batch_sweep --space large --design-batch
    python -m repro_torch.dse.batch_sweep --models all --quick
    python -m repro_torch.dse.batch_sweep --space tiny --reduced --seq 64 \\
        --nets MobileNetV2 --emit-dir rtl --out sweep.json

A SIGTERM takes the Ctrl-C path: the ledger is flushed, a ``"partial":
true`` artifact written, and the command returns 130; ``--resume``
finishes it.
"""

from __future__ import annotations

import argparse
import os
import signal
import statistics
import sys
import time

from ..configs import ARCH_IDS, resolve_ids
from ..core import workload as W
from ..core.fusion import estimate_data_nodes
from ..core.mapper import SpatialChoice
from ..core.mapper_batch import (best_mappings, best_mappings_design,
                                 build_batch, evaluate_batch)
from ..core.perf_model import HWConfig
from ..core.perf_model_torch import ENGINES
from ..frontend import PHASES, has_attention_rows
from ..models.common import check_device, synchronize
from ..obs import (METRICS, add_verbosity_flag, configure, enable_tracing,
                   get_logger, provenance_record, save_trace,
                   set_metrics_enabled, span)
from ..serve.sim import SLO, ServingSpec
from ..serve.trace import parse_trace_spec
from .cache import MappingCache, mapping_key
from .evaluate import DEFAULT_ZOO, Evaluator, load_zoo, zoo_layers
from .faults import (FaultPlan, corrupt_cache_file, parse_fault_spec,
                     plan_from_env)
from .report import (emit_frontier_rtl, format_frontier, format_models,
                     format_scorecard, format_serving, write_bench_json,
                     write_models_json)
from .search import SearchResult, pareto_frontier, run_search
from .space import SPACES, DesignPoint, DesignSpace
from .supervisor import RunLedger, Supervisor, SupervisorConfig

_LOG = get_logger("dse.batch_sweep")

__all__ = ["DEFAULT_TILE", "plan_tiles", "sweep_zoo", "prefill_queries",
           "new_stats", "prefill_tile", "prefill_sweep", "batch_sweep",
           "engine_microbench", "main"]

# designs per tile: big enough that the design-invariant candidate math
# amortizes over the whole tile
DEFAULT_TILE = 32

# the space whose designs engine_microbench's design-axis section sweeps
DESIGN_AXIS_SPACE = "large"


def plan_tiles(points: list[DesignPoint],
               d_tile: int = DEFAULT_TILE) -> list[list[DesignPoint]]:
    """Group by ``(n_fus, dataflow_set)`` (identical candidate enumeration)
    and split each group into design-axis tiles of at most ``d_tile``,
    groups in order of descending FU count."""
    groups: dict[tuple[int, str], list[DesignPoint]] = {}
    for p in points:
        groups.setdefault((p.n_fus, p.dataflow_set), []).append(p)
    tiles: list[list[DesignPoint]] = []
    for key in sorted(groups, key=lambda k: (-k[0], k[1])):
        g = groups[key]
        tiles.extend(g[i:i + d_tile] for i in range(0, len(g), d_tile))
    return tiles


def sweep_zoo(config_names=DEFAULT_ZOO, seqs=(512,),
              reduced: bool = False) -> dict[str, list]:
    """The prefill zoo of a sweep over several sequence lengths, keyed as
    ``benchmarks/dse.py`` keys it (``id@s<seq>`` when there are several)."""
    zoo: dict[str, list] = {}
    for seq in seqs:
        for k, v in load_zoo(config_names, seq=seq, reduced=reduced).items():
            zoo[k if len(seqs) == 1 else f"{k}@s{seq}"] = v
    return zoo


def prefill_queries(zoo: dict[str, list], rep: DesignPoint) -> list[tuple]:
    """The distinct mapping queries one design of ``rep``'s group issues.

    Mirrors the evaluator's scoring walk exactly — fused zoo, plus the
    unfused attention-bearing subset when the design is fusion-capable —
    and dedups per workload kind.  Returns
    ``[(wl, spatials, data_nodes, [(dims, ppu), ...]), ...]``.
    """
    fused = (rep.supports("attention_qk") and rep.supports("attention_pv"))
    zoos = [zoo_layers(zoo, fused)]
    if fused:
        zoos.append({n: ls for n, ls in zoo_layers(zoo, False).items()
                     if has_attention_rows(zoo[n])})
    kinds: dict[str, tuple] = {}
    seen: dict[str, set] = {}
    for layers_of in zoos:
        for layers in layers_of.values():
            for wl, dims, _, ppu in layers:
                if wl.name not in kinds:
                    dn = estimate_data_nodes(rep.n_fus,
                                             [t.name for t in wl.tensors])
                    kinds[wl.name] = (wl, rep.spatials(wl.name), dn, [])
                    seen[wl.name] = set()
                sig = (tuple(sorted(dims.items())), float(ppu))
                if sig not in seen[wl.name]:
                    seen[wl.name].add(sig)
                    kinds[wl.name][3].append((dims, float(ppu)))
    return list(kinds.values())


def new_stats() -> dict:
    """Empty statistics for :func:`prefill_tile` to accumulate into."""
    return {"designs": 0, "tiles": 0, "dispatches": 0, "entries_added": 0,
            "candidates_scored": 0, "enum_s": 0.0, "dispatch_s": 0.0,
            "select_s": 0.0, "device_ms": 0.0, "kinds": {}}


def prefill_tile(zoo: dict[str, list], tile: list[DesignPoint],
                 cache: MappingCache, objective: str = "cycles",
                 device="cuda", engine: str = "torch",
                 stats: dict | None = None) -> int:
    """Solve every cache-missing (design, query) pair of one tile in
    design-batched dispatches (one per workload kind with misses); returns
    the number of entries added.  ``stats`` accumulates the time split and
    counts, and per kind the largest batch seen, ``(candidates, loops)``."""
    stats = new_stats() if stats is None else stats
    hw_list = [p.hw_config() for p in tile]
    added = 0
    for wl, sps, dn, queries in prefill_queries(zoo, tile[0]):
        keys = [[mapping_key(wl, dims, sps, hw, dn, ppu, objective)
                 for dims, ppu in queries] for hw in hw_list]
        need_d = [di for di in range(len(tile))
                  if any(not cache.contains(k) for k in keys[di])]
        if not need_d:
            continue
        # solve the full query set for every design that misses anything:
        # the batch is one dispatch either way
        t0 = time.perf_counter()
        cand = build_batch(wl, [q[0] for q in queries], sps, hw_list[0])
        stats["enum_s"] += time.perf_counter() - t0
        mappings = best_mappings_design(
            wl, queries, sps, [hw_list[di] for di in need_d],
            data_nodes_per_tensor_list=[dn] * len(need_d),
            objective=objective, batch=cand, engine=engine, device=device,
            timing=stats)
        for row, di in enumerate(need_d):
            for qi, m in enumerate(mappings[row]):
                if not cache.contains(keys[di][qi]):
                    cache.put(keys[di][qi],
                              {"perf": m.perf.as_dict(),
                               "spatial": m.spatial.name,
                               "dataflow": m.dataflow.name})
                    added += 1
        stats["dispatches"] += 1
        stats["candidates_scored"] += len(need_d) * cand.n_candidates
        c0, l0 = stats["kinds"].get(wl.name, (0, 0))
        stats["kinds"][wl.name] = (max(c0, cand.n_candidates),
                                   max(l0, cand.loop_size.shape[1]))
    stats["entries_added"] += added
    return added


def _points(space: DesignSpace | list[DesignPoint]) -> list[DesignPoint]:
    return list(space.enumerate()) if isinstance(space, DesignSpace) \
        else list(space)


def _close(stats: dict, prefill_s: float) -> None:
    """The prefill's time not spent enumerating, dispatching or selecting:
    query planning and cache writes."""
    stats["other_s"] = (prefill_s - stats["enum_s"] - stats["dispatch_s"]
                        - stats["select_s"])


def prefill_sweep(space: DesignSpace | list[DesignPoint],
                  zoo: dict[str, list], cache: MappingCache,
                  objective: str = "cycles", d_tile: int = DEFAULT_TILE,
                  device="cuda") -> dict:
    """Prefill ``cache`` with every mapping query a sweep of ``space`` over
    ``zoo`` issues, scored on ``device``; returns the run's statistics:
    counts (designs, tiles, dispatches, entries added, candidates scored)
    and its wall time split into host enumeration (``enum_s``), scoring
    dispatches (``dispatch_s``, each ending in its one host sync; on a card
    also ``device_ms`` by CUDA events) and host selection plus rescoring
    (``select_s``); the rest (``other_s``) is query planning and cache
    writes."""
    dev = check_device(device)
    points = _points(space)
    tiles = plan_tiles(points, d_tile=d_tile)
    stats = new_stats()
    stats.update(designs=len(points), tiles=len(tiles))
    t0 = time.perf_counter()
    for tile in tiles:
        prefill_tile(zoo, tile, cache, objective, device=dev, stats=stats)
    stats["wall_s"] = time.perf_counter() - t0
    _close(stats, stats["wall_s"])
    return stats


def batch_sweep(space: DesignSpace | list[DesignPoint],
                evaluator: Evaluator,
                workers: int = 1,
                supervisor: Supervisor | None = None,
                log=None,
                d_tile: int = DEFAULT_TILE,
                snapshot_every: int = 1,
                stats: dict | None = None) -> SearchResult:
    """Exhaustive sweep with design-axis batched mapping search.

    Drop-in replacement for :func:`~repro_torch.dse.search.exhaustive_search`
    (same :class:`SearchResult`, byte-identical evals/frontier) that scores
    mapping candidates a tile of designs at a time on ``evaluator.device``
    (the card unless the evaluator was given the CPU).  Designs already
    completed in ``supervisor``'s ledger skip both prefill and evaluation;
    the frontier-so-far is checkpointed into the ledger every
    ``snapshot_every`` tiles.  ``stats``, when given, accumulates the
    prefill's statistics (as :func:`prefill_sweep` returns them, with the
    prefill's time in ``prefill_s`` and the evaluation's in ``eval_s``).
    """
    dev = check_device(evaluator.device)
    points = _points(space)
    space_name = space.name if isinstance(space, DesignSpace) else "custom"
    tiles = plan_tiles(points, d_tile=d_tile)
    _LOG.info("design-batched sweep: %d points in %d tiles (d_tile=%d) "
              "over space %r on %s", len(points), len(tiles), d_tile,
              space_name, dev)
    stats = new_stats() if stats is None else stats
    stats.update(designs=len(points), tiles=len(tiles), prefill_s=0.0,
                 eval_s=0.0)
    by_name = {}
    with span("dse.batch_sweep", cat="dse", space=space_name,
              n_points=len(points), n_tiles=len(tiles),
              d_tile=d_tile) as sp, \
            _supervised(evaluator, workers, supervisor) as pe:
        for ti, tile in enumerate(tiles):
            todo = [p for p in tile if p.name not in pe.completed]
            t0 = time.perf_counter()
            if todo:
                with span("dse.batch_sweep.prefill", cat="dse", tile=ti,
                          designs=len(todo)):
                    added = prefill_tile(evaluator.zoo, todo, evaluator.cache,
                                         evaluator.objective, device=dev,
                                         stats=stats)
                METRICS.counter("dse.prefill_entries").inc(added)
            METRICS.counter("dse.tiles_swept").inc()
            t1 = time.perf_counter()
            for e in pe.map(tile, log=log):
                by_name[e.point.name] = e
            stats["prefill_s"] += t1 - t0
            stats["eval_s"] += time.perf_counter() - t1
            if pe.ledger is not None and (ti + 1) % max(1,
                                                        snapshot_every) == 0:
                pe.ledger.record_frontier(
                    pareto_frontier(list(by_name.values())))
                pe.ledger.flush()
    _close(stats, stats["prefill_s"])
    # report in enumeration order: evals / frontier are byte-identical to
    # the per-design exhaustive sweep, tiling invisible
    evals = [by_name[p.name] for p in points]
    return SearchResult(space=space_name, strategy="exhaustive",
                        evals=evals, frontier=pareto_frontier(evals),
                        wall_s=sp.duration_s,
                        cache_stats=evaluator.cache.stats,
                        supervisor=dict(pe.stats))


def engine_microbench(repeats: int = 5, design_axis: bool = False,
                      device="cuda") -> dict:
    """Time the per-batch candidate fan-out on both engines.

    One representative mapping batch (a transformer-ish GEMM fan-out) is
    built once, then scored through ``evaluate_batch`` per engine:
    ``numpy`` reports the median wall time, ``torch`` (on ``device``, each
    call synchronised) the first call and the median of the calls after
    it separately.  With ``design_axis`` a second section sweeps the
    mapping solve for every design of :data:`DESIGN_AXIS_SPACE` — the
    per-design loop on each engine against the tiled ``(D, C)``
    design-axis dispatches on ``device`` — and records the speedup
    ``--design-batch`` buys at the engine level.  The reference's layout
    (``benchmarks/dse.py``), ``torch`` where it has ``jax``; recorded under
    ``meta["engine_bench"]``.
    """
    dev = check_device(device)
    wl = W.gemm()
    hw = HWConfig(n_fus=256)
    sps = [SpatialChoice(("i", "j"), (1, 1), "ij"),
           SpatialChoice(("k", "j"), (1, 1), "jk")]
    d = 2048
    dims_list = [{"i": s, "j": j, "k": d}
                 for s in (256, 512, 1024) for j in (d, 3 * d, 4 * d)]
    ppu_list = [0.0] * len(dims_list)
    batch = build_batch(wl, dims_list, sps, hw)

    def timed(engine, n):
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            evaluate_batch(batch, hw, dims_list, ppu_list, engine=engine,
                           device=dev)
            synchronize(dev)
            ts.append(time.perf_counter() - t)
        return ts

    out = {"workload": wl.name, "layers": len(dims_list),
           "candidates": batch.n_candidates, "engines": {}}
    out["engines"]["numpy"] = {
        "warm_ms": statistics.median(timed("numpy", repeats)) * 1e3}
    cold = timed("torch", 1)[0]
    out["engines"]["torch"] = {
        "cold_ms": cold * 1e3,
        "warm_ms": statistics.median(timed("torch", repeats)) * 1e3}
    if design_axis:
        out["design_batch"] = _design_axis_bench(
            wl, sps, dims_list, ppu_list, repeats, DESIGN_AXIS_SPACE, dev)
    return out


def _design_axis_bench(wl, sps, dims_list, ppu_list, repeats: int,
                       space_name: str, device) -> dict:
    """Mapping-solve wall clock over every design of one space: the
    per-design ``best_mappings`` loop (the NumPy engine, and warm
    per-design torch dispatches on ``device``) against the tiled
    design-axis ``best_mappings_design`` path on ``device``.
    ``speedup_vs_numpy_loop`` is the acceptance number for
    ``--design-batch``."""
    points = list(SPACES[space_name].enumerate())
    queries = [(dims, ppu) for dims, ppu in zip(dims_list, ppu_list)]
    tiles = plan_tiles(points, d_tile=DEFAULT_TILE)
    # one candidate batch per FU count (enumeration only depends on the
    # design through n_fus)
    batches = {}
    for tile in tiles:
        if tile[0].n_fus not in batches:
            batches[tile[0].n_fus] = build_batch(
                wl, dims_list, sps, tile[0].hw_config())

    def loop(engine):
        t = time.perf_counter()
        for p in points:
            best_mappings(wl, queries, sps, p.hw_config(), engine=engine,
                          device=device)
        synchronize(device)
        return time.perf_counter() - t

    def batched():
        t = time.perf_counter()
        for tile in tiles:
            best_mappings_design(
                wl, queries, sps, [p.hw_config() for p in tile],
                batch=batches[tile[0].n_fus], engine="torch", device=device)
        synchronize(device)
        return time.perf_counter() - t

    loop_numpy_s = loop("numpy")
    loop("torch")                    # warm the per-design dispatches
    loop_torch_s = loop("torch")
    cold_s = batched()
    warm_s = statistics.median(batched() for _ in range(max(1, repeats - 2)))
    return {"space": space_name, "designs": len(points),
            "tiles": len(tiles), "d_tile": DEFAULT_TILE,
            "layers": len(dims_list),
            "loop_numpy_ms": loop_numpy_s * 1e3,
            "loop_torch_warm_ms": loop_torch_s * 1e3,
            "batched_cold_ms": cold_s * 1e3,
            "batched_warm_ms": warm_s * 1e3,
            "speedup_vs_numpy_loop": loop_numpy_s / warm_s,
            "speedup_vs_torch_loop": loop_torch_s / warm_s}


def _supervised(evaluator: Evaluator, workers: int,
                supervisor: Supervisor | None) -> Supervisor:
    if supervisor is not None:
        return supervisor
    if workers > 1:
        # pool workers snapshot the cache at spawn time — tiles prefilled
        # after that would re-solve in-process; the design axis on the card
        # already replaces process parallelism, so evaluate inline
        _LOG.warning("batch_sweep ignores workers=%d (design-axis batching "
                     "replaces the process pool); evaluating in-process",
                     workers)
    return Supervisor(evaluator, workers=1)




# ---------------------------------------------------------------------------
# the command line (the twin of the reference's benchmarks/dse.py)
# ---------------------------------------------------------------------------

def _interrupt(signum, frame):
    raise KeyboardInterrupt()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.batch_sweep",
        description="Design-space exploration on the card: sweep candidate "
                    "accelerators over the model zoo, print the Pareto "
                    "frontier and write BENCH_dse.json, or, with --models, "
                    "run the cross-model study and write BENCH_models.json "
                    "with its one-architecture winner.  Every mapping miss "
                    "is scored on --device (the card by default).")
    ap.add_argument("--space", default=None, choices=sorted(SPACES),
                    help="design space (default: small; tiny with --quick)")
    ap.add_argument("--configs", default=",".join(DEFAULT_ZOO),
                    help="comma-separated repro_torch.configs ids")
    ap.add_argument("--models", default=None, metavar="IDS",
                    help="cross-model mode: 'all' or a comma list of "
                         "repro_torch.configs ids — scores a Gemmini "
                         "baseline per model and writes BENCH_models.json "
                         "with the one-architecture winner (overrides "
                         "--configs)")
    ap.add_argument("--phases", default=None,
                    help="execution phases to lower, comma list of "
                         "prefill/decode (default: prefill; --models "
                         "defaults to prefill,decode unless --quick)")
    ap.add_argument("--nets", default="",
                    help="also score repro_torch.nn_workloads networks "
                         "(comma-separated, e.g. MobileNetV2,ResNet50) — "
                         "conv workloads make fused dataflow sets earn "
                         "their mux area")
    ap.add_argument("--seq", default=None,
                    help="prefill sequence length(s) to score, comma list "
                         "(default: 512; 512,4096 for --space large; 256 "
                         "with --quick)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="use smoke() configs instead of full()")
    ap.add_argument("--quick", action="store_true",
                    help="sub-minute smoke sweep: tiny space, seq 256, "
                         "prefill only")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate args + lower the zoo, print the sweep "
                         "plan, exit before searching")
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "exhaustive", "evolutionary", "evolve"],
                    help="search strategy: 'exhaustive' enumerates, "
                         "'evolve' is the guided tournament+mutation loop "
                         "for big spaces (--budget/--seed), 'evolutionary' "
                         "is the legacy generational GA; 'auto' picks "
                         "exhaustive up to --max-exhaustive raw points, "
                         "evolve beyond")
    ap.add_argument("--budget", type=int, default=64,
                    help="evolve: full-evaluation budget — total designs "
                         "scored, ledger-resumed points included "
                         "(default 64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="evolve/evolutionary RNG seed; the same seed "
                         "visits the same designs and yields the same "
                         "frontier (default 0)")
    ap.add_argument("--design-batch", action="store_true",
                    help="exhaustive sweeps only: prefill the mapping "
                         "cache a design tile at a time on --device — one "
                         "(D, C) dispatch per tile and workload kind — "
                         "then evaluate every design from the warm cache "
                         "(frontier byte-identical to a per-design sweep)")
    ap.add_argument("--d-tile", type=int, default=DEFAULT_TILE, metavar="D",
                    help="--design-batch: designs per tile (default "
                         f"{DEFAULT_TILE})")
    ap.add_argument("--snapshot-every", type=int, default=1, metavar="N",
                    help="--design-batch: checkpoint the frontier-so-far "
                         "into the run ledger every N tiles (default 1)")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool fan-out for design evaluations "
                         "(workers score on the host; the pool spawns once "
                         "CUDA is up)")
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted sweep from its run ledger: "
                         "already-completed points are adopted, only the "
                         "missing ones evaluate")
    ap.add_argument("--ledger", default=None, metavar="PATH",
                    help="run-ledger checkpoint file "
                         "(default: <out>.ledger)")
    ap.add_argument("--task-timeout", type=float, default=120.0,
                    metavar="S",
                    help="per-evaluation timeout with workers>1: a worker "
                         "past it is killed and the point retried "
                         "(0 disables; default 120)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="failures per design point before it is "
                         "quarantined as a failure stub (default 2)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic fault injection, e.g. "
                         "'crash=1,hang=1,transient=1,corrupt=1,seed=3' "
                         "(also: kill_after=N, hang_s=S); falls back to "
                         "the REPRO_FAULTS env var")
    ap.add_argument("--max-exhaustive", type=int, default=512,
                    help="auto strategy: exhaustive up to this many raw "
                         "points, evolutionary beyond")
    ap.add_argument("--objective", default="cycles",
                    choices=["cycles", "energy", "edp", "serving"],
                    help="per-layer mapping-search objective; 'serving' "
                         "replays a synthetic traffic trace against every "
                         "design (repro_torch.serve.sim) and ranks the "
                         "frontier by goodput-under-SLO instead of static "
                         "cycles")
    ap.add_argument("--trace-spec", default=None, metavar="SPEC",
                    help="serving traffic mix, e.g. 'seed=0,requests=64,"
                         "rate=0.25,models=gemma_7b:2;rwkv6_7b:1,"
                         "prompt=64:256,output=16:64' (models default to "
                         "the swept configs, requests default to 16 with "
                         "--quick else 64)")
    ap.add_argument("--slo-ms", default="30000:1500", metavar="TTFT:TPOT",
                    help="serving SLO bounds in ms — time-to-first-token : "
                         "time-per-output-token (default 30000:1500)")
    ap.add_argument("--kv-gb", type=float, default=4.0, metavar="GB",
                    help="KV-cache capacity modeled by the serving "
                         "simulator (default 4.0 GiB)")
    ap.add_argument("--engine", default="torch", choices=list(ENGINES),
                    help="mapping-miss scoring engine (results are "
                         "byte-identical across engines; default torch, "
                         "on --device; 'scalar' is the slow reference)")
    ap.add_argument("--engine-bench", action="store_true",
                    help="micro-benchmark the candidate fan-out on both "
                         "engines and record it in the output meta "
                         "(implied by --engine torch and --design-batch)")
    ap.add_argument("--device", default="cuda",
                    help="where the torch engine, --design-batch and "
                         "--engine-bench score (default: cuda; no fallback "
                         "to the CPU)")
    ap.add_argument("--emit-dir", default=None, metavar="DIR",
                    help="emit the frontier designs' wiring classes as "
                         "structural Verilog into DIR; BENCH_dse.json "
                         "frontier entries gain an 'rtl' artifact path")
    ap.add_argument("--out", default=None,
                    help="output JSON (default: BENCH_dse.json, or "
                         "BENCH_models.json with --models, in the current "
                         "directory)")
    ap.add_argument("--cache-path", default=None,
                    help="mapping-cache JSON (default: next to --out)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent mapping cache")
    ap.add_argument("--top", type=int, default=12,
                    help="scorecard rows to print")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome trace-event JSON of the sweep "
                         "(load in https://ui.perfetto.dev or "
                         "chrome://tracing); covers process-pool workers")
    ap.add_argument("--no-metrics", action="store_true",
                    help="disable the hot-path metrics registry (the bench "
                         "JSON 'metrics' section comes out empty)")
    ap.add_argument("-q", "--quiet", action="store_true")
    add_verbosity_flag(ap)
    args = ap.parse_args(argv)
    configure(args.verbose)
    set_metrics_enabled(not args.no_metrics)
    if args.trace:
        enable_tracing()

    t0 = time.perf_counter()
    if args.design_batch and args.strategy not in ("auto", "exhaustive"):
        ap.error("--design-batch is an exhaustive-sweep orchestrator; "
                 "use --strategy auto or exhaustive (guided search wants "
                 "--strategy evolve instead)")
    if args.d_tile < 1:
        ap.error(f"--d-tile expects a positive tile size, got "
                 f"{args.d_tile}")
    if args.budget < 1:
        ap.error(f"--budget expects a positive evaluation count, got "
                 f"{args.budget}")
    # the card unless the CPU is named; without one this raises
    device = (check_device(args.device)
              if args.engine == "torch" or args.design_batch
              or args.engine_bench else args.device)
    space = SPACES[args.space or ("tiny" if args.quick else "small")]
    if args.models:
        try:
            configs = resolve_ids(args.models)
        except KeyError as e:
            ap.error(str(e.args[0]))
    else:
        configs = [c for c in args.configs.split(",") if c]
    if args.phases is None:
        args.phases = ("prefill,decode" if args.models and not args.quick
                       else "prefill")
    phases = tuple(dict.fromkeys(p for p in args.phases.split(",") if p))
    if not phases or any(p not in PHASES for p in phases):
        ap.error(f"--phases expects a comma list of {'/'.join(PHASES)}, "
                 f"got {args.phases!r}")
    if args.seq is None:
        args.seq = ("256" if args.quick
                    else "512,4096" if space.name == "large" else "512")
    try:
        seqs = list(dict.fromkeys(int(s) for s in args.seq.split(",") if s))
    except ValueError:
        ap.error(f"--seq expects a comma list of ints, got {args.seq!r}")
    if not seqs or any(s <= 0 for s in seqs):
        ap.error(f"--seq expects positive lengths, got {args.seq!r}")
    # --objective serving: the mapping search still optimizes cycles per
    # layer; the *design ranking* comes from the traffic-trace replay
    serving_spec = None
    map_objective = args.objective
    if args.objective == "serving":
        map_objective = "cycles"
        text = (args.trace_spec if args.trace_spec is not None
                else f"requests={16 if args.quick else 64}")
        try:
            trace_spec = parse_trace_spec(text, default_models=configs)
        except ValueError as e:
            ap.error(f"--trace-spec: {e}")
        bad = [m for m, _ in trace_spec.models if m not in ARCH_IDS]
        if bad:
            ap.error(f"--trace-spec names unknown configs {bad}; "
                     f"known ids: {', '.join(ARCH_IDS)}")
        parts = args.slo_ms.split(":")
        try:
            ttft, tpot = ((float(parts[0]), float(parts[1]))
                          if len(parts) == 2 else (None, None))
        except ValueError:
            ttft = tpot = None
        if ttft is None or ttft <= 0 or tpot <= 0:
            ap.error(f"--slo-ms expects 'TTFT:TPOT' in positive ms, got "
                     f"{args.slo_ms!r}")
        serving_spec = ServingSpec(
            trace=trace_spec, slo=SLO(ttft_ms=ttft, tpot_ms=tpot),
            kv_capacity_bytes=int(args.kv_gb * (1 << 30)),
            reduced=args.reduced)
    elif args.trace_spec is not None:
        ap.error("--trace-spec requires --objective serving")
    out = args.out or ("BENCH_models.json" if args.models
                       else "BENCH_dse.json")
    log = (lambda m: None) if args.quiet else (
        lambda m: print(f"  {m}", flush=True))

    mode = "cross-model study" if args.models else "DSE sweep"
    print(f"== {mode}: space={space.name} ({space.raw_size} raw points), "
          f"zoo={configs}, seq={seqs}, phases={list(phases)} ==")
    zoo = {}
    for seq in seqs:
        try:
            part = load_zoo(configs, seq=seq, batch=args.batch,
                            reduced=args.reduced, phases=phases)
        except ModuleNotFoundError as e:
            ap.error(f"unknown config in --configs ({e.name}); "
                     f"known ids: {', '.join(ARCH_IDS)}")
        for k, v in part.items():
            zoo[k if len(seqs) == 1 else f"{k}@s{seq}"] = v
    if args.nets:
        from ..nn_workloads import NETWORKS
        for net in args.nets.split(","):
            if net not in NETWORKS:
                ap.error(f"unknown net {net!r}; known: "
                         f"{', '.join(sorted(NETWORKS))}")
            zoo[net] = NETWORKS[net]()
    n_layers = sum(len(v) for v in zoo.values())
    print(f"  lowered {len(zoo)} configs -> {n_layers} unique layer shapes")

    if args.dry_run:
        print(f"  dry run: would sweep {space.raw_size} raw design points "
              f"(strategy={args.strategy}, workers={args.workers}) and "
              f"write {out}")
        return 0

    try:
        plan = (parse_fault_spec(args.inject_faults) if args.inject_faults
                else plan_from_env() or FaultPlan())
    except ValueError as e:
        ap.error(str(e))
    if plan.active:
        print(f"  fault injection armed: {plan.spec()}")

    cache_path = None
    if not args.no_cache:
        cache_path = args.cache_path or os.path.join(
            os.path.dirname(os.path.abspath(out)),
            ".dse_mapping_cache.json")
    if plan.corrupt and cache_path and os.path.exists(cache_path):
        hit = corrupt_cache_file(cache_path, plan.corrupt, plan.seed)
        print(f"  fault injection: corrupted {hit} mapping-cache "
              f"entries in {cache_path}")
    cache = MappingCache(cache_path)
    if len(cache):
        print(f"  mapping cache: {len(cache)} entries from {cache_path}")

    # run ledger: checkpoint of completed evaluations, keyed to this exact
    # sweep so --resume can never splice two different configurations
    run_key = {"space": space.name, "configs": configs, "seqs": seqs,
               "batch": args.batch, "phases": list(phases),
               "objective": args.objective, "nets": args.nets,
               "models": bool(args.models),
               "strategy": args.strategy, "budget": args.budget,
               "seed": args.seed,
               "serving": (serving_spec.as_dict() if serving_spec
                           else None)}
    ledger = RunLedger(args.ledger or out + ".ledger", run_key=run_key)
    completed = {}
    if args.resume:
        loaded = ledger.load()
        completed = ledger.completed_evals()
        cache.merge(ledger.cache_entries())
        print(f"  resume: adopted {len(completed)} completed evaluations "
              f"from {ledger.path}" if loaded else
              f"  resume: no usable ledger at {ledger.path} — full sweep")

    evaluator = Evaluator(zoo=zoo, cache=cache, objective=map_objective,
                          baseline="gemmini" if args.models else None,
                          engine=args.engine, serving=serving_spec,
                          device=device)
    if serving_spec is not None:
        print(f"  serving: trace '{serving_spec.trace.spec()}', SLO "
              f"ttft<={serving_spec.slo.ttft_ms:g}ms "
              f"tpot<={serving_spec.slo.tpot_ms:g}ms, "
              f"KV {args.kv_gb:g} GiB")
    if args.models:
        # baselines depend only on the zoo — score them once in the parent
        # (workers recompute lazily from the same zoo, deterministically)
        evaluator.baselines

    sup = Supervisor(
        evaluator, workers=args.workers,
        cfg=SupervisorConfig(
            task_timeout_s=args.task_timeout if args.task_timeout > 0
            else None,
            max_retries=args.max_retries),
        fault_plan=plan if plan.active else None,
        ledger=ledger, completed=completed)
    meta = {"configs": configs, "seqs": seqs, "batch": args.batch,
            "phases": list(phases), "objective": args.objective,
            "serving": serving_spec.as_dict() if serving_spec else None,
            "engine": args.engine, "device": str(device),
            "design_batch": bool(args.design_batch),
            "budget": args.budget, "seed": args.seed,
            "workers": args.workers, "ledger": ledger.path,
            "resume": bool(args.resume),
            "faults": plan.spec() if plan.active else None}
    provenance = provenance_record(
        extra={"engine": args.engine, "strategy": args.strategy,
               "seed": args.seed, "budget": args.budget,
               "design_batch": bool(args.design_batch)})

    # a SIGTERM (e.g. an OOM-killer sibling or batch-system preemption)
    # takes the same checkpoint path as Ctrl-C
    prev = signal.signal(signal.SIGTERM, _interrupt)
    stats = None
    try:
        if args.design_batch:
            stats = new_stats()
            result = batch_sweep(space, evaluator, workers=args.workers,
                                 supervisor=sup, log=log,
                                 d_tile=args.d_tile,
                                 snapshot_every=args.snapshot_every,
                                 stats=stats)
        else:
            # seed/budget only reach the strategies that take them; 'auto'
            # may resolve to evolve, where run_search forwards them
            kw = ({"budget": args.budget, "seed": args.seed}
                  if args.strategy in ("auto", "evolve")
                  else {"seed": args.seed}
                  if args.strategy == "evolutionary" else {})
            result = run_search(space, evaluator, strategy=args.strategy,
                                log=log, workers=args.workers,
                                supervisor=sup,
                                max_exhaustive=args.max_exhaustive, **kw)
    except KeyboardInterrupt:
        # the supervisor already flushed the ledger on its way out; leave a
        # partial artifact instead of dying with nothing
        evals = ledger.evals()
        partial = SearchResult(
            space=space.name, strategy=args.strategy, evals=evals,
            frontier=pareto_frontier(evals),
            wall_s=time.perf_counter() - t0, cache_stats=cache.stats,
            supervisor=dict(sup.stats))
        meta["partial"] = True
        meta["total_wall_s"] = time.perf_counter() - t0
        write_bench_json(out, partial, meta=meta, partial=True,
                         provenance=provenance)
        cache.save()
        if args.trace:
            save_trace(args.trace)
        print(f"\ninterrupted after {len(evals)} evaluations — partial "
              f"artifact {out} + ledger {ledger.path}; rerun with "
              f"--resume to finish", flush=True)
        return 130
    finally:
        signal.signal(signal.SIGTERM, prev)
    cache.save()

    print()
    print(format_scorecard(result.evals, limit=args.top))
    print()
    print(format_frontier(result))
    if args.models:
        print()
        print(format_models(result))
    if serving_spec is not None:
        print()
        print(format_serving(result))

    artifacts = None
    if args.emit_dir:
        artifacts = emit_frontier_rtl(result, args.emit_dir)

    wall = time.perf_counter() - t0
    meta.update({"strategy": result.strategy, "total_wall_s": wall,
                 "supervisor": dict(sup.stats)})
    if stats is not None:
        meta["prefill"] = stats
        if not args.quiet:
            _print_prefill(stats, args.d_tile, len(cache))
    if args.engine == "torch" or args.engine_bench or args.design_batch:
        # the design-axis section re-sweeps the large space at the engine
        # level — keep it out of --quick runs
        meta["engine_bench"] = engine_microbench(
            design_axis=args.design_batch and not args.quick, device=device)
        if not args.quiet:
            _print_engine_bench(meta["engine_bench"])
    if args.models:
        write_models_json(out, result, model_ids=configs,
                          baselines=evaluator.baselines, meta=meta,
                          artifacts=artifacts, provenance=provenance)
    else:
        write_bench_json(out, result, meta=meta, artifacts=artifacts,
                         provenance=provenance)
    if args.trace:
        payload = save_trace(args.trace)
        print(f"  trace: {len(payload['traceEvents'])} events -> "
              f"{args.trace}")
    cs = result.cache_stats
    ss = result.supervisor
    extra = "".join(
        f"; {k}={ss[k]}" for k in ("resumed", "retries", "respawns",
                                   "quarantined", "timeouts") if ss.get(k))
    print(f"\nswept {result.n_designs} designs x {len(zoo)} configs in "
          f"{wall:.1f}s (workers={args.workers}; mapper cache: "
          f"{cs['hits']} hits / {cs['misses']} misses{extra}); wrote {out}")
    return 0


def _print_engine_bench(bench: dict) -> None:
    for name, row in bench["engines"].items():
        print(f"  engine_bench {name}: "
              + ", ".join(f"{k}={v:.3f}" for k, v in row.items()))
    db = bench.get("design_batch")
    if db:
        print(f"  engine_bench design_batch: {db['designs']} "
              f"designs/{db['tiles']} tiles — numpy loop "
              f"{db['loop_numpy_ms']:.0f}ms, torch loop "
              f"{db['loop_torch_warm_ms']:.0f}ms, batched warm "
              f"{db['batched_warm_ms']:.0f}ms "
              f"({db['speedup_vs_numpy_loop']:.1f}x vs numpy loop)")


def _print_prefill(s: dict, d_tile: int, n_cache: int) -> None:
    """--design-batch: the prefill's counts and its time split."""
    print(f"  prefill: {s['designs']} designs in {s['tiles']} tiles "
          f"(d_tile {d_tile}), {s['dispatches']} dispatches, "
          f"{s['entries_added']} entries added ({n_cache} in the cache), "
          f"{s['candidates_scored']} candidates scored")
    print(f"  prefill {s['prefill_s']:.3f} s: enumeration "
          f"{s['enum_s']:.3f}, dispatches {s['dispatch_s']:.3f} (device "
          f"{s['device_ms'] / 1e3:.3f}), selection + rescoring "
          f"{s['select_s']:.3f}, other {s['other_s']:.3f}")
    if s["prefill_s"] > 0:
        print(f"  {s['candidates_scored'] / s['prefill_s']:.0f} "
              f"candidates/s over the prefill's wall time")
    print(f"  evaluation {s['eval_s']:.3f} s")


if __name__ == "__main__":
    sys.exit(main())

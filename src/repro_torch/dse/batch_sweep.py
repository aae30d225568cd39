"""Design-axis batched sweep on the card: the twin of the reference's
``repro.dse.batch_sweep``.

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

The whole design search, from the zoo to the frontier::

    python -m repro_torch.dse.batch_sweep --space large --seq 512,4096 \\
        --cache-path PATH --out sweep.json

``--strategy evolve --budget N --seed S`` runs the guided search instead,
its mapping misses scored design by design on the card.  The sweep runs in
one process and never forks once CUDA is up.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core.fusion import estimate_data_nodes
from ..core.mapper_batch import best_mappings_design, build_batch
from ..core.perf_model_torch import ENGINES
from ..frontend import has_attention_rows
from ..models.common import check_device
from ..obs import METRICS, get_logger, span
from .cache import MappingCache, mapping_key
from .evaluate import DEFAULT_ZOO, Evaluator, load_zoo, zoo_layers
from .report import format_frontier, write_bench_json
from .search import SearchResult, evolve_search, pareto_frontier
from .space import SPACES, DesignPoint, DesignSpace
from .supervisor import Supervisor

_LOG = get_logger("dse.batch_sweep")

__all__ = ["DEFAULT_TILE", "plan_tiles", "sweep_zoo", "prefill_queries",
           "new_stats", "prefill_tile", "prefill_sweep", "batch_sweep",
           "main"]

# designs per tile: big enough that the design-invariant candidate math
# amortizes over the whole tile
DEFAULT_TILE = 32


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.batch_sweep",
        description="Design-space sweep on the card: prefill the mapping "
                    "cache a tile of designs at a time, evaluate every "
                    "design over the zoo and print the Pareto frontier "
                    "(or, with --strategy evolve, the guided search).")
    ap.add_argument("--space", default="small", choices=sorted(SPACES))
    ap.add_argument("--configs", default=",".join(DEFAULT_ZOO),
                    help="comma-separated config ids")
    ap.add_argument("--seq", default=None,
                    help="prefill sequence length(s), comma list (default: "
                         "512; 512,4096 for --space large, as "
                         "benchmarks/dse.py)")
    ap.add_argument("--reduced", action="store_true",
                    help="use smoke() configs instead of full()")
    ap.add_argument("--cache-path", required=True)
    ap.add_argument("--d-tile", type=int, default=DEFAULT_TILE)
    ap.add_argument("--objective", default="cycles",
                    choices=["cycles", "energy", "edp"])
    ap.add_argument("--strategy", default="exhaustive",
                    choices=["exhaustive", "evolve"],
                    help="search strategy: 'exhaustive' is the "
                         "design-batched sweep of every design, 'evolve' "
                         "the guided tournament+mutation loop under "
                         "--budget (default exhaustive)")
    ap.add_argument("--budget", type=int, default=64,
                    help="evolve: full-evaluation budget — total designs "
                         "scored (default 64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="evolve RNG seed; the same seed visits the same "
                         "designs and yields the same frontier (default 0)")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool fan-out for design evaluations "
                         "(evolve; the exhaustive sweep evaluates "
                         "in-process)")
    ap.add_argument("--engine", default="torch", choices=list(ENGINES),
                    help="mapping-miss scoring engine (results are "
                         "byte-identical across engines; default torch, "
                         "on --device)")
    ap.add_argument("--out", default=None,
                    help="write the sweep's JSON (the layout of the "
                         "reference's BENCH_dse.json) to this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.d_tile < 1:
        ap.error(f"--d-tile expects a positive tile size, got {args.d_tile}")
    if args.budget < 1:
        ap.error(f"--budget expects a positive evaluation count, got "
                 f"{args.budget}")
    space = SPACES[args.space]
    seq = args.seq or ("512,4096" if space.name == "large" else "512")
    try:
        seqs = list(dict.fromkeys(int(s) for s in seq.split(",") if s))
    except ValueError:
        ap.error(f"--seq expects a comma list of ints, got {seq!r}")
    configs = [c for c in args.configs.split(",") if c]
    zoo = sweep_zoo(configs, seqs, reduced=args.reduced)
    cache = MappingCache(args.cache_path)
    evaluator = Evaluator(zoo=zoo, cache=cache, objective=args.objective,
                          engine=args.engine, device=args.device)
    print(f"== DSE sweep: space={space.name}, zoo={configs}, seq={seqs}, "
          f"strategy={args.strategy}, objective={args.objective}, "
          f"engine={args.engine}, device={args.device}; cache "
          f"{args.cache_path} ({len(cache)} entries) ==", flush=True)
    t0 = time.perf_counter()
    s = None
    if args.strategy == "exhaustive":
        s = new_stats()
        result = batch_sweep(space, evaluator, workers=args.workers,
                             d_tile=args.d_tile, stats=s)
    else:
        result = evolve_search(space, evaluator, budget=args.budget,
                               seed=args.seed, workers=args.workers)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    cache.save()
    save_s = time.perf_counter() - t1
    if s is not None:
        print(f"  prefill: {s['designs']} designs in {s['tiles']} tiles "
              f"(d_tile {args.d_tile}), {s['dispatches']} dispatches, "
              f"{s['entries_added']} entries added ({len(cache)} in the "
              f"cache), {s['candidates_scored']} candidates scored")
        print(f"  prefill {s['prefill_s']:.3f} s: enumeration "
              f"{s['enum_s']:.3f}, dispatches {s['dispatch_s']:.3f} (device "
              f"{s['device_ms'] / 1e3:.3f}), selection + rescoring "
              f"{s['select_s']:.3f}, other {s['other_s']:.3f}")
        if s["prefill_s"] > 0:
            print(f"  {s['candidates_scored'] / s['prefill_s']:.0f} "
                  f"candidates/s over the prefill's wall time")
        print(f"  evaluation {s['eval_s']:.3f} s")
    cs = result.cache_stats
    print(f"  {result.n_designs} designs evaluated in {wall:.3f} s "
          f"(mapper cache: {cs['hits']} hits / {cs['misses']} misses); "
          f"save {save_s:.3f} s")
    print()
    print(format_frontier(result))
    if args.out:
        meta = {"configs": configs, "seqs": seqs,
                "objective": args.objective, "strategy": args.strategy,
                "engine": args.engine, "device": args.device,
                "d_tile": args.d_tile, "budget": args.budget,
                "seed": args.seed, "workers": args.workers,
                "total_wall_s": wall, "prefill": s}
        write_bench_json(args.out, result, meta=meta)
        print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

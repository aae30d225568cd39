"""Design-axis batched mapping prefill on the card: the twin of the mapping
half of the reference's ``repro.dse.batch_sweep``.

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

The evaluation that follows (the Evaluator, fusion credits, baselines, the
Pareto frontier) stays the reference's NumPy code: over the warm cache every
query hits, so the frontier is the one a cold per-design sweep gives::

    python -m repro_torch.dse.batch_sweep --space large --seq 512,4096 \\
        --cache-path PATH
    python benchmarks/dse.py --space large --strategy exhaustive \
        --cache-path PATH

The prefill runs in one process and never forks once CUDA is up (the
reference's sweep already evaluates in-process when it batches designs).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..core import workload as W
from ..core.fusion import estimate_data_nodes
from ..core.mapper_batch import best_mappings_design, build_batch
from ..frontend import has_attention_rows, lower_zoo, unfuse_attention_rows
from ..models.common import check_device
from .cache import MappingCache, mapping_key
from .space import SPACES, DesignPoint, DesignSpace

__all__ = ["DEFAULT_ZOO", "DEFAULT_TILE", "plan_tiles", "load_zoo",
           "sweep_zoo", "zoo_layers", "prefill_queries", "new_stats",
           "prefill_tile", "prefill_sweep", "main"]

# four families: dense GLU, MoE, hybrid Mamba+attn+MoE, RWKV
DEFAULT_ZOO = ("gemma_7b", "glm4_9b", "deepseek_moe_16b", "rwkv6_7b")

# designs per tile: big enough that the design-invariant candidate math
# amortizes over the whole tile
DEFAULT_TILE = 32

_WL = {"gemm": W.gemm(), "conv": W.conv2d(), "dwconv": W.depthwise_conv2d(),
       "attn_qk": W.attention_qk(), "attn_pv": W.attention_pv()}


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


def load_zoo(config_names=DEFAULT_ZOO, seq: int = 512, batch: int = 1,
             reduced: bool = False,
             phases=("prefill",)) -> dict[str, list]:
    """Lower every named config once per phase: {key: [(kind, dims, rep,
    nt)]} — keys are config ids, suffixed ``@phase`` when several phases are
    requested (see :func:`repro_torch.frontend.lower_zoo`)."""
    return lower_zoo(config_names, seq=seq, batch=batch, phases=phases,
                     reduced=reduced)


def sweep_zoo(config_names=DEFAULT_ZOO, seqs=(512,),
              reduced: bool = False) -> dict[str, list]:
    """The prefill zoo of a sweep over several sequence lengths, keyed as
    ``benchmarks/dse.py`` keys it (``id@s<seq>`` when there are several)."""
    zoo: dict[str, list] = {}
    for seq in seqs:
        for k, v in load_zoo(config_names, seq=seq, reduced=reduced).items():
            zoo[k if len(seqs) == 1 else f"{k}@s{seq}"] = v
    return zoo


def zoo_layers(zoo: dict[str, list], fused: bool) -> dict[str, list]:
    """Workload-resolved layer rows per zoo entry.  ``fused=False``
    rewrites the attention pair to the plain per-GEMM lowering (the
    reference's ``Evaluator._zoo_layers``)."""
    out = {}
    for name, rows in zoo.items():
        if not fused:
            rows = unfuse_attention_rows(rows)
        out[name] = [(_WL[kind], dims, rep, nt)
                     for kind, dims, rep, nt in rows]
    return out


def prefill_queries(zoo: dict[str, list], rep: DesignPoint) -> list[tuple]:
    """The distinct mapping queries one design of ``rep``'s group issues.

    Mirrors the reference evaluator's scoring walk exactly — fused zoo,
    plus the unfused attention-bearing subset when the design is
    fusion-capable — and dedups per workload kind.  Returns
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
    points = list(space.enumerate()) if isinstance(space, DesignSpace) \
        else list(space)
    tiles = plan_tiles(points, d_tile=d_tile)
    stats = new_stats()
    stats.update(designs=len(points), tiles=len(tiles))
    t0 = time.perf_counter()
    for tile in tiles:
        prefill_tile(zoo, tile, cache, objective, device=dev, stats=stats)
    stats["wall_s"] = time.perf_counter() - t0
    stats["other_s"] = (stats["wall_s"] - stats["enum_s"]
                        - stats["dispatch_s"] - stats["select_s"])
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse.batch_sweep",
        description="Prefill a DSE mapping cache on the card: every mapping "
                    "query of a design-space sweep, scored a tile of "
                    "designs at a time. Evaluate the warm cache with "
                    "`python benchmarks/dse.py --space NAME --strategy "
                    "exhaustive --cache-path PATH` (every query hits).")
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.d_tile < 1:
        ap.error(f"--d-tile expects a positive tile size, got {args.d_tile}")
    space = SPACES[args.space]
    seq = args.seq or ("512,4096" if space.name == "large" else "512")
    try:
        seqs = list(dict.fromkeys(int(s) for s in seq.split(",") if s))
    except ValueError:
        ap.error(f"--seq expects a comma list of ints, got {seq!r}")
    configs = [c for c in args.configs.split(",") if c]
    zoo = sweep_zoo(configs, seqs, reduced=args.reduced)
    cache = MappingCache(args.cache_path)
    before = len(cache)
    print(f"== mapping prefill: space={space.name}, zoo={configs}, "
          f"seq={seqs}, objective={args.objective}, d_tile={args.d_tile}, "
          f"device={args.device}; cache {args.cache_path} "
          f"({before} entries) ==", flush=True)
    s = prefill_sweep(space, zoo, cache, objective=args.objective,
                      d_tile=args.d_tile, device=args.device)
    t0 = time.perf_counter()
    cache.save()
    save_s = time.perf_counter() - t0
    print(f"  {s['designs']} designs in {s['tiles']} tiles, "
          f"{s['dispatches']} dispatches, {s['entries_added']} entries "
          f"added ({len(cache)} in the cache), "
          f"{s['candidates_scored']} candidates scored")
    print(f"  wall {s['wall_s']:.3f} s: enumeration {s['enum_s']:.3f}, "
          f"dispatches {s['dispatch_s']:.3f} (device "
          f"{s['device_ms'] / 1e3:.3f}), selection + rescoring "
          f"{s['select_s']:.3f}, other {s['other_s']:.3f}; "
          f"save {save_s:.3f} s")
    if s["wall_s"] > 0:
        print(f"  {s['candidates_scored'] / s['wall_s']:.0f} candidates/s "
              f"over the wall time")
    return 0


if __name__ == "__main__":
    sys.exit(main())

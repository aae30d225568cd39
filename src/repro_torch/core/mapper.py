"""Mapping search (paper §VI-A: "a simple mapping search tool that identifies
the best mapping (i.e., dataflow and tiling) for every neural network layer
based on the simulated #cycles and energy").

Given a layer (workload + true dims) and the spatial dataflows a design
supports, the mapper pads dims to tileable sizes, enumerates spatial-array
factorizations, tile splits and a set of canonical loop orders, evaluates
each with the perf model, and returns the best mapping (min cycles, energy
as tie-break).  Two-level tile splits (``_tile_candidates``) are part of
the default enumeration — ``tile_search=False`` restores the historical
narrower space; the scalar-vs-batch parity suite covers the tiled
candidates, which is what let the default flip on.

Candidate enumeration (:func:`enumerate_candidates`) is shared between the
evaluation engines:

``engine="numpy"`` (default; alias ``"batch"``)
    the NumPy-vectorized engine in :mod:`repro_torch.core.mapper_batch` —
    the whole candidate set is scored in one broadcasted perf-kernel pass.
``engine="torch"``
    the PyTorch engine (:mod:`repro_torch.core.perf_model_torch`) scores
    the batch on the card in float64/int64; selection and the reported
    numbers stay on the NumPy path, so the returned mapping is
    byte-identical (see that module's tolerance policy).
``engine="scalar"``
    the reference candidate-at-a-time loop.  All engines call the same
    perf-kernel math, so they return bit-identical mappings; the scalar
    path is kept as the parity oracle for tests.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..obs import METRICS

from .dataflow import Dataflow, build_dataflow
from .perf_model import HWConfig, LayerPerf, layer_perf
from .workload import Workload

__all__ = ["SpatialChoice", "Mapping", "Candidate", "best_mapping",
           "enumerate_candidates", "factor_pairs"]


@dataclass(frozen=True)
class SpatialChoice:
    """One supported spatial dataflow: the parallel dims and control flow."""

    dims: tuple[str, ...]
    c: tuple[int, ...]
    name: str


@dataclass
class Mapping:
    dataflow: Dataflow
    perf: LayerPerf
    spatial: SpatialChoice


@dataclass(frozen=True)
class Candidate:
    """One enumerated (spatial choice × factorization × loop order) point.

    ``temporal`` is the outermost-first (dim, trip) nest; a dim may appear
    twice when ``tile_search`` split its trip into two levels.
    """

    spatial_idx: int
    facs: tuple[int, ...]
    temporal: tuple[tuple[str, int], ...]


@functools.lru_cache(maxsize=None)
def factor_pairs(n: int, max_ratio: int = 16) -> tuple[tuple[int, int], ...]:
    out = []
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            b = n // a
            if max(a, b) / min(a, b) <= max_ratio:
                out.append((a, b))
                if a != b:
                    out.append((b, a))
    return tuple(out) or ((1, n), (n, 1))


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=None)
def _tile_candidates(r: int) -> tuple[int, ...]:
    """Candidate inner-tile sizes for a loop of trip count r (part of the
    default enumeration since tile search went default-on; the batched
    engine scores the widened candidate set in the same kernel pass)."""
    cands = {1, r}
    for t in (2, 4, 8, 16, 32, 64):
        if t < r:
            cands.add(t)
    return tuple(sorted(cands))


@functools.lru_cache(maxsize=None)
def _orders_cached(dims: tuple[str, ...], out_dims: frozenset,
                   max_orders: int = 8) -> tuple[tuple[str, ...], ...]:
    red = [d for d in dims if d not in out_dims]
    nonred = [d for d in dims if d in out_dims]
    orders = []
    orders.append(nonred + red)          # reductions innermost
    orders.append(red + nonred)          # outputs innermost (output reuse)
    if len(nonred) > 1:
        orders.append(nonred[::-1] + red)
    if len(red) > 1:
        orders.append(nonred + red[::-1])
    # a couple of interleaved orders
    if red and nonred:
        orders.append([nonred[0]] + red + nonred[1:])
    dedup = []
    for o in orders:
        if o not in dedup:
            dedup.append(o)
    return tuple(tuple(o) for o in dedup[:max_orders])


def workload_out_dims(wl: Workload) -> frozenset:
    """Iteration dims the output tensor depends on (non-reduction dims)."""
    return frozenset(wl.iter_dims[i]
                     for i in np.nonzero(wl.output.fmap.M.any(axis=0))[0])


def _orders(dims: list[str], wl: Workload, max_orders: int = 8) -> list[list[str]]:
    """Canonical temporal loop orders: reduction dims innermost (streaming
    weights / accumulating in place) and output dims innermost variants."""
    return [list(o) for o in
            _orders_cached(tuple(dims), workload_out_dims(wl), max_orders)]


def _tile_splits(temporal: tuple[tuple[str, int], ...]):
    """Two-level tile variants of ``temporal``: one loop's trip ``T`` becomes
    an outer ``T // t`` at its original depth plus an inner tile ``t``
    innermost (classic inner-tiling; default-on, disable with
    ``tile_search=False``)."""
    for p, (d, T) in enumerate(temporal):
        for t in _tile_candidates(T):
            if t <= 1 or t >= T or T % t:
                continue
            outer = temporal[:p] + ((d, T // t),) + temporal[p + 1:]
            yield outer + ((d, t),)


def enumerate_candidates(
    wl: Workload,
    dims: dict[str, int],
    spatials: list[SpatialChoice],
    hw: HWConfig,
    tile_search: bool = True,
) -> list[Candidate]:
    """All deduplicated mapping candidates for one layer.

    Dedup matters: a single-dim spatial choice collapses every factor pair
    of ``factor_pairs(hw.n_fus)`` to the identical ``(n_fus,)`` candidate —
    without dedup each was evaluated once per pair.  First occurrence order
    is preserved so tie-breaking matches the historical scalar search.
    """
    orders = _orders(list(wl.iter_dims), wl)
    out: list[Candidate] = []
    seen: set[tuple] = set()
    n_dup = 0

    def add(cand: Candidate) -> bool:
        nonlocal n_dup
        key = (cand.spatial_idx, cand.facs, cand.temporal)
        if key in seen:
            n_dup += 1
            return False
        seen.add(key)
        out.append(cand)
        return True

    for si, sp in enumerate(spatials):
        for facs in factor_pairs(hw.n_fus):
            if len(sp.dims) != len(facs):
                if len(sp.dims) == 1:
                    facs = (hw.n_fus,)
                else:
                    continue
            # pad dims so spatial tiles divide
            pad = dict(dims)
            ok = True
            for d, P in zip(sp.dims, facs):
                if d not in pad:
                    ok = False
                    break
                pad[d] = _ceil_to(pad[d], P)
            if not ok:
                continue
            trips = {d: pad[d] for d in pad}
            for d, P in zip(sp.dims, facs):
                trips[d] //= P
            for order in orders:
                temporal = tuple((d, trips[d]) for d in order if trips[d] > 1)
                if add(Candidate(si, facs, temporal)) and tile_search:
                    for split in _tile_splits(temporal):
                        add(Candidate(si, facs, split))
    # pruned = duplicate (spatial, facs, temporal) keys dropped by dedup —
    # the "candidates enumerated vs pruned" ratio in the bench metrics
    METRICS.counter("mapper.candidates_enumerated").inc(len(out))
    METRICS.counter("mapper.candidates_pruned").inc(n_dup)
    return out


def materialize(wl: Workload, cand: Candidate,
                spatials: list[SpatialChoice]) -> Dataflow:
    """Build the concrete (memoized) :class:`Dataflow` for a candidate."""
    sp = spatials[cand.spatial_idx]
    return build_dataflow(
        wl, spatial=list(zip(sp.dims, cand.facs)),
        temporal=list(cand.temporal), c=sp.c,
        name=f"{sp.name}-{'x'.join(map(str, cand.facs))}")


def best_mapping(
    wl: Workload,
    dims: dict[str, int],
    spatials: list[SpatialChoice],
    hw: HWConfig,
    data_nodes_per_tensor: dict[str, int] | None = None,
    ppu_elements: float = 0.0,
    objective: str = "cycles",  # "cycles" | "energy" | "edp"
    engine: str = "numpy",      # "numpy" | "batch" (alias) | "torch" | "scalar"
    tile_search: bool = True,
    device="cuda",              # engine="torch" only
) -> Mapping:
    if engine in ("numpy", "batch", "torch"):
        from .mapper_batch import best_mappings
        return best_mappings(
            wl, [(dims, ppu_elements)], spatials, hw,
            data_nodes_per_tensor=data_nodes_per_tensor,
            objective=objective, tile_search=tile_search, engine=engine,
            device=device)[0]
    if engine != "scalar":
        raise ValueError(f"unknown engine {engine!r} "
                         f"(expected 'numpy', 'torch', 'scalar' or 'batch')")

    best: Mapping | None = None
    best_key: tuple | None = None
    for cand in enumerate_candidates(wl, dims, spatials, hw,
                                     tile_search=tile_search):
        df = materialize(wl, cand, spatials)
        perf = layer_perf(wl, df, hw, true_sizes=dims,
                          data_nodes_per_tensor=data_nodes_per_tensor,
                          ppu_elements=ppu_elements)
        key = {"cycles": (perf.cycles, perf.energy_pj),
               "energy": (perf.energy_pj, perf.cycles),
               "edp": (perf.cycles * perf.energy_pj,)}[objective]
        if best_key is None or key < best_key:
            best = Mapping(df, perf, spatials[cand.spatial_idx])
            best_key = key
    assert best is not None, "no feasible mapping"
    return best

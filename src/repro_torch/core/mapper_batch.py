"""Batched mapping-search engine: the twin of the reference's
``repro.core.mapper_batch``.

The scalar mapper walks (spatial choice × factorization × loop order)
candidates one Python iteration at a time.  This module keeps the *same*
candidate enumeration (:func:`repro_torch.core.mapper.enumerate_candidates`)
but lowers the candidate set — for one layer or for **all layers of a
workload kind at once** — into the struct-of-arrays row encoding of
:mod:`repro_torch.core.perf_model` and scores the entire batch in one pass.
Selection is a stable lexicographic argmin per layer on the host, so ties
resolve to the first enumerated candidate exactly like the scalar search;
only the winning :class:`~repro_torch.core.dataflow.Dataflow` is ever
materialized.

``engine="numpy"`` (alias ``"batch"``) scores with the NumPy
:func:`~repro_torch.core.perf_model.perf_kernel`, the plain path.
``engine="torch"`` scores on the card
(:mod:`repro_torch.core.perf_model_torch`, ``device="cuda"`` unless the
caller passes another); the per-layer winners are then re-scored through
the NumPy kernel, so the reported :class:`LayerPerf` — and every mapping
cache entry built from it — is byte-identical across engines.
:func:`best_mappings_design` scores one candidate batch against a tile of
designs at once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..obs import METRICS

from .mapper import (Candidate, Mapping, SpatialChoice, enumerate_candidates,
                     materialize)
from .perf_model import NO_TRUE_SIZE, HWConfig, LayerPerf, perf_kernel
from .perf_model_torch import perf_kernel_torch, perf_kernel_torch_design
from .workload import Workload

__all__ = ["CandidateBatch", "build_batch", "evaluate_batch", "best_mappings",
           "best_mappings_design"]


@dataclass
class CandidateBatch:
    """Struct-of-arrays form of every mapping candidate of a query batch.

    Row ``i`` is one candidate of layer ``layer_id[i]``; ``offsets`` slices
    rows per layer (``offsets[q] .. offsets[q+1]``).  Array semantics match
    the row encoding documented in :mod:`repro_torch.core.perf_model`.
    """

    wl: Workload
    spatials: list[SpatialChoice]
    candidates: list[Candidate]
    loop_dim: np.ndarray   # (C, L) int64, -1 = padding slot
    loop_size: np.ndarray  # (C, L) int64
    S: np.ndarray          # (C, D) int64 spatial extent per dim
    n_fus: np.ndarray      # (C,) int64
    fill: np.ndarray       # (C,) float64
    layer_id: np.ndarray   # (C,) int64
    offsets: np.ndarray    # (n_layers + 1,) int64

    @property
    def n_candidates(self) -> int:
        return len(self.candidates)


def build_batch(
    wl: Workload,
    dims_list: list[dict[str, int]],
    spatials: list[SpatialChoice],
    hw: HWConfig,
    tile_search: bool = True,
) -> CandidateBatch:
    """Enumerate + lower the candidates of every layer into one batch."""
    D = len(wl.iter_dims)
    dim_idx = {d: i for i, d in enumerate(wl.iter_dims)}
    per_layer = [enumerate_candidates(wl, dims, spatials, hw,
                                      tile_search=tile_search)
                 for dims in dims_list]
    cands = [c for cl in per_layer for c in cl]
    C = len(cands)
    L = max((len(c.temporal) for c in cands), default=0)

    loop_dim = np.full((C, L), -1, dtype=np.int64)
    loop_size = np.ones((C, L), dtype=np.int64)
    S = np.ones((C, D), dtype=np.int64)
    n_fus = np.empty(C, dtype=np.int64)
    fill = np.empty(C, dtype=np.float64)
    layer_id = np.empty(C, dtype=np.int64)
    offsets = np.zeros(len(dims_list) + 1, dtype=np.int64)

    i = 0
    for li, cl in enumerate(per_layer):
        for c in cl:
            sp = spatials[c.spatial_idx]
            for j, (d, r) in enumerate(c.temporal):
                loop_dim[i, j] = dim_idx[d]
                loop_size[i, j] = r
            nf = 1
            for d, P in zip(sp.dims, c.facs):
                S[i, dim_idx[d]] *= P
                nf *= P
            n_fus[i] = nf
            fill[i] = float(sum(c.facs))
            layer_id[i] = li
            i += 1
        offsets[li + 1] = i
    return CandidateBatch(wl, list(spatials), cands, loop_dim, loop_size, S,
                          n_fus, fill, layer_id, offsets)


def _true_rows(wl: Workload, dims_list: list[dict[str, int]]) -> np.ndarray:
    """Un-padded dims per layer, :data:`NO_TRUE_SIZE` where unspecified."""
    true = np.full((len(dims_list), len(wl.iter_dims)), NO_TRUE_SIZE,
                   dtype=np.int64)
    for li, dims in enumerate(dims_list):
        for i, d in enumerate(wl.iter_dims):
            if d in dims:
                true[li, i] = dims[d]
    return true


def _dn_row(wl: Workload, hw: HWConfig,
            data_nodes_per_tensor: dict[str, int] | None) -> list[int]:
    """Data nodes per tensor; the scalar default is one bank read per FU
    (mapper candidates always span exactly hw.n_fus FUs, so min(dn, n_fus)
    == n_fus either way)."""
    if data_nodes_per_tensor is None:
        return [hw.n_fus for _ in wl.tensors]
    return [data_nodes_per_tensor.get(t.name, hw.n_fus) for t in wl.tensors]


def evaluate_batch(
    batch: CandidateBatch,
    hw: HWConfig,
    dims_list: list[dict[str, int]],
    ppu_list: list[float],
    data_nodes_per_tensor: dict[str, int] | None = None,
    engine: str = "numpy",
    device="cuda",
) -> dict[str, np.ndarray]:
    """Score every candidate row in one pass.

    ``engine="numpy"`` (alias ``"batch"``) runs the broadcasted NumPy
    kernels; ``engine="torch"`` scores on ``device`` — integer-derived
    outputs are bit-identical, ``energy_pj`` within
    :data:`repro_torch.core.perf_model_torch.ENERGY_RTOL`."""
    wl = batch.wl
    true = _true_rows(wl, dims_list)
    dn = np.array([_dn_row(wl, hw, data_nodes_per_tensor)], dtype=np.int64)
    ppu = np.asarray(ppu_list, dtype=np.float64)
    lid = batch.layer_id
    args = (wl, hw, batch.loop_dim, batch.loop_size, batch.S)
    kw = dict(n_fus=batch.n_fus, fill=batch.fill, true_sizes=true[lid],
              data_nodes=np.broadcast_to(
                  dn, (batch.n_candidates, dn.shape[1])),
              ppu_elements=ppu[lid])
    if engine in ("numpy", "batch"):
        return perf_kernel(*args, **kw)
    if engine == "torch":
        return perf_kernel_torch(*args, **kw, device=device)
    raise ValueError(f"unknown engine {engine!r} "
                     f"(expected 'numpy', 'torch' or 'batch')")


def _argbest(cycles: np.ndarray, energy: np.ndarray, objective: str) -> int:
    """Index of the objective-minimal candidate; ties resolve to the first
    enumerated row (stable lexsort), matching the scalar strict-< search."""
    if objective == "cycles":
        return int(np.lexsort((energy, cycles))[0])
    if objective == "energy":
        return int(np.lexsort((cycles, energy))[0])
    if objective == "edp":
        return int(np.argmin(cycles * energy))
    raise ValueError(f"unknown objective {objective!r}")


def _winners(batch: CandidateBatch, cycles: np.ndarray, energy: np.ndarray,
             objective: str) -> list[int]:
    """The objective-best row of every layer slice of ``batch``."""
    out: list[int] = []
    for li in range(len(batch.offsets) - 1):
        lo, hi = int(batch.offsets[li]), int(batch.offsets[li + 1])
        assert hi > lo, "no feasible mapping"
        out.append(lo + _argbest(cycles[lo:hi], energy[lo:hi], objective))
    return out


def best_mappings(
    wl: Workload,
    queries: list[tuple[dict[str, int], float]],
    spatials: list[SpatialChoice],
    hw: HWConfig,
    data_nodes_per_tensor: dict[str, int] | None = None,
    objective: str = "cycles",
    tile_search: bool = True,
    engine: str = "numpy",
    device="cuda",
) -> list[Mapping]:
    """Best mapping for every ``(dims, ppu_elements)`` query of one workload.

    All queries share the spatial-dataflow menu and data-node counts (the
    DSE evaluator's per-workload-kind shape), so their candidate sets are
    concatenated and scored in one pass; argmin runs per layer slice.  Only
    winners become :class:`Dataflow`/:class:`Mapping` objects.

    With ``engine="torch"`` the candidate scores come from one dispatch on
    ``device``; the stable-lexsort selection runs on the host either way,
    and the per-layer winners are re-scored through the NumPy kernel so the
    returned :class:`Mapping` is byte-identical to the ``engine="numpy"``
    result.
    """
    dims_list = [q[0] for q in queries]
    ppu_list = [float(q[1]) for q in queries]
    batch = build_batch(wl, dims_list, spatials, hw, tile_search=tile_search)
    r = evaluate_batch(batch, hw, dims_list, ppu_list,
                       data_nodes_per_tensor=data_nodes_per_tensor,
                       engine=engine, device=device)
    METRICS.counter("mapper.batch_solves").inc()
    METRICS.counter("mapper.layers_solved").inc(len(queries))
    METRICS.counter("mapper.candidates_scored").inc(batch.n_candidates)
    winners = _winners(batch, r["cycles"], r["energy_pj"], objective)
    rows = winners
    if engine == "torch":
        # report NumPy-exact numbers for the winners (a batch of n_layers
        # rows — negligible next to the candidate fan-out)
        r = _rescore_rows(batch, winners, hw, dims_list, ppu_list,
                          data_nodes_per_tensor)
        rows = list(range(len(queries)))  # rescored row li = winner of li
    out: list[Mapping] = []
    for li, w in enumerate(winners):
        cand = batch.candidates[w]
        out.append(Mapping(materialize(wl, cand, spatials),
                           LayerPerf.from_kernel(r, rows[li]),
                           spatials[cand.spatial_idx]))
    return out


def best_mappings_design(
    wl: Workload,
    queries: list[tuple[dict[str, int], float]],
    spatials: list[SpatialChoice],
    hw_list: list[HWConfig],
    data_nodes_per_tensor_list: list[dict[str, int] | None] | None = None,
    objective: str = "cycles",
    tile_search: bool = True,
    batch: CandidateBatch | None = None,
    engine: str = "torch",
    device="cuda",
    timing: dict | None = None,
) -> list[list[Mapping]]:
    """Best mappings for every query against **D design points** at once.

    The design-axis twin of :func:`best_mappings`: one candidate batch is
    enumerated (all designs must share ``n_fus`` — candidate enumeration
    depends on the design only through the FU count, asserted here) and one
    ``(design, candidate)`` dispatch scores it against every design
    (:func:`~repro_torch.core.perf_model_torch.perf_kernel_torch_design`;
    ``engine="numpy"`` scores design by design with the NumPy kernel, the
    plain path).  Selection is the host-side stable lexsort per design, and
    the per-layer winners are re-scored through the NumPy kernel, so
    ``result[d]`` is byte-identical to ``best_mappings(..., hw_list[d])``.
    Returns ``result[d][q]`` (D × len(queries) mappings).

    ``timing``, when given, accumulates the host seconds of the scoring
    dispatch (``dispatch_s``, ending in its one host sync) and of selection
    plus rescoring (``select_s``), and on a card the dispatch's device time
    (``device_ms``).
    """
    assert hw_list, "best_mappings_design needs at least one design"
    assert len({hw.n_fus for hw in hw_list}) == 1, \
        "design batch must share n_fus (identical candidate enumeration)"
    dims_list = [q[0] for q in queries]
    ppu_list = [float(q[1]) for q in queries]
    if batch is None:
        batch = build_batch(wl, dims_list, spatials, hw_list[0],
                            tile_search=tile_search)
    dnts = data_nodes_per_tensor_list or [None] * len(hw_list)
    true = _true_rows(wl, dims_list)
    ppu = np.asarray(ppu_list, dtype=np.float64)
    lid = batch.layer_id
    args = (batch.loop_dim, batch.loop_size, batch.S)
    kw = dict(n_fus=batch.n_fus, fill=batch.fill, true_sizes=true[lid],
              ppu_elements=ppu[lid])

    t0 = time.perf_counter()
    if engine == "torch":
        r = perf_kernel_torch_design(
            wl, hw_list, *args, **kw,
            data_nodes=np.asarray([_dn_row(wl, hw, dnt) for hw, dnt
                                   in zip(hw_list, dnts)], dtype=np.int64),
            device=device, timing=timing)
    elif engine in ("numpy", "batch"):
        rs = [perf_kernel(wl, hw, *args, **kw, data_nodes=np.broadcast_to(
                  np.array([_dn_row(wl, hw, dnt)], dtype=np.int64),
                  (batch.n_candidates, len(wl.tensors))))
              for hw, dnt in zip(hw_list, dnts)]
        r = {k: np.stack([x[k] for x in rs]) for k in rs[0]}
    else:
        raise ValueError(f"unknown engine {engine!r} "
                         f"(expected 'numpy', 'torch' or 'batch')")
    t1 = time.perf_counter()

    out: list[list[Mapping]] = []
    for di, hw in enumerate(hw_list):
        winners = _winners(batch, r["cycles"][di], r["energy_pj"][di],
                           objective)
        rd = _rescore_rows(batch, winners, hw, dims_list, ppu_list, dnts[di])
        out.append([Mapping(materialize(wl, batch.candidates[w], spatials),
                            LayerPerf.from_kernel(rd, li),
                            spatials[batch.candidates[w].spatial_idx])
                    for li, w in enumerate(winners)])
    if timing is not None:
        timing["dispatch_s"] = timing.get("dispatch_s", 0.0) + t1 - t0
        timing["select_s"] = (timing.get("select_s", 0.0)
                              + time.perf_counter() - t1)
    return out


def _rescore_rows(batch: CandidateBatch, rows: list[int], hw: HWConfig,
                  dims_list, ppu_list,
                  data_nodes_per_tensor) -> dict[str, np.ndarray]:
    """NumPy ``perf_kernel`` over a row subset of ``batch`` (the per-layer
    winners of a card-scored pass), keeping the candidate row encoding."""
    wl = batch.wl
    idx = np.asarray(rows, dtype=np.int64)
    true = _true_rows(wl, dims_list)
    dn_row = _dn_row(wl, hw, data_nodes_per_tensor)
    dn = np.broadcast_to(np.array([dn_row], dtype=np.int64),
                         (len(rows), len(dn_row)))
    ppu = np.asarray(ppu_list, dtype=np.float64)
    lid = batch.layer_id[idx]
    return perf_kernel(wl, hw, batch.loop_dim[idx], batch.loop_size[idx],
                       batch.S[idx], n_fus=batch.n_fus[idx],
                       fill=batch.fill[idx], true_sizes=true[lid],
                       data_nodes=dn, ppu_elements=ppu[lid])

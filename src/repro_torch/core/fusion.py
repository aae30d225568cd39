"""The DSE's half of the reference's ``repro.core.fusion``: the data-node
estimate and the scoring of one fused design over a model zoo.

:func:`estimate_data_nodes` is part of every mapping-cache key.
:func:`score_fused_design` / :func:`score_design_over_zoo` map every layer
of a zoo onto one design through a batched mapping front door (by default
:func:`repro_torch.core.mapper_batch.best_mappings`; the DSE evaluator
injects the persistent cache's, which solves misses on the card) and
aggregate cycles and energy per model, with the score-stationary
attention credit (:func:`apply_attention_fusion`) for the fused
``attention_qk``/``attention_pv`` pair.

The ADG half of the reference's module (``solve_dataflow``,
``fuse_tensor``, ``naive_merge``, ``data_node_pressure`` and the
interconnection plans) has no twin: the port builds no ADG.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..obs import METRICS
from .cost import DRAM_PJ_PER_BYTE

__all__ = ["estimate_data_nodes", "DesignScore", "score_fused_design",
           "score_design_over_zoo", "attention_fusion_viable",
           "apply_attention_fusion"]


def estimate_data_nodes(n_fus: int, tensor_names: list[str] | tuple[str, ...]
                        ) -> dict[str, int]:
    """Analytic proxy for the data-node pressure when no ADG is built.

    LEGO's interconnection generation feeds a P×P array from one edge of data
    nodes per tensor (O(√N)), not from every FU — the property that makes its
    scratchpad power beat edge-fed arrays (Table III).  DSE sweeps score
    hundreds of candidates and cannot afford full ADG generation per point,
    so they use this √N estimate.
    """
    per_tensor = max(1, int(np.sqrt(n_fus)))
    return {t: per_tensor for t in tensor_names}


# ---------------------------------------------------------------------------
# score-stationary attention fusion (paper Fig. 10 "Attention")
# ---------------------------------------------------------------------------

def attention_fusion_viable(dims: dict[str, int], hw) -> bool:
    """Can P = softmax(S) stay resident between the QK and PV stages?

    The fused design streams the batched ``b`` axis temporally, so one
    ``m × n`` score slice (data precision — P is the post-softmax tensor
    the PPUs write back in place) is the intermediate-tensor footprint that
    must fit on chip.  The slice is held partly in the FU array itself
    (score-stationary: one element per (m, n)-tile FU) and partly in the
    P banks behind its data nodes, so the capacity check is against the
    whole on-chip buffer; the data-node pressure of the P plan (or the √N
    estimate when no ADG is built — :func:`estimate_data_nodes`) already
    prices the bank traffic of the non-resident remainder in the perf model.
    """
    return dims["m"] * dims["n"] * hw.data_bytes <= hw.buffer_bytes


def _apply_dram_credit(perf, credit_bytes: float, hw):
    """Return a copy of ``perf`` with ``credit_bytes`` of DRAM traffic
    elided (the score writeback / score re-read the fusion removes).

    The per-candidate compute-cycle term is not recorded in
    :class:`~repro_torch.core.perf_model.LayerPerf`, so for memory-bound layers it
    is reconstructed from the padded MAC count (``macs / utilization /
    n_fus`` — exact up to the systolic fill term, which only matters in the
    rare case the credit flips the layer to compute-bound).  Cycles never
    drop below that reconstruction and never rise; energy loses the DRAM
    energy of the elided bytes plus the static energy of the saved cycles.
    """
    credit = min(float(credit_bytes), perf.dram_bytes)
    if credit <= 0.0:
        return perf
    new_dram = perf.dram_bytes - credit
    core = perf.cycles - perf.ppu_cycles       # == max(compute, mem_cycles)
    bound = perf.bound
    if bound == "memory":
        compute_est = perf.macs / max(perf.utilization, 1e-12) / hw.n_fus
        mem_new = new_dram / hw.bytes_per_cycle
        new_core = min(core, max(compute_est, mem_new))
        bound = "memory" if mem_new >= compute_est else "compute"
    else:
        new_core = core
    new_cycles = new_core + perf.ppu_cycles
    saved_static_pj = hw.static_mw * (perf.cycles - new_cycles) \
        / hw.freq_ghz * 1e-3
    return replace(perf, dram_bytes=new_dram, cycles=new_cycles, bound=bound,
                   energy_pj=max(0.0, perf.energy_pj
                                 - credit * DRAM_PJ_PER_BYTE
                                 - saved_static_pj))


def apply_attention_fusion(layers, perfs, hw) -> int:
    """P-resident credit for matched ``attention_qk``/``attention_pv`` rows.

    ``layers`` is the ``(workload, dims, repeat, ppu_elements)`` row list of
    one model and ``perfs`` the per-row :class:`LayerPerf` results (mutated
    in place).  A QK row pairs with the PV row of identical ``(dims,
    repeat)`` — the frontend emits them as one fused op pair.  For every
    viable pair the QK stage loses the raw-score writeback
    (``b·m·n`` accumulator-precision bytes) and the PV stage loses the
    post-softmax score read (``b·m·n`` data-precision bytes); the softmax
    itself still runs on the PPUs and is charged unchanged.  Returns the
    number of pairs fused.
    """
    pending: dict[tuple, list[int]] = {}
    fused = 0
    for idx, (wl, dims, rep, _) in enumerate(layers):
        key = (tuple(sorted(dims.items())), rep)
        if wl.name == "attention_qk":
            pending.setdefault(key, []).append(idx)
        elif wl.name == "attention_pv":
            q = pending.get(key)
            if not q:
                continue
            qi = q.pop(0)
            if not attention_fusion_viable(dims, hw):
                continue
            n_el = dims["b"] * dims["m"] * dims["n"]
            perfs[qi] = _apply_dram_credit(perfs[qi],
                                           n_el * hw.acc_bytes, hw)
            perfs[idx] = _apply_dram_credit(perfs[idx],
                                            n_el * hw.data_bytes, hw)
            fused += 1
    METRICS.counter("fusion.attention_pairs_fused").inc(fused)
    return fused


@dataclass
class DesignScore:
    """Aggregate of one design evaluated across a list of layer workloads."""

    cycles: float = 0.0
    energy_pj: float = 0.0
    macs: float = 0.0
    ppu_cycles: float = 0.0
    n_layers: int = 0

    @property
    def gops(self) -> float:
        return 2.0 * self.macs / max(1.0, self.cycles)

    @property
    def gops_per_w(self) -> float:
        mw = self.energy_pj / max(1.0, self.cycles)
        return self.gops / (mw / 1e3)

    def add(self, rep: float, cycles: float, energy_pj: float, macs: float,
            ppu_cycles: float = 0.0) -> None:
        self.cycles += rep * cycles
        self.energy_pj += rep * energy_pj
        self.macs += rep * macs
        self.ppu_cycles += rep * ppu_cycles
        self.n_layers += 1


def score_fused_design(
    layers,
    spatials,
    hw,
    *,
    data_nodes_per_tensor: dict[str, int] | None = None,
    objective: str = "cycles",
    mapping_fn=None,
    batch_mapping_fn=None,
    attention_fusion: bool = True,
) -> DesignScore:
    """Map every layer of ``layers`` onto one fused design and aggregate.

    ``layers``: iterable of ``(workload, dims, repeat, ppu_elements)``.
    ``spatials``: the design's runtime-switchable spatial dataflows — either a
    flat ``list[SpatialChoice]`` applied to every layer or a
    ``dict[workload_name, list[SpatialChoice]]``.

    By default all layers of a workload kind are solved in one vectorized
    pass (:mod:`repro_torch.core.mapper_batch`).  Two override hooks:
    ``batch_mapping_fn(wl, queries, sps, hw, data_nodes_per_tensor,
    objective) -> list[LayerPerf]`` replaces the batched solve per kind —
    the DSE engine injects its persistent-cache front door here; the legacy
    ``mapping_fn(wl, dims, sps, hw, data_nodes_per_tensor, ppu_elements,
    objective)`` forces the per-layer path instead.  Aggregation always
    walks ``layers`` in order, so totals are independent of the engine.

    With ``attention_fusion=True`` (default) rows lowered as the fused
    ``attention_qk``/``attention_pv`` pair get the score-stationary
    P-residency credit (:func:`apply_attention_fusion`) after mapping —
    callers score a non-fused design by handing it the plain-GEMM fallback
    rows instead (:func:`repro_torch.frontend.lower.unfuse_attention_rows`).

    This is the paper's "one generated architecture serves diverse models"
    scoring loop.
    """
    layers = list(layers)
    perfs: list = [None] * len(layers)
    if mapping_fn is not None:
        for idx, (wl, dims, _, ppu_elements) in enumerate(layers):
            sps = spatials[wl.name] if isinstance(spatials, dict) else spatials
            dn = data_nodes_per_tensor
            if dn is None:
                dn = estimate_data_nodes(hw.n_fus,
                                         [t.name for t in wl.tensors])
            perfs[idx] = mapping_fn(wl, dims, sps, hw, dn, ppu_elements,
                                    objective)
    else:
        if batch_mapping_fn is None:
            from .mapper_batch import best_mappings

            def batch_mapping_fn(wl, queries, sps, hw, dn, obj):
                return [m.perf for m in best_mappings(
                    wl, queries, sps, hw, data_nodes_per_tensor=dn,
                    objective=obj)]

        by_kind: dict[str, list[int]] = {}
        for idx, (wl, _, _, _) in enumerate(layers):
            by_kind.setdefault(wl.name, []).append(idx)
        for idxs in by_kind.values():
            wl = layers[idxs[0]][0]
            sps = spatials[wl.name] if isinstance(spatials, dict) else spatials
            dn = data_nodes_per_tensor
            if dn is None:
                dn = estimate_data_nodes(hw.n_fus,
                                         [t.name for t in wl.tensors])
            ps = batch_mapping_fn(
                wl, [(layers[i][1], layers[i][3]) for i in idxs], sps, hw,
                dn, objective)
            for i, p in zip(idxs, ps):
                perfs[i] = p

    if attention_fusion:
        apply_attention_fusion(layers, perfs, hw)

    score = DesignScore()
    for idx, (_, _, rep, _) in enumerate(layers):
        perf = perfs[idx]
        score.add(rep, perf.cycles, perf.energy_pj, perf.macs,
                  perf.ppu_cycles)
    return score


def score_design_over_zoo(
    zoo,
    spatials_for,
    hw,
    *,
    objective: str = "cycles",
    data_nodes_per_tensor: dict[str, int] | None = None,
    mapping_fn=None,
    batch_mapping_fn=None,
    attention_fusion: bool = True,
) -> dict[str, DesignScore]:
    """Score **one** candidate design across a whole model zoo.

    ``zoo``: ``{model_name: [(workload, dims, repeat, ppu_elements), ...]}``
    — typically the output of :func:`repro_torch.frontend.lower.lower_zoo` with
    each row's kind resolved to its :class:`~repro_torch.core.workload.Workload`.
    ``spatials_for``: the design's runtime-switchable dataflow menu — either
    a ``dict[workload_name, list[SpatialChoice]]`` shared by every model or a
    callable ``workload_name -> list[SpatialChoice]`` (e.g.
    ``DesignPoint.spatials``).

    Returns one :class:`DesignScore` per model.  This is the paper's
    "one generated architecture for diverse modern foundation models"
    objective: a single ``hw``/dataflow-set candidate is held fixed while
    every model's layers are mapped onto it; the caller aggregates the
    per-model scores into a cross-model selection metric (geomean speedup in
    :mod:`repro_torch.dse.report`).  Shared layer shapes across models dedup
    through ``batch_mapping_fn`` (the DSE mapping-cache front door).
    """
    out: dict[str, DesignScore] = {}
    for model, layers in zoo.items():
        layers = list(layers)
        if callable(spatials_for):
            spatials = {wl.name: spatials_for(wl.name)
                        for wl, _, _, _ in layers}
        else:
            spatials = spatials_for
        out[model] = score_fused_design(
            layers, spatials, hw, objective=objective,
            data_nodes_per_tensor=data_nodes_per_tensor,
            mapping_fn=mapping_fn, batch_mapping_fn=batch_mapping_fn,
            attention_fusion=attention_fusion)
    return out

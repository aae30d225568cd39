"""Heuristic-based direct-interconnection planning for dataflow fusion
(paper §IV-C, Fig. 5).

When one design must execute several spatial dataflows, naively unioning each
dataflow's minimum-spanning interconnections wastes muxes and data nodes.
LEGO instead re-plans all *direct* interconnections globally:

1. partition the FUs of each dataflow into *chains* — connected components of
   the admissible direct-reuse graph (all FUs in a chain may share data
   combinationally / with control skew only);
2. process chains shortest → longest (the worked example in the paper labels
   the long chain's root using data nodes established by shorter chains);
3. root candidates = chain FUs fed by a delay interconnection in that
   dataflow's spanning solution; if none, every chain FU is a candidate;
4. final root = candidate preferring (a) FUs already labeled as data nodes,
   (b) fewest existing physical input links, (c) lowest id — fewer muxes and
   fewer data nodes;
5. grow the chain from the root by BFS, expanding over already-built physical
   links first so long chains reuse the short chains' wiring.

Delay interconnections are then added between chain roots; physically
identical (src, dst) FIFOs are shared across dataflows because FIFO depth is
runtime-programmable (§II).

A copy of the reference's ``repro.core.fusion``, both halves: the planning
above, which :mod:`repro_torch.core.adg` drives, and the design-level
scoring the DSE runs (:func:`estimate_data_nodes` is part of every
mapping-cache key; :func:`score_fused_design` / :func:`score_design_over_zoo`
map every layer of a zoo onto one design through a batched mapping front
door, by default :func:`repro_torch.core.mapper_batch.best_mappings`).
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field, replace

import numpy as np

from ..obs import METRICS

from .dataflow import Dataflow
from .interconnect import Reuse, build_reuse_graph
from .spanning import spanning_interconnect
from .workload import Workload

__all__ = ["PhysicalLink", "FusedTensorPlan", "DataflowSolution",
           "solve_dataflow", "fuse_tensor", "naive_merge",
           "data_node_pressure", "estimate_data_nodes",
           "DesignScore", "score_fused_design", "score_design_over_zoo",
           "attention_fusion_viable", "apply_attention_fusion"]


@dataclass
class PhysicalLink:
    """One physical FU→FU connection; ``users`` maps dataflow name → FIFO
    depth (0 = wire/skew-register direct path)."""

    src: int
    dst: int
    kind: str  # "direct" | "delay"
    users: dict[str, int] = field(default_factory=dict)


@dataclass
class DataflowSolution:
    """Per-(dataflow, tensor) front-end result used by fusion."""

    df: Dataflow
    tensor: str
    parent: dict[int, int]  # spanning arborescence (root = n_fus)
    data_nodes: list[int]
    direct_edges: dict[tuple[int, int], int]  # admissible, cost = skew
    delay_edges: dict[tuple[int, int], int]  # admissible, cost = depth
    reuses: list[Reuse]


def solve_dataflow(
    wl: Workload,
    df: Dataflow,
    tensor: str,
    reuses: list[Reuse],
    mem_edge_cost: float = 1.2,
    reverse: bool = False,
) -> DataflowSolution:
    """Run §IV-A/B for a single (dataflow, tensor): admissible edges + MST.

    ``reverse=True`` (output tensors) solves in the transposed graph so the
    spanning structure funnels partial sums toward commit data nodes; the
    admissible edge books are stored transposed as well, and
    :func:`repro_torch.core.adg.generate_adg` flips the fused plan back into flow
    direction afterwards.
    """
    spatial = [r for r in reuses if r.is_spatial]
    coords = df.fu_coords()
    index = {tuple(c): i for i, c in enumerate(map(tuple, coords))}
    direct: dict[tuple[int, int], int] = {}
    delay: dict[tuple[int, int], int] = {}
    for r in spatial:
        ds = np.asarray(r.ds)
        for i, s in enumerate(coords):
            j = index.get(tuple((s + ds).tolist()))
            if j is None:
                continue
            key = (j, i) if reverse else (i, j)
            book = direct if r.kind == "direct" else delay
            if key not in book or r.depth < book[key]:
                book[key] = r.depth

    if spatial:
        g = build_reuse_graph(df, spatial, mem_edge_cost, reverse=reverse)
        parent, data_nodes = spanning_interconnect(g)
    else:
        parent = {i: df.n_fus for i in range(df.n_fus)}
        data_nodes = list(range(df.n_fus))
    return DataflowSolution(df, tensor, parent, data_nodes, direct, delay,
                            reuses)


def _chains(sol: DataflowSolution) -> list[list[int]]:
    """Connected components of the admissible direct graph (size ≥ 1)."""
    n = sol.df.n_fus
    adj: dict[int, set[int]] = defaultdict(set)
    for (u, v) in sol.direct_edges:
        adj[u].add(v)
        adj[v].add(u)
    seen: set[int] = set()
    comps = []
    for v in range(n):
        if v in seen:
            continue
        comp, q = [], deque([v])
        seen.add(v)
        while q:
            x = q.popleft()
            comp.append(x)
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    q.append(y)
        comps.append(sorted(comp))
    return comps


@dataclass
class FusedTensorPlan:
    """Fusion result for one tensor across all dataflows."""

    tensor: str
    links: dict[tuple[int, int], PhysicalLink]
    data_nodes: dict[str, list[int]]  # dataflow -> data-node FUs
    chain_roots: dict[str, list[int]]

    @property
    def all_data_nodes(self) -> list[int]:
        out: set[int] = set()
        for v in self.data_nodes.values():
            out.update(v)
        return sorted(out)

    def mux_inputs(self) -> dict[int, int]:
        """#physical input links per FU (>1 ⇒ runtime mux)."""
        fan: dict[int, int] = defaultdict(int)
        for (u, v) in self.links:
            fan[v] += 1
        return dict(fan)

    @property
    def n_links(self) -> int:
        return len(self.links)


def fuse_tensor(solutions: list[DataflowSolution]) -> FusedTensorPlan:
    """The Fig. 5 heuristic across all dataflows of one tensor."""
    tensor = solutions[0].tensor
    links: dict[tuple[int, int], PhysicalLink] = {}
    data_node_label: set[int] = set()
    out_data_nodes: dict[str, list[int]] = {}
    out_roots: dict[str, list[int]] = {}

    phys_in: dict[int, int] = defaultdict(int)

    # chains across all dataflows, shortest first (ties: dataflow order)
    work: list[tuple[int, DataflowSolution, list[int]]] = []
    for sol in solutions:
        for chain in _chains(sol):
            work.append((len(chain), sol, chain))
    work.sort(key=lambda x: (x[0],))

    # FUs fed by a delay edge in the per-dataflow arborescence
    def delay_fed(sol: DataflowSolution) -> set[int]:
        fed = set()
        for v, p in sol.parent.items():
            if p == sol.df.n_fus:
                continue
            if (p, v) in sol.delay_edges and (p, v) not in sol.direct_edges:
                fed.add(v)
        return fed

    per_df_roots: dict[str, list[int]] = defaultdict(list)
    per_df_dn: dict[str, set[int]] = defaultdict(set)

    def reach_of(sol: DataflowSolution, start: int, within: set[int]) -> set[int]:
        seen = {start}
        q = deque([start])
        while q:
            u = q.popleft()
            for v in within - seen:
                if (u, v) in sol.direct_edges:
                    seen.add(v)
                    q.append(v)
        return seen

    for _, sol, chain in work:
        dfn = sol.df.name
        remaining = set(chain)
        while remaining:
            if len(remaining) == 1:
                root = next(iter(remaining))
                reach = {root}
            else:
                cands = sorted(delay_fed(sol) & remaining) or sorted(remaining)
                # a root must be able to feed as much of the chain as possible
                reaches = {f: reach_of(sol, f, remaining) for f in cands}
                best_span = max(len(r) for r in reaches.values())
                cands = [f for f in cands if len(reaches[f]) == best_span]
                # prefer existing data nodes, then fewest existing input links
                root = min(cands, key=lambda f: (f not in data_node_label,
                                                 phys_in[f], f))
                reach = reaches[root]
            per_df_roots[dfn].append(root)

            # BFS from root over admissible direct edges, existing links first
            visited = {root}
            frontier = deque([root])
            while frontier:
                u = frontier.popleft()
                nbrs = [v for v in remaining - visited
                        if (u, v) in sol.direct_edges]
                # existing physical links first — reuse wiring
                nbrs.sort(key=lambda v: ((u, v) not in links, v))
                for v in nbrs:
                    if v in visited:
                        continue
                    visited.add(v)
                    skew = sol.direct_edges[(u, v)]
                    link = links.get((u, v))
                    if link is None:
                        link = PhysicalLink(u, v, "direct")
                        links[(u, v)] = link
                        phys_in[v] += 1
                    link.users[dfn] = skew
                    frontier.append(v)
            assert visited == reach, "BFS must cover the root's reach"
            remaining -= visited

    # delay interconnections between chain roots (per dataflow).  A root's
    # delay feed must come from *outside* its own chain (a feed from inside
    # would form a cycle with no commit point), and the chain-level feed
    # graph must stay acyclic across chains.
    for sol in solutions:
        dfn = sol.df.name
        roots = per_df_roots[dfn]
        fed = delay_fed(sol)

        chain_id: dict[int, int] = {}
        for cid, chain in enumerate(_chains(sol)):
            for f in chain:
                chain_id[f] = cid
        chain_feeds: dict[int, set[int]] = defaultdict(set)  # cid -> feeder cids

        def creates_cycle(src_cid: int, dst_cid: int) -> bool:
            if src_cid == dst_cid:
                return True
            seen, stack = set(), [src_cid]
            while stack:
                c = stack.pop()
                if c == dst_cid:
                    return True
                if c in seen:
                    continue
                seen.add(c)
                stack.extend(chain_feeds.get(c, ()))
            return False

        for r in roots:
            rc = chain_id[r]
            cands = [(d, u) for (u, v), d in sol.delay_edges.items()
                     if v == r and not creates_cycle(chain_id[u], rc)]
            if r in fed:
                p = sol.parent[r]
                if (p, r) in sol.delay_edges and not creates_cycle(chain_id[p], rc):
                    cands.insert(0, (sol.delay_edges[(p, r)], p))
            if not cands:
                # memory-fed data node
                per_df_dn[dfn].add(r)
                data_node_label.add(r)
                continue
            depth, u = min(cands)
            chain_feeds[rc].add(chain_id[u])
            key = (u, r)
            if key in links and links[key].kind == "direct":
                # separate physical FIFO path alongside the wire
                links[key].kind = "direct+delay"
                links[key].users[dfn + "#delay"] = depth
                continue
            link = links.get(key)
            if link is None:
                link = PhysicalLink(u, r, "delay")
                links[key] = link
                phys_in[r] += 1
            link.users[dfn] = depth

        out_data_nodes[dfn] = sorted(per_df_dn[dfn])
        out_roots[dfn] = sorted(set(roots))

    return FusedTensorPlan(tensor, links, out_data_nodes, out_roots)


# ---------------------------------------------------------------------------
# design-level scoring (the DSE's, repro_torch.dse)
# ---------------------------------------------------------------------------

def data_node_pressure(tensor_plans: dict[str, FusedTensorPlan]) -> dict[str, int]:
    """Bank-port pressure per tensor = data nodes of the *active* dataflow.

    Only one dataflow runs at a time; the union across dataflows would
    double-charge the fused design's scratchpad energy.
    """
    out: dict[str, int] = {}
    for t, plan in tensor_plans.items():
        per_df = [len(v) for v in plan.data_nodes.values() if v]
        out[t] = max(1, min(per_df) if per_df else len(plan.all_data_nodes))
    return out


def estimate_data_nodes(n_fus: int, tensor_names: list[str] | tuple[str, ...]
                        ) -> dict[str, int]:
    """Analytic proxy for :func:`data_node_pressure` when no ADG is built.

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
    from .cost import DRAM_PJ_PER_BYTE  # local: cost->dag->adg->fusion cycle
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


def naive_merge(solutions: list[DataflowSolution]) -> FusedTensorPlan:
    """Baseline for Table V: union each dataflow's spanning edges verbatim
    (every per-dataflow root stays a data node; no wiring reuse planning)."""
    tensor = solutions[0].tensor
    links: dict[tuple[int, int], PhysicalLink] = {}
    data_nodes: dict[str, list[int]] = {}
    roots: dict[str, list[int]] = {}
    for sol in solutions:
        dfn = sol.df.name
        dns = []
        for v, p in sol.parent.items():
            if p == sol.df.n_fus:
                dns.append(v)
                continue
            kind = "direct" if (p, v) in sol.direct_edges else "delay"
            depth = (sol.direct_edges if kind == "direct" else sol.delay_edges)[(p, v)]
            link = links.get((p, v))
            if link is None:
                link = PhysicalLink(p, v, kind)
                links[(p, v)] = link
            link.users[dfn] = depth
        data_nodes[dfn] = sorted(dns)
        roots[dfn] = sorted(dns)
    return FusedTensorPlan(tensor, links, data_nodes, roots)

"""Back-end transformation passes on the DAG (paper §V-A..D).

* ``delay_matching`` — LP (Eq. 10/11): insert the minimum register bits so
  every node's inputs arrive aligned.  Solved with HiGHS via scipy (the same
  solver the paper uses).
* ``broadcast_rewire`` — 3-stage heuristic (Fig. 8): (1) LP with a virtual
  max-cost for broadcast fan-outs, (2) MST/chain rewiring of each broadcast
  (1-D latencies ⇒ the MST is the sorted chain), (3) re-run the plain LP.
* ``extract_reduction_trees`` — collapse combinational adder chains into
  balanced ``reduce`` nodes (Fig. 9, left).
* ``pin_reuse`` — 0-1 ILP remapping per-dataflow live pins onto shared
  physical ports of reducers/muxes (Fig. 9, right).
* ``power_gate`` — clock-enables on sequential nodes not used by every
  dataflow.
* ``infer_bitwidths`` — forward value-range analysis.

Passes mutate the DAG in place and return a small result record so the
benchmarks can report per-pass savings (Fig. 13/14).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import scipy.optimize as sopt
import scipy.sparse as sp

from ..obs import METRICS

from .dag import DAG, DAGEdge

__all__ = [
    "delay_matching", "broadcast_rewire", "extract_reduction_trees",
    "pin_reuse", "power_gate", "infer_bitwidths", "run_backend",
]


# ---------------------------------------------------------------------------
# §V-A delay matching
# ---------------------------------------------------------------------------

def _lp_edges(dag: DAG) -> list[DAGEdge]:
    """Edges participating in timing (elastic FIFOs decouple timing)."""
    return [e for e in dag.edges
            if not dag.nodes[e.src].elastic and not dag.nodes[e.dst].elastic]


def _chain_fifo_terms(dag: DAG) -> list[tuple]:
    """The FIFOs on a chain of elastic nodes, as delay terms of the LP.

    Every elastic node is anchored as :func:`repro_torch.core.emit.
    anchored_sched` anchors it (nodes in id order: through its first
    out-edge whose consumer is non-elastic or already anchored, else at
    its first source, else at 0), kept symbolically as ``A = D[a] + o``
    with ``a`` a non-elastic node or ``None``.  Returns ``(fifo, a, b,
    off, cap, d_local)`` for each FIFO with local delays whose source is
    elastic or whose anchoring consumer is, where its delay is ``D[a] −
    D[b] + off + d_local`` (``b`` the source's anchor node); FIFOs whose
    delay is a constant are left out."""
    outs: dict[int, list[DAGEdge]] = defaultdict(list)
    ins: dict[int, list[DAGEdge]] = defaultdict(list)
    for e in dag.edges:
        outs[e.src].append(e)
        ins[e.dst].append(e)
    anchor: dict[int, tuple] = {}
    via: dict[int, int | None] = {}

    def of(nid):
        return (nid, 0.0) if not dag.nodes[nid].elastic else anchor.get(nid)

    for nid in sorted(dag.nodes):
        if not dag.nodes[nid].elastic:
            continue
        cons = [e for e in outs[nid] if of(e.dst) is not None]
        if cons:
            e = cons[0]
            a, o = of(e.dst)
            anchor[nid] = (a, o - dag.nodes[e.dst].latency - e.el)
            via[nid] = e.dst
        else:
            src = ins[nid]
            anchor[nid] = (of(src[0].src) if src and of(src[0].src)
                           is not None else (None, 0.0))
            via[nid] = None
    terms = []
    for nid, node in sorted(dag.nodes.items()):
        dloc = node.meta.get("d_local") if node.elastic else None
        if not dloc or not ins[nid]:
            continue
        src = ins[nid][0].src
        if not (dag.nodes[src].elastic or (
                via[nid] is not None and dag.nodes[via[nid]].elastic)):
            continue
        (a, oa), (b, ob) = anchor[nid], of(src)
        if a == b:
            continue
        cap = max(1, int(node.meta.get("depth", 1)))
        terms.append((nid, a, b, oa - ob, cap, dloc))
    return terms


@dataclass
class DelayMatchResult:
    register_bits: int
    D: dict[int, float]


def delay_matching(dag: DAG, broadcast_virtual_cost: bool = False) -> DelayMatchResult:
    """min Σ EL_{u,v}·W_{u,v}  s.t.  EL_{u,v} = D_v − D_u − L_v ≥ 0.

    With ``broadcast_virtual_cost`` (stage 1 of Fig. 8) each broadcast
    source's fan-out counts only its *maximum* EL: an auxiliary variable
    M_u ≥ EL_e replaces the per-edge terms, modelling that a broadcast can
    always be rewired into a forwarding chain afterwards.
    """
    edges = _lp_edges(dag)
    node_ids = sorted(dag.nodes)
    idx = {nid: i for i, nid in enumerate(node_ids)}
    n = len(node_ids)

    bcast_sources = set()
    if broadcast_virtual_cost:
        fan = defaultdict(int)
        for e in edges:
            fan[e.src] += 1
        bcast_sources = {u for u, f in fan.items() if f >= 3}

    aux_idx: dict[int, int] = {}
    n_aux = 0
    for u in bcast_sources:
        aux_idx[u] = n + n_aux
        n_aux += 1
    n_var = n + n_aux

    c = np.zeros(n_var)
    rows, cols, vals, b = [], [], [], []

    def add_row(entries, rhs):
        r = len(b)
        for col, v in entries:
            rows.append(r)
            cols.append(col)
            vals.append(v)
        b.append(rhs)

    for e in edges:
        lu, lv = idx[e.src], idx[e.dst]
        L = dag.nodes[e.dst].latency
        # EL = D_v - D_u - L >= 0  →  D_u - D_v <= -L
        add_row([(lu, 1.0), (lv, -1.0)], -float(L))
        if e.src in bcast_sources:
            # M_u >= EL_e  →  D_v - D_u - M_u <= L
            add_row([(lv, 1.0), (lu, -1.0), (aux_idx[e.src], -1.0)], float(L))
        else:
            c[lv] += e.bits
            c[lu] -= e.bits

    for u in bcast_sources:
        w = max(e.bits for e in edges if e.src == u)
        c[aux_idx[u]] += w

    # FIFO realizability: elastic links decouple timing but can only *add*
    # delay, bounded by their capacity.  For a codegen FIFO fed from u with
    # consumer v, the runtime-programmed delay under dataflow d is
    # p_d = D_v − L_v − D_u + d_local(d); require 0 ≤ p_d ≤ CAP so the
    # schedule the LP picks stays physically realizable (rtlsim executes
    # exactly these delays and re-checks them).
    for nid, node in dag.nodes.items():
        if not node.elastic:
            continue
        dloc = node.meta.get("d_local")
        if not dloc:
            continue
        cap = max(1, int(node.meta.get("depth", 1)))
        for ein in dag.in_edges(nid):
            if dag.nodes[ein.src].elastic or ein.src not in idx:
                continue
            for eout in dag.out_edges(nid):
                if dag.nodes[eout.dst].elastic or eout.dst not in idx:
                    continue
                lu, lv = idx[ein.src], idx[eout.dst]
                Lv = dag.nodes[eout.dst].latency
                for dl in dloc.values():
                    add_row([(lu, 1.0), (lv, -1.0)], float(dl - Lv))
                    add_row([(lv, 1.0), (lu, -1.0)], float(cap - dl + Lv))

    # FIFO chains: the rows above skip a FIFO fed by a FIFO or anchored
    # through one, so nothing kept its delay within its capacity.  Such a
    # FIFO's delay is measured between anchored times, as the netlist
    # schedule measures it (emit.anchored_sched, rtlsim._schedule):
    # p_d = A[fifo] − A[source] + d_local(d), each A the potential of one
    # non-elastic node plus a constant.  No row is added where no FIFO
    # feeds a FIFO.
    for _, fa, fb, off, cap, dloc in _chain_fifo_terms(dag):
        for dl in dloc.values():
            # 0 ≤ D_fa − D_fb + off + dl ≤ cap
            add_row([(idx[x], s) for x, s in ((fb, 1.0), (fa, -1.0))
                     if x is not None], float(off + dl))
            add_row([(idx[x], s) for x, s in ((fa, 1.0), (fb, -1.0))
                     if x is not None], float(cap - off - dl))

    A = sp.csr_matrix((vals, (rows, cols)), shape=(len(b), n_var))
    METRICS.counter("backend.lp_solves").inc()
    METRICS.counter("backend.lp_rows").inc(len(b))
    METRICS.counter("backend.lp_vars").inc(n_var)
    res = sopt.linprog(c, A_ub=A, b_ub=np.array(b),
                       bounds=[(0, None)] * n_var, method="highs")
    if not res.success:
        raise RuntimeError(f"delay-matching LP failed: {res.message}")
    D = {nid: float(res.x[idx[nid]]) for nid in node_ids}

    total_bits = 0
    for e in edges:
        el = D[e.dst] - D[e.src] - dag.nodes[e.dst].latency
        e.el = int(round(el))
        assert e.el >= -1e-6
        total_bits += e.el * e.bits
    dag.sched = D
    METRICS.gauge("backend.register_bits").set(int(total_bits))
    return DelayMatchResult(int(total_bits), D)


# ---------------------------------------------------------------------------
# §V-B broadcast pin rewiring
# ---------------------------------------------------------------------------

@dataclass
class RewireResult:
    sources_rewired: int
    register_bits_before: int
    register_bits_after: int


def broadcast_rewire(dag: DAG, min_fanout: int = 3) -> RewireResult:
    """Fig. 8: stage-1 LP with virtual broadcast cost, stage-2 chain rewiring
    (latencies are 1-D, so the MST over |Δlatency| costs is the sorted
    chain), stage-3 plain re-LP to redistribute remaining slack."""
    before = delay_matching(dag).register_bits
    delay_matching(dag, broadcast_virtual_cost=True)

    fan: dict[int, list[DAGEdge]] = defaultdict(list)
    for e in _lp_edges(dag):
        fan[e.src].append(e)

    rewired = 0
    for u, out in list(fan.items()):
        if len(out) < min_fanout:
            continue
        # only rewire homogeneous broadcast (same payload everywhere)
        if len({e.bits for e in out}) != 1:
            continue
        # per-destination required latency from the stage-1 solution
        lat = [(e.el, e) for e in out]
        if all(l == 0 for l, _ in lat):
            continue
        lat.sort(key=lambda x: (x[0], x[1].dst))
        rewired += 1
        # remove the original broadcast edges; build a forwarding chain of
        # zero-latency wire taps (the paper's pin registers): the value is
        # forwarded *past* each destination, never through its function
        for _, e in lat:
            dag.edges.remove(e)
        prev = u
        for l, e in lat:
            w = dag.add("wire", e.bits, users=dag.users.get(e.dst, None),
                        rewire_tap=True)
            dag.wire(prev, w, bits=e.bits, rewired=True)
            dag.wire(w, e.dst, bits=e.bits, **{**e.meta, "rewired": True})
            prev = w

    after = delay_matching(dag).register_bits
    return RewireResult(rewired, before, after)


# ---------------------------------------------------------------------------
# §V-C reduction tree extraction
# ---------------------------------------------------------------------------

@dataclass
class ReduceResult:
    chains_extracted: int
    adders_removed: int


def extract_reduction_trees(dag: DAG, min_chain: int = 3) -> ReduceResult:
    """Collapse maximal combinational adder chains (add feeding add through
    un-registered edges) into single balanced ``reduce`` nodes."""
    consumers: dict[int, list[DAGEdge]] = defaultdict(list)
    for e in dag.edges:
        consumers[e.src].append(e)

    def is_add(nid: int) -> bool:
        return nid in dag.nodes and dag.nodes[nid].kind == "add"

    # next add in chain: add u whose sole consumer is another add, via an
    # edge with no skew registers between them
    nxt: dict[int, int] = {}
    for nid in list(dag.nodes):
        if not is_add(nid):
            continue
        outs = consumers[nid]
        if len(outs) == 1 and is_add(outs[0].dst) and outs[0].el == 0:
            nxt[nid] = outs[0].dst

    heads = [nid for nid in dag.nodes
             if is_add(nid) and nid not in set(nxt.values())]

    chains_done = adders_removed = 0
    for head in heads:
        chain = [head]
        while chain[-1] in nxt:
            chain.append(nxt[chain[-1]])
        if len(chain) < min_chain:
            continue
        # gather non-chain inputs of every adder in the chain
        leaf_edges: list[DAGEdge] = []
        chain_set = set(chain)
        for a in chain:
            for e in dag.in_edges(a):
                if e.src not in chain_set:
                    leaf_edges.append(e)
        tail = chain[-1]
        tail_outs = dag.out_edges(tail)
        users = set()
        for a in chain:
            users |= dag.users[a]
        red = dag.add("reduce", dag.nodes[tail].bits, users=users,
                      fan=len(leaf_edges))
        for e in leaf_edges:
            e.dst = red
        for e in tail_outs:
            e.src = red
        # drop chain adders and intra-chain edges
        dag.edges = [e for e in dag.edges
                     if e.src not in chain_set and e.dst not in chain_set]
        for a in chain:
            del dag.nodes[a]
            del dag.users[a]
        chains_done += 1
        adders_removed += len(chain)
    return ReduceResult(chains_done, adders_removed)


# ---------------------------------------------------------------------------
# §V-C pin reusing (0-1 ILP, Fig. 9)
# ---------------------------------------------------------------------------

@dataclass
class PinReuseResult:
    nodes_optimized: int
    pins_before: int
    pins_after: int


def pin_reuse(dag: DAG) -> PinReuseResult:
    """Remap per-dataflow live input pins of reducers/muxes onto shared
    physical ports with a 0-1 integer program:

      minimize  Σ_{i,j} y_{i,j}
      s.t.      Σ_j C_{i,j,k} = 1          (i live in dataflow k)
                Σ_i C_{i,j,k} ≤ 1          (port exclusivity per dataflow)
                C_{i,j,k} ≤ y_{i,j}        (connection indicator)
    """
    dataflows = dag.dataflows or ["default"]
    pins_before = pins_after = optimized = 0

    for nid in list(dag.nodes):
        node = dag.nodes[nid]
        if node.kind not in ("reduce", "mux", "add"):
            continue
        ins = dag.in_edges(nid)
        if len(ins) < 2:
            continue
        # liveness: which dataflows use each input edge
        live = [sorted(dag.users.get(e.src, set(dataflows))) for e in ins]
        per_df = {k: [i for i, l in enumerate(live) if k in l]
                  for k in dataflows}
        need = max((len(v) for v in per_df.values()), default=len(ins))
        if need >= len(ins):
            continue  # nothing to save

        n_i, n_j, n_k = len(ins), need, len(dataflows)
        nC = n_i * n_j * n_k
        nY = n_i * n_j

        def Cix(i, j, k):
            return (i * n_j + j) * n_k + k

        def Yix(i, j):
            return nC + i * n_j + j

        c = np.zeros(nC + nY)
        c[nC:] = 1.0
        rows_eq, cols_eq, vals_eq, b_eq = [], [], [], []
        rows_ub, cols_ub, vals_ub, b_ub = [], [], [], []

        for k, kname in enumerate(dataflows):
            act = per_df[kname]
            for i in act:
                r = len(b_eq)
                for j in range(n_j):
                    rows_eq.append(r)
                    cols_eq.append(Cix(i, j, k))
                    vals_eq.append(1.0)
                b_eq.append(1.0)
            for j in range(n_j):
                r = len(b_ub)
                for i in act:
                    rows_ub.append(r)
                    cols_ub.append(Cix(i, j, k))
                    vals_ub.append(1.0)
                b_ub.append(1.0)
            for i in act:
                for j in range(n_j):
                    r = len(b_ub)
                    rows_ub.append(r)
                    cols_ub.append(Cix(i, j, k))
                    vals_ub.append(1.0)
                    rows_ub.append(r)
                    cols_ub.append(Yix(i, j))
                    vals_ub.append(-1.0)
                    b_ub.append(0.0)

        constraints = []
        if b_eq:
            A = sp.csr_matrix((vals_eq, (rows_eq, cols_eq)),
                              shape=(len(b_eq), nC + nY))
            constraints.append(sopt.LinearConstraint(A, np.array(b_eq),
                                                     np.array(b_eq)))
        if b_ub:
            A = sp.csr_matrix((vals_ub, (rows_ub, cols_ub)),
                              shape=(len(b_ub), nC + nY))
            constraints.append(sopt.LinearConstraint(A, -np.inf,
                                                     np.array(b_ub)))
        res = sopt.milp(c, constraints=constraints,
                        integrality=np.ones(nC + nY),
                        bounds=sopt.Bounds(0, 1))
        if not res.success:
            continue

        # apply: port j gathers the inputs mapped to it (mux if > 1)
        y = res.x[nC:].round().astype(int).reshape(n_i, n_j)
        pins_before += n_i
        pins_after += n_j
        optimized += 1
        node.meta["ports"] = n_j
        node.meta["pin_map"] = {i: int(np.argmax(y[i])) for i in range(n_i)
                                if y[i].any()}
        if node.kind == "reduce":
            node.meta["fan"] = n_j
        port_edges: dict[int, list[DAGEdge]] = defaultdict(list)
        for i, e in enumerate(ins):
            j = node.meta["pin_map"].get(i, 0)
            port_edges[j].append(e)
        for j, elist in port_edges.items():
            if len(elist) > 1:
                mux = dag.add("mux", elist[0].bits,
                              users=set().union(*[dag.users.get(e.src, set())
                                                  for e in elist]),
                              ways=len(elist), pin_share=True)
                for e in elist:
                    e.dst = mux
                dag.wire(mux, nid, bits=elist[0].bits)

    return PinReuseResult(optimized, pins_before, pins_after)


# ---------------------------------------------------------------------------
# §V-D power gating + bitwidth inference
# ---------------------------------------------------------------------------

def power_gate(dag: DAG) -> int:
    """Clock-enable sequential nodes not used by every dataflow; returns the
    number of gated nodes (their idle dynamic power drops to ~0 in cost.py)."""
    alln = set(dag.dataflows)
    gated = 0
    for nid, node in dag.nodes.items():
        if node.kind in ("fifo", "reg", "acc") and dag.users[nid] != alln:
            node.meta["gated"] = True
            gated += 1
    return gated


def infer_bitwidths(dag: DAG, data_bits: int = 8, max_accum: int = 4096) -> int:
    """Forward value-range propagation; returns total bits saved."""
    lo = -(2 ** (data_bits - 1))
    hi = 2 ** (data_bits - 1) - 1
    rng: dict[int, tuple[int, int]] = {}
    saved = 0
    for nid in dag.toposort():
        node = dag.nodes[nid]
        ins = [rng.get(e.src, (lo, hi)) for e in dag.in_edges(nid)]
        if node.kind in ("input", "memport", "const", "counter"):
            r = (lo, hi)
        elif node.kind == "mul":
            a = ins[0] if ins else (lo, hi)
            b = ins[1] if len(ins) > 1 else (lo, hi)
            cands = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
            r = (min(cands), max(cands))
        elif node.kind in ("add", "reduce"):
            fan = max(1, len(ins))
            r = (sum(x[0] for x in ins), sum(x[1] for x in ins))
        elif node.kind == "acc":
            a = ins[0] if ins else (lo, hi)
            r = (a[0] * max_accum, a[1] * max_accum)
        else:
            r = ins[0] if ins else (lo, hi)
        rng[nid] = r
        span = max(abs(r[0]), abs(r[1]) + 1)
        need = min(32, max(2, int(span).bit_length() + 1))
        if node.kind not in ("addrgen", "counter") and need < node.bits:
            saved += node.bits - need
            node.bits = need
            for e in dag.out_edges(nid):
                e.bits = min(e.bits, need)
    return saved


# ---------------------------------------------------------------------------
# the whole back end
# ---------------------------------------------------------------------------

def run_backend(dag: DAG, optimize: bool = True, data_bits: int = 8) -> dict:
    """Full back-end pipeline.  ``optimize=False`` is the Fig. 10 baseline:
    delay matching only (mandatory for timing correctness).

    The final :func:`delay_matching` call leaves the DAG emit-ready: every
    edge carries its register count (``el``) and ``dag.sched`` holds the LP
    potentials — :func:`repro_torch.core.emit.emit_netlist` renders the result as
    structural Verilog and :func:`repro_torch.core.rtlsim.simulate_rtl` executes
    and re-verifies it."""
    report: dict = {}
    if not optimize:
        r = delay_matching(dag)
        report["register_bits"] = r.register_bits
        report["pipeline_depth"] = _depth(r)
        return report
    red = extract_reduction_trees(dag)
    report["reduction"] = red.__dict__
    rw = broadcast_rewire(dag)
    report["rewire"] = rw.__dict__
    pr = pin_reuse(dag)
    report["pin_reuse"] = pr.__dict__
    report["power_gated"] = power_gate(dag)
    report["bits_saved"] = infer_bitwidths(dag, data_bits)
    r = delay_matching(dag)
    report["register_bits"] = r.register_bits
    report["pipeline_depth"] = _depth(r)
    return report


def _depth(r: DelayMatchResult) -> int:
    """Array fill latency implied by the delay-matching potentials."""
    return int(round(max(r.D.values()) - min(r.D.values()))) if r.D else 0

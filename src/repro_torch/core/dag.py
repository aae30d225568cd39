"""Detailed Architecture Graph — the primitive-level IR of the back end
(paper Fig. 7(b)) and the ADG→DAG translation pass (codegen).

DAG nodes are hardware primitives (multipliers, adders, muxes, registers,
FIFOs, address generators, memory ports, reducers); edges carry bit-widths
and accumulate the pipeline registers inserted by delay matching (``el``).
FU boundaries are dissolved: an FU's multiplier and its neighbor's adder are
just nodes, which is what lets the LP/ILP passes optimize the array as a
whole instead of per-template (§V).

Latency model: combinational primitives (mux, wire) have ``latency = 0``;
arithmetic primitives are pipelined with ``latency = 1``; skew registers
carry their skew; FIFOs are *elastic* (runtime-programmable depth) and are
therefore excluded from the delay-matching constraint system.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .adg import ADG

__all__ = ["DAGNode", "DAGEdge", "DAG", "codegen"]

# primitive -> (latency_cycles, is_elastic)
PRIM_LATENCY = {
    "input": 0, "output": 0, "const": 0, "wire": 0, "mux": 0,
    "mul": 1, "add": 1, "acc": 1, "shift": 0, "lut": 1,
    "reg": None,  # latency = meta["depth"]
    "fifo": 0,  # elastic
    "addrgen": 1, "counter": 1, "memport": 1, "reduce": None,  # ceil(log2(fan))
}


@dataclass
class DAGNode:
    id: int
    kind: str
    bits: int = 16
    meta: dict = field(default_factory=dict)

    @property
    def latency(self) -> int:
        if self.kind == "reg":
            return int(self.meta.get("depth", 1))
        if self.kind == "reduce":
            fan = max(2, int(self.meta.get("fan", 2)))
            return int(np.ceil(np.log2(fan)))
        lat = PRIM_LATENCY.get(self.kind, 0)
        return int(lat or 0)

    @property
    def elastic(self) -> bool:
        return self.kind == "fifo"


@dataclass
class DAGEdge:
    src: int
    dst: int
    bits: int = 16
    el: int = 0  # pipeline registers inserted by delay matching
    meta: dict = field(default_factory=dict)


class DAG:
    def __init__(self, name: str = "dag"):
        self.name = name
        self.nodes: dict[int, DAGNode] = {}
        self.edges: list[DAGEdge] = []
        self._next = 0
        # per-dataflow usage: node id -> set of dataflow names using it
        self.users: dict[int, set[str]] = {}
        self.dataflows: list[str] = []
        # codegen provenance consumed by emit/rtlsim (empty for hand-built DAGs)
        self.opnd_ports: dict[tuple[str, int], int] = {}  # (tensor, fu) -> nid
        self.fu_product: dict[int, int] = {}  # fu -> final multiplier node
        # multi-*workload* provenance: distinct workload kinds fused into one
        # design (score-stationary attention), in spec order, and which
        # workload each dataflow executes — drives the workload-select ctrl
        # field in emit and the per-stage operand muxing in rtlsim
        self.workloads: list[str] = []
        self.df_workload: dict[str, str] = {}
        # last delay-matching potentials D (pins schedule components whose
        # only coupling is elastic; see rtlsim._schedule)
        self.sched: dict[int, float] = {}

    # -- construction ------------------------------------------------------
    def add(self, kind: str, bits: int = 16, users=None, **meta) -> int:
        nid = self._next
        self._next += 1
        self.nodes[nid] = DAGNode(nid, kind, bits, dict(meta))
        self.users[nid] = set(users) if users else set(self.dataflows)
        return nid

    def wire(self, src: int, dst: int, bits: int | None = None, **meta) -> DAGEdge:
        if bits is None:
            bits = self.nodes[src].bits
        e = DAGEdge(src, dst, bits, 0, dict(meta))
        self.edges.append(e)
        return e

    # -- queries -----------------------------------------------------------
    def in_edges(self, nid: int) -> list[DAGEdge]:
        return [e for e in self.edges if e.dst == nid]

    def in_edge_map(self) -> dict[int, list[DAGEdge]]:
        """dst → in-edges (stable edge order) in one O(E) pass — use instead
        of per-node :meth:`in_edges` scans when walking the whole graph."""
        m: dict[int, list[DAGEdge]] = {nid: [] for nid in self.nodes}
        for e in self.edges:
            m[e.dst].append(e)
        return m

    def out_edges(self, nid: int) -> list[DAGEdge]:
        return [e for e in self.edges if e.src == nid]

    def count(self, kind: str) -> int:
        return sum(1 for n in self.nodes.values() if n.kind == kind)

    def pipeline_register_bits(self) -> int:
        """Total bits of delay-matching registers (Σ EL·W) — the quantity the
        back-end LP minimizes (paper Eq. 11)."""
        return sum(e.el * e.bits for e in self.edges)

    def register_bits(self) -> int:
        """All register bits: pipeline + skew regs + accumulators."""
        bits = self.pipeline_register_bits()
        for n in self.nodes.values():
            if n.kind == "reg":
                bits += n.bits * max(1, n.meta.get("depth", 1))
            elif n.kind == "acc":
                bits += n.bits
        return bits

    def fifo_bits(self) -> int:
        return sum(n.bits * max(1, n.meta.get("depth", 1))
                   for n in self.nodes.values() if n.kind == "fifo")

    def toposort(self) -> list[int]:
        indeg = {nid: 0 for nid in self.nodes}
        for e in self.edges:
            if not self.nodes[e.src].elastic:
                indeg[e.dst] += 1
        from collections import deque
        q = deque(nid for nid, d in indeg.items() if d == 0)
        order = []
        while q:
            u = q.popleft()
            order.append(u)
            for e in self.out_edges(u):
                if self.nodes[u].elastic:
                    continue
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    q.append(e.dst)
        if len(order) != len(self.nodes):
            # cycles must pass through elastic nodes; report remaining anyway
            rest = [nid for nid in self.nodes if nid not in order]
            order.extend(rest)
        return order

    def stats(self) -> dict:
        from collections import Counter
        c = Counter(n.kind for n in self.nodes.values())
        return {
            **dict(c),
            "edges": len(self.edges),
            "pipeline_reg_bits": self.pipeline_register_bits(),
            "register_bits": self.register_bits(),
            "fifo_bits": self.fifo_bits(),
        }


# ---------------------------------------------------------------------------
# codegen: ADG → DAG (paper §V, translation pass)
# ---------------------------------------------------------------------------

def codegen(adg: ADG, data_bits: int = 8, acc_bits: int = 32) -> DAG:
    """Open the FU black boxes (Fig. 7): expand every FU into its compute
    primitives, every physical link into wires/skew-regs/FIFOs, every
    multi-source operand into a mux, and instantiate the single shared
    control/address generators whose signals propagate per the control-flow
    vector ``c`` (§III-D — this is what removes per-FU address logic).
    """
    dag = DAG(adg.name)
    dag.dataflows = list(adg.dataflow_names)
    n_fus = adg.n_fus

    # multi-workload provenance: one design may fuse dataflows of *distinct*
    # workloads (attention_qk + attention_pv) whose FU operand networks must
    # be muxed per stage
    dag.workloads = list(dict.fromkeys(s.workload.name for s in adg.specs))
    dag.df_workload = {s.dataflow.name: s.workload.name for s in adg.specs}
    wl_dataflows = {w: tuple(s.dataflow.name for s in adg.specs
                             if s.workload.name == w)
                    for w in dag.workloads}
    if len(dag.workloads) > 1:
        # the FU compute plane is shared: every fused workload must use the
        # same loop body and operand count, or the unused multiplier stage /
        # operand slot would silently corrupt the other workload's products
        shapes = {w: (next(s.workload.compute for s in adg.specs
                           if s.workload.name == w),
                      len(next(s.workload.inputs for s in adg.specs
                               if s.workload.name == w)))
                  for w in dag.workloads}
        if len(set(shapes.values())) > 1:
            raise NotImplementedError(
                "multi-workload designs must agree on the FU loop body "
                f"(compute kind and input-operand count); got {shapes}")

    _rtables: dict[tuple[str, str], dict] = {}

    def _rtable(df_name: str, tensor: str) -> dict:
        key = (df_name, tensor)
        if key not in _rtables:
            _rtables[key] = adg.reuse_table(df_name, tensor)
        return _rtables[key]

    compute = {s.dataflow.name: s.workload.compute for s in adg.specs}
    any_mac2 = any(v == "mac2" for v in compute.values())

    # -- operand source nodes per (tensor, fu) ------------------------------
    # in_port[(tensor, fu)] = node id delivering that operand to the FU
    in_port: dict[tuple[str, int], int] = {}
    out_sink: dict[tuple[str, int], int] = {}

    input_tensors: list[str] = []
    output_tensor: dict[str, str] = {}
    for s in adg.specs:
        for t in s.workload.inputs:
            if t.name not in input_tensors:
                input_tensors.append(t.name)
        output_tensor[s.dataflow.name] = s.workload.output.name

    # memory ports: one read port per data node per tensor (fed by the data
    # distribution switch from the banks; the switch cost is modeled in cost.py)
    for tensor, plan in adg.tensor_plans.items():
        is_out = tensor in output_tensor.values()
        bits = acc_bits if is_out else data_bits
        # sources entering each FU for this operand:
        # (node-or-fu_out-ref, kind, depth, live dataflows, PhysicalLink)
        srcs: dict[int, list[tuple]] = {f: [] for f in range(n_fus)}

        if not is_out:
            for dfn, dns in plan.data_nodes.items():
                for f in dns:
                    mp = dag.add("memport", bits, users={dfn}, tensor=tensor,
                                 fu=f, direction="read")
                    srcs[f].append((mp, "mem", 0, {dfn}, None))

        for (u, v), link in plan.links.items():
            depths = link.users
            if link.kind == "direct" or link.kind == "direct+delay":
                skew = max((d for k, d in depths.items() if "#" not in k),
                           default=0)
                # the wire/skew-reg path serves the plainly-keyed dataflows
                live = {k for k in depths if "#" not in k}
                srcs[v].append((("fu_out", u), "link", skew, live, link))
            if "delay" in link.kind:
                depth = max(depths.values())
                # the FIFO path serves "#delay"-keyed dataflows (alongside a
                # wire) or every user of a pure delay link
                live = ({k.split("#")[0] for k in depths if "#" in k}
                        if link.kind == "direct+delay" else set(depths))
                srcs[v].append((("fu_out", u), "fifo", depth, live, link))

        plan.meta_srcs = srcs  # type: ignore[attr-defined]
        if is_out:
            # output write ports for data nodes
            pass

    # -- FU compute primitives ----------------------------------------------
    fu_out: dict[tuple[str, int], int] = {}  # (tensor, fu) -> producing node
    fu_mul: dict[int, int] = {}   # fu -> final (product) multiplier
    fu_mul1: dict[int, int] = {}  # fu -> first-stage multiplier (operand in)
    fu_add: dict[int, int] = {}

    # first create all compute nodes so links can reference fu outputs
    for f in range(n_fus):
        mul = dag.add("mul", 2 * data_bits, fu=f)
        fu_mul[f] = fu_mul1[f] = mul
        if any_mac2:
            mul2 = dag.add("mul", 2 * data_bits, fu=f, stage=2)
            dag.wire(mul, mul2)
            fu_mul[f] = mul2
        add = dag.add("add", acc_bits, fu=f)
        dag.wire(fu_mul[f], add, bits=2 * data_bits)
        fu_add[f] = add

    # resolve operand sources into muxes / wires / fifos
    for tensor, plan in adg.tensor_plans.items():
        is_out = tensor in output_tensor.values()
        bits = acc_bits if is_out else data_bits
        srcs = plan.meta_srcs  # type: ignore[attr-defined]
        for f in range(n_fus):
            entries = srcs.get(f, [])
            resolved: list[int] = []
            for src, kind, depth, users, link in entries:
                nid = src if isinstance(src, int) else (
                    fu_add[src[1]] if is_out else None)
                if nid is None:
                    # input tensor forwarded from another FU's operand register
                    nid = in_port.get((tensor, src[1]))
                    if nid is None:
                        # operand path not yet built; use a placeholder wire
                        nid = dag.add("wire", bits, users=users, tensor=tensor,
                                      fu=src[1], forward=True)
                        in_port[(tensor, src[1])] = nid
                lmeta = {} if link is None else {
                    "src_fu": link.src, "dst_fu": link.dst,
                    "depths": {k: int(v) for k, v in sorted(link.users.items())}}
                if kind == "fifo":
                    # local-time delay per serving dataflow (t_scalar(Δt) of
                    # the matching reuse) — drives the FIFO-realizability
                    # rows of the delay-matching LP and the rtlsim delays
                    dloc = {}
                    for base in sorted(users):
                        df_b = adg.spec(base).dataflow
                        cds = df_b.fu_coords()
                        ent = _rtable(base, tensor).get(
                            tuple((cds[link.dst] - cds[link.src]).tolist()))
                        if ent is not None:
                            dloc[base] = int(df_b.t_scalar(ent[0]))
                    lmeta["d_local"] = dloc
                    fifo = dag.add("fifo", bits, users=users, depth=depth,
                                   tensor=tensor, **lmeta)
                    dag.wire(nid, fifo, bits=bits)
                    nid = fifo
                elif kind == "link" and depth > 0:
                    reg = dag.add("reg", bits, users=users, depth=depth,
                                  tensor=tensor, skew=True, **lmeta)
                    dag.wire(nid, reg, bits=bits)
                    nid = reg
                resolved.append((nid, users))

            if not resolved:
                continue
            if len(resolved) > 1:
                mux = dag.add("mux", bits, tensor=tensor, fu=f,
                              ways=len(resolved))
                for r, live in resolved:
                    # per-input dataflow liveness drives the runtime select
                    dag.wire(r, mux, bits=bits, live=tuple(sorted(live)))
                port = mux
            else:
                port = resolved[0][0]

            if (tensor, f) in in_port:
                # back-patch placeholder forward wires
                ph = in_port[(tensor, f)]
                if dag.nodes[ph].meta.get("forward"):
                    dag.wire(port, ph, bits=bits)
                    port = ph
            in_port[(tensor, f)] = port

    # -- operand slots per *workload* ---------------------------------------
    # workload w's input tensors feed the FU multiplier operand positions in
    # order; a heterogeneous design (attention_qk + attention_pv) muxes the
    # per-workload operand networks in front of each slot — the runtime
    # workload switch of the score-stationary fused design.  The mux input
    # order follows ``dag.workloads`` so the select value is the workload
    # index (the workload-select ctrl field in emit).
    n_slots = 3 if any_mac2 else 2
    slot_tensors: list[list[tuple[str, str]]] = [[] for _ in range(n_slots)]
    for w in dag.workloads:
        w_inputs = next(s.workload.inputs for s in adg.specs
                        if s.workload.name == w)
        for k, t in enumerate(w_inputs[:n_slots]):
            slot_tensors[k].append((w, t.name))

    # dataflows per output tensor: drives psum-edge liveness so the shared
    # adder plane only sums the active workload's reduction network
    out_live = {ot: tuple(sorted(d for d, o in output_tensor.items()
                                 if o == ot))
                for ot in set(output_tensor.values())}

    for f in range(n_fus):
        for k in range(n_slots):
            # one port per workload; a missing port in a heterogeneous design
            # becomes a switch-served placeholder so every stage's operand
            # physically exists (rtlsim injects its values at the port)
            by_tensor: dict[str, list[str]] = {}
            for w, tn in slot_tensors[k]:
                if (tn, f) not in in_port and len(dag.workloads) > 1:
                    in_port[(tn, f)] = dag.add(
                        "wire", data_bits, users=set(wl_dataflows[w]),
                        tensor=tn, fu=f, switch_port=True)
                if (tn, f) in in_port:
                    by_tensor.setdefault(tn, []).extend(wl_dataflows[w])
            if not by_tensor:
                continue
            target = fu_mul[f] if (any_mac2 and k == 2) else fu_mul1[f]
            if len(by_tensor) == 1:
                tn = next(iter(by_tensor))
                dag.wire(in_port[(tn, f)], target, bits=data_bits)
            else:
                mux = dag.add("mux", data_bits, fu=f, slot=k,
                              ways=len(by_tensor), wl_mux=True)
                for tn, dfs in by_tensor.items():
                    dag.wire(in_port[(tn, f)], mux, bits=data_bits,
                             live=tuple(sorted(dfs)))
                dag.wire(mux, target, bits=data_bits)

        # output reduction / accumulation (dedup: fused dataflows sharing one
        # output tensor must not wire the same psum port twice); per-tensor
        # liveness keeps the inactive workload's psum network out of the sum
        for ot in dict.fromkeys(output_tensor.values()):
            if (ot, f) in in_port:
                dag.wire(in_port[(ot, f)], fu_add[f], bits=acc_bits,
                         live=out_live[ot])

        # stationary accumulator (e.g. Y revisit): acc register on the adder
        needs_acc = any(
            r.depth >= 1 for dfn in adg.dataflow_names
            for r in adg.stationary.get((dfn, output_tensor[dfn]), []))
        if needs_acc:
            acc = dag.add("acc", acc_bits, fu=f)
            dag.wire(fu_add[f], acc)
            fu_out_node = acc
        else:
            fu_out_node = fu_add[f]
        for dfn in adg.dataflow_names:
            fu_out[(output_tensor[dfn], f)] = fu_out_node

    # output write ports: data nodes of the output tensor commit to memory
    for dfn in adg.dataflow_names:
        ot = output_tensor[dfn]
        plan = adg.tensor_plans[ot]
        for f in plan.data_nodes.get(dfn, []):
            wp = dag.add("memport", acc_bits, users={dfn}, tensor=ot, fu=f,
                         direction="write")
            dag.wire(fu_out[(ot, f)], wp, bits=acc_bits)

    # -- shared control: counters + address generators ----------------------
    ctrl = dag.add("counter", 16, role="timestamp")
    for (dfn, tensor), gens in adg.addr_gens.items():
        if not gens:
            continue
        ag = dag.add("addrgen", 20, users={dfn}, tensor=tensor,
                     n_nodes=len(gens))
        dag.wire(ctrl, ag, bits=16)
        # distribute address to that tensor's memports (broadcast — rewired
        # into a forwarding chain by the backend pass when c != 0)
        for n in dag.nodes.values():
            if (n.kind == "memport" and n.meta.get("tensor") == tensor
                    and dfn in dag.users[n.id]):
                dag.wire(ag, n.id, bits=20, addr=True)

    # provenance for the netlist back end (emit/rtlsim)
    dag.opnd_ports = dict(in_port)
    dag.fu_product = dict(fu_mul)
    return dag

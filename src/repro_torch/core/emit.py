"""Structural Verilog emission — the synthesizable back end of the pipeline
(paper §V: primitive graph → RTL; replaces the paper's SpinalHDL generator).

The optimized :class:`~repro_torch.core.dag.DAG` is lowered to a small netlist IR
(:class:`Netlist`) and rendered as plain structural Verilog:

* one ``lego_*`` primitive-library module per primitive kind/arity actually
  used (multiplier, adder, accumulator, muxes, reducers, programmable-depth
  FIFO, skew register, shift chain, address generator, memory ports);
* a **datapath** module: one instance per DAG node with *named* ports from
  :data:`_PRIM_PORTS`, one wire per DAG edge, and every delay-matching
  result (``edge.el``) materialized as an explicit ``lego_shift`` chain —
  no ``pipe(...)`` pseudo-calls, no positional ``.inN`` connections;
* one **control** module per dataflow spec (``<design>_ctrl_<df>``): the
  dataflow's address generators plus its mux-select and FIFO-depth
  configuration words (the §III-D "switching dataflows only rewrites matrix
  values" property — selects and depths come from the ADG).  Multi-
  *workload* designs (score-stationary fused attention) add a third word:
  ``wl_o``, the **workload-select field** — the index of the workload this
  dataflow executes, driving the FU operand-network muxes that switch the
  multipliers between e.g. the (Q, K) and (P, V) operand planes;
* a **top level** with the runtime-switch mux fabric: ``df_sel`` picks which
  control module's select/config/address/workload words drive the shared
  datapath.

:func:`build_netlist` is deterministic in the DAG (stable node/edge order,
no timestamps), so emission is snapshot-testable; :mod:`repro_torch.core.rtlsim`
executes the same select/config tables cycle-by-cycle and is cross-checked
bit-exactly against the :mod:`repro_torch.core.funcsim` oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .dag import DAG

__all__ = [
    "Netlist", "VModule", "Instance", "build_netlist", "emit_netlist",
    "mux_select", "fifo_depth_for", "fifo_programmed_delay", "anchored_sched",
]

# Named input ports per primitive (the paper's primitive library, Fig. 7b).
# ``None`` marks variadic primitives (``d0 .. d{k-1}``); muxes add ``sel``.
_PRIM_PORTS = {
    "mul": ("a", "b"), "add": ("a", "b"), "acc": ("d",), "mux": None,
    "reduce": None, "fifo": ("d",), "reg": ("d",), "wire": ("d",),
    "shift": ("d",), "memport": ("addr", "d"), "addrgen": ("t",),
    "counter": (), "lut": ("x",), "input": ("d",), "output": ("d",),
    "const": (),
}

# Output port name per primitive (default "y").
_PRIM_OUT = {
    "acc": "q", "fifo": "q", "reg": "q", "shift": "q", "memport": "q",
    "addrgen": "addr", "counter": "t", "lut": "q",
}


def _out_port(kind: str) -> str:
    return _PRIM_OUT.get(kind, "y")


def _clog2(n: int) -> int:
    return max(1, (max(n, 1) - 1).bit_length())


def _ident(s: str) -> str:
    out = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in s)
    return out if out and not out[0].isdigit() else f"_{out}"


def _edge_live(dag: DAG, e) -> set[str]:
    """Dataflows an edge carries data for (drives the runtime mux select)."""
    live = e.meta.get("live")
    if live is not None:
        return set(live)
    users = dag.users.get(e.src, set())
    return {u.split("#")[0] for u in users}


def _edge_wl_gate(dag: DAG, e) -> list[int] | None:
    """Workload indices an edge is exclusively live for, or ``None`` when it
    serves every workload.  Drives the emitted psum gating: an input of the
    shared adder plane that belongs to one workload's reduction network must
    contribute zero while another workload runs — the netlist realizes the
    same deselection :func:`repro_torch.core.rtlsim._edge_active` applies in
    simulation, so external simulators see identical semantics."""
    live = e.meta.get("live")
    if not live or len(dag.workloads) < 2:
        return None
    wls = {dag.df_workload.get(u.split("#")[0]) for u in live} - {None}
    if not wls or wls == set(dag.workloads):
        return None
    idxs = sorted(dag.workloads.index(w) for w in wls
                  if w in dag.workloads)
    return idxs or None


def _wl_mux_aligned(dag: DAG, edges) -> bool:
    """True when a codegen workload mux has exactly one input per workload,
    in ``dag.workloads`` order — then its select value *is* the workload
    index and the shared ``wl_sel`` word can drive it directly."""
    wls = dag.workloads
    if len(wls) < 2 or len(edges) != len(wls):
        return False
    for i, e in enumerate(edges):
        live = e.meta.get("live")
        if not live:
            return False
        got = {dag.df_workload.get(u.split("#")[0]) for u in live}
        if got != {wls[i]}:
            return False
    return True


def mux_select(dag: DAG, nid: int, df_name: str,
               edges=None) -> int:
    """Select value of a mux under ``df_name``: the first input edge live for
    that dataflow (data-node memports precede links in codegen order, which
    matches the funcsim feeder priority).  Defaults to input 0."""
    edges = dag.in_edges(nid) if edges is None else edges
    for i, e in enumerate(edges):
        if df_name in _edge_live(dag, e):
            return i
    return 0


def fifo_depth_for(meta: dict, df_name: str) -> int | None:
    """Runtime-programmed FIFO depth for ``df_name`` from the ADG link plan
    (``None`` when the FIFO is idle under that dataflow)."""
    depths = meta.get("depths") or {}
    if df_name in depths:
        return int(depths[df_name])
    if df_name + "#delay" in depths:
        return int(depths[df_name + "#delay"])
    return None


def fifo_programmed_delay(dag: DAG, nid: int, df_name: str,
                          anchored: dict[int, float] | None = None
                          ) -> int | None:
    """The depth word the control module programs into FIFO ``nid`` under
    ``df_name``: the *schedule-consistent* physical delay
    ``p = (D[consumer] − L_consumer − EL) − D[src] + d_local`` derived from
    the delay-matching potentials ``dag.sched``.  The LP's FIFO-
    realizability rows keep ``0 ≤ p ≤ CAP``; rtlsim re-derives the same
    value from the netlist structure and cross-checks it, so the emitted
    cfg word and the simulated delay cannot diverge.  Falls back to the raw
    ADG depth when the DAG carries no potentials (hand-built DAGs); returns
    ``None`` when the FIFO is idle under ``df_name``.

    Elastic nodes take no part in the LP, so their own potentials are
    arbitrary.  A FIFO's arrival time is therefore anchored the way the
    hardware fixes it (:func:`anchored_sched`): from its first non-elastic
    consumer, and a FIFO fed by another FIFO measures its delay from that
    FIFO's anchored time.  Reading the raw potential of a FIFO consumer or
    source instead gave a word 2 cycles off the netlist's own schedule on a
    2x2 conv OH-OW array whose FIFOs feed each other.  Callers asking for
    many FIFOs pass ``anchored=anchored_sched(dag)`` once."""
    node = dag.nodes[nid]
    word = fifo_depth_for(node.meta, df_name)
    if word is None:
        return None
    d_local = node.meta.get("d_local", {}).get(df_name)
    ins = dag.in_edges(nid)
    outs = dag.out_edges(nid)
    if d_local is None or not dag.sched or not ins or not outs:
        return word
    u = ins[0].src
    if u not in dag.sched or not any(e.dst in dag.sched for e in outs):
        return word
    A = anchored_sched(dag) if anchored is None else anchored
    return int(round(A[nid] - A[u])) + int(d_local)


def anchored_sched(dag: DAG) -> dict[int, float]:
    """``dag.sched`` with every elastic node re-anchored as the netlist
    schedule anchors it: ``A[fifo] = A[c] − L_c − EL`` through the first
    out-edge whose consumer is non-elastic or already anchored (nodes in id
    order), else the time of its first source, else 0."""
    A = {nid: v for nid, v in dag.sched.items()
         if not dag.nodes[nid].elastic}
    outs: dict[int, list] = {}
    ins: dict[int, list] = {}
    for e in dag.edges:
        outs.setdefault(e.src, []).append(e)
        ins.setdefault(e.dst, []).append(e)
    for nid in sorted(dag.nodes):
        if not dag.nodes[nid].elastic:
            continue
        cons = [e for e in outs.get(nid, ()) if e.dst in A]
        if cons:
            e = cons[0]
            A[nid] = A[e.dst] - dag.nodes[e.dst].latency - e.el
        else:
            src = ins.get(nid, ())
            A[nid] = A[src[0].src] if src and src[0].src in A else 0.0
    return A


# ---------------------------------------------------------------------------
# netlist IR
# ---------------------------------------------------------------------------

@dataclass
class Instance:
    name: str
    module: str
    params: list  # [(param, value_str)]
    conns: list   # [(port, expr)]
    comment: str = ""


@dataclass
class VModule:
    name: str
    ports: list = field(default_factory=list)   # [(dir, width, name)]
    wires: list = field(default_factory=list)   # [(width, name)]
    localparams: list = field(default_factory=list)  # [(name, expr)]
    assigns: list = field(default_factory=list)      # [(lhs, rhs)]
    instances: list = field(default_factory=list)
    comments: list = field(default_factory=list)

    def verilog(self) -> list[str]:
        def decl(width: int, name: str, kind: str) -> str:
            rng = f" [{max(width, 1) - 1}:0]" if width > 1 else ""
            return f"{kind}{rng} {name}"

        lines = [f"module {self.name} ("]
        lines += [f"  {decl(w, n, d)}{',' if i < len(self.ports) - 1 else ''}"
                  for i, (d, w, n) in enumerate(self.ports)]
        lines.append(");")
        for c in self.comments:
            lines.append(f"  // {c}")
        for name, expr in self.localparams:
            lines.append(f"  localparam {name} = {expr};")
        for w, n in self.wires:
            lines.append(f"  {decl(w, n, 'wire')};")
        for lhs, rhs in self.assigns:
            lines.append(f"  assign {lhs} = {rhs};")
        for inst in self.instances:
            p = ""
            if inst.params:
                p = " #(" + ", ".join(f".{k}({v})" for k, v in inst.params) + ")"
            conns = ", ".join(f".{k}({v})" for k, v in inst.conns)
            tail = f"  // {inst.comment}" if inst.comment else ""
            lines.append(f"  {inst.module}{p} {inst.name} ({conns});{tail}")
        lines.append("endmodule")
        return lines


@dataclass
class Netlist:
    name: str
    modules: list          # list[VModule], library first, top last
    n_dataflows: int

    @property
    def top(self) -> VModule:
        return self.modules[-1]

    def stats(self, text: str | None = None) -> dict:
        """Netlist size summary; pass an already-rendered ``verilog()`` text
        to avoid rendering twice."""
        inst = sum(len(m.instances) for m in self.modules)
        text = self.verilog() if text is None else text
        return {"modules": len(self.modules), "instances": inst,
                "lines": len(text.splitlines())}

    def verilog(self) -> str:
        # the banner names the reference's emitter, as the reference's does,
        # so the two texts compare byte for byte
        lines = [f"// generated by repro.core.emit — design '{self.name}'",
                 f"// modules: {len(self.modules)}  dataflows: "
                 f"{self.n_dataflows}"]
        for m in self.modules:
            lines.append("")
            lines += m.verilog()
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# primitive library
# ---------------------------------------------------------------------------

def _lib_module(kind: str, arity: int = 0) -> VModule:
    if kind == "shift" or kind == "reg":
        name = f"lego_{kind}"
        body = [
            "  reg [W-1:0] taps [0:DEPTH-1];",
            "  integer k;",
            "  always @(posedge clk) begin",
            "    if (rst) for (k = 0; k < DEPTH; k = k + 1) "
            "taps[k] <= {W{1'b0}};",
            "    else begin",
            "      taps[0] <= d;",
            "      for (k = 1; k < DEPTH; k = k + 1) taps[k] <= taps[k-1];",
            "    end",
            "  end",
            "  assign q = taps[DEPTH-1];",
        ]
        return _raw(name, "#(parameter W = 16, DEPTH = 1)",
                    "(input clk, input rst, input [W-1:0] d, "
                    "output [W-1:0] q)", body)
    if kind == "mul":
        return _raw("lego_mul", "#(parameter W = 16)",
                    "(input clk, input rst, input [W-1:0] a, "
                    "input [W-1:0] b, output reg [W-1:0] y)",
                    ["  always @(posedge clk) y <= rst ? {W{1'b0}} : a * b;"])
    if kind == "add":
        return _raw("lego_add", "#(parameter W = 16)",
                    "(input clk, input rst, input [W-1:0] a, "
                    "input [W-1:0] b, output reg [W-1:0] y)",
                    ["  always @(posedge clk) y <= rst ? {W{1'b0}} : a + b;"])
    if kind == "acc":
        return _raw("lego_acc", "#(parameter W = 32)",
                    "(input clk, input rst, input en, input clr, "
                    "input [W-1:0] d, output reg [W-1:0] q)",
                    ["  always @(posedge clk)",
                     "    if (rst || clr) q <= {W{1'b0}};",
                     "    else if (en) q <= q + d;"])
    if kind == "mux":
        ports = ", ".join(f"input [W-1:0] d{i}" for i in range(arity))
        sel_w = _clog2(arity)
        cases = [f"      {sel_w}'d{i}: y = d{i};" for i in range(arity - 1)]
        return _raw(f"lego_mux{arity}", "#(parameter W = 16)",
                    f"({ports}, input [{sel_w - 1}:0] sel, "
                    "output reg [W-1:0] y)",
                    ["  always @(*)",
                     "    case (sel)", *cases,
                     f"      default: y = d{arity - 1};",
                     "    endcase"])
    if kind == "reduce":
        ports = ", ".join(f"input [W-1:0] d{i}" for i in range(arity))
        depth = max(1, (arity - 1).bit_length())  # balanced-tree latency
        total = " + ".join(f"d{i}" for i in range(arity))
        body = ["  // balanced adder tree, registered once per tree level",
                f"  reg [W-1:0] pipe_r [0:{depth - 1}];",
                "  integer k;",
                "  always @(posedge clk) begin",
                f"    pipe_r[0] <= rst ? {{W{{1'b0}}}} : {total};",
                f"    for (k = 1; k < {depth}; k = k + 1) "
                "pipe_r[k] <= pipe_r[k-1];",
                "  end",
                f"  assign y = pipe_r[{depth - 1}];"]
        return _raw(f"lego_reduce{arity}", "#(parameter W = 32)",
                    f"({ports}, input clk, input rst, output [W-1:0] y)",
                    body)
    if kind == "fifo":
        return _raw("lego_fifo", "#(parameter W = 16, CAP = 4)",
                    "(input clk, input rst, input [15:0] depth, "
                    "input [W-1:0] d, output [W-1:0] q)",
                    ["  // elastic link: runtime-programmable delay (§II)",
                     "  reg [W-1:0] taps [0:CAP-1];",
                     "  integer k;",
                     "  always @(posedge clk) begin",
                     "    if (rst) for (k = 0; k < CAP; k = k + 1) "
                     "taps[k] <= {W{1'b0}};",
                     "    else begin",
                     "      taps[0] <= d;",
                     "      for (k = 1; k < CAP; k = k + 1) "
                     "taps[k] <= taps[k-1];",
                     "    end",
                     "  end",
                     "  assign q = (depth == 0) ? d : taps[depth-1];"])
    if kind == "counter":
        return _raw("lego_counter", "#(parameter W = 16)",
                    "(input clk, input rst, output reg [W-1:0] t)",
                    ["  always @(posedge clk) t <= rst ? {W{1'b0}} : "
                     "t + {{(W-1){1'b0}}, 1'b1};"])
    if kind == "addrgen":
        return _raw("lego_addrgen", "#(parameter W = 20, TW = 16)",
                    "(input clk, input rst, input [TW-1:0] t, "
                    "output reg [W-1:0] addr)",
                    ["  // affine addr = L@t + base; L/base are dataflow-"
                     "programmed matrix words (§IV-D),",
                     "  // modeled behaviorally as a registered timestamp "
                     "pass-through here",
                     "  always @(posedge clk) addr <= rst ? {W{1'b0}} : "
                     "{{(W-TW){1'b0}}, t};"])
    if kind == "memport_rd":
        return _raw("lego_memport_rd", "#(parameter W = 16, AW = 20)",
                    "(input clk, input rst, input [AW-1:0] addr, "
                    "input [W-1:0] rdata, output reg [W-1:0] q, "
                    "output [AW-1:0] mem_addr)",
                    ["  assign mem_addr = addr;",
                     "  always @(posedge clk) q <= rst ? {W{1'b0}} : rdata;"])
    if kind == "memport_wr":
        return _raw("lego_memport_wr", "#(parameter W = 32, AW = 20)",
                    "(input clk, input rst, input [AW-1:0] addr, "
                    "input [W-1:0] d, output reg [W-1:0] wdata, "
                    "output [AW-1:0] mem_addr)",
                    ["  assign mem_addr = addr;",
                     "  always @(posedge clk) wdata <= rst ? {W{1'b0}} : d;"])
    if kind == "lut":
        return _raw("lego_lut", "#(parameter W = 16)",
                    "(input clk, input rst, input [W-1:0] x, "
                    "output reg [W-1:0] q)",
                    ["  // user-defined FU lookup (identity placeholder)",
                     "  always @(posedge clk) q <= rst ? {W{1'b0}} : x;"])
    if kind == "wire":
        return _raw("lego_wire", "#(parameter W = 16)",
                    "(input [W-1:0] d, output [W-1:0] y)",
                    ["  assign y = d;"])
    if kind == "const":
        return _raw("lego_const", "#(parameter W = 16, VALUE = 0)",
                    "(output [W-1:0] y)",
                    ["  assign y = VALUE[W-1:0];"])
    raise KeyError(kind)


class _RawModule(VModule):
    """Library module with a fixed body (keeps the IR dataclass simple)."""

    def __init__(self, name, params, portlist, body):
        super().__init__(name)
        self._params = params
        self._portlist = portlist
        self._body = body

    def verilog(self) -> list[str]:
        head = f"module {self.name} {self._params} {self._portlist};"
        return [head, *self._body, "endmodule"]


def _raw(name, params, portlist, body) -> _RawModule:
    return _RawModule(name, params, portlist, body)


# ---------------------------------------------------------------------------
# DAG → netlist
# ---------------------------------------------------------------------------

def _split_edges(edges) -> tuple[list, list]:
    """(addr_edges, value_edges) of a node's in-edges, stable order."""
    addr, val = [], []
    for e in edges:
        (addr if e.meta.get("addr") else val).append(e)
    return addr, val


def build_netlist(dag: DAG, name: str | None = None) -> Netlist:
    name = _ident(name or dag.name)
    dataflows = list(dag.dataflows)
    node_ids = sorted(dag.nodes)
    in_map = dag.in_edge_map()

    # -- select / config tables (shared with rtlsim) -----------------------
    # mux slots: DAG muxes + address-fabric muxes at multi-addressed
    # memports.  Workload muxes — the FU operand-network switches of a
    # multi-workload design whose inputs align one-per-workload — are
    # driven by the shared workload-select word ``wl_sel`` instead of a
    # packed per-mux slice (their select value IS the workload index).
    wl_width = _clog2(max(len(dag.workloads), 2)) \
        if len(dag.workloads) > 1 else 0
    wl_muxes: set[int] = set()
    mux_slots: list[tuple[str, int, int]] = []  # (kind, nid, ways)
    for nid in node_ids:
        n = dag.nodes[nid]
        if n.kind == "mux" and len(in_map[nid]) > 1:
            if n.meta.get("wl_mux") and _wl_mux_aligned(dag, in_map[nid]):
                wl_muxes.add(nid)
            else:
                mux_slots.append(("mux", nid, len(in_map[nid])))
        elif n.kind == "memport" and len(_split_edges(in_map[nid])[0]) > 1:
            mux_slots.append(("addr", nid, len(_split_edges(in_map[nid])[0])))
    # wl_sel is also needed when the shared adder plane has per-workload
    # reduction inputs to gate, even if every operand mux happens to align
    needs_wl = bool(wl_muxes)
    if wl_width and not needs_wl:
        needs_wl = any(
            _edge_wl_gate(dag, e) is not None
            for nid in node_ids
            if dag.nodes[nid].kind in ("add", "reduce", "acc")
            for e in in_map[nid])
    if not needs_wl:
        wl_width = 0
    sel_slice: dict[int, tuple[int, int]] = {}  # nid -> (lo, width)
    sel_width = 0
    for _, nid, ways in mux_slots:
        w = _clog2(ways)
        sel_slice[nid] = (sel_width, w)
        sel_width += w

    fifo_ids = [nid for nid in node_ids if dag.nodes[nid].kind == "fifo"]
    anchored = anchored_sched(dag) if fifo_ids and dag.sched else None
    cfg_slice = {nid: (16 * i, 16) for i, nid in enumerate(fifo_ids)}
    cfg_width = 16 * len(fifo_ids)

    # -- node placement ----------------------------------------------------
    # per-dataflow addrgens live in the control modules; the counter in top
    ctrl_nodes: dict[str, list[int]] = {d: [] for d in dataflows}
    counter_ids = []
    dp_nodes = []
    for nid in node_ids:
        n = dag.nodes[nid]
        users = sorted(dag.users.get(nid, set()))
        if n.kind == "counter":
            counter_ids.append(nid)
        elif n.kind == "addrgen" and len(users) == 1 and users[0] in ctrl_nodes:
            ctrl_nodes[users[0]].append(nid)
        else:
            dp_nodes.append(nid)

    lib_kinds: set[tuple[str, int]] = set()

    def net(nid: int) -> str:
        return f"n{nid}"

    # -- datapath ----------------------------------------------------------
    dp = VModule(f"{name}_dp")
    dp.comments.append("shared datapath: one instance per primitive, one "
                       "wire per edge; lego_shift chains materialize the "
                       "delay-matching registers (EL)")
    dp.ports.append(("input", 1, "clk"))
    dp.ports.append(("input", 1, "rst"))
    if sel_width:
        dp.ports.append(("input", sel_width, "sel"))
    if wl_width:
        dp.ports.append(("input", wl_width, "wl_sel"))
    if cfg_width:
        dp.ports.append(("input", cfg_width, "fifo_cfg"))
    ext_ports: list[tuple[str, int, str]] = []  # bubbled up to top verbatim

    def shifted(e, ctx: VModule, label: str, src: str | None = None) -> str:
        """Source expression of an edge, through its EL shift chain.

        ``src`` overrides the source expression when the edge's source is a
        module port rather than a local net (ctrl-module timestamps)."""
        src = net(e.src) if src is None else src
        if e.el <= 0:
            return src
        out = f"{src}_el{e.el}_{label}"
        ctx.wires.append((e.bits, out))
        lib_kinds.add(("shift", 0))
        ctx.instances.append(Instance(
            f"u_sh_{label}", "lego_shift",
            [("W", str(max(e.bits, 1))), ("DEPTH", str(e.el))],
            [("clk", "clk"), ("rst", "rst"), ("d", src), ("q", out)],
            comment=f"EL={e.el} pipeline regs, edge {e.src}->{e.dst}"))
        return out

    def zero(bits: int) -> str:
        return f"{{{max(bits, 1)}{{1'b0}}}}"

    for nid in dp_nodes:
        n = dag.nodes[nid]
        dp.wires.append((n.bits, net(nid)))

    def wl_gated(e, expr: str, label: str) -> str:
        """Zero a summing-node input while its workload is not selected —
        the netlist-side counterpart of rtlsim's liveness filtering."""
        idxs = _edge_wl_gate(dag, e) if wl_width else None
        if idxs is None:
            return expr
        out = f"wg_{label}"
        dp.wires.append((e.bits, out))
        cond = " || ".join(f"(wl_sel == {wl_width}'d{i})" for i in idxs)
        dp.assigns.append((out, f"({cond}) ? {expr} : {zero(e.bits)}"))
        return out

    for nid in dp_nodes:
        n = dag.nodes[nid]
        kind = n.kind
        addr_edges, val_edges = _split_edges(in_map[nid])
        ins = [shifted(e, dp, f"{e.src}_{nid}_{i}")
               for i, e in enumerate(val_edges)]
        if kind in ("add", "reduce", "acc"):
            ins = [wl_gated(e, s, f"{e.src}_{nid}_{i}")
                   for i, (e, s) in enumerate(zip(val_edges, ins))]
        W = [("W", str(max(n.bits, 1)))]
        clkrst = [("clk", "clk"), ("rst", "rst")]
        meta = ", ".join(f"{k}={v}" for k, v in sorted(n.meta.items())
                         if isinstance(v, (int, float, str, bool)))
        gated = "clock-enable (power-gated); " if n.meta.get("gated") else ""
        comment = f"{gated}{meta}" if (gated or meta) else ""

        def addr_expr() -> str:
            if not addr_edges:
                return zero(20)
            srcs = [shifted(e, dp, f"{e.src}_{nid}_a{i}")
                    for i, e in enumerate(addr_edges)]
            if len(srcs) == 1:
                return srcs[0]
            # runtime dataflow switch: fabric mux over per-dataflow addrgens
            ways = len(srcs)
            lib_kinds.add(("mux", ways))
            lo, w = sel_slice[nid]
            out = f"{net(nid)}_addr"
            dp.wires.append((addr_edges[0].bits, out))
            conns = [(f"d{i}", s) for i, s in enumerate(srcs)]
            conns += [("sel", f"sel[{lo + w - 1}:{lo}]"), ("y", out)]
            dp.instances.append(Instance(
                f"u{nid}_asel", f"lego_mux{ways}",
                [("W", str(max(addr_edges[0].bits, 1)))], conns,
                comment="addr fabric: df_sel-driven"))
            return out

        if kind in ("mul", "add") and len(ins) <= 2:
            lib_kinds.add((kind, 0))
            pa, pb = _PRIM_PORTS[kind]
            a = ins[0] if ins else zero(n.bits)
            b = ins[1] if len(ins) > 1 else zero(n.bits)
            dp.instances.append(Instance(
                f"u{nid}", f"lego_{kind}", W,
                clkrst + [(pa, a), (pb, b), (_out_port(kind), net(nid))],
                comment))
        elif kind in ("add", "reduce"):  # variadic sum
            ways = max(len(ins), 2)
            while len(ins) < ways:
                ins.append(zero(n.bits))
            lib_kinds.add(("reduce", ways))
            conns = [(f"d{i}", s) for i, s in enumerate(ins)]
            dp.instances.append(Instance(
                f"u{nid}", f"lego_reduce{ways}", W,
                conns + clkrst + [("y", net(nid))], comment))
        elif kind == "mux":
            if len(ins) == 1:
                lib_kinds.add(("wire", 0))
                dp.instances.append(Instance(
                    f"u{nid}", "lego_wire", W,
                    [("d", ins[0]), ("y", net(nid))], comment))
            else:
                ways = len(ins)
                lib_kinds.add(("mux", ways))
                conns = [(f"d{i}", s) for i, s in enumerate(ins)]
                if nid in wl_muxes:
                    # operand-network switch: the workload-select field
                    # drives it directly (select value == workload index)
                    sel_expr = "wl_sel"
                else:
                    lo, w = sel_slice[nid]
                    sel_expr = f"sel[{lo + w - 1}:{lo}]"
                conns += [("sel", sel_expr), ("y", net(nid))]
                dp.instances.append(Instance(
                    f"u{nid}", f"lego_mux{ways}", W, conns, comment))
        elif kind == "acc":
            lib_kinds.add(("acc", 0))
            (pd,) = _PRIM_PORTS["acc"]
            d = ins[0] if ins else zero(n.bits)
            dp.instances.append(Instance(
                f"u{nid}", "lego_acc", W,
                clkrst + [("en", "1'b1"), ("clr", "1'b0"), (pd, d),
                          (_out_port(kind), net(nid))], comment))
        elif kind in ("reg", "shift"):
            lib_kinds.add(("shift" if kind == "shift" else "reg", 0))
            (pd,) = _PRIM_PORTS[kind]
            d = ins[0] if ins else zero(n.bits)
            depth = max(1, int(n.meta.get("depth", 1)))
            dp.instances.append(Instance(
                f"u{nid}", f"lego_{kind}",
                W + [("DEPTH", str(depth))],
                clkrst + [(pd, d), (_out_port(kind), net(nid))], comment))
        elif kind == "fifo":
            lib_kinds.add(("fifo", 0))
            (pd,) = _PRIM_PORTS["fifo"]
            d = ins[0] if ins else zero(n.bits)
            cap = max(1, int(n.meta.get("depth", 1)))
            lo, w = cfg_slice[nid]
            dp.instances.append(Instance(
                f"u{nid}", "lego_fifo",
                W + [("CAP", str(cap))],
                clkrst + [("depth", f"fifo_cfg[{lo + 15}:{lo}]"),
                          (pd, d), (_out_port(kind), net(nid))], comment))
        elif kind == "memport":
            direction = n.meta.get("direction", "read")
            tensor = _ident(str(n.meta.get("tensor", f"mp{nid}"))).lower()
            fu = n.meta.get("fu", nid)
            paddr, pd = _PRIM_PORTS["memport"]
            if direction == "read":
                lib_kinds.add(("memport_rd", 0))
                rport = f"{tensor}_rd{nid}_f{fu}_data"
                aport = f"{tensor}_rd{nid}_f{fu}_addr"
                ext_ports.append(("input", n.bits, rport))
                ext_ports.append(("output", 20, aport))
                dp.instances.append(Instance(
                    f"u{nid}", "lego_memport_rd",
                    W + [("AW", "20")],
                    clkrst + [(paddr, addr_expr()), ("rdata", rport),
                              (_out_port(kind), net(nid)),
                              ("mem_addr", aport)], comment))
            else:
                lib_kinds.add(("memport_wr", 0))
                wport = f"{tensor}_wr{nid}_f{fu}_data"
                aport = f"{tensor}_wr{nid}_f{fu}_addr"
                ext_ports.append(("output", n.bits, wport))
                ext_ports.append(("output", 20, aport))
                d = ins[0] if ins else zero(n.bits)
                dp.instances.append(Instance(
                    f"u{nid}", "lego_memport_wr",
                    W + [("AW", "20")],
                    clkrst + [(paddr, addr_expr()), (pd, d),
                              ("wdata", wport), ("mem_addr", aport)],
                    comment))
                # internal q net unused for write ports
                dp.assigns.append((net(nid), d))
        elif kind == "addrgen":
            # shared addrgen used by several dataflows stays in the datapath
            lib_kinds.add(("addrgen", 0))
            (pt,) = _PRIM_PORTS["addrgen"]
            t = ins[0] if ins else zero(16)
            dp.instances.append(Instance(
                f"u{nid}", "lego_addrgen",
                W + [("TW", "16")],
                clkrst + [(pt, t), (_out_port(kind), net(nid))], comment))
        elif kind == "lut":
            lib_kinds.add(("lut", 0))
            (px,) = _PRIM_PORTS["lut"]
            x = ins[0] if ins else zero(n.bits)
            dp.instances.append(Instance(
                f"u{nid}", "lego_lut", W,
                clkrst + [(px, x), (_out_port(kind), net(nid))], comment))
        elif kind == "const":
            lib_kinds.add(("const", 0))
            dp.instances.append(Instance(
                f"u{nid}", "lego_const",
                W + [("VALUE", str(int(n.meta.get("value", 0))))],
                [("y", net(nid))], comment))
        elif kind == "input":
            port = f"din{nid}"  # not in<nid>: .inN would read as positional
            ext_ports.append(("input", n.bits, port))
            dp.assigns.append((net(nid), port))
        elif kind == "output":
            port = f"dout{nid}"
            ext_ports.append(("output", n.bits, port))
            d = ins[0] if ins else zero(n.bits)
            dp.assigns.append((net(nid), d))
            dp.assigns.append((port, net(nid)))
        else:  # wire / forward taps
            lib_kinds.add(("wire", 0))
            (pd,) = _PRIM_PORTS["wire"]
            d = ins[0] if ins else zero(n.bits)
            dp.instances.append(Instance(
                f"u{nid}", "lego_wire", W,
                [(pd, d), (_out_port("wire"), net(nid))], comment))

    # addr nets produced by control-module addrgens enter as ports
    for df in dataflows:
        for nid in ctrl_nodes[df]:
            dp.ports.append(("input", dag.nodes[nid].bits, net(nid)))
    for nid in counter_ids:
        dp.ports.append(("input", dag.nodes[nid].bits, net(nid)))
    dp.ports += ext_ports

    # -- control module per dataflow spec ----------------------------------
    ctrl_mods = []
    for df in dataflows:
        cm = VModule(f"{name}_ctrl_{_ident(df)}")
        cm.comments.append(f"dataflow '{df}': address generators + "
                           "select/FIFO-depth configuration words")
        cm.ports = [("input", 1, "clk"), ("input", 1, "rst"),
                    ("input", 16, "t")]
        for nid in ctrl_nodes[df]:
            n = dag.nodes[nid]
            cm.ports.append(("output", n.bits, net(nid)))
            e = in_map[nid]
            t_expr = "t"
            if e and e[0].el > 0:
                # the counter arrives on the module's t port, not a local net
                t_expr = shifted(e[0], cm, f"{e[0].src}_{nid}_t", src="t")
            lib_kinds.add(("addrgen", 0))
            meta = ", ".join(f"{k}={v}" for k, v in sorted(n.meta.items())
                             if isinstance(v, (int, float, str, bool)))
            cm.instances.append(Instance(
                f"u{nid}", "lego_addrgen",
                [("W", str(max(n.bits, 1))), ("TW", "16")],
                [("clk", "clk"), ("rst", "rst"), ("t", t_expr),
                 ("addr", net(nid))], meta))
        if sel_width:
            cm.ports.append(("output", sel_width, "sel_o"))
            parts = []
            for _, nid, ways in reversed(mux_slots):
                lo, w = sel_slice[nid]
                if dag.nodes[nid].kind == "memport":
                    v = mux_select(dag, nid, df,
                                   edges=_split_edges(in_map[nid])[0])
                else:
                    v = mux_select(dag, nid, df, edges=in_map[nid])
                parts.append(f"{w}'d{v}")
            cm.assigns.append(("sel_o", "{" + ", ".join(parts) + "}"))
        if wl_width:
            # workload-select field: which workload's operand plane this
            # dataflow drives through the FU input muxes
            cm.ports.append(("output", wl_width, "wl_o"))
            widx = dag.workloads.index(dag.df_workload[df])
            cm.assigns.append(("wl_o", f"{wl_width}'d{widx}"))
        if cfg_width:
            cm.ports.append(("output", cfg_width, "cfg_o"))
            parts = []
            for nid in reversed(fifo_ids):
                d = fifo_programmed_delay(dag, nid, df, anchored)
                if d is None:  # idle under this dataflow: park at capacity
                    d = max(1, int(dag.nodes[nid].meta.get("depth", 1)))
                parts.append(f"16'd{d}")
            cm.assigns.append(("cfg_o", "{" + ", ".join(parts) + "}"))
        ctrl_mods.append(cm)

    # -- top: runtime-switch mux fabric ------------------------------------
    top = VModule(name)
    top.comments.append("top level: df_sel switches which dataflow's control "
                        "words drive the shared datapath")
    top.ports = [("input", 1, "clk"), ("input", 1, "rst")]
    n_df = len(dataflows)
    if n_df:
        top.ports.append(("input", _clog2(max(n_df, 2)), "df_sel"))
    top.ports += ext_ports

    for nid in counter_ids:
        n = dag.nodes[nid]
        lib_kinds.add(("counter", 0))
        top.wires.append((n.bits, net(nid)))
        top.instances.append(Instance(
            f"u{nid}", "lego_counter", [("W", str(max(n.bits, 1)))],
            [("clk", "clk"), ("rst", "rst"), ("t", net(nid))],
            "shared timestamp (§III-D: one control path for the array)"))
    t_net = net(counter_ids[0]) if counter_ids else "16'd0"

    for df, cm in zip(dataflows, ctrl_mods):
        sfx = _ident(df)
        conns = [("clk", "clk"), ("rst", "rst"), ("t", t_net)]
        for nid in ctrl_nodes[df]:
            w = dag.nodes[nid].bits
            top.wires.append((w, net(nid)))
            conns.append((net(nid), net(nid)))
        if sel_width:
            top.wires.append((sel_width, f"sel_{sfx}"))
            conns.append(("sel_o", f"sel_{sfx}"))
        if wl_width:
            top.wires.append((wl_width, f"wl_{sfx}"))
            conns.append(("wl_o", f"wl_{sfx}"))
        if cfg_width:
            top.wires.append((cfg_width, f"cfg_{sfx}"))
            conns.append(("cfg_o", f"cfg_{sfx}"))
        top.instances.append(Instance(f"u_ctrl_{sfx}", cm.name, [], conns))

    def fabric(width: int, stem: str) -> str | None:
        """df_sel-indexed mux over the per-dataflow control words."""
        if not width or not n_df:
            return None
        out = f"{stem}_active"
        top.wires.append((width, out))
        terms = [f"{stem}_{_ident(d)}" for d in dataflows]
        expr = terms[-1]
        for i in range(n_df - 2, -1, -1):
            expr = (f"(df_sel == {_clog2(max(n_df, 2))}'d{i}) ? "
                    f"{terms[i]} : {expr}")
        top.assigns.append((out, expr))
        return out

    sel_active = fabric(sel_width, "sel")
    wl_active = fabric(wl_width, "wl")
    cfg_active = fabric(cfg_width, "cfg")

    dconns = [("clk", "clk"), ("rst", "rst")]
    if sel_width:
        dconns.append(("sel", sel_active or f"{sel_width}'d0"))
    if wl_width:
        dconns.append(("wl_sel", wl_active or f"{wl_width}'d0"))
    if cfg_width:
        dconns.append(("fifo_cfg", cfg_active or f"{cfg_width}'d0"))
    for df in dataflows:
        for nid in ctrl_nodes[df]:
            dconns.append((net(nid), net(nid)))
    for nid in counter_ids:
        dconns.append((net(nid), net(nid)))
    dconns += [(p, p) for _, _, p in ext_ports]
    top.instances.append(Instance("u_dp", dp.name, [], dconns))

    # -- assemble ----------------------------------------------------------
    lib = [_lib_module(k, a) for k, a in sorted(lib_kinds)]
    return Netlist(name, [*lib, dp, *ctrl_mods, top], n_df)


def emit_netlist(dag: DAG, name: str | None = None) -> str:
    """Structural Verilog for a delay-matched DAG (deterministic text)."""
    return build_netlist(dag, name).verilog()

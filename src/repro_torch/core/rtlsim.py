"""Cycle-accurate netlist-level simulation of the emitted DAG, on the device
its input tensors lie on: the twin of the reference's ``repro.core.rtlsim``.

Where :mod:`repro_torch.core.funcsim` simulates the *FU-level* ADG
semantics, this module executes the *primitive-level* netlist the back end
emits (:mod:`repro_torch.core.emit`): every DAG node steps with its hardware
latency, every delay-matching register chain (``edge.el``) delays its wire,
skew registers and FIFOs delay forwarded operands, and runtime mux selects /
FIFO depths come from the same per-dataflow control words the Verilog
control modules carry.  Each node's full value stream is one float64 tensor
over the wall-clock axis.

What is verified, and how:

* **Delay matching (Eq. 10/11)** — a wall-clock schedule ``S`` is derived
  from the netlist itself (``S[dst] = S[src] + EL + latency`` along every
  edge); any join whose input arrivals disagree raises
  :class:`RTLTimingError`.  The LP's registers are thus *executed*, not just
  counted.
* **Interconnect topology + FIFO depths** — operand values only travel
  through the generated links; the elastic FIFO's physically required delay
  is checked against its programmed capacity and against the word the
  emitted control module programs.
* **Bit-exact results** — read memory ports are driven by a behavioral
  memory model (the testbench answers the generated address stream with the
  tensor value of the scheduled timestep), boundary fills are injected
  through the data-distribution-switch model exactly as in funcsim, and the
  committed output must equal :func:`repro_torch.core.funcsim.oracle`.

Like funcsim, psum *routing* is checked structurally
(:meth:`ADG.check_output_path`) while products are committed through the
output affine map — the scoreboard side of the testbench; the adder /
accumulator / reduction-tree plane still executes cycle-by-cycle.

Where the work runs.  The schedule, the FIFO checks and the evaluation order
are host Python over the DAG (as in the reference); the testbench, the
stream evaluation, the commit and the introspection record are tensor work
on the inputs' device.  A node's stream is freed after its last consumer
unless a VCD was asked for; the streams go to the host only for the VCD.
The commit sums every output element in the loop nest's point order
(:func:`repro_torch.core.funcsim.commit`), the order the oracle uses, so the
two agree bit for bit on any values.  What reads which stream: the commit
reads the FU product (multiplier) streams only; ``acc`` streams (a
``cumsum``, exact on the card only for integer-valued streams, as CUDA
scans in parallel) reach only the VCD; the ``hw`` record reads the schedule
and the fill masks, no stream.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..obs import METRICS, VCDWriter, span
from .adg import ADG
from .dag import DAG
from .emit import (anchored_sched, fifo_depth_for, fifo_programmed_delay,
                   mux_select)
from .funcsim import (_points_of, commit, in_box, on_device, operand_streams,
                      run_stages, shift_right, time_vectors)

__all__ = ["RTLSimResult", "RTLTimingError", "simulate_rtl",
           "simulate_rtl_stages"]


class RTLTimingError(AssertionError):
    """The netlist is not consistently delay-matched / FIFO-sized."""


@dataclass
class RTLSimResult:
    output: torch.Tensor
    cycles: int                 # wall-clock cycles simulated
    pipeline_depth: int         # max schedule offset (fill latency)
    fills: dict[str, int]       # switch-served boundary fills per tensor
    mem_reads: dict[str, int]
    link_transfers: dict[str, int]
    checks: dict                # joins verified, fifo delays, overrides
    hw: dict = field(default_factory=dict)  # introspection: per-FU
    # utilization, stall attribution, FIFO occupancy (see _introspect)


def _active(users: set[str], df_name: str) -> bool:
    return any(u.split("#")[0] == df_name for u in users)


def _edge_active(e, df_name: str) -> bool:
    """An edge with explicit codegen liveness serves only those dataflows.

    Multi-*workload* designs wire one reduction/psum network per output
    tensor into the shared adder plane and one operand network per workload
    into the multipliers; codegen records ``live`` on those edges so the
    inactive workload's network drops out of the sum exactly as the
    workload-select muxes deselect it in hardware.  Edges without the
    annotation (the workload-homogeneous common case) are always active."""
    live = e.meta.get("live")
    return live is None or any(u.split("#")[0] == df_name for u in live)


def _active_in(dag: DAG, df_name: str, cut_ports: set[int], in_map):
    """Value-dependency edges per node under the *active* dataflow.

    Fused designs may wire forwarding links in both directions between two
    FUs (one per dataflow) — a structural cycle that real hardware resolves
    because the runtime muxes deselect the inactive direction.  The stream
    evaluator mirrors that: a mux depends only on its selected input, an
    idle FIFO is cut, a port served entirely by the distribution switch
    needs no upstream value at all, and compute nodes of a multi-workload
    design combine only the edges live under the active workload."""

    def deps(nid: int) -> list:
        node = dag.nodes[nid]
        ins = in_map[nid]
        if nid in cut_ports:
            return []
        if node.kind == "mux":
            sel = mux_select(dag, nid, df_name, edges=ins)
            return [ins[sel]] if ins else []
        if node.kind == "fifo" and fifo_depth_for(node.meta, df_name) is None:
            return []
        if node.kind in ("mul", "add", "reduce", "acc"):
            return [e for e in ins if _edge_active(e, df_name)]
        return ins

    return deps


def _toposort_active(dag: DAG, deps) -> list[int]:
    """Topological order over the active value-dependency edges."""
    indeg = {nid: len(deps(nid)) for nid in dag.nodes}
    consumers: dict[int, list[int]] = {nid: [] for nid in dag.nodes}
    for nid in dag.nodes:
        for e in deps(nid):
            consumers[e.src].append(nid)
    q = deque(nid for nid in sorted(dag.nodes) if indeg[nid] == 0)
    order = []
    while q:
        u = q.popleft()
        order.append(u)
        for v in consumers[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                q.append(v)
    if len(order) != len(dag.nodes):
        raise RTLTimingError(
            "emitted DAG has a value cycle under the active dataflow; "
            "cannot stream-simulate")
    return order


def _schedule(dag: DAG) -> tuple[dict[int, int], dict]:
    """Wall-clock arrival offset per node, re-derived from the netlist.

    Every non-elastic edge ``u → v`` imposes the *equality*
    ``S[v] = S[u] + latency(v) + EL`` — the delay-matching property.  The
    offsets are assigned by BFS over the undirected equality graph and every
    redundant (non-tree) edge is checked exactly: a single wrong EL anywhere
    raises :class:`RTLTimingError`.  Components coupled only through elastic
    FIFOs are pinned with the LP potentials ``dag.sched`` (the FIFO-
    realizability rows of the LP keep that pinning feasible); FIFO nodes
    themselves are anchored from their consumer, so their programmed delay
    absorbs the inter-component skew exactly as in hardware.
    """
    adj: dict[int, list[tuple[int, int]]] = {nid: [] for nid in dag.nodes}
    n_eq = 0
    for e in dag.edges:
        if dag.nodes[e.src].elastic or dag.nodes[e.dst].elastic:
            continue
        delta = dag.nodes[e.dst].latency + e.el
        adj[e.src].append((e.dst, delta))
        adj[e.dst].append((e.src, -delta))
        n_eq += 1

    S: dict[int, int] = {}
    joins_checked = 0
    for start in sorted(dag.nodes):
        if start in S or dag.nodes[start].elastic:
            continue
        S[start] = int(round(dag.sched.get(start, 0)))
        q = deque([start])
        while q:
            u = q.popleft()
            for v, delta in adj[u]:
                want = S[u] + delta
                if v in S:
                    joins_checked += 1
                    if S[v] != want:
                        raise RTLTimingError(
                            f"delay-matching violated between nodes {u} and "
                            f"{v}: arrival {S[v]} != {want}")
                else:
                    S[v] = want
                    q.append(v)

    # elastic nodes: anchored from their (non-elastic) consumer side
    for nid in sorted(dag.nodes):
        if not dag.nodes[nid].elastic:
            continue
        outs = [e for e in dag.out_edges(nid) if e.dst in S]
        if outs:
            e = outs[0]
            S[nid] = S[e.dst] - dag.nodes[e.dst].latency - e.el
        else:
            ins = dag.in_edges(nid)
            S[nid] = S[ins[0].src] if ins and ins[0].src in S else 0

    shift = -min(S.values())
    S = {nid: s + shift for nid, s in S.items()}
    return S, {"joins_checked": joins_checked, "equality_edges": n_eq}


def simulate_rtl(dag: DAG, adg: ADG, df_name: str, inputs: dict,
                 true_sizes: dict[str, int] | None = None,
                 vcd: VCDWriter | str | None = None) -> RTLSimResult:
    """Execute the emitted netlist under dataflow ``df_name``.

    ``dag`` must come from :func:`repro_torch.core.dag.codegen` (it carries
    the operand-port provenance) and be delay-matched — run
    :func:`repro_torch.core.passes.run_backend` (or ``delay_matching``)
    first.  ``inputs`` are tensors on one device; everything on the value
    path runs there.

    ``true_sizes`` gives the un-padded problem dims: per-FU utilization in
    the ``hw`` introspection record then counts only iteration points inside
    the true extents as useful work.  ``vcd`` dumps every node's value
    stream as a waveform — pass a path string (written on return) or a
    shared :class:`~repro_torch.obs.VCDWriter` (multi-stage runs; the caller
    saves).
    """
    if not dag.opnd_ports:
        raise ValueError("DAG carries no operand-port provenance; "
                         "simulate_rtl needs a codegen-produced DAG")
    spec = adg.spec(df_name)
    wl, df = spec.workload, spec.dataflow
    T, n = df.total_cycles, df.n_fus
    coords = df.fu_coords()
    R_T = df.R_T
    dev, inputs = on_device(inputs)

    adg.check_output_path(df_name)
    feeders = adg.feeders(df_name)

    # --- testbench: local timesteps, operand values, boundary-fill masks ---
    TV = time_vectors(T, R_T, dev)
    VAL = operand_streams(wl, df, inputs, TV, coords)   # (n, T) per tensor
    fill_mask: dict[str, torch.Tensor] = {}
    valid_of: dict[tuple, torch.Tensor] = {}
    for t in wl.inputs:
        m = torch.zeros((n, T), dtype=torch.bool, device=dev)
        for f, (kind, info) in enumerate(feeders[t.name]):
            if kind == "switch":
                m[f] = True
            elif kind == "link":
                key = tuple(int(x) for x in info[1])
                if key not in valid_of:
                    valid_of[key] = in_box(TV, key, R_T)
                m[f] = ~valid_of[key]
        fill_mask[t.name] = m
    any_fill = {t: m.any(dim=1).tolist() for t, m in fill_mask.items()}

    # --- switch-model overrides at the operand ports -----------------------
    overrides: dict[int, list[tuple[str, int]]] = {}
    cut_ports: set[int] = set()  # ports served entirely by the switch
    input_names = {t.name for t in wl.inputs}
    for (tensor, f), nid in dag.opnd_ports.items():
        if tensor not in input_names:
            continue
        kind, _ = feeders[tensor][f]
        if kind == "mem":
            continue
        if any_fill[tensor][f]:
            claims = overrides.setdefault(nid, [])
            if claims:
                raise RTLTimingError(
                    f"operand port node {nid} shared by {claims} and "
                    f"({tensor}, {f}) needs conflicting fill injection")
            claims.append((tensor, f))
            if kind == "switch":
                cut_ports.add(nid)

    in_map = dag.in_edge_map()
    deps = _active_in(dag, df_name, cut_ports, in_map)
    order = _toposort_active(dag, deps)
    S, checks = _schedule(dag)
    W_total = max(S.values()) + T + 2

    # --- programmed FIFO delays -------------------------------------------
    fifo_delay: dict[int, int] = {}
    tables = {t.name: adg.reuse_table(df_name, t.name) for t in wl.tensors}
    fifo_report: dict[int, dict] = {}
    anchored = anchored_sched(dag) if dag.sched else None
    for nid in order:
        node = dag.nodes[nid]
        if node.kind != "fifo":
            continue
        ins = in_map[nid]
        cap = max(1, int(node.meta.get("depth", 1)))
        active = fifo_depth_for(node.meta, df_name) is not None
        if not active or not ins:
            fifo_delay[nid] = cap
            continue
        sf, dfu = node.meta.get("src_fu"), node.meta.get("dst_fu")
        tensor = node.meta.get("tensor")
        if df_name in node.meta.get("d_local", {}):
            d_local = int(node.meta["d_local"][df_name])
        else:
            ent = tables.get(tensor, {}).get(
                tuple((coords[dfu] - coords[sf]).tolist()))
            if ent is None:
                raise RTLTimingError(
                    f"fifo {nid} ({tensor} {sf}->{dfu}) active under "
                    f"{df_name} but no reuse generator matches its offset")
            d_local = df.t_scalar(ent[0])
        p = S[nid] - S[ins[0].src] + d_local
        if p < 0:
            raise RTLTimingError(
                f"fifo {nid} needs negative delay {p} under {df_name}")
        if p > cap:
            raise RTLTimingError(
                f"fifo {nid} needs delay {p} > capacity {cap} "
                f"under {df_name}")
        word = fifo_programmed_delay(dag, nid, df_name, anchored)
        if word is not None and word != p:
            raise RTLTimingError(
                f"fifo {nid}: emitted cfg word {word} != physically "
                f"required delay {p} under {df_name}")
        fifo_delay[nid] = p
        fifo_report[nid] = {"delay": p, "capacity": cap,
                            "programmed": word}

    # --- stream evaluation -------------------------------------------------
    keep_all = vcd is not None
    deps_of = {nid: deps(nid) for nid in order}
    last_use: dict[int, int] = {}
    for pos, nid in enumerate(order):
        for e in deps_of[nid]:
            last_use[e.src] = pos
    product_of = {mid: f for f, mid in dag.fu_product.items()}
    P = torch.empty((n, T), dtype=torch.float64, device=dev)

    streams: dict[int, torch.Tensor] = {}

    def zeros() -> torch.Tensor:
        return torch.zeros(W_total, dtype=torch.float64, device=dev)

    def inp(e, L: int) -> torch.Tensor:
        return shift_right(streams[e.src], L + e.el)

    # a stream may be its source's own tensor (a zero delay): nothing below
    # writes into a stream in place except the override, on a copy
    t_f64 = torch.arange(T, dtype=torch.float64, device=dev)
    for pos, nid in enumerate(order):
        node = dag.nodes[nid]
        L = node.latency
        ins = deps_of[nid]  # active value dependencies only
        kind = node.kind
        s0 = S[nid]
        if kind == "memport" and node.meta.get("direction") == "read":
            s = zeros()
            if _active(dag.users.get(nid, set()), df_name):
                s[s0:s0 + T] = VAL[node.meta["tensor"]][node.meta["fu"]]
        elif kind == "counter":
            s = zeros()
            s[s0:s0 + T] = t_f64
        elif kind in ("mul", "add", "reduce"):
            s = inp(ins[0], L) if ins else zeros()
            for e in ins[1:]:
                s = s * inp(e, L) if kind == "mul" else s + inp(e, L)
        elif kind == "acc":
            s = torch.cumsum(inp(ins[0], L), 0) if ins else zeros()
        elif kind == "fifo":
            base = streams[ins[0].src] if ins else zeros()
            s = shift_right(base, fifo_delay.get(nid, 1))
        elif kind in ("reg", "shift"):
            s = (shift_right(streams[ins[0].src], ins[0].el) if ins
                 else zeros())
            s = shift_right(s, max(1, int(node.meta.get("depth", 1))))
        elif kind == "const":
            s = torch.full((W_total,), float(node.meta.get("value", 0)),
                           dtype=torch.float64, device=dev)
        else:  # mux / wire / lut / memport-write / addrgen / input / output
            s = inp(ins[0], L) if ins else zeros()
        # data-distribution-switch model: boundary fills forced at the port
        if nid in overrides:
            s = s.clone()
            seg = s[s0:s0 + T]
            for tensor, f in overrides[nid]:
                seg.copy_(torch.where(fill_mask[tensor][f], VAL[tensor][f],
                                      seg))
        streams[nid] = s
        if nid in product_of:
            P[product_of[nid]] = s[s0:s0 + T]
        if not keep_all:
            for e in ins:
                if last_use.get(e.src) == pos:
                    streams.pop(e.src, None)
            if nid not in last_use:
                streams.pop(nid, None)

    # --- commit (scoreboard): FU products through the output map ----------
    sizes = df.sizes()
    out_shape = wl.tensor_shape(wl.output, sizes)
    pidx, oidx = _points_of(wl, df, sizes, TV, coords)
    numel = int(np.prod(out_shape, dtype=np.int64))
    out = commit(numel, oidx, P, key=pidx).reshape(out_shape)

    n_fill = {t.name: int(fill_mask[t.name].sum()) for t in wl.inputs}
    fills = dict(n_fill)
    mem_reads = {t.name: T * sum(1 for k, _ in feeders[t.name]
                                 if k == "mem") for t in wl.inputs}
    link_transfers = {}
    for t in wl.inputs:
        links = [f for f, (k, _) in enumerate(feeders[t.name]) if k == "link"]
        link_transfers[t.name] = (
            int((~fill_mask[t.name][links]).sum()) if links else 0)
    checks["fifos"] = fifo_report
    checks["overridden_ports"] = sum(len(v) for v in overrides.values())

    hw = _introspect(wl, df, S, T, W_total, n, TV, coords, fill_mask, dag,
                     true_sizes, fifo_report)
    METRICS.counter("rtlsim.runs").inc()
    METRICS.histogram("rtlsim.cycles").observe(W_total)

    if vcd is not None:
        writer = VCDWriter(vcd, design=f"{dag.name}.{df_name}") \
            if isinstance(vcd, (str, bytes)) else vcd
        _dump_vcd(writer, dag, streams)
        if isinstance(vcd, (str, bytes)):
            writer.save()

    return RTLSimResult(out, W_total, max(S.values()), fills, mem_reads,
                        link_transfers, checks, hw)


def _introspect(wl, df, S, T, W_total, n, TV, coords, fill_mask, dag,
                true_sizes, fifo_report) -> dict:
    """Hardware introspection record of one netlist execution.

    * ``fu_utilization`` — useful-MAC cycles / active cycles per FU.  A
      cycle is *useful* when the FU's iteration vector lies inside the true
      (un-padded) problem extents; without ``true_sizes`` every cycle
      counts, so the aggregate equals the closed-form ``perf_model``
      utilization (``true_macs / padded_macs``) by construction.
    * ``stalls`` — wall FU-cycles not doing useful work, attributed:
      ``fill`` (schedule offset before an FU's compute window — systolic
      pipeline fill), ``drain`` (after the window), ``switch_fill``
      (operand cycles served by the data-distribution switch instead of a
      link — boundary fills; these overlap the active window),
      ``padding`` (in-window cycles on padded iteration points) and
      ``memory`` (always 0: the behavioral memory model answers every
      address in one cycle).
    * ``fifo_occupancy`` — steady-state occupancy (== programmed delay) vs
      capacity per elastic FIFO; the high-water mark of the run.
    """
    sizes = df.sizes()
    dev = TV.device
    if true_sizes:
        useful = torch.ones((n, T), dtype=torch.bool, device=dev)
        i_base = (TV[:, None, :] * torch.as_tensor(
            df.M_TI, device=dev)[None, :, :]).sum(-1)     # (T, n_iter)
        SC = torch.as_tensor(coords @ df.M_SI.T, device=dev)  # (n, n_iter)
        for k, d in enumerate(wl.iter_dims):
            lim = int(true_sizes.get(d, sizes[d]))
            useful &= (SC[:, k, None] + i_base[None, :, k]) < lim
        useful_per_fu = useful.sum(dim=1).tolist()
        n_useful = int(sum(useful_per_fu))
    else:
        useful_per_fu = [T] * n
        n_useful = T * n
    fu_busy = np.array([S[dag.fu_product[f]] for f in range(n)],
                       dtype=np.int64)
    switch_cycles = 0
    for m in fill_mask.values():
        switch_cycles += int(m.sum())
    upf = np.asarray(useful_per_fu, dtype=np.int64)
    return {
        "n_fus": int(n),
        "active_cycles": int(T),
        "total_cycles": int(W_total),
        "utilization": float(n_useful / float(T * n)),
        "fu_utilization": (upf / float(T)).tolist(),
        "occupancy": float(T) / float(W_total),
        "stalls": {
            "fill": int(fu_busy.sum()),
            "drain": int((W_total - T - fu_busy).sum()),
            "switch_fill": switch_cycles,
            "padding": int((T - upf).sum()),
            "memory": 0,
        },
        "fifo_occupancy": {
            str(nid): {"high_water": rep["delay"],
                       "capacity": rep["capacity"]}
            for nid, rep in sorted(fifo_report.items())},
    }


def _dump_vcd(writer: VCDWriter, dag: DAG, streams: dict) -> None:
    """Register every DAG node's value stream with the VCD writer (change-
    compressed), in node-id order so the dump is deterministic.  The
    streams come to the host here and only here."""
    for nid in sorted(streams):
        node = dag.nodes[nid]
        name = f"n{nid}_{node.kind}"
        if node.kind == "memport":
            name += f"_{node.meta.get('tensor', '')}" \
                    f"_{node.meta.get('direction', '')}"
        writer.dump_stream(name, streams[nid].cpu().numpy())


def simulate_rtl_stages(dag: DAG, adg: ADG, df_names: list[str],
                        inputs: dict,
                        resident: dict[str, str] | None = None,
                        ppu=None,
                        vcd_path: str | None = None) -> list[RTLSimResult]:
    """Execute a multi-*workload* schedule on one emitted netlist.

    ``df_names`` runs in order (the runtime re-programs ``df_sel`` /
    ``wl_sel`` between stages); ``resident`` maps a stage's output tensor to
    the input tensor of a later stage it stays resident as — for the
    score-stationary fused attention design ``{"S": "P"}``: the score tensor
    written by the QK stage is *held in the behavioral memory model* and
    served as the PV stage's P operand.  ``ppu`` is the optional element-wise
    PPU transform applied at the handover (softmax in the paper; the
    identity when omitted), a tensor-to-tensor callable the testbench
    applies exactly as the staged oracle does, so the cross-check stays
    bit-exact.

    The caller provides only the external inputs (Q, K, V); providing a
    tensor that a ``resident`` handover would overwrite is an error, and
    every stage input is shape-checked against that stage's dataflow
    extents (:func:`repro_torch.core.funcsim.run_stages`).  Returns one
    :class:`RTLSimResult` per stage.

    ``vcd_path`` dumps every stage's node value streams into **one** VCD
    file on a monotonic timeline (the writer's origin advances past each
    finished stage).
    """
    writer = (VCDWriter(vcd_path, design=dag.name)
              if vcd_path else None)

    def stage_fn(a: ADG, dfn: str, stage_in):
        with span("rtlsim.stage", cat="rtlsim", dataflow=dfn):
            res = simulate_rtl(dag, a, dfn, stage_in, vcd=writer)
        if writer is not None:
            writer.advance(res.cycles)
        return res

    out = run_stages(adg, df_names, inputs, resident, ppu, stage_fn)
    if writer is not None:
        writer.save()
    return out

"""The paper's system end to end on the card: NN model → one fused
accelerator → per-layer mapping search → latency/energy report vs the
Gemmini baseline (Fig. 11 in miniature), plus the generated design's
area/power breakdown (Fig. 12).  The twin of the reference's
``examples/generate_accelerator.py``: its standard output is the
example's, line for line (only the wall times differ).

The accelerator can be the paper's hand-picked LEGO-MNICOC (default) or a
DSE-selected design: run ``python -m repro_torch.dse.batch_sweep --space
small`` first, then pass ``--dse BENCH_dse.json [--pick
cycles|energy|area|edp]`` to score the frontier-best configuration instead
(either CLI's frontier JSON works) — mapped with its own dataflow set and
the same closed-form area/power model the sweep used, so the numbers
printed here agree with the frontier entry it was picked from.

``--model ID`` runs a foundation model from ``repro_torch.configs``
instead of a CNN table: the config lowers through the model-graph frontend
(:func:`repro_torch.frontend.build_model_graph` — prefill *and* decode
phases) and is scored on the generated architecture vs the Gemmini
baseline.

On ``--device`` (the card unless the caller names the CPU; without a card
it raises): every mapping miss is scored there (``engine="torch"``), and
the two-stage netlist check, the waveform smoke run and their VCD dumps
run there.  ADG, DAG, the LP/ILP back end and the Verilog stay on the
host.

Run:  PYTHONPATH=src python -m repro_torch.generate_accelerator [--net MobileNetV2]
      PYTHONPATH=src python -m repro_torch.generate_accelerator --dse BENCH_dse.json
      PYTHONPATH=src python -m repro_torch.generate_accelerator \\
          --model llama4_scout_17b_a16e --emit-rtl out.v
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .configs import get_config, resolve_ids
from .core.cost import design_area_mm2, design_power_mw
from .core.dag import codegen
from .core.emit import build_netlist
from .core.passes import run_backend
from .designs import SET_TO_DESIGN, build_design
from .dse import DesignPoint, Evaluator, MappingCache
from .e2e import run_network_gemmini, run_network_lego
from .frontend import build_model_graph
from .models.common import check_device
from .nn_workloads import NETWORKS
from .obs import (add_verbosity_flag, configure, enable_tracing, save_trace,
                  span)


def emit_rtl(dag, path: str) -> None:
    """Write the optimized DAG as structural Verilog and report its size."""
    nl = build_netlist(dag)
    text = nl.verilog()
    with open(path, "w") as f:
        f.write(text)
    st = nl.stats(text)
    print(f"  emitted {path}: {st['modules']} modules, "
          f"{st['instances']} instances, {st['lines']} lines "
          f"(datapath + 1 ctrl module per dataflow + df_sel top)")


def pick_dse_design(path: str, objective: str) -> DesignPoint:
    """Frontier design from ``BENCH_dse.json`` minimizing ``objective``."""
    with open(path) as f:
        bench = json.load(f)
    frontier = bench["frontier"] or bench["designs"]
    keyfn = {"cycles": lambda e: e["cycles"],
             "energy": lambda e: e["energy_pj"],
             "area": lambda e: e["area_mm2"],
             "edp": lambda e: e["cycles"] * e["energy_pj"]}[objective]
    d = min(frontier, key=keyfn)["design"]
    return DesignPoint(n_fus=d["n_fus"], buffer_kb=d["buffer_kb"],
                       dram_gbps=d["dram_gbps"],
                       dataflow_set=d["dataflow_set"])


def run_paper_design(net: str, dev, emit: str | None = None,
                     vcd: str | None = None) -> None:
    """The original Fig. 11/12 miniature: LEGO-MNICOC at 256 FUs."""
    t0 = time.time()
    print("== generating LEGO-MNICOC (256 FUs, fused OH-OW + IC-OC) ==")
    adg = build_design("Conv2d-MNICOC")
    dag = codegen(adg)
    run_backend(dag)
    print(f"  generation time: {time.time()-t0:.1f}s "
          f"(paper: 28.7s at 256 FUs)")
    if emit:
        emit_rtl(dag, emit)
    if vcd:
        dump_waveform(dag, adg, vcd, dev)
    banks = sum(b.total_banks for b in adg.banking.values())
    area = design_area_mm2(dag, 256 * 1024, banks)
    power = design_power_mw(dag, 256 * 1024, sram_bytes_per_cycle=64)
    print(f"  area {area['total_mm2']:.2f} mm2 "
          f"(buffers {100*area['buffers']/area['total_mm2']/1e6:.0f}%), "
          f"power {power['total_mw']:.0f} mW")

    print(f"== mapping {net} ==")
    lego = run_network_lego(net, device=dev)
    gem = run_network_gemmini(net)
    print(f"  LEGO   : {lego.cycles/1e6:.2f} Mcycles, "
          f"{lego.gops:.0f} GOP/s, {lego.gops_per_w:.0f} GOP/s/W")
    print(f"  Gemmini: {gem.cycles/1e6:.2f} Mcycles, {gem.gops:.0f} GOP/s")
    print(f"  speedup {gem.cycles/lego.cycles:.2f}x, "
          f"energy saving {gem.energy_pj/lego.energy_pj:.2f}x "
          f"(paper average: 3.2x / 2.4x)")


def run_dse_design(point: DesignPoint, net: str, pick: str, dev,
                   emit: str | None = None, vcd: str | None = None) -> None:
    """Score a DSE-picked design on ``net`` the way the sweep scored it:
    its own dataflow set, √N data-node estimate, closed-form area/power."""
    print(f"== DSE pick (min {pick}): {point.name} ==")
    print(f"  {point.n_fus} FUs, {point.buffer_kb} KB buffers, "
          f"{point.dram_gbps:g} GB/s, dataflow set {point.dataflow_set!r}")

    t0 = time.time()
    design_name = SET_TO_DESIGN[point.dataflow_set]
    print(f"== generating {design_name} interconnect "
          f"(16x16 demo of the {point.dataflow_set!r} wiring class) ==")
    adg = build_design(design_name)
    dag = codegen(adg)
    run_backend(dag)
    print(f"  generation time: {time.time()-t0:.1f}s "
          f"(paper: 28.7s at 256 FUs)")
    if emit:
        emit_rtl(dag, emit)
    if vcd:
        dump_waveform(dag, adg, vcd, dev)

    e = Evaluator(zoo={net: NETWORKS[net]()}, cache=MappingCache(),
                  engine="torch", device=dev).evaluate(point)
    gem = run_network_gemmini(net)
    print(f"== mapping {net} on {point.name} ==")
    print(f"  est. area {e.area_mm2:.2f} mm2, power {e.power_mw:.0f} mW "
          f"(closed-form, as in BENCH_dse.json)")
    print(f"  LEGO   : {e.cycles/1e6:.2f} Mcycles, {e.gops:.0f} GOP/s")
    print(f"  Gemmini: {gem.cycles/1e6:.2f} Mcycles, {gem.gops:.0f} GOP/s")
    print(f"  speedup {gem.cycles/e.cycles:.2f}x, "
          f"energy saving {gem.energy_pj/e.energy_pj:.2f}x")


def _inputs(dev, specs_names, seed: int = 0) -> dict[str, torch.Tensor]:
    """The example's operands (NumPy's generator, integers in [-3, 3]) as
    float64 tensors on ``dev``."""
    rng = np.random.default_rng(seed)
    out = {}
    for spec, names in specs_names:
        sizes = spec.dataflow.sizes()
        for name in names:
            shape = spec.workload.tensor_shape(
                spec.workload.tensor(name), sizes)
            out[name] = torch.from_numpy(
                rng.integers(-3, 4, size=shape).astype(float)).to(dev)
    return out


def dump_waveform(dag, adg, path: str, dev) -> None:
    """Smoke-run the generated design's first dataflow with random inputs
    and dump every node's value stream as a VCD waveform (GTKWave /
    Surfer / any IEEE-1364 viewer)."""
    from .core.rtlsim import simulate_rtl

    df_name = adg.dataflow_names[0]
    spec = adg.spec(df_name)
    inputs = _inputs(dev, [(spec, [t.name for t in spec.workload.inputs])])
    res = simulate_rtl(dag, adg, df_name, inputs, vcd=path)
    print(f"  vcd: {res.cycles}-cycle {df_name!r} waveform -> {path}")


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in NumPy's pairwise order (eight running sums
    per block of 128, halves above), so that the softmax below rounds as
    the example's ``np.sum`` does."""
    n = x.shape[-1]
    if n < 8:
        r = torch.zeros_like(x[..., 0])
        for i in range(n):
            r = r + x[..., i]
        return r
    if n > 128:
        h = n // 2
        h -= h % 8
        return _row_sum(x[..., :h]) + _row_sum(x[..., h:])
    r = [x[..., j] for j in range(8)]
    i = 8
    while i < n - n % 8:
        r = [r[j] + x[..., i + j] for j in range(8)]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, n):
        res = res + x[..., k]
    return res


def softmax(s: torch.Tensor) -> torch.Tensor:
    """The PPU transform between the QK and PV stages."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / _row_sum(e).unsqueeze(-1)


def verify_two_stage_rtl(dag, adg, dev, vcd: str | None = None) -> None:
    """Bit-exactness gate for the score-stationary fused attention design:
    the emitted netlist executes the QK stage, the score tensor S is held
    in the behavioral memory model, softmax runs as the PPU transform, and
    the PV stage consumes the resident P — both stages must equal the
    staged funcsim oracle exactly."""
    from .core.funcsim import staged_oracle
    from .core.rtlsim import simulate_rtl_stages

    qk, pv = adg.spec("attn-qk"), adg.spec("attn-pv")
    inputs = _inputs(dev, [(qk, ("Q", "K")), (pv, ("V",))])
    stages, resident = ["attn-qk", "attn-pv"], {"S": "P"}
    refs = staged_oracle(adg, stages, inputs, resident=resident, ppu=softmax)
    res = simulate_rtl_stages(dag, adg, stages, inputs, resident=resident,
                              ppu=softmax, vcd_path=vcd)
    for r, ref, name in zip(res, refs, stages):
        assert torch.equal(r.output, ref), \
            f"stage {name}: netlist diverges from the funcsim oracle"
    print(f"  rtlsim two-stage check: QK + PV bit-exact vs funcsim oracle "
          f"(P resident, softmax on PPUs; "
          f"{res[0].cycles}+{res[1].cycles} cycles)")
    if vcd:
        print(f"  vcd: QK+PV two-stage waveform -> {vcd}")


def run_model_design(model_id: str, seq: int, dev, emit: str | None = None,
                     point: DesignPoint | None = None,
                     vcd: str | None = None) -> None:
    """One generated architecture, one foundation model, both phases.

    Lowers the full config through the model-graph frontend, generates the
    fused interconnect of the design's wiring class, then maps the prefill
    pass and the decode step onto the design point and compares each
    against the Gemmini baseline.  Attention-bearing models default to the
    ``attention_fused`` wiring class: the score-stationary attn_qk+pv
    design (paper Fig. 10), whose emitted netlist is verified bit-exactly
    against the two-stage funcsim oracle before mapping.
    """
    cfg = get_config(model_id)
    graphs = {ph: build_model_graph(cfg, seq=seq, phase=ph)
              for ph in ("prefill", "decode")}
    g = graphs["prefill"]
    print(f"== lowering {cfg.name}: {g.n_nodes} graph nodes -> "
          f"{len(g.lowered())} unique workload shapes "
          f"({g.macs() / 1e9:.1f} GMACs prefill @ seq {seq}) ==")
    print(g.summary(limit=16))

    # 256 FUs / 256 KB (the paper's budget) unless --dse picked a point;
    # attention-bearing models get the score-stationary fused design
    if point is None:
        has_attn = any(n.kind in ("attn_qk", "attn_pv") for n in g.nodes)
        point = DesignPoint(
            dataflow_set="attention_fused" if has_attn else "switch")
    t0 = time.time()
    design_name = SET_TO_DESIGN[point.dataflow_set]
    print(f"== generating {design_name} interconnect "
          f"(16x16 demo of the {point.dataflow_set!r} wiring class) ==")
    adg = build_design(design_name)
    dag = codegen(adg)
    run_backend(dag)
    print(f"  generation time: {time.time()-t0:.1f}s "
          f"(paper: 28.7s at 256 FUs)")
    if point.dataflow_set == "attention_fused":
        verify_two_stage_rtl(dag, adg, dev, vcd=vcd)
    elif vcd:
        dump_waveform(dag, adg, vcd, dev)
    if emit:
        emit_rtl(dag, emit)

    zoo = {f"{model_id}@{ph}": gr.lowered() for ph, gr in graphs.items()}
    ev = Evaluator(zoo=zoo, cache=MappingCache(), baseline="gemmini",
                   engine="torch", device=dev)
    e = ev.evaluate(point)
    print(f"== mapping {cfg.name} on {point.name} ==")
    print(f"  est. area {e.area_mm2:.2f} mm2, power {e.power_mw:.0f} mW "
          f"(closed-form, as in BENCH_models.json)")
    for key, rec in e.per_config.items():
        ph = key.split("@")[-1]
        fused = ""
        if "speedup_fused_attention" in rec:
            fused = (f", fused attention "
                     f"{rec['speedup_fused_attention']:.2f}x vs unfused")
        print(f"  {ph:>8}: {rec['cycles']/1e6:10.2f} Mcycles, "
              f"{rec['gops']:5.0f} GOP/s, util {rec['utilization']:.2f}, "
              f"{rec['speedup_vs_gemmini']:.2f}x vs Gemmini "
              f"({rec['energy_vs_gemmini']:.2f}x energy){fused}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.generate_accelerator",
        description=__doc__.splitlines()[0])
    ap.add_argument("--net", default="MobileNetV2")
    ap.add_argument("--model", default=None, metavar="ID",
                    help="map a repro_torch.configs foundation model "
                         "(lowered via repro_torch.frontend, prefill + "
                         "decode) instead of a --net CNN table")
    ap.add_argument("--seq", type=int, default=512,
                    help="prefill length / decode context (with --model)")
    ap.add_argument("--dse", default=None, metavar="BENCH_dse.json",
                    help="take the accelerator config from a DSE sweep")
    ap.add_argument("--pick", default="cycles",
                    choices=["cycles", "energy", "area", "edp"],
                    help="frontier objective to minimize (with --dse)")
    ap.add_argument("--emit-rtl", default=None, metavar="OUT.v",
                    help="write the generated design as structural Verilog "
                         "(datapath + per-dataflow control + df_sel top)")
    ap.add_argument("--vcd", default=None, metavar="OUT.vcd",
                    help="dump the rtlsim waveform of the generated design "
                         "as a GTKWave-loadable VCD (the two-stage fused-"
                         "attention verify with --model on attention "
                         "models, else a smoke run of its first dataflow)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome trace-event JSON of the generate/"
                         "verify/map pipeline (load in "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate arguments and inputs, print the plan, "
                         "exit before generation/mapping")
    ap.add_argument("--device", default="cuda",
                    help="where mapping misses are scored and the netlist "
                         "simulator runs (default: cuda)")
    add_verbosity_flag(ap)
    args = ap.parse_args(argv)
    configure(args.verbose)
    dev = check_device(args.device)
    if args.trace:
        enable_tracing()

    model_id = None
    if args.model:
        try:
            (model_id,) = resolve_ids(args.model)
        except (KeyError, ValueError) as e:
            sys.exit(f"error: --model expects one repro_torch.configs id: "
                     f"{e.args[0]}")
    elif args.net not in NETWORKS:
        sys.exit(f"error: unknown net {args.net!r}; known: "
                 f"{', '.join(sorted(NETWORKS))}")
    if args.dse and not os.path.exists(args.dse):
        sys.exit(f"error: {args.dse} not found — run "
                 f"`python -m repro_torch.dse.batch_sweep --space small` "
                 f"first")

    if args.dry_run:
        target = (f"model {model_id}" if model_id else f"net {args.net}")
        source = (f"DSE pick (min {args.pick}) from {args.dse}" if args.dse
                  else "LEGO-MNICOC (256 FUs)")
        print(f"dry run: would map {target} on {source}"
              + (f", emitting RTL to {args.emit_rtl}" if args.emit_rtl
                 else ""))
        return 0

    with span("generate_accelerator", cat="cli",
              target=model_id or args.net):
        if model_id:
            point = pick_dse_design(args.dse, args.pick) if args.dse else None
            run_model_design(model_id, args.seq, dev, emit=args.emit_rtl,
                             point=point, vcd=args.vcd)
        elif args.dse:
            run_dse_design(pick_dse_design(args.dse, args.pick), args.net,
                           args.pick, dev, emit=args.emit_rtl, vcd=args.vcd)
        else:
            run_paper_design(args.net, dev, emit=args.emit_rtl, vcd=args.vcd)
    if args.trace:
        payload = save_trace(args.trace)
        print(f"  trace: {len(payload['traceEvents'])} events -> "
              f"{args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The paper's evaluation on the port — one function per paper table or
figure, the twin of the reference's ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV rows: ``us_per_call`` is the wall
time of producing the artifact (generation/analysis time — Table IV's
"Generation Time" axis), ``derived`` carries the headline number(s) being
reproduced next to the paper's published value.  The rows, their fields
and number formats are the reference's; every number in them that is not a
timing is the reference's too.

On ``--device`` (the card unless the caller names the CPU; without a card
it raises):

- ``fig11_e2e``, ``table2_genai``, ``table5_fusion`` and
  ``instr_overhead`` map every layer through
  :func:`repro_torch.e2e.run_network_lego`, the candidates scored by the
  torch engine there (the winners are the NumPy engine's);
- ``mapper_batch_micro``'s batched half scores there
  (``best_mappings(engine="torch")``); its scalar half stays on the host;
- ``kernel_micro`` times :func:`repro_torch.kernels.ops.gemm` at 512 x 512
  fp32 (one warm-up, then 10 calls, each waited for): on the card that is
  K1's fp32 kernel (``csrc/gemm.cu``), on the CPU its plain version.  The
  row keeps the reference's name, ``micro.gemm_ref_512``.

The other rows (Figs. 10, 12, 13/14, Tables III, IV, VI, the memoization
micro-bench) generate and cost designs on the host, as in the reference.

A function that raises prints the reference's ``ERROR=`` row and the run
goes on, as the reference's does; unlike the reference's, the command then
exits 1.

Run:  PYTHONPATH=src python -m repro_torch.paper_figures [--only SUBSTR]
          [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

from .models.common import check_device, synchronize


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e6, out


def _emit(name: str, us: float, derived: str):
    print(f"{name},{us:.0f},{derived}", flush=True)


# ---------------------------------------------------------------------------
# Fig. 10 — per-kernel area/energy savings of back-end optimization
# ---------------------------------------------------------------------------

def fig10_backend_opts():
    from .core.cost import dag_area_um2, dag_power_mw
    from .core.dag import codegen
    from .core.passes import run_backend
    from .designs import build_design

    ratios = []
    for name in ["GEMM-IJ", "GEMM-JK", "GEMM-MJ", "Conv2d-OHOW",
                 "Conv2d-ICOC", "Conv2d-MNICOC", "MTTKRP-IJ", "MTTKRP-MJ",
                 "Attention"]:
        def one(name=name):
            adg = build_design(name)
            base = codegen(adg)
            run_backend(base, optimize=False)
            opt = codegen(adg)
            run_backend(opt, optimize=True)
            a0 = dag_area_um2(base).total_um2
            a1 = dag_area_um2(opt).total_um2
            df0 = adg.dataflow_names[0]
            p0 = dag_power_mw(base).total_mw
            p1 = dag_power_mw(opt, active_df=df0).total_mw
            return a0 / a1, p0 / p1
        us, (ar, pr) = _timed(one)
        ratios.append((ar, pr))
        _emit(f"fig10.{name}", us,
              f"area_saving={ar:.2f}x;energy_saving={pr:.2f}x")
    aa = sum(r[0] for r in ratios) / len(ratios)
    pp = sum(r[1] for r in ratios) / len(ratios)
    _emit("fig10.average", 0, f"area_saving={aa:.2f}x;energy_saving={pp:.2f}x"
          ";paper=1.5x/1.4x")


# ---------------------------------------------------------------------------
# Fig. 11 — end-to-end vs Gemmini (paper: 3.2x speedup, 2.4x energy)
# ---------------------------------------------------------------------------

def fig11_e2e(device="cuda"):
    from .e2e import run_network_gemmini, run_network_lego

    device = check_device(device)
    nets = ["AlexNet", "MobileNetV2", "ResNet50", "EfficientNetV2", "BERT",
            "GPT2", "CoAtNet"]
    sp = en = 0.0
    for net in nets:
        def one(net=net):
            lego = run_network_lego(net, device=device)
            gem = run_network_gemmini(net)
            return gem.cycles / lego.cycles, gem.energy_pj / lego.energy_pj, \
                lego, gem
        us, (s, e, lego, gem) = _timed(one)
        sp += s
        en += e
        _emit(f"fig11.{net}", us,
              f"speedup={s:.2f}x;energy_saving={e:.2f}x;"
              f"lego_gops={lego.gops:.0f};gemmini_gops={gem.gops:.0f}")
    _emit("fig11.average", 0,
          f"speedup={sp/len(nets):.2f}x;energy_saving={en/len(nets):.2f}x;"
          "paper=3.2x/2.4x")


# ---------------------------------------------------------------------------
# Fig. 12 — area/power breakdown of LEGO-MNICOC
# ---------------------------------------------------------------------------

def fig12_breakdown():
    from .core.cost import design_area_mm2, design_power_mw
    from .core.dag import codegen
    from .core.passes import run_backend
    from .designs import build_design

    def one():
        adg = build_design("Conv2d-MNICOC")
        dag = codegen(adg)
        run_backend(dag)
        banks = sum(b.total_banks for b in adg.banking.values())
        area = design_area_mm2(dag, 256 * 1024, banks, n_ppus=8)
        power = design_power_mw(dag, 256 * 1024, sram_bytes_per_cycle=64,
                                n_ppus=8)
        return area, power
    us, (area, power) = _timed(one)
    buf_frac = area["buffers"] / (area["total_mm2"] * 1e6)
    fu_noc_pw = (power["fu_array"] + power["noc"]) / power["total_mw"]
    ppu_area = area["ppu"] / (area["total_mm2"] * 1e6)
    _emit("fig12.area", us,
          f"total_mm2={area['total_mm2']:.2f};buffers_frac={buf_frac:.2f};"
          f"ppu_frac={ppu_area:.3f};paper=1.76mm2/0.86/0.02")
    _emit("fig12.power", 0,
          f"total_mw={power['total_mw']:.0f};fu_noc_frac={fu_noc_pw:.2f};"
          "paper=285mW/0.83")


# ---------------------------------------------------------------------------
# Fig. 13/14 — per-pass backend contribution breakdown
# ---------------------------------------------------------------------------

def fig13_14_backend_breakdown():
    from .core.cost import dag_area_um2, dag_power_mw
    from .core.dag import codegen
    from .core.passes import (broadcast_rewire, delay_matching,
                              extract_reduction_trees, infer_bitwidths,
                              pin_reuse, power_gate)
    from .designs import build_design

    for name in ["GEMM-MJ", "Conv2d-MNICOC", "MTTKRP-MJ", "Attention"]:
        def one(name=name):
            adg = build_design(name)
            steps = {}
            dag = codegen(adg)
            delay_matching(dag)
            steps["baseline"] = dag_area_um2(dag).total_um2
            extract_reduction_trees(dag)
            delay_matching(dag)
            steps["reduction_tree"] = dag_area_um2(dag).total_um2
            broadcast_rewire(dag)
            steps["rewire"] = dag_area_um2(dag).total_um2
            pin_reuse(dag)
            delay_matching(dag)
            steps["pin_reuse"] = dag_area_um2(dag).total_um2
            power_gate(dag)
            infer_bitwidths(dag)
            delay_matching(dag)
            steps["final"] = dag_area_um2(dag).total_um2
            p = dag_power_mw(dag, active_df=adg.dataflow_names[0]).total_mw
            return steps, p
        us, (steps, p) = _timed(one)
        b = steps["baseline"]
        derived = ";".join(f"{k}={v/b:.3f}" for k, v in steps.items())
        _emit(f"fig13.{name}", us, derived + f";power_mw={p:.1f}"
              + ";paper_avg_area=0.65x_of_baseline")


# ---------------------------------------------------------------------------
# Table II — large generative models on LEGO-ICOC-1K
# ---------------------------------------------------------------------------

def table2_genai(device="cuda"):
    from .core.perf_model import HWConfig
    from .e2e import run_network_lego

    device = check_device(device)
    hw1k = HWConfig(n_fus=1024, buffer_bytes=576 * 1024, dram_gbps=32.0,
                    n_ppus=32)
    for net, paper_util in [("DDPM", 0.929), ("StableDiffusion", 0.802),
                            ("LLaMA-7B-bs1", 0.031),
                            ("LLaMA-7B-bs32", 0.429)]:
        def one(net=net):
            return run_network_lego(net, hw=hw1k, device=device)
        us, r = _timed(one)
        util = 2.0 * r.macs / (2.0 * hw1k.n_fus * r.cycles)
        _emit(f"table2.{net}", us,
              f"utilization={util:.3f};gops={2*r.macs/r.cycles:.0f};"
              f"paper_util={paper_util}")


# ---------------------------------------------------------------------------
# Table III — vs handwritten designs (Eyeriss / NVDLA class)
# ---------------------------------------------------------------------------

def table3_handwritten():
    from .core.adg import generate_adg
    from .core.cost import dag_power_mw, design_area_mm2
    from .core.dag import codegen
    from .core.passes import run_backend
    from .designs import _conv_icoc, _conv_khoh

    def one():
        # LEGO-KHOH @ 168 FUs (Eyeriss setting: 12x14 array)
        wl, df = _conv_khoh(Pkh=12, Poh=14, name="khoh-eyeriss")
        adg = generate_adg([(wl, df)], name="lego-khoh")
        dag = codegen(adg)
        run_backend(dag)
        a_khoh = design_area_mm2(dag, 108 * 1024, 16)["total_mm2"]
        p_khoh = dag_power_mw(dag).total_mw + 40  # buffers/noc active power

        # LEGO-ICOC @ 256 FUs (NVDLA setting)
        wl2, df2 = _conv_icoc(P=16, name="icoc-nvdla")
        adg2 = generate_adg([(wl2, df2)], name="lego-icoc")
        dag2 = codegen(adg2)
        run_backend(dag2)
        a_icoc = design_area_mm2(dag2, 256 * 1024, 16)["total_mm2"]
        p_icoc = dag_power_mw(dag2).total_mw + 120
        return a_khoh, p_khoh, a_icoc, p_icoc
    us, (a1, p1, a2, p2) = _timed(one)
    _emit("table3.LEGO-KHOH", us,
          f"area_mm2={a1:.2f};power_mw={p1:.0f};"
          "eyeriss=9.6mm2@65nm/278mW;paper_lego=7.4mm2@65nm/112mW")
    _emit("table3.LEGO-ICOC", 0,
          f"area_mm2={a2:.2f};power_mw={p2:.0f};"
          "nvdla=1.7mm2/300mW;paper_lego=1.5mm2/209mW")


# ---------------------------------------------------------------------------
# Table IV — scaling 64 -> 4096 FUs (FU array below 1024, L2 NoC above)
# ---------------------------------------------------------------------------

def table4_scaling():
    from .core import workload as W
    from .core.adg import generate_adg
    from .core.cost import (dag_power_mw, design_area_mm2, noc_area_um2,
                            noc_power_mw)
    from .core.dag import codegen
    from .core.dataflow import build_dataflow
    from .core.passes import run_backend

    for n_fus in [64, 256, 1024, 4096]:
        def one(n_fus=n_fus):
            arr = min(n_fus, 1024)
            P = int(arr ** 0.5)
            n_pes = max(1, n_fus // arr)
            wl = W.conv2d()
            df = build_dataflow(
                wl, spatial=[("ic", P), ("oc", P)],
                temporal=[("n", 1), ("oc", 2), ("ic", 2), ("oh", 4),
                          ("ow", 4), ("kh", 3), ("kw", 3)],
                c=(1, 1), name="icoc")
            adg = generate_adg([(wl, df)], name=f"scale{n_fus}")
            dag = codegen(adg)
            run_backend(dag)
            buf = 256 * 1024 * n_pes
            parts = design_area_mm2(dag, buf, 16, n_ppus=8 * n_pes)
            area = parts["total_mm2"] + (n_pes > 1) * (
                noc_area_um2(n_pes, 256) / 1e6)
            pw = (dag_power_mw(dag).total_mw + 110) * n_pes \
                + (n_pes > 1) * noc_power_mw(n_pes, 256)
            eff = 2.0 * n_fus / pw  # GOP/s/mW -> TOP/s/W
            return area, pw, eff * 1e3
        us, (area, pw, eff) = _timed(one)
        _emit(f"table4.fus{n_fus}", us,
              f"gen_time_s={us/1e6:.1f};area_mm2={area:.2f};"
              f"power_mw={pw:.0f};gops_per_w={eff:.0f};paper_eff~4700-4850")


# ---------------------------------------------------------------------------
# Table V — efficacy of dataflow fusion
# ---------------------------------------------------------------------------

def table5_fusion(device="cuda"):
    from .core.cost import dag_power_mw
    from .core.dag import codegen
    from .core.passes import run_backend
    from .designs import build_design
    from .e2e import run_network_lego

    device = check_device(device)
    rows = [
        ("ICOCICOC", "Conv2d-ICOC", "icoc", "heuristic"),
        ("OHOWICOC", "Conv2d-OHOW", "ohow", "heuristic"),
        ("MNICOC-merged", "Conv2d-MNICOC", None, "naive"),
        ("MNICOC-optimized", "Conv2d-MNICOC", None, "heuristic"),
    ]
    for label, design, restrict, fuse in rows:
        def one(label=label, design=design, restrict=restrict, fuse=fuse):
            adg = build_design(design, fuse=fuse)
            dag = codegen(adg)
            run_backend(dag, optimize=(fuse == "heuristic"))
            pw = dag_power_mw(dag, active_df=adg.dataflow_names[0]).total_mw
            mbv2 = run_network_lego("MobileNetV2", restrict=restrict,
                                    device=device)
            r50 = run_network_lego("ResNet50", restrict=restrict,
                                   device=device)
            return pw, mbv2, r50
        us, (pw, mbv2, r50) = _timed(one)
        _emit(f"table5.{label}", us,
              f"power_mw={pw:.0f};mbv2_gops={mbv2.gops:.0f};"
              f"r50_gops={r50.gops:.0f};mbv2_eff={mbv2.gops_per_w:.0f}")


# ---------------------------------------------------------------------------
# Table VI-class — control-logic sharing + instruction overhead
# ---------------------------------------------------------------------------

def table6_related():
    from .core.cost import dag_area_um2
    from .core.dag import codegen
    from .core.passes import run_backend
    from .designs import build_design

    def one():
        adg = build_design("GEMM-IJ")
        dag = codegen(adg)
        run_backend(dag)
        shared = dag.count("addrgen") + dag.count("counter")
        # counterfactual (AutoSA/TensorLib style): per-FU address/control
        per_fu = adg.n_fus * 3
        ff_saving = per_fu / max(1, shared)
        area = dag_area_um2(dag)
        ctrl_frac = area.control / area.total_um2
        return ff_saving, ctrl_frac
    us, (ff, frac) = _timed(one)
    _emit("table6.control_sharing", us,
          f"addrgen_reduction={ff:.1f}x;ctrl_area_frac={frac:.2f};"
          "paper=6.5xFF/5.0xLUT_vs_AutoSA;2.0xArea/2.6xPower_vs_TensorLib")


def instr_overhead(device="cuda"):
    from .e2e import run_network_lego
    from .nn_workloads import NETWORKS

    device = check_device(device)
    def one():
        out = []
        for net in ["MobileNetV2", "ResNet50", "BERT"]:
            r = run_network_lego(net, device=device)
            n_instr = sum(rep for _, _, rep, _ in NETWORKS[net]()) * 4
            cpi = r.cycles / n_instr
            bw = n_instr * 16 / max(r.cycles, 1)  # GB/s at 1 GHz
            out.append((net, cpi, bw))
        return out
    us, rows = _timed(one)
    for net, cpi, bw in rows:
        _emit(f"instr.{net}", us / len(rows),
              f"cycles_per_instr={cpi:.0f};instr_bw_gbps={bw:.3f};"
              "paper=>2000cpi;0.05-0.13GB/s")


# ---------------------------------------------------------------------------
# micro-benchmarks: the mapper's memoization and batching on the host and
# the card, and K1
# ---------------------------------------------------------------------------

def mapper_micro():
    """Memoization of the mapper's pure enumeration helpers (factor_pairs,
    dataflow construction): unmemoized body vs lru_cache hit."""
    from .core import dataflow as DF
    from .core import mapper as M
    from .core import workload as W

    # enumeration helpers in isolation: unmemoized body vs lru_cache hit
    def fp_raw():
        for _ in range(2000):
            M.factor_pairs.__wrapped__(4096)

    def fp_cached():
        for _ in range(2000):
            M.factor_pairs(4096)

    us_fp_raw, _ = _timed(fp_raw)
    M.factor_pairs(4096)  # prime
    us_fp_hit, _ = _timed(fp_cached)
    _emit("micro.factor_pairs_2000x", us_fp_hit,
          f"unmemoized_us={us_fp_raw:.0f};memoized_us={us_fp_hit:.0f};"
          f"speedup={us_fp_raw / max(1.0, us_fp_hit):.1f}x")

    wl_conv = W.conv2d()

    def df_raw():
        for _ in range(200):
            DF._cached_dataflow.__wrapped__(
                wl_conv.iter_dims, (("ic", 16), ("oc", 16)),
                (("n", 1), ("oc", 2), ("ic", 2), ("oh", 8), ("ow", 8),
                 ("kh", 3), ("kw", 3)), (1, 1), "icoc")

    def df_cached():
        for _ in range(200):
            DF.build_dataflow(
                wl_conv, spatial=[("ic", 16), ("oc", 16)],
                temporal=[("n", 1), ("oc", 2), ("ic", 2), ("oh", 8),
                          ("ow", 8), ("kh", 3), ("kw", 3)],
                c=(1, 1), name="icoc")

    us_df_raw, _ = _timed(df_raw)
    us_df_hit, _ = _timed(df_cached)
    _emit("micro.build_dataflow_200x", us_df_hit,
          f"unmemoized_us={us_df_raw:.0f};memoized_us={us_df_hit:.0f};"
          f"speedup={us_df_raw / max(1.0, us_df_hit):.1f}x")


# transformer-shaped GEMM layer set: the DSE evaluator's typical
# per-(design, workload-kind) batched query (the reference's, copied)
MAPPER_BENCH_QUERIES = [(dict(i=i, j=j, k=k), float(nt)) for i, j, k, nt in [
    (512, 5120, 4096, 0), (512, 4096, 4096, 0), (512, 512, 128, 262144),
    (512, 128, 512, 0), (512, 14336, 4096, 0), (512, 4096, 14336, 2048),
    (512, 256000, 4096, 0), (1, 4096, 4096, 0), (4096, 4096, 4096, 0),
    (512, 1024, 4096, 0), (512, 4096, 1024, 0), (512, 64, 4096, 0)]]
MAPPER_BENCH_FUS = (64, 256, 1024)


def mapper_batch_micro(device="cuda"):
    """Batched vs scalar mapping search: a transformer-shaped layer set
    (the DSE evaluator's per-(design, workload-kind) query), the scalar
    engine on the host against the batched one scored on ``device``."""
    from .core import workload as W
    from .core.mapper import SpatialChoice, best_mapping
    from .core.mapper_batch import best_mappings
    from .core.perf_model import HWConfig

    device = check_device(device)
    wl = W.gemm()
    sps = [SpatialChoice(("i", "j"), (1, 1), "ij"),
           SpatialChoice(("k", "j"), (1, 1), "jk")]
    queries = MAPPER_BENCH_QUERIES
    hws = [HWConfig(n_fus=n) for n in MAPPER_BENCH_FUS]

    def scalar():
        for hw in hws:
            for dims, nt in queries:
                best_mapping(wl, dims, sps, hw, ppu_elements=nt,
                             engine="scalar")

    def batched():
        for hw in hws:
            best_mappings(wl, queries, sps, hw, engine="torch",
                          device=device)

    us_scalar, _ = _timed(scalar)
    us_batch, _ = _timed(batched)
    n = len(queries) * len(hws)
    _emit(f"micro.mapper_batch_{n}q", us_batch,
          f"scalar_us={us_scalar:.0f};batched_us={us_batch:.0f};"
          f"speedup={us_scalar / max(1.0, us_batch):.1f}x")


def kernel_micro(device="cuda"):
    """K1 (``ops.gemm``) at 512 x 512 fp32 on ``device``: one warm-up,
    then the mean of 10 calls, each waited for as the reference blocks
    until ready."""
    import torch

    from .kernels import ops

    dev = check_device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(512, 512, generator=gen).to(dev)
    b = torch.randn(512, 512, generator=gen).to(dev)
    ops.gemm(a, b)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        ops.gemm(a, b)
        synchronize(dev)
    us = (time.perf_counter() - t0) / 10 * 1e6
    _emit("micro.gemm_ref_512", us, f"gflops={2*512**3/us/1e3:.1f}")


ALL = [fig10_backend_opts, fig11_e2e, fig12_breakdown,
       fig13_14_backend_breakdown, table2_genai, table3_handwritten,
       table4_scaling, table5_fusion, table6_related, instr_overhead,
       mapper_micro, mapper_batch_micro, kernel_micro]

QUICK = [mapper_micro, mapper_batch_micro]

# the functions that take the device
ON_DEVICE = (fig11_e2e, table2_genai, table5_fusion, instr_overhead,
             mapper_batch_micro, kernel_micro)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.paper_figures",
        description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="micro-benchmarks only (seconds, not minutes)")
    ap.add_argument("--device", default="cuda",
                    help="where the mapping candidates are scored and K1 "
                         "runs (default: cuda; no fallback to the CPU)")
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    print("name,us_per_call,derived", flush=True)
    errors = 0
    for fn in QUICK if args.quick else ALL:
        if args.only and args.only not in fn.__name__:
            continue
        try:
            fn(dev) if fn in ON_DEVICE else fn()
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            _emit(fn.__name__, 0, f"ERROR={type(e).__name__}:{e}")
            errors += 1
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

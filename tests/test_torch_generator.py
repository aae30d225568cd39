"""The port's LEGO generator against the reference's, on the CPU: the reuse
solver, the arborescence, banking, the fusion plans, the ADG, codegen's
DAG, the LP/ILP back end, the DAG cost model and structural Verilog.

Everything here is host NumPy/SciPy in both packages, called on the same
inputs in the same order, so every comparison is exact: the same reuse
sets, the same DAG (nodes, edges, meta, every edge's ``el`` and the LP's
potentials), the same area and power floats, the same Verilog bytes.  The
paper's four fused 256-FU designs are built by the reference's recipes
(``benchmarks.designs``) and by the port from the same loops."""

import os
import random
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.cost as RC
import repro.core.fusion as RFU
import repro.core.interconnect as RI
import repro.core.memory as RM
import repro.core.passes as RP
import repro.core.spanning as RSP
import repro.core.workload as RW
import repro_torch.core.cost as PC
import repro_torch.core.fusion as PFU
import repro_torch.core.interconnect as PI
import repro_torch.core.memory as PM
import repro_torch.core.passes as PP
import repro_torch.core.spanning as PSP
from _generator_parity import FUSED, dag_form, fused_pair, norm, port_spec
from benchmarks.designs import DESIGNS
from repro.core.adg import generate_adg as ref_generate_adg
from repro.core.dag import DAG as RefDAG
from repro.core.dag import codegen as ref_codegen
from repro.core.dataflow import build_dataflow as ref_build_dataflow
from repro.core.emit import emit_netlist as ref_emit_netlist
from repro_torch.core.adg import generate_adg
from repro_torch.core.dag import DAG, codegen
from repro_torch.core.emit import build_netlist, emit_netlist

ROOT = Path(__file__).resolve().parents[1]

# small single-dataflow specs over every workload kind (the shapes of
# tests/test_backend.py's), as (workload name, loops)
SMALL = {
    "gemm-jk": ("gemm", dict(spatial=[("k", 4), ("j", 4)],
                             temporal=[("i", 2), ("j", 2), ("k", 2), ("i", 4)],
                             c=(1, 1))),
    "gemm-ij": ("gemm", dict(spatial=[("i", 4), ("j", 4)],
                             temporal=[("i", 2), ("j", 2), ("k", 8)],
                             c=(0, 0))),
    "conv-ohow": ("conv2d", dict(
        spatial=[("ow", 3), ("oh", 3)],
        temporal=[("n", 1), ("ow", 1), ("oh", 1), ("oc", 2), ("ic", 2),
                  ("kh", 3), ("kw", 3)], c=(0, 0))),
    "conv-icoc": ("conv2d", dict(
        spatial=[("ic", 4), ("oc", 4)],
        temporal=[("n", 1), ("oc", 2), ("ic", 2), ("oh", 2), ("ow", 2),
                  ("kh", 3), ("kw", 3)], c=(1, 1))),
    "attn-qk": ("attention_qk", dict(spatial=[("m", 4), ("n", 4)],
                                     temporal=[("b", 2), ("d", 8)],
                                     c=(0, 0))),
    "mttkrp-kj": ("mttkrp", dict(spatial=[("k", 4), ("j", 4)],
                                 temporal=[("i", 4), ("k", 2), ("l", 2)],
                                 c=(1, 1))),
}


def _small(name):
    wname, kw = SMALL[name]
    wl = getattr(RW, wname)()
    df = ref_build_dataflow(wl, name=name, **kw)
    return (wl, df), port_spec(wl, df)


# ---------------------------------------------------------------------------
# interconnect, spanning, memory, fusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SMALL))
def test_reuse_solver_and_reuse_graph_match(name):
    (wl, df), (pwl, pdf) = _small(name)
    want, got = RI.solve_all(wl, df), PI.solve_all(pwl, pdf)
    assert norm(got) == norm(want)
    if df.n_T <= 4:  # a wider spatial box (the solver enumerates 3^n_T)
        assert norm(PI.solve_all(pwl, pdf, 2, 1)) == \
            norm(RI.solve_all(wl, df, 2, 1))
    for t in wl.tensors:
        assert norm(PI.solve_delay(pwl, pdf, t.name, 1, 1, 3)) \
            == norm(RI.solve_delay(wl, df, t.name, 1, 1, 3))
        reuses, preuses = want[t.name], got[t.name]
        for reverse in (False, True):
            assert norm(PI.build_reuse_graph(pdf, preuses, 1.2, reverse)) == \
                norm(RI.build_reuse_graph(df, reuses, 1.2, reverse))


@pytest.mark.parametrize("seed", range(6))
def test_min_arborescence_matches_on_random_graphs(seed):
    rnd = random.Random(seed)
    n = rnd.randint(3, 12)
    root = n
    edges = {(root, v): float(rnd.randint(3, 9)) for v in range(n)}
    for _ in range(rnd.randint(n, 4 * n)):
        u, v = rnd.randrange(n), rnd.randrange(n)
        if u != v:
            edges[(u, v)] = float(rnd.randint(0, 6))
    assert PSP.min_arborescence(n, root, dict(edges)) == \
        RSP.min_arborescence(n, root, dict(edges))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_spanning_banking_and_address_generators_match(name):
    (wl, df), (pwl, pdf) = _small(name)
    want, got = RI.solve_all(wl, df), PI.solve_all(pwl, pdf)
    for t in wl.tensors:
        reuses, preuses = want[t.name], got[t.name]
        spatial = [r for r in reuses if r.is_spatial]
        if not spatial:
            continue
        reverse = t.role == "output"
        g = RI.build_reuse_graph(df, spatial, 1.2, reverse)
        pg = PI.build_reuse_graph(pdf, [r for r in preuses if r.is_spatial],
                                  1.2, reverse)
        parent, dns = RSP.spanning_interconnect(g)
        assert PSP.spanning_interconnect(pg) == (parent, dns)
        plan = RM.analyze_banking(wl, df, t.name, dns)
        pplan = PM.analyze_banking(pwl, pdf, t.name, dns)
        assert norm(pplan) == norm(plan)
        assert norm(PM.fuse_banking([pplan])) == norm(RM.fuse_banking([plan]))
        coords = df.fu_coords()
        for f in dns[:4]:
            ag = RM.address_generator(wl, df, t.name, coords[f])
            pag = PM.address_generator(pwl, pdf, t.name, coords[f])
            assert norm(pag) == norm(ag)
            for tv in ([0] * df.n_T, [1] * df.n_T):
                assert pag.flat_address(np.array(tv)) == \
                    ag.flat_address(np.array(tv))


# Conv2d-MNICOC's plans are held through its whole ADG below (the same
# solve and fuse calls), which saves solving its reuse twice
@pytest.mark.parametrize("design", ["GEMM-MJ", "MTTKRP-MJ", "Attention"])
def test_fusion_plans_match(design):
    specs = DESIGNS[design]()
    pspecs = [port_spec(w, d) for w, d in specs]
    tensors = {}
    for (wl, df), (pwl, pdf) in zip(specs, pspecs):
        want, got = RI.solve_all(wl, df), PI.solve_all(pwl, pdf)
        for t in wl.tensors:
            reuses, preuses = want[t.name], got[t.name]
            rev = t.role == "output"
            sol = RFU.solve_dataflow(wl, df, t.name, reuses, 1.2, rev)
            psol = PFU.solve_dataflow(pwl, pdf, t.name, preuses, 1.2, rev)
            assert norm(psol) == norm(sol)
            tensors.setdefault(t.name, ([], []))
            tensors[t.name][0].append(sol)
            tensors[t.name][1].append(psol)
    plans, pplans = {}, {}
    for tn, (sols, psols) in tensors.items():
        for fuse, pfuse in ((RFU.fuse_tensor, PFU.fuse_tensor),
                            (RFU.naive_merge, PFU.naive_merge)):
            want, got = fuse(sols), pfuse(psols)
            assert norm(got) == norm(want)
            assert got.mux_inputs() == want.mux_inputs()
            assert got.all_data_nodes == want.all_data_nodes
        plans[tn], pplans[tn] = RFU.fuse_tensor(sols), PFU.fuse_tensor(psols)
    assert PFU.data_node_pressure(pplans) == RFU.data_node_pressure(plans)


# ---------------------------------------------------------------------------
# ADG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", FUSED)
def test_fused_adg_matches(design):
    (radg, _, _), (padg, _, _) = fused_pair(design)
    assert padg.summary() == radg.summary()
    assert norm(padg) == norm(radg)
    for dfn in radg.dataflow_names:
        assert norm(padg.feeders(dfn)) == norm(radg.feeders(dfn))
        spec = radg.spec(dfn)
        for t in spec.workload.tensors:
            assert norm(padg.reuse_table(dfn, t.name)) == \
                norm(radg.reuse_table(dfn, t.name))
            assert padg.max_fifo_depth(t.name) == radg.max_fifo_depth(t.name)
        padg.check_output_path(dfn)
    assert padg.n_muxes() == radg.n_muxes()


@pytest.mark.parametrize("fuse", ["heuristic", "naive"])
@pytest.mark.parametrize("pair,d_S,max_delay", [
    ("conv", 1, None), ("conv", 1, 4), ("gemm", 2, None)])
def test_adg_options_match(fuse, pair, d_S, max_delay):
    if pair == "gemm":
        specs = [_small("gemm-jk")[0], _small("gemm-ij")[0]]
    else:
        specs = [_small("conv-ohow")[0], _small("conv-icoc")[0]]
        specs[1] = (specs[1][0], ref_build_dataflow(
            specs[1][0], name="conv-icoc", spatial=[("ic", 3), ("oc", 3)],
            temporal=[("n", 1), ("oc", 2), ("ic", 2), ("oh", 3), ("ow", 3),
                      ("kh", 3), ("kw", 3)], c=(1, 1)))
    kw = dict(name="opts", fuse=fuse, d_S=d_S, max_delay_depth=max_delay)
    radg = ref_generate_adg(specs, **kw)
    padg = generate_adg([port_spec(w, d) for w, d in specs], **kw)
    assert norm(padg) == norm(radg)
    for dfn in radg.dataflow_names:
        assert norm(padg.feeders(dfn)) == norm(radg.feeders(dfn))


# ---------------------------------------------------------------------------
# DAG, back end, cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", FUSED)
def test_codegen_and_backend_match(design):
    (radg, rdag, rrep), (padg, pdag, prep) = fused_pair(design)
    # the optimized DAG: nodes, edges (every el), meta, LP potentials
    assert prep == rrep
    assert dag_form(pdag) == dag_form(rdag)
    assert pdag.stats() == rdag.stats()
    # codegen alone, and the Fig. 10 baseline (delay matching only)
    base, pbase = ref_codegen(radg), codegen(padg)
    assert dag_form(pbase) == dag_form(base)
    assert PP.run_backend(pbase, optimize=False) == \
        RP.run_backend(base, optimize=False)
    assert dag_form(pbase) == dag_form(base)
    assert pbase.toposort() == base.toposort()


@pytest.mark.parametrize("name", sorted(SMALL))
def test_each_pass_matches(name):
    (wl, df), (pwl, pdf) = _small(name)
    rdag = ref_codegen(ref_generate_adg([(wl, df)], name="t"))
    pdag = codegen(generate_adg([(pwl, pdf)], name="t"))
    steps = [
        ("extract_reduction_trees", lambda m, d: m.extract_reduction_trees(d)),
        ("delay_matching_bcast",
         lambda m, d: m.delay_matching(d, broadcast_virtual_cost=True)),
        ("broadcast_rewire", lambda m, d: m.broadcast_rewire(d)),
        ("pin_reuse", lambda m, d: m.pin_reuse(d)),
        ("power_gate", lambda m, d: m.power_gate(d)),
        ("infer_bitwidths", lambda m, d: m.infer_bitwidths(d, 8)),
        ("delay_matching", lambda m, d: m.delay_matching(d)),
    ]
    for label, step in steps:
        got, want = step(PP, pdag), step(RP, rdag)
        assert norm(got) == norm(want), label
        assert dag_form(pdag) == dag_form(rdag), label


def test_pin_reuse_ilp_matches_on_a_shared_reducer():
    """tests/test_backend.py's hand-built reducer whose inputs are live in
    disjoint dataflows: the 0-1 ILP remaps them onto shared ports."""
    dags = []
    for D in (RefDAG, DAG):
        d = D("pins")
        d.dataflows = ["a", "b"]
        red = d.add("reduce", 32, fan=4)
        for k in range(4):
            src = d.add("mul", 16, users={"a" if k < 2 else "b"})
            d.wire(src, red)
        dags.append(d)
    want, got = RP.pin_reuse(dags[0]), PP.pin_reuse(dags[1])
    assert norm(got) == norm(want) and got.pins_after < got.pins_before
    assert dag_form(dags[1]) == dag_form(dags[0])


@pytest.mark.parametrize("design", FUSED)
def test_dag_cost_model_matches(design):
    (radg, rdag, _), (padg, pdag, _) = fused_pair(design)
    assert PC.dag_area_um2(pdag).as_dict() == RC.dag_area_um2(rdag).as_dict()
    for active in (None, *radg.dataflow_names):
        assert PC.dag_power_mw(pdag, active).as_dict() == \
            RC.dag_power_mw(rdag, active).as_dict()
    banks = sum(b.total_banks for b in radg.banking.values())
    assert norm(PC.design_area_mm2(pdag, 256 * 1024, banks)) == \
        norm(RC.design_area_mm2(rdag, 256 * 1024, banks))
    assert norm(PC.design_power_mw(pdag, 256 * 1024, 64.0,
                                   active_df=radg.dataflow_names[0])) == \
        norm(RC.design_power_mw(rdag, 256 * 1024, 64.0,
                                active_df=radg.dataflow_names[0]))


# ---------------------------------------------------------------------------
# Verilog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", FUSED)
def test_fused_design_verilog_is_byte_identical(design):
    (_, rdag, _), (_, pdag, _) = fused_pair(design)
    text = emit_netlist(pdag)
    assert text == ref_emit_netlist(rdag)
    assert "pipe(" not in text
    assert build_netlist(pdag).stats(text)["lines"] == len(text.splitlines())


def test_baseline_verilog_is_byte_identical():
    (radg, _, _), (padg, _, _) = fused_pair("GEMM-MJ")
    base, pbase = ref_codegen(radg), codegen(padg)
    RP.run_backend(base, optimize=False)
    PP.run_backend(pbase, optimize=False)
    assert emit_netlist(pbase) == ref_emit_netlist(base)


def test_tiny_dag_matches_the_golden_netlist():
    d = DAG("tiny")
    a = d.add("input", 8)
    b = d.add("const", 8, value=3)
    m = d.add("mul", 16)
    d.wire(a, m)
    e = d.wire(b, m)
    e.el = 2
    acc = d.add("acc", 32)
    d.wire(m, acc)
    o = d.add("output", 32)
    d.wire(acc, o)
    golden = (ROOT / "tests" / "golden" / "tiny_netlist.v").read_text()
    assert emit_netlist(d) == golden


# ---------------------------------------------------------------------------
# the quickstart twin, and CUDA left alone at import
# ---------------------------------------------------------------------------

def test_quickstart_twin_prints_the_examples_output(capsys):
    from repro_torch import quickstart
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    assert quickstart.main(["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want
    assert got.err.count("netlist: exact=True") == 2


def test_quickstart_refuses_a_missing_card(monkeypatch):
    import torch

    from repro_torch import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])


def test_generator_chain_imports_torch_but_never_initialises_cuda():
    """Importing the generator chain and running the GEMM-MJ quickstart on
    the CPU never initialises CUDA.  A fresh interpreter with CUDA's lazy
    init made to raise."""
    code = (
        "import sys, torch\n"
        "def boom(*a, **k): raise AssertionError('CUDA initialised')\n"
        "torch.cuda._lazy_init = boom\n"
        "torch.cuda.init = boom\n"
        "import repro_torch.core.adg, repro_torch.core.dag\n"
        "import repro_torch.core.passes, repro_torch.core.emit\n"
        "import repro_torch.core.funcsim, repro_torch.core.rtlsim\n"
        "import repro_torch.quickstart\n"
        "assert repro_torch.quickstart.main(['--device', 'cpu']) == 0\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-1] == "ok"


def test_chip_smoke_recipes_are_the_reference_designs():
    """chip_smoke.py phase 12 builds the designs from repro_torch.designs
    (the port does not import benchmarks/): their loops are
    benchmarks/designs.py's."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert chip_smoke.GEN_DESIGNS == FUSED
    for name in chip_smoke.GEN_DESIGNS:
        want = [(w.name, d.name, [(l.dim, l.size) for l in d.spatial],
                 [(l.dim, l.size) for l in d.temporal],
                 tuple(int(v) for v in d.c)) for w, d in DESIGNS[name]()]
        got = [(w.name, d.name, [(l.dim, l.size) for l in d.spatial],
                [(l.dim, l.size) for l in d.temporal],
                tuple(int(v) for v in d.c))
               for w, d in chip_smoke._gen_recipe(name)]
        assert got == want
    long = chip_smoke._gen_recipe("Conv2d-MNICOC", chip_smoke.GEN_LONG_OHOW)
    assert long[1][1].total_cycles == 112_896
    assert [(l.dim, l.size) for l in long[1][1].temporal] == [
        ("n", 1), ("oc", 2), ("ic", 2), ("oh", 56), ("ow", 56), ("kh", 3),
        ("kw", 3)]

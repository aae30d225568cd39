"""The port's two user front doors against the reference's, on the CPU:
``python -m repro_torch.generate_accelerator`` (the twin of
``examples/generate_accelerator.py``) and the design search's command line
``python -m repro_torch.dse.batch_sweep`` (the twin of
``benchmarks/dse.py``), with the copies they stand on
(``repro_torch.configs.resolve_ids``, ``repro_torch.designs``,
``repro_torch.nn_workloads``, ``repro_torch.e2e``).

The reference runs as a subprocess (its CLIs with ``--engine numpy``), the
port in this process with ``--device cpu`` and its default ``torch``
engine.  Comparisons are exact: the standard output with only the wall
times masked, the Verilog and VCD bytes, and the sweep JSON with its walls,
provenance and the engine naming fields aside; ``run_network_lego``'s
energy is held at 1e-9 relative (its integers exactly)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import benchmarks.designs as RD
import benchmarks.e2e as RE
import benchmarks.nn_workloads as RN
import repro_torch.designs as PD
import repro_torch.e2e as PE
import repro_torch.nn_workloads as PN
from _generator_parity import norm
from repro.configs import resolve_ids as ref_resolve_ids
from repro_torch import generate_accelerator as GA
from repro_torch.configs import resolve_ids
from repro_torch.dse import batch_sweep as PB
from repro_torch.obs import METRICS

ROOT = Path(__file__).resolve().parents[1]
ENERGY_RTOL = 1e-9

# the CLIs' tiny sweep: two configs at smoke size, seq 64
TINY = ["--space", "tiny", "--configs", "gemma_7b,glm4_9b", "--reduced",
        "--seq", "64", "-q"]
_WALL = re.compile(r"(generation time: |\) in |configs in )[0-9.]+s")


def _mask(text: str) -> str:
    return _WALL.sub(r"\1<t>s", text)


def _ref(cmd: list[str], cwd: Path) -> subprocess.CompletedProcess:
    """A reference script (``examples/`` or ``benchmarks/``) in ``cwd``."""
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'src'}"}
    cwd.mkdir(parents=True, exist_ok=True)
    return subprocess.run([sys.executable, str(ROOT / cmd[0]), *cmd[1:]],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=cwd)


def _port(main, argv, cwd: Path, capsys, monkeypatch) -> tuple[int, str]:
    """A port entry point in this process, run from ``cwd``, on the CPU;
    the metrics registry starts empty, as in a fresh process."""
    cwd.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    METRICS.reset()
    capsys.readouterr()
    rc = main([*argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "all", " ALL ", "gemma_7b", "gemma-7b,llama", "llama4, rwkv6-7b,llama4",
    "phi-3-vision-4.2b,whisper-base", ("glm4_9b", "glm4-9b"), "", "gpt5",
    "gemma_7b,nope"])
def test_resolve_ids_matches_reference(spec):
    try:
        want = ref_resolve_ids(spec)
    except KeyError as e:
        with pytest.raises(KeyError) as got:
            resolve_ids(spec)
        assert got.value.args == e.args
        return
    assert resolve_ids(spec) == want


def _recipe(specs):
    return [(w.name, d.name, [(l.dim, l.size) for l in d.spatial],
             [(l.dim, l.size) for l in d.temporal],
             tuple(int(v) for v in d.c)) for w, d in specs]


@pytest.mark.parametrize("name", sorted(RD.DESIGNS))
def test_design_recipes_match(name):
    assert _recipe(PD.DESIGNS[name]()) == _recipe(RD.DESIGNS[name]())
    assert PD.SET_TO_DESIGN == RD.SET_TO_DESIGN
    try:
        want = RD.design_spatials(name)
    except KeyError:
        with pytest.raises(KeyError):
            PD.design_spatials(name)
        return
    assert norm(PD.design_spatials(name)) == norm(want)


@pytest.mark.parametrize("net", sorted(RN.NETWORKS))
def test_network_layer_tables_match(net):
    assert PN.NETWORKS[net]() == RN.NETWORKS[net]()


@pytest.mark.parametrize("net", ["MobileNetV2", "BERT"])
def test_network_scores_match(net):
    """run_network_lego (mapping candidates scored by the torch engine on
    the CPU) and run_network_gemmini against the reference's."""
    assert PE.lego_data_nodes() == RE.lego_data_nodes()
    for restrict in (None, "icoc"):
        got = PE.run_network_lego(net, restrict=restrict, device="cpu")
        want = RE.run_network_lego(net, restrict=restrict)
        assert (got.name, got.cycles, got.macs, got.ppu_cycles) == \
            (want.name, want.cycles, want.macs, want.ppu_cycles)
        assert abs(got.energy_pj - want.energy_pj) <= \
            ENERGY_RTOL * abs(want.energy_pj)
    got, want = PE.run_network_gemmini(net), RE.run_network_gemmini(net)
    assert (got.cycles, got.macs, got.ppu_cycles) == \
        (want.cycles, want.macs, want.ppu_cycles)
    assert abs(got.energy_pj - want.energy_pj) <= \
        ENERGY_RTOL * abs(want.energy_pj)


# ---------------------------------------------------------------------------
# generate_accelerator: the example's stdout, Verilog and VCD
# ---------------------------------------------------------------------------

def _same_files(a: Path, b: Path, names) -> None:
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_twin_paper_design(tmp_path, capsys, monkeypatch):
    """LEGO-MNICOC on MobileNetV2, --emit-rtl."""
    args = ["--net", "MobileNetV2", "--emit-rtl", "o.v"]
    want = _ref(["examples/generate_accelerator.py", *args],
                tmp_path / "ref")
    assert want.returncode == 0, want.stderr[-2000:]
    rc, got = _port(GA.main, args, tmp_path / "port", capsys, monkeypatch)
    assert rc == 0 and _mask(got) == _mask(want.stdout)
    assert "speedup" in got
    _same_files(tmp_path / "ref", tmp_path / "port", ["o.v"])


def test_twin_model_design(tmp_path, capsys, monkeypatch):
    """A foundation model through the graph frontend on the fused
    attention design: the two-stage netlist check (softmax on the PPUs)
    and its waveform, byte for byte."""
    args = ["--model", "llama4_scout_17b_a16e", "--emit-rtl", "o.v",
            "--vcd", "o.vcd"]
    want = _ref(["examples/generate_accelerator.py", *args],
                tmp_path / "ref")
    assert want.returncode == 0, want.stderr[-2000:]
    rc, got = _port(GA.main, args, tmp_path / "port", capsys, monkeypatch)
    assert rc == 0 and _mask(got) == _mask(want.stdout)
    assert "QK + PV bit-exact" in got
    _same_files(tmp_path / "ref", tmp_path / "port", ["o.v", "o.vcd"])


def test_softmax_rounds_as_numpy():
    """The PPU softmax sums each row in NumPy's pairwise order, so the
    staged waveform above equals the example's; at every row length."""
    import numpy as np
    r = np.random.default_rng(0)
    for n in (*range(1, 40), 127, 128, 129, 300, 1000):
        s = r.integers(-30, 30, (3, n)).astype(np.float64) * 0.37
        e = np.exp(s - s.max(axis=-1, keepdims=True))
        want = e / e.sum(axis=-1, keepdims=True)
        assert np.array_equal(GA.softmax(torch.from_numpy(s)).numpy(), want)


@pytest.fixture(scope="module")
def frontiers(tmp_path_factory):
    """The same tiny sweep's frontier JSON from each CLI."""
    d = tmp_path_factory.mktemp("frontiers")
    r = _ref(["benchmarks/dse.py", *TINY, "--engine", "numpy", "--out",
              "f.json"], d / "ref")
    assert r.returncode == 0, r.stderr[-2000:]
    METRICS.reset()
    cwd = os.getcwd()
    try:
        (d / "port").mkdir()
        os.chdir(d / "port")
        assert PB.main([*TINY, "--device", "cpu", "--out", "f.json"]) == 0
    finally:
        os.chdir(cwd)
    return d / "ref" / "f.json", d / "port" / "f.json"


def test_twin_dse_pick_reads_either_clis_frontier(frontiers, tmp_path,
                                                  capsys, monkeypatch):
    """--dse with --emit-rtl and --vcd (the first dataflow's smoke run)."""
    ref_json, port_json = frontiers
    args = ["--pick", "edp", "--emit-rtl", "o.v", "--vcd", "o.vcd"]
    want = _ref(["examples/generate_accelerator.py", "--dse", str(ref_json),
                 *args], tmp_path / "ref")
    assert want.returncode == 0, want.stderr[-2000:]
    for src, js in (("r", ref_json), ("p", port_json)):
        rc, got = _port(GA.main, ["--dse", str(js), *args],
                        tmp_path / src, capsys, monkeypatch)
        assert rc == 0 and _mask(got) == _mask(want.stdout)
        _same_files(tmp_path / "ref", tmp_path / src, ["o.v", "o.vcd"])


def test_twin_dry_run_and_bad_arguments(tmp_path, capsys, monkeypatch):
    for args in (["--dry-run"], ["--model", "glm4-9b", "--dry-run",
                                 "--emit-rtl", "x.v"]):
        want = _ref(["examples/generate_accelerator.py", *args],
                    tmp_path / "ref")
        rc, got = _port(GA.main, args, tmp_path / "port", capsys,
                        monkeypatch)
        assert rc == 0 and got == want.stdout
    for args in (["--model", "gpt5"], ["--net", "LeNet"],
                 ["--dse", "missing.json"]):
        with pytest.raises(SystemExit) as e:
            GA.main([*args, "--device", "cpu"])
        assert "error:" in str(e.value)


# ---------------------------------------------------------------------------
# the design search's command line against benchmarks/dse.py
# ---------------------------------------------------------------------------

_FRONTIER = re.compile(r"== Pareto frontier.*?best\[   edp\]: \S+", re.S)


def _payload(path: Path, port: bool) -> dict:
    """The sweep JSON without walls and provenance; the port's engine and
    device fields checked and dropped, and so is the engine
    micro-benchmark its torch engine implies (the reference's NumPy engine
    runs none; a partial artifact has none), with the candidates its batch
    enumerated taken out of the metrics."""
    d = json.loads(path.read_text())
    d.pop("wall_s"), d.pop("provenance")
    meta = d["meta"]
    meta.pop("total_wall_s")
    engine = meta.pop("engine")
    bench = meta.pop("engine_bench", None)
    if port:
        assert engine == "torch" and meta.pop("device") == "cpu"
        if meta.get("partial"):
            assert bench is None
        else:
            assert list(bench["engines"]) == ["numpy", "torch"]
            d["metrics"]["counters"]["mapper.candidates_enumerated"] -= \
                bench["candidates"]
    else:
        assert engine == "numpy" and bench is None
    return d


def _both_clis(tmp_path, args, capsys, monkeypatch, rc=0, out="out.json"):
    """Run the reference's CLI and the port's with ``args`` in their own
    directories (each with its own cache and ledger); returns both
    stdouts after checking the exit codes and the JSON."""
    want = _ref(["benchmarks/dse.py", *args, "--engine", "numpy"],
                tmp_path / "ref")
    assert want.returncode == rc, want.stderr[-2000:]
    got_rc, got = _port(PB.main, args, tmp_path / "port", capsys,
                        monkeypatch)
    assert got_rc == rc
    if out is not None:
        assert _payload(tmp_path / "port" / out, True) == \
            _payload(tmp_path / "ref" / out, False)
    return got, want.stdout


def _flags(cmd: list[str]) -> set[str]:
    r = subprocess.run([sys.executable, *cmd, "--help"], capture_output=True,
                       text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr[-2000:]
    # the option column of argparse's help: "  -q, --quiet", "  --seq SEQ"
    return {f for line in r.stdout.splitlines()
            if re.match(r"  -", line)
            for f in re.findall(r"(?<![\w-])(--?[a-z][a-z-]*)",
                                line.split("  ")[1])}


def test_cli_takes_the_reference_flags():
    """Every flag of benchmarks/dse.py, and --device."""
    want = _flags(["benchmarks/dse.py"])
    got = _flags(["-m", "repro_torch.dse.batch_sweep"])
    assert "--emit-dir" in want and "--engine-bench" in want
    assert want <= got and got - want == {"--device"}


def test_cli_sigterm_leaves_a_partial_artifact(tmp_path):
    """A SIGTERM takes the Ctrl-C path: the ledger flushed, a partial
    artifact written, exit 130."""
    import signal
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    p = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.dse.batch_sweep", "--space",
         "small", "--seq", "512,4096", "--device", "cpu", "--out",
         "out.json"], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        for line in p.stdout:      # the first design's progress line
            if line.startswith("  [1/"):
                break
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 130, err[-2000:]
    assert "interrupted after" in out
    payload = json.loads((tmp_path / "out.json").read_text())
    assert payload["partial"] and payload["meta"]["partial"]
    assert 0 < len(payload["designs"]) < 120
    assert (tmp_path / "out.json.ledger").exists()


@pytest.mark.parametrize("mode", ["plain", "workers", "serving", "dry-run"])
def test_cli_matches_reference(mode, tmp_path, capsys, monkeypatch):
    extra = {"plain": ["--top", "4"], "workers": ["--workers", "2"],
             "serving": ["--objective", "serving"],
             "dry-run": ["--dry-run"]}[mode]
    got, want = _both_clis(tmp_path, [*TINY, *extra, "--out", "out.json"],
                           capsys, monkeypatch,
                           out="out.json" if mode in ("plain", "serving")
                           else None)
    if mode == "workers":
        # a pool's cache statistics depend on which worker took which
        # design; the scorecards do not
        a = _payload(tmp_path / "port" / "out.json", True)
        b = _payload(tmp_path / "ref" / "out.json", False)
        for k in ("designs", "frontier", "best", "supervisor"):
            assert a[k] == b[k], k
        assert a["meta"]["workers"] == 2
    if mode == "dry-run":
        assert got == want and not (tmp_path / "port" / "out.json").exists()
        return
    assert _FRONTIER.search(got).group() == _FRONTIER.search(want).group()
    if mode != "workers":
        assert _mask(got) == _mask(want)
    if mode == "serving":
        assert "== serving (64 requests" in got


def test_cli_cross_model_study(tmp_path, capsys, monkeypatch):
    """--models with --quick: the Gemmini baselines and the
    one-architecture winner, in BENCH_models.json's layout."""
    got, want = _both_clis(
        tmp_path, ["--models", "gemma_7b,rwkv6-7b", "--quick", "-q",
                   "--out", "out.json"], capsys, monkeypatch)
    assert _mask(got) == _mask(want) and "== cross-model winner" in got
    payload = json.loads((tmp_path / "port" / "out.json").read_text())
    assert payload["bench"] == "models"
    assert payload["model_ids"] == ["gemma_7b", "rwkv6_7b"]


def test_cli_nets_and_emit_dir(tmp_path, capsys, monkeypatch):
    """A CNN in the zoo and the frontier's wiring classes emitted: the
    Verilog byte for byte, the artifacts recorded in the JSON."""
    got, want = _both_clis(
        tmp_path, [*TINY, "--nets", "MobileNetV2", "--emit-dir", "rtl",
                   "--out", "out.json"], capsys, monkeypatch)
    assert _mask(got) == _mask(want)
    payload = json.loads((tmp_path / "port" / "out.json").read_text())
    assert "MobileNetV2" in payload["designs"][0]["per_config"]
    names = sorted(os.listdir(tmp_path / "ref" / "rtl"))
    assert names and sorted(os.listdir(tmp_path / "port" / "rtl")) == names
    _same_files(tmp_path / "ref" / "rtl", tmp_path / "port" / "rtl", names)
    assert sorted(payload["artifacts"].values()) == \
        [f"rtl/{n}" for n in names]


def test_cli_interrupted_then_resumed(tmp_path, capsys, monkeypatch):
    """--inject-faults kill_after=3 leaves a partial artifact and its
    ledger and returns 130; --resume adopts the three evaluations and
    finishes with the clean frontier."""
    got, want = _both_clis(
        tmp_path, [*TINY, "--inject-faults", "kill_after=3", "--out",
                   "out.json"], capsys, monkeypatch, rc=130)
    assert _mask(got) == _mask(want) and "interrupted after 3" in got
    partial = json.loads((tmp_path / "port" / "out.json").read_text())
    assert partial["partial"] and len(partial["designs"]) == 3
    got, want = _both_clis(tmp_path, [*TINY, "--resume", "--out",
                                      "out.json"], capsys, monkeypatch)
    assert "resumed=3" in got
    assert _FRONTIER.search(got).group() == _FRONTIER.search(want).group()


def test_cli_design_batch_is_the_per_design_sweep(tmp_path, capsys,
                                                  monkeypatch):
    """--design-batch prefills on --device and gives the reference's
    per-design frontier."""
    want = _ref(["benchmarks/dse.py", *TINY, "--engine", "numpy", "--out",
                 "out.json"], tmp_path / "ref")
    monkeypatch.setattr(PB, "DESIGN_AXIS_SPACE", "tiny")
    rc, got = _port(PB.main, [*TINY, "--design-batch", "--d-tile", "4",
                              "--out", "out.json"], tmp_path / "port",
                    capsys, monkeypatch)
    assert rc == 0
    assert _FRONTIER.search(got).group() == \
        _FRONTIER.search(want.stdout).group()
    a = _payload(tmp_path / "port" / "out.json", True)
    b = _payload(tmp_path / "ref" / "out.json", False)
    assert a["frontier"] == b["frontier"] and a["designs"] == b["designs"]
    assert a["meta"]["prefill"]["entries_added"] > 0


# ---------------------------------------------------------------------------
# --engine-bench against benchmarks/dse.py's engine_microbench
# ---------------------------------------------------------------------------

def _masked(bench: dict) -> dict:
    """The micro-benchmark's layout and every value that is not a time."""
    return {k: ("<t>" if k.endswith("_ms") or k.startswith("speedup")
                else _masked(v) if isinstance(v, dict) else v)
            for k, v in bench.items()}


def _times(bench: dict) -> list[float]:
    return [t for k, v in bench.items()
            for t in (_times(v) if isinstance(v, dict) else
                      [v] if k.endswith("_ms") or k.startswith("speedup")
                      else [])]


def test_engine_bench_is_the_reference_s_layout(monkeypatch):
    """engine_microbench with its design-axis section over ``tiny``: the
    reference's keys, with torch where it has jax, and its values but the
    times.  The reference's JAX engine does not run on this jax, so its
    NumPy engine stands in for it (the layout does not depend on it)."""
    import benchmarks.dse as RDSE
    import repro.core.mapper_batch as RMB
    import repro.core.perf_model_jax as RJ

    def numpy_engine(fn):
        def call(*args, engine="numpy", **kwargs):
            return fn(*args, engine="numpy" if engine == "jax" else engine,
                      **kwargs)
        return call

    best = RMB.best_mappings

    def design_loop(wl, queries, sps, hw_list, min_c=1, min_l=4, min_d=1,
                    batch=None):
        return [best(wl, queries, sps, hw) for hw in hw_list]

    axis = RDSE._design_axis_bench
    monkeypatch.setattr(RJ, "jax_available", lambda: True)
    monkeypatch.setattr(RMB, "evaluate_batch",
                        numpy_engine(RMB.evaluate_batch))
    monkeypatch.setattr(RMB, "best_mappings", numpy_engine(best))
    monkeypatch.setattr(RMB, "best_mappings_design", design_loop)
    monkeypatch.setattr(RDSE, "_design_axis_bench",
                        lambda *args: axis(*args, space_name="tiny"))
    want = RDSE.engine_microbench(repeats=1, design_axis=True)
    monkeypatch.setattr(PB, "DESIGN_AXIS_SPACE", "tiny")
    got = PB.engine_microbench(repeats=1, design_axis=True, device="cpu")
    want = json.loads(json.dumps(want).replace("jax", "torch"))
    assert _masked(got) == _masked(want)
    assert got["engines"]["torch"].keys() == {"cold_ms", "warm_ms"}
    assert got["design_batch"]["designs"] == 6
    assert all(t > 0 for t in _times(got))
    assert "design_batch" not in PB.engine_microbench(repeats=1,
                                                      device="cpu")


def test_engine_bench_tiles_pick_the_loop_s_winners():
    """The design-axis section's two paths agree: over every tile of
    ``tiny``, best_mappings_design on the CPU's torch engine picks, design
    by design, the mappings of the per-design NumPy loop."""
    from repro_torch.core import workload as PW
    from repro_torch.core.mapper import SpatialChoice
    from repro_torch.core.mapper_batch import (best_mappings,
                                               best_mappings_design)
    from repro_torch.dse.space import SPACES

    wl = PW.gemm()
    sps = [SpatialChoice(("i", "j"), (1, 1), "ij"),
           SpatialChoice(("k", "j"), (1, 1), "jk")]
    queries = [({"i": s, "j": j, "k": 2048}, 0.0)
               for s in (256, 512, 1024) for j in (2048, 6144, 8192)]
    tiles = PB.plan_tiles(list(SPACES["tiny"].enumerate()))
    assert len(tiles) > 1
    for tile in tiles:
        hws = [p.hw_config() for p in tile]
        got = best_mappings_design(wl, queries, sps, hws, engine="torch",
                                   device="cpu")
        want = [best_mappings(wl, queries, sps, hw) for hw in hws]
        assert norm(got) == norm(want)


def test_cli_engine_bench(tmp_path, capsys, monkeypatch):
    """--engine-bench with the NumPy engine records the micro-benchmark
    (its torch half on --device) and prints its lines; --engine numpy
    alone records none."""
    args = ["--space", "tiny", "--configs", "gemma_7b", "--reduced", "--seq",
            "64", "--engine", "numpy"]
    rc, out = _port(PB.main, [*args, "--engine-bench", "--out", "a.json"],
                    tmp_path, capsys, monkeypatch)
    assert rc == 0
    assert re.search(r"engine_bench numpy: warm_ms=[0-9.]+\n", out)
    assert re.search(r"engine_bench torch: cold_ms=[0-9.]+, warm_ms=[0-9.]+",
                     out)
    meta = json.loads((tmp_path / "a.json").read_text())["meta"]
    assert list(meta["engine_bench"]["engines"]) == ["numpy", "torch"]
    assert "design_batch" not in meta["engine_bench"]
    rc, _ = _port(PB.main, [*args, "-q", "--out", "b.json"], tmp_path, capsys,
                  monkeypatch)
    assert rc == 0
    assert "engine_bench" not in json.loads(
        (tmp_path / "b.json").read_text())["meta"]


def test_cli_argument_errors(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for args in (["--models", "gpt5"], ["--phases", "train"],
                 ["--seq", "x"], ["--trace-spec", "seed=0"],
                 ["--design-batch", "--strategy", "evolve"],
                 ["--objective", "serving", "--slo-ms", "0:1"]):
        with pytest.raises(SystemExit) as e:
            PB.main([*TINY, *args, "--device", "cpu"])
        assert e.value.code == 2
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# no card, no fallback; imports
# ---------------------------------------------------------------------------

def test_both_front_doors_refuse_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        GA.main([])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        GA.main(["--model", "rwkv6_7b", "--dry-run"])
    for args in ([], ["--design-batch", "--engine", "numpy"], ["--dry-run"],
                 ["--engine", "numpy", "--engine-bench"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            PB.main([*TINY, *args])
    assert list(tmp_path.iterdir()) == []


def test_front_doors_import_neither_reference_nor_jax_nor_cuda(tmp_path):
    """A fresh interpreter where importing repro, benchmarks or jax fails
    and CUDA's lazy init raises: both entry points import, a sweep runs on
    the CPU and the generator maps its pick."""
    code = (
        "import sys, torch\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('repro', 'benchmarks', 'jax'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "def boom(*a, **k): raise AssertionError('CUDA initialised')\n"
        "torch.cuda._lazy_init = boom\n"
        "torch.cuda.init = boom\n"
        "from repro_torch import generate_accelerator as GA\n"
        "from repro_torch.dse import batch_sweep as PB\n"
        f"args = {TINY!r} + ['--device', 'cpu', '--out', 's.json']\n"
        "assert PB.main(args) == 0\n"
        "assert GA.main(['--device', 'cpu', '--dse', 's.json',\n"
        "                '--pick', 'edp']) == 0\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-1] == "ok"

"""The paper's evaluation in the port (``python -m
repro_torch.paper_figures``, the twin of ``benchmarks/run.py``) against
the reference's, on the CPU: Figs. 10, 12 and 13/14 (designs generated
and costed on the host) and the micro-benchmarks, each run in this
process beside the reference's, rows equal with only the timings masked
(tests/_paper_parity.py); the functions, their order and the copied
constants; the command line's device, its exit code after a failing
function, and a fresh interpreter with the reference, jax and CUDA kept
out.  The tables and the rows that map networks are in
tests/test_torch_paper_tables.py."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import benchmarks.run as RR
import repro_torch.paper_figures as PF
from _paper_parity import FIGURES, TABLES, check_function, rows

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", FIGURES)
def test_rows_match_reference(name, monkeypatch):
    check_function(name, monkeypatch)


def test_functions_and_constants_are_the_reference_s():
    names = [f.__name__ for f in RR.ALL]
    assert [f.__name__ for f in PF.ALL] == names
    assert [f.__name__ for f in PF.QUICK] == [f.__name__ for f in RR.QUICK]
    assert sorted(FIGURES + TABLES) == sorted(names)
    assert set(PF.ON_DEVICE) <= set(PF.ALL)
    assert PF.MAPPER_BENCH_QUERIES == RR.MAPPER_BENCH_QUERIES
    assert PF.MAPPER_BENCH_FUS == RR.MAPPER_BENCH_FUS


def test_the_card_is_the_default_and_a_missing_one_raises(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--quick"], ["--only", "fig10"], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            PF.main(argv)
    for fn in PF.ON_DEVICE:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            fn()
    assert capsys.readouterr().out == ""


def test_a_failing_function_prints_the_reference_s_row_and_exits_1(
        monkeypatch, capsys):
    """The reference's ERROR= row and the run goes on; the reference exits
    0 after it, the port 1."""
    def mapper_batch_micro(*args):
        raise ValueError("no feasible mapping")

    def ok(emit):
        return lambda *args: emit("micro.ok", 0, "x=1")

    monkeypatch.setattr(sys, "argv", ["run.py", "--quick"])
    monkeypatch.setattr(RR, "QUICK", [mapper_batch_micro, ok(RR._emit)])
    assert RR.main() is None
    want = capsys.readouterr().out
    monkeypatch.setattr(PF, "QUICK", [mapper_batch_micro, ok(PF._emit)])
    assert PF.main(["--quick", "--device", "cpu"]) == 1
    got = capsys.readouterr()
    assert got.out == want
    assert rows(got.out.split("\n", 1)[1]) == [
        ("mapper_batch_micro", ["ERROR=ValueError:no feasible mapping"]),
        ("micro.ok", ["x=1"])]
    assert "Traceback" in got.err


def test_quick_run_imports_neither_reference_nor_jax_nor_cuda(tmp_path):
    """A fresh interpreter where importing repro, benchmarks or jax fails
    and CUDA's lazy init raises: --quick --device cpu prints the header
    and the reference's quick rows and exits 0."""
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
        "from repro_torch import paper_figures as PF\n"
        "rc = PF.main(['--quick', '--device', 'cpu'])\n"
        "assert not torch.cuda.is_initialized()\n"
        "sys.exit(rc)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [n for n, _ in rows("\n".join(lines[1:]))] == [
        "micro.factor_pairs_2000x", "micro.build_dataflow_200x",
        "micro.mapper_batch_36q"]

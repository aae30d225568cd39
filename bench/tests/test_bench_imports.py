"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
comparing each module's top-level name whole, so that ``repro_torch``
is not taken for ``repro``; the references load nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

from benchlib import ROOT

from bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path) -> set[str]:
    """Top-level names of the absolute imports of a source file."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    allowed = {"torch", "math", "importlib", "__future__"}
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert _imports(path) <= allowed, path
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import bench.reference as R; "
            "[R.load(n) for n in ('dense_gqa', 'rwkv6', 'adamw', 'feed')]; "
            "import json; print(json.dumps(sorted({{m.split('.')[0] "
            "for m in sys.modules}})))").format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_a_run_loads_no_jax_and_names_are_compared_whole():
    code = ("import sys, json; sys.path[0:0] = [{src!r}, {root!r}]; "
            "from pathlib import Path; from bench import harness; "
            "line = harness.run(Path({root!r}), 'nemo_serve', 3, 0.2, "
            "False, device='cpu', smoke=True)[0]; "
            "print(json.dumps([line['correct'], "
            "sorted({{m.split('.')[0] for m in sys.modules}})]))").format(
                root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    correct, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct
    assert "repro_torch" in loaded and not set(loaded) & FORBIDDEN


def test_the_check_flags_the_jax_package_but_not_the_port(monkeypatch):
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax", "repro"]

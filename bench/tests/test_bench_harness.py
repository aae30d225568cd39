"""The harness on the CPU at the smoke sizes: the result line's shape, the
benchmark file against the contract's rules, a run without a card, and
a cell, a configuration and a metric added as files only."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchlib import CELLS, ROOT, run_smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contract_line(workload, trace):
    line = run_smoke(workload, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    bench = _bench()
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
    if trace:
        # no device: no device metric is read on the CPU
        assert line["metrics"] == {}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"]
        assert "peak_mem_gib" not in line["metrics"]        # no card


def test_the_benchmark_file_keeps_the_contracts_rules():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layer = {m["name"]: m for m in bench["per_layer"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = set()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json") \
            .is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in list(e2e.values()) + list(layer.values()):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer.values():
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for cell in cells:
        mine = [n for n, m in e2e.items()
                if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m["workloads"] for m in layer.values())
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_serve_readers_count_the_call_under_way_in_part():
    from bench import harness
    calls = [{"batch": 2, "output": 10, "start_s": 0.0, "latency_s": 4.0},
             {"batch": 2, "output": 30, "start_s": 4.0, "latency_s": 2.0},
             {"batch": 2, "output": 40, "start_s": 6.0, "latency_s": 8.0}]
    rec = {"calls": calls, "window_s": 10.0}
    # 20 + 60 tokens whole, and half of the last call's 80
    assert harness.reader(ROOT, "serve_tok_per_s").read(rec) == 12.0
    # the last call ends after the close: only the first two are complete
    p95 = harness.reader(ROOT, "serve_latency_p95_ms").read(rec)
    assert p95 == 4000.0


def test_profile_slices_reads_the_slice_traced_on_the_device_alone():
    from bench import devtrace
    ran = []
    out, rec = devtrace.profile_slices(lambda k: ran.append(k) or k,
                                       lambda: None)
    assert ran == out == [0, 1, 2]
    assert {"untraced_s", "host_traced_s", "busy_s", "window_s",
            "device_ops", "idle_gaps"} <= set(rec)


def test_the_gc_log_records_each_collection():
    import gc

    from bench.entries.train import GcLog
    log = GcLog()
    gc.callbacks.append(log)
    try:
        gc.collect(1)
    finally:
        gc.callbacks.remove(log)
    events = log.take()
    assert 1 in [g for g, _ in events] and all(t >= 0 for _, t in events)
    assert log.take() == []


def test_a_train_run_logs_its_steps_collections():
    from bench import harness
    _, summary = harness.run(ROOT, "rwkv6_train", 7, 0.2, False,
                             device="cpu", smoke=True)
    assert len(summary["gc_ms"]) == len(summary["steps_s"])


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                          "--workload", "nemo_serve", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_configuration_and_metric_added_as_files(tmp_path):
    """In a copy: a new configuration, traffic mix, cell and two metrics,
    added as new files and new BENCHMARK.json entries, are found and run;
    no file of bench/ that was there is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = _digests(tmp_path)

    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "mistral_nemo_12b_pp10.json")
                     .read_text())
    cfg["name"] = "dense_other"
    (b / "configs" / "dense_other.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "serve_azure_conv.json")
                         .read_text())
    traffic["smoke"]["batch"] = 2
    traffic["smoke"]["lengths"]["seed"] = 99
    (b / "traffic" / "serve_closed2.json").write_text(json.dumps(traffic))
    (b / "limits" / "other_serve.json").write_text(json.dumps(
        {"full": {"served_gap": 1.0}, "smoke": {"served_gap": 0.05}}))
    (b / "metrics" / "serve_requests_per_s.py").write_text(
        "def read(rec):\n"
        "    calls = rec.get('calls')\n"
        "    if not calls:\n"
        "        return None\n"
        "    return sum(c['batch'] for c in calls) / rec['window_s']\n")
    (b / "metrics" / "calls.serve.py").write_text(
        "def read(rec):\n"
        "    return float(len(rec['calls'])) if rec.get('calls') else None\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dense_other", "source": cfg["source"],
                             "file": "bench/configs/dense_other.json",
                             "reduced": ["num_hidden_layers"],
                             "why": "a second dense cell"})
    bench["workloads"].append({"name": "other_serve", "config": "dense_other",
                               "traffic": "serve_closed2", "chips": 1,
                               "why": "batches of 2"})
    bench["end_to_end"].append({"name": "serve_requests_per_s",
                                "unit": "requests/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["other_serve"]})
    bench["per_layer"].append({"name": "calls.serve", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving loop",
                               "moves": "serve_requests_per_s",
                               "workloads": ["other_serve"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    line = run_smoke("other_serve", root=tmp_path)
    assert line["correct"] and line["attempted"] % 2 == 0
    assert set(line["metrics"]) == {"serve_requests_per_s", "setup_s"}
    traced = run_smoke("other_serve", root=tmp_path, trace=True)
    assert traced["metrics"]["calls.serve"]["value"] >= 2
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

"""Run one cell once and build its result line.

A cell is found by name: its entry in ``BENCHMARK.json`` names the
configuration (``configs/<name>.json``: the published keys, the port's
config id and overrides, the reference) and the traffic
(``traffic/<name>.json``, whose ``entry`` names ``entries/<entry>.py``);
its correctness limits are ``limits/<cell>.json``; each metric that the
cell reports is read from the run's record by ``metrics/<metric>.py``.

The record an entry returns (what the readers read):

- ``setup_s``, ``window_s``, ``peak_bytes``, ``attempted``, ``failed``,
  ``platform`` ("gpu" or "cpu"), ``arch`` and ``hp`` (the published keys);
- serve entries: ``calls``, one {prompt, output, batch, start_s (from the
  window's start), latency_s, traced} a ``generate`` call; ``window_s``
  is ``--seconds``, the close;
- train entries: ``steps``, one {seconds, tokens, feed_s, traced} a step
  of the window;
- ``trace`` (``--trace 1`` only): :func:`bench.devtrace.reduce`'s record of
  the profiled slice, with ``slice`` saying what it held;
- ``checks``: {name: (value, limit)}, each correct when value <= limit.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import arch as arch_mod
from . import reference as ref_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    """JAX, its libraries or the JAX package were loaded."""


@dataclasses.dataclass
class Cell:
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    config: dict
    hp: dict
    traffic: dict
    limits: dict
    arch: object
    ref: object
    cfg: object

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.max_memory_allocated(self.device)
        return 0

    def note(self, what: str) -> None:
        """A progress line on standard error, with the seconds since the
        process started."""
        print(f"[{time.perf_counter() - self.t_start:.1f} s] {what}",
              file=sys.stderr, flush=True)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def port_config(config: dict, smoke: bool):
    """The port's ``ModelConfig`` for a configuration file: its config id
    (the smoke preset for the CPU tests), with the file's overrides."""
    from repro_torch.configs import get_config
    port = config["smoke"]["port"] if smoke else config["port"]
    cfg = get_config(port["id"], reduced=smoke)
    return dataclasses.replace(cfg, **port.get("overrides", {}))


def load_cell(root: Path, workload: str, seed: int, seconds: float,
              trace: bool, device, smoke: bool = False,
              t_start: float | None = None) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    w = _find(bench["workloads"], workload, "workload")
    c = _find(bench["configs"], w["config"], "configuration")
    config = _read(root / c["file"])
    hp = {k: v for k, v in config.items() if k != "smoke"}
    if smoke:
        hp.update(config["smoke"]["published"])
    traffic = _read(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = _read(root / "bench" / "limits" / f"{workload}.json")
    limits = limits["smoke" if smoke else "full"]
    if smoke:
        traffic = {**traffic, **traffic.get("smoke", {})}
    arch = arch_mod.load(config["reference"])
    cfg = port_config(config, smoke)
    wrong = [(k, a, b) for k, a, b in arch.port_pairs(hp, cfg) if a != b]
    if wrong:
        raise ValueError(f"{config['name']}: the port's config differs from "
                         f"the configuration's keys: {wrong}")
    return Cell(seed=int(seed), seconds=float(seconds), trace=bool(trace),
                device=torch.device(device),
                t_start=time.perf_counter() if t_start is None else t_start,
                config=config, hp=hp, traffic=traffic, limits=limits,
                arch=arch, ref=ref_mod.load(config["reference"]), cfg=cfg)


def _applies(m: dict, cell: str, bench: dict) -> bool:
    if "workloads" in m:
        return cell in m["workloads"]
    if "moves" not in m:                     # an end-to-end metric
        return True
    moved = _find(bench["end_to_end"], m["moves"], "end-to-end metric")
    return _applies(moved, cell, bench)


def reader(root: Path, name: str):
    """``metrics/<name>.py``'s module (names may hold dots)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics(root: Path, cell: str, rec: dict, trace: bool) -> dict:
    bench = _read(root / "BENCHMARK.json")
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not _applies(m, cell, bench):
            continue
        v = reader(root, m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def judged(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not hold:
    JAX, its libraries and the JAX package (whole names: ``repro_torch``
    is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_info(cell: Cell, rec: dict) -> dict:
    if cell.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(cell.device),
                "count": 1, "memory_peak_bytes": int(rec["peak_bytes"])}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(rec["peak_bytes"])}
    tr = rec.get("trace")
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", smoke: bool = False,
        t_start: float | None = None) -> dict:
    """One run of ``workload``: (the result line as a dict, its ``checks``
    last; a summary for the log).  Raises if a forbidden module was
    loaded."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(root, workload, seed, seconds, trace, device, smoke,
                     t_start)
    entry = importlib.import_module(f"bench.entries.{cell.traffic['entry']}")
    rec = entry.run(cell)
    rec.update(platform="gpu" if cell.device.type == "cuda" else "cpu",
               arch=cell.config["reference"], hp=cell.hp)
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules("modules of JAX or the JAX package were "
                               "loaded: " + ", ".join(loaded))
    checks = rec["checks"]
    line = {"correct": judged(checks) and rec["failed"] == 0,
            "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics(root, workload, rec, trace),
            "device": device_info(cell, rec)}
    if rec.get("trace") is not None:
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line, summary(rec)


def summary(rec: dict) -> dict:
    """What a run did, for its log: each call's or step's seconds, the
    window, the set-up and the check's readings."""
    out = {"setup_s": rec["setup_s"], "window_s": rec["window_s"],
           "readings": rec.get("readings")}
    if "calls" in rec:
        out["calls"] = [[c["prompt"], c["output"], round(c["start_s"], 4),
                         round(c["latency_s"], 4)] for c in rec["calls"]]
    if "steps" in rec:
        out["steps_s"] = [round(s["seconds"], 4) for s in rec["steps"]]
        out["feed_ms"] = [round(s["feed_s"] * 1e3, 3) for s in rec["steps"]]
        out["gc_ms"] = [[[g, round(t * 1e3, 3)] for g, t in s["gc"]]
                        for s in rec["steps"]]
    tr = rec.get("trace")
    if tr is not None:
        out["slice"] = {k: tr.get(k) for k in ("window_s", "busy_s",
                                               "untraced_s", "host_traced_s")}
        out["slice"]["events"] = len(tr["device_events"])
    return out

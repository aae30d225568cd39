"""Slices of a run under ``torch.profiler``, reduced to the record the
per-layer readers read: the slice's host-clock length, the device events
(name, start, duration; kernels, copies and sets, those a CUDA graph
replays included), the device-busy time (the union of those events), the
device operations that took most time and the longest idle gaps, each
named by the host operation under way.

The profiler's record of every host operation stretches a slice of many
small kernels, so :func:`profile_slices` reads the metrics from a slice
traced on the device alone, names the idle gaps from a like slice traced
with the host's operations, and times a third like slice untraced to show
the stretch.
"""

from __future__ import annotations

import time

import torch


def _kineto(prof):
    """[(name, is_device, start_ns, dur_ns)] of every event of the trace."""
    dev = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == dev, e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def union(intervals) -> list[tuple[int, int]]:
    """Merged [start, end) of ``(start, duration)`` intervals."""
    merged: list[list[int]] = []
    for s, d in sorted(intervals):
        e = s + d
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def traced(fn, sync, host: bool = True):
    """``fn()`` under the profiler, ``sync()`` before and after; ``host``:
    the host's operations recorded too (on a machine without a card they
    always are).  Returns (fn's result, record)."""
    act = torch.profiler.ProfilerActivity
    activities = [act.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(act.CUDA)
    else:
        activities = [act.CPU]
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    return out, reduce(_kineto(prof), window_s)


def profile_slices(run, sync) -> tuple[list, dict]:
    """``run(k)`` runs the k-th of three like slices (the same shapes and
    work).  Slice 0 runs untraced, slice 1 under the profiler on the
    device alone, slice 2 with the host's operations too.  Returns (the
    three results, slice 1's record with slice 2's idle gaps in place of
    its own, and ``untraced_s`` and ``host_traced_s``: slices 0's and 2's
    host-clock lengths)."""
    sync()
    t0 = time.perf_counter()
    first = run(0)
    sync()
    untraced_s = time.perf_counter() - t0
    second, rec = traced(lambda: run(1), sync, host=False)
    third, named = traced(lambda: run(2), sync, host=True)
    rec["idle_gaps"] = named["idle_gaps"]
    rec["untraced_s"] = untraced_s
    rec["host_traced_s"] = named["window_s"]
    return [first, second, third], rec


def reduce(events, window_s: float, top: int = 10) -> dict:
    device = [(n, s, d) for n, is_dev, s, d in events if is_dev]
    host = [(n, s, d) for n, is_dev, s, d in events if not is_dev]
    busy = union((s, d) for _, s, d in device)
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name: dict[str, int] = {}
    for n, _, d in device:
        by_name[n] = by_name.get(n, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps inside the device's span, plus the lead-in from the
    # slice's first host event to its first device event
    gaps = []
    if busy:
        start = min([s for _, s, _ in host] + [busy[0][0]])
        prev = start
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = e
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "device_events": device,
        "device_ops": [[n, d / 1e9] for n, d in ops],
        "idle_gaps": [[_host_at(host, a, b), (b - a) / 1e9]
                      for a, b in gaps],
    }


def _host_at(host, a: int, b: int) -> str:
    """The innermost host operation under way at the middle of [a, b)."""
    mid = (a + b) // 2
    best = None
    for n, s, d in host:
        if s <= mid < s + d and (best is None or d < best[1]):
            best = (n, d)
    return best[0] if best else "host (no traced operation)"

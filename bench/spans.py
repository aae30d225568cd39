"""The program's own spans and counters (``repro_torch.obs``), for the
per-layer readers; a program without them gives none, and its readers
read ``None``.

The program stamps its spans on the epoch clock, as ``torch.profiler``
stamps its host and device events, so the spans and the traced slice's
device events (``rec["trace"]["device_events"]``: name, start ns,
duration ns) lie on one time line.  A span timed on the device holds in
its ``args`` ``device_ms`` (its entry to its exit event), ``device_at_ms``
(its root's entry event to its exit event; an instant's one event) and
``device_entry_ts`` (µs: the epoch time just after its entry event was
recorded).  The harness synchronises before each slice, so a root's entry
event runs on an idle device at its ``device_entry_ts``: that places its
tree's device times on the shared clock.
"""

from __future__ import annotations

from typing import NamedTuple

from bench import devtrace


class Tree(NamedTuple):
    """A root span, every event under it (the root first, then in order
    of start), and the ns of the slice's device-busy time inside the
    root's host interval."""
    root: dict
    events: list
    overlap: int


def events() -> list[dict] | None:
    """The program's recorded events, device times resolved, the buffer
    kept; None where the program cannot read them so."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    read = getattr(trace, "read_events", None)
    return read() if read is not None else None


def counters() -> dict:
    """The program's counters (``repro_torch.obs.METRICS``)."""
    try:
        from repro_torch.obs import METRICS
    except ImportError:
        return {}
    return METRICS.snapshot()["counters"]


def busy(rec) -> list[tuple[int, int]]:
    """The traced slice's device-busy intervals, [start, end) ns."""
    return devtrace.union((s, d) for _, s, d in rec["trace"]["device_events"])


def _overlap(lo: float, hi: float, intervals) -> float:
    return sum(max(0.0, min(hi, e) - max(lo, s)) for s, e in intervals)


def traced(rec, name: str) -> list[Tree]:
    """The traced slice's trees under roots named ``name``: every such
    root whose host interval holds at least half as much of the slice's
    device-busy time as the root that holds most, in order of start; []
    off the card, without a trace, or where no such root overlaps it."""
    if rec.get("platform") != "gpu" or not rec.get("trace"):
        return []
    evs = events()
    if not evs or not rec["trace"]["device_events"]:
        return []
    by_id = {e["id"]: e for e in evs if "id" in e}
    roots = [e for e in evs if e.get("name") == name and e.get("ph") == "X"
             and "id" in e and e.get("parent") is None]
    on = busy(rec)
    held = [_overlap(r["ts"] * 1e3, (r["ts"] + r["dur"]) * 1e3, on)
            for r in roots]
    if not held or max(held) <= 0:
        return []
    chosen = {r["id"]: h for r, h in zip(roots, held)
              if h >= 0.5 * max(held)}
    members: dict[str, list] = {k: [] for k in chosen}
    for e in evs:
        top = e
        while top is not None and top.get("parent") is not None:
            top = by_id.get(top["parent"])
        if top is not None and top.get("id") in members \
                and e is not top:
            members[top["id"]].append(e)
    return sorted((Tree(by_id[k], [by_id[k]] + sorted(
        members[k], key=lambda e: e["ts"]), int(chosen[k]))
        for k in chosen), key=lambda t: t.root["ts"])


def call(rec) -> Tree | None:
    """The traced ``generate`` call: the ``engine.generate`` tree that
    holds most of the slice's device-busy time, or None."""
    trees = traced(rec, "engine.generate")
    return max(trees, key=lambda t: t.overlap) if trees else None


def named(tree: Tree, name: str) -> list[dict]:
    return [e for e in tree.events if e["name"] == name]


def device_ns(tree: Tree, at_ms: float) -> float | None:
    """Epoch ns of a point ``at_ms`` after the root's entry event, or None
    where the root was not timed on the device."""
    ts = tree.root.get("args", {}).get("device_entry_ts")
    return None if ts is None else ts * 1e3 + at_ms * 1e6


def idle(rec, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi) ns with no device event of the slice
    running."""
    out, prev = [], lo
    for s, e in busy(rec):
        if e <= prev:
            continue
        if s >= hi:
            break
        if s > prev:
            out.append((prev, s))
        prev = e
    if prev < hi:
        out.append((prev, hi))
    return out


def call_idle(rec, tree: Tree) -> list[tuple[float, float]] | None:
    """The device's idle intervals from the call's entry to the device's
    end of the call (its root's exit event), or None where the root was
    not timed on the device."""
    at = tree.root.get("args", {}).get("device_at_ms")
    end = None if at is None else device_ns(tree, at)
    if end is None:
        return None
    return idle(rec, tree.root["ts"] * 1e3, end)


def per_step(rec, name: str) -> float | None:
    """Mean over the slice's ``train.step`` trees of the device ms of
    their spans named ``name``; None where a tree has none timed."""
    trees = traced(rec, "train.step")
    totals = []
    for t in trees:
        ms = [e.get("args", {}).get("device_ms") for e in named(t, name)]
        if not ms or None in ms:
            return None
        totals.append(sum(ms))
    return sum(totals) / len(totals) if totals else None

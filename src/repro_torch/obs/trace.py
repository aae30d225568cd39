"""Structured tracing (a copy of the reference's ``repro.obs.trace``):
context-manager/decorator spans emitting Chrome trace-event JSON (the
``traceEvents`` array format that chrome://tracing and
https://ui.perfetto.dev load directly).

Design constraints, in order:

1. **Zero overhead when disabled.**  ``span(...)`` always measures wall time
   (two ``perf_counter`` calls — the duration is program state, e.g.
   ``SearchResult.wall_s``), but allocates and records an event dict only
   while tracing is enabled.
2. **Process-safe merge.**  Each process traces into its own in-memory
   buffer; the DSE worker pool ships ``drain_events()`` payloads back with
   each result and the parent ``merge_events()`` them, so one trace file
   covers the whole pool.  Events carry the recording ``pid``/``tid``, so
   Perfetto renders one track per worker.
3. **Determinism where it matters.**  Wall timestamps are inherently
   run-dependent; :func:`span_counts` projects a trace onto its
   deterministic skeleton (span name → occurrence count), which is what the
   workers=1 vs workers=N equivalence test asserts.

Usage::

    from repro_torch.obs import enable_tracing, save_trace, span

    enable_tracing()
    with span("dse.sweep", space="tiny"):
        ...
    save_trace("trace.json")

``span`` also works as a decorator: ``@span("mapper.solve")``.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

__all__ = ["Span", "Tracer", "span", "instant", "enable_tracing",
           "disable_tracing", "tracing_enabled", "drain_events",
           "merge_events", "save_trace", "span_counts", "trace_preamble"]


class Tracer:
    """In-memory trace-event buffer for one process (thread-safe appends)."""

    def __init__(self) -> None:
        self._events: list[dict] = []
        self._lock = threading.Lock()

    def record(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def drain(self) -> list[dict]:
        """Return buffered events and clear the buffer."""
        with self._lock:
            out, self._events = self._events, []
        return out

    def merge(self, events: list[dict]) -> None:
        """Adopt events recorded elsewhere (a pool worker)."""
        with self._lock:
            self._events.extend(events)

    def __len__(self) -> int:
        return len(self._events)


_TRACER = Tracer()
_ENABLED = False


def enable_tracing() -> None:
    """Start buffering span events in this process."""
    global _ENABLED
    _ENABLED = True


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def tracing_enabled() -> bool:
    return _ENABLED


def drain_events() -> list[dict]:
    """Buffered events of this process's tracer (buffer is cleared) — the
    worker side of the pool merge."""
    return _TRACER.drain()


def merge_events(events: list[dict]) -> None:
    """Adopt events drained from another process — the parent side."""
    if events:
        _TRACER.merge(events)


class Span:
    """One timed region.  Context manager and decorator.

    Always measures (``duration_s`` is valid whether or not tracing is
    enabled); records a Chrome complete event (``ph: "X"``, microsecond
    timestamps) only when tracing is on at entry.
    """

    __slots__ = ("name", "cat", "args", "t0", "t1", "_record")

    def __init__(self, name: str, cat: str = "repro_torch", **args):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0
        self._record = False

    @property
    def duration_s(self) -> float:
        return (self.t1 or time.perf_counter()) - self.t0

    def __enter__(self) -> "Span":
        self._record = _ENABLED
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = time.perf_counter()
        if self._record:
            ev = {"name": self.name, "cat": self.cat, "ph": "X",
                  "ts": self.t0 * 1e6, "dur": (self.t1 - self.t0) * 1e6,
                  "pid": os.getpid(),
                  "tid": threading.get_ident() & 0xFFFFFFFF}
            if self.args:
                ev["args"] = {k: _jsonable(v) for k, v in self.args.items()}
            if exc_type is not None:
                ev.setdefault("args", {})["error"] = exc_type.__name__
            _TRACER.record(ev)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with Span(self.name, self.cat, **self.args):
                return fn(*a, **kw)
        return wrapped


def span(name: str, cat: str = "repro_torch", **args) -> Span:
    """A new :class:`Span` — ``with span("phase", key=...) as sp: ...``."""
    return Span(name, cat, **args)


def instant(name: str, cat: str = "repro_torch", **args) -> None:
    """Point-in-time marker (Chrome ``ph: "i"`` instant event)."""
    if not _ENABLED:
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "p",
          "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
          "tid": threading.get_ident() & 0xFFFFFFFF}
    if args:
        ev["args"] = {k: _jsonable(v) for k, v in args.items()}
    _TRACER.record(ev)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def trace_preamble() -> list[dict]:
    """Metadata events naming this process's track in the viewer."""
    return [{"name": "process_name", "ph": "M", "pid": os.getpid(),
             "args": {"name": "repro_torch"}}]


def save_trace(path: str, extra_events: list[dict] | None = None) -> dict:
    """Write the buffered events as a Chrome trace-event JSON file.

    The payload is the standard ``{"traceEvents": [...]}`` object; load it
    in Perfetto (https://ui.perfetto.dev → "Open trace file") or
    chrome://tracing.  The buffer is *not* cleared, so a CLI can save and
    keep tracing.  Returns the payload.
    """
    events = trace_preamble() + list(_TRACER._events)
    if extra_events:
        events += list(extra_events)
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def span_counts(events: list[dict] | None = None) -> dict[str, int]:
    """Deterministic projection of a trace: span name → occurrence count.

    Timestamps and pids vary run to run; the *set of spans* a given sweep
    records must not — this is what the workers=1 vs workers=N trace
    equivalence test compares.
    """
    if events is None:
        events = _TRACER._events
    out: dict[str, int] = {}
    for e in events:
        if e.get("ph") in ("X", "i"):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return dict(sorted(out.items()))

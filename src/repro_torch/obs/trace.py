"""Structured tracing (grown from the reference's ``repro.obs.trace``):
context-manager/decorator spans emitting Chrome trace-event JSON (the
``traceEvents`` array format that chrome://tracing and
https://ui.perfetto.dev load directly), on the clock ``torch.profiler``
stamps its events with, so that a span can be laid over a profiler's
device trace.

Design constraints, in order:

1. **Zero overhead when not recording.**  ``span(...)`` always measures
   wall time (two ``perf_counter`` calls — the duration is program state,
   e.g. ``SearchResult.wall_s``) and asks once whether to record; it
   allocates and records an event dict, and times device work, only while
   recording.
2. **One clock.**  A recorded event's ``ts`` and ``dur`` (microseconds) are
   read from the epoch clock (``time.time_ns``), the clock of
   ``torch.profiler``'s host and device events, in every process.
3. **Links.**  A recorded span carries an ``id`` unique across processes,
   its ``parent`` (the enclosing recorded span of this thread, kept in a
   context variable) and a ``rid`` (request id) given at the root and
   inherited by its children.
4. **Device time.**  ``span(..., device=True)`` records a CUDA timing
   event on the current stream at entry and at exit (never while the
   stream is being captured into a graph); the pair is resolved into
   ``args`` (``device_ms``; ``device_at_ms`` from the root's entry event;
   ``device_entry_ts``, the epoch time just after the entry event was
   recorded) only when the events are read.
5. **Process-safe merge.**  Each process traces into its own in-memory
   buffer; the DSE worker pool ships ``drain_events()`` payloads back with
   each result and the parent ``merge_events()`` them, so one trace file
   covers the whole pool.  Events carry the recording ``pid``/``tid``, so
   Perfetto renders one track per worker.
6. **Determinism where it matters.**  Wall timestamps are inherently
   run-dependent; :func:`span_counts` projects a trace onto its
   deterministic skeleton (span name → occurrence count), which is what the
   workers=1 vs workers=N equivalence test asserts.

Recording happens after :func:`enable_tracing`, or while a
``torch.profiler`` session is active on the thread, so a profiled region
gets the program's spans with no flag of its own.  Usage::

    from repro_torch.obs import enable_tracing, save_trace, span

    enable_tracing()
    with span("dse.sweep", space="tiny"):
        ...
    save_trace("trace.json")

``span`` also works as a decorator: ``@span("mapper.solve")``.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

__all__ = ["Span", "Tracer", "span", "instant", "enable_tracing",
           "disable_tracing", "tracing_enabled", "recording", "read_events",
           "drain_events", "merge_events", "save_trace", "span_counts",
           "counter_events", "trace_preamble"]


class Tracer:
    """In-memory trace-event buffer for one process (thread-safe appends).
    Events holding CUDA events wait in ``_pending`` until read."""

    def __init__(self) -> None:
        self._events: list[dict] = []
        self._pending: list[dict] = []
        self._lock = threading.Lock()

    def record(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)
            if "_dev" in event:
                self._pending.append(event)

    def _resolve(self) -> None:
        for ev in self._pending:
            _resolve_device(ev)
        self._pending = []

    def read(self) -> list[dict]:
        """The buffered events, device times resolved (buffer kept)."""
        with self._lock:
            self._resolve()
            return list(self._events)

    def drain(self) -> list[dict]:
        """Return buffered events and clear the buffer."""
        with self._lock:
            self._resolve()
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
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Link(NamedTuple):
    """What a recorded span hands its children: its id, the request id and
    the root's entry CUDA event (or None)."""
    id: str
    rid: object
    root_event: object


_CURRENT: contextvars.ContextVar[_Link | None] = contextvars.ContextVar(
    "repro_torch_span", default=None)
_IDS = itertools.count(1)


def enable_tracing() -> None:
    """Start buffering span events in this process."""
    global _ENABLED
    _ENABLED = True


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def tracing_enabled() -> bool:
    return _ENABLED


def recording() -> bool:
    """Whether a span entered now is recorded: after
    :func:`enable_tracing`, or while a ``torch.profiler`` session is active
    on this thread."""
    return _ENABLED or _profiler_enabled()


def read_events() -> list[dict]:
    """This process's buffered events, device times resolved; the buffer
    is kept, so several readers can share it."""
    return _TRACER.read()


def drain_events() -> list[dict]:
    """Buffered events of this process's tracer (buffer is cleared) — the
    worker side of the pool merge."""
    return _TRACER.drain()


def merge_events(events: list[dict]) -> None:
    """Adopt events drained from another process — the parent side."""
    if events:
        _TRACER.merge(events)


def _device_event():
    """A CUDA timing event recorded now on the current stream, or None
    where CUDA is not in use or the stream is being captured."""
    if not torch.cuda.is_initialized() \
            or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _resolve_device(ev: dict) -> None:
    """Turn an event's pending CUDA events into milliseconds in its
    ``args``: ``device_ms`` from its entry to its exit event,
    ``device_at_ms`` from its root's entry event to its exit event (an
    instant's one event)."""
    start, end, root = ev.pop("_dev")
    if end is None:
        return
    end.synchronize()
    args = ev.setdefault("args", {})
    if start is not None:
        args["device_ms"] = start.elapsed_time(end)
    if root is not None:
        args["device_at_ms"] = root.elapsed_time(end)


def _open(name: str, cat: str, ph: str, rid, device: bool):
    """A recorded event's dict at its start, and the link its children
    inherit."""
    up = _CURRENT.get()
    ev = {"name": name, "cat": cat, "ph": ph, "ts": time.time_ns() / 1e3,
          "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFFFFFF,
          "id": f"{os.getpid()}.{next(_IDS)}",
          "parent": up.id if up is not None else None,
          "rid": _jsonable(rid if rid is not None or up is None else up.rid)}
    dev = _device_event() if device else None
    root = up.root_event if up is not None else dev
    if dev is not None:
        ev["_dev"] = [dev, None, root]
        ev["args"] = {"device_entry_ts": time.time_ns() / 1e3}
    return ev, _Link(ev["id"], ev["rid"], root)


class Span:
    """One timed region.  Context manager and decorator.

    Always measures (``duration_s`` is valid whether or not recording);
    records a Chrome complete event (``ph: "X"``, microsecond timestamps
    on the epoch clock, with ``id``, ``parent`` and ``rid``) only when
    :func:`recording` at entry.  ``rid``: the request id of a root span
    (children inherit their root's).  ``device``: time the device work
    queued on the current CUDA stream inside the span too.
    """

    __slots__ = ("name", "cat", "args", "rid", "device", "t0", "t1", "_ev",
                 "_token")

    def __init__(self, name: str, cat: str = "repro_torch", *, rid=None,
                 device: bool = False, **args):
        self.name = name
        self.cat = cat
        self.args = args
        self.rid = rid
        self.device = device
        self.t0 = 0.0
        self.t1 = 0.0
        self._ev = None

    @property
    def duration_s(self) -> float:
        return (self.t1 or time.perf_counter()) - self.t0

    def __enter__(self) -> "Span":
        if _ENABLED or _profiler_enabled():
            self._ev, link = _open(self.name, self.cat, "X", self.rid,
                                   self.device)
            self._token = _CURRENT.set(link)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = time.perf_counter()
        ev = self._ev
        if ev is None:
            return
        self._ev = None
        if "_dev" in ev:
            ev["_dev"][1] = _device_event()
        ev["dur"] = time.time_ns() / 1e3 - ev["ts"]
        _CURRENT.reset(self._token)
        if self.args:
            ev.setdefault("args", {}).update(
                (k, _jsonable(v)) for k, v in self.args.items())
        if exc_type is not None:
            ev.setdefault("args", {})["error"] = exc_type.__name__
        _TRACER.record(ev)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with Span(self.name, self.cat, rid=self.rid, device=self.device,
                      **self.args):
                return fn(*a, **kw)
        return wrapped


def span(name: str, cat: str = "repro_torch", *, rid=None,
         device: bool = False, **args) -> Span:
    """A new :class:`Span` — ``with span("phase", key=...) as sp: ...``."""
    return Span(name, cat, rid=rid, device=device, **args)


def instant(name: str, cat: str = "repro_torch", *, device: bool = False,
            **args) -> None:
    """Point-in-time marker (Chrome ``ph: "i"`` instant event), recorded
    only when :func:`recording`.  ``device``: a CUDA event on the current
    stream marks the point on the device too (``device_at_ms``)."""
    if not recording():
        return
    ev, link = _open(name, cat, "i", None, False)
    ev["s"] = "p"
    if device:
        dev = _device_event()
        if dev is not None:
            ev["_dev"] = [None, dev, link.root_event]
    if args:
        ev.setdefault("args", {}).update(
            (k, _jsonable(v)) for k, v in args.items())
    _TRACER.record(ev)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def counter_events(counters: dict) -> list[dict]:
    """Chrome counter events (``ph: "C"``), one a counter, stamped now:
    ``counters`` (name → value, as ``METRICS.snapshot()["counters"]``)
    as tracks of a trace file."""
    ts = time.time_ns() / 1e3
    return [{"name": k, "ph": "C", "ts": ts, "pid": os.getpid(),
             "args": {"value": v}} for k, v in counters.items()]


def trace_preamble() -> list[dict]:
    """Metadata events naming this process's track in the viewer."""
    return [{"name": "process_name", "ph": "M", "pid": os.getpid(),
             "args": {"name": "repro_torch"}}]


def save_trace(path: str, extra_events: list[dict] | None = None) -> dict:
    """Write the buffered events as a Chrome trace-event JSON file, device
    times resolved.

    The payload is the standard ``{"traceEvents": [...]}`` object; load it
    in Perfetto (https://ui.perfetto.dev → "Open trace file") or
    chrome://tracing.  The buffer is *not* cleared, so a CLI can save and
    keep tracing.  Returns the payload.
    """
    events = trace_preamble() + read_events()
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

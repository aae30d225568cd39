"""Metrics registry: counters, gauges and histograms for the DSE's hot
paths (a copy of the reference's ``repro.obs.metrics``), dumped into the
``metrics`` section of every sweep JSON :mod:`repro_torch.dse.report`
writes, next to the provenance record.

The registry is a process-global name → metric map.  Incrementing a counter
is one dict lookup plus a float add — cheap enough to live inside the
mapping-search hot path.  When metrics are disabled
(``set_metrics_enabled(False)``) the registry hands out a shared no-op
metric, so instrumented code needs no conditionals.

Worker processes of a DSE sweep carry their own registry; workers return
``METRICS.drain()`` snapshots with each result and the parent
``METRICS.merge()`` them (counters/histograms add, gauges keep the max), so
the dumped metrics cover the whole pool.

Metric names are dotted, ``subsystem.event``, and are the reference's
(``dse.designs_scored``, ``mapper_cache.hits``, ...), so one name reads the
same counter in either package's artifacts.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "METRICS",
           "set_metrics_enabled", "metrics_enabled"]


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def as_number(self) -> float:
        v = self.value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-set value (also tracks the max ever set — the merge key)."""

    __slots__ = ("value", "max")

    def __init__(self) -> None:
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if v > self.max:
            self.max = float(v)


class Histogram:
    """Streaming summary: count / sum / min / max (no buckets — the bench
    artifacts want compact scalars, not distributions)."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def as_dict(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": 0.0}
        return {"count": self.count, "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min, "max": self.max}


class _NullMetric:
    """Shared no-op standing in for every metric while disabled."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL = _NullMetric()


class Registry:
    """Name → metric map with snapshot/merge/drain for the worker pool."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()
        self.enabled = True

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL  # type: ignore[return-value]
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL  # type: ignore[return-value]
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NULL  # type: ignore[return-value]
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def snapshot(self) -> dict:
        """JSON-ready view: the ``metrics`` section of a sweep JSON."""
        return {
            "counters": {k: v.as_number()
                         for k, v in sorted(self._counters.items())},
            "gauges": {k: {"value": v.value, "max": v.max}
                       for k, v in sorted(self._gauges.items())},
            "histograms": {k: v.as_dict()
                           for k, v in sorted(self._histograms.items())},
        }

    def drain(self) -> dict:
        """Snapshot + reset — the worker side of the pool merge."""
        snap = self.snapshot()
        self.reset()
        return snap

    def merge(self, snap: dict) -> None:
        """Adopt a drained snapshot: counters and histogram moments add,
        gauges keep the maximum (merge order across workers must not change
        the result)."""
        for k, v in snap.get("counters", {}).items():
            self.counter(k).inc(v)
        for k, v in snap.get("gauges", {}).items():
            g = self.gauge(k)
            if isinstance(g, Gauge) and v["max"] >= g.max:
                g.set(v["max"])
        for k, v in snap.get("histograms", {}).items():
            h = self.histogram(k)
            if isinstance(h, Histogram) and v.get("count"):
                h.count += v["count"]
                h.sum += v["sum"]
                h.min = min(h.min, v["min"])
                h.max = max(h.max, v["max"])

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


METRICS = Registry()


def set_metrics_enabled(enabled: bool) -> None:
    """Globally enable/disable the shared registry (``--no-metrics``)."""
    METRICS.enabled = bool(enabled)


def metrics_enabled() -> bool:
    return METRICS.enabled

"""Observability of the port's DSE: the twin of the reference's
``repro.obs`` (stdlib-only, like the original).

``trace``
    context-manager/decorator spans emitting Chrome trace-event JSON
    (Perfetto / chrome://tracing), process-safe so DSE worker pools merge
    per-worker traces on join.
``metrics``
    process-global counters/gauges/histograms wired through the hot paths
    (mapping cache, design scoring, the supervised pool, the serving
    replay); dumped as the ``metrics`` section of every sweep JSON.
``provenance``
    schema-versioned run metadata (git sha, host, timestamp, argv, torch's
    version and the card's name) stamped into every sweep JSON.
``log``
    the ``repro_torch`` module-logger hierarchy behind the CLIs' ``-v``
    flags.
``vcd``
    a deterministic IEEE 1364 value-change-dump writer for the netlist
    simulator's node streams (:mod:`repro_torch.core.rtlsim`).

Span and counter names are the reference's (``dse.evaluate``,
``dse.designs_scored``, ``rtlsim.runs``, ``backend.lp_solves``, ...).
"""

from .log import add_verbosity_flag, configure, get_logger
from .metrics import (METRICS, Counter, Gauge, Histogram, Registry,
                      metrics_enabled, set_metrics_enabled)
from .provenance import PROVENANCE_SCHEMA, git_sha, provenance_record
from .trace import (Span, Tracer, disable_tracing, drain_events,
                    enable_tracing, instant, merge_events, save_trace, span,
                    span_counts, tracing_enabled)
from .vcd import VCDWriter

__all__ = [
    "span", "instant", "Span", "Tracer", "enable_tracing", "disable_tracing",
    "tracing_enabled", "drain_events", "merge_events", "save_trace",
    "span_counts",
    "METRICS", "Registry", "Counter", "Gauge", "Histogram",
    "set_metrics_enabled", "metrics_enabled",
    "PROVENANCE_SCHEMA", "provenance_record", "git_sha",
    "get_logger", "configure", "add_verbosity_flag",
    "VCDWriter",
]

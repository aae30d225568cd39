"""Observability of the port: the DSE's, the generator's, and the serving
and training paths' (grown from the reference's ``repro.obs``).

``trace``
    context-manager/decorator spans emitting Chrome trace-event JSON
    (Perfetto / chrome://tracing) on ``torch.profiler``'s epoch clock,
    linked by ``id``, ``parent`` and ``rid``, with CUDA-event device times
    on request; recorded after ``enable_tracing()`` or inside a profiler
    session; process-safe so DSE worker pools merge per-worker traces on
    join; ``counter_events`` lays counters into a trace file.
``metrics``
    process-global counters/gauges/histograms wired through the hot paths
    (mapping cache, design scoring, the supervised pool, the serving
    replay, ``generate``'s calls, captures and replays); dumped as the
    ``metrics`` section of every sweep JSON.
``provenance``
    schema-versioned run metadata (git sha, host, timestamp, argv, torch's
    version and the card's name) stamped into every sweep JSON.
``log``
    the ``repro_torch`` module-logger hierarchy behind the CLIs' ``-v``
    flags.
``vcd``
    a deterministic IEEE 1364 value-change-dump writer for the netlist
    simulator's node streams (:mod:`repro_torch.core.rtlsim`).

The DSE's, the netlist simulator's and the generator's span and counter
names are the reference's (``dse.evaluate``, ``dse.designs_scored``,
``rtlsim.runs``, ``backend.lp_solves``, ...); the serving engine's are
``engine.*`` and the training loop's ``train.*`` (``serve.*`` is the
simulated replay's).
"""

from .log import add_verbosity_flag, configure, get_logger
from .metrics import (METRICS, Counter, Gauge, Histogram, Registry,
                      metrics_enabled, set_metrics_enabled)
from .provenance import PROVENANCE_SCHEMA, git_sha, provenance_record
from .trace import (Span, Tracer, counter_events, disable_tracing,
                    drain_events, enable_tracing, instant, merge_events,
                    read_events, recording, save_trace, span, span_counts,
                    tracing_enabled)
from .vcd import VCDWriter

__all__ = [
    "span", "instant", "Span", "Tracer", "enable_tracing", "disable_tracing",
    "tracing_enabled", "recording", "read_events", "drain_events",
    "merge_events", "save_trace", "span_counts", "counter_events",
    "METRICS", "Registry", "Counter", "Gauge", "Histogram",
    "set_metrics_enabled", "metrics_enabled",
    "PROVENANCE_SCHEMA", "provenance_record", "git_sha",
    "get_logger", "configure", "add_verbosity_flag",
    "VCDWriter",
]

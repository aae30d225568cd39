"""captures_per_call.serve: CUDA-graph captures per ``generate`` call
over the whole process (set-up, window and traced slices alike), from
the program's counters ``engine.captures`` and ``engine.calls``
(``bench.spans``)."""

from bench import spans


def read(rec):
    if rec.get("platform") != "gpu":
        return None
    c = spans.counters()
    if not c.get("engine.calls"):
        return None
    return c.get("engine.captures", 0) / c["engine.calls"]

"""serve_latency_p95_ms: the 95th percentile (nearest rank) of the
latencies of every request completed in the window, in ms.  A request's
latency is its call's: from the start of ``generate`` to its tokens being
on the host, graph capture included."""

import math


def read(rec):
    lat = sorted(c["latency_s"] for c in rec.get("calls") or []
                 if c["start_s"] + c["latency_s"] <= rec["window_s"]
                 for _ in range(c["batch"]))
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3

"""step_p95_ms.serve: the 95th percentile (nearest rank) of the device
ms between the ends of successive ``engine.step`` spans (one a graph
replay) of the traced ``generate`` call: a decode step's time as the
device sees it, host gaps between replays included.  Read from the
program's spans (``bench.spans``)."""

import math

from bench import spans


def read(rec):
    tree = spans.call(rec)
    if tree is None:
        return None
    ends = [e["args"]["device_at_ms"]
            for e in spans.named(tree, "engine.step")
            if "device_at_ms" in e.get("args", {})]
    gaps = sorted(b - a for a, b in zip(ends, ends[1:]))
    if not gaps:
        return None
    return gaps[math.ceil(0.95 * len(gaps)) - 1]

"""idle_setup_ms.serve: ms of the traced ``generate`` call with the
device idle while the host builds the call's state and step or captures
its graph: the device's idle intervals in the call whose midpoints fall
in an ``engine.state_init`` or ``engine.capture`` span.  Read from the
program's spans (``bench.spans``) over the slice's device events."""

from bench import spans


def read(rec):
    tree = spans.call(rec)
    if tree is None:
        return None
    gaps = spans.call_idle(rec, tree)
    under = [(e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3)
             for e in tree.events
             if e["name"] in ("engine.state_init", "engine.capture")]
    if gaps is None or not under:
        return None
    return sum(b - a for a, b in gaps
               if any(s <= (a + b) / 2 < e for s, e in under)) / 1e6

"""idle_steps_ms.serve: ms of the traced ``generate`` call with the
device idle in its replay loop: the device's idle intervals whose
midpoints fall from the end of the ``engine.capture`` span to the device
end of the last ``engine.step`` span.  Read from the program's spans
(``bench.spans``) over the slice's device events."""

from bench import spans


def read(rec):
    tree = spans.call(rec)
    if tree is None:
        return None
    gaps = spans.call_idle(rec, tree)
    caps = spans.named(tree, "engine.capture")
    ends = [e["args"]["device_at_ms"]
            for e in spans.named(tree, "engine.step")
            if "device_at_ms" in e.get("args", {})]
    if gaps is None or not caps or not ends:
        return None
    lo = max(e["ts"] + e["dur"] for e in caps) * 1e3
    hi = spans.device_ns(tree, max(ends))
    return sum(b - a for a, b in gaps if lo <= (a + b) / 2 < hi) / 1e6

"""data_ms.train: host-clock ms a step spent in the feed (the program's
``batch_at``, called through the harness's own callable), over the
window's untraced steps."""


def read(rec):
    steps = [s for s in rec.get("steps") or [] if not s["traced"]]
    if not steps or rec["platform"] != "gpu":
        return None
    return sum(s["feed_s"] for s in steps) / len(steps) * 1e3

"""serve_tok_per_s: new tokens of the window (batch × max_new a call) over
its seconds.  Each call counts by the share of its time inside the window,
so the call under way at the close counts in part; its tokens are taken
to come at an even rate over the call."""


def read(rec):
    calls, T = rec.get("calls"), rec["window_s"]
    if not calls:
        return None
    done = 0.0
    for c in calls:
        inside = max(0.0, min(c["latency_s"], T - c["start_s"]))
        done += c["batch"] * c["output"] * inside / c["latency_s"]
    return done / T

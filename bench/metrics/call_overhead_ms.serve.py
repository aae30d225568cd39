"""call_overhead_ms.serve: the ``generate`` call traced on the device
alone (``devtrace.profile_slices``): its host-clock time minus the
device-busy time inside it, in ms: the eager first step, the graph
capture and the host's gaps between replays."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    return (tr["window_s"] - tr["busy_s"]) * 1e3

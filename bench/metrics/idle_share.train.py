"""idle_share.train: share of the host-clock time of the train steps
traced on the device alone (``devtrace.profile_slices``) with no device
operation running, in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100

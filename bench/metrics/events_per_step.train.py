"""events_per_step.train: device operations (kernels, copies, sets) in
the traced train steps, over their number."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    return len(tr["device_events"]) / tr["slice"]["steps"]

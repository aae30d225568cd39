"""events_per_step.serve: device operations (kernels, copies, sets, those
CUDA graphs replay included) in the call traced on the device alone,
over its steps."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    return len(tr["device_events"]) / tr["slice"]["steps"]

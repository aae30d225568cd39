"""mfu.serve: the traced call's model FLOPs (2 a multiplying parameter and
token stepped, plus the mixer at each position; ``bench.roofline``) over
its host-clock time × the bf16 peak, in %; the call traced on the device
alone (``devtrace.profile_slices``)."""

from bench import arch, roofline


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    sl = tr["slice"]
    flops = roofline.serve_call_flops(arch.load(rec["arch"]), rec["hp"],
                                      sl["batch"], sl["steps"])
    return flops / (tr["window_s"] * roofline.PEAK_FLOPS_BF16) * 100

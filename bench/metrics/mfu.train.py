"""mfu.train: the traced steps' model FLOPs (6 a multiplying parameter and
token, plus three times the mixer's forward work; recomputation not
counted; ``bench.roofline``) over their host-clock time × the bf16 peak,
in %; the steps traced on the device alone
(``devtrace.profile_slices``)."""

from bench import arch, roofline


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_events"]:
        return None
    sl = tr["slice"]
    flops = sl["steps"] * roofline.train_step_flops(
        arch.load(rec["arch"]), rec["hp"], sl["batch"], sl["seq"])
    return flops / (tr["window_s"] * roofline.PEAK_FLOPS_BF16) * 100

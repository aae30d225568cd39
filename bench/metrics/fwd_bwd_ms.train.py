"""fwd_bwd_ms.train: mean device ms a traced train step spends in its
``train.fwd_bwd`` span (forward and backward by autograd), over the
``train.step`` roots of the slice traced on the device.  Read from the
program's spans (``bench.spans``)."""

from bench import spans


def read(rec):
    return spans.per_step(rec, "train.fwd_bwd")

"""setup_s: seconds from the process's start to the first timed call or
step (weights drawn, kernels built or loaded, warm-up, the train cells'
first steps)."""


def read(rec):
    return rec["setup_s"]

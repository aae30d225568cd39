"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` from the start of
set-up to the end of the window, in GiB (the correctness check after the
window is left out)."""


def read(rec):
    if rec["platform"] != "gpu":
        return None
    return rec["peak_bytes"] / 2**30

"""k2_decode_roofline.serve: K2 decode's share of its roofline in the
traced call, in %: the least time of every ``flash_decode_split_kernel``
launch (``bench.roofline.k2_decode_bound_s`` at its position: the i-th
launch of a call of L layers decodes position i // L), summed, over the
time the split and combine kernels ran (the union of their intervals: the
combine kernel may start before the split kernel ends)."""

from bench import devtrace, roofline


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    ev = tr["device_events"]
    split = [e for e in ev if "flash_decode_split_kernel" in e[0]]
    if not split:
        return None
    both = [(s, d) for n, s, d in ev
            if "flash_decode_split_kernel" in n
            or "flash_decode_combine_kernel" in n]
    busy = sum(e - s for s, e in devtrace.union(both)) / 1e9
    hp, sl = rec["hp"], tr["slice"]
    bound = sum(roofline.k2_decode_bound_s(
        sl["batch"], hp["num_attention_heads"], hp["num_key_value_heads"],
        hp["head_dim"], i // sl["layers"]) for i in range(len(split)))
    return bound / busy * 100

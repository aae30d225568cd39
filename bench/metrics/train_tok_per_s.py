"""train_tok_per_s: tokens trained in the window over its seconds (whole
steps, each ending when ``train`` has read its loss)."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    return sum(s["tokens"] for s in steps) / rec["window_s"]

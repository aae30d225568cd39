"""ttft_ms.serve: device ms of the traced ``generate`` call from its
entry (the ``engine.generate`` span's entry event) to its first new
token (the ``engine.first_token`` event, recorded after the first
greedy pick): the teacher-forced prompt's steps and the call's set-up.
Read from the program's spans (``bench.spans``)."""

from bench import spans


def read(rec):
    tree = spans.call(rec)
    if tree is None:
        return None
    for e in spans.named(tree, "engine.first_token"):
        at = e.get("args", {}).get("device_at_ms")
        if at is not None:
            return at
    return None

"""Serving through the program's ``repro_torch.serve.engine.generate``: a
closed loop of one client, each request a batch of ``batch`` prompts of
one length asking for one number of new tokens, the lengths cycled in
order from the traffic's fixed list (``bench.lengths``).  ``--seed``
draws the prompts' token ids and the weights, never the lengths, so every
run times the same calls.

A call's latency runs from its start to its tokens being on the host.
Calls start while the window (``--seconds``) is open; the one under way
at the close runs to its end and counts in the window by the share of
its time inside it (``metrics/serve_tok_per_s.py``).  With ``--trace 1``
the call at index ``trace_call`` runs three times with prompts of its
own (``devtrace.profile_slices``: untraced, traced on the device, traced
with the host's operations).

Correct: once the window has closed and the peak memory is read, a
sample of the served requests drawn from the seed (the call with the most
new tokens and others, a few rows of each) goes through the reference
over its prompt and served tokens.  ``served_gap`` is the widest gap by
which a served token's reference logit lies below the reference's best at
its position, ``served_gap_mean`` the mean of those gaps over the served
tokens; ``prompt_kept`` counts prompt tokens the program did not hand
back as given.  The numbers compared are those that the cell's limits
file names (with ``prompt_kept``, exact).
"""

from __future__ import annotations

import random
import time

import torch

from .. import devtrace
from .. import weights as W
from ..lengths import length_pairs
from ..reference.common import PRECISION


def prompts(cell, key, batch: int, length: int) -> torch.Tensor:
    """(batch, length) int32 token ids on the device, from the seed and
    ``key``."""
    gen = torch.Generator(cell.device).manual_seed(
        W.leaf_seed(cell.seed, f"prompts/{key}"))
    return torch.randint(0, cell.cfg.vocab_size, (batch, length),
                         generator=gen, dtype=torch.int32,
                         device=cell.device)


def prepare(cell) -> dict:
    """The weights, drawn from the seed, and one warm-up call (kernels
    built and loaded, the graph capture's first use)."""
    from repro_torch.serve import engine
    cell.reset_peak()
    weights = W.make(cell.arch, cell.cfg, cell.seed, cell.device)
    t = cell.traffic
    warm = prompts(cell, "warmup", t["batch"], t["warmup"]["prompt"])
    engine.generate(weights, cell.cfg, warm, t["warmup"]["output"]).cpu()
    cell.sync()
    return {"weights": weights, "pairs": length_pairs(t["lengths"])}


def call(cell, weights, key, pair) -> tuple[torch.Tensor, float]:
    """One call on prompts drawn for ``key``: (its tokens on the host,
    seconds)."""
    from repro_torch.serve import engine
    P, O = pair
    pr = prompts(cell, key, cell.traffic["batch"], P)
    cell.sync()
    t0 = time.perf_counter()
    out = engine.generate(weights, cell.cfg, pr, O).cpu()
    return out, time.perf_counter() - t0


def loop(cell, ctx: dict, more) -> tuple[list, list, dict | None]:
    """Calls in order while ``more(i, seconds so far)``: (calls, outputs,
    the traced call's record)."""
    t = cell.traffic
    calls, outs, trace = [], [], None
    t0 = time.perf_counter()
    i = 0
    while more(i, time.perf_counter() - t0):
        start = time.perf_counter() - t0
        pair = ctx["pairs"][i % len(ctx["pairs"])]
        if cell.trace and i == t["trace_call"]:
            keys = [f"{i}", f"{i}.device", f"{i}.host"]
            done, trace = devtrace.profile_slices(
                lambda k: call(cell, ctx["weights"], keys[k], pair),
                cell.sync)
            trace["slice"] = {"kind": "serve_call", "prompt": pair[0],
                              "output": pair[1], "batch": t["batch"],
                              "steps": pair[0] + pair[1] - 1,
                              "layers": cell.cfg.n_layers}
        else:
            keys, done = [f"{i}"], [call(cell, ctx["weights"], f"{i}",
                                         pair)]
        for key, (out, lat) in zip(keys, done):
            calls.append({"key": key, "prompt": pair[0], "output": pair[1],
                          "batch": t["batch"], "start_s": start,
                          "latency_s": lat, "traced": len(keys) > 1})
            outs.append(out)
            start += lat
        i += 1
    return calls, outs, trace


def sample(cell, calls: list) -> list[tuple[int, int]]:
    """(call, row) pairs to check: the call with the most new tokens and
    ``check.calls`` − 1 others, ``check.rows`` rows of each, drawn from
    the seed."""
    chk = cell.traffic["check"]
    rng = random.Random(f"{cell.seed}/check")
    n = len(calls)
    longest = max(range(n), key=lambda j: (calls[j]["output"],
                                           calls[j]["prompt"], -j))
    others = [j for j in range(n) if j != longest]
    chosen = [longest] + rng.sample(others, min(chk["calls"] - 1,
                                                len(others)))
    B = cell.traffic["batch"]
    return [(j, b) for j in chosen for b in sorted(rng.sample(range(B),
                                                              chk["rows"]))]


def readings(cell, weights, calls, outs, picks, control: str | None = None
             ) -> dict:
    """``served_gap``, ``served_gap_mean`` and ``prompt_kept`` over
    ``picks``.  With
    ``control`` ("fp8"), the token judged at each position is the one
    the reference computed at that precision puts first, not the served
    one."""
    V = cell.cfg.vocab_size
    seqs, rows, served = [], [], []
    kept = 0
    for n, (j, b) in enumerate(picks):
        P, O = calls[j]["prompt"], calls[j]["output"]
        out = outs[j]
        given = prompts(cell, calls[j]["key"], cell.traffic["batch"],
                        P)[b].cpu()
        kept += int((out[b, :P] != given).sum())
        seqs.append(torch.cat([given, out[b, P:P + O - 1]]).long())
        served.append(out[b, P:P + O].long())
        rows += [(n, P - 1 + t) for t in range(O)]
    served = torch.cat(served)
    toks = torch.zeros((len(seqs), max(len(s) for s in seqs)),
                       dtype=torch.long)
    for n, s in enumerate(seqs):
        toks[n, :len(s)] = s
    rows_t = torch.tensor(rows, dtype=torch.long, device=cell.device)
    toks = toks.to(cell.device)
    ref = cell.ref.logits_at(weights, toks, rows_t, cell.hp, PRECISION["exact"])
    if control is not None:
        lowp = cell.ref.logits_at(weights, toks, rows_t, cell.hp,
                                  PRECISION[control])
        judged = lowp.argmax(-1)
        del lowp
    else:
        judged = served.to(cell.device)
    if bool(((judged < 0) | (judged >= V)).any()):
        gap = mean = float("inf")
    else:
        gaps = ref.max(-1).values - ref.gather(-1, judged[:, None])[:, 0]
        gap, mean = float(gaps.max()), float(gaps.mean())
    return {"served_gap": gap, "served_gap_mean": mean,
            "prompt_kept": float(kept), "served_tokens": int(served.numel())}


def run(cell) -> dict:
    ctx = prepare(cell)
    setup_s = time.perf_counter() - cell.t_start
    need = cell.traffic["trace_call"] + 1 if cell.trace else 1

    def more(i, elapsed):
        return i < need or elapsed < cell.seconds

    cell.note(f"set-up done: {setup_s:.1f} s")
    calls, outs, trace = loop(cell, ctx, more)
    peak = cell.peak_bytes()
    cell.note(f"window closed: {len(calls)} calls, peak "
              f"{peak / 2**30:.2f} GiB")
    cell.free()
    r = readings(cell, ctx["weights"], calls, outs, sample(cell, calls))
    cell.note("reference done")
    checks = {k: (r[k], lim) for k, lim in cell.limits.items()}
    checks["prompt_kept"] = (r["prompt_kept"], 0.0)
    return {
        "setup_s": setup_s, "window_s": cell.seconds, "peak_bytes": peak,
        "attempted": sum(c["batch"] for c in calls), "failed": 0,
        "calls": calls, "trace": trace, "readings": r, "checks": checks,
    }


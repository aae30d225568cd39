"""Training through the program's ``repro_torch.train.train_lm.train`` over
``build_train_step`` (autograd on the plain path, AdamW in place), fed by
the program's ``data/pipeline.py`` ``batch_at`` from ``--seed``: one
step a ``train`` call, each step's batch of new rows.

Set-up makes the weights from the seed, builds the one train state and
step that the window then drives, and runs the first ``setup_steps``
steps through the same call and feed; from them it keeps the losses, the
first gradient as the optimizer took it (the first moment after step 1
over 1 − β1, per leaf), and each leaf's change (against the starting
weights drawn again) and second moment after the last of them.  The
window then runs steps until ``--seconds`` have passed.  With
``--trace 1`` its first 3 × ``trace_steps`` steps are
``devtrace.profile_slices``' three slices.  Python's cyclic collections
are logged a step.

Correct: once the window has closed and the peak memory is read, the
program's state is freed and the reference runs the set-up steps from
the same weights on batches it works out itself.  ``loss_gap`` is the
largest absolute gap of a step's loss; ``grad_gap``, ``delta_gap`` and
``nu_gap`` the worst leaf's gap between the program's and the
reference's norms (of the first step's gradient, the change over the
steps, the second moment after them), over the larger of the reference's
norm of that leaf and of the median leaf, on the leaves whose reference
gradient is at least a thousandth of the median leaf's, and
``nu_gap_median`` the median leaf's gap of the second moment;
``batch_kept`` counts tokens and labels of the program's batches that
differ from the reference's.  The numbers compared are those that the
cell's limits file names (with ``batch_kept``, exact).
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from .. import devtrace
from .. import weights as W
from ..reference import adamw as ref_adamw
from ..reference import feed as ref_feed
from ..reference.common import PRECISION

_SLICE = 1 << 26


def _quiet(*_):
    pass


class GcLog:
    """Python's cyclic collections while installed in ``gc.callbacks``:
    [generation, seconds] each, taken by :meth:`take`."""

    def __init__(self):
        self.events: list = []
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.events.append([info["generation"],
                                time.perf_counter() - self._t0])
            self._t0 = None

    def take(self) -> list:
        out, self.events = self.events, []
        return out


def _norm(fn, *ts) -> float:
    """sqrt of the sum of squares of ``fn`` over float32 slices of ``ts``
    (tensors of one shape)."""
    flats = [t.reshape(-1) for t in ts]
    sq = 0.0
    for s in range(0, flats[0].numel(), _SLICE):
        sq += float(fn(*(f[s:s + _SLICE].float() for f in flats))
                    .square().sum())
    return math.sqrt(sq)


def _delta_norms(cell, params) -> dict:
    """Per leaf, the norm of (parameter now − its starting value drawn
    again from the seed)."""
    out = {}
    for path, p in W.paths(params):
        p0 = W.draw(cell.arch, cell.seed, path, p.shape, p.dtype, p.device)
        out[path] = _norm(torch.sub, p, p0)
        del p0
    return out


def _leaf_norms(tree) -> dict:
    return {k: _norm(lambda a: a, t) for k, t in W.paths(tree)}


def prepare(cell) -> dict:
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState, build_train_step
    from repro_torch.train.train_lm import train
    t, cfg = cell.traffic, cell.cfg
    opt = t["optimizer"]
    if opt["moments"] != "float32":
        raise ValueError(f"moments {opt['moments']!r}: the entry keeps "
                         "float32 moments")
    cell.reset_peak()
    params = W.make(cell.arch, cfg, cell.seed, cell.device)
    state = TrainState(params, adamw_init(params), None)
    step_fn = build_train_step(cfg, lr=opt["lr"])
    ds = SyntheticLM(cfg.vocab_size, t["seq_len"], t["batch"],
                     seed=cell.seed)
    feed_s: list[float] = []
    seen: dict = {}
    keep = set(range(t["setup_steps"]))

    def feed(i):
        t0 = time.perf_counter()
        b = batch_at(ds, i, cell.device)
        feed_s.append(time.perf_counter() - t0)
        if i in keep:
            seen[i] = (b["tokens"].cpu(), b["labels"].cpu())
        return b

    ctx = {"state": state, "step_fn": step_fn, "feed": feed,
           "feed_s": feed_s, "seen": seen, "train": train,
           "gc": GcLog()}
    losses, grads = [], {}
    for i in range(t["setup_steps"]):
        losses.append(one_step(cell, ctx, i)["loss"])
        if i == 0:
            grads = {k: _norm(lambda m: m, m) / (1 - opt["b1"])
                     for k, m in W.paths(ctx["state"].opt.mu)}
    ctx["prog"] = {"losses": losses, "grad_norms": grads,
                   "delta_norms": _delta_norms(cell, ctx["state"].params),
                   "nu_norms": _leaf_norms(ctx["state"].opt.nu)}
    cell.sync()
    return ctx


def one_step(cell, ctx: dict, i: int) -> dict:
    """Step ``i`` through ``train``: {seconds, tokens, feed_s, loss, gc}."""
    t = cell.traffic
    n_feed = len(ctx["feed_s"])
    ctx["gc"].take()
    t0 = time.perf_counter()
    ctx["state"], losses = ctx["train"](
        ctx["step_fn"], ctx["state"], ctx["feed"], i, i + 1,
        tokens_per_step=t["batch"] * t["seq_len"], log=_quiet)
    return {"seconds": time.perf_counter() - t0,
            "tokens": t["batch"] * t["seq_len"],
            "feed_s": sum(ctx["feed_s"][n_feed:]), "loss": losses[i],
            "gc": ctx["gc"].take()}


def compare(side: dict, ref: dict) -> dict:
    """loss_gap, grad_gap, delta_gap, nu_gap of ``side`` against ``ref``
    (each {"losses", "grad_norms", "delta_norms", "nu_norms"}), the worst
    leaf of each, every leaf's gap, and nu_gap_median."""
    loss_gaps = [abs(a - b) for a, b in zip(side["losses"], ref["losses"])]
    loss_gap = max(loss_gaps)
    if not all(math.isfinite(x) for x in side["losses"]):
        loss_gap = float("inf")
    g = ref["grad_norms"]
    med_g = statistics.median(g.values())
    counted = [k for k in g if g[k] >= 1e-3 * med_g]

    def worst(what):
        mine, theirs = side[what], ref[what]
        med = statistics.median(theirs[k] for k in counted)
        gaps = {k: abs(mine[k] - theirs[k]) / max(theirs[k], med)
                for k in counted}
        k = max(gaps, key=gaps.get)
        if not all(map(math.isfinite, gaps.values())):
            return float("inf"), k, gaps
        return gaps[k], k, gaps

    out = {"loss_gap": loss_gap, "loss_gaps": loss_gaps}
    for what in ("grad", "delta", "nu"):
        out[f"{what}_gap"], out[f"{what}_leaf"], out[f"{what}_gaps"] = \
            worst(f"{what}_norms")
    out["nu_gap_median"] = statistics.median(out["nu_gaps"].values())
    out.update(leaves_counted=len(counted), leaves=len(g))
    return out


def _batches(cell, steps) -> list:
    t = cell.traffic
    return [ref_feed.batch(cell.seed, s, t["batch"], t["seq_len"],
                           cell.hp["vocab_size"]) for s in steps]


def reference_run(cell, control: str | None = None) -> tuple[dict, list]:
    """The reference's set-up steps (at ``control``'s precision if given)
    from the weights drawn again, on the batches it works out: (its
    readings, the batches)."""
    t = cell.traffic
    batches = _batches(cell, range(t["setup_steps"]))
    p0 = W.make(cell.arch, cell.cfg, cell.seed, cell.device)
    on_dev = [(a.to(cell.device), b.to(cell.device)) for a, b in batches]
    out = ref_adamw.train_steps(cell.ref.loss, p0, on_dev, cell.hp,
                                t["optimizer"], PRECISION[control or "exact"],
                                rows=t["check"]["rows"])
    return out, batches


def readings(cell, prog: dict, seen: dict, control: bool = False) -> dict:
    """The program's numbers (``compare``'s and ``batch_kept``); with
    ``control``, also those of the reference at fp8 in the program's
    place, under ``control``."""
    ref, batches = reference_run(cell)
    kept = 0
    for s, (c, d) in enumerate(batches):
        if s not in seen:
            kept += 1
            continue
        a, b = seen[s]
        kept += int((a != c).sum()) + int((b != d).sum())
    out = {**compare(prog, ref), "batch_kept": float(kept)}
    if control:
        cell.free()
        ctrl, _ = reference_run(cell, control="fp8")
        out["control"] = compare(ctrl, ref)
    return out


def run(cell, control: bool = False) -> dict:
    hook = None
    try:
        ctx = prepare(cell)
        hook = ctx["gc"]
        gc.callbacks.append(hook)
        return _window_and_check(cell, ctx, control)
    finally:
        if hook in gc.callbacks:
            gc.callbacks.remove(hook)


def _window_and_check(cell, ctx: dict, control: bool) -> dict:
    setup_s = time.perf_counter() - cell.t_start
    cell.note(f"set-up done: {setup_s:.1f} s")
    t = cell.traffic
    i = t["setup_steps"]
    steps, trace = [], None
    t0 = time.perf_counter()
    if cell.trace:
        n = t["trace_steps"]

        def sliced(k, first=i):
            done = [one_step(cell, ctx, first + k * n + j) for j in range(n)]
            for s in done:
                s["traced"] = k > 0
            return done

        done, trace = devtrace.profile_slices(sliced, cell.sync)
        trace["slice"] = {"kind": "train_steps", "steps": n,
                          "batch": t["batch"], "seq": t["seq_len"]}
        steps += [s for d in done for s in d]
        i += 3 * n
    while time.perf_counter() - t0 < cell.seconds:
        s = one_step(cell, ctx, i)
        s["traced"] = False
        steps.append(s)
        i += 1
    window_s = time.perf_counter() - t0
    peak = cell.peak_bytes()
    cell.note(f"window closed: {len(steps)} steps, {window_s:.1f} s, "
              f"peak {peak / 2**30:.2f} GiB")
    prog, seen = ctx["prog"], ctx["seen"]
    ctx.clear()
    cell.free()
    r = readings(cell, prog, seen, control)
    cell.note("reference done")
    checks = {k: (r[k], lim) for k, lim in cell.limits.items()}
    checks["batch_kept"] = (r["batch_kept"], 0.0)
    return {
        "setup_s": setup_s, "window_s": window_s, "peak_bytes": peak,
        "attempted": len(steps),
        "failed": sum(not math.isfinite(s["loss"]) for s in steps),
        "steps": steps, "trace": trace, "readings": r, "checks": checks,
    }

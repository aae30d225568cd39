"""Traffic-driven continuous-batching decode simulator (serving DSE): the
twin of the reference's ``repro.serve.sim``.

The DSE scored designs on static per-layer cycles; this module closes the
loop the paper's "one architecture for diverse modern foundation models"
claim actually needs: replay a synthetic request trace
(:mod:`repro_torch.serve.trace` — Poisson arrivals, mixed prompt/output lengths,
multi-model tenancy) against one candidate :class:`~repro_torch.dse.space.
DesignPoint` and score it on **p50/p99 TTFT + TPOT and goodput under SLO**
instead of raw cycles.

Per decode step the cost comes from the real mapping search: a
:class:`DecodeCostModel` lowers each tenant model through the graph
frontend at ``--phases decode`` (context and batch bucketed to powers of
two) and scores the rows through the persistent mapping cache
(:meth:`repro_torch.dse.cache.MappingCache.best_mapping_perfs`) — designs whose
dataflow set maps the attention pair keep the fused score-stationary decode
lowering and its P-residency credit, everything else falls back to the
per-GEMM form.  Batch-size-dependent utilization therefore emerges from the
perf model itself: weight streaming is memory-bound at batch 1 and
amortizes across the batch, per-token attention grows with context.

The event loop models KV-cache capacity pressure: optimistic vLLM-style
admission against current occupancy, growth of one KV token per generated
token, and LIFO preempt-and-recompute when the projected occupancy exceeds
capacity (preempted requests re-queue at the front and re-prefill
prompt+progress on resume).  Straggling decode shards are detected by the
:class:`repro_torch.ft.straggler.StragglerMonitor` wired into the step loop: a
flagged shard is evicted (elastic re-mesh, one-time penalty) so its
slowdown is bounded by the monitor's patience.

Everything is a pure function of (design, trace, spec): no wall clock, no
global RNG, deterministic tie-breaking — the property-based invariant
suite of the reference (``tests/test_serve_sim.py``) holds its replays
bit-identical across runs, ``--workers`` settings and scoring engines, and
``tests/test_torch_dse_search.py`` holds this copy's summaries equal to the
reference's.  With ``engine="torch"`` the mapping misses of a replay are
scored on ``device`` (the card unless the caller names the CPU).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

from ..obs import METRICS, span

from .trace import Request, TraceSpec, generate_trace

__all__ = ["SLO", "ServingSpec", "StragglerEpisode", "DecodeCostModel",
           "ServingResult", "simulate", "percentile", "next_pow2",
           "kv_bytes_per_token", "const_state_bytes"]


# ---------------------------------------------------------------------------
# config records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SLO:
    """Latency service-level objective: time-to-first-token and
    time-per-output-token bounds a request must meet to count toward
    goodput."""

    ttft_ms: float = 30000.0
    tpot_ms: float = 1500.0

    def as_dict(self) -> dict:
        return {"ttft_ms": self.ttft_ms, "tpot_ms": self.tpot_ms}


@dataclass(frozen=True)
class StragglerEpisode:
    """One injected slow-shard episode: ``shard`` runs ``factor×`` slower
    for steps ``[start, start + steps)`` (until evicted by the monitor)."""

    shard: int = 0
    start: int = 0
    steps: int = 10**9
    factor: float = 4.0


@dataclass(frozen=True)
class ServingSpec:
    """Everything the serving objective adds on top of a design point —
    carried by the :class:`~repro_torch.dse.evaluate.Evaluator` into workers and
    stamped into the bench artifacts."""

    trace: TraceSpec = field(default_factory=TraceSpec)
    slo: SLO = field(default_factory=SLO)
    kv_capacity_bytes: int = 4 << 30
    max_batch: int = 64
    reduced: bool = False

    def as_dict(self) -> dict:
        return {"trace": self.trace.as_dict(), "slo": self.slo.as_dict(),
                "kv_capacity_bytes": self.kv_capacity_bytes,
                "max_batch": self.max_batch, "reduced": self.reduced}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def next_pow2(n: int) -> int:
    """Smallest power of two >= max(1, n) — the cost-model bucket."""
    return 1 << (max(1, int(n)) - 1).bit_length()


def percentile(vals, q: float) -> float:
    """Deterministic nearest-rank percentile (q in [0, 100]); 0.0 on
    empty input.  ``percentile(v, 50) <= percentile(v, 99)`` always."""
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return float(s[idx])


def _model_config(model: str, reduced: bool):
    from ..configs import get_config
    return get_config(model, reduced=reduced)


def kv_bytes_per_token(model, data_bytes: int = 1,
                       reduced: bool = False) -> int:
    """Per-token KV-cache growth of one request: 2 (K+V) × kv heads ×
    head_dim × bytes, summed over the attention layers of the pattern.
    Mamba/RWKV blocks carry constant-size state instead
    (:func:`const_state_bytes`)."""
    cfg = model if not isinstance(model, str) \
        else _model_config(model, reduced)
    n_attn = cfg.n_periods * sum(1 for s in cfg.layer_pattern
                                 if s.kind == "attn")
    return n_attn * 2 * cfg.n_kv_heads * cfg.hd * data_bytes


def const_state_bytes(model, data_bytes: int = 1,
                      reduced: bool = False) -> int:
    """Context-independent recurrent state of one request (SSM conv+scan
    states, RWKV wkv + shift states) — charged once at admission."""
    cfg = model if not isinstance(model, str) \
        else _model_config(model, reduced)
    total = 0
    for s in cfg.layer_pattern:
        if s.kind == "mamba":
            d_inner = cfg.mamba_expand * cfg.d_model
            total += d_inner * (cfg.d_state + cfg.d_conv)
        elif s.kind == "rwkv":
            heads = max(1, cfg.d_model // cfg.rwkv_head_dim)
            total += heads * cfg.rwkv_head_dim * cfg.rwkv_head_dim \
                + 2 * cfg.d_model
    return cfg.n_periods * total * data_bytes


# ---------------------------------------------------------------------------
# decode cost model (the mapping-search front door)
# ---------------------------------------------------------------------------

class DecodeCostModel:
    """Per-step serving costs of one design, solved by the mapping search.

    ``decode_step_ms(model, ctx, batch)`` lowers one decode step of
    ``batch`` requests at context ``ctx`` (both bucketed to powers of two)
    through :func:`repro_torch.frontend.lower_model` and scores the rows with
    :func:`repro_torch.core.fusion.score_fused_design` through the shared
    :class:`~repro_torch.dse.cache.MappingCache` — the exact engine-invariant
    path the static DSE uses, including the fused-attention decode design
    point for capable dataflow sets.  ``prefill_ms`` does the same for the
    admission-time prefill pass.  Results are memoized per (model, phase,
    ctx, batch) bucket, so a whole trace replay costs a handful of mapping
    queries per tenant model.
    """

    def __init__(self, point, cache=None, engine: str = "numpy",
                 objective: str = "cycles", reduced: bool = False,
                 device="cuda"):
        from ..dse.cache import MappingCache
        from ..models.common import check_device
        self.point = point
        self.hw = point.hw_config()
        self.cache = cache if cache is not None else MappingCache()
        self.engine = engine
        # where engine="torch" scores the misses; no quiet CPU fallback
        self.device = check_device(device) if engine == "torch" else device
        self.objective = objective
        self.reduced = reduced
        self.fused = (point.supports("attention_qk")
                      and point.supports("attention_pv"))
        self._memo: dict[tuple, float] = {}

    def _score_ms(self, model: str, phase: str, seq: int,
                  batch: int) -> float:
        from ..core import workload as W
        from ..core.fusion import score_fused_design
        from ..frontend import lower_model, unfuse_attention_rows
        wl_by_kind = {"gemm": W.gemm(), "conv": W.conv2d(),
                      "dwconv": W.depthwise_conv2d(),
                      "attn_qk": W.attention_qk(),
                      "attn_pv": W.attention_pv()}
        rows = lower_model(model, seq=seq, batch=batch, phase=phase,
                           reduced=self.reduced)
        if not self.fused:
            rows = unfuse_attention_rows(rows)
        layers = [(wl_by_kind[k], dims, rep, nt)
                  for k, dims, rep, nt in rows]
        spatials = {wl.name: self.point.spatials(wl.name)
                    for wl, _, _, _ in layers}
        solve = functools.partial(self.cache.best_mapping_perfs,
                                  engine=self.engine, device=self.device)
        score = score_fused_design(layers, spatials, self.hw,
                                   objective=self.objective,
                                   batch_mapping_fn=solve)
        return score.cycles / (self.hw.freq_ghz * 1e6)  # cycles -> ms

    def _lookup(self, model: str, phase: str, seq: int,
                batch: int) -> float:
        key = (model, phase, seq, batch)
        ms = self._memo.get(key)
        if ms is None:
            METRICS.counter("serve.cost_model_solves").inc()
            ms = self._score_ms(model, phase, seq, batch)
            self._memo[key] = ms
        return ms

    def decode_step_ms(self, model: str, ctx: int, batch: int) -> float:
        """Wall time of one decode step of ``batch`` requests of ``model``
        attending a ``ctx``-token context (bucket-quantized)."""
        return self._lookup(model, "decode", next_pow2(ctx),
                            next_pow2(batch))

    def prefill_ms(self, model: str, tokens: int) -> float:
        """Wall time of prefilling ``tokens`` prompt tokens (bucketed)."""
        return self._lookup(model, "prefill", next_pow2(tokens), 1)

    def kv_bytes_per_token(self, model: str) -> int:
        return kv_bytes_per_token(model, self.hw.data_bytes, self.reduced)

    def const_state_bytes(self, model: str) -> int:
        return const_state_bytes(model, self.hw.data_bytes, self.reduced)


# ---------------------------------------------------------------------------
# simulation state + result
# ---------------------------------------------------------------------------

@dataclass
class _Req:
    """Mutable per-request simulation state."""

    req: Request
    progress: int = 0            # tokens generated (and kept) so far
    ctx: int = 0                 # KV tokens held while active
    admitted_ms: float = -1.0
    ttft_ms: float = -1.0        # set once, at first-token emission
    first_token_abs_ms: float = -1.0
    finish_ms: float = -1.0
    preemptions: int = 0
    resumes: int = 0

    def kv_bytes(self, kvpt: int, const: int) -> int:
        return const + self.ctx * kvpt


@dataclass
class ServingResult:
    """Outcome of one trace replay against one design."""

    design: str
    spec: ServingSpec
    n_requests: int
    completed: int
    tokens_served: int
    sim_ms: float
    n_steps: int
    preemptions: int
    resumes: int
    remeshes: int
    p50_ttft_ms: float
    p99_ttft_ms: float
    p50_tpot_ms: float
    p99_tpot_ms: float
    goodput_tps: float           # SLO-met output tokens per second
    slo_attainment: float        # fraction of requests meeting both SLOs
    kv_peak_bytes: int
    batch_mean: float
    requests: list[dict] = field(default_factory=list)
    steps: list[dict] = field(default_factory=list)  # record_steps=True only

    def summary(self) -> dict:
        """The JSON serving scorecard stamped into bench artifacts —
        deterministic (no wall clock, no paths), so seeded reruns are
        byte-identical."""
        return {
            "design": self.design,
            "trace": self.spec.trace.as_dict(),
            "slo": self.spec.slo.as_dict(),
            "kv_capacity_bytes": self.spec.kv_capacity_bytes,
            "max_batch": self.spec.max_batch,
            "requests": self.n_requests,
            "completed": self.completed,
            "tokens_served": self.tokens_served,
            "sim_ms": self.sim_ms,
            "steps": self.n_steps,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "remeshes": self.remeshes,
            "p50_ttft_ms": self.p50_ttft_ms,
            "p99_ttft_ms": self.p99_ttft_ms,
            "p50_tpot_ms": self.p50_tpot_ms,
            "p99_tpot_ms": self.p99_tpot_ms,
            "goodput_tps": self.goodput_tps,
            "slo_attainment": self.slo_attainment,
            "kv_peak_bytes": self.kv_peak_bytes,
            "batch_mean": self.batch_mean,
        }


# ---------------------------------------------------------------------------
# the event loop
# ---------------------------------------------------------------------------

def simulate(point, trace: list[Request] | None = None, *,
             spec: ServingSpec | None = None,
             cost_model: DecodeCostModel | None = None,
             cache=None, engine: str = "numpy", objective: str = "cycles",
             device="cuda", shards: int = 1, straggler: StragglerEpisode | None = None,
             monitor=None, remesh_penalty_ms: float = 0.0,
             record_steps: bool = False) -> ServingResult:
    """Replay ``trace`` against ``point``; returns the SLO scorecard.

    ``trace=None`` generates it from ``spec.trace``.  Without a
    ``cost_model`` one is built from ``cache``, ``engine``, ``objective`` and
    ``device`` (where ``engine="torch"`` scores).  ``shards > 1`` models
    data-parallel decode shards whose per-step times feed the
    :class:`~repro_torch.ft.straggler.StragglerMonitor` (``monitor`` overrides
    the default-patience one); a ``straggler`` episode slows one shard
    until the monitor flags it and the loop re-meshes (evicts) it.  With
    ``record_steps=True`` every step appends a log row — the contract the
    brute-force oracle test replays step-for-step.
    """
    spec = spec if spec is not None else ServingSpec()
    if trace is None:
        trace = generate_trace(spec.trace)
    if cost_model is None:
        cost_model = DecodeCostModel(point, cache=cache, engine=engine,
                                     objective=objective,
                                     reduced=spec.reduced, device=device)
    cap = int(spec.kv_capacity_bytes)
    kvpt = {m: cost_model.kv_bytes_per_token(m)
            for m in sorted({r.model for r in trace})}
    const = {m: cost_model.const_state_bytes(m) for m in kvpt}
    for r in trace:
        need = const[r.model] + (r.prompt + r.output) * kvpt[r.model]
        if need > cap:
            raise ValueError(
                f"request {r.rid} needs {need} KV bytes "
                f"({r.prompt}+{r.output} tokens of {r.model}) but capacity "
                f"is {cap} — it could never be served")

    if shards > 1 and monitor is None:
        from ..ft.straggler import StragglerMonitor
        monitor = StragglerMonitor(n_hosts=shards)

    with span("serve.simulate", cat="serve", design=point.name,
              requests=len(trace)):
        return _run(point, trace, spec, cost_model, kvpt, const, shards,
                    straggler, monitor, remesh_penalty_ms, record_steps)


def _run(point, trace, spec, cost_model, kvpt, const, shards, straggler,
         monitor, remesh_penalty_ms, record_steps) -> ServingResult:
    cap = int(spec.kv_capacity_bytes)
    states = {r.rid: _Req(req=r) for r in trace}
    pending = sorted(trace, key=lambda r: (r.arrival_ms, r.rid))
    ready: list[_Req] = []       # arrived, awaiting first admission
    resume_q: list[_Req] = []    # preempted, awaiting re-admission (FIFO)
    active: list[_Req] = []      # admission-ordered running batch
    alive = list(range(max(1, shards)))
    kv_used = 0
    kv_peak = 0
    t = 0.0
    n_steps = n_preempt = n_resume = n_remesh = 0
    batch_sum = 0
    step_log: list[dict] = []

    def kv_of(s: _Req) -> int:
        return s.kv_bytes(kvpt[s.req.model], const[s.req.model])

    while pending or ready or resume_q or active:
        # -- arrivals up to the current time -----------------------------
        while pending and pending[0].arrival_ms <= t:
            ready.append(states[pending.pop(0).rid])
        if not active and not ready and not resume_q:
            t = max(t, pending[0].arrival_ms)
            continue

        # -- preempt: existing actives grow one KV token this step -------
        preempted_now: list[int] = []
        projected = kv_used + sum(kvpt[s.req.model] for s in active)
        while projected > cap:
            victim = active.pop()          # LIFO: latest admission first
            kv_used -= kv_of(victim)
            projected -= kv_of(victim) + kvpt[victim.req.model]
            victim.ctx = 0                 # recompute-style: KV dropped
            victim.preemptions += 1
            n_preempt += 1
            resume_q.insert(0, victim)
            preempted_now.append(victim.req.rid)
        METRICS.counter("serve.preemptions").inc(len(preempted_now))

        # -- admit: resumed requests first, then new arrivals ------------
        admitted_now: list[_Req] = []
        for queue in (resume_q, ready):
            while queue and len(active) + len(admitted_now) \
                    < spec.max_batch:
                cand = queue[0]
                ctx0 = cand.req.prompt + cand.progress
                need = const[cand.req.model] + (ctx0 + 1) \
                    * kvpt[cand.req.model]
                if projected + need > cap:
                    break
                queue.pop(0)
                projected += need
                cand.ctx = ctx0
                if cand.resumes < cand.preemptions:
                    cand.resumes += 1
                    n_resume += 1
                    METRICS.counter("serve.resumes").inc()
                cand.admitted_ms = t
                admitted_now.append(cand)
        if not active and not admitted_now:
            # nothing runnable this instant: jump to the next arrival
            t = max(t, pending[0].arrival_ms)
            continue

        # -- step cost: prefill for admissions + one batched decode pass
        # per tenant model (sorted for a fixed fp summation order) --------
        prefill_ms = 0.0
        for s in admitted_now:
            prefill_ms += cost_model.prefill_ms(s.req.model, s.ctx)
        groups: dict[str, list[_Req]] = {}
        for s in active:
            groups.setdefault(s.req.model, []).append(s)
        decode_ms = 0.0
        for model in sorted(groups):
            grp = groups[model]
            decode_ms += cost_model.decode_step_ms(
                model, max(s.ctx for s in grp), len(grp))
        base_ms = prefill_ms + decode_ms

        # -- shard skew: the monitor watches per-shard step times --------
        slow = 1.0
        if straggler is not None and straggler.shard in alive \
                and straggler.start <= n_steps \
                < straggler.start + straggler.steps:
            slow = straggler.factor
        step_ms = base_ms * slow
        if monitor is not None and shards > 1:
            monitor.record({s: (base_ms * (slow if s == straggler.shard
                                           else 1.0) if straggler is not None
                                else base_ms) / 1e3
                            for s in alive})
            flagged = [s for s in monitor.stragglers() if s in alive]
            if flagged:
                # elastic re-mesh: evict the shard, pay the restore once
                for s in flagged:
                    alive.remove(s)
                n_remesh += len(flagged)
                METRICS.counter("serve.remeshes").inc(len(flagged))
                step_ms += remesh_penalty_ms

        # -- advance: admissions emit their first token (prefill),
        # actives decode one token each ----------------------------------
        t_end = t + step_ms
        completed_now: list[int] = []
        for s in admitted_now:
            s.progress += 1
            s.ctx += 1
            s.ttft_ms = t_end - s.req.arrival_ms
            s.first_token_abs_ms = t_end
            kv_used += kv_of(s)
        for s in active:
            s.progress += 1
            s.ctx += 1
            kv_used += kvpt[s.req.model]
        active.extend(admitted_now)
        still: list[_Req] = []
        for s in active:
            if s.progress >= s.req.output:
                s.finish_ms = t_end
                kv_used -= kv_of(s)
                completed_now.append(s.req.rid)
            else:
                still.append(s)
        active = still
        assert kv_used <= cap, "KV occupancy exceeded capacity"
        kv_peak = max(kv_peak, kv_used)
        batch_sum += len(still) + len(completed_now)
        METRICS.counter("serve.steps").inc()
        METRICS.histogram("serve.batch_occupancy").observe(
            len(still) + len(completed_now))
        METRICS.histogram("serve.step_ms").observe(step_ms)
        if record_steps:
            step_log.append({
                "t_ms": t, "step_ms": step_ms,
                "batch": {m: len(g) for m, g in sorted(groups.items())},
                "admitted": [s.req.rid for s in admitted_now],
                "preempted": preempted_now,
                "completed": completed_now,
                "kv_bytes": kv_used,
            })
        n_steps += 1
        t = t_end

    # -- scorecard -------------------------------------------------------
    slo = spec.slo
    done = [states[r.rid] for r in trace]
    ttfts = [s.ttft_ms for s in done]
    tpots = []
    for s in done:
        if s.req.output > 1:
            tpots.append((s.finish_ms - s.first_token_abs_ms)
                         / (s.req.output - 1))
        else:
            tpots.append(0.0)
    met_tokens = 0
    met = 0
    for s, tp in zip(done, tpots):
        if s.ttft_ms <= slo.ttft_ms and tp <= slo.tpot_ms:
            met += 1
            met_tokens += s.req.output
    sim_ms = t
    per_request = [{
        "rid": s.req.rid, "model": s.req.model,
        "arrival_ms": s.req.arrival_ms, "prompt": s.req.prompt,
        "output": s.req.output, "ttft_ms": s.ttft_ms, "tpot_ms": tp,
        "finish_ms": s.finish_ms, "preemptions": s.preemptions,
        "resumes": s.resumes,
        "slo_met": bool(s.ttft_ms <= slo.ttft_ms and tp <= slo.tpot_ms),
    } for s, tp in zip(done, tpots)]
    return ServingResult(
        design=point.name, spec=spec, n_requests=len(trace),
        completed=len(done), tokens_served=sum(s.req.output for s in done),
        sim_ms=sim_ms, n_steps=n_steps, preemptions=n_preempt,
        resumes=n_resume, remeshes=n_remesh,
        p50_ttft_ms=percentile(ttfts, 50),
        p99_ttft_ms=percentile(ttfts, 99),
        p50_tpot_ms=percentile(tpots, 50),
        p99_tpot_ms=percentile(tpots, 99),
        goodput_tps=(met_tokens / (sim_ms / 1e3)) if sim_ms > 0 else 0.0,
        slo_attainment=(met / len(done)) if done else 0.0,
        kv_peak_bytes=kv_peak,
        batch_mean=(batch_sum / n_steps) if n_steps else 0.0,
        requests=per_request, steps=step_log)

"""Search strategies over the design space + Pareto-frontier extraction:
the twin of the reference's ``repro.dse.search``.

Exhaustive enumeration for small spaces; an evolutionary random-mutation loop
(archive-based, deterministic seed) when the space outgrows it.  Both return
a :class:`SearchResult` holding every evaluated scorecard and the
non-dominated subset over (cycles, energy, area).

Both strategies accept ``workers=N``: independent :class:`DesignPoint`
evaluations fan out across the **supervised worker pool**
(:class:`~repro_torch.dse.supervisor.Supervisor` — each worker holds its
own in-memory :class:`~repro_torch.dse.cache.MappingCache`, warm-started from the
parent's entries) and results return **in submission order**, so the sweep
is deterministic — the frontier is independent of the worker count.  New
mapping-cache entries computed by workers merge back into the parent cache
with every result, so a later ``cache.save()`` persists them.  The
supervisor adds per-task timeouts with hung-worker kill-and-respawn,
bounded retries with backoff, poison-point quarantine, degradation to
in-process evaluation, and an optional resumable run ledger — pass a
pre-configured ``supervisor=`` to opt in; the default is a plain
``Supervisor(evaluator, workers)`` with retries but no ledger.

Observability: each search runs inside a :func:`repro_torch.obs.span` (the single
source of the reported ``wall_s``, and a trace event when tracing is on),
and workers ship their buffered trace events and metric deltas back with
every result — the parent merges them, so one ``--trace`` file and one
``metrics`` section cover the whole pool regardless of the worker count.

The evaluator's ``engine`` (and ``device``) decide only where mapping
misses are scored: the same seed and budget visit the same designs in the
same order, and give the same frontier, whichever engine is used.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..obs import get_logger, span

_LOG = get_logger("dse.search")

from .evaluate import DesignEval, Evaluator
from .space import DesignPoint, DesignSpace
from .supervisor import Supervisor, SupervisorConfig

__all__ = ["dominates", "pareto_frontier", "exhaustive_search",
           "evolutionary_search", "evolve_search", "run_search",
           "SearchResult", "Supervisor", "SupervisorConfig"]


def dominates(a, b) -> bool:
    """True iff objective vector ``a`` Pareto-dominates ``b`` (minimize)."""
    return all(x <= y for x, y in zip(a, b)) and any(
        x < y for x, y in zip(a, b))


def pareto_frontier(evals: list[DesignEval],
                    key=lambda e: e.objectives()) -> list[DesignEval]:
    """Non-dominated subset, sorted by first objective.

    O(n²) pairwise filtering — design-space sweeps are hundreds of points,
    not millions; simplicity and determinism win here.  Quarantined
    failure stubs (``e.failed``) never reach the frontier: their zeroed
    objectives are a bookkeeping artifact, not a design.
    """
    evals = [e for e in evals if not getattr(e, "failed", False)]
    out = []
    vecs = [key(e) for e in evals]
    for i, e in enumerate(evals):
        dominated = False
        for j, v in enumerate(vecs):
            if j == i:
                continue
            if dominates(v, vecs[i]):
                dominated = True
                break
            # identical vectors: keep only the first occurrence
            if v == vecs[i] and j < i:
                dominated = True
                break
        if not dominated:
            out.append(e)
    out.sort(key=lambda e: key(e))
    return out


@dataclass
class SearchResult:
    space: str
    strategy: str
    evals: list[DesignEval]
    frontier: list[DesignEval]
    wall_s: float = 0.0
    cache_stats: dict = field(default_factory=dict)
    supervisor: dict = field(default_factory=dict)  # retries/respawns/...
    # strategy-specific provenance (evolve: seed/budget/visited order) —
    # lands in the BENCH artifact so seeded runs are auditable
    extra: dict = field(default_factory=dict)

    @property
    def n_designs(self) -> int:
        return len(self.evals)

    def best(self, objective: str = "cycles") -> DesignEval:
        keyfn = {"cycles": lambda e: e.cycles,
                 "energy": lambda e: e.energy_pj,
                 "area": lambda e: e.area_mm2,
                 "edp": lambda e: e.edp,
                 # traffic-mix goodput (requires serving scorecards);
                 # minimized like every other key, hence the negation
                 "goodput": lambda e: -(e.serving or {}).get(
                     "goodput_tps", 0.0)}[objective]
        return min(self.frontier or self.evals, key=keyfn)


# ---------------------------------------------------------------------------
# supervised fan-out (see dse.supervisor for the pool machinery)
# ---------------------------------------------------------------------------

def _supervised(evaluator: Evaluator, workers: int,
                supervisor: Supervisor | None) -> Supervisor:
    if supervisor is not None:
        return supervisor
    return Supervisor(evaluator, workers=workers)


def exhaustive_search(space: DesignSpace, evaluator: Evaluator,
                      log=None, workers: int = 1,
                      supervisor: Supervisor | None = None) -> SearchResult:
    points = list(space.enumerate())
    _LOG.info("exhaustive search: %d points over space %r (workers=%d)",
              len(points), space.name, workers)
    # the span is the single timing source: wall_s in the SearchResult /
    # bench provenance AND the sweep event in the --trace file come from it
    with span("dse.exhaustive_search", cat="dse", space=space.name,
              n_points=len(points), workers=workers) as sp, \
            _supervised(evaluator, workers, supervisor) as pe:
        evals = pe.map(points, log=log)
    return SearchResult(space=space.name, strategy="exhaustive", evals=evals,
                        frontier=pareto_frontier(evals),
                        wall_s=sp.duration_s,
                        cache_stats=evaluator.cache.stats,
                        supervisor=dict(pe.stats))


def _scalar_rank(evals: list[DesignEval]) -> list[float]:
    """Normalized-sum scalarization used only for parent selection."""
    if not evals:
        return []
    los = [min(e.objectives()[k] for e in evals) for k in range(3)]
    his = [max(e.objectives()[k] for e in evals) for k in range(3)]
    out = []
    for e in evals:
        s = 0.0
        for k, v in enumerate(e.objectives()):
            span = his[k] - los[k]
            s += (v - los[k]) / span if span > 0 else 0.0
        out.append(s)
    return out


def evolutionary_search(space: DesignSpace, evaluator: Evaluator,
                        population: int = 12, generations: int = 8,
                        seed: int = 0, log=None, workers: int = 1,
                        supervisor: Supervisor | None = None) -> SearchResult:
    """Archive-based (μ+λ) random-mutation search.

    Every evaluated point enters the archive keyed by its name, so mutation
    revisits never re-run the evaluator (and the mapping cache removes the
    per-layer cost of near-revisits that differ in one axis).  With
    ``workers > 1`` each generation's unseen points evaluate concurrently;
    archive updates stay in submission order, so the run is reproducible at
    any worker count.
    """
    rng = random.Random(seed)
    archive: dict[str, DesignEval] = {}
    _LOG.info("evolutionary search: pop=%d gens=%d over space %r "
              "(workers=%d)", population, generations, space.name, workers)

    with span("dse.evolutionary_search", cat="dse", space=space.name,
              population=population, generations=generations,
              workers=workers) as sp, \
            _supervised(evaluator, workers, supervisor) as pe:

        def eval_points(points: list[DesignPoint]) -> list[DesignEval]:
            todo, seen_names = [], set()
            for p in points:
                if p.name not in archive and p.name not in seen_names:
                    seen_names.add(p.name)
                    todo.append(p)
            for p, e in zip(todo, pe.map(todo)):
                archive[p.name] = e
            return [archive[p.name] for p in points]

        pop = []
        seen = set()
        for _ in range(population * 4):
            if len(pop) >= population:
                break
            p = space.sample(rng)
            if p.name not in seen:
                seen.add(p.name)
                pop.append(p)
        for g in range(generations):
            evals = eval_points(pop)
            # quarantined failure stubs carry zeroed objectives — letting
            # them into selection would rank poison points as the fittest
            live = [i for i, e in enumerate(evals) if not e.failed]
            if not live:
                live = list(range(len(pop)))
            ranks = _scalar_rank([evals[i] for i in live])
            order = sorted(range(len(live)), key=lambda i: ranks[i])
            parents = [pop[live[i]] for i in order[:max(2, population // 2)]]
            children = [space.mutate(rng.choice(parents), rng)
                        for _ in range(population - len(parents))]
            pop = parents + children
            if log:
                best = archive[min(archive,
                                   key=lambda n: archive[n].cycles)]
                log(f"gen {g + 1}/{generations}: archive={len(archive)} "
                    f"best_cycles={best.cycles:.3g}")
        eval_points(pop)
    evals = list(archive.values())
    return SearchResult(space=space.name, strategy="evolutionary",
                        evals=evals, frontier=pareto_frontier(evals),
                        wall_s=sp.duration_s,
                        cache_stats=evaluator.cache.stats,
                        supervisor=dict(pe.stats))


# ---------------------------------------------------------------------------
# guided search: tournament selection + mutation + successive halving
# ---------------------------------------------------------------------------

# the selection lenses children cycle through — driving exploration toward
# every frontier corner instead of one scalarized compromise point
_EVOLVE_KEYS = (("cycles", lambda e: (e.cycles, e.energy_pj)),
                ("energy", lambda e: (e.energy_pj, e.cycles)),
                ("edp", lambda e: (e.edp, e.area_mm2)))


def _corner_points(space: DesignSpace) -> list[DesignPoint]:
    """Deterministic screening seeds: the all-min / all-max numeric corner
    per dataflow set (classic DOE initialization).  Extreme designs are
    where single-objective winners live; invalid corners (e.g. area-pruned)
    are simply skipped — mutation can still climb toward them."""
    out = []
    for ds in space.dataflow_sets:
        for pick in (min, max):
            p = DesignPoint(n_fus=pick(space.n_fus),
                            buffer_kb=pick(space.buffer_kb),
                            dram_gbps=pick(space.dram_gbps),
                            dataflow_set=ds)
            if space.is_valid(p):
                out.append(p)
    return out


def evolve_search(space: DesignSpace, evaluator: Evaluator,
                  budget: int = 64, seed: int = 0,
                  population: int = 16, halving_eta: int = 2,
                  tournament_k: int = 3, log=None, workers: int = 1,
                  supervisor: Supervisor | None = None) -> SearchResult:
    """Guided search under an evaluation budget: explore a 10⁵-point space
    without ever enumerating it.

    One loop iteration: **tournament selection** (``tournament_k`` random
    archive members, fittest wins — quarantined failure stubs never enter)
    picks a parent per child, each child cycling through the cycles /
    energy / EDP selection lens; ``space.mutate`` steps one axis.  The
    brood then runs **successive halving**: a cheap prefilter — the
    smallest zoo entry only, scored in-process through the shared mapping
    cache — ranks each lens class and only the top ``1/halving_eta``
    survive to full-zoo scoring through the supervisor.  ``budget`` counts
    full-zoo evaluations, *including* ledger hits on ``--resume`` (the
    evaluator is deterministic, so a resumed run replays the same
    trajectory and simply skips the compute).

    Deterministic per ``(seed, budget)``: same visited designs in the same
    order, same frontier, at any worker count (``SearchResult.extra``
    records the visit order for the provenance stamp).
    """
    rng = random.Random(seed)
    archive: dict[str, DesignEval] = {}
    visited: list[str] = []
    spent = 0
    _LOG.info("evolve search: budget=%d seed=%d pop=%d over space %r "
              "(raw size %d)", budget, seed, population, space.name,
              space.raw_size)

    # prefilter evaluator: one zoo entry (the smallest), no serving replay,
    # same cache/engine/objective — its mapping solves are strict subsets
    # of the full evaluation, so survivor scoring reuses them as cache hits
    pre_name = min(evaluator.zoo, key=lambda n: (len(evaluator.zoo[n]), n))
    pre_ev = Evaluator(zoo={pre_name: evaluator.zoo[pre_name]},
                       cache=evaluator.cache, objective=evaluator.objective,
                       engine=evaluator.engine, device=evaluator.device)
    pre_cache: dict[str, DesignEval] = {}

    with span("dse.evolve_search", cat="dse", space=space.name,
              budget=budget, seed=seed, population=population,
              workers=workers) as sp, \
            _supervised(evaluator, workers, supervisor) as pe:

        def full_eval(points: list[DesignPoint]) -> None:
            nonlocal spent
            todo, names = [], set()
            for p in points:
                if p.name not in archive and p.name not in names:
                    names.add(p.name)
                    todo.append(p)
            todo = todo[:max(0, budget - spent)]
            spent += len(todo)  # ledger hits short-circuit inside map()
            for p, e in zip(todo, pe.map(todo, log=log)):
                archive[p.name] = e
                visited.append(p.name)

        def prefilter(p: DesignPoint) -> DesignEval:
            e = pre_cache.get(p.name)
            if e is None:
                e = pre_cache[p.name] = pre_ev.evaluate(p)
            return e

        # generation 0: deterministic corners + random samples
        init = _corner_points(space)
        names = {p.name for p in init}
        for _ in range(population * 4):
            if len(init) >= population:
                break
            p = space.sample(rng)
            if p.name not in names:
                names.add(p.name)
                init.append(p)
        full_eval(init)

        stale = 0
        while spent < budget and stale < 3:
            parents = [e for e in archive.values() if not e.failed]
            if not parents:
                full_eval([space.sample(rng) for _ in range(population)])
                stale += 1
                continue
            brood: list[tuple[DesignPoint, int]] = []
            names = set()
            for ci in range(population * halving_eta * 2):
                lens = ci % len(_EVOLVE_KEYS)
                keyfn = _EVOLVE_KEYS[lens][1]
                k = min(tournament_k, len(parents))
                parent = min(rng.sample(parents, k), key=keyfn)
                child = space.mutate(parent.point, rng)
                if child.name in archive or child.name in names:
                    continue
                names.add(child.name)
                brood.append((child, lens))
                if len(brood) >= population * halving_eta:
                    break
            if not brood:
                stale += 1
                continue
            stale = 0
            # successive halving: keep the top 1/eta of each lens class by
            # its prefilter score, then full-zoo score only the survivors
            survivors: list[DesignPoint] = []
            for lens, (_, keyfn) in enumerate(_EVOLVE_KEYS):
                cls = [p for p, l in brood if l == lens]
                if not cls:
                    continue
                ranked = sorted(cls, key=lambda p: keyfn(prefilter(p)))
                keep = max(1, len(cls) // halving_eta)
                survivors.extend(ranked[:keep])
            full_eval(survivors)
            if log:
                best = min((e for e in archive.values() if not e.failed),
                           key=lambda e: e.cycles, default=None)
                log(f"evolve: {spent}/{budget} evals, archive="
                    f"{len(archive)}"
                    + (f", best_cycles={best.cycles:.3g}" if best else ""))

    evals = list(archive.values())
    return SearchResult(space=space.name, strategy="evolve", evals=evals,
                        frontier=pareto_frontier(evals),
                        wall_s=sp.duration_s,
                        cache_stats=evaluator.cache.stats,
                        supervisor=dict(pe.stats),
                        extra={"seed": seed, "budget": budget,
                               "spent": spent, "population": population,
                               "prefilter_zoo": pre_name,
                               "prefilter_evals": len(pre_cache),
                               "visited": visited})


def run_search(space: DesignSpace, evaluator: Evaluator,
               strategy: str = "auto", max_exhaustive: int = 96,
               log=None, workers: int = 1,
               supervisor: Supervisor | None = None, **kw) -> SearchResult:
    if strategy == "auto":
        strategy = ("exhaustive" if space.raw_size <= max_exhaustive
                    else "evolve")
    if strategy == "exhaustive":
        return exhaustive_search(space, evaluator, log=log, workers=workers,
                                 supervisor=supervisor)
    if strategy == "evolutionary":
        return evolutionary_search(space, evaluator, log=log,
                                   workers=workers, supervisor=supervisor,
                                   **kw)
    if strategy == "evolve":
        return evolve_search(space, evaluator, log=log, workers=workers,
                             supervisor=supervisor, **kw)
    raise ValueError(f"unknown strategy {strategy!r}")

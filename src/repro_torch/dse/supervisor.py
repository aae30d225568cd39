"""Supervised worker pool + resumable run ledger for crash-safe DSE sweeps:
the twin of the reference's ``repro.dse.supervisor``.

``ProcessPoolExecutor.map`` treats the pool as infallible: one worker
segfault raises ``BrokenProcessPool`` and throws away every completed
evaluation, one hung mapper call stalls the sweep forever, and one Ctrl-C
loses any unmerged mapping-cache entries.  At the sweep scales the ROADMAP
targets (10⁵–10⁶ designs) those are certainties, not edge cases.

:class:`Supervisor` replaces blind ``pool.map`` with per-point dispatch
over a hand-rolled pool — one ``multiprocessing.Process`` + duplex pipe per
worker, so a crash or hang is attributed to exactly the task that caused
it (an executor breaks *every* in-flight future on one worker death, which
makes attribution, and therefore fair retry budgets, impossible):

* **timeouts** — each dispatched task carries a deadline; a worker past it
  is SIGKILLed and respawned (``dse.worker_respawns`` /
  ``dse.task_timeouts`` counters, a ``dse.worker_respawn`` span);
* **bounded retries** — a failed task backs off exponentially and retries
  up to ``max_retries`` times (``dse.retries``); a point that keeps
  failing is *quarantined*: recorded as a failure-stub
  :class:`~repro_torch.dse.evaluate.DesignEval` (``error`` set, excluded from
  the Pareto frontier), never a sweep abort (``dse.quarantined_points``);
* **graceful degradation** — after ``max_respawns`` worker deaths the pool
  is torn down and the remaining points run in-process sequentially;
* **checkpointing** — completed evals and drained mapping-cache entries
  append to a :class:`RunLedger` (atomic JSON, content-keyed by
  ``DesignPoint.name``), flushed every ``checkpoint_every`` completions
  and on *any* exit path, so a resumed sweep re-evaluates only the missing
  points after a kill (``dse.ledger_hits``).

Fault injection (:mod:`repro_torch.dse.faults`) hooks the same dispatch
path: the plan fires on a task's first attempt only, so every injected
crash / hang / transient recovers through the retry machinery and an
injected sweep's frontier is bit-identical to the clean run.

Pooled workers build their :class:`Evaluator` with no engine, as the
reference's do: they solve mapping misses on the host with NumPy, and CUDA
never runs in a child.  Workers fork, unless CUDA is already up in this
process (a forked child of a process with a CUDA context dies at its first
CUDA call); then they spawn, as the reference spawns once jax is loaded.
"""

from __future__ import annotations

import json
import multiprocessing
import multiprocessing.connection
import os
import time
from collections import deque
from dataclasses import dataclass

import torch

from ..obs import (METRICS, disable_tracing, drain_events, enable_tracing,
                   get_logger, instant, merge_events, span, tracing_enabled)

from .cache import MappingCache, atomic_write_json
from .evaluate import DesignEval, Evaluator
from .faults import FaultPlan, SweepKilled
from .space import DesignPoint

_LOG = get_logger("dse.supervisor")

__all__ = ["Supervisor", "SupervisorConfig", "RunLedger", "failure_stub"]


@dataclass(frozen=True)
class SupervisorConfig:
    """Retry / timeout / checkpoint policy for one supervised sweep."""

    task_timeout_s: float | None = None  # None: no hang detection
    max_retries: int = 2                 # failures per point before quarantine
    backoff_base_s: float = 0.05         # first retry delay
    backoff_factor: float = 2.0          # exponential backoff multiplier
    max_respawns: int = 8                # worker deaths before sequential
    checkpoint_every: int = 10           # ledger flush cadence (completions)

    def backoff_s(self, failures: int) -> float:
        return self.backoff_base_s * self.backoff_factor ** max(
            0, failures - 1)


def failure_stub(point: DesignPoint, error: str, retries: int) -> DesignEval:
    """A ``DesignEval``-shaped record of a quarantined poison point: zero
    objectives, ``error`` set — reporting keeps it out of the frontier."""
    return DesignEval(point=point, cycles=0.0, energy_pj=0.0, area_mm2=0.0,
                      power_mw=0.0, macs=0.0, per_config={}, error=error,
                      retries=retries)


# ---------------------------------------------------------------------------
# run ledger (checkpoint / resume)
# ---------------------------------------------------------------------------

class RunLedger:
    """Append-style sweep checkpoint: completed evals (content-keyed by
    ``DesignPoint.name``) + mapping-cache entries drained from workers.

    The file is rewritten atomically on every flush — cheap at sweep sizes
    where resume matters (a flush is one ``json.dump`` of completed work)
    and immune to torn writes.  A ``run_key`` dict identifies the sweep
    (space, configs, objective, ...); a ledger whose key disagrees is
    ignored on load so ``--resume`` can never splice two different sweeps.

    Quarantined failure stubs are recorded (the artifact stays auditable)
    but **not** resumed — a poison point gets a fresh chance after a
    restart, since its failure may have been environmental."""

    SCHEMA = 1

    def __init__(self, path: str | os.PathLike,
                 run_key: dict | None = None):
        self.path = os.fspath(path)
        self.run_key = run_key or {}
        self._evals: dict[str, dict] = {}
        self._cache_entries: dict[str, dict] = {}
        self._frontiers: list[dict] = []
        self._dirty = False
        self.flushes = 0

    def __len__(self) -> int:
        return len(self._evals)

    def load(self) -> int:
        """Adopt a previous run's ledger (tolerant: unreadable, stale-schema
        or foreign-run files count as empty).  Returns evals loaded."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return 0
        except (OSError, json.JSONDecodeError) as e:
            _LOG.warning("run ledger %s unreadable (%s: %s) — starting "
                         "fresh", self.path, type(e).__name__, e)
            return 0
        if payload.get("schema") != self.SCHEMA:
            _LOG.warning("run ledger %s has schema %r (want %d) — starting "
                         "fresh", self.path, payload.get("schema"),
                         self.SCHEMA)
            return 0
        if self.run_key and payload.get("run_key") != self.run_key:
            _LOG.warning("run ledger %s belongs to a different sweep "
                         "(%r != %r) — starting fresh", self.path,
                         payload.get("run_key"), self.run_key)
            return 0
        self._evals = dict(payload.get("evals", {}))
        self._cache_entries = dict(payload.get("cache_entries", {}))
        self._frontiers = list(payload.get("frontier_snapshots", []))
        return len(self._evals)

    def completed_evals(self) -> dict[str, DesignEval]:
        """name → :class:`DesignEval` for every *successful* ledger entry
        (failure stubs re-evaluate on resume)."""
        out: dict[str, DesignEval] = {}
        for name, d in self._evals.items():
            if d.get("error") is not None:
                continue
            out[name] = DesignEval.from_dict(d)
        return out

    def evals(self) -> list[DesignEval]:
        """Every recorded eval (incl. failure stubs) — the partial-artifact
        payload after a mid-sweep kill."""
        return [DesignEval.from_dict(d) for d in self._evals.values()]

    def cache_entries(self) -> dict[str, dict]:
        return dict(self._cache_entries)

    def record(self, e: DesignEval) -> None:
        self._evals[e.point.name] = e.as_dict()
        self._dirty = True

    def add_cache_entries(self, entries: dict[str, dict]) -> None:
        if entries:
            self._cache_entries.update(entries)
            self._dirty = True

    def record_frontier(self, frontier: list[DesignEval]) -> None:
        """Append one periodic frontier snapshot (long-sweep progress
        audit): evals seen so far + the names of the current survivors.
        :mod:`repro_torch.dse.batch_sweep` records one every ``snapshot_every``
        tiles, so a killed 10⁵-design run still shows how the frontier
        converged."""
        self._frontiers.append({"n_evals": len(self._evals),
                                "frontier": [e.point.name for e in frontier]})
        self._dirty = True
        METRICS.counter("dse.frontier_snapshots").inc()

    def frontier_snapshots(self) -> list[dict]:
        return list(self._frontiers)

    def flush(self) -> None:
        if not self._dirty:
            return
        atomic_write_json(self.path,
                          {"schema": self.SCHEMA, "run_key": self.run_key,
                           "evals": self._evals,
                           "cache_entries": self._cache_entries,
                           "frontier_snapshots": self._frontiers},
                          separators=(",", ":"))
        self._dirty = False
        self.flushes += 1


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

_WORKER: dict = {}


def _init_worker(zoo, objective, warm_entries, baseline=None,
                 trace: bool = False, faults: FaultPlan | None = None,
                 serving=None):
    """Build this worker's Evaluator around a private in-memory mapping
    cache, warm-started with the parent's entries.

    Observability state is reset first: a forked worker inherits the
    parent's trace buffer and metric totals, which would double-count on
    merge.  Tracing is re-enabled iff the parent traced."""
    drain_events()
    METRICS.reset()
    enable_tracing() if trace else disable_tracing()
    cache = MappingCache()
    cache.merge(warm_entries)  # merge bypasses the put() journal, so the
    _WORKER["ev"] = Evaluator(  # warm entries never echo back to the parent
        zoo=zoo, cache=cache, objective=objective, baseline=baseline,
        serving=serving)
    _WORKER["faults"] = faults


def _eval_payload(point: DesignPoint):
    """One evaluation + everything the parent merges on completion."""
    ev: Evaluator = _WORKER["ev"]
    h0, m0 = ev.cache.hits, ev.cache.misses
    e = ev.evaluate(point)
    return (e, ev.cache.drain_new(),
            ev.cache.hits - h0, ev.cache.misses - m0,
            drain_events(), METRICS.drain())


def _worker_main(conn, init_args) -> None:
    """Worker loop: recv ``(seq, attempt, point)``, send ``(seq, "ok",
    payload)`` or ``(seq, "err", message)``.  ``None`` shuts down.

    Exceptions are *returned*, not raised — only a genuine crash (signal,
    ``os._exit``) severs the pipe, which is exactly the signal the
    supervisor's death detection keys on."""
    _init_worker(*init_args)
    faults: FaultPlan | None = _WORKER.get("faults")
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError, KeyboardInterrupt):
            return
        if msg is None:
            conn.close()
            return
        seq, attempt, point = msg
        try:
            if faults is not None and attempt == 0:
                faults.fire(seq)  # may os._exit / sleep / raise
            payload = _eval_payload(point)
        except KeyboardInterrupt:
            return
        except BaseException as e:
            try:
                conn.send((seq, "err", f"{type(e).__name__}: {e}"))
            except Exception:
                os._exit(1)
        else:
            conn.send((seq, "ok", payload))


@dataclass
class _Task:
    idx: int                 # position in the submitted point list
    point: DesignPoint
    seq: int                 # global dispatch slot (fault-plan addressing)
    attempt: int = 0
    failures: int = 0
    not_before: float = 0.0  # monotonic time gate (retry backoff)
    last_error: str = ""


class _Worker:
    __slots__ = ("proc", "conn", "task", "deadline")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.task: _Task | None = None
        self.deadline: float | None = None


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

class Supervisor:
    """Crash-safe :class:`DesignPoint` evaluation with in-order results.

    ``workers=1`` evaluates in-process (still with retry + quarantine —
    injected crashes/hangs downgrade to exceptions there); ``workers>1``
    runs the supervised pool.  ``completed`` (name → eval) short-circuits
    already-ledgered points on ``--resume``.  Reusable across ``map()``
    calls (the evolutionary strategy evaluates generation by generation);
    close with the context-manager protocol."""

    def __init__(self, evaluator: Evaluator, workers: int = 1,
                 cfg: SupervisorConfig | None = None,
                 fault_plan: FaultPlan | None = None,
                 ledger: RunLedger | None = None,
                 completed: dict[str, DesignEval] | None = None):
        self.evaluator = evaluator
        self.workers = max(1, int(workers))
        self.cfg = cfg or SupervisorConfig()
        self.faults = fault_plan if (fault_plan and fault_plan.active) \
            else None
        self.ledger = ledger
        self.completed = dict(completed or {})
        self.stats = {"evaluated": 0, "resumed": 0, "retries": 0,
                      "respawns": 0, "quarantined": 0, "timeouts": 0,
                      "degraded_sequential": False}
        self._seq = 0
        self._done = 0          # completions (kill_after accounting)
        self._unflushed = 0
        self._degraded = False
        self._pool: list[_Worker] = []
        # workers score on the host with NumPy, so forking is cheap and
        # safe — unless this process has a CUDA context, which a forked
        # child cannot use: then spawn fresh workers instead
        self._ctx = multiprocessing.get_context(
            "spawn" if torch.cuda.is_initialized() else None)

    # -- lifecycle --------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        for w in self._pool:
            try:
                w.conn.send(None)
            except Exception:
                pass
        for w in self._pool:
            w.proc.join(0.2)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(1.0)
            try:
                w.conn.close()
            except Exception:
                pass
        self._pool = []

    # -- public API -------------------------------------------------------
    def map(self, points: list[DesignPoint], log=None) -> list[DesignEval]:
        """Evaluate ``points`` (in submission order) surviving crashes,
        hangs and transient failures; the ledger is flushed on every exit
        path, including KeyboardInterrupt."""
        n = len(points)
        results: list[DesignEval | None] = [None] * n
        tasks: list[_Task] = []
        for i, p in enumerate(points):
            hit = self.completed.get(p.name)
            if hit is not None:
                results[i] = hit
                self.stats["resumed"] += 1
                METRICS.counter("dse.ledger_hits").inc()
                if log:
                    log(f"[{i + 1}/{n}] {p.name} (resumed)")
            else:
                tasks.append(_Task(idx=i, point=p, seq=self._seq))
                self._seq += 1
        try:
            if self.workers > 1 and not self._degraded and tasks:
                tasks = self._run_pool(tasks, results, n, log)
            if tasks:  # workers=1, or the pool degraded mid-sweep
                self._run_sequential(tasks, results, n, log)
        finally:
            if self.ledger is not None:
                self.ledger.flush()
        return results  # type: ignore[return-value]

    # -- shared bookkeeping ----------------------------------------------
    def _record(self, task: _Task, e: DesignEval, results, n, log) -> None:
        e.retries = task.failures
        results[task.idx] = e
        self.completed[task.point.name] = e
        self.stats["evaluated"] += 1
        if self.ledger is not None:
            self.ledger.record(e)
            self._unflushed += 1
            if self._unflushed >= self.cfg.checkpoint_every:
                self.ledger.flush()
                self._unflushed = 0
        if log:
            log(f"[{task.idx + 1}/{n}] {task.point.name}")
        self._done += 1
        if (self.faults and self.faults.kill_after
                and self._done >= self.faults.kill_after):
            _LOG.warning("fault plan: simulated SIGINT after %d completed "
                         "evaluations", self._done)
            raise SweepKilled(
                f"fault plan kill_after={self.faults.kill_after}")

    def _fail(self, task: _Task, err: str) -> bool:
        """Count one failure; True if the task still has retry budget."""
        task.failures += 1
        task.attempt += 1
        task.last_error = err
        if task.failures > self.cfg.max_retries:
            return False
        self.stats["retries"] += 1
        METRICS.counter("dse.retries").inc()
        instant("dse.retry", cat="dse", design=task.point.name,
                attempt=task.attempt, error=err)
        delay = self.cfg.backoff_s(task.failures)
        task.not_before = time.monotonic() + delay
        _LOG.warning("retry %d/%d for %s in %.2fs (%s)", task.failures,
                     self.cfg.max_retries, task.point.name, delay, err)
        return True

    def _quarantine(self, task: _Task, results, n, log) -> None:
        self.stats["quarantined"] += 1
        METRICS.counter("dse.quarantined_points").inc()
        _LOG.error("quarantining poison point %s after %d failures (%s)",
                   task.point.name, task.failures, task.last_error)
        stub = failure_stub(task.point, task.last_error, task.failures)
        results[task.idx] = stub
        self.stats["evaluated"] -= 1  # _record counts it; undo
        self._record(task, stub, results, n, log)

    # -- sequential path (workers=1 / degraded) ---------------------------
    def _run_sequential(self, tasks, results, n, log) -> None:
        cache = self.evaluator.cache
        for task in tasks:
            while True:
                try:
                    if self.faults is not None and task.attempt == 0:
                        self.faults.fire(task.seq, in_process=True)
                    e = self.evaluator.evaluate(task.point)
                except Exception as err:  # KeyboardInterrupt passes through
                    if not self._fail(task, f"{type(err).__name__}: {err}"):
                        self._quarantine(task, results, n, log)
                        break
                    time.sleep(max(
                        0.0, min(task.not_before - time.monotonic(), 1.0)))
                else:
                    if self.ledger is not None:
                        self.ledger.add_cache_entries(cache.drain_new())
                    self._record(task, e, results, n, log)
                    break

    # -- pool path --------------------------------------------------------
    def _init_args(self):
        ev = self.evaluator
        return (ev.zoo, ev.objective, ev.cache.snapshot(),
                getattr(ev, "baseline", None), tracing_enabled(),
                self.faults, getattr(ev, "serving", None))

    def _spawn_worker(self) -> _Worker:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker_main,
                                 args=(child_conn, self._init_args()),
                                 daemon=True)
        proc.start()
        child_conn.close()
        return _Worker(proc, parent_conn)

    def _ensure_pool(self) -> None:
        while len(self._pool) < self.workers:
            self._pool.append(self._spawn_worker())

    def _dispatch(self, w: _Worker, task: _Task, pending) -> bool:
        try:
            w.conn.send((task.seq, task.attempt, task.point))
        except (BrokenPipeError, OSError):
            # worker died while idle — not the task's fault: requeue it
            # untouched and respawn the worker
            pending.appendleft(task)
            self._respawn(w, "idle worker died")
            return False
        w.task = task
        w.deadline = (time.monotonic() + self.cfg.task_timeout_s
                      if self.cfg.task_timeout_s else None)
        return True

    def _respawn(self, w: _Worker, reason: str) -> None:
        """Kill-and-replace one worker; trips degradation past the budget."""
        try:
            w.proc.kill()
        except Exception:
            pass
        w.proc.join(1.0)
        try:
            w.conn.close()
        except Exception:
            pass
        self.stats["respawns"] += 1
        METRICS.counter("dse.worker_respawns").inc()
        if self.stats["respawns"] > self.cfg.max_respawns:
            if not self._degraded:
                _LOG.error("worker respawn budget exhausted (%d) — "
                           "degrading to in-process sequential evaluation",
                           self.cfg.max_respawns)
                self._degraded = True
                self.stats["degraded_sequential"] = True
            self._pool.remove(w)
            return
        with span("dse.worker_respawn", cat="dse", reason=reason):
            self._pool[self._pool.index(w)] = self._spawn_worker()
        _LOG.warning("respawned worker (%s); %d/%d respawns used", reason,
                     self.stats["respawns"], self.cfg.max_respawns)

    def _on_worker_death(self, w: _Worker, reason: str, pending, results,
                         n, log, timed_out: bool = False) -> None:
        task, w.task, w.deadline = w.task, None, None
        if timed_out:
            self.stats["timeouts"] += 1
            METRICS.counter("dse.task_timeouts").inc()
        self._respawn(w, reason)
        if task is not None:
            if not self._fail(task, reason):
                self._quarantine(task, results, n, log)
            else:
                pending.append(task)

    def _complete(self, task: _Task, payload, results, n, log) -> None:
        e, new, dh, dm, events, metrics = payload
        cache = self.evaluator.cache
        cache.merge(new)
        cache.hits += dh
        cache.misses += dm
        merge_events(events)
        METRICS.merge(metrics)
        if self.ledger is not None:
            self.ledger.add_cache_entries(new)
        self._record(task, e, results, n, log)

    def _run_pool(self, tasks, results, n, log) -> list[_Task]:
        """Supervised dispatch loop.  Returns the tasks still outstanding
        when the pool degrades (the caller finishes them sequentially);
        returns ``[]`` on normal completion."""
        pending: deque[_Task] = deque(tasks)
        self._ensure_pool()
        while pending or any(w.task is not None for w in self._pool):
            if self._degraded:
                leftovers = [w.task for w in self._pool
                             if w.task is not None] + list(pending)
                for t in leftovers:
                    t.not_before = 0.0
                self.close()
                return leftovers
            now = time.monotonic()
            # top up idle workers with backoff-ready tasks
            for w in self._pool:
                if w.task is not None:
                    continue
                task = self._next_ready(pending, now)
                if task is None:
                    break
                self._dispatch(w, task, pending)
            busy = [w for w in self._pool if w.task is not None]
            if not busy:
                if pending:  # everything is backing off — sleep it out
                    wake = min(t.not_before for t in pending)
                    time.sleep(max(0.0, min(wake - time.monotonic(), 1.0)))
                continue
            ready = multiprocessing.connection.wait(
                [w.conn for w in busy], timeout=self._wait_timeout(pending))
            for conn in ready:
                w = next(x for x in self._pool if x.conn is conn)
                try:
                    seq, status, payload = w.conn.recv()
                except (EOFError, OSError):
                    self._on_worker_death(
                        w, f"worker died (exit {w.proc.exitcode})",
                        pending, results, n, log)
                    continue
                task, w.task, w.deadline = w.task, None, None
                if task is None or seq != task.seq:
                    continue  # stale reply from a pre-respawn dispatch
                if status == "ok":
                    self._complete(task, payload, results, n, log)
                else:
                    if not self._fail(task, payload):
                        self._quarantine(task, results, n, log)
                    else:
                        pending.append(task)
            now = time.monotonic()
            for w in list(self._pool):  # hung-worker sweep
                if (w.task is not None and w.deadline is not None
                        and now > w.deadline):
                    self._on_worker_death(
                        w, f"task timeout after "
                           f"{self.cfg.task_timeout_s:g}s "
                           f"({w.task.point.name})",
                        pending, results, n, log, timed_out=True)
        return []

    @staticmethod
    def _next_ready(pending: deque, now: float) -> _Task | None:
        """Pop the first task whose backoff gate has passed (stable order)."""
        for _ in range(len(pending)):
            t = pending.popleft()
            if t.not_before <= now:
                return t
            pending.append(t)
        return None

    def _wait_timeout(self, pending) -> float | None:
        """How long the dispatch loop may block: until the nearest task
        deadline or backoff expiry, else indefinitely."""
        now = time.monotonic()
        candidates = [w.deadline for w in self._pool
                      if w.task is not None and w.deadline is not None]
        if pending and any(w.task is None for w in self._pool):
            candidates.append(min(t.not_before for t in pending))
        if not candidates:
            return None
        return max(0.0, min(candidates) - now + 0.01)

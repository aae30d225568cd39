"""Deterministic fault injection for the sweep robustness harness (a copy
of the reference's ``repro.dse.faults``).

A :class:`FaultPlan` is a seeded, fully deterministic description of the
faults to inject into a DSE sweep: worker crashes (``os._exit`` in pool
mode), hangs (a sleep long enough to trip the supervisor's task timeout),
transient exceptions, mapping-cache-file corruption, and a simulated
mid-sweep kill (``kill_after`` — raises a ``KeyboardInterrupt`` subclass in
the parent after N completed evaluations, exercising the SIGINT checkpoint
path without real signals).

Determinism contract: fault kinds are assigned to the first
``crash + hang + transient`` *dispatch-sequence slots* of the run, shuffled
by ``random.Random(seed)``, and each fires only on a task's **first**
attempt — so the supervisor's retry recovers every injected fault and an
injected sweep must converge to results bit-identical to the clean run.

Plans parse from a ``k=v`` comma spec (the reference CLI's
``--inject-faults`` flag, or the ``REPRO_FAULTS`` environment variable)::

    crash=1,hang=1,transient=2,corrupt=1,seed=7,hang_s=30,kill_after=0

In-process (``workers=1`` or degraded-sequential) evaluation cannot survive
a real ``os._exit`` or an un-killable sleep, so there crashes and hangs
downgrade to :class:`SimulatedCrash` / :class:`SimulatedHang` exceptions —
same retry path, same determinism bar.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass, fields

__all__ = ["FaultPlan", "parse_fault_spec", "plan_from_env",
           "corrupt_cache_file", "TransientFault", "SimulatedCrash",
           "SimulatedHang", "SweepKilled", "FAULTS_ENV"]

FAULTS_ENV = "REPRO_FAULTS"

_CRASH_EXIT = 13  # distinctive worker exit code for injected crashes


class TransientFault(RuntimeError):
    """Injected exception that succeeds on retry."""


class SimulatedCrash(RuntimeError):
    """In-process stand-in for a worker ``os._exit`` crash."""


class SimulatedHang(RuntimeError):
    """In-process stand-in for a hung worker (killed by timeout)."""


class SweepKilled(KeyboardInterrupt):
    """Deterministic stand-in for a mid-sweep SIGINT (``kill_after``)."""


@dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule for one sweep (all counts default to zero)."""

    seed: int = 0
    crash: int = 0       # workers that os._exit mid-evaluation
    hang: int = 0        # workers that sleep past the task timeout
    transient: int = 0   # evaluations that raise once, then succeed
    corrupt: int = 0     # mapping-cache entries to corrupt on disk
    kill_after: int = 0  # completed evals before a simulated SIGINT (0=off)
    hang_s: float = 60.0  # how long a hung worker sleeps (pool mode)

    def kinds(self) -> tuple[str, ...]:
        """Fault kind per dispatch-sequence slot, deterministically
        shuffled — slot ``i`` faults the ``i``-th task the supervisor
        dispatches, on that task's first attempt only."""
        kinds = (["crash"] * self.crash + ["hang"] * self.hang
                 + ["transient"] * self.transient)
        random.Random(self.seed).shuffle(kinds)
        return tuple(kinds)

    def kind_for(self, seq: int) -> str | None:
        kinds = self.kinds()
        return kinds[seq] if 0 <= seq < len(kinds) else None

    @property
    def active(self) -> bool:
        return bool(self.crash or self.hang or self.transient
                    or self.corrupt or self.kill_after)

    def fire(self, seq: int, in_process: bool = False) -> None:
        """Inject the fault assigned to dispatch slot ``seq`` (no-op when
        none is).  Pool workers really crash/hang; in-process evaluation
        raises the simulated equivalents instead."""
        kind = self.kind_for(seq)
        if kind is None:
            return
        if kind == "crash":
            if in_process:
                raise SimulatedCrash(f"injected worker crash (task {seq})")
            os._exit(_CRASH_EXIT)
        if kind == "hang":
            if in_process:
                raise SimulatedHang(f"injected worker hang (task {seq})")
            time.sleep(self.hang_s)  # parent's timeout kills us first
            return
        raise TransientFault(f"injected transient fault (task {seq})")

    def spec(self) -> str:
        """Round-trippable ``k=v`` spec (non-default fields only)."""
        parts = []
        for f in fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                parts.append(f"{f.name}={v:g}" if f.name == "hang_s"
                             else f"{f.name}={v}")
        return ",".join(parts)


def parse_fault_spec(spec: str) -> FaultPlan:
    """``"crash=1,hang=1,seed=7"`` → :class:`FaultPlan` (strict keys)."""
    known = {f.name: f.type for f in fields(FaultPlan)}
    kw: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"fault spec item {part!r} is not k=v "
                             f"(known keys: {', '.join(known)})")
        k, v = (s.strip() for s in part.split("=", 1))
        if k not in known:
            raise ValueError(f"unknown fault spec key {k!r} "
                             f"(known keys: {', '.join(known)})")
        try:
            kw[k] = float(v) if k == "hang_s" else int(v)
        except ValueError:
            raise ValueError(f"fault spec {k}={v!r} is not a number")
    return FaultPlan(**kw)


def plan_from_env(environ=None) -> FaultPlan | None:
    """The :data:`FAULTS_ENV` plan, if set (workers inherit the variable,
    so a pool sweep under ``REPRO_FAULTS`` faults consistently)."""
    spec = (environ or os.environ).get(FAULTS_ENV, "").strip()
    return parse_fault_spec(spec) if spec else None


def corrupt_cache_file(path: str, n: int, seed: int = 0) -> int:
    """Corrupt ``n`` entries of a mapping-cache JSON file in place.

    The entry payloads are mangled but the stored per-entry checksums are
    left untouched, so :meth:`repro_torch.dse.cache.MappingCache.load` must catch
    the mismatch and quarantine exactly the corrupted entries (never the
    whole store).  Returns the number of entries corrupted (0 when the file
    is missing or empty — nothing to corrupt is not an error)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return 0
    entries = payload.get("entries", {})
    if not entries:
        return 0
    keys = sorted(entries)
    victims = random.Random(seed).sample(keys, min(int(n), len(keys)))
    for k in victims:
        e = entries[k]
        if isinstance(e, dict) and isinstance(e.get("perf"), dict):
            e["perf"] = {**e["perf"], "cycles": -1.0}
        else:
            entries[k] = {"__corrupted__": True}
    with open(path, "w") as f:
        json.dump(payload, f, separators=(",", ":"))
    return len(victims)

"""Straggler detection for the training loop: a copy of
``repro.ft.straggler.StragglerMonitor`` (the port imports nothing of
``repro``; ``tests/test_torch_ckpt.py`` holds the copy to the original on
the same records).  The reference's ``ElasticPlanner`` / ``MeshPlan``
re-mesh a pod and wait for a port of ``parallel/``.

``StragglerMonitor`` keeps an EWMA of each host's step time, flags hosts
slower than ``ratio_threshold ×`` the fleet median for ``patience``
consecutive steps, and hard-fails hosts that miss ``dead_after``
heartbeats.
"""

from __future__ import annotations

import numpy as np

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 ratio_threshold: float = 1.8, patience: int = 3,
                 dead_after: int = 5):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.ratio_threshold = ratio_threshold
        self.patience = patience
        self.dead_after = dead_after
        self.ewma = np.full(n_hosts, np.nan)
        self.slow_streak = np.zeros(n_hosts, dtype=int)
        self.missed = np.zeros(n_hosts, dtype=int)
        self.step = 0

    def record(self, step_times: dict[int, float]) -> None:
        """step_times: host -> seconds for this step (absent = missed
        heartbeat).  Streak accounting happens here — once per recorded
        step — so :meth:`stragglers` / :meth:`healthy` are pure queries
        that can be called any number of times between steps."""
        self.step += 1
        for h in range(self.n_hosts):
            if h in step_times:
                t = step_times[h]
                self.missed[h] = 0
                prev = self.ewma[h]
                self.ewma[h] = t if np.isnan(prev) else \
                    self.alpha * t + (1 - self.alpha) * prev
            else:
                self.missed[h] += 1
        valid = self.ewma[~np.isnan(self.ewma)]
        if len(valid) < max(2, self.n_hosts // 2):
            return
        med = float(np.median(valid))
        for h in range(self.n_hosts):
            if np.isnan(self.ewma[h]):
                continue
            if self.ewma[h] > self.ratio_threshold * med:
                self.slow_streak[h] += 1
            else:
                self.slow_streak[h] = 0

    def stragglers(self) -> list[int]:
        """Hosts whose EWMA has exceeded ``ratio_threshold ×`` the fleet
        median for ``patience`` consecutive recorded steps.  Pure — the
        streaks advance only in :meth:`record`."""
        return [h for h in range(self.n_hosts)
                if self.slow_streak[h] >= self.patience]

    def dead(self) -> list[int]:
        return [h for h in range(self.n_hosts)
                if self.missed[h] >= self.dead_after]

    def healthy(self) -> list[int]:
        bad = set(self.stragglers()) | set(self.dead())
        return [h for h in range(self.n_hosts) if h not in bad]

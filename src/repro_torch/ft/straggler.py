"""Straggler detection for the training loop: a copy of
``repro.ft.straggler.StragglerMonitor`` (the port imports nothing of
``repro``; ``tests/test_torch_ckpt.py`` holds the copy to the original on
the same records), and copies of ``MeshPlan`` and ``ElasticPlanner``,
which pick the largest well-formed mesh over the hosts that survive
(``tests/test_torch_launch.py`` holds them to the originals); a plan's
``shape`` and ``axes`` are what :func:`repro_torch.launch.mesh.shape_mesh`
builds a ``DeviceMesh`` from.

``StragglerMonitor`` keeps an EWMA of each host's step time, flags hosts
slower than ``ratio_threshold ×`` the fleet median for ``patience``
consecutive steps, and hard-fails hosts that miss ``dead_after``
heartbeats.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

__all__ = ["StragglerMonitor", "MeshPlan", "ElasticPlanner"]


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


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    n_hosts: int

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


class ElasticPlanner:
    """Largest well-formed mesh over surviving hosts (model axis pinned)."""

    def __init__(self, devices_per_host: int = 4, model_axis: int = 16,
                 pods: int = 2, hosts_per_pod: int | None = None):
        self.devices_per_host = devices_per_host
        self.model_axis = model_axis
        self.pods = pods
        self.hosts_per_pod = hosts_per_pod

    def plan(self, healthy_hosts: list[int], total_hosts: int) -> MeshPlan:
        per_pod = self.hosts_per_pod or total_hosts // self.pods
        pod_health = defaultdict(int)
        for h in healthy_hosts:
            pod_health[h // per_pod] += 1
        # a pod participates only if all its hosts are healthy (symmetric DP)
        live_pods = [p for p in range(self.pods) if pod_health[p] == per_pod]
        if not live_pods:
            # degrade: use the healthiest pod with a shrunken data axis
            best = max(range(self.pods), key=lambda p: pod_health[p])
            hosts = pod_health[best]
            devices = hosts * self.devices_per_host
            data = max(1, devices // self.model_axis)
            while data > 1 and data * self.model_axis > devices:
                data -= 1
            # shrink to a power-of-two data axis for divisibility
            data = 1 << int(np.log2(max(1, data)))
            return MeshPlan((data, self.model_axis), ("data", "model"),
                            hosts)
        devices = per_pod * self.devices_per_host
        data = devices // self.model_axis
        if len(live_pods) == 1:
            return MeshPlan((data, self.model_axis), ("data", "model"),
                            per_pod)
        return MeshPlan((len(live_pods), data, self.model_axis),
                        ("pod", "data", "model"), per_pod * len(live_pods))

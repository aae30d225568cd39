"""Multi-workload design evaluator: the twin of the reference's
``repro.dse.evaluate``.

Lowers every :class:`~repro_torch.models.common.ModelConfig` in the zoo to
its layer workloads **once** through the model-graph frontend
(:mod:`repro_torch.frontend`), then scores each candidate design with
:func:`repro_torch.core.fusion.score_design_over_zoo`: all cache-missing
layer shapes of a workload kind are solved in **one batched query**
through the persistent :class:`~repro_torch.dse.cache.MappingCache`, and
cycles/energy aggregate per layer row plus area/power via the closed-form
estimators in :mod:`repro_torch.core.cost`.  With ``engine="torch"`` every
miss is scored on ``device`` (the card unless the caller names the CPU) by
:mod:`repro_torch.core.perf_model_torch`; the winners, and so every
scorecard, are byte-identical to the NumPy engine's.

With ``baseline="gemmini"`` the evaluator also scores every zoo entry on
the Gemmini model (:func:`repro_torch.core.baselines.gemmini_layer_perf`) —
baselines depend only on the zoo, so they are computed once per evaluator —
and each design's per-model scorecard gains ``speedup_vs_gemmini`` /
``energy_vs_gemmini``, the paper's Fig. 11/12 comparison axes that the
cross-model winner in :mod:`repro_torch.dse.report` maximizes.

Attention is heterogeneous: the frontend lowers it as the fused
``attn_qk``/``attn_pv`` pair.  Designs whose dataflow set carries spatial
menus for the attention workloads (``attention_fused``) map the pair
directly and receive the score-stationary P-residency credit
(:func:`repro_torch.core.fusion.apply_attention_fusion`); every other
design scores the plain per-GEMM fallback
(:func:`repro_torch.frontend.unfuse_attention_rows`).  Fusion-capable
designs additionally record ``speedup_fused_attention`` — the same design
point scored on the unfused lowering, the paper's Fig. 10 comparison.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

from ..core import workload as W
from ..core.baselines import gemmini_layer_perf
from ..core.cost import estimate_design_area_mm2, estimate_design_power_mw
from ..core.fusion import DesignScore, score_design_over_zoo
from ..core.perf_model_torch import ENGINES
from ..frontend import (has_attention_rows, lower_model,
                        unfuse_attention_rows)
from ..frontend import lower_zoo as _frontend_lower_zoo
from ..models.common import ModelConfig, check_device
from ..obs import METRICS, span
from ..serve.sim import DecodeCostModel, ServingSpec, simulate
from ..serve.trace import generate_trace

from .cache import MappingCache
from .space import DesignPoint

__all__ = ["lower_config", "load_zoo", "zoo_layers", "Evaluator",
           "DesignEval", "DEFAULT_ZOO", "gemmini_zoo_baseline"]

# four families: dense GLU, MoE, hybrid Mamba+attn+MoE, RWKV
DEFAULT_ZOO = ("gemma_7b", "glm4_9b", "deepseek_moe_16b", "rwkv6_7b")

_WL = {"gemm": W.gemm(), "conv": W.conv2d(), "dwconv": W.depthwise_conv2d(),
       "attn_qk": W.attention_qk(), "attn_pv": W.attention_pv()}


def lower_config(cfg: ModelConfig, seq: int = 512, batch: int = 1,
                 phase: str = "prefill") -> list:
    """ModelConfig → merged ``(kind, dims, repeat, nontensor)`` layer rows.

    Thin wrapper over :func:`repro_torch.frontend.lower_model` (kept as the
    historical DSE entry point).  ``phase="prefill"`` scores a prefill pass
    of ``batch`` sequences of ``seq`` tokens — the throughput-bound regime
    spatial accelerators target; ``phase="decode"`` scores one generated
    token against a ``seq``-token context.
    """
    return lower_model(cfg, seq=seq, batch=batch, phase=phase)


def load_zoo(config_names=DEFAULT_ZOO, seq: int = 512, batch: int = 1,
             reduced: bool = False,
             phases=("prefill",)) -> dict[str, list]:
    """Lower every named config once per phase: {key: [(kind, dims, rep,
    nt)]} — keys are config ids, suffixed ``@phase`` when several phases are
    requested (see :func:`repro_torch.frontend.lower_zoo`)."""
    return _frontend_lower_zoo(config_names, seq=seq, batch=batch,
                               phases=phases, reduced=reduced)


def zoo_layers(zoo: dict[str, list], fused: bool) -> dict[str, list]:
    """Workload-resolved layer rows per zoo entry.  ``fused=False``
    rewrites the attention pair to the plain per-GEMM lowering — the
    fallback for designs whose dataflow set cannot map the attention
    workloads, and the comparison zoo for the fusion-speedup record."""
    out = {}
    for name, rows in zoo.items():
        if not fused:
            rows = unfuse_attention_rows(rows)
        out[name] = [(_WL[kind], dims, rep, nt)
                     for kind, dims, rep, nt in rows]
    return out


def gemmini_zoo_baseline(zoo: dict[str, list]) -> dict[str, dict]:
    """Score every zoo entry on the Gemmini baseline (§VI-A comparison).

    Depends only on the lowered rows — one pass per zoo, reused across all
    candidate designs of a sweep.  Fused ``attn_qk``/``attn_pv`` rows are
    unfused first: Gemmini executes attention as independent per-head GEMMs
    with the score tensor taking the HBM round trip.
    """
    out: dict[str, dict] = {}
    for name, rows in zoo.items():
        cyc = en = macs = 0.0
        for kind, dims, rep, nt in unfuse_attention_rows(rows):
            p = gemmini_layer_perf(kind, dims, ppu_elements=nt)
            cyc += rep * p.cycles
            en += rep * p.energy_pj
            macs += rep * p.macs
        out[name] = {"cycles": cyc, "energy_pj": en, "macs": macs,
                     "gops": 2.0 * macs / max(1.0, cyc)}
    return out


# ---------------------------------------------------------------------------
# per-design scorecard
# ---------------------------------------------------------------------------

@dataclass
class DesignEval:
    """Scorecard of one design across the whole zoo (all objectives in one
    place so Pareto extraction is a pure post-processing step)."""

    point: DesignPoint
    cycles: float
    energy_pj: float
    area_mm2: float
    power_mw: float
    macs: float
    per_config: dict[str, dict] = field(default_factory=dict)
    # serving scorecard (serve.sim.ServingResult.summary()) when the
    # evaluator replays a traffic trace against the design
    serving: dict | None = None
    # robustness bookkeeping (dse.supervisor): a point that exhausts
    # its retry budget is recorded as a failure stub, not a sweep abort
    error: str | None = None
    retries: int = 0

    @property
    def failed(self) -> bool:
        """True for a quarantined poison point — excluded from the Pareto
        frontier, kept in the scorecard so the sweep stays auditable."""
        return self.error is not None

    @property
    def gops(self) -> float:
        return 2.0 * self.macs / max(1.0, self.cycles)

    @property
    def edp(self) -> float:
        return self.cycles * self.energy_pj

    def objectives(self) -> tuple[float, float, float]:
        """The minimized Pareto axes: (cycles, energy, area) for static
        sweeps; with a serving scorecard attached the latency axis becomes
        traffic-mix goodput (negated — higher is better)."""
        if self.serving is not None:
            return (-self.serving["goodput_tps"], self.energy_pj,
                    self.area_mm2)
        return (self.cycles, self.energy_pj, self.area_mm2)

    def as_dict(self) -> dict:
        d = {"design": self.point.as_dict(), "cycles": self.cycles,
             "energy_pj": self.energy_pj, "area_mm2": self.area_mm2,
             "power_mw": self.power_mw, "macs": self.macs,
             "gops": self.gops, "per_config": self.per_config}
        if self.serving is not None:
            d["serving"] = self.serving
        if self.error is not None:
            # only failure stubs carry retry provenance in artifacts: a
            # recovered eval is bit-identical to one that never faulted,
            # with its retry count reported via the supervisor stats
            # section
            d["error"] = self.error
            d["retries"] = self.retries
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DesignEval":
        """Inverse of :meth:`as_dict` — the run-ledger resume path."""
        return cls(point=DesignPoint.from_dict(d["design"]),
                   cycles=d["cycles"], energy_pj=d["energy_pj"],
                   area_mm2=d["area_mm2"], power_mw=d["power_mw"],
                   macs=d["macs"], per_config=d.get("per_config", {}),
                   serving=d.get("serving"),
                   error=d.get("error"), retries=int(d.get("retries", 0)))


class Evaluator:
    """Scores :class:`DesignPoint`s against a fixed, pre-lowered zoo.

    ``engine`` and ``device`` pick the mapping-miss solver: ``"torch"``
    scores on ``device`` (the card by default; it must exist), ``"numpy"``
    and ``"scalar"`` on the host."""

    def __init__(self, zoo: dict[str, list] | None = None,
                 cache: MappingCache | None = None,
                 objective: str = "cycles",
                 baseline: str | None = None,
                 engine: str = "numpy",
                 serving: ServingSpec | None = None,
                 device="cuda"):
        self.zoo = zoo if zoo is not None else load_zoo()
        self.cache = cache if cache is not None else MappingCache()
        self.objective = objective
        # a ServingSpec turns every evaluation into a traffic-trace replay
        # on top of the static scorecard: the DesignEval gains a `serving`
        # section and its Pareto latency axis becomes goodput-under-SLO
        self.serving = serving
        self._serving_trace = (generate_trace(serving.trace)
                               if serving is not None else None)
        if baseline not in (None, "gemmini"):
            raise ValueError(f"unknown baseline {baseline!r}")
        self.baseline = baseline
        if engine not in ENGINES and engine != "batch":
            raise ValueError(f"unknown engine {engine!r} "
                             f"(expected one of {ENGINES})")
        # miss-solver selection only: mapping-cache keys carry no engine
        # field and all engines return byte-identical winners, so a cache
        # (or frontier) produced under one engine is valid under any other
        self.engine = engine
        self.device = check_device(device) if engine == "torch" else device
        self._baselines: dict[str, dict] | None = None

    @property
    def baselines(self) -> dict[str, dict]:
        """Per-zoo-entry baseline scores (empty when no baseline is set);
        computed lazily once — they only depend on the zoo."""
        if self.baseline is None:
            return {}
        if self._baselines is None:
            self._baselines = gemmini_zoo_baseline(self.zoo)
        return self._baselines

    def _zoo_layers(self, fused: bool) -> dict[str, list]:
        return zoo_layers(self.zoo, fused)

    def evaluate(self, point: DesignPoint) -> DesignEval:
        with span("dse.evaluate", cat="dse", design=point.name):
            return self._evaluate(point)

    def _evaluate(self, point: DesignPoint) -> DesignEval:
        hw = point.hw_config()
        fused = (point.supports("attention_qk")
                 and point.supports("attention_pv"))
        METRICS.counter("dse.designs_scored").inc()
        METRICS.counter("dse.designs_fused_capable" if fused
                        else "dse.designs_unfused").inc()
        zoo_layers = self._zoo_layers(fused)
        # all cache-missing layer shapes of a workload kind solve in a
        # single batched query through the persistent mapping cache
        solve = functools.partial(self.cache.best_mapping_perfs,
                                  engine=self.engine, device=self.device)
        scores = score_design_over_zoo(
            zoo_layers, point.spatials, hw, objective=self.objective,
            batch_mapping_fn=solve)

        # the same design point scored on the unfused per-GEMM lowering —
        # the denominator of the paper's fused-attention speedup claim.
        # Only attention-bearing entries differ, and their layer shapes hit
        # the mapping cache, so the extra pass is cheap.
        unfused_scores = {}
        if fused:
            unfused_scores = score_design_over_zoo(
                {n: ls for n, ls in self._zoo_layers(False).items()
                 if has_attention_rows(self.zoo[n])},
                point.spatials, hw, objective=self.objective,
                batch_mapping_fn=solve)

        base = self.baselines
        total = DesignScore()
        per_config = {}
        for cfg_name, s in scores.items():
            rec = {
                "cycles": s.cycles, "energy_pj": s.energy_pj,
                "macs": s.macs, "gops": s.gops,
                "gops_per_w": s.gops_per_w,
                "utilization": s.macs / (point.n_fus * max(1.0, s.cycles)),
            }
            b = base.get(cfg_name)
            if b is not None:
                rec["speedup_vs_gemmini"] = b["cycles"] / max(1.0, s.cycles)
                rec["energy_vs_gemmini"] = (b["energy_pj"]
                                            / max(1.0, s.energy_pj))
            u = unfused_scores.get(cfg_name)
            if u is not None:
                rec["speedup_fused_attention"] = (u.cycles
                                                  / max(1.0, s.cycles))
                rec["energy_fused_attention"] = (u.energy_pj
                                                 / max(1.0, s.energy_pj))
            per_config[cfg_name] = rec
            total.add(1.0, s.cycles, s.energy_pj, s.macs, s.ppu_cycles)

        area = estimate_design_area_mm2(
            point.n_fus, point.buffer_bytes, n_dataflows=point.n_dataflows,
            n_ppus=point.n_ppus)
        power = estimate_design_power_mw(
            point.n_fus, point.buffer_bytes, n_dataflows=point.n_dataflows,
            n_ppus=point.n_ppus)
        serving = None
        if self.serving is not None:
            cm = DecodeCostModel(point, cache=self.cache,
                                 engine=self.engine,
                                 objective=self.objective,
                                 reduced=self.serving.reduced,
                                 device=self.device)
            serving = simulate(point, self._serving_trace,
                               spec=self.serving,
                               cost_model=cm).summary()
        return DesignEval(point=point, cycles=total.cycles,
                          energy_pj=total.energy_pj,
                          area_mm2=area["total_mm2"],
                          power_mw=power["total_mw"], macs=total.macs,
                          per_config=per_config, serving=serving)

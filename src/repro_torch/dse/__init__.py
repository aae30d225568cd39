"""Design-space exploration of the port: the twin of the reference's
``repro.dse``, with every mapping miss scored on the card.

``space``       — declarative :class:`DesignSpace` over candidate ``HWConfig``s
``evaluate``    — lower every model config to layer workloads, score each
design (``Evaluator(engine="torch")`` scores misses on ``device``)
``cache``       — content-hashed persistent mapping cache in the reference's
file format (checksummed entries, lock-guarded multi-process merge)
``search``      — Pareto frontier + exhaustive / evolutionary / evolve
strategies
``supervisor``  — crash-safe worker pool (timeouts, retries, quarantine,
degradation) + resumable :class:`RunLedger` checkpoints
``faults``      — seeded deterministic fault injection
``report``      — frontier and scorecard text, cross-model winner, the
sweep's JSON writers, the frontier's Verilog (``emit_frontier_rtl``)
``batch_sweep`` — design-batched sweep (prefill on the card, then evaluate)
and the design search's command line, the twin of ``benchmarks/dse.py``
(``python -m repro_torch.dse.batch_sweep``)

Importing this package loads torch but does not initialise CUDA.  Unlike
the reference's package, ``repro_torch.dse.batch_sweep`` names the module
(the CLI, ``python -m repro_torch.dse.batch_sweep``); the sweep itself is
``repro_torch.dse.batch_sweep.batch_sweep``.  ``plan_tiles`` resolves on
first use (PEP 562), so that running the module does not import it twice.
"""

from .cache import MappingCache, atomic_write_json
from .evaluate import (DesignEval, Evaluator, gemmini_zoo_baseline, load_zoo,
                       lower_config)
from .faults import (FaultPlan, corrupt_cache_file, parse_fault_spec,
                     plan_from_env)
from .report import (cross_model_winner, format_frontier, format_models,
                     format_scorecard, format_serving, write_bench_json,
                     write_models_json)
from .search import (SearchResult, dominates, evolutionary_search,
                     evolve_search, exhaustive_search, pareto_frontier,
                     run_search)
from .space import DATAFLOW_SETS, SPACES, DesignPoint, DesignSpace
from .supervisor import RunLedger, Supervisor, SupervisorConfig

__all__ = [
    "DesignPoint", "DesignSpace", "SPACES", "DATAFLOW_SETS",
    "MappingCache", "atomic_write_json",
    "Evaluator", "DesignEval", "load_zoo", "lower_config",
    "gemmini_zoo_baseline",
    "pareto_frontier", "dominates", "exhaustive_search",
    "evolutionary_search", "evolve_search", "run_search", "SearchResult",
    "plan_tiles",
    "Supervisor", "SupervisorConfig", "RunLedger",
    "FaultPlan", "parse_fault_spec", "plan_from_env", "corrupt_cache_file",
    "format_frontier", "format_scorecard", "format_serving",
    "write_bench_json", "cross_model_winner", "format_models",
    "write_models_json",
]


def __getattr__(name: str):
    if name == "plan_tiles":
        from .batch_sweep import plan_tiles
        return plan_tiles
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

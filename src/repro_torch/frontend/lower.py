"""Model-graph → LEGO workload lowering (the config→workload contract).

One lowering *row* is ``(kind, dims, repeat, nontensor)``:

``kind``
    ``"gemm"`` | ``"conv"`` | ``"dwconv"`` | ``"attn_qk"`` | ``"attn_pv"``
    — the LEGO workload the row maps onto
    (:func:`repro_torch.core.workload.gemm` / :func:`~repro_torch.core.workload.conv2d`
    / :func:`~repro_torch.core.workload.depthwise_conv2d` /
    :func:`~repro_torch.core.workload.attention_qk` /
    :func:`~repro_torch.core.workload.attention_pv`);
``dims``
    that workload's iteration-dim sizes by name (``i/j/k`` for GEMM,
    ``n/oc/ic/oh/ow/kh/kw`` for conv, ``n/c/oh/ow/kh/kw`` for dwconv,
    ``b/m/n/d`` for the fused attention pair);
``repeat``
    how many times the shape executes end-to-end (layers × heads × experts ×
    batch folded in by the graph builder);
``nontensor``
    PPU element count per execution (softmax/norm/scan/token-shift) — LEGO
    runs these on-chip, the Gemmini baseline pays a DRAM round trip.

:func:`merge_rows` deduplicates identical ``(kind, dims, nontensor)`` shapes
by summing repeats, so the mapper never sees the same shape twice within one
model — MAC totals are preserved exactly.  The full contract (with a worked
Llama-4 example) is documented in ``docs/MODELS.md``.
"""

from __future__ import annotations

from typing import Iterable

from ..configs import ARCH_IDS, get_config
from ..models.common import ModelConfig

from .model_graph import PHASES, ModelGraph, build_model_graph

__all__ = ["Row", "merge_rows", "lower_model", "lower_zoo", "zoo_key",
           "unfuse_attention_rows", "has_attention_rows", "ATTENTION_KINDS"]

# (kind, dims, repeat, nontensor) — the evaluator/scoring row format
Row = tuple[str, dict[str, int], int, float]

# row kinds of the score-stationary fused attention pair
ATTENTION_KINDS = ("attn_qk", "attn_pv")


def has_attention_rows(rows: Iterable[Row]) -> bool:
    """True when the lowering kept the fused attn_qk/attn_pv pair."""
    return any(kind in ATTENTION_KINDS for kind, _, _, _ in rows)


def unfuse_attention_rows(rows: Iterable[Row]) -> list[Row]:
    """Rewrite fused ``attn_qk``/``attn_pv`` rows to the plain-GEMM lowering.

    This is the fallback for designs whose dataflow set has no spatial menu
    for the attention workloads: the batched ``b`` head×batch dim folds back
    into the repeat count and each stage becomes one GEMM per head —
    ``attn_qk(b,m,n,d)`` → ``gemm(i=m, j=n, k=d) × b`` and
    ``attn_pv(b,m,n,d)`` → ``gemm(i=m, j=d, k=n) × b``.  Total MACs and PPU
    elements are preserved exactly; P takes the HBM round trip this time
    (no residency credit — that is the whole point of the comparison).
    """
    out: list[Row] = []
    for kind, dims, rep, nt in rows:
        if kind == "attn_qk":
            b = dims["b"]
            out.append(("gemm", dict(i=dims["m"], j=dims["n"], k=dims["d"]),
                        rep * b, nt / b))
        elif kind == "attn_pv":
            b = dims["b"]
            out.append(("gemm", dict(i=dims["m"], j=dims["d"], k=dims["n"]),
                        rep * b, nt / b))
        else:
            out.append((kind, dims, rep, nt))
    return merge_rows(out)


def merge_rows(rows: Iterable[Row]) -> list[Row]:
    """Deduplicate rows with identical (kind, dims, nontensor) by summing
    repeats; first-appearance order is kept so lowering is deterministic."""
    merged: dict[tuple, list] = {}
    for kind, dims, rep, nt in rows:
        key = (kind, tuple(sorted(dims.items())), nt)
        if key in merged:
            merged[key][2] += rep
        else:
            merged[key] = [kind, dict(dims), rep, nt]
    return [tuple(v) for v in merged.values()]  # type: ignore[misc]


def lower_model(cfg: ModelConfig | str, *, seq: int = 512, batch: int = 1,
                phase: str = "prefill", reduced: bool = False,
                lm_head: bool = True,
                fused_attention: bool = True) -> list[Row]:
    """Lower one model (config object or ``repro_torch.configs`` id) to merged
    workload rows for one execution phase.  ``fused_attention=False`` keeps
    the historical per-GEMM attention lowering (see
    :func:`unfuse_attention_rows`)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg, reduced=reduced)
    graph = build_model_graph(cfg, seq=seq, batch=batch, phase=phase,
                              lm_head=lm_head,
                              fused_attention=fused_attention)
    return graph.lowered()


def zoo_key(name: str, phase: str, phases: Iterable[str]) -> str:
    """Zoo dict key for one (model, phase) variant: the bare model id when a
    single phase is swept, ``id@phase`` otherwise."""
    return name if len(tuple(phases)) == 1 else f"{name}@{phase}"


def lower_zoo(names: Iterable[str] | None = None, *, seq: int = 512,
              batch: int = 1, phases: Iterable[str] = ("prefill",),
              reduced: bool = False,
              lm_head: bool = True,
              fused_attention: bool = True) -> dict[str, list[Row]]:
    """Lower every named config once per phase: ``{key: rows}``.

    ``names=None`` lowers the whole assigned zoo (``repro_torch.configs.ARCH_IDS``).
    """
    names = list(ARCH_IDS if names is None else names)
    phases = tuple(phases)
    for p in phases:
        if p not in PHASES:
            raise ValueError(f"unknown phase {p!r}; known: {PHASES}")
    zoo: dict[str, list[Row]] = {}
    for name in names:
        cfg = get_config(name, reduced=reduced)
        for phase in phases:
            zoo[zoo_key(name, phase, phases)] = lower_model(
                cfg, seq=seq, batch=batch, phase=phase, lm_head=lm_head,
                fused_attention=fused_attention)
    return zoo

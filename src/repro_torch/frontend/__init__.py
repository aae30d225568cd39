"""Model-zoo frontend of the port (a copy of the reference's
``repro.frontend``): ``repro_torch.configs`` specs → operator graphs →
LEGO tensor workloads.

``model_graph`` — :func:`build_model_graph` walks a
:class:`~repro_torch.models.common.ModelConfig` into an :class:`OpNode`
graph per execution phase (prefill / decode).

``lower`` — :func:`lower_model` / :func:`lower_zoo` turn graphs into the
deduplicated ``(kind, dims, repeat, nontensor)`` rows the DSE consumes.
"""

from .lower import (ATTENTION_KINDS, Row, has_attention_rows, lower_model,
                    lower_zoo, merge_rows, unfuse_attention_rows, zoo_key)
from .model_graph import PHASES, ModelGraph, OpNode, build_model_graph

__all__ = [
    "OpNode", "ModelGraph", "build_model_graph", "PHASES",
    "Row", "merge_rows", "lower_model", "lower_zoo", "zoo_key",
    "ATTENTION_KINDS", "has_attention_rows", "unfuse_attention_rows",
]

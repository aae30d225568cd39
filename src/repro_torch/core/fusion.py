"""The data-node estimate of the reference's ``repro.core.fusion``.

Only :func:`estimate_data_nodes` is copied: the DSE's mapping queries carry
it (it is part of every mapping-cache key), and the port builds no ADG, so
the rest of the reference's fusion planning has no twin here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["estimate_data_nodes"]


def estimate_data_nodes(n_fus: int, tensor_names: list[str] | tuple[str, ...]
                        ) -> dict[str, int]:
    """Analytic proxy for the data-node pressure when no ADG is built.

    LEGO's interconnection generation feeds a P×P array from one edge of data
    nodes per tensor (O(√N)), not from every FU — the property that makes its
    scratchpad power beat edge-fed arrays (Table III).  DSE sweeps score
    hundreds of candidates and cannot afford full ADG generation per point,
    so they use this √N estimate.
    """
    per_tensor = max(1, int(np.sqrt(n_fus)))
    return {t: per_tensor for t in tensor_names}

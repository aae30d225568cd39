"""Relation-based interconnection analysis (paper §IV-A).

Two FUs can share a tensor element in two ways:

* **direct** (Eq. 6): same data at the same *local* timestamp —
  ``M_{I->D} M_{S->I} Δs = 0``.  Under a control-flow vector ``c`` the
  wall-clock skew between the FUs is ``Δs^T c`` (paper Eq. 5), which is the
  number of store-and-forward registers the connection needs (this is how a
  multicast becomes a systolic chain "for free", §III-D).

* **delay** (Eq. 7): same data with a timestamp gap —
  ``M_{I->D} (M_{T->I} Δt + M_{S->I} Δs) = 0``.  The FIFO depth follows from
  the scalar timestamp delta (Eq. 3) plus the control skew.

The solver enumerates the bounded integer lattice (LEGO FU arrays have
``n_S ≤ 3`` and ``n_T ≤ 8``, so exhaustive enumeration is exact and cheap),
keeping only primitive generators.  Unlike TensorLib this captures *every*
reuse direction, any spatial rank, and any number of delay sets (§IV-A-c).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .affine import enumerate_box
from .dataflow import Dataflow
from .workload import Workload

__all__ = ["Reuse", "solve_direct", "solve_delay", "solve_all", "ReuseGraph", "build_reuse_graph"]


@dataclass(frozen=True)
class Reuse:
    """One reuse generator: data at FU ``s`` (local time ``t``) is consumed
    again by FU ``s+ds`` at local time ``t+dt``; wall-clock latency ``depth``.
    """

    tensor: str
    ds: tuple[int, ...]
    dt: tuple[int, ...]
    depth: int
    kind: str  # "direct" | "delay" | "stationary"

    @property
    def is_spatial(self) -> bool:
        return any(self.ds)


def _primitive(*vecs: np.ndarray) -> bool:
    cat = np.concatenate([np.asarray(v).ravel() for v in vecs])
    nz = np.abs(cat[cat != 0])
    return len(nz) > 0 and int(np.gcd.reduce(nz)) == 1


def solve_direct(wl: Workload, df: Dataflow, tensor: str, d_S: int = 1) -> list[Reuse]:
    """Paper Eq. 6 with constraints |Δs|_inf <= d_S and Δt_bias = Δs·c >= 0."""
    MD_S = wl.tensor(tensor).fmap.M @ df.M_SI
    out: list[Reuse] = []
    for ds in enumerate_box(df.n_S, d_S):
        if not np.any(ds) or not _primitive(ds):
            continue
        if np.any(MD_S @ ds):
            continue
        skew = df.t_bias(ds)
        if skew < 0:
            continue  # data must flow from past to future
        out.append(Reuse(tensor, tuple(int(x) for x in ds),
                         (0,) * df.n_T, int(skew), "direct"))
    return out


def solve_delay(
    wl: Workload,
    df: Dataflow,
    tensor: str,
    d_S: int = 1,
    d_T: int = 1,
    max_depth: int | None = None,
) -> list[Reuse]:
    """Paper Eq. 7.  Enumerates (Δs, Δt) pairs; keeps those whose effective
    wall-clock delay ``t_scalar(Δt) + Δs·c`` is positive (realizable FIFO).

    Includes stationary reuse (Δs = 0, Δt ≠ 0) — e.g. weights pinned in a
    weight-stationary array, or the output-accumulator revisit — which lowers
    to a self-loop FIFO and drives the memory-traffic model.
    """
    fm = wl.tensor(tensor).fmap
    MD_T = fm.M @ df.M_TI
    MD_S = fm.M @ df.M_SI
    out: list[Reuse] = []
    for ds in enumerate_box(df.n_S, d_S):
        rhs = MD_S @ ds
        for dt in enumerate_box(df.n_T, d_T):
            if not np.any(dt):
                continue  # Δt = 0 is the direct case
            if np.any(MD_T @ dt + rhs):
                continue
            if not _primitive(ds, dt):
                continue
            depth = df.t_scalar(dt) + df.t_bias(ds)
            if depth <= 0:
                continue
            if max_depth is not None and depth > max_depth:
                continue
            kind = "stationary" if not np.any(ds) else "delay"
            out.append(Reuse(tensor, tuple(int(x) for x in ds),
                             tuple(int(x) for x in dt), int(depth), kind))
    return out


def solve_all(wl: Workload, df: Dataflow, d_S: int = 1, d_T: int = 1) -> dict[str, list[Reuse]]:
    """All reuse generators for every tensor of the workload."""
    res: dict[str, list[Reuse]] = {}
    for t in wl.tensors:
        res[t.name] = solve_direct(wl, df, t.name, d_S) + solve_delay(wl, df, t.name, d_S, d_T)
    return res


# ---------------------------------------------------------------------------
# reuse graph over the concrete FU grid
# ---------------------------------------------------------------------------

@dataclass
class ReuseGraph:
    """Per-tensor directed reuse graph over the FU grid plus a virtual memory
    root (node id = n_fus).  ``edges[(u, v)] = (cost, reuse)`` keeps the
    cheapest generator per FU pair."""

    tensor: str
    n_fus: int
    grid: np.ndarray  # (n_fus, n_S) FU coordinates, row-major
    edges: dict[tuple[int, int], tuple[float, Reuse | None]]

    @property
    def root(self) -> int:
        return self.n_fus


def build_reuse_graph(
    df: Dataflow,
    reuses: list[Reuse],
    mem_edge_cost: float = 2.5,
    reverse: bool = False,
) -> ReuseGraph:
    """Instantiate reuse generators over the concrete FU grid.

    Every FU also gets a ``root -> fu`` edge of cost ``mem_edge_cost``
    (fetching from on-chip memory); the minimum arborescence then *chooses*
    the data nodes (paper §IV-B): the FUs kept as children of the root.

    ``reverse=True`` transposes the reuse edges — used for *output* tensors,
    whose partial sums flow toward a single commit point per chain (the
    spanning structure is an anti-arborescence: every FU has out-degree 1
    toward its consumer, and the data nodes are the sinks — e.g. partial
    sums exiting the bottom row of a TPU-style array).
    """
    coords = df.fu_coords()
    n = len(coords)
    index = {tuple(cc): i for i, cc in enumerate(map(tuple, coords))}
    edges: dict[tuple[int, int], tuple[float, Reuse | None]] = {}
    tensor = reuses[0].tensor if reuses else "?"

    for r in reuses:
        if not r.is_spatial:
            continue  # stationary reuse is a self-loop; not a spanning edge
        ds = np.asarray(r.ds, dtype=np.int64)
        for i, s in enumerate(coords):
            dst = tuple((s + ds).tolist())
            j = index.get(dst)
            if j is None:
                continue
            key = (j, i) if reverse else (i, j)
            cost = float(r.depth)
            prev = edges.get(key)
            if prev is None or cost < prev[0]:
                edges[key] = (cost, r)

    root = n
    for i in range(n):
        edges[(root, i)] = (float(mem_edge_cost), None)

    return ReuseGraph(tensor=tensor, n_fus=n, grid=coords, edges=edges)

"""Dataflow mappings (paper §III-B/C): ``i = [M_T->I  M_S->I] [t; s]``.

LEGO maps *from* temporal/spatial loop instances *to* the computation
iteration domain (the inverse of polyhedral/STT notation), which keeps the
representation purely affine — no div/mod — and lets the interconnect solver
capture every reuse direction (paper §III-D).

A :class:`Dataflow` carries:
  * ordered temporal loops (outermost first) with integer strides,
  * spatial loops (the parfor dims = FU-array axes) with strides,
  * the control-flow vector ``c`` (§III-C), decoupled from the dataflow.

Loop strides are derived canonically: the spatial tile is the innermost tile
of its dim (stride 1) and temporal tiles multiply up from there, exactly as in
Fig. 3 (``j = P_j*t0_j + s_j``, ``i = R0_i*t1_i + t0_i``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .affine import AffineMap, mixed_radix_scalar
from .workload import Workload

__all__ = ["Loop", "Dataflow", "build_dataflow"]


@dataclass(frozen=True)
class Loop:
    """One (par)for loop instance mapping to iteration dim ``dim``."""

    name: str
    dim: str
    size: int
    stride: int


@dataclass(frozen=True)
class Dataflow:
    """A concrete spatio-temporal mapping for a workload's iteration domain."""

    name: str
    iter_dims: tuple[str, ...]
    temporal: tuple[Loop, ...]  # outermost -> innermost
    spatial: tuple[Loop, ...]
    c: np.ndarray  # control-flow vector, len n_S

    def __post_init__(self):
        object.__setattr__(self, "c", np.asarray(self.c, dtype=np.int64))
        assert self.c.shape == (len(self.spatial),), "c must have one entry per spatial dim"

    # -- matrices ---------------------------------------------------------
    @property
    def n_T(self) -> int:
        return len(self.temporal)

    @property
    def n_S(self) -> int:
        return len(self.spatial)

    def _loops_to_matrix(self, loops: tuple[Loop, ...]) -> np.ndarray:
        M = np.zeros((len(self.iter_dims), len(loops)), dtype=np.int64)
        for col, lp in enumerate(loops):
            M[self.iter_dims.index(lp.dim), col] = lp.stride
        return M

    @property
    def M_TI(self) -> np.ndarray:
        return self._loops_to_matrix(self.temporal)

    @property
    def M_SI(self) -> np.ndarray:
        return self._loops_to_matrix(self.spatial)

    @property
    def R_T(self) -> np.ndarray:
        return np.array([lp.size for lp in self.temporal], dtype=np.int64)

    @property
    def R_S(self) -> np.ndarray:
        return np.array([lp.size for lp in self.spatial], dtype=np.int64)

    @property
    def n_fus(self) -> int:
        return int(np.prod(self.R_S))

    @property
    def total_cycles(self) -> int:
        """Steady-state cycle count = product of temporal loop sizes."""
        return int(np.prod(self.R_T))

    def fmap_TS(self, workload_map: AffineMap) -> tuple[np.ndarray, np.ndarray]:
        """(M_{I->D} M_{T->I}, M_{I->D} M_{S->I}) for one tensor's data map."""
        return workload_map.M @ self.M_TI, workload_map.M @ self.M_SI

    # -- timestamps (§III-C) ----------------------------------------------
    def t_scalar(self, dt: np.ndarray) -> int:
        """Scalar cycle delta of a loop-index delta (paper Eq. 3)."""
        return mixed_radix_scalar(dt, self.R_T)

    def t_bias(self, s: np.ndarray) -> int:
        """Per-FU timestamp bias (paper Eq. 4): ``t_bias = s^T c``."""
        return int(np.asarray(s, dtype=np.int64) @ self.c)

    # -- domain sizes -------------------------------------------------------
    def dim_extent(self, dim: str) -> int:
        e = 1
        for lp in self.temporal + self.spatial:
            if lp.dim == dim:
                e *= lp.size
        return e

    def sizes(self) -> dict[str, int]:
        return {d: self.dim_extent(d) for d in self.iter_dims}

    def iter_index(self, t: np.ndarray, s: np.ndarray) -> np.ndarray:
        return self.M_TI @ np.asarray(t, dtype=np.int64) + self.M_SI @ np.asarray(s, dtype=np.int64)

    def fu_coords(self) -> np.ndarray:
        """All FU coordinates, row-major over the spatial grid: (n_fus, n_S)."""
        grids = np.meshgrid(*[np.arange(sz) for sz in self.R_S], indexing="ij")
        return np.stack([g.reshape(-1) for g in grids], axis=-1).astype(np.int64)

    def loop_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Candidate-row encoding for the batched perf kernels.

        Returns ``(loop_dim, loop_size, S)``: temporal loop dim-indices and
        trip counts (outermost first, ``(n_T,)`` int64) and the spatial
        extent per iteration dim (``(n_dims,)`` int64).  Strides are
        irrelevant to the perf model — only extents matter.
        """
        idx = {d: i for i, d in enumerate(self.iter_dims)}
        loop_dim = np.array([idx[lp.dim] for lp in self.temporal],
                            dtype=np.int64)
        loop_size = np.array([lp.size for lp in self.temporal],
                             dtype=np.int64)
        S = np.ones(len(self.iter_dims), dtype=np.int64)
        for lp in self.spatial:
            S[idx[lp.dim]] *= lp.size
        return loop_dim, loop_size, S

    def __repr__(self) -> str:
        sp = ",".join(f"{l.dim}:{l.size}" for l in self.spatial)
        tp = ",".join(f"{l.dim}:{l.size}" for l in self.temporal)
        return f"Dataflow({self.name}; spatial[{sp}] temporal[{tp}] c={self.c.tolist()})"


def build_dataflow(
    wl: Workload,
    *,
    spatial: list[tuple[str, int]],
    temporal: list[tuple[str, int]],
    c: tuple[int, ...],
    name: str = "",
) -> Dataflow:
    """Construct a :class:`Dataflow` with canonical strides.

    ``spatial``: [(dim, P)] — FU-array axes, listed as (s_0, s_1, ...).
    ``temporal``: [(dim, R)] outermost -> innermost; a dim may appear several
    times for multi-level tiling.
    Strides: spatial tile is the innermost tile of its dim (stride 1); each
    temporal tile's stride is the product of all tile sizes below it for the
    same dim (spatial included).

    Construction is pure in (iter_dims, spatial, temporal, c, name), so the
    result is memoized — the mapper rebuilds the same candidate dataflows for
    every layer of a network and every design of a DSE sweep.  The returned
    :class:`Dataflow` is frozen; callers share one instance.
    """
    return _cached_dataflow(
        tuple(wl.iter_dims),
        tuple((d, int(p)) for d, p in spatial),
        tuple((d, int(r)) for d, r in temporal),
        tuple(int(x) for x in c),
        name,
    )


@functools.lru_cache(maxsize=65536)
def _cached_dataflow(
    iter_dims: tuple[str, ...],
    spatial: tuple[tuple[str, int], ...],
    temporal: tuple[tuple[str, int], ...],
    c: tuple[int, ...],
    name: str,
) -> Dataflow:
    spatial_size = {d: p for d, p in spatial}
    assert len(spatial_size) == len(spatial), "duplicate spatial dim"

    # innermost-first cumulative strides per dim
    cum: dict[str, int] = {d: p for d, p in spatial}
    t_loops_rev: list[Loop] = []
    counters: dict[str, int] = {}
    for dim, size in reversed(temporal):
        stride = cum.get(dim, 1)
        lvl = counters.get(dim, 0)
        counters[dim] = lvl + 1
        t_loops_rev.append(Loop(f"t{lvl}_{dim}", dim, int(size), int(stride)))
        cum[dim] = stride * size
    t_loops = tuple(reversed(t_loops_rev))

    s_loops = tuple(Loop(f"s_{d}", d, int(p), 1) for d, p in spatial)

    df = Dataflow(
        name=name or ("sp-" + "".join(d for d, _ in spatial)),
        iter_dims=iter_dims,
        temporal=t_loops,
        spatial=s_loops,
        c=np.asarray(c, dtype=np.int64),
    )
    return df

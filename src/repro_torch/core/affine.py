"""Integer affine maps — the algebra underlying LEGO's relation-centric IR.

Everything in LEGO (paper §III) is expressed as integer affine transformations:

  * data mapping      d = M_{I->D} @ i + b      (workload, hardware-agnostic)
  * dataflow mapping  i = [M_{T->I} M_{S->I}] @ [t; s]   (hardware, workload-agnostic)

This module provides a small exact-integer affine-map type plus the lattice
helpers (integer nullspace enumeration, mixed-radix timestamp arithmetic) used
by the interconnect solvers in the reference's ``repro.core.interconnect``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "AffineMap",
    "int_nullspace",
    "enumerate_box",
    "mixed_radix_scalar",
    "mixed_radix_vector",
]


def _as_int_matrix(m) -> np.ndarray:
    a = np.asarray(m, dtype=np.int64)
    if a.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {a.shape}")
    return a


@dataclass(frozen=True)
class AffineMap:
    """An exact integer affine map ``f(x) = M @ x + b``.

    ``M`` has shape ``(n_out, n_in)``; ``b`` has shape ``(n_out,)``.
    """

    M: np.ndarray
    b: np.ndarray = None  # type: ignore[assignment]

    def __post_init__(self):
        object.__setattr__(self, "M", _as_int_matrix(self.M))
        b = self.b
        if b is None:
            b = np.zeros(self.M.shape[0], dtype=np.int64)
        b = np.asarray(b, dtype=np.int64).reshape(-1)
        if b.shape[0] != self.M.shape[0]:
            raise ValueError("bias length mismatch")
        object.__setattr__(self, "b", b)

    # -- shape -----------------------------------------------------------
    @property
    def n_out(self) -> int:
        return self.M.shape[0]

    @property
    def n_in(self) -> int:
        return self.M.shape[1]

    # -- application / composition --------------------------------------
    def __call__(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.int64)
        if x.ndim == 1:
            return self.M @ x + self.b
        # batched: x is (..., n_in)
        return np.einsum("oi,...i->...o", self.M, x) + self.b

    def compose(self, inner: "AffineMap") -> "AffineMap":
        """self ∘ inner : x ↦ self(inner(x))."""
        return AffineMap(self.M @ inner.M, self.M @ inner.b + self.b)

    def linear(self) -> np.ndarray:
        """The linear part (copy)."""
        return self.M.copy()

    def hstack(self, other: "AffineMap") -> "AffineMap":
        """[self | other] acting on concatenated inputs; biases add."""
        return AffineMap(np.hstack([self.M, other.M]), self.b + other.b)

    @staticmethod
    def identity(n: int) -> "AffineMap":
        return AffineMap(np.eye(n, dtype=np.int64))

    @staticmethod
    def select(rows, n_in: int, scales=None) -> "AffineMap":
        """Map selecting (optionally scaled) input coordinates.

        ``rows`` is a list where each entry is either an int column index or a
        list of ``(col, coeff)`` pairs — e.g. conv's ``ih = oh + kh`` is
        ``[(oh_idx, 1), (kh_idx, 1)]``.
        """
        M = np.zeros((len(rows), n_in), dtype=np.int64)
        for r, spec in enumerate(rows):
            if isinstance(spec, (int, np.integer)):
                M[r, spec] = 1 if scales is None else scales[r]
            else:
                for col, coeff in spec:
                    M[r, col] += coeff
        return AffineMap(M)

    def __repr__(self) -> str:  # compact
        return f"AffineMap(M={self.M.tolist()}, b={self.b.tolist()})"


# ---------------------------------------------------------------------------
# lattice helpers
# ---------------------------------------------------------------------------

def int_nullspace(M: np.ndarray, bound: int = 2) -> list[np.ndarray]:
    """All *primitive* integer nullspace vectors of ``M`` with |v|_inf <= bound.

    Exhaustive over the bounded box (LEGO arrays are low-dimensional: n_S <= 3,
    n_T <= 8, so the box is tiny).  A vector is *primitive* when the gcd of its
    entries is 1; non-primitive multiples are redundant as interconnect
    generators.  The zero vector is excluded.
    """
    M = _as_int_matrix(M)
    n = M.shape[1]
    out: list[np.ndarray] = []
    for v in enumerate_box(n, bound):
        if not np.any(v):
            continue
        g = np.gcd.reduce(np.abs(v[v != 0])) if np.any(v) else 0
        if g > 1:
            continue
        if not np.any(M @ v):
            out.append(v)
    return out


def enumerate_box(n: int, bound: int):
    """Yield all int64 vectors in [-bound, bound]^n (including zero)."""
    for tup in itertools.product(range(-bound, bound + 1), repeat=n):
        yield np.array(tup, dtype=np.int64)


def mixed_radix_scalar(t: np.ndarray, radices: np.ndarray) -> int:
    """Paper Eq. 3: convert a (possibly non-canonical) loop-index vector to a
    scalar timestamp under mixed radices ``R_T`` (outermost first).

    Works for *delta* vectors too because the map is linear in ``t``:
    scalar(t) = sum_k t_k * prod_{q>k} R_q.
    """
    t = np.asarray(t, dtype=np.int64)
    radices = np.asarray(radices, dtype=np.int64)
    weights = np.ones(len(radices), dtype=np.int64)
    for k in range(len(radices) - 2, -1, -1):
        weights[k] = weights[k + 1] * radices[k + 1]
    return int(t @ weights)


def mixed_radix_vector(scalar: int, radices: np.ndarray) -> np.ndarray:
    """Inverse of :func:`mixed_radix_scalar` for canonical (in-range) values."""
    radices = np.asarray(radices, dtype=np.int64)
    out = np.zeros(len(radices), dtype=np.int64)
    for k in range(len(radices) - 1, -1, -1):
        out[k] = scalar % radices[k]
        scalar //= radices[k]
    return out

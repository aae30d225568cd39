"""Tensor workloads as loop nests (paper §III-A).

A workload is the hardware-agnostic half of LEGO's input: the computation
iteration domain ``I``, one affine data mapping ``f_{I->D}`` per tensor
(Definition 1), and the loop-body computation (a MAC by default; user-defined
FUs such as BitFusion's mult-shift-add are supported through ``compute``).

All of the paper's evaluation kernels are provided as constructors:
GEMM, Conv2D (incl. depthwise/pointwise/strided), the two attention GEMM
stages (QK^T and PV — softmax runs on the PPU, §II), and MTTKRP.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .affine import AffineMap

__all__ = [
    "TensorAccess",
    "Workload",
    "gemm",
    "conv2d",
    "depthwise_conv2d",
    "attention_qk",
    "attention_pv",
    "mttkrp",
]


@dataclass(frozen=True)
class TensorAccess:
    """One tensor of the workload and its data mapping ``d = M i + b``."""

    name: str
    role: str  # "input" | "output"
    fmap: AffineMap  # I -> D
    dim_names: tuple[str, ...] = ()

    @property
    def n_dims(self) -> int:
        return self.fmap.n_out


@dataclass(frozen=True)
class Workload:
    """A tensor operation in loop-nest form.

    ``iter_dims``: names of the computation iteration dims (purple box, Fig 3).
    ``tensors``: per-tensor affine access maps (green box).
    ``compute``: loop-body definition, one of {"mac", "mac2", "mul", "max"};
    "mac2" is a two-multiplier MAC (``Y += A*B*C``, used by MTTKRP).
    ``flops_per_iter``: useful FLOPs of one loop-body execution.
    """

    name: str
    iter_dims: tuple[str, ...]
    tensors: tuple[TensorAccess, ...]
    compute: str = "mac"
    flops_per_iter: int = 2

    # -- lookups ---------------------------------------------------------
    def dim_index(self, name: str) -> int:
        return self.iter_dims.index(name)

    def tensor(self, name: str) -> TensorAccess:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)

    @property
    def inputs(self) -> tuple[TensorAccess, ...]:
        return tuple(t for t in self.tensors if t.role == "input")

    @property
    def output(self) -> TensorAccess:
        outs = [t for t in self.tensors if t.role == "output"]
        assert len(outs) == 1, "LEGO workloads have a single output tensor"
        return outs[0]

    @property
    def n_iter(self) -> int:
        return len(self.iter_dims)

    def iter_volume(self, sizes: dict[str, int]) -> int:
        v = 1
        for d in self.iter_dims:
            v *= sizes[d]
        return v

    def tensor_shape(self, t: TensorAccess, sizes: dict[str, int]) -> tuple[int, ...]:
        """Extent of each tensor dim = max over the iteration box + 1."""
        hi = np.array([sizes[d] - 1 for d in self.iter_dims], dtype=np.int64)
        lo = np.zeros(len(self.iter_dims), dtype=np.int64)
        M, b = t.fmap.M, t.fmap.b
        top = M @ np.where(M.sum(0) >= 0, hi, hi)  # per-entry max below
        # per-row max of M@i over the box [lo, hi]
        mx = (np.clip(M, 0, None) @ hi + np.clip(M, None, 0) @ lo) + b
        return tuple(int(x) + 1 for x in mx)


def _select(rows, dims):
    return AffineMap.select(rows, len(dims))


# ---------------------------------------------------------------------------
# paper kernels
# ---------------------------------------------------------------------------

def gemm() -> Workload:
    """Y[i,j] += X[i,k] * W[k,j]  (paper Fig. 3)."""
    dims = ("i", "j", "k")
    return Workload(
        name="gemm",
        iter_dims=dims,
        tensors=(
            TensorAccess("Y", "output", _select([0, 1], dims), ("i", "j")),
            TensorAccess("X", "input", _select([0, 2], dims), ("i", "k")),
            TensorAccess("W", "input", _select([2, 1], dims), ("k", "j")),
        ),
    )


def conv2d(stride: int = 1) -> Workload:
    """Y[n,oc,oh,ow] += X[n,ic,oh*st+kh,ow*st+kw] * W[oc,ic,kh,kw] (Fig. 4)."""
    dims = ("n", "oc", "ic", "oh", "ow", "kh", "kw")
    n, oc, ic, oh, ow, kh, kw = range(7)
    return Workload(
        name=f"conv2d_s{stride}" if stride != 1 else "conv2d",
        iter_dims=dims,
        tensors=(
            TensorAccess("Y", "output", _select([n, oc, oh, ow], dims),
                         ("n", "oc", "oh", "ow")),
            TensorAccess(
                "X", "input",
                _select([n, ic, [(oh, stride), (kh, 1)], [(ow, stride), (kw, 1)]], dims),
                ("n", "ic", "ih", "iw")),
            TensorAccess("W", "input", _select([oc, ic, kh, kw], dims),
                         ("oc", "ic", "kh", "kw")),
        ),
    )


def depthwise_conv2d(stride: int = 1) -> Workload:
    """Y[n,c,oh,ow] += X[n,c,oh*st+kh,ow*st+kw] * W[c,kh,kw].

    The channel dim is shared between all three tensors — the case where
    weight-stationary IC-OC arrays (Gemmini) collapse to 1/Pic utilization and
    LEGO's OH-OW dataflow switching wins (paper §VI-B).
    """
    dims = ("n", "c", "oh", "ow", "kh", "kw")
    n, c, oh, ow, kh, kw = range(6)
    return Workload(
        name=f"dwconv2d_s{stride}" if stride != 1 else "dwconv2d",
        iter_dims=dims,
        tensors=(
            TensorAccess("Y", "output", _select([n, c, oh, ow], dims),
                         ("n", "c", "oh", "ow")),
            TensorAccess(
                "X", "input",
                _select([n, c, [(oh, stride), (kh, 1)], [(ow, stride), (kw, 1)]], dims),
                ("n", "c", "ih", "iw")),
            TensorAccess("W", "input", _select([c, kh, kw], dims), ("c", "kh", "kw")),
        ),
    )


def attention_qk() -> Workload:
    """S[b,m,n] += Q[b,m,d] * K[b,n,d] — attention score GEMM (batched)."""
    dims = ("b", "m", "n", "d")
    b, m, n, d = range(4)
    return Workload(
        name="attention_qk",
        iter_dims=dims,
        tensors=(
            TensorAccess("S", "output", _select([b, m, n], dims), ("b", "m", "n")),
            TensorAccess("Q", "input", _select([b, m, d], dims), ("b", "m", "d")),
            TensorAccess("K", "input", _select([b, n, d], dims), ("b", "n", "d")),
        ),
    )


def attention_pv() -> Workload:
    """O[b,m,d] += P[b,m,n] * V[b,n,d] — attention value GEMM (batched).

    P is the post-softmax score tensor produced in-place by the PPU; the
    *score-stationary* fused design (paper Fig. 10 "Attention") keeps P
    resident in the FU array between the two stages.
    """
    dims = ("b", "m", "n", "d")
    b, m, n, d = range(4)
    return Workload(
        name="attention_pv",
        iter_dims=dims,
        tensors=(
            TensorAccess("O", "output", _select([b, m, d], dims), ("b", "m", "d")),
            TensorAccess("P", "input", _select([b, m, n], dims), ("b", "m", "n")),
            TensorAccess("V", "input", _select([b, n, d], dims), ("b", "n", "d")),
        ),
    )


def mttkrp() -> Workload:
    """Y[i,j] += A[i,k,l] * B[k,j] * C[l,j] — matricized tensor times
    Khatri-Rao product (the ALS bottleneck; paper §VI-A).  Loop body is a
    two-multiplier FU ("mac2")."""
    dims = ("i", "j", "k", "l")
    i, j, k, l = range(4)
    return Workload(
        name="mttkrp",
        iter_dims=dims,
        compute="mac2",
        flops_per_iter=3,
        tensors=(
            TensorAccess("Y", "output", _select([i, j], dims), ("i", "j")),
            TensorAccess("A", "input", _select([i, k, l], dims), ("i", "k", "l")),
            TensorAccess("B", "input", _select([k, j], dims), ("k", "j")),
            TensorAccess("C", "input", _select([l, j], dims), ("l", "j")),
        ),
    )

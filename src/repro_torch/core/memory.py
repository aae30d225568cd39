"""Relation-based memory analysis (paper §IV-D).

The L1 memory for each tensor is a banked array.  Bank-conflict freedom
requires (Eq. 8) that no two data nodes touch the same bank at the same
timestamp; since the interconnect analysis already guarantees distinct data,
it suffices (Eq. 9) to size each dim's bank count beyond the largest index
delta observed across data nodes at ``t = 0`` — divided by the GCD of the
deltas when one exists (the paper's bank-reduction trick).

Fusing multiple dataflows reuses one physical bank array viewed under
different factorizations (Fig. 6(c): 4 banks = 4×1 for (a) and 2×2 for (b)).

The address generator is pure affine machinery: ``addr = L @ t + base`` per
data node (matrix–vector product of the current timestamp, §V), so switching
dataflows only rewrites matrix values, never the hardware structure.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import gcd

import numpy as np

from .dataflow import Dataflow
from .workload import Workload

__all__ = ["BankingPlan", "analyze_banking", "fuse_banking", "AddressGenerator",
           "address_generator"]


@dataclass(frozen=True)
class BankingPlan:
    """Per-tensor banking for one dataflow."""

    tensor: str
    dataflow: str
    banks_per_dim: tuple[int, ...]  # B_i
    divisors_per_dim: tuple[int, ...]  # g_i (GCD trick): bank_i = d_i/g_i mod B_i
    data_node_indices: np.ndarray  # (n_nodes, n_D) tensor indexes at t=0

    @property
    def total_banks(self) -> int:
        return int(np.prod(self.banks_per_dim))

    def bank_of(self, d: np.ndarray) -> tuple[int, ...]:
        d = np.asarray(d, dtype=np.int64)
        g = np.asarray(self.divisors_per_dim, dtype=np.int64)
        B = np.asarray(self.banks_per_dim, dtype=np.int64)
        return tuple(((d // g) % B).tolist())


def analyze_banking(
    wl: Workload,
    df: Dataflow,
    tensor: str,
    data_nodes: list[int],
) -> BankingPlan:
    """Size the bank array from data-node index deltas at t = 0 (Eq. 9)."""
    fmap = wl.tensor(tensor).fmap
    coords = df.fu_coords()[data_nodes]
    d = np.stack([fmap(df.M_SI @ s) for s in coords])  # (n, n_D)
    n_D = d.shape[1]
    banks, gs = [], []
    for i in range(n_D):
        vals = d[:, i]
        deltas = {abs(int(a) - int(b)) for a in vals for b in vals if a != b}
        deltas.discard(0)
        if not deltas:
            banks.append(1)
            gs.append(1)
            continue
        g = 0
        for x in deltas:
            g = gcd(g, x)
        banks.append(max(deltas) // g + 1)
        gs.append(g)
    plan = BankingPlan(tensor, df.name, tuple(banks), tuple(gs), d)
    _verify_no_conflict(plan)
    return plan


def _verify_no_conflict(plan: BankingPlan) -> None:
    seen: dict[tuple[int, ...], int] = {}
    for row in plan.data_node_indices:
        b = plan.bank_of(row)
        if b in seen:
            raise AssertionError(
                f"bank conflict in {plan.tensor}/{plan.dataflow}: nodes share bank {b}")
        seen[b] = 1


@dataclass(frozen=True)
class FusedBanking:
    """One physical bank array serving several dataflows (Fig. 6(c))."""

    tensor: str
    total_banks: int
    views: dict[str, BankingPlan]  # dataflow name -> per-dataflow view


def fuse_banking(plans: list[BankingPlan]) -> FusedBanking:
    """Physical banks = max over dataflows of each plan's total; each dataflow
    keeps its own (B_i, g_i) view of the shared array."""
    assert plans and len({p.tensor for p in plans}) == 1
    total = max(p.total_banks for p in plans)
    return FusedBanking(plans[0].tensor, total, {p.dataflow: p for p in plans})


# ---------------------------------------------------------------------------
# address generation (affine: one control unit per memory space, §III-D)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AddressGenerator:
    """``addr(t) = row_major(f_{I->D}(M_{T->I} t + M_{S->I} s0))`` for the data
    node at FU ``s0``; realized in hardware as one matrix multiply driven by
    the shared timestamp counters (the systolic/broadcast distribution of the
    result follows the control-flow vector c, so only ONE generator exists
    per memory space — the paper's 2.0×-area control-logic saving)."""

    tensor: str
    L: np.ndarray  # (n_D, n_T) linear part w.r.t. t
    base: np.ndarray  # (n_D,) offset from the FU coordinate
    tensor_shape: tuple[int, ...]

    def data_index(self, t: np.ndarray) -> np.ndarray:
        return self.L @ np.asarray(t, dtype=np.int64) + self.base

    def flat_address(self, t: np.ndarray) -> int:
        d = self.data_index(t)
        addr = 0
        for extent, x in zip(self.tensor_shape, d):
            addr = addr * extent + int(x)
        return addr


def address_generator(
    wl: Workload, df: Dataflow, tensor: str, fu_coord: np.ndarray
) -> AddressGenerator:
    fmap = wl.tensor(tensor).fmap
    L = fmap.M @ df.M_TI
    base = fmap.M @ (df.M_SI @ np.asarray(fu_coord, dtype=np.int64)) + fmap.b
    shape = wl.tensor_shape(wl.tensor(tensor), df.sizes())
    return AddressGenerator(tensor, L, base, shape)

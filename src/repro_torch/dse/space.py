"""Declarative hardware design space (DSE input).

A :class:`DesignPoint` is one candidate accelerator: FU count, on-chip buffer
capacity, DRAM bandwidth, and the set of runtime-switchable spatial dataflows
the generated interconnect must support (the paper's ``M``/``N`` fused-design
notation — ``fused`` designs pay mux/FIFO area for dataflow switching,
§IV-C).  A :class:`DesignSpace` enumerates points over axis value lists with
validity pruning, and provides ``sample``/``mutate`` for the evolutionary
search strategy.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Iterator

from ..core.mapper import SpatialChoice
from ..core.perf_model import HWConfig

__all__ = ["DesignPoint", "DesignSpace", "SPACES", "DATAFLOW_SETS"]


# Spatial-dataflow menus per workload, named after the stationarity they
# implement.  "os" keeps outputs resident (accumulate in place), "ws" streams
# outputs across a stationary-weight array, "switch" fuses both into one
# runtime-switchable design (Conv2d-MNICOC / GEMM-MJ in the paper).
# "attention_fused" extends "switch" with menus for the batched attention
# workloads: both stages parallelize (m, n), so the score tensor P stays
# resident in the FU array between the QK and PV stages (paper Fig. 10
# "Attention") — rows of heterogeneous workload kinds map onto one design.
DATAFLOW_SETS: dict[str, dict[str, tuple[SpatialChoice, ...]]] = {
    "os": {
        "gemm": (SpatialChoice(("i", "j"), (1, 1), "ij"),),
        "conv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),),
        "dwconv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),),
    },
    "ws": {
        "gemm": (SpatialChoice(("k", "j"), (1, 1), "jk"),),
        "conv2d": (SpatialChoice(("ic", "oc"), (1, 1), "icoc"),),
        "dwconv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),),
    },
    "switch": {
        "gemm": (SpatialChoice(("i", "j"), (1, 1), "ij"),
                 SpatialChoice(("k", "j"), (1, 1), "jk")),
        "conv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),
                   SpatialChoice(("ic", "oc"), (1, 1), "icoc")),
        "dwconv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),),
    },
    "attention_fused": {
        "gemm": (SpatialChoice(("i", "j"), (1, 1), "ij"),
                 SpatialChoice(("k", "j"), (1, 1), "jk")),
        "conv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),
                   SpatialChoice(("ic", "oc"), (1, 1), "icoc")),
        "dwconv2d": (SpatialChoice(("ow", "oh"), (0, 0), "ohow"),),
        # score-stationary pair: S/P[b,m,n] lives at FU (m,n) across stages;
        # the (b,n) variant keeps residency for GEMV-shaped decode (m = 1)
        "attention_qk": (SpatialChoice(("m", "n"), (0, 0), "attn-mn"),
                         SpatialChoice(("b", "n"), (0, 0), "attn-bn")),
        "attention_pv": (SpatialChoice(("m", "n"), (0, 0), "attn-mn"),
                         SpatialChoice(("b", "n"), (0, 0), "attn-bn")),
    },
}


@dataclass(frozen=True)
class DesignPoint:
    """One candidate accelerator configuration."""

    n_fus: int = 256
    buffer_kb: int = 256
    dram_gbps: float = 16.0
    dataflow_set: str = "switch"

    @property
    def name(self) -> str:
        return (f"fu{self.n_fus}-buf{self.buffer_kb}k-"
                f"bw{self.dram_gbps:g}-{self.dataflow_set}")

    @property
    def buffer_bytes(self) -> int:
        return self.buffer_kb * 1024

    @property
    def n_dataflows(self) -> int:
        return max(len(v) for v in DATAFLOW_SETS[self.dataflow_set].values())

    @property
    def fused(self) -> bool:
        return self.n_dataflows > 1

    @property
    def n_ppus(self) -> int:
        # one PPU bank per 32 FUs, at least the paper's 8
        return max(8, self.n_fus // 32)

    def hw_config(self) -> HWConfig:
        return HWConfig(n_fus=self.n_fus, buffer_bytes=self.buffer_bytes,
                        dram_gbps=self.dram_gbps, n_ppus=self.n_ppus)

    def supports(self, workload_name: str) -> bool:
        """Whether this design's dataflow set can map ``workload_name`` —
        heterogeneous workload sets (``attention_fused``) carry menus for
        the attention pair; the classic sets trigger the evaluator's
        plain-GEMM fallback lowering instead."""
        return workload_name in DATAFLOW_SETS[self.dataflow_set]

    def spatials(self, workload_name: str) -> list[SpatialChoice]:
        menu = DATAFLOW_SETS[self.dataflow_set]
        if workload_name not in menu:
            raise KeyError(
                f"dataflow set {self.dataflow_set!r} has no spatial menu for "
                f"workload {workload_name!r}")
        return list(menu[workload_name])

    def as_dict(self) -> dict:
        return {"name": self.name, "n_fus": self.n_fus,
                "buffer_kb": self.buffer_kb, "dram_gbps": self.dram_gbps,
                "dataflow_set": self.dataflow_set, "fused": self.fused}

    @classmethod
    def from_dict(cls, d: dict) -> "DesignPoint":
        """Inverse of :meth:`as_dict` (``name``/``fused`` are derived) —
        the run-ledger resume path rebuilds points from checkpoint JSON."""
        return cls(n_fus=int(d["n_fus"]), buffer_kb=int(d["buffer_kb"]),
                   dram_gbps=float(d["dram_gbps"]),
                   dataflow_set=d["dataflow_set"])


@dataclass(frozen=True)
class DesignSpace:
    """Axis value lists + validity rules; the cartesian product, pruned."""

    name: str
    n_fus: tuple[int, ...] = (256,)
    buffer_kb: tuple[int, ...] = (256,)
    dram_gbps: tuple[float, ...] = (16.0,)
    dataflow_sets: tuple[str, ...] = ("switch",)

    # pruning rules
    min_buffer_bytes_per_fu: int = 64     # can't even double-buffer tiles
    max_buffer_bytes_per_fu: int = 64 * 1024  # buffer dwarfs the array
    max_area_mm2: float | None = None     # closed-form area budget

    @property
    def raw_size(self) -> int:
        return (len(self.n_fus) * len(self.buffer_kb) * len(self.dram_gbps)
                * len(self.dataflow_sets))

    def is_valid(self, p: DesignPoint) -> bool:
        if p.dataflow_set not in DATAFLOW_SETS:
            return False
        if p.n_fus < 16 or p.n_fus > 16384:
            return False
        if p.n_fus & (p.n_fus - 1):
            return False  # non-power-of-two arrays break factorization menus
        per_fu = p.buffer_bytes / p.n_fus
        if per_fu < self.min_buffer_bytes_per_fu:
            return False
        if per_fu > self.max_buffer_bytes_per_fu:
            return False
        if self.max_area_mm2 is not None:
            from ..core.cost import estimate_design_area_mm2
            a = estimate_design_area_mm2(
                p.n_fus, p.buffer_bytes, n_dataflows=p.n_dataflows,
                n_ppus=p.n_ppus)["total_mm2"]
            if a > self.max_area_mm2:
                return False
        return True

    def enumerate(self) -> Iterator[DesignPoint]:
        """Yield valid points lazily, in axis-product order.

        A generator, not a list: the ``huge`` space has ~10⁵ raw points and
        guided search must be able to walk (or ignore) it without ever
        materializing the full design list.  Callers that need ``len()`` or
        indexing wrap it in ``list(...)`` explicitly.
        """
        for nf, bk, bw, ds in itertools.product(
                self.n_fus, self.buffer_kb, self.dram_gbps,
                self.dataflow_sets):
            p = DesignPoint(n_fus=nf, buffer_kb=bk, dram_gbps=bw,
                            dataflow_set=ds)
            if self.is_valid(p):
                yield p

    # -- evolutionary-search hooks ---------------------------------------
    def sample(self, rng) -> DesignPoint:
        """One valid random point (rng: ``random.Random``)."""
        for _ in range(256):
            p = DesignPoint(n_fus=rng.choice(self.n_fus),
                            buffer_kb=rng.choice(self.buffer_kb),
                            dram_gbps=rng.choice(self.dram_gbps),
                            dataflow_set=rng.choice(self.dataflow_sets))
            if self.is_valid(p):
                return p
        raise RuntimeError(f"design space {self.name!r} has no valid points")

    def mutate(self, p: DesignPoint, rng) -> DesignPoint:
        """Step one axis to a neighboring value (random-mutation search)."""
        def step(values, cur):
            values = sorted(set(values))
            if cur not in values or len(values) == 1:
                return rng.choice(values)
            i = values.index(cur)
            j = min(max(i + rng.choice((-1, 1)), 0), len(values) - 1)
            return values[j]

        for _ in range(64):
            axis = rng.randrange(4)
            if axis == 0:
                q = replace(p, n_fus=step(self.n_fus, p.n_fus))
            elif axis == 1:
                q = replace(p, buffer_kb=step(self.buffer_kb, p.buffer_kb))
            elif axis == 2:
                q = replace(p, dram_gbps=step(self.dram_gbps, p.dram_gbps))
            else:
                q = replace(p, dataflow_set=rng.choice(self.dataflow_sets))
            if q != p and self.is_valid(q):
                return q
        return self.sample(rng)


SPACES: dict[str, DesignSpace] = {
    # few points: CI smoke sweeps and unit tests (attention_fused included
    # so `--models all --quick` always evaluates the paper's fused design)
    "tiny": DesignSpace(
        name="tiny", n_fus=(64, 128), buffer_kb=(128,),
        dataflow_sets=("os", "switch", "attention_fused")),
    # the acceptance sweep: ≥20 candidates, exhaustive
    "small": DesignSpace(
        name="small", n_fus=(64, 128, 256, 512, 1024),
        buffer_kb=(128, 256, 512),
        dataflow_sets=("os", "ws", "switch", "attention_fused")),
    # adds a bandwidth axis; still exhaustive on a beefy machine
    "medium": DesignSpace(
        name="medium", n_fus=(64, 128, 256, 512, 1024, 2048),
        buffer_kb=(128, 256, 512, 1024), dram_gbps=(16.0, 32.0),
        dataflow_sets=("os", "ws", "switch", "attention_fused"),
        max_area_mm2=20.0),
    # evolutionary territory
    "large": DesignSpace(
        name="large", n_fus=(64, 128, 256, 512, 1024, 2048, 4096),
        buffer_kb=(64, 128, 256, 512, 1024, 2048),
        dram_gbps=(8.0, 16.0, 32.0, 64.0),
        dataflow_sets=("os", "ws", "switch", "attention_fused"),
        max_area_mm2=40.0),
    # ~10⁵ raw points (10 × 64 × 61 × 4 = 156 160): guided-search-only
    # territory — `--strategy evolve --budget N` walks it via sample/mutate,
    # never enumerating the product (enumerate() stays a lazy generator)
    "huge": DesignSpace(
        name="huge",
        n_fus=tuple(2 ** k for k in range(5, 15)),           # 32 .. 16384
        buffer_kb=tuple(range(64, 4096 + 1, 64)),            # 64 .. 4096
        dram_gbps=tuple(float(g) for g in range(4, 245, 4)),  # 4 .. 244
        dataflow_sets=("os", "ws", "switch", "attention_fused"),
        max_area_mm2=60.0),
}

"""Shared end-to-end evaluation engine: map every layer of a network onto a
LEGO design with the mapper (dataflow + tiling search, §VI-A) or onto the
Gemmini baseline, and accumulate cycles/energy.  The port's copy of the
reference's ``benchmarks/e2e.py``: every layer's mapping candidates are
scored by the torch engine on ``device``, the card unless the caller names
the CPU, as :class:`repro_torch.dse.Evaluator` scores its misses; the
winners, and so every total, are the NumPy engine's."""

from __future__ import annotations

from dataclasses import dataclass

from .core import workload as W
from .core.baselines import gemmini_layer_perf
from .core.fusion import data_node_pressure, score_fused_design
from .core.mapper import SpatialChoice
from .core.mapper_batch import best_mappings
from .core.perf_model import HWConfig
from .models.common import check_device

from .designs import build_design
from .nn_workloads import NETWORKS

__all__ = ["run_network_lego", "run_network_gemmini", "NetResult",
           "LEGO_HW", "lego_data_nodes"]

LEGO_HW = HWConfig(n_fus=256, buffer_bytes=256 * 1024, dram_gbps=16.0,
                   n_ppus=8)

GEMM_SP = [SpatialChoice(("k", "j"), (1, 1), "jk"),
           SpatialChoice(("i", "j"), (1, 1), "ij")]
CONV_SP = [SpatialChoice(("ow", "oh"), (0, 0), "ohow"),
           SpatialChoice(("ic", "oc"), (1, 1), "icoc")]
DW_SP = [SpatialChoice(("ow", "oh"), (0, 0), "ohow")]

_WL = {"conv": W.conv2d(), "dwconv": W.depthwise_conv2d(), "gemm": W.gemm()}
_SP = {"conv": CONV_SP, "dwconv": DW_SP, "gemm": GEMM_SP}


@dataclass
class NetResult:
    name: str
    cycles: float
    energy_pj: float
    macs: float
    ppu_cycles: float

    @property
    def gops(self) -> float:
        return 2.0 * self.macs / max(1.0, self.cycles)

    @property
    def gops_per_w(self) -> float:
        # energy_pj / cycles(ns) = power in mW; GOP/s / W
        mw = self.energy_pj / max(1.0, self.cycles)
        return self.gops / (mw / 1e3)

    @property
    def utilization(self) -> float:
        return 2.0 * self.macs / (2.0 * 256 * max(1.0, self.cycles))


def lego_data_nodes(design_name: str = "Conv2d-MNICOC") -> dict[str, int]:
    """Exact per-tensor data-node counts from a generated ADG (see
    :func:`repro_torch.core.fusion.data_node_pressure`)."""
    return data_node_pressure(build_design(design_name).tensor_plans)


def run_network_lego(net: str, hw: HWConfig = LEGO_HW,
                     restrict: str | None = None,
                     device="cuda") -> NetResult:
    """restrict: force a single spatial dataflow name (Table V ablation).
    The mapping candidates are scored on ``device``, which must exist."""
    dev = check_device(device)
    dn = lego_data_nodes()
    spatials = {}
    layers = []
    for kind, dims, rep, nt in NETWORKS[net]():
        wl = _WL[kind]
        sps = _SP[kind]
        if restrict:
            sps = [s for s in sps if s.name == restrict] or sps
        spatials[wl.name] = sps
        layers.append((wl, dims, rep, nt))

    def solve(wl, queries, sps, hw, dn, obj):
        return [m.perf for m in best_mappings(
            wl, queries, sps, hw, data_nodes_per_tensor=dn, objective=obj,
            engine="torch", device=dev)]

    s = score_fused_design(layers, spatials, hw, data_nodes_per_tensor=dn,
                           batch_mapping_fn=solve)
    return NetResult(net, s.cycles, s.energy_pj, s.macs, s.ppu_cycles)


def run_network_gemmini(net: str) -> NetResult:
    layers = NETWORKS[net]()
    cyc = en = macs = 0.0
    for kind, dims, rep, nt in layers:
        p = gemmini_layer_perf(kind, dims, ppu_elements=nt)
        cyc += rep * p.cycles
        en += rep * p.energy_pj
        macs += rep * p.macs
    return NetResult(net, cyc, en, macs, 0.0)

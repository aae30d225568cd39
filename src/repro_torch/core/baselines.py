"""Baseline accelerator models the paper compares against (a copy of the
reference's ``repro.core.baselines``).

``gemmini_layer_perf`` models Gemmini [10]: a 16×16 weight-stationary
systolic array (output-stationary option ignored — WS is its primary mode),
im2col-style convolution lowering, edge-fed operands (one bank read per
row/column port per cycle), and *non-tensor ops executed outside the
accelerator* — activations/normalization take a DRAM round trip, which is
the main end-to-end gap Fig. 11/12(b) highlights.

The same HW budget as LEGO's comparison setup: 256 MACs, 256 KB scratchpad,
16 GB/s DRAM.
"""

from __future__ import annotations

import numpy as np

from .dataflow import build_dataflow
from .perf_model import HWConfig, LayerPerf, layer_perf
from .workload import Workload, gemm

__all__ = ["gemmini_layer_perf", "GEMMINI_HW"]

GEMMINI_HW = HWConfig(n_fus=256, buffer_bytes=256 * 1024, dram_gbps=16.0)


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gemmini_layer_perf(kind: str, dims: dict[str, int],
                       hw: HWConfig = GEMMINI_HW,
                       ppu_elements: float = 0.0) -> LayerPerf:
    """Model a layer on Gemmini.  ``kind`` ∈ {gemm, conv, dwconv}; conv is
    lowered to GEMM via im2col: M=N·OH·OW, K=IC·KH·KW, N_out=OC (the im2col
    expansion inflates input DRAM traffic by ~KH·KW unless it fits on-chip).
    ``dwconv`` maps catastrophically: channels are the only parallel dim on
    the array's K axis, so utilization collapses to 1/16 per side (the
    MobileNetV2 effect in Fig. 11)."""
    wl = gemm()
    P = int(np.sqrt(hw.n_fus))
    if kind == "gemm":
        m, n, k = dims["i"], dims["j"], dims["k"]
        im2col_factor = 1.0
    elif kind == "conv":
        m = dims["n"] * dims["oh"] * dims["ow"]
        k = dims["ic"] * dims["kh"] * dims["kw"]
        n = dims["oc"]
        im2col_factor = min(dims["kh"] * dims["kw"], 4.0)
    elif kind == "dwconv":
        # each channel is an independent tiny GEMM: K = KH·KW (≤ 9) on a
        # 16-wide reduction axis, N = 1 on a 16-wide output axis
        m = dims["n"] * dims["oh"] * dims["ow"]
        k = dims["kh"] * dims["kw"]
        n = 1
        perf_one = _ws_gemm_perf(wl, m, n, k, P, hw, 1.0, 0.0)
        c = dims["c"]
        return LayerPerf(
            cycles=perf_one.cycles * c + ppu_elements / max(1, hw.n_ppus),
            macs=perf_one.macs * c,
            utilization=perf_one.utilization,
            dram_bytes=perf_one.dram_bytes * c,
            sram_reads=perf_one.sram_reads * c,
            energy_pj=perf_one.energy_pj * c + ppu_elements * _CPU_PPU_PJ,
            bound=perf_one.bound,
        )
    else:
        raise ValueError(kind)
    return _ws_gemm_perf(wl, m, n, k, P, hw, im2col_factor, ppu_elements)


_CPU_PPU_PJ = 18.0  # per element: DRAM round trip + CPU vector op


def _ws_gemm_perf(wl: Workload, m: int, n: int, k: int, P: int,
                  hw: HWConfig, im2col_factor: float,
                  ppu_elements: float) -> LayerPerf:
    true = {"i": m, "j": n, "k": k}
    mp, np_, kp = _ceil_to(m, 1), _ceil_to(n, P), _ceil_to(k, P)
    df = build_dataflow(
        wl, spatial=[("k", P), ("j", P)],
        temporal=[("j", np_ // P), ("k", kp // P), ("i", mp)],
        c=(1, 1), name="gemmini-ws")
    # edge-fed array: X enters at P row ports, Y leaves at P column ports,
    # W is preloaded into all FUs (counted at its full rate)
    data_nodes = {"X": P, "Y": P, "W": hw.n_fus}
    perf = layer_perf(wl, df, hw, true_sizes=true,
                      data_nodes_per_tensor=data_nodes)
    perf.dram_bytes *= im2col_factor
    mem_cycles = perf.dram_bytes / hw.bytes_per_cycle
    compute = perf.cycles
    perf.cycles = max(compute, mem_cycles)
    perf.bound = "memory" if mem_cycles > compute else "compute"
    # non-tensor ops leave the accelerator: DRAM round trip + host latency
    if ppu_elements:
        rt_bytes = 2.0 * ppu_elements * hw.acc_bytes
        perf.cycles += rt_bytes / hw.bytes_per_cycle + ppu_elements / 16.0
        perf.energy_pj += ppu_elements * _CPU_PPU_PJ
    return perf

"""Analytic 28 nm area/power/energy model: the closed-form part.

A copy of the reference's ``repro.core.cost`` without its DAG-based
functions (``dag_area_um2``, ``dag_power_mw``, ``design_area_mm2``,
``design_power_mw``), which score a generated architecture graph the port
does not build.  What is kept is what the mapping engine and the design
space need: the SRAM and DRAM energies the perf model charges and the
closed-form design estimators that ``DesignSpace.is_valid`` prunes by.

Primitive costs are table constants calibrated against the paper's
absolute anchors:

  * LEGO-MNICOC (256 FUs int8, 256 KB buffers): 1.76 mm², 285 mW, with
    buffers ≈ 86% of area and FU array + NoC ≈ 83% of power (Fig. 12a);
  * LEGO-ICOC-1K (1024 FUs, 576 KB): 3.95 mm², 601 mW (Table II);
  * energy-efficiency plateau ≈ 4.7–4.9 TOP/s/W for 64–16k FUs (Table IV).
"""

from __future__ import annotations

import numpy as np

__all__ = ["sram_area_um2", "sram_read_pj_per_byte", "DRAM_PJ_PER_BYTE",
           "noc_area_um2", "noc_power_mw", "ppu_area_um2", "ppu_power_mw",
           "estimate_design_area_mm2", "estimate_design_power_mw"]

# -- memory ------------------------------------------------------------------
SRAM_UM2_PER_BIT = 0.62       # incl. periphery for small banked arrays
SRAM_BANK_OVERHEAD = 0.06     # extra area per √bank
DRAM_PJ_PER_BYTE = 31.2       # LPDDR-class, system energy
FREQ_GHZ = 1.0


def sram_area_um2(capacity_bytes: int, banks: int = 1) -> float:
    bits = capacity_bytes * 8
    return bits * SRAM_UM2_PER_BIT * (1.0 + SRAM_BANK_OVERHEAD * np.sqrt(max(1, banks)))


def sram_read_pj_per_byte(capacity_bytes: int) -> float:
    """CACTI-like: energy grows ~√capacity; ≈0.35 pJ/B at 8 KB."""
    kb = max(0.5, capacity_bytes / 1024)
    return 0.125 * float(np.sqrt(kb))


# -- system-level pieces outside the FU array --------------------------------

def noc_area_um2(n_l1_endpoints: int, bus_bits: int = 128) -> float:
    """Butterfly/wormhole L1 NoC: per-endpoint router slice."""
    return n_l1_endpoints * bus_bits * 9.0


def noc_power_mw(n_l1_endpoints: int, bus_bits: int = 128,
                 activity: float = 0.5) -> float:
    return n_l1_endpoints * bus_bits * 0.0028 * activity * FREQ_GHZ


def ppu_area_um2(n_ppus: int) -> float:
    # LUT + small reduce + control per PPU (paper: 2% of 1.76 mm² for the
    # MNICOC config's PPU bank)
    return n_ppus * 4400.0


def ppu_power_mw(n_ppus: int, activity: float = 0.6) -> float:
    return n_ppus * 1.8 * activity


# -- closed-form design estimators (no DAG required) --------------------------
#
# The DSE sweep scores hundreds of candidate designs; generating the full ADG
# for each would dominate the sweep, so the area/power axes of the Pareto
# frontier use a closed-form estimate instead.  Constants are calibrated
# against the reference's DAG-based model for the paper's two anchor designs
# (LEGO-MNICOC 256 FUs fused ≈ 1.8–2.0 mm², LEGO-ICOC-1K 1024 FUs ≈ 4 mm²):
# each FU carries a MAC + accumulator + pipeline/skew registers, and every
# additional runtime-switchable dataflow adds mux/FIFO/data-node overhead per
# FU (§IV-C fusion hardware).

FU_AREA_UM2 = 1150.0              # MAC + acc + regs + share of links
FU_AREA_PER_EXTRA_DF_UM2 = 280.0  # muxes + shared FIFOs + extra data nodes
FU_POWER_MW = 0.78                # active per-FU power incl. link traffic
FU_POWER_PER_EXTRA_DF_MW = 0.07


def estimate_design_area_mm2(n_fus: int, buffer_bytes: int,
                             n_dataflows: int = 1, n_ppus: int = 8,
                             banks: int = 16) -> dict:
    """Closed-form area of a design for DSE scoring."""
    fu = n_fus * (FU_AREA_UM2
                  + FU_AREA_PER_EXTRA_DF_UM2 * max(0, n_dataflows - 1))
    n_ep = max(8, int(np.sqrt(n_fus)))
    parts = {
        "fu_array": fu,
        "buffers": sram_area_um2(buffer_bytes, banks),
        "noc": noc_area_um2(n_ep),
        "ppu": ppu_area_um2(n_ppus),
    }
    parts["total_mm2"] = sum(parts.values()) / 1e6
    return parts


def estimate_design_power_mw(n_fus: int, buffer_bytes: int,
                             n_dataflows: int = 1, n_ppus: int = 8,
                             sram_bytes_per_cycle: float | None = None) -> dict:
    """Closed-form power of a design for DSE scoring."""
    fu = n_fus * (FU_POWER_MW
                  + FU_POWER_PER_EXTRA_DF_MW * max(0, n_dataflows - 1))
    n_ep = max(8, int(np.sqrt(n_fus)))
    if sram_bytes_per_cycle is None:
        # LEGO interconnects feed the array from O(√N) data nodes, not N edges
        sram_bytes_per_cycle = 4.0 * np.sqrt(n_fus)
    sram_mw = sram_read_pj_per_byte(buffer_bytes) * sram_bytes_per_cycle * FREQ_GHZ
    parts = {
        "fu_array": fu,
        "buffers": sram_mw,
        "noc": noc_power_mw(n_ep),
        "ppu": ppu_power_mw(n_ppus),
    }
    parts["total_mw"] = sum(parts.values())
    return parts

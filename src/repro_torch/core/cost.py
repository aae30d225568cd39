"""Analytic 28 nm area/power/energy model (replaces Design Compiler + CACTI):
a copy of the reference's ``repro.core.cost``.

The DAG half (:func:`dag_area_um2`, :func:`dag_power_mw`,
:func:`design_area_mm2`, :func:`design_power_mw`) scores a generated
architecture graph; the closed-form half is what the mapping engine and the
design space need (the SRAM and DRAM energies the perf model charges and
the estimators ``DesignSpace.is_valid`` prunes by).  No synthesis runs, so
primitive costs are table constants calibrated against the paper's absolute
anchors:

  * LEGO-MNICOC (256 FUs int8, 256 KB buffers): 1.76 mm², 285 mW, with
    buffers ≈ 86% of area and FU array + NoC ≈ 83% of power (Fig. 12a);
  * LEGO-ICOC-1K (1024 FUs, 576 KB): 3.95 mm², 601 mW (Table II);
  * energy-efficiency plateau ≈ 4.7–4.9 TOP/s/W for 64–16k FUs (Table IV).

All *relative* results (Fig. 10/13/14, Table V) are emergent from the DAG
structure, not from these constants.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dag import DAG

__all__ = ["AreaBreakdown", "PowerBreakdown", "dag_area_um2", "dag_power_mw",
           "sram_area_um2", "sram_read_pj_per_byte", "DRAM_PJ_PER_BYTE",
           "design_area_mm2", "design_power_mw", "noc_area_um2",
           "noc_power_mw", "ppu_area_um2", "ppu_power_mw",
           "estimate_design_area_mm2", "estimate_design_power_mw"]

# -- primitive area (µm², TSMC 28 nm class) ----------------------------------
A_MUL_PER_BIT2 = 5.5          # multiplier ~ 5.5 · b² (8×8 ≈ 350 µm²)
A_ADD_PER_BIT = 6.0
A_REG_PER_BIT = 4.5           # DFF
A_MUX2_PER_BIT = 1.8
A_FIFO_PER_BIT = 3.6          # latch/reg-file based programmable FIFO
A_LUT = 900.0                 # small activation LUT
A_ADDRGEN = 1400.0            # matrix-vector address core (shared, §III-D)
A_COUNTER = 160.0
A_MEMPORT = 140.0             # distribution-switch endpoint
A_CE_GATE = 12.0              # clock-enable cell for power gating

# -- primitive dynamic energy (pJ per active cycle) ---------------------------
E_MUL8 = 0.115
E_ADD_PER_BIT = 0.0028
E_REG_PER_BIT = 0.0030
E_MUX_PER_BIT = 0.0006
E_FIFO_PER_BIT = 0.0024       # per stored bit per cycle (shift/ptr update)
E_ADDRGEN = 0.55
E_MEMPORT = 0.05
STATIC_FRACTION = 0.08        # leakage as a fraction of peak dynamic

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


def _mux_area(bits: int, ways: int) -> float:
    return A_MUX2_PER_BIT * bits * max(1, ways - 1)


@dataclass
class AreaBreakdown:
    compute: float = 0.0      # mul/add/reduce/acc
    registers: float = 0.0    # pipeline + skew regs
    fifos: float = 0.0
    muxes: float = 0.0
    control: float = 0.0      # counters, addrgens, memports
    total_um2: float = 0.0

    def as_dict(self):
        return {k: getattr(self, k) for k in
                ("compute", "registers", "fifos", "muxes", "control", "total_um2")}


def dag_area_um2(dag: DAG) -> AreaBreakdown:
    br = AreaBreakdown()
    for n in dag.nodes.values():
        if n.kind == "mul":
            br.compute += A_MUL_PER_BIT2 * (n.bits / 2) ** 2
        elif n.kind in ("add",):
            br.compute += A_ADD_PER_BIT * n.bits
        elif n.kind == "reduce":
            fan = int(n.meta.get("fan", n.meta.get("ports", 2)))
            br.compute += A_ADD_PER_BIT * n.bits * max(1, fan - 1)
        elif n.kind == "acc":
            br.compute += A_ADD_PER_BIT * n.bits + A_REG_PER_BIT * n.bits
        elif n.kind == "reg":
            br.registers += A_REG_PER_BIT * n.bits * max(1, n.meta.get("depth", 1))
        elif n.kind == "fifo":
            br.fifos += A_FIFO_PER_BIT * n.bits * max(1, n.meta.get("depth", 1))
        elif n.kind == "mux":
            br.muxes += _mux_area(n.bits, int(n.meta.get("ways", 2)))
        elif n.kind == "addrgen":
            br.control += A_ADDRGEN
        elif n.kind == "counter":
            br.control += A_COUNTER
        elif n.kind == "memport":
            br.control += A_MEMPORT
        elif n.kind == "lut":
            br.control += A_LUT
        if n.meta.get("gated"):
            br.control += A_CE_GATE
    # pipeline registers inserted on edges by delay matching
    for e in dag.edges:
        br.registers += A_REG_PER_BIT * e.bits * e.el
    br.total_um2 = br.compute + br.registers + br.fifos + br.muxes + br.control
    return br


@dataclass
class PowerBreakdown:
    compute: float = 0.0
    registers: float = 0.0
    fifos: float = 0.0
    other: float = 0.0
    total_mw: float = 0.0

    def as_dict(self):
        return {k: getattr(self, k) for k in
                ("compute", "registers", "fifos", "other", "total_mw")}


def dag_power_mw(dag: DAG, active_df: str | None = None,
                 activity: float = 0.85) -> PowerBreakdown:
    """Dynamic + leakage power at 1 GHz.  Power-gated nodes burn only leakage
    when the active dataflow does not use them (§V-D)."""
    br = PowerBreakdown()

    def active(nid) -> bool:
        if active_df is None:
            return True
        users = dag.users.get(nid, set())
        return (active_df in users) or not users

    for n in dag.nodes.values():
        on = active(n.id)
        gate_ok = n.meta.get("gated", False)
        act = activity if on else (0.0 if gate_ok else activity * 0.35)
        pj = 0.0
        if n.kind == "mul":
            pj = E_MUL8 * (n.bits / 16) ** 2
            br.compute += pj * act * FREQ_GHZ
        elif n.kind in ("add",):
            br.compute += E_ADD_PER_BIT * n.bits * act * FREQ_GHZ
        elif n.kind == "reduce":
            fan = int(n.meta.get("fan", n.meta.get("ports", 2)))
            br.compute += E_ADD_PER_BIT * n.bits * max(1, fan - 1) * act * FREQ_GHZ
        elif n.kind == "acc":
            br.compute += (E_ADD_PER_BIT + E_REG_PER_BIT) * n.bits * act * FREQ_GHZ
        elif n.kind == "reg":
            bits = n.bits * max(1, n.meta.get("depth", 1))
            br.registers += E_REG_PER_BIT * bits * act * FREQ_GHZ
        elif n.kind == "fifo":
            bits = n.bits * max(1, n.meta.get("depth", 1))
            br.fifos += E_FIFO_PER_BIT * bits * act * FREQ_GHZ
        elif n.kind == "mux":
            br.other += E_MUX_PER_BIT * n.bits * act * FREQ_GHZ
        elif n.kind == "addrgen":
            br.other += E_ADDRGEN * act * FREQ_GHZ
        elif n.kind == "memport":
            br.other += E_MEMPORT * act * FREQ_GHZ
    for e in dag.edges:
        br.registers += E_REG_PER_BIT * e.bits * e.el * activity * FREQ_GHZ

    dyn = br.compute + br.registers + br.fifos + br.other
    br.total_mw = dyn * (1.0 + STATIC_FRACTION)
    return br


# -- system-level pieces outside the DAG --------------------------------------

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


def design_area_mm2(dag: DAG, buffer_bytes: int, banks: int,
                    n_ppus: int = 8, n_l1_endpoints: int | None = None) -> dict:
    a = dag_area_um2(dag)
    n_ep = n_l1_endpoints if n_l1_endpoints is not None else max(
        8, dag.count("memport"))
    parts = {
        "fu_array": a.total_um2,
        "buffers": sram_area_um2(buffer_bytes, banks),
        "noc": noc_area_um2(n_ep),
        "ppu": ppu_area_um2(n_ppus),
    }
    parts["total_mm2"] = sum(parts.values()) / 1e6
    parts["fu_breakdown"] = a.as_dict()
    return parts


# -- closed-form design estimators (no DAG required) --------------------------
#
# The DSE sweep scores hundreds of candidate designs; generating the full ADG
# and running the back end for each (~10 s at 256 FUs) would dominate the
# sweep, so the area/power axes of the Pareto frontier use a closed-form
# estimate instead.  Constants are calibrated against the DAG-based model for
# the paper's two anchor designs (LEGO-MNICOC 256 FUs fused ≈ 1.8–2.0 mm²,
# LEGO-ICOC-1K 1024 FUs ≈ 4 mm²): each FU carries a MAC + accumulator +
# pipeline/skew registers, and every additional runtime-switchable dataflow
# adds mux/FIFO/data-node overhead per FU (§IV-C fusion hardware).

FU_AREA_UM2 = 1150.0              # MAC + acc + regs + share of links
FU_AREA_PER_EXTRA_DF_UM2 = 280.0  # muxes + shared FIFOs + extra data nodes
FU_POWER_MW = 0.78                # active per-FU power incl. link traffic
FU_POWER_PER_EXTRA_DF_MW = 0.07


def estimate_design_area_mm2(n_fus: int, buffer_bytes: int,
                             n_dataflows: int = 1, n_ppus: int = 8,
                             banks: int = 16) -> dict:
    """Closed-form analogue of :func:`design_area_mm2` for DSE scoring."""
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
    """Closed-form analogue of :func:`design_power_mw` for DSE scoring."""
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


def design_power_mw(dag: DAG, buffer_bytes: int, sram_bytes_per_cycle: float,
                    n_ppus: int = 8, active_df: str | None = None,
                    n_l1_endpoints: int | None = None) -> dict:
    p = dag_power_mw(dag, active_df)
    n_ep = n_l1_endpoints if n_l1_endpoints is not None else max(
        8, dag.count("memport"))
    sram_mw = sram_read_pj_per_byte(buffer_bytes) * sram_bytes_per_cycle * FREQ_GHZ
    parts = {
        "fu_array": p.total_mw,
        "buffers": sram_mw,
        "noc": noc_power_mw(n_ep),
        "ppu": ppu_power_mw(n_ppus),
    }
    parts["total_mw"] = sum(parts.values())
    parts["fu_breakdown"] = p.as_dict()
    return parts

"""Standard LEGO-generated designs used across the paper's evaluation: the
port's copy of the reference's ``benchmarks/designs.py``, on the port's
``workload``, ``dataflow``, ``adg`` and ``mapper``.

Design names follow the paper's *Operation-Dataflow* convention; `M`/`N`
denote runtime-switchable spatial dataflows fused into one architecture
(e.g. GEMM-MJ = {I-J, K-J}, Conv2d-MNICOC = {OH-OW, IC-OC}).
"""

from __future__ import annotations

import functools

from .core import workload as W
from .core.adg import generate_adg
from .core.dataflow import build_dataflow
from .core.mapper import SpatialChoice

__all__ = ["DESIGNS", "SET_TO_DESIGN", "build_design", "design_spatials"]

# which generated ADG realizes each DSE dataflow set (conv family shown in
# the Fig. 12-style interconnect demo; GEMM menus share the same class).
# "attention_fused" is the score-stationary two-workload design: the QK and
# PV stages share one FU array with P resident between them (Fig. 10).
SET_TO_DESIGN = {"os": "Conv2d-OHOW", "ws": "Conv2d-ICOC",
                 "switch": "Conv2d-MNICOC", "attention_fused": "Attention"}


def _gemm_jk(P=16, name="gemm-jk"):
    wl = W.gemm()
    return wl, build_dataflow(wl, spatial=[("k", P), ("j", P)],
                              temporal=[("i", 4), ("j", 4), ("k", 4), ("i", 8)],
                              c=(1, 1), name=name)


def _gemm_ij(P=16, name="gemm-ij"):
    wl = W.gemm()
    return wl, build_dataflow(wl, spatial=[("i", P), ("j", P)],
                              temporal=[("i", 4), ("j", 4), ("k", 32)],
                              c=(1, 1), name=name)


def _conv_ohow(P=16, name="conv-ohow"):
    wl = W.conv2d()
    return wl, build_dataflow(
        wl, spatial=[("ow", P), ("oh", P)],
        temporal=[("n", 1), ("ow", 2), ("oh", 2), ("oc", 8), ("ic", 8),
                  ("kh", 3), ("kw", 3)],
        c=(0, 0), name=name)


def _conv_icoc(P=16, name="conv-icoc"):
    wl = W.conv2d()
    return wl, build_dataflow(
        wl, spatial=[("ic", P), ("oc", P)],
        temporal=[("n", 1), ("oc", 2), ("ic", 2), ("oh", 8), ("ow", 8),
                  ("kh", 3), ("kw", 3)],
        c=(1, 1), name=name)


def _conv_khoh(Pkh=8, Poh=32, name="conv-khoh"):
    # Eyeriss-style row-stationary-ish: KH×OH parallel
    wl = W.conv2d()
    return wl, build_dataflow(
        wl, spatial=[("kh", Pkh), ("oh", Poh)],
        temporal=[("n", 1), ("oc", 8), ("ic", 4), ("ow", 16), ("kw", 3)],
        c=(0, 0), name=name)


def _attn_qk(P=16):
    wl = W.attention_qk()
    return wl, build_dataflow(wl, spatial=[("m", P), ("n", P)],
                              temporal=[("b", 2), ("m", 2), ("n", 2), ("d", 16)],
                              c=(0, 0), name="attn-qk")


def _attn_pv(P=16):
    # shares the (m, n) FU grid and the b/m/n extents with _attn_qk so the
    # score tensor S -> P hands over shape-exactly between the two stages
    wl = W.attention_pv()
    return wl, build_dataflow(wl, spatial=[("m", P), ("n", P)],
                              temporal=[("b", 2), ("m", 2), ("n", 2), ("d", 16)],
                              c=(0, 0), name="attn-pv")


def _mttkrp_ij(P=16, name="mttkrp-ij"):
    wl = W.mttkrp()
    return wl, build_dataflow(wl, spatial=[("i", P), ("j", P)],
                              temporal=[("i", 2), ("k", 8), ("l", 8)],
                              c=(0, 0), name=name)


def _mttkrp_kj(P=16, name="mttkrp-kj"):
    wl = W.mttkrp()
    return wl, build_dataflow(wl, spatial=[("k", P), ("j", P)],
                              temporal=[("i", 16), ("k", 2), ("l", 8)],
                              c=(1, 1), name=name)


DESIGNS = {
    # single-dataflow designs
    "GEMM-JK": lambda: [_gemm_jk()],
    "GEMM-IJ": lambda: [_gemm_ij()],
    "Conv2d-OHOW": lambda: [_conv_ohow()],
    "Conv2d-ICOC": lambda: [_conv_icoc()],
    "Conv2d-KHOH": lambda: [_conv_khoh()],
    "MTTKRP-IJ": lambda: [_mttkrp_ij()],
    # fused / switchable designs (the paper's M/N notation)
    "GEMM-MJ": lambda: [_gemm_jk(), _gemm_ij()],
    "Conv2d-MNICOC": lambda: [_conv_ohow(), _conv_icoc()],
    "MTTKRP-MJ": lambda: [_mttkrp_ij(), _mttkrp_kj()],
    "Attention": lambda: [_attn_qk(), _attn_pv()],  # score-stationary fusion
}


@functools.lru_cache(maxsize=None)
def build_design(name: str, fuse: str = "heuristic"):
    specs = DESIGNS[name]()
    return generate_adg(specs, name=name, fuse=fuse)


def design_spatials(name: str) -> list[SpatialChoice]:
    """Mapper-facing spatial dataflow choices a design supports."""
    table = {
        "GEMM-JK": [SpatialChoice(("k", "j"), (1, 1), "jk")],
        "GEMM-IJ": [SpatialChoice(("i", "j"), (1, 1), "ij")],
        "GEMM-MJ": [SpatialChoice(("k", "j"), (1, 1), "jk"),
                    SpatialChoice(("i", "j"), (1, 1), "ij")],
        "Conv2d-OHOW": [SpatialChoice(("ow", "oh"), (0, 0), "ohow")],
        "Conv2d-ICOC": [SpatialChoice(("ic", "oc"), (1, 1), "icoc")],
        "Conv2d-MNICOC": [SpatialChoice(("ow", "oh"), (0, 0), "ohow"),
                          SpatialChoice(("ic", "oc"), (1, 1), "icoc")],
    }
    return table[name]

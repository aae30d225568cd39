"""Roofline terms of a traced dry-run cell against the H100 (the
counterpart of ``repro.launch.roofline``; no TPU constant carries over).

Constants, per card (NVIDIA H100 SXM 80GB, the part the port runs on, at
its 700 W limit): peak dense bf16 tensor-core rate 989 TFLOP/s and HBM3
3.35 TB/s (``kernels/autotile.py``'s ``PEAK_FLOPS[2]`` and
``PEAK_BYTES``, from NVIDIA's data sheet), and NVLink 4 at 450 GB/s per
direction (18 links of 25 GB/s each way, the same data sheet).

Terms, as the reference defines them:
    compute    = FLOPs_global          / (cards · 989e12)
    memory     = bytes_global          / (cards · 3.35e12)
    collective = collective_bytes_global / (cards · 450e9)

The counts come from :mod:`repro_torch.launch.opcount`, per device; global
= per device × cards.  These are predictions from operation counts, not
measurements.  The useful FLOPs (:func:`model_flops_for`) count
``cfg.n_active_params()``, which leaves out an encoder-decoder model's
encoder, as the reference's count does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kernels.autotile import PEAK_BYTES, PEAK_FLOPS as _PEAK

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "CARD", "Roofline",
           "model_flops_for", "analyze"]

CARD = "NVIDIA H100 SXM 80GB, 700 W"
PEAK_FLOPS = _PEAK[2]          # dense bf16 on the tensor cores
HBM_BW = PEAK_BYTES
LINK_BW = 450e9                # NVLink 4, per direction per card
HBM_GB = 80.0                  # the budget a cell must fit per card


@dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    flops_global: float
    bytes_global: float
    collective_bytes_global: float
    model_flops: float
    peak_mem_bytes_per_device: float = 0.0
    coll_detail: dict = field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_global / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_global / (self.chips * LINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Optimistic no-overlap-needed estimate: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops_global if self.flops_global \
            else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the peak-compute roofline reached at the predicted
        step time, counting only useful (6·N·D-style) FLOPs."""
        if self.step_time == 0:
            return 0.0
        achieved = self.model_flops / self.step_time
        return achieved / (self.chips * PEAK_FLOPS)

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "chips": self.chips,
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "collective_bytes_global": self.collective_bytes_global,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_bytes_per_device": self.peak_mem_bytes_per_device,
            "coll_detail": self.coll_detail,
        }


def model_flops_for(cfg, shape_info: dict) -> float:
    """Useful FLOPs per step: 6·N·D for training, 2·N·D for prefill,
    2·N_active per generated token for decode (batch tokens); N is
    ``cfg.n_active_params()``."""
    kind = shape_info["kind"]
    B, T = shape_info["global_batch"], shape_info["seq_len"]
    n_active = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n_active * B * T
    if kind == "prefill":
        return 2.0 * n_active * B * T
    return 2.0 * n_active * B  # one token per sequence


def analyze(arch: str, shape: str, cfg, counts, n_devices: int,
            peak_mem: float) -> Roofline:
    """The roofline of a cell from its per-device ``counts``
    (:class:`~repro_torch.launch.opcount.OpCounts`) and its peak memory
    per device."""
    from .cells import SHAPES
    coll = {**counts.coll_bytes, "counts": counts.coll_counts,
            "per_device_bytes": counts.coll_bytes_total,
            "n_ops": counts.n_ops,
            "top_dots": counts.top_flops[:6],
            "top_bytes": counts.top_bytes[:8]}
    return Roofline(
        arch=arch, shape=shape, chips=n_devices,
        flops_global=counts.flops * n_devices,
        bytes_global=counts.bytes * n_devices,
        collective_bytes_global=counts.coll_bytes_total * n_devices,
        model_flops=model_flops_for(cfg, SHAPES[shape]),
        peak_mem_bytes_per_device=float(peak_mem),
        coll_detail=coll,
    )

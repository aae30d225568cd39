"""PyTorch scoring engine (``engine="torch"``): the twin of the reference's
JAX engine (``repro.core.perf_model_jax``).

The NumPy kernels in :mod:`repro_torch.core.perf_model` score one candidate
batch per call on the host.  This module scores the same struct-of-arrays
candidate batch on the card: every candidate row is one row of a tensor,
int64 for every reduction and float64 for the float steps, and with the
design axis one call scores ``D`` designs × ``C`` candidates.  As in the
reference's double ``vmap``, the design-invariant chain — extents,
footprints, compute cycles, MACs — runs once at ``(C, …)``; only the
budget test, the level choice, the traffic gather, the memory cycles, the
SRAM reads and the energy batch to ``(D, C)``.

Contract with the NumPy engine (``tests/test_torch_dse.py`` and
``chip_smoke.py`` phase 9 hold it):

* every integer-derived quantity (cycles, MACs, utilization, DRAM bytes,
  SRAM reads, PPU cycles, the memory-bound flag) is **bit-identical** —
  ``prod``/``cumprod``/the footprint contraction run in int64 exactly like
  NumPy, and the float steps are element-wise IEEE operations in NumPy's
  order (DRAM bytes and SRAM reads summed tensor by tensor, the static
  energy as ``static_mw * cycles / freq_ghz * 1e-3``);
* ``energy_pj`` is held within :data:`ENERGY_RTOL` (eager PyTorch runs one
  operation per kernel, so nothing contracts into an FMA across them);
* selection never trusts these floats for the *reported* numbers:
  :func:`repro_torch.core.mapper_batch.best_mappings` orders candidates by
  them (host-side stable lexsort) and re-scores the winners through the
  NumPy kernel, so mapping caches are byte-identical across engines.

Both entry points run on ``device="cuda"`` unless the caller passes
another device, and raise where CUDA is absent.  An empty batch
(``C == 0``) answers through NumPy, as the reference's does.  The integer
contraction is a broadcast multiply and a ``sum``: CUDA's matrix products
take no int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.common import check_device
from .cost import DRAM_PJ_PER_BYTE, sram_read_pj_per_byte
from .perf_model import HWConfig, perf_kernel
from .workload import Workload

__all__ = ["perf_kernel_torch", "perf_kernel_torch_design", "ENERGY_RTOL",
           "ENGINES", "RESULT_KEYS"]

# the engines a mapping query can be solved with ("numpy" is the batched
# default; "batch" is its historical alias; "scalar" is the reference
# candidate-at-a-time oracle)
ENGINES = ("numpy", "torch", "scalar")

# tolerance for float energies (everything else is exact): the reference's
# gate for its JAX engine, kept for this one
ENERGY_RTOL = 1e-9

# perf_kernel's result keys, in the order the card returns them
RESULT_KEYS = ("cycles", "macs", "utilization", "dram_bytes", "sram_reads",
               "energy_pj", "memory_bound", "ppu_cycles")

_I64, _F64 = torch.int64, torch.float64


def _hw_rows(hw_list: list[HWConfig], tensors) -> dict[str, np.ndarray]:
    """Per-design scalars as ``(D,)`` rows, each computed on the host exactly
    as :func:`~repro_torch.core.perf_model.perf_kernel` computes it."""
    T = len(tensors)
    return {
        "budget": np.array([hw.buffer_bytes / T for hw in hw_list]),
        "db": np.array([[hw.acc_bytes if t.role == "output"
                         else hw.data_bytes for t in tensors]
                        for hw in hw_list], dtype=np.float64).reshape(-1, T),
        "bytes_per_cycle": np.array([hw.bytes_per_cycle for hw in hw_list]),
        "n_ppus": np.array([max(1, hw.n_ppus) for hw in hw_list],
                           dtype=np.float64),
        "sram_pj": np.array([sram_read_pj_per_byte(hw.buffer_bytes)
                             for hw in hw_list]),
        "e_reg": np.array([hw.e_reg_pj_per_byte for hw in hw_list]),
        "data_bytes": np.array([hw.data_bytes for hw in hw_list],
                               dtype=np.float64),
        "e_mac": np.array([hw.e_mac_pj for hw in hw_list]),
        "e_ppu": np.array([hw.e_ppu_pj for hw in hw_list]),
        "static_mw": np.array([hw.static_mw for hw in hw_list]),
        "freq_ghz": np.array([hw.freq_ghz for hw in hw_list]),
    }


def _score(wl: Workload, hw_list: list[HWConfig], loop_dim, loop_size, S,
           n_fus, fill, true_sizes, data_nodes, ppu_elements,
           device: torch.device, timing: dict | None) -> dict[str, np.ndarray]:
    """``(D, C)`` scores of one candidate batch against ``len(hw_list)``
    designs; ``data_nodes`` is one ``(D, T)`` row per design."""
    C, L = loop_size.shape
    Dd = S.shape[1]
    tensors = list(wl.tensors)
    # one upload of the candidate rows: ints and floats, each one copy
    ints = np.concatenate([loop_dim, loop_size, S, true_sizes,
                           n_fus[:, None]], axis=1).astype(np.int64)
    flts = np.stack([fill, ppu_elements], axis=1).astype(np.float64)
    hw = _hw_rows(hw_list, tensors)
    host = {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in hw.items()}
    host["ints"] = torch.from_numpy(np.ascontiguousarray(ints))
    host["flts"] = torch.from_numpy(np.ascontiguousarray(flts))
    host["dn"] = torch.from_numpy(np.array(data_nodes, dtype=np.int64))
    for k, t in enumerate(tensors):   # the workload's access maps
        host[f"Mpos{k}"] = torch.from_numpy(
            np.clip(t.fmap.M, 0, None).astype(np.int64))
        host[f"b{k}"] = torch.from_numpy(np.asarray(t.fmap.b, dtype=np.int64))
        host[f"dep{k}"] = torch.from_numpy(t.fmap.M.any(axis=0))
    dev = {k: v.to(device) for k, v in host.items()}
    events = None
    if timing is not None and device.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()

    ints, flts = dev["ints"], dev["flts"]
    ld, ls = ints[:, :L], ints[:, L:2 * L]
    Sd = ints[:, 2 * L:2 * L + Dd]
    ts = ints[:, 2 * L + Dd:2 * L + 2 * Dd]
    nf = ints[:, 2 * L + 2 * Dd]
    fill_d, ppu = flts[:, 0], flts[:, 1]

    # ---- design-invariant chain, once at (C, ...) -----------------------
    # extents E[c, l, d]: temporal loops at depth >= l times the spatial tile
    onehot = ld[:, :, None] == torch.arange(Dd, device=device, dtype=_I64)
    G = torch.where(onehot, ls[:, :, None], torch.ones_like(ls[:, :, None]))
    suffix = torch.flip(torch.cumprod(torch.flip(G, [1]), dim=1), [1])
    E = Sd[:, None, :] * torch.cat(
        [suffix, torch.ones((C, 1, Dd), dtype=_I64, device=device)], dim=1)
    sizes_full = E[:, 0, :]
    padded_macs = torch.prod(sizes_full, dim=1).to(_F64)
    true_macs = torch.prod(torch.minimum(ts, sizes_full), dim=1).to(_F64)
    util = true_macs / padded_macs
    compute_cycles = torch.prod(ls, dim=1).to(_F64) + fill_d
    pre = torch.cat([torch.ones((C, 1), dtype=_I64, device=device),
                     torch.cumprod(ls, dim=1)], dim=1).to(_F64)
    real = ld >= 0
    lvl_of = torch.arange(L, device=device, dtype=_I64)
    Em1 = (E - 1)[:, :, None, :]                      # (C, L+1, 1, D)
    fp_elems = []   # (C, L+1) distinct elements of each tensor per level
    nondep = []     # (C, L) reduction loops of an output, else None
    for k, t in enumerate(tensors):
        mx = (Em1 * dev[f"Mpos{k}"]).sum(dim=3) + dev[f"b{k}"]
        fp_elems.append(torch.prod(mx + 1, dim=2))
        if t.role == "output":
            dep = dev[f"dep{k}"]
            nondep.append(real & ~dep[torch.clamp(ld, min=0)])
        else:
            nondep.append(None)

    # ---- per design, (D, C) ----------------------------------------------
    col = {k: dev[k][:, None] for k in hw if k != "db"}  # (D, 1) rows
    D = len(hw_list)
    dram_bytes = torch.zeros((D, C), dtype=_F64, device=device)
    sram_reads = torch.zeros((D, C), dtype=_F64, device=device)
    for k, t in enumerate(tensors):
        db = dev["db"][:, k]
        fp = fp_elems[k].to(_F64)[None] * db[:, None, None]  # (D, C, L+1)
        fits = fp <= dev["budget"][:, None, None]
        lvl = torch.where(fits.any(dim=2),
                          torch.argmax(fits.to(torch.int32), dim=2),
                          torch.full((D, C), L, dtype=_I64, device=device))
        traffic = (torch.gather(fp, 2, lvl[:, :, None])[:, :, 0]
                   * torch.gather(pre.expand(D, C, L + 1), 2,
                                  lvl[:, :, None])[:, :, 0])
        if nondep[k] is not None:
            spills = (nondep[k][None]
                      & (lvl_of[None, None, :] < lvl[:, :, None])).any(dim=2)
            traffic = torch.where(spills, traffic * 2.0, traffic)
        dram_bytes = dram_bytes + traffic
        dn = torch.minimum(dev["dn"][:, k][:, None], nf[None, :])
        sram_reads = sram_reads + compute_cycles[None] * dn * db[:, None]
    mem_cycles = dram_bytes / col["bytes_per_cycle"]
    ppu_cycles = ppu[None] / col["n_ppus"]
    cycles = torch.maximum(compute_cycles[None], mem_cycles) + ppu_cycles
    memory_bound = mem_cycles > compute_cycles[None]

    sram_pj = col["sram_pj"] * sram_reads
    link_pj = col["e_reg"] * compute_cycles[None] * nf[None] \
        * col["data_bytes"]
    energy = (true_macs[None] * col["e_mac"]
              + sram_pj + link_pj
              + dram_bytes * DRAM_PJ_PER_BYTE
              + ppu[None] * col["e_ppu"]
              + col["static_mw"] * cycles / col["freq_ghz"] * 1e-3)
    out = torch.stack([cycles, true_macs[None].expand(D, C),
                       util[None].expand(D, C), dram_bytes, sram_reads,
                       energy, memory_bound.to(_F64), ppu_cycles])
    if events is not None:
        events[1].record()
    res = out.cpu().numpy()                          # the one host sync
    if events is not None:
        timing["device_ms"] = (timing.get("device_ms", 0.0)
                               + events[0].elapsed_time(events[1]))
    r = dict(zip(RESULT_KEYS, res))
    r["memory_bound"] = r["memory_bound"] != 0.0
    return r


def perf_kernel_torch(
    wl: Workload,
    hw: HWConfig,
    loop_dim: np.ndarray,
    loop_size: np.ndarray,
    S: np.ndarray,
    n_fus: np.ndarray,
    fill: np.ndarray,
    true_sizes: np.ndarray,
    data_nodes: np.ndarray,
    ppu_elements: np.ndarray,
    device="cuda",
) -> dict[str, np.ndarray]:
    """Drop-in PyTorch replacement for
    :func:`repro_torch.core.perf_model.perf_kernel`, scored on ``device``.

    Same candidate row encoding, same result keys.  ``data_nodes`` rows must
    be identical across the batch (the mapper-batch invariant: one
    data-node vector per query set) — asserted, as the reference asserts
    it.  Results come back as host NumPy arrays.
    """
    dev = check_device(device)
    C = loop_size.shape[0]
    if C == 0:
        return perf_kernel(wl, hw, loop_dim, loop_size, S, n_fus, fill,
                           true_sizes, data_nodes, ppu_elements)
    assert (data_nodes == data_nodes[0]).all(), \
        "engine='torch' expects one shared data-node row per batch"
    r = _score(wl, [hw], loop_dim, loop_size, S, n_fus,
               np.asarray(fill, dtype=np.float64), true_sizes,
               np.asarray(data_nodes[:1]),
               np.asarray(ppu_elements, dtype=np.float64), dev, None)
    return {k: v[0] for k, v in r.items()}


def perf_kernel_torch_design(
    wl: Workload,
    hw_list: list[HWConfig],
    loop_dim: np.ndarray,
    loop_size: np.ndarray,
    S: np.ndarray,
    n_fus: np.ndarray,
    fill: np.ndarray,
    true_sizes: np.ndarray,
    data_nodes: np.ndarray,
    ppu_elements: np.ndarray,
    device="cuda",
    timing: dict | None = None,
) -> dict[str, np.ndarray]:
    """Score one candidate batch against **D designs** in one dispatch.

    Candidate arrays are the shared ``(C, …)`` row encoding of
    :func:`perf_kernel_torch` (all designs must enumerate the identical
    candidate set — callers group designs by ``n_fus``); ``data_nodes`` is
    one ``(D, T)`` row per design.  Returns ``(D, C)``-shaped host arrays.
    ``timing``, when given on a card, accumulates the device time between
    the upload and the results (``device_ms``, CUDA events).
    """
    dev = check_device(device)
    Dn = len(hw_list)
    assert Dn >= 1 and data_nodes.shape[0] == Dn
    C = loop_size.shape[0]
    if C == 0:
        rs = [perf_kernel(wl, hw, loop_dim, loop_size, S, n_fus, fill,
                          true_sizes,
                          np.empty((0, data_nodes.shape[1]), dtype=np.int64),
                          ppu_elements)
              for hw in hw_list]
        return {k: np.stack([r[k] for r in rs]) for k in RESULT_KEYS}
    return _score(wl, hw_list, loop_dim, loop_size, S, n_fus,
                  np.asarray(fill, dtype=np.float64), true_sizes,
                  np.asarray(data_nodes),
                  np.asarray(ppu_elements, dtype=np.float64), dev, timing)

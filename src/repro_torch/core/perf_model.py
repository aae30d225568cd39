"""Fast performance/energy model for the FU array + memory system.

This is the paper's front-end "performance simulator ... to fast predict the
latency of computation and memory movement" (§VI-A), used both to drive the
mapping search and to produce the end-to-end numbers of Fig. 11 / Table II.

Latency: ``cycles = max(compute_cycles, dram_bytes / bytes_per_cycle)`` with
spatial under-utilization from tile rounding and a pipeline fill term.

DRAM traffic per tensor follows the standard tiled-reuse argument: find the
outermost loop level whose working set fits the tensor's buffer share; all
loops outside that level replay the footprint.  Output tensors that spill
partial sums across an outer reduction loop pay read+write.

SRAM traffic comes from the ADG structure: only *data nodes* read the banks
each cycle — FU-to-FU links deliver everything else (this is where LEGO's
interconnection generation beats edge-fed arrays on scratchpad power,
Table III).

The model is implemented as **batched array kernels** operating on a
struct-of-arrays candidate representation (one row per mapping candidate):
``extents_kernel`` → ``footprint_kernel`` → ``traffic_kernel`` →
``perf_kernel``.  The scalar API (:func:`footprint`, :func:`dram_traffic`,
:func:`layer_perf`) wraps the same kernels with a batch of one, so the
batched mapping engine in :mod:`repro_torch.core.mapper_batch` is bit-identical to
the candidate-at-a-time path by construction.

Candidate row encoding (all int64 unless noted):

``loop_dim (C, L)``
    iteration-dim index of each temporal loop, outermost first; ``-1`` pads
    unused innermost slots (their ``loop_size`` must be 1).
``loop_size (C, L)``
    trip count of each temporal loop (1 for padding slots).
``S (C, D)``
    spatial extent per iteration dim (1 when the dim is not spatial).
``n_fus (C,)`` / ``fill (C,)``
    FU count (product of spatial extents) and systolic fill term (sum of
    spatial extents, float64).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np

from .cost import DRAM_PJ_PER_BYTE, sram_read_pj_per_byte
from .dataflow import Dataflow
from .workload import Workload

__all__ = ["HWConfig", "LayerPerf", "footprint", "dram_traffic", "layer_perf",
           "extents_kernel", "footprint_kernel", "traffic_kernel",
           "perf_kernel", "NO_TRUE_SIZE"]

# sentinel for "no true size given for this dim" — min() then keeps the
# padded extent, mirroring ``true_sizes.get(d, sizes[d])`` in the scalar API
NO_TRUE_SIZE = np.int64(2 ** 62)


@dataclass(frozen=True)
class HWConfig:
    n_fus: int = 256
    buffer_bytes: int = 256 * 1024
    dram_gbps: float = 16.0
    freq_ghz: float = 1.0
    n_ppus: int = 8
    data_bytes: int = 1          # int8 datapath (paper evaluation)
    acc_bytes: int = 4
    e_mac_pj: float = 0.28       # full MAC incl. local pipeline
    e_reg_pj_per_byte: float = 0.024
    e_ppu_pj: float = 1.1        # per element (LUT + reduce)
    static_mw: float = 25.0

    @property
    def bytes_per_cycle(self) -> float:
        return self.dram_gbps / self.freq_ghz

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def signature(self) -> tuple:
        """Stable content key over every field that affects mapping/perf —
        used by the DSE persistent mapping cache."""
        return tuple(sorted(self.as_dict().items()))


@dataclass
class LayerPerf:
    cycles: float
    macs: float
    utilization: float
    dram_bytes: float
    sram_reads: float
    energy_pj: float
    bound: str
    ppu_cycles: float = 0.0

    @property
    def gops(self) -> float:
        # 2 ops per MAC, at 1 GHz (cycles == ns)
        return 2.0 * self.macs / max(1.0, self.cycles)

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "LayerPerf":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_kernel(cls, r: dict, i: int) -> "LayerPerf":
        """Row ``i`` of a :func:`perf_kernel` result as a scalar record."""
        return cls(
            cycles=float(r["cycles"][i]), macs=float(r["macs"][i]),
            utilization=float(r["utilization"][i]),
            dram_bytes=float(r["dram_bytes"][i]),
            sram_reads=float(r["sram_reads"][i]),
            energy_pj=float(r["energy_pj"][i]),
            bound="memory" if bool(r["memory_bound"][i]) else "compute",
            ppu_cycles=float(r["ppu_cycles"][i]))


# ---------------------------------------------------------------------------
# batched array kernels
# ---------------------------------------------------------------------------

def extents_kernel(loop_dim: np.ndarray, loop_size: np.ndarray,
                   S: np.ndarray) -> np.ndarray:
    """Per-dim iteration extents at every temporal depth: ``(C, L+1, D)``.

    ``E[c, l, d]`` is the extent of dim ``d`` covered by temporal loops at
    depth >= ``l`` times the spatial tile — the batched form of the loop
    walk the scalar model used to do per (tensor, level).
    """
    C, L = loop_size.shape
    D = S.shape[1]
    if L == 0:
        return S[:, None, :].copy()
    onehot = loop_dim[:, :, None] == np.arange(D, dtype=np.int64)
    G = np.where(onehot, loop_size[:, :, None], np.int64(1))
    suffix = np.cumprod(G[:, ::-1, :], axis=1)[:, ::-1, :]
    E = np.concatenate([suffix, np.ones((C, 1, D), dtype=np.int64)], axis=1)
    return S[:, None, :] * E


def footprint_kernel(tensor, E: np.ndarray, data_bytes: int) -> np.ndarray:
    """Distinct bytes of ``tensor`` per candidate per level: ``(C, L+1)``.

    Tensor extent per data dim = max of ``M @ i + b`` over the iteration box
    ``[0, E-1]`` plus one; all workload maps have ``lo = 0`` so only the
    positive part of ``M`` contributes.
    """
    Mpos = np.clip(tensor.fmap.M, 0, None)
    mx = np.einsum("rd,cld->clr", Mpos, E - 1) + tensor.fmap.b
    return np.prod(mx + 1, axis=2).astype(np.float64) * data_bytes


def traffic_kernel(wl: Workload, hw: HWConfig, loop_dim: np.ndarray,
                   loop_size: np.ndarray, S: np.ndarray,
                   budget_per_tensor: dict[str, float] | None = None,
                   E: np.ndarray | None = None) -> np.ndarray:
    """Per-tensor DRAM bytes for one full layer execution: ``(C, n_tensors)``.

    For each tensor: the smallest temporal level whose working set fits the
    tensor's buffer share; every loop outside that level replays the
    footprint; outputs spill (read+write) if a non-dependent — i.e.
    reduction — loop lies outside the resident scope.
    """
    C, L = loop_size.shape
    if E is None:
        E = extents_kernel(loop_dim, loop_size, S)
    tensors = list(wl.tensors)
    if budget_per_tensor is None:
        budget_per_tensor = {t.name: hw.buffer_bytes / len(tensors)
                             for t in tensors}
    real = loop_dim >= 0
    pre = np.concatenate(
        [np.ones((C, 1), dtype=np.int64), np.cumprod(loop_size, axis=1)],
        axis=1).astype(np.float64)  # replay factors: loops outside level l
    rows = np.arange(C)
    lvl_of = np.arange(L)[None, :]
    out = np.empty((C, len(tensors)), dtype=np.float64)
    for k, t in enumerate(tensors):
        db = hw.acc_bytes if t.role == "output" else hw.data_bytes
        fp = footprint_kernel(t, E, db)  # (C, L+1), non-increasing in level
        fits = fp <= budget_per_tensor[t.name]
        lvl = np.where(fits.any(axis=1), fits.argmax(axis=1), L)
        traffic = fp[rows, lvl] * pre[rows, lvl]
        if t.role == "output":
            dep = t.fmap.M.any(axis=0)  # dims the output depends on
            nondep = real & ~dep[np.clip(loop_dim, 0, None)]
            spills = (nondep & (lvl_of < lvl[:, None])).any(axis=1)
            traffic = traffic * np.where(spills, 2.0, 1.0)
        out[:, k] = traffic
    return out


def perf_kernel(
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
) -> dict[str, np.ndarray]:
    """Latency + energy for a whole candidate batch in one broadcasted pass.

    ``true_sizes (C, D)`` un-padded dims (:data:`NO_TRUE_SIZE` where
    unspecified); ``data_nodes (C, n_tensors)`` bank readers per tensor;
    ``ppu_elements (C,)`` non-tensor elements routed to the PPUs.
    Returns per-candidate arrays keyed like :class:`LayerPerf` fields
    (``memory_bound`` is a bool array instead of the ``bound`` string).
    """
    C = loop_size.shape[0]
    E = extents_kernel(loop_dim, loop_size, S)
    sizes_full = E[:, 0, :]
    padded_macs = np.prod(sizes_full, axis=1).astype(np.float64)
    true_macs = np.prod(np.minimum(true_sizes, sizes_full),
                        axis=1).astype(np.float64)
    util = true_macs / padded_macs

    compute_cycles = np.prod(loop_size, axis=1).astype(np.float64) + fill

    traffic = traffic_kernel(wl, hw, loop_dim, loop_size, S, E=E)
    dram_bytes = np.zeros(C, dtype=np.float64)
    for k in range(traffic.shape[1]):
        dram_bytes = dram_bytes + traffic[:, k]
    mem_cycles = dram_bytes / hw.bytes_per_cycle

    ppu_cycles = ppu_elements / max(1, hw.n_ppus)
    cycles = np.maximum(compute_cycles, mem_cycles) + ppu_cycles
    memory_bound = mem_cycles > compute_cycles

    # SRAM reads: data nodes touch banks; everything else rides the links
    sram_reads = np.zeros(C, dtype=np.float64)
    for k, t in enumerate(wl.tensors):
        db = hw.acc_bytes if t.role == "output" else hw.data_bytes
        sram_reads = sram_reads + \
            compute_cycles * np.minimum(data_nodes[:, k], n_fus) * db

    sram_pj = sram_read_pj_per_byte(hw.buffer_bytes) * sram_reads
    link_pj = hw.e_reg_pj_per_byte * compute_cycles * n_fus * hw.data_bytes
    energy = (true_macs * hw.e_mac_pj
              + sram_pj + link_pj
              + dram_bytes * DRAM_PJ_PER_BYTE
              + ppu_elements * hw.e_ppu_pj
              + hw.static_mw * cycles / hw.freq_ghz * 1e-3)  # mW·ns = pJ
    return {"cycles": cycles, "macs": true_macs, "utilization": util,
            "dram_bytes": dram_bytes, "sram_reads": sram_reads,
            "energy_pj": energy, "memory_bound": memory_bound,
            "ppu_cycles": ppu_cycles}


# ---------------------------------------------------------------------------
# scalar API — batch-of-one wrappers around the kernels
# ---------------------------------------------------------------------------

def _df_arrays(df: Dataflow) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    ld, ls, S = df.loop_arrays()
    return ld[None, :], ls[None, :], S[None, :]


def footprint(wl: Workload, df: Dataflow, tensor: str, level: int,
              data_bytes: int) -> float:
    """Distinct bytes of ``tensor`` touched by one execution of temporal
    loops ``level..inner`` (plus the full spatial extent)."""
    ld, ls, S = _df_arrays(df)
    E = extents_kernel(ld, ls, S)
    return float(footprint_kernel(wl.tensor(tensor), E, data_bytes)[0, level])


def dram_traffic(wl: Workload, df: Dataflow, hw: HWConfig,
                 budget_per_tensor: dict[str, float] | None = None
                 ) -> dict[str, float]:
    """Per-tensor DRAM bytes for one full layer execution."""
    ld, ls, S = _df_arrays(df)
    tr = traffic_kernel(wl, hw, ld, ls, S, budget_per_tensor=budget_per_tensor)
    return {t.name: float(tr[0, k]) for k, t in enumerate(wl.tensors)}


def layer_perf(
    wl: Workload,
    df: Dataflow,
    hw: HWConfig,
    true_sizes: dict[str, int] | None = None,
    data_nodes_per_tensor: dict[str, int] | None = None,
    ppu_elements: float = 0.0,
) -> LayerPerf:
    """Predict latency + energy of executing ``wl`` under ``df`` on ``hw``.

    ``true_sizes`` gives the un-padded problem dims (utilization accounting);
    ``data_nodes_per_tensor`` plugs in the ADG's generated data-node counts
    (defaults assume one bank read per FU — edge-fed worst case).
    """
    ld, ls, S = _df_arrays(df)
    ts = np.full((1, len(wl.iter_dims)), NO_TRUE_SIZE, dtype=np.int64)
    if true_sizes:
        for i, d in enumerate(wl.iter_dims):
            if d in true_sizes:
                ts[0, i] = true_sizes[d]
    if data_nodes_per_tensor is None:
        data_nodes_per_tensor = {t.name: df.n_fus for t in wl.tensors}
    dn = np.array([[data_nodes_per_tensor.get(t.name, df.n_fus)
                    for t in wl.tensors]], dtype=np.int64)
    r = perf_kernel(wl, hw, ld, ls, S,
                    n_fus=np.array([df.n_fus], dtype=np.int64),
                    fill=np.array([float(np.sum(df.R_S))]),
                    true_sizes=ts, data_nodes=dn,
                    ppu_elements=np.array([float(ppu_elements)]))
    return LayerPerf.from_kernel(r, 0)

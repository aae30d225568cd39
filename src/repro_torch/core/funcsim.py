"""Cycle-accurate functional simulation of a generated architecture, on the
device its input tensors lie on: the twin of the reference's
``repro.core.funcsim``.

It executes an ADG dataflow where **input operands may only arrive through
the generated physical links (skew registers / FIFOs with the generated
depths) or through a data node's shared address generator**.  If the front
end derived a wrong interconnection or FIFO depth, the steady-state operand
values are wrong and the result diverges from the oracle.

Semantics (the reference's):
  * each FU ``s`` executes local timestep ``t`` (wall time ``t + s·c``);
  * a link ``u→f`` created from reuse ``(Δs, Δt)`` delivers ``u``'s operand
    of local time ``t − scalar(Δt)``; the value is *valid* only when the
    vector ``t_vec − Δt`` stays inside the canonical loop box (mixed-radix
    carries invalidate the shift — the data valid/invalid control signal of
    §III-C).  Invalid cycles are *boundary fills*: served through the
    data-distribution switch and counted in ``fills``;
  * output elements are committed by scatter-accumulation over the FU
    products; psum *routing* is checked structurally instead (every FU must
    reach an output data node through generated output links).

How the port computes it.  The reference steps cycle by cycle over every FU
in Python.  Here each FU's whole time column is one tensor row: the FUs are
resolved in the reference's BFS rank (a link-fed FU after its source), a
link-fed column is its source column shifted by ``t_scalar(Δt)`` with the
boundary fills gathered where the source time leaves ``R_T``, and a memory
or switch column is a gather from the tensor.  The counters are counts over
the same masks, so they equal the reference's.

Exactness.  Every flat tensor index is affine in the loop indices, so each
operand stream is one gather.  The committed sum reduces every output
element in one fixed order, the order of the iteration points in the loop
nest (:func:`commit`), whichever side produced the products — the oracle,
:func:`simulate` and ``rtlsim.simulate_rtl`` therefore agree bit for bit on
any values and on any device, and the oracle equals the reference's
``np.add.at`` (which adds in that order) bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .adg import ADG
from .workload import TensorAccess, Workload

__all__ = ["oracle", "simulate", "SimResult", "run_stages",
           "simulate_stages", "staged_oracle", "commit", "on_device",
           "time_vectors", "operand_streams"]

# points per chunk of the oracle's loop nest (bounds the (chunk, n_iter)
# index tensors; 28.9 M points of a ResNet-50 conv layer take 7 chunks)
ORACLE_CHUNK = 1 << 22


def on_device(inputs: dict) -> tuple[torch.device, dict[str, torch.Tensor]]:
    """The device the input tensors lie on, and the inputs in float64 (the
    reference's dtype) there; inputs on several devices are refused."""
    devs = {v.device for v in inputs.values()}
    if len(devs) > 1:
        raise ValueError(f"input tensors lie on several devices: {devs}")
    dev = devs.pop() if devs else torch.device("cpu")
    return dev, {k: v.to(torch.float64) for k, v in inputs.items()}


def _strides(shape) -> np.ndarray:
    st = np.ones(len(shape), dtype=np.int64)
    for k in range(len(shape) - 2, -1, -1):
        st[k] = st[k + 1] * int(shape[k + 1])
    return st


def _flat_coeffs(t: TensorAccess, shape) -> tuple[np.ndarray, int]:
    """Row-major flat index of ``t`` as ``w @ i + c0`` over the iteration
    vector ``i`` (exact: the data map is affine)."""
    st = _strides(shape)
    return st @ t.fmap.M, int(st @ t.fmap.b)


def _affine_rows(coef: np.ndarray, digits: torch.Tensor) -> torch.Tensor:
    """``digits @ coef`` in int64 as a broadcast multiply and a sum (CUDA's
    matrix products take no int64)."""
    w = torch.as_tensor(np.asarray(coef, dtype=np.int64), device=digits.device)
    return (digits * w).sum(-1)


def time_vectors(T: int, R_T, device) -> torch.Tensor:
    """All local timestep vectors 0..T-1 as mixed-radix digits, (T, n_T)."""
    R_T = [int(r) for r in R_T]
    out = torch.empty((T, len(R_T)), dtype=torch.int64, device=device)
    t = torch.arange(T, dtype=torch.int64, device=device)
    for k in range(len(R_T) - 1, -1, -1):
        out[:, k] = t % R_T[k]
        t = t // R_T[k]
    return out


def operand_streams(wl: Workload, df, inputs: dict, TV: torch.Tensor,
                    coords: np.ndarray) -> dict[str, torch.Tensor]:
    """Each input tensor's value at every (FU, local timestep), ``(n, T)``:
    ``arr.flat[a(t) + b(f)]`` with ``a`` and ``b`` the affine parts of the
    flat index in the timestep and the FU coordinate."""
    sizes = df.sizes()
    out = {}
    for t in wl.inputs:
        arr = inputs[t.name]
        w, c0 = _flat_coeffs(t, wl.tensor_shape(t, sizes))
        a = _affine_rows(w @ df.M_TI, TV)                        # (T,)
        b = torch.as_tensor(coords @ (w @ df.M_SI) + c0,
                            device=TV.device)                     # (n,)
        out[t.name] = arr.reshape(-1)[b[:, None] + a[None, :]]
    return out


def _points_of(wl: Workload, df, sizes, TV: torch.Tensor,
               coords: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(point index in the loop nest's row-major order, flat output index)
    of every (FU, local timestep), each ``(n, T)``."""
    dims_shape = [sizes[d] for d in wl.iter_dims]
    ps = _strides(dims_shape)
    w_out, c_out = _flat_coeffs(wl.output, wl.tensor_shape(wl.output, sizes))
    res = []
    for w, c0 in ((ps, 0), (w_out, c_out)):
        a = _affine_rows(w @ df.M_TI, TV)
        b = torch.as_tensor(coords @ (w @ df.M_SI) + c0, device=TV.device)
        res.append(b[:, None] + a[None, :])
    return res[0], res[1]


def commit(numel: int, out_idx: torch.Tensor, vals: torch.Tensor,
           key: torch.Tensor | None = None) -> torch.Tensor:
    """``np.add.at(zeros(numel), out_idx, vals)`` with one fixed order of
    addition per output element: the order of ``key`` (the iteration
    point's position in the loop nest), or the order given when ``key`` is
    None.  Each element is summed left to right starting from 0, as
    ``np.add.at`` does, so the result does not depend on the device or on
    the order the products arrive in.  The adds run one rank at a time: the
    ``j``-th term of every element in one indexed add whose indices are
    distinct, so no atomic decides an order."""
    out_idx = out_idx.reshape(-1)
    vals = vals.reshape(-1)
    if key is not None:
        perm = torch.sort(key.reshape(-1), stable=True).indices
        out_idx, vals = out_idx[perm], vals[perm]
    out = torch.zeros(numel, dtype=torch.float64, device=vals.device)
    if out_idx.numel() == 0:
        return out
    o_sorted, perm = torch.sort(out_idx, stable=True)
    v_sorted = vals[perm]
    counts = torch.bincount(o_sorted, minlength=numel)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(o_sorted.numel(), device=vals.device) - starts[o_sorted]
    rank_sorted, perm = torch.sort(rank, stable=True)
    o_by_rank, v_by_rank = o_sorted[perm], v_sorted[perm]
    per_rank = torch.bincount(rank_sorted).tolist()
    lo = 0
    for c in per_rank:
        idx = o_by_rank[lo:lo + c]
        out[idx] = out[idx] + v_by_rank[lo:lo + c]
        lo += c
    return out


def oracle(wl: Workload, sizes: dict[str, int], inputs: dict) -> torch.Tensor:
    """Reference semantics: full loop-nest evaluation, in chunks of points,
    on the device the inputs lie on."""
    dev, inputs = on_device(inputs)
    dims_shape = [sizes[d] for d in wl.iter_dims]
    N = int(np.prod(dims_shape, dtype=np.int64))
    coef = [(inputs[t.name].reshape(-1),
             *_flat_coeffs(t, wl.tensor_shape(t, sizes))) for t in wl.inputs]
    out_shape = wl.tensor_shape(wl.output, sizes)
    w_out, c_out = _flat_coeffs(wl.output, out_shape)
    vals = torch.empty(N, dtype=torch.float64, device=dev)
    oidx = torch.empty(N, dtype=torch.int64, device=dev)
    for lo in range(0, N, ORACLE_CHUNK):
        hi = min(N, lo + ORACLE_CHUNK)
        p = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        pts = torch.empty((hi - lo, len(dims_shape)), dtype=torch.int64,
                          device=dev)
        for k in range(len(dims_shape) - 1, -1, -1):
            pts[:, k] = p % dims_shape[k]
            p = p // dims_shape[k]
        v = None
        for flat, w, c0 in coef:
            x = flat[_affine_rows(w, pts) + c0]
            v = x if v is None else v * x
        vals[lo:hi] = v
        oidx[lo:hi] = _affine_rows(w_out, pts) + c_out
    numel = int(np.prod(out_shape, dtype=np.int64))
    return commit(numel, oidx, vals).reshape(out_shape)


@dataclass
class SimResult:
    output: torch.Tensor
    fills: dict[str, int]          # boundary fills per tensor (switch traffic)
    mem_reads: dict[str, int]      # data-node reads per tensor
    link_transfers: dict[str, int]
    cycles: int


def _bfs_order(fl: list, n: int) -> list[int]:
    """The reference's resolution order: memory/switch FUs first, then
    link-fed FUs in BFS rank from them."""
    rank = {f: 0 for f in range(n) if fl[f][0] != "link"}
    frontier = list(rank)
    while frontier:
        nxt = []
        for f in range(n):
            if f in rank or fl[f][0] != "link":
                continue
            u, _ = fl[f][1]
            if u in rank:
                rank[f] = rank[u] + 1
                nxt.append(f)
        if not nxt:
            break
        frontier = nxt
    unranked = [f for f in range(n) if f not in rank]
    if unranked:
        # fusion gives every dataflow an acyclic feed (chains are BFS trees,
        # delay feeds between chains are kept acyclic), so this is a bug
        raise ValueError(f"link feeders form a cycle through FUs "
                         f"{unranked[:8]}: no column order resolves them")
    return sorted(range(n), key=lambda f: rank.get(f, 0))


def shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` delayed by ``k`` steps along its last axis, zeros shifted in; a
    negative ``k`` reads the future, which a cycle loop has not written yet
    (zeros)."""
    if k == 0:
        return x
    out = torch.zeros_like(x)
    if 0 < k < x.shape[-1]:
        out[..., k:] = x[..., :-k]
    return out


def in_box(TV: torch.Tensor, dt, R_T) -> torch.Tensor:
    """Whether ``t_vec − Δt`` stays inside the loop box, per timestep."""
    tsrc = TV - torch.as_tensor(np.asarray(dt, dtype=np.int64),
                                device=TV.device)
    R = torch.as_tensor(np.asarray(R_T, dtype=np.int64), device=TV.device)
    return ((tsrc >= 0) & (tsrc < R)).all(dim=1)


def simulate(adg: ADG, df_name: str, inputs: dict) -> SimResult:
    spec = adg.spec(df_name)
    wl, df = spec.workload, spec.dataflow
    sizes = df.sizes()
    T = df.total_cycles
    n = df.n_fus
    coords = df.fu_coords()
    R_T = df.R_T
    dev, inputs = on_device(inputs)

    # --- structural check: every FU reaches an output data node -----------
    adg.check_output_path(df_name)
    feeders = adg.feeders(df_name)

    TV = time_vectors(T, R_T, dev)
    VAL = operand_streams(wl, df, inputs, TV, coords)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fills = {t.name: zero for t in wl.inputs}
    mem_reads = {t.name: 0 for t in wl.inputs}
    link_transfers = {t.name: zero for t in wl.inputs}

    H: dict[str, torch.Tensor] = {}
    for t in wl.inputs:
        tn = t.name
        fl = feeders[tn]
        h = torch.empty((n, T), dtype=torch.float64, device=dev)
        valid_of: dict[tuple, torch.Tensor] = {}
        n_switch = 0
        for f in _bfs_order(fl, n):
            kind, info = fl[f]
            if kind == "link":
                u, dt_vec = info
                key = tuple(int(x) for x in dt_vec)
                if key not in valid_of:
                    valid_of[key] = in_box(TV, key, R_T)
                valid = valid_of[key]
                src = shift_right(h[u], df.t_scalar(dt_vec))
                h[f] = torch.where(valid, src, VAL[tn][f])
                nv = valid.sum()
                link_transfers[tn] = link_transfers[tn] + nv
                fills[tn] = fills[tn] + (T - nv)
            else:
                h[f] = VAL[tn][f]
                if kind == "mem":
                    mem_reads[tn] += T
                else:
                    n_switch += 1
        fills[tn] = fills[tn] + n_switch * T
        H[tn] = h

    # products (in the inputs' order, as the reference's running product)
    # and the commit in loop-nest point order
    P = None
    for t in wl.inputs:
        P = H[t.name] if P is None else P * H[t.name]
    pidx, oidx = _points_of(wl, df, sizes, TV, coords)
    out_shape = wl.tensor_shape(wl.output, sizes)
    numel = int(np.prod(out_shape, dtype=np.int64))
    out = commit(numel, oidx, P, key=pidx).reshape(out_shape)

    cycles = T + int(np.max(coords @ df.c)) if n else T
    return SimResult(out, {k: int(v) for k, v in fills.items()}, mem_reads,
                     {k: int(v) for k, v in link_transfers.items()}, cycles)


# ---------------------------------------------------------------------------
# multi-workload staged execution (score-stationary fused attention)
# ---------------------------------------------------------------------------

def run_stages(adg: ADG, df_names, inputs, resident, ppu, stage_fn):
    """Shared stage runner (used by funcsim, the oracle, and rtlsim): run
    ``stage_fn(adg, df_name, stage_inputs)`` per stage, handing each
    ``resident``-mapped output tensor (through the optional element-wise
    ``ppu`` transform, which takes and returns a tensor) to later stages as
    an input.  Every stage input is shape-checked against that stage's
    dataflow extents, so a resident handover between disagreeing stage
    tilings fails loudly."""
    resident = dict(resident or {})
    for dst in resident.values():
        if dst in inputs:
            raise ValueError(
                f"input tensor {dst!r} is produced by a resident handover; "
                f"it must not be supplied externally")
    avail = dict(inputs)
    results = []
    for dfn in df_names:
        spec = adg.spec(dfn)
        stage_in = {}
        for t in spec.workload.inputs:
            if t.name not in avail:
                raise KeyError(
                    f"stage {dfn!r} needs tensor {t.name!r}: not an external "
                    f"input and not produced by an earlier resident stage")
            arr = avail[t.name]
            want = spec.workload.tensor_shape(t, spec.dataflow.sizes())
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"stage {dfn!r} tensor {t.name!r} has shape "
                    f"{tuple(arr.shape)}, dataflow expects {want} — stage "
                    f"dataflows must agree on the shared dims")
            stage_in[t.name] = arr
        res = stage_fn(adg, dfn, stage_in)
        results.append(res)
        dst = resident.get(spec.workload.output.name)
        if dst is not None:
            out = getattr(res, "output", res)
            avail[dst] = out if ppu is None else ppu(out)
    return results


def simulate_stages(adg: ADG, df_names: list[str], inputs: dict,
                    resident: dict[str, str] | None = None,
                    ppu=None) -> list[SimResult]:
    """Cycle-accurate multi-workload execution of one fused ADG.

    ``df_names`` are executed in order; ``resident`` maps a stage's output
    tensor to the input tensor it stays resident as for a later stage (the
    fused attention design uses ``{"S": "P"}`` — no HBM round trip for the
    score tensor), with ``ppu`` the optional element-wise PPU transform
    (softmax) applied at the handover.  Returns one :class:`SimResult` per
    stage.
    """
    return run_stages(adg, df_names, inputs, resident, ppu, simulate)


def staged_oracle(adg: ADG, df_names: list[str], inputs: dict,
                  resident: dict[str, str] | None = None,
                  ppu=None) -> list[torch.Tensor]:
    """Reference semantics of a staged schedule: the loop-nest
    :func:`oracle` per stage with the same resident-tensor handover —
    the two-stage oracle the netlist simulation is checked against."""

    def stage_fn(a: ADG, dfn: str, stage_in):
        spec = a.spec(dfn)
        return oracle(spec.workload, spec.dataflow.sizes(), stage_in)

    return run_stages(adg, df_names, inputs, resident, ppu, stage_fn)

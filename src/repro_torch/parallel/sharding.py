"""Divisibility-aware declarative sharding on a ``DeviceMesh`` (the
counterpart of ``repro.parallel.sharding``).

Logical axis names decouple model code from the physical mesh:

  * ``batch``  → ("pod", "data")      pure DP across pods, DP/FSDP within
  * ``fsdp``   → ("data",)            parameter/optimizer sharding
  * ``tensor`` → ("model",)           TP / EP
  * ``seq``    → ("data", "model")    sequence sharding for long context
  * ``expert`` → ("model",)           expert parallelism
  * ``none``   → replicated

:func:`logical_to_spec` resolves a tuple of logical names against a mesh,
*dropping* (a) axes not in the mesh (a single-pod mesh has no "pod") and
(b) axes whose size does not divide the dim, as the reference does.  The
rules read only the mesh's dim names and sizes (``mesh_dim_names`` and
``shape`` of a ``DeviceMesh``), so they are pure functions of (shape, mesh
shape).  A :class:`Spec` is the port's ``PartitionSpec``: one entry per
tensor dim, each ``None``, an axis name or a tuple of names.

:func:`placements` turns a spec into DTensor placements, one per *mesh*
dim.  A DTensor splits one tensor dim over two mesh dims only in mesh-dim
order (the first listed mesh dim major), which is what JAX's
``P(("data", "model"))`` means; every rule of :data:`PROFILES` lists its
axes in mesh order, and :func:`placements` asserts it.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

__all__ = ["PROFILES", "LOGICAL_RULES", "set_profile", "AxisNames", "Spec",
           "choose_axes", "logical_to_spec", "placements", "distribute",
           "with_constraint", "PARAM_RULES", "shard_params_spec",
           "distribute_tree", "mesh_axes", "is_sharded", "local_call",
           "sharded_region"]

PROFILES: dict[str, dict[str, tuple[str, ...]]] = {
    # Megatron-style: TP over "model", FSDP over "data", DP across pods.
    "tp": {
        "batch": ("pod", "data"),
        "fsdp": ("data",),
        "tensor": ("model",),
        "seq": ("data", "model"),
        "seq_model": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
        "none": (),
    },
    # ZeRO-3: batch over the whole mesh, params fully sharded, no TP.
    "fsdp": {
        "batch": ("pod", "data", "model"),
        "fsdp": ("data", "model"),
        "tensor": (),
        "seq": ("data", "model"),
        "seq_model": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
        "none": (),
    },
}

LOGICAL_RULES: dict[str, tuple[str, ...]] = dict(PROFILES["tp"])


def set_profile(name: str) -> None:
    """Switch the global sharding profile ("tp" | "fsdp")."""
    LOGICAL_RULES.clear()
    LOGICAL_RULES.update(PROFILES[name])


@dataclass(frozen=True)
class AxisNames:
    batch: tuple[str, ...] = ("pod", "data")
    fsdp: str = "data"
    tensor: str = "model"


class Spec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (that dim split over those axes, the first major).
    Immutable; equal, entry for entry, to the reference's
    ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def choose_axes(dim_size: int, logical: str, mesh) -> tuple[str, ...]:
    """Physical axes for one dim: greedily keep the rule's axes that exist
    in the mesh and whose running product divides ``dim_size``."""
    sizes = mesh_axes(mesh)
    chosen: list[str] = []
    prod = 1
    for ax in LOGICAL_RULES[logical]:
        if ax not in sizes:
            continue
        if dim_size % (prod * sizes[ax]) == 0:
            chosen.append(ax)
            prod *= sizes[ax]
    return tuple(chosen)


def logical_to_spec(logical_axes: tuple[str, ...], shape, mesh) -> Spec:
    """The :class:`Spec` of a tensor of ``shape`` whose dims carry
    ``logical_axes``.  An axis an earlier dim already took is dropped, and
    divisibility is checked again after that."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    entries = []
    for name, dim in zip(logical_axes, shape):
        axes = tuple(a for a in choose_axes(dim, name, mesh) if a not in used)
        prod = 1
        keep = []
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        if not keep:
            entries.append(None)
        elif len(keep) == 1:
            entries.append(keep[0])
        else:
            entries.append(tuple(keep))
    return Spec(*entries)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``: per mesh dim, ``Shard(d)`` where
    tensor dim ``d`` lists that axis, else ``Replicate()``.  A mesh dim of
    one device is ``Replicate()`` either way: its one shard is the whole
    dim, and a replicated DTensor keeps the very tensor it was given where
    a sharded one would hold a copy."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        # a DTensor shards one dim over several mesh dims major-first in
        # mesh order only (JAX's tuple is major-first in its own order)
        assert idx == sorted(idx), (spec, names)
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def is_sharded(mesh) -> bool:
    """Whether ``mesh`` spreads work over more than one device."""
    return mesh is not None and mesh.size() > 1


def distribute(t: torch.Tensor, mesh, logical: tuple[str, ...]):
    """``t`` (the same global tensor on every rank) as a DTensor laid out
    by ``logical`` (the reference's ``named_sharding``); each rank keeps
    its own shard without communicating."""
    spec = logical_to_spec(logical, tuple(t.shape), mesh)
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def distribute_tree(tree, specs, mesh):
    """The leaves of ``tree`` (the same on every rank) as DTensors laid out
    by the matching :class:`Spec` of ``specs``; each rank keeps its shard."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], mesh) for k in tree}
    if tree is None:
        return None
    return distribute_tensor(tree, mesh, placements(specs, mesh),
                             src_data_rank=None)


def with_constraint(x, mesh, logical_axes: tuple[str, ...]):
    """Lay ``x`` out by ``logical_axes`` (the reference's sharding
    constraint): nothing without a mesh or on one device; otherwise a
    DTensor is redistributed and a plain tensor (the same on every rank)
    distributed."""
    if not is_sharded(mesh):
        return x
    spec = logical_to_spec(logical_axes, tuple(x.shape), mesh)
    if isinstance(x, DTensor):
        want = placements(spec, mesh)
        return x if tuple(x.placements) == want else x.redistribute(
            mesh, want)
    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=None)


# ---------------------------------------------------------------------------
# parameter sharding rules (matched by param-path suffix)
# ---------------------------------------------------------------------------

# ordered (regex, logical axes for the trailing dims) — first match wins.
# Params are layer-stacked: a leading period dim is always replicated.
PARAM_RULES: list[tuple[str, tuple[str, ...]]] = [
    (r"embed/table", ("vocab", "fsdp")),
    (r"lm_head/w", ("fsdp", "vocab")),
    (r"(wq|wk|wv|wkv|in_proj|up|gate|w_up|w_gate|rkvwg|qkv)/w",
     ("fsdp", "tensor")),
    (r"(wo|down|w_down|out_proj)/w", ("tensor", "fsdp")),
    (r"experts/(w_up|w_gate)", ("expert", "fsdp", "tensor")),
    (r"experts/w_down", ("expert", "tensor", "fsdp")),
    (r"router/w", ("fsdp", "none")),
    (r"(conv1d)/w", ("none", "tensor")),
    (r"(A_log|dt_proj|x_proj|ssm_norm)/?.*", ("tensor", "none")),
    (r"(time_decay|time_first|u)$", ("none", "none")),
    (r".*(scale|bias|norm).*", ("none",)),
]


def _logical_for(path: str, ndim: int) -> tuple[str, ...]:
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            if len(logical) > ndim:
                logical = logical[-ndim:]
            pad = ("none",) * (ndim - len(logical))
            return pad + tuple(logical)
    return ("none",) * ndim


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, paths joined with ``/`` as the
    reference joins its pytree keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def shard_params_spec(params, mesh):
    """The :class:`Spec` tree of a parameter tree (path-rule matched)."""
    return _map_paths(lambda p, leaf: logical_to_spec(
        _logical_for(p, leaf.ndim), tuple(leaf.shape), mesh), params)


# ---------------------------------------------------------------------------
# running a per-device function on the local shards of DTensors
# ---------------------------------------------------------------------------

def _mesh_of(args):
    for a in args:
        if isinstance(a, DTensor):
            return a.device_mesh
    return None


def local_call(fn, args, roles, out_roles, free=("b", "c")):
    """``fn(*args)`` where ``fn`` is independent along the dims whose role
    is in ``free``; with DTensor arguments, on each device's shards.

    ``roles`` gives, per argument, one role per dim (``None`` for a dim
    ``fn`` needs whole); ``out_roles`` the same per output.  The first
    argument's layout decides: each mesh dim that shards one of its dims
    of a free role keeps sharding that role in every argument that has it
    (when every such dim divides), and every other mesh dim is gathered.
    The arguments are redistributed to that layout, ``fn`` runs on their
    local tensors, and the outputs are DTensors laid out the same way (all
    through DTensor's differentiable ``to_local``/``from_local``).  An
    argument without a role that the layout shards (a scan's A, say,
    beside a batch split over ``data``) gets, per device, the gradient of
    that device's part: a partial sum.  Without a DTensor argument,
    ``fn(*args)`` as it is."""
    mesh = _mesh_of(args)
    if mesh is None:
        return fn(*args)
    lead = args[0]
    lead_pl = (lead.placements if isinstance(lead, DTensor)
               else (Replicate(),) * mesh.ndim)
    role_of = []                       # per mesh dim: a role or None
    count: dict[str, int] = {}
    for i, pl in enumerate(lead_pl):
        r = roles[0][pl.dim] if isinstance(pl, Shard) else None
        if r in free:
            n = count.get(r, 1) * mesh.shape[i]
            if all(a.shape[rs.index(r)] % n == 0
                   for a, rs in zip(args, roles)
                   if isinstance(a, torch.Tensor) and r in rs):
                count[r] = n
            else:
                r = None
        else:
            r = None
        role_of.append(r)

    def layout(rs):
        return tuple(Shard(rs.index(r)) if r is not None and r in rs
                     else Replicate() for r in role_of)

    def grad_layout(rs):
        return tuple(Partial() if r is not None and r not in rs else pl
                     for r, pl in zip(role_of, layout(rs)))

    local = []
    for a, rs in zip(args, roles):
        if not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        want = layout(rs)
        if isinstance(a, DTensor):
            a = a if tuple(a.placements) == want else a.redistribute(
                mesh, want)
        else:
            a = distribute_tensor(a, mesh, want, src_data_rank=None)
        local.append(a.to_local(grad_placements=grad_layout(rs)))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(DTensor.from_local(o, mesh, layout(rs), run_check=False)
                    for o, rs in zip(outs, out_roles))
    return wrapped[0] if single else wrapped


# ---------------------------------------------------------------------------
# the sharded region: plain tensors as replicated, and GSPMD's fallback
# ---------------------------------------------------------------------------

def _no_strategy(err: Exception) -> bool:
    msg = str(err)
    return ("sharding strategy" in msg or "Sharding propagation failed" in msg
            or "in-place operations that require placement changes" in msg)


def _not_viewable(err: Exception) -> bool:
    return "view size is not compatible" in str(err)


def _replicated(a):
    if isinstance(a, DTensor):
        return a.redistribute(a.device_mesh,
                              (Replicate(),) * a.device_mesh.ndim)
    return a


class _ReplicateFallback(TorchDispatchMode):
    """An op on DTensors that DTensor has no sharding strategy for runs on
    replicated copies of its arguments, which is what GSPMD does for an op
    it cannot partition; an argument the op writes is then written back
    in its own layout."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (NotImplementedError, RuntimeError) as e:
            if func is torch.ops.aten.view.default and _not_viewable(e):
                # the DTensor's strides admit a view that its local
                # tensor's do not (a backward's reshape of a transposed
                # gradient): view a contiguous copy, as reshape would
                a = args[0]
                a = DTensor.from_local(a.to_local().contiguous(),
                                       a.device_mesh, a.placements,
                                       run_check=False, shape=a.shape,
                                       stride=a.stride())
                return func(a, *args[1:], **kwargs)
            if not _no_strategy(e):
                raise
        r_args = tree_map(_replicated, args)
        r_kwargs = tree_map(_replicated, kwargs)
        out = func(*r_args, **r_kwargs)
        written = None
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            orig = args[i] if i < len(args) else kwargs[arg.name]
            new = r_args[i] if i < len(args) else r_kwargs[arg.name]
            orig.copy_(new.redistribute(orig.device_mesh, orig.placements))
            written = orig if written is None else written
        return written if written is not None else out


_ACTIVE: list = []


@contextlib.contextmanager
def sharded_region(mesh):
    """Where the model runs on DTensors over ``mesh``: a plain tensor in
    an op with DTensors counts as replicated (positions, masks and zeros
    made inside the model), and an op DTensor has no strategy for runs
    replicated (:class:`_ReplicateFallback`).  Nothing without a mesh;
    inside a region already entered, nothing more."""
    if mesh is None or _ACTIVE:
        yield _ACTIVE[-1] if _ACTIVE else None
        return
    fb = _ReplicateFallback()
    _ACTIVE.append(fb)
    try:
        with implicit_replication(), fb:
            yield fb
    finally:
        _ACTIVE.pop()

"""Per-device operation counts of one traced step, the port's stand-in for
``repro.launch.hloparse``: torch emits no HLO, so the step is run once on
fake tensors (``FakeTensorMode``) over DTensors and its operations are
counted as they are dispatched.

:class:`OpCounter` is a ``TorchDispatchMode`` that gives way to DTensor
(it returns ``NotImplemented`` for an op on DTensors), so it sees what
each device runs: the local op on the local shard, and the
``_c10d_functional`` collectives DTensor issues to redistribute.  Every
count is therefore **per device**; multiply by the mesh's size for a
global figure.  (``FlopCounterMode`` over the same DTensor step reads the
*global* FLOPs of the unsharded program, since it sees each op before
DTensor splits it; ``tests/test_torch_launch.py`` holds the two apart on
a sharded product.)  DTensor's sharding propagation also runs ops, on
fake tensors of the global shapes, to learn output shapes; those are not
the device's work and are not counted.

- FLOPs: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``: mm, bmm, addmm, baddbmm, attention, convolution)
  on the local operands.
- Bytes: each op is one kernel in eager PyTorch, so an op reads its
  inputs and writes its outputs; views and allocations move nothing.  An
  op that writes one of its inputs in place is charged its other inputs
  and the update it writes (and, when it reads the whole input it
  writes, that input): ``index_copy_``, ``index_put_`` and ``scatter``
  count the rows written, as ``hloparse`` charges a dynamic-update-slice.
  Unlike XLA's fused programs, elementwise chains are not fused here, so
  this is the traffic of the port's plain path.
- Collectives: per-device wire bytes by the reference's ring formulas on
  the op's result size s and group size g: all-reduce 2·s·(g−1)/g,
  all-gather s·(g−1)/g, reduce-scatter s·(g−1), all-to-all s·(g−1)/g.
- Memory: the bytes of the tensors the step allocates that are alive at
  once, tracked by each new storage's lifetime; the peak, and what is
  alive at the end.  The step's arguments (parameters, state, batch) are
  the caller's to add.
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCounts", "OpCounter", "wire_bytes", "tensor_bytes",
           "local_bytes"]

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

# ops that move no data: aliases and allocations
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "lift_fresh", "wait_tensor", "_to_copy_alias",
         "detach", "alias", "set_", "resize_", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size", "device", "_unsafe_view", "_reshape_alias"}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Per-device wire bytes of one collective (the reference's formulas,
    ``repro/launch/roofline.py``): all-reduce 2·s·(g−1)/g, all-gather and
    all-to-all s·(g−1)/g, reduce-scatter s·(g−1), permute s."""
    g = max(1, group)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    return float(result_bytes)


@dataclass
class OpCounts:
    """What one device runs in the traced step."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    coll_counts: dict = field(
        default_factory=lambda: {k: 0 for k in COLL_KINDS})
    n_ops: int = 0
    peak_live_bytes: int = 0
    end_live_bytes: int = 0
    top_flops: list = field(default_factory=list)   # (flops, op), summed
    top_bytes: list = field(default_factory=list)

    @property
    def coll_bytes_total(self) -> float:
        return sum(self.coll_bytes.values())


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _written(func) -> list[int]:
    """Indices of the arguments the op writes (in place or ``out=``)."""
    return [i for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write]


@contextlib.contextmanager
def _strided_offsets_outside_fake():
    """DTensor finds a strided shard's offsets (a dim split over two mesh
    dims and then flattened, as a matmul flattens (B, T, d)) by listing the
    values of an index tensor it builds; under ``FakeTensorMode`` that
    tensor would be fake and hold no values, so it is built outside."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    memo: dict = {}

    def outside(*args, **kwargs):
        # a pure function of (placement, size, chunks, rank, mode), called
        # for every such op: its index tensor spans the whole dim
        key = (args, tuple(sorted(kwargs.items())))
        if key not in memo:
            with unset_fake_temporarily():
                memo[key] = orig(*args, **kwargs)
        return memo[key]

    cls.local_shard_size_and_offset = outside
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


class OpCounter(TorchDispatchMode):
    """Counts, per device, the ops dispatched while it is active (see the
    module's docstring).  Use as a context manager; ``counts`` holds the
    totals."""

    def __init__(self):
        super().__init__()
        self.counts = OpCounts()
        self._live = 0
        self._seen: set[int] = set()
        self._by_flops: dict[str, float] = {}
        self._by_bytes: dict[str, float] = {}
        self._prop_depth = 0

    # DTensor's sharding propagation runs the op on global-shape fake
    # tensors to learn its output; that is no device's work
    @contextlib.contextmanager
    def _skip_propagation(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def wrapped(prop, op_schema):
            counter._prop_depth += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._prop_depth -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        try:
            yield
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = orig

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._skip_propagation())
        self._stack.enter_context(_strided_offsets_outside_fake())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()
            c = self.counts
            c.end_live_bytes = self._live
            c.top_flops = sorted(((v, k) for k, v in self._by_flops.items()),
                                 reverse=True)[:8]
            c.top_bytes = sorted(((v, k) for k, v in self._by_bytes.items()),
                                 reverse=True)[:8]

    def _track(self, out) -> None:
        """Charge the new storages among ``out`` to the live bytes until
        they are freed."""
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self._live += n
            self.counts.peak_live_bytes = max(self.counts.peak_live_bytes,
                                              self._live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._prop_depth:
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        c = self.counts
        c.n_ops += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind = _KIND.get(name)
            if kind is None:
                return
            if name.startswith("all_reduce"):
                group = _group_size(args[-1])
            else:
                group = int(args[-2]) if name != "all_to_all_single" \
                    else _group_size(args[-1])
            res = sum(tensor_bytes(t) for t in tree_flatten(out)[0]
                      if isinstance(t, torch.Tensor))
            c.coll_bytes[kind] += wire_bytes(kind, res, group)
            c.coll_counts[kind] += 1
            self._track(out)
            return
        if func.is_view or name in _FREE:
            return
        key = str(func.overloadpacket)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            self._by_flops[key] = self._by_flops.get(key, 0.0) + f
        tensors = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        written = _written(func)
        if written:
            dst = [args[i] if i < len(args)
                   else kwargs.get(func._schema.arguments[i].name)
                   for i in written]
            dst = [t for t in dst if isinstance(t, torch.Tensor)]
            ids = {id(t) for t in dst}
            rest = [t for t in tensors if id(t) not in ids]
            read = sum(tensor_bytes(t) for t in rest)
            big = max((t.numel() for t in rest), default=0)
            upd = sum(min(t.numel(), big or t.numel()) * t.element_size()
                      for t in dst)
            whole = sum(tensor_bytes(t) for t in dst     # read as well
                        if (not rest or big >= t.numel())
                        and name != "copy_")
            b = read + upd + whole
        else:
            b = (sum(tensor_bytes(t) for t in tensors)
                 + sum(tensor_bytes(t) for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)))
            self._track(out)
        c.bytes += b
        self._by_bytes[key] = self._by_bytes.get(key, 0.0) + b


def local_bytes(tree) -> int:
    """The bytes one device holds of the tensors in ``tree`` (a DTensor's
    local shard, a plain tensor whole)."""
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            total += tensor_bytes(t._local_tensor)
        elif isinstance(t, torch.Tensor):
            total += tensor_bytes(t)
    return total

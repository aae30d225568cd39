"""Batched serving: teacher-forced prefill + greedy decode, with the KV
caches and recurrent states sharded on a ``DeviceMesh`` when one is given
(``repro.serve.engine``'s counterpart).

Cache sharding is declarative, as in the reference:

    KV cache (periods, B, Hkv, S, hd)
        → ("none", "batch", "tensor", "seq", "none")

with the divisibility fallback: kv heads that do not divide the model axis
fall back to a sequence-sharded cache (each device holds an S/|model|
slab, written in place where the position falls, and gathered for the
attention).

The reference compiles its step once, ``jax.jit(step,
donate_argnums=(1,))``, and dispatches a whole step at a time.  Here, on a
card, :func:`build_serve_step` captures one decode step in a CUDA graph and
replays it, so the host issues one graph a step instead of every operation
of every layer; the graph writes the caller's state in place, the port's
counterpart of donating it.  On the CPU the step stays eager, chosen by the
token's device alone.

The decode position lives in a 0-d int32 tensor on the device and is
advanced there, so neither the kernels nor the graph make the host wait on
the device between steps.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch

from torch.distributed.tensor import DTensor

from ..kernels import ops
from ..models import encdec as ED
from ..models import transformer as TF
from ..models.common import ModelConfig
from ..parallel.sharding import (distribute_tree, logical_to_spec,
                                 shard_params_spec)

__all__ = ["ServeConfig", "CapturedStep", "build_serve_step", "generate",
           "state_sharding_spec"]


@dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_len: int
    temperature: float = 0.0


_STATE_LOGICAL = {
    ("k",): ("none", "batch", "tensor", "seq", "none"),
    ("v",): ("none", "batch", "tensor", "seq", "none"),
    ("conv",): ("none", "batch", "none", "tensor"),
    ("ssm",): ("none", "batch", "tensor", "none"),
    ("wkv",): ("none", "batch", "tensor", "none", "none"),
    ("tshift",): ("none", "batch", "none"),
    ("cshift",): ("none", "batch", "none"),
}


def _state_logical(name, ndim: int) -> tuple[str, ...]:
    logical = _STATE_LOGICAL.get((name,), ("none",) * ndim)
    if len(logical) != ndim:
        logical = (("none",) * (ndim - len(logical)) + tuple(logical))
        logical = logical[-ndim:]
    return logical


def _map_named(fn, tree, name=None):
    """``fn(leaf's key, leaf)`` over a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def state_sharding_spec(state, mesh):
    """The :class:`~repro_torch.parallel.sharding.Spec` tree of a decode
    state (its leaves or their shapes)."""
    return _map_named(lambda n, t: logical_to_spec(
        _state_logical(n, t.ndim), tuple(t.shape), mesh), state)


def _local_tree(tree):
    """Each DTensor leaf's local tensor (the very tensor it holds)."""
    if isinstance(tree, dict):
        return {k: _local_tree(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        with torch.no_grad():
            return tree.to_local()
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _spec(t) -> tuple:
    """What a copy into a static buffer needs to be the same."""
    if isinstance(t, torch.Tensor):
        return (t.shape, t.dtype, t.device)
    return (type(t),)


class CapturedStep:
    """``step(params, state, token, pos[, enc_out])`` → (logits, state),
    captured in a CUDA graph on a card and replayed.

    - A CPU token runs the eager step, as every op there does.
    - On a card, the first call (and any call whose params or state leaves
      are not the tensors captured, or whose inputs differ in shape, dtype
      or device) runs the eager step on a side stream for its own result
      (building the kernels, loading their libraries and cuBLAS's handles)
      and then captures one step in a new graph, dropping the old one.  The
      graph reads the params and reads and writes the state's leaves where
      they lie; ``token`` (B,), ``pos`` (0-d int32, or an int) and
      ``enc_out`` are copied into static buffers that it reads.
    - Later calls copy the inputs into those buffers, replay the graph and
      return a clone of its logits (a tensor of the caller's, not the
      buffer the next replay overwrites) and the state.
    - The launch counters of :mod:`repro_torch.kernels.ops` count replays:
      what the capture counted is taken back and added on each replay.

    A capture or replay that fails raises; nothing falls back to eager.
    ``captures`` and ``replays`` count both.

    ``local``: the params and state come as DTensors over a one-device
    mesh, and the step runs (and is captured) on their local tensors,
    which are the whole tensors.  ``eager``: never captured (a step on
    DTensors over several devices, which runs eagerly)."""

    def __init__(self, eager, local: bool = False, captured: bool = True):
        self._eager = eager
        self._local = local
        self._captured = captured
        self._graph = None
        self.captures = 0
        self.replays = 0

    def __call__(self, params, state, token, pos, *extra):
        if self._local:
            logits, _ = self._call(_local_tree(params), _local_tree(state),
                                   token, pos, *extra)
            return logits, state
        return self._call(params, state, token, pos, *extra)

    def _call(self, params, state, token, pos, *extra):
        if token.device.type == "cpu" or not self._captured:
            return self._eager(params, state, token, pos, *extra)
        bound = list(_leaves(params)) + list(_leaves(state))
        inputs = tuple(_spec(t) for t in (token, pos, *extra))
        if not self._holds(bound, inputs):
            return self._capture(params, state, token, pos, extra, bound,
                                 inputs)
        for static, new in zip(self._static, (token, pos, *extra)):
            if isinstance(new, torch.Tensor):
                static.copy_(new)
            else:
                static.fill_(new)
        self._graph.replay()
        ops.add_launch_counts(self._launches)
        self.replays += 1
        return self._logits.clone(), state

    def _holds(self, bound, inputs) -> bool:
        """Whether the graph was captured over these very tensors, where
        they lie now, and inputs of these shapes."""
        if self._graph is None or inputs != self._inputs \
                or len(bound) != len(self._bound):
            return False
        return all(ref() is t and lay == (t.data_ptr(), t.shape, t.stride(),
                                          t.dtype)
                   for (ref, lay), t in zip(self._bound, bound))

    def _capture(self, params, state, token, pos, extra, bound, inputs):
        dev = token.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            logits, state = self._eager(params, state, token, pos, *extra)
        cur.wait_stream(side)
        logits.record_stream(cur)

        self._graph = self._logits = self._static = None
        static = [torch.empty_like(token,
                                   memory_format=torch.contiguous_format),
                  torch.empty_like(pos) if isinstance(pos, torch.Tensor)
                  else torch.zeros((), dtype=torch.int32, device=dev),
                  *(torch.empty_like(e) for e in extra)]
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(graph):
            out, _ = self._eager(params, state, *static)
        launches = tuple(a - b for a, b in zip(ops.launch_counts(), before))
        ops.add_launch_counts([-n for n in launches])

        self._graph, self._logits, self._static = graph, out, static
        self._launches, self._inputs = launches, inputs
        self._bound = [(weakref.ref(t), (t.data_ptr(), t.shape, t.stride(),
                                         t.dtype)) for t in bound]
        self.captures += 1
        return logits, state


def build_serve_step(cfg: ModelConfig, backend: str = "kernel", mesh=None):
    """Returns the one-token step → (next-token logits, state):
    ``step(params, state, token, pos)`` for a decoder LM (the step of
    :func:`generate`), ``step(params, state, token, pos, enc_out)`` for an
    encoder-decoder model, ``enc_out`` from ``encdec.encode``.  A
    :class:`CapturedStep`: replayed from a CUDA graph on a card, eager on
    the CPU; the state is updated in place, and the logits returned are
    the caller's to keep.

    With a ``mesh`` the step has ``jit_with(params, state)``, the twin of
    the reference's: it lays the params out by ``shard_params_spec`` and
    the state by :func:`state_sharding_spec` (DTensors; each rank keeps
    its shards) and returns (step, params, state), the step laying the
    token (and ``enc_out``) out on ``batch``.  On a one-device mesh that
    step runs and is captured on the DTensors' local tensors (the whole
    tensors; the reference's constraints are no-ops there and its MoE
    dispatch computes the same); over several devices it runs on the
    DTensors, eagerly."""

    def make(m):
        if cfg.is_encoder_decoder:
            def step(params, state, token, pos, enc_out):
                return ED.decode_step_encdec(params, state, token, pos,
                                             enc_out, cfg, backend, m)
        else:
            def step(params, state, token, pos):
                return TF.decode_step(params, state, token, pos, cfg,
                                      backend, m)
        return step

    captured = CapturedStep(make(None))
    if mesh is None:
        return captured

    def jit_with(params, state):
        dparams = distribute_tree(params, shard_params_spec(params, mesh),
                                  mesh)
        dstate = distribute_tree(state, state_sharding_spec(state, mesh),
                                 mesh)
        if mesh.size() == 1:
            return CapturedStep(make(None), local=True), dparams, dstate
        return CapturedStep(make(mesh), captured=False), dparams, dstate

    captured.jit_with = jit_with
    return captured


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, max_new: int,
             backend: str = "kernel", mesh=None) -> torch.Tensor:
    """Greedy batched generation (decoder-only models).
    prompts (B, Tp) int32 → (B, Tp + max_new), on the prompts' device.
    Every step, the teacher-forced prompt's and the new tokens', goes
    through one :func:`build_serve_step` step: on a card its first call
    runs eagerly and captures the graph, the others replay it.  With a
    ``mesh``, the params (the same on every rank) and the state are laid
    out by the step's ``jit_with`` first."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"generate serves decoder-only models; drive "
                         f"{cfg.name} through build_serve_step with the "
                         "encoder's output")
    Bsz, Tp = prompts.shape
    state = TF.init_decode_state(cfg, Bsz, Tp + max_new,
                                 device=prompts.device)
    step = build_serve_step(cfg, backend, mesh)
    if mesh is not None:
        step, params, state = step.jit_with(params, state)
    pos = torch.zeros((), dtype=torch.int32, device=prompts.device)

    def greedy(logits):
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        return logits.argmax(-1).to(torch.int32)

    # teacher-forced prefill through the decode path (exact, cache-filling)
    logits = None
    for t in range(Tp):
        logits, state = step(params, state, prompts[:, t], pos)
        pos += 1

    out = [prompts]
    tok = greedy(logits)
    for i in range(max_new):
        out.append(tok[:, None])
        if i == max_new - 1:
            break
        logits, state = step(params, state, tok, pos)
        pos += 1
        tok = greedy(logits)
    return torch.cat(out, dim=1)

"""(architecture × input-shape) dry-run cells (the counterpart of
``repro.launch.cells``).

A cell is a step (train, prefill or decode), its inputs and a mesh; no
memory is allocated anywhere.  The parameters and states come from the
port's initializers under ``FakeTensorMode`` (the twin of
``jax.eval_shape``), laid out on the mesh as DTensors by the sharding
rules, and the batch is fake too.  ``Cell.trace()`` (the twin of
``lower()``) runs the step once under the same fake mode and an
:class:`~repro_torch.launch.opcount.OpCounter`: tensors that are not on a
card take the plain path, as the reference's dry run lowers with its
``"ref"`` kernels.

Assigned shapes (LM family, applied to all 10 archs):
  train_4k     seq 4096   global_batch 256   → train step
  prefill_32k  seq 32768  global_batch 32    → prefill (forward, no grad)
  decode_32k   seq 32768  global_batch 128   → serve step (1 token, full KV)
  long_500k    seq 524288 global_batch 1     → serve step; SSM/hybrid only

Modality stubs: phi-3-vision gets 576 precomputed patch embeddings inside
the 4096-token budget; whisper gets 1500 precomputed encoder frame
embeddings and decodes against the assigned sequence lengths mechanically.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCH_IDS, get_config
from ..models import encdec as ED
from ..models import transformer as TF
from ..models.common import ModelConfig
from ..parallel.sharding import (distribute, distribute_tree,
                                 shard_params_spec)
from ..serve.engine import ServeConfig, build_serve_step
from ..train.step import build_train_step, make_train_state
from .opcount import OpCounter, local_bytes

__all__ = ["SHAPES", "LONG_OK", "cell_is_applicable", "build_cell",
           "all_cells", "Cell"]

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid families
LONG_OK = {"jamba_1_5_large_398b", "rwkv6_7b"}


def cell_is_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, ("pure full-attention (or modality-inapplicable) arch; "
                       "524k decode assigned to SSM/hybrid families only")
    return True, ""


def _batch(cfg: ModelConfig, B: int, T: int, mesh) -> dict:
    """The fake global batch laid out on ``batch`` (the reference's
    ``_batch_shapes`` with its shardings)."""
    n = T - cfg.prefix_len
    batch = {"tokens": torch.zeros((B, n), dtype=torch.int32),
             "labels": torch.zeros((B, n), dtype=torch.int32)}
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.zeros((B, cfg.prefix_len,
                                              cfg.d_model))
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.zeros((B, cfg.enc_seq_len, cfg.d_model))
    return {k: distribute(v, mesh, ("batch",) + ("none",) * (v.ndim - 1))
            for k, v in batch.items()}


@dataclass
class Cell:
    arch: str
    shape: str
    fn: object           # the step, called as fn(*args)
    args: tuple
    cfg: ModelConfig
    fake: FakeTensorMode
    grad: bool           # whether the step records gradients

    def trace(self) -> dict:
        """One call of the step on the fake tensors, counted.  Returns
        {"counts": OpCounts (per device), "argument_bytes": what one
        device holds of the arguments}."""
        with self.fake, torch.set_grad_enabled(self.grad), \
                OpCounter() as oc:
            out = self.fn(*self.args)
            del out
        return {"counts": oc.counts,
                "argument_bytes": local_bytes(self.args)}


def _init(cfg: ModelConfig):
    init = ED.init_params_encdec if cfg.is_encoder_decoder else TF.init_params
    return init(cfg, torch.Generator().manual_seed(0), "cpu")


def build_cell(arch: str, shape: str, mesh, *, opt_dtype=None,
               compress_grads: bool = False, accum_steps: int = 1,
               reduced: bool = False) -> Cell:
    """``reduced`` takes the config's smoke size (for tests; the shapes
    stay the assigned ones)."""
    ok, why = cell_is_applicable(arch, shape)
    assert ok, f"{arch}×{shape} skipped: {why}"
    cfg = get_config(arch, reduced=reduced)
    info = SHAPES[shape]
    B, T, kind = info["global_batch"], info["seq_len"], info["kind"]
    fake = FakeTensorMode()

    with fake:
        if kind == "train":
            # bf16 optimizer moments for the 398B config: fp32 moments
            # alone are 3.2 TB, 12.4 GB a device at 256-way sharding
            odt = opt_dtype or (torch.bfloat16 if cfg.n_params() > 1e11
                                else torch.float32)
            state = make_train_state(cfg, torch.Generator().manual_seed(0),
                                     "cpu", compress_grads, odt)
            step = build_train_step(cfg, mesh, accum_steps=accum_steps,
                                    compress_grads=compress_grads)
            step, state = step.jit_with(state)
            return Cell(arch, shape, step, (state, _batch(cfg, B, T, mesh)),
                        cfg, fake, True)

        params = _init(cfg)
        if kind == "prefill":
            params = distribute_tree(params, shard_params_spec(params, mesh),
                                     mesh)
            batch = _batch(cfg, B, T, mesh)
            if cfg.is_encoder_decoder:
                def prefill(params, tokens, enc_embeds):
                    return ED.forward_encdec(params, tokens, enc_embeds, cfg,
                                             "ref", mesh)
                args = (params, batch["tokens"], batch["enc_embeds"])
            elif cfg.prefix_len:
                def prefill(params, tokens, prefix):
                    return TF.forward(params, tokens, cfg, prefix, "ref",
                                      mesh)[0]
                args = (params, batch["tokens"], batch["prefix_embeds"])
            else:
                def prefill(params, tokens):
                    return TF.forward(params, tokens, cfg, backend="ref",
                                      mesh=mesh)[0]
                args = (params, batch["tokens"])
            return Cell(arch, shape, prefill, args, cfg, fake, False)

        # decode
        sc = ServeConfig(batch=B, max_len=T)
        if cfg.is_encoder_decoder:
            state = ED.init_decode_state_encdec(cfg, sc.batch, sc.max_len,
                                                "cpu")
        else:
            state = TF.init_decode_state(cfg, sc.batch, sc.max_len, "cpu")
        step, params, state = build_serve_step(cfg, "ref", mesh).jit_with(
            params, state)
        token = distribute(torch.zeros((B,), dtype=torch.int32), mesh,
                           ("batch",))
        pos = torch.zeros((), dtype=torch.int32)
        args = (params, state, token, pos)
        if cfg.is_encoder_decoder:
            args += (distribute(torch.zeros((B, cfg.enc_seq_len,
                                             cfg.d_model),
                                            dtype=cfg.torch_dtype),
                                mesh, ("batch", "none", "none")),)
        return Cell(arch, shape, step, args, cfg, fake, False)


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]

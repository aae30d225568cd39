"""How the sharded train step divides its products among the devices of a
small fake mesh (pod 2 x data 2 x model 4, PyTorch's "fake" process group),
counted per device with ``repro_torch.launch.opcount``: one forward and
backward of the loss, against the same step unsharded.

- The attention's products (every ``bmm``: self-, cross- and encoder
  attention) and the logits' products (the ``mm``s with the vocabulary as a
  dim, forward and backward) each read 1/16 of the whole a device, where
  the vocabulary (509) and the kv heads do not divide ``model``.
- With kv heads that do not divide ``model`` but q heads that do, each
  device holds its q heads and their kv head, as GSPMD lays out the
  reference's attention (each of its devices holds 2 of Mistral-NeMo's 32
  q heads on the 16 x 16 mesh); the kv heads are repeated to make the
  split whole."""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import get_config
from repro_torch.launch.mesh import fake_group, shape_mesh
from repro_torch.launch.opcount import OpCounter
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.parallel.sharding import (distribute, distribute_tree,
                                           shard_params_spec)
from repro_torch.train.step import loss_and_grads

MESH = ((2, 2, 4), ("pod", "data", "model"))
DEVICES = 16
VOCAB = 509          # prime: no mesh dim divides it


class _Products(OpCounter):
    """An OpCounter that also sums the attention's products (``bmm``) and
    the logits' (an ``mm`` with a ``vocab``-wide dim), and records the
    local shapes of the attention's products."""

    def __init__(self, vocab):
        super().__init__()
        self.vocab, self.attn, self.logits = vocab, 0.0, 0.0
        self.attn_shapes = set()

    def _count(self, func, args, kwargs, out):
        before = self.counts.flops
        super()._count(func, args, kwargs, out)
        f = self.counts.flops - before
        if not f:
            return
        shapes = [tuple(t.shape) for t in tree_flatten(args)[0]
                  if isinstance(t, torch.Tensor)]
        if str(func.overloadpacket) == "aten.bmm":
            self.attn += f
            self.attn_shapes.add(tuple(shapes))
        elif any(self.vocab in s for s in shapes):
            self.logits += f


def _count(cfg, B, T, mesh=None) -> _Products:
    fake = FakeTensorMode()
    with fake:
        init = (ED.init_params_encdec if cfg.is_encoder_decoder
                else TF.init_params)
        params = init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.zeros((B, T), dtype=torch.int32),
                 "labels": torch.zeros((B, T), dtype=torch.int32)}
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = torch.zeros((B, cfg.enc_seq_len,
                                               cfg.d_model))
        if mesh is not None:
            params = distribute_tree(params, shard_params_spec(params, mesh),
                                     mesh)
            batch = {k: distribute(v, mesh, ("batch",)
                                   + ("none",) * (v.ndim - 1))
                     for k, v in batch.items()}
    with fake, _Products(cfg.vocab_size) as oc:
        loss_and_grads(cfg, params, batch, mesh=mesh)
    return oc


def _per_device_and_whole(cfg, B, T):
    whole = _count(cfg, B, T)
    with fake_group(DEVICES):
        per = _count(cfg, B, T, shape_mesh(*MESH))
    return per, whole


@pytest.mark.parametrize("arch,over", [
    # Whisper: the encoder's, the decoder's and the cross-attention, with
    # heads (2) that do not divide model (4), as Whisper-base's 8 do not
    # divide 16
    ("whisper_base", dict(n_heads=2, n_kv_heads=2)),
    # a decoder LM whose kv heads (2) do not divide model (4)
    ("mistral_nemo_12b", dict(n_heads=8, n_kv_heads=2)),
])
def test_attention_and_logits_products_split_over_every_device(arch, over):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              vocab_size=VOCAB, dtype="float32", **over)
    per, whole = _per_device_and_whole(cfg, B=16, T=32)
    assert whole.attn > 0 and whole.logits > 0
    assert per.attn * DEVICES == pytest.approx(whole.attn, rel=1e-9)
    assert per.logits * DEVICES == pytest.approx(whole.logits, rel=1e-9)


def test_kv_heads_follow_their_q_heads_over_model():
    """8 q heads and 2 kv heads over model = 4: each device runs 2 q heads
    against their one kv head (GQA group 2 locally), its batch rows split
    over pod and data; no device runs all 8 heads."""
    cfg = dataclasses.replace(get_config("mistral_nemo_12b", reduced=True),
                              vocab_size=VOCAB, dtype="float32", n_heads=8,
                              n_kv_heads=2)
    with fake_group(DEVICES):
        per = _count(cfg, 16, 32, shape_mesh(*MESH))
    B_loc, T, hd = 16 // 4, 32, cfg.hd
    # attention_ref's score product: (B_loc * Hkv_loc, G_loc * T, hd) @
    # (B_loc * Hkv_loc, hd, T), Hkv_loc = 1 and G_loc = 2
    assert ((B_loc, 2 * T, hd), (B_loc, hd, T)) in per.attn_shapes, \
        per.attn_shapes


def test_rwkv6_products_split_over_every_device():
    """RWKV-6's products (time mix, channel mix, head) a device: 1/16 of
    the unsharded step's, its channel mix included (the token shift's
    local op leaves no mesh dim repeating the work: torch 2.11 ran one
    layer's channel mix on every device of model before)."""
    cfg = dataclasses.replace(get_config("rwkv6_7b", reduced=True),
                              vocab_size=VOCAB, dtype="float32")
    per, whole = _per_device_and_whole(cfg, B=16, T=32)
    assert whole.counts.flops > 0
    assert per.counts.flops * DEVICES == pytest.approx(whole.counts.flops,
                                                       rel=1e-9)

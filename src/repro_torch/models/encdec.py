"""The encoder-decoder of the port (Whisper-style), the counterpart of
``repro.models.encdec``.

The conv front end is a stub, as in the reference: ``enc_embeds`` arrive
as precomputed frame embeddings (B, T_enc, d).  Encoder = non-causal
attention blocks (no RoPE, no softcap) + FFN; decoder = causal
self-attention with RoPE + cross-attention over the encoder output (no
RoPE) + FFN.  Both attentions that are not causal go through
``ops.flash_attention(..., causal=False)``: on a card the prefill kernel,
which masks the ragged 1500-frame key range itself.  Layers are stacked
over their count (``enc`` over ``n_enc_layers``, ``dec`` over
``n_layers``) with the reference's keys and shapes, so
:func:`repro_torch.convert.params_from_jax` maps one tree onto the other.
Logits are in the model dtype, as the reference returns them.  ``mesh``
runs the model on DTensors over it, as in
:mod:`repro_torch.models.transformer`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..kernels import ops
from ..kernels import ref as R
from ..parallel.sharding import sharded_region, vocab_product
from . import blocks as B
from .common import BlockSpec, ModelConfig, check_device, make_dense, rms_norm
from .transformer import _check_backend, _period, _tokens_in, _unbind

__all__ = ["init_params_encdec", "forward_encdec", "encode",
           "loss_fn_encdec", "init_decode_state_encdec",
           "decode_step_encdec"]

_SELF = BlockSpec(kind="attn")


def _xattn_init(cfg: ModelConfig, gen, device, lead) -> dict:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.torch_dtype
    return {
        "norm": {"scale": torch.zeros((*lead, d), dtype=dt, device=device)},
        "wq": {"w": make_dense(gen, (*lead, d, cfg.n_heads * hd), dt, device)},
        "wkv": {"w": make_dense(gen, (*lead, d, 2 * cfg.n_kv_heads * hd), dt,
                                device)},
        "wo": {"w": make_dense(gen, (*lead, cfg.n_heads * hd, d), dt,
                               device)},
    }


def init_params_encdec(cfg: ModelConfig,
                       generator: torch.Generator | None = None,
                       device="cuda") -> dict:
    """Random parameters on ``device`` from ``generator`` (seeded 0 when
    omitted); ``device="meta"`` gives shapes and dtypes only."""
    device = check_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device).manual_seed(0)
    d, dt, g = cfg.d_model, cfg.torch_dtype, generator
    enc, dec = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": {"table": make_dense(g, (cfg.vocab_size, d), dt, device,
                                      scale=0.02)},
        "enc_pos": make_dense(g, (cfg.enc_seq_len, d), dt, device,
                              scale=0.02),
        "enc": {"self": B.attn_init(cfg, g, device, enc),
                "ffn": B.mlp_init(cfg, g, device, enc)},
        "dec": {"self": B.attn_init(cfg, g, device, dec),
                "cross": _xattn_init(cfg, g, device, dec),
                "ffn": B.mlp_init(cfg, g, device, dec)},
        "enc_norm": {"scale": torch.zeros((d,), dtype=dt, device=device)},
        "final_norm": {"scale": torch.zeros((d,), dtype=dt, device=device)},
        "lm_head": {"w": make_dense(g, (d, cfg.vocab_size), dt, device)},
    }


# non-causal attention's roles for local_call: q's rows may split too
_NONCAUSAL = dict(roles=(B._QROWS, B._BHTD, B._BHTD),
                  out_roles=(B._QROWS,), free=("b", "c", "t"))


def _attend(p, x, q, k, v, backend: str):
    """Non-causal attention of q (B, T, Hq, hd) over k/v (B, Tk, Hkv, hd),
    then the output projection and the residual."""
    Bsz, T, _ = x.shape
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fn = R.attention_ref if backend == "ref" else ops.flash_attention
    o = B._local(fn, (qh, kh, vh), **_NONCAUSAL, causal=False)
    return (x + o.transpose(1, 2).contiguous().reshape(Bsz, T, -1)
            @ p["wo"]["w"])


def _self_attn_enc(cfg: ModelConfig, p, x, backend: str):
    """The encoder's self-attention: no mask, no RoPE, no softcap."""
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    q, k, v = B._qkv(cfg, p, h)
    return _attend(p, x, q, k, v, backend)


def _cross_attn(cfg: ModelConfig, p, x, enc_out, backend: str):
    """Decoder queries over the encoder output's keys and values, which
    are recomputed from ``enc_out`` on every call, as in the reference."""
    hd = cfg.hd
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    q = B._split_heads(h @ p["wq"]["w"], cfg.n_heads, hd)
    k, v = (enc_out @ p["wkv"]["w"]).chunk(2, dim=-1)
    return _attend(p, x, q, B._split_heads(k, cfg.n_kv_heads, hd),
                   B._split_heads(v, cfg.n_kv_heads, hd), backend)


def _embed_rows(params, tokens, index: bool = False):
    """The token embeddings: ``F.embedding`` (or indexing, the decode
    step's form), the vocab-parallel lookup on a DTensor table."""
    table = params["embed"]["table"]
    if isinstance(table, DTensor):
        return B.vocab_parallel_embed(tokens, table)
    if index:
        return table[tokens.long()]
    return F.embedding(tokens.long(), table)


def encode(params, enc_embeds, cfg: ModelConfig, backend: str = "kernel",
           mesh=None):
    """enc_embeds (B, T_enc, d), T_enc <= enc_seq_len → (B, T_enc, d)."""
    _check_backend(backend)
    T = enc_embeds.shape[1]
    with sharded_region(mesh):
        x = (_tokens_in(enc_embeds, mesh).to(cfg.torch_dtype)
             + params["enc_pos"][None, :T])
        for p in _unbind(params["enc"], cfg.n_enc_layers):
            x = _self_attn_enc(cfg, p["self"], x, backend)
            x = B.mlp_fwd(cfg, p["ffn"], x, mesh)
        return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def _logits(params, x, cfg: ModelConfig, mesh=None):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return vocab_product(x, params["lm_head"]["w"].to(x.dtype), mesh)


def forward_encdec(params, tokens, enc_embeds, cfg: ModelConfig,
                   backend: str = "kernel", mesh=None):
    """tokens (B, T) int, enc_embeds (B, T_enc, d) → logits (B, T, V) in
    the model dtype."""
    with sharded_region(mesh):
        enc_out = encode(params, enc_embeds, cfg, backend, mesh)
        x = _embed_rows(params, _tokens_in(tokens, mesh)).to(cfg.torch_dtype)
        Bsz, T, _ = x.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(Bsz, T)
        for p in _unbind(params["dec"], cfg.n_layers):
            x = B.attn_fwd(cfg, _SELF, p["self"], x, positions, backend, mesh)
            x = _cross_attn(cfg, p["cross"], x, enc_out, backend)
            x = B.mlp_fwd(cfg, p["ffn"], x, mesh)
        return _logits(params, x, cfg, mesh)


def loss_fn_encdec(params, batch, cfg: ModelConfig, backend: str = "ref",
                   mesh=None):
    """batch: {tokens, labels (< 0 masked), enc_embeds}.  CE through the
    fp32 ``log_softmax`` of the logits, as the reference computes it here
    (its decoder LM's loss takes the logsumexp form).  Returns (ce,
    {"ce", "aux": 0}); no remat, as in the reference."""
    with sharded_region(mesh):
        logits = forward_encdec(params, batch["tokens"], batch["enc_embeds"],
                                cfg, backend, mesh)
        labels = _tokens_in(batch["labels"], mesh).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        mask = labels >= 0
        ll = logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        loss = -(ll * mask).sum() / mask.sum().clamp_min(1)
        return loss, {"ce": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}


def init_decode_state_encdec(cfg: ModelConfig, batch: int, max_len: int,
                             device="cuda") -> dict:
    """The decoder's self-attention KV caches, (n_layers, B, Hkv, max_len,
    hd) each."""
    device = check_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def decode_step_encdec(params, state, token, pos, enc_out, cfg: ModelConfig,
                       backend: str = "kernel", mesh=None):
    """token (B,) int; ``pos`` an int or a 0-d int32 tensor on the token's
    device; enc_out (B, T_enc, d) from :func:`encode`.  Returns (logits
    (B, V) in the model dtype, state); the caches are updated in place."""
    _check_backend(backend)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=token.device)
    with sharded_region(mesh):
        x = _embed_rows(params, _tokens_in(token, mesh), index=True)[
            :, None].to(cfg.torch_dtype)
        enc_out = _tokens_in(enc_out, mesh)
        for i in range(cfg.n_layers):
            p = _period(params["dec"], i)
            cache = {"k": state["k"][i], "v": state["v"][i]}   # views
            x, _ = B.attn_step(cfg, _SELF, p["self"], x, cache, pos, backend,
                               mesh)
            x = _cross_attn(cfg, p["cross"], x, enc_out, backend)
            x = B.mlp_fwd(cfg, p["ffn"], x, mesh)
        return _logits(params, x[:, 0], cfg), state

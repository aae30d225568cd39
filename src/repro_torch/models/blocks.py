"""Blocks of the dense decoder LM: GQA attention and the dense GLU FFN
(``repro.models.blocks``'s counterparts; MoE, Mamba and RWKV blocks are not
ported yet).

Every block provides ``init``, ``fwd`` (full sequence) and, for attention,
``init_state`` / ``step`` (one token with a KV cache).  ``lead`` is the
leading shape of period-stacked parameters and states.  ``backend``
"kernel" sends attention through :mod:`repro_torch.kernels.ops` (the CUDA
kernels on a card, the plain versions on the CPU); "ref" runs the plain
versions on any device, as the reference's ``KB = "ref"`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels import ref as R
from .common import BlockSpec, ModelConfig, make_dense, rms_norm, rope

BACKENDS = ("kernel", "ref")


def _dense(gen, lead, d_in, d_out, cfg, device):
    return {"w": make_dense(gen, (*lead, d_in, d_out), cfg.torch_dtype,
                            device)}


def _zeros(lead, n, cfg, device):
    return torch.zeros((*lead, n), dtype=cfg.torch_dtype, device=device)


# ===========================================================================
# attention (GQA + RoPE + sliding window + softcap)
# ===========================================================================

def attn_init(cfg: ModelConfig, gen, device, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "norm": {"scale": _zeros(lead, d, cfg, device)},
        "wq": _dense(gen, lead, d, cfg.n_heads * hd, cfg, device),
        "wkv": _dense(gen, lead, d, 2 * cfg.n_kv_heads * hd, cfg, device),
        "wo": _dense(gen, lead, cfg.n_heads * hd, d, cfg, device),
    }
    if cfg.post_block_norm:
        p["post_norm"] = {"scale": _zeros(lead, d, cfg, device)}
    return p


def _split_heads(x, n, hd):
    B, T, _ = x.shape
    return x.reshape(B, T, n, hd)


def _qkv(cfg: ModelConfig, p, h):
    """q (B, T, Hq, hd), k/v (B, T, Hkv, hd); the fused ``wkv`` holds k in
    its first half and v in its second."""
    hd = cfg.hd
    q = _split_heads(h @ p["wq"]["w"], cfg.n_heads, hd)
    k, v = (h @ p["wkv"]["w"]).chunk(2, dim=-1)
    return (q, _split_heads(k, cfg.n_kv_heads, hd),
            _split_heads(v, cfg.n_kv_heads, hd))


def _out(cfg: ModelConfig, p, x, o):
    o = o @ p["wo"]["w"]
    if cfg.post_block_norm:
        o = rms_norm(o, p["post_norm"]["scale"], cfg.norm_eps)
    return x + o


def attn_fwd(cfg: ModelConfig, spec: BlockSpec, p, x, positions,
             backend: str = "kernel"):
    B, T, d = x.shape
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # (B, H, T, D) layout for the kernel
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=True, window=spec.window, softcap=cfg.attn_softcap)
    plain = backend == "ref" or x.device.type == "cpu"
    if plain and cfg.chunk_threshold and T >= cfg.chunk_threshold:
        o = R.chunked_attention_ref(qh, kh, vh, kv_chunk=cfg.attn_kv_chunk,
                                    **kw)
    elif backend == "ref":
        o = R.attention_ref(qh, kh, vh, **kw)
    else:
        # on a card the kernel takes every T
        o = ops.flash_attention(qh, kh, vh, **kw)
    o = o.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.hd)
    return _out(cfg, p, x, o)


def attn_init_state(cfg: ModelConfig, batch: int, max_len: int, device,
                    lead=()) -> dict:
    shape = (*lead, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def attn_step(cfg: ModelConfig, spec: BlockSpec, p, x, state, pos,
              backend: str = "kernel"):
    """x (B, 1, d); ``state`` the KV cache filled up to ``pos`` (a 0-d int32
    tensor on x's device); returns (x, state).

    The cache is written in place (``index_copy_``), where the reference
    returns an updated copy (``dynamic_update_slice``): the port keeps one
    cache per layer instead of two."""
    B = x.shape[0]
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    pvec = pos.reshape(1, 1).expand(B, 1)
    q = rope(q, pvec, cfg.rope_theta)
    k = rope(k, pvec, cfg.rope_theta)
    idx = pos.reshape(1).long()
    kc = state["k"].index_copy_(2, idx, k.transpose(1, 2))
    vc = state["v"].index_copy_(2, idx, v.transpose(1, 2))
    qh = q.transpose(1, 2).contiguous()
    kw = dict(window=spec.window, softcap=cfg.attn_softcap, pos=pos)
    if backend == "ref":
        o = R.decode_attention_ref(qh, kc, vc, **kw)
    else:
        o = ops.decode_attention(qh, kc, vc, **kw)
    o = o.transpose(1, 2).reshape(B, 1, cfg.n_heads * cfg.hd)
    return _out(cfg, p, x, o), state


# ===========================================================================
# dense FFN (SwiGLU / GeGLU)
# ===========================================================================

def mlp_init(cfg: ModelConfig, gen, device, lead=(), d_ff=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "norm": {"scale": _zeros(lead, d, cfg, device)},
        "up": _dense(gen, lead, d, f, cfg, device),
        "down": _dense(gen, lead, f, d, cfg, device),
    }
    if cfg.glu:
        p["gate"] = _dense(gen, lead, d, f, cfg, device)
    if cfg.post_block_norm:
        p["post_norm"] = {"scale": _zeros(lead, d, cfg, device)}
    return p


def _act(cfg):
    if cfg.activation == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def mlp_fwd(cfg: ModelConfig, p, x):
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    up = h @ p["up"]["w"]
    if cfg.glu:
        up = _act(cfg)(h @ p["gate"]["w"]) * up
    else:
        up = _act(cfg)(up)
    o = up @ p["down"]["w"]
    if cfg.post_block_norm:
        o = rms_norm(o, p["post_norm"]["scale"], cfg.norm_eps)
    return x + o

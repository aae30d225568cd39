"""Blocks of the decoder LMs: GQA attention, the dense GLU FFN and RWKV-6
(time mix + channel mix) — ``repro.models.blocks``'s counterparts; the MoE
and Mamba blocks are not ported yet.

Every block provides ``init``, ``fwd`` (full sequence) and, for attention
and RWKV, ``init_state`` / ``step`` (one token with a KV cache or a
recurrent state).  ``lead`` is the leading shape of period-stacked
parameters and states.  ``backend`` "kernel" sends attention and the wkv
recurrence through :mod:`repro_torch.kernels.ops` (the CUDA kernels on a
card, the plain versions on the CPU); "ref" runs the plain versions on any
device, as the reference's ``KB = "ref"`` does.
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


# ===========================================================================
# RWKV-6 (time mix + channel mix)
# ===========================================================================

def rwkv_init(cfg: ModelConfig, gen, device, lead=()) -> dict:
    d, dt = cfg.d_model, cfg.torch_dtype
    H = d // cfg.rwkv_head_dim
    rank = cfg.rwkv_decay_rank
    return {
        "norm": {"scale": _zeros(lead, d, cfg, device)},
        "mix": make_dense(gen, (*lead, 5, d), dt, device, scale=0.02),
        "rkvwg": _dense(gen, lead, d, 4 * d, cfg, device),
        "w_lora_a": make_dense(gen, (*lead, d, rank), dt, device),
        "w_lora_b": make_dense(gen, (*lead, rank, d), dt, device),
        "time_decay": torch.full((*lead, d), -4.0, dtype=dt, device=device),
        "u": make_dense(gen, (*lead, H, cfg.rwkv_head_dim), dt, device,
                        scale=0.1),
        "out_proj": _dense(gen, lead, d, d, cfg, device),
        "cnorm": {"scale": _zeros(lead, d, cfg, device)},
        "ck": _dense(gen, lead, d, cfg.d_ff, cfg, device),
        "cv": _dense(gen, lead, cfg.d_ff, d, cfg, device),
        "cr": _dense(gen, lead, d, d, cfg, device),
    }


def _shift(h):
    """Token shift: h at t - 1, zeros at t = 0 (h is (B, T, d))."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def _rwkv_mix(h, hprev, mix):
    """token-shift interpolation for (r, k, v, w, g)."""
    return [h + (hprev - h) * mix[i] for i in range(5)]


def _time_mix_inputs(p, h, hprev):
    """r, k, v, g projections and the fp32 decay w in (0, 1).  The decay's
    ``time_decay + tanh(xw @ A) @ B`` runs in the model dtype and is cast to
    fp32 after, as in the reference."""
    d = h.shape[-1]
    xr, xk, xv, xw, xg = _rwkv_mix(h, hprev, p["mix"])
    w4 = p["rkvwg"]["w"]     # (d, 4d): the r, k, v, g blocks side by side
    r, k, v, g = (xs @ w4[:, i * d:(i + 1) * d]
                  for i, xs in enumerate((xr, xk, xv, xg)))
    w_raw = p["time_decay"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return r, k, v, g, torch.exp(-torch.exp(w_raw.float()))


def _sigmoid(t):
    """``1 / (1 + exp(-t))`` op by op in t's dtype: in bf16 this rounds
    where the reference's ``jax.nn.sigmoid`` does (``torch.sigmoid`` rounds
    once, and the bf16 logits then drift past the parity tolerance)."""
    return 1 / (1 + torch.exp(-t))


def _channel_mix(p, h2, h2prev):
    """The channel mix reuses ``mix[1]`` for k and ``mix[0]`` for r, as the
    reference does."""
    xk = h2 + (h2prev - h2) * p["mix"][1]
    xr = h2 + (h2prev - h2) * p["mix"][0]
    kk = torch.square(F.relu(xk @ p["ck"]["w"]))
    return (kk @ p["cv"]["w"]) * _sigmoid(xr @ p["cr"]["w"])


def rwkv_fwd(cfg: ModelConfig, p, x, backend: str = "kernel"):
    B, T, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    r, k, v, g, w = _time_mix_inputs(p, h, _shift(h))

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2).contiguous()

    # w is rounded to the model dtype before the recurrence (the reference's
    # ``w.astype(x.dtype)``); rwkv_step keeps it in fp32
    args = (heads(r), heads(k), heads(v), heads(w.to(x.dtype)), p["u"])
    # Every T takes one path: the plain loop holds only the (Dk, Dv) state,
    # so unlike attention it gains nothing from chunks above
    # ``chunk_threshold`` (the reference chunks to rematerialize each chunk
    # for its backward pass, which this forward-only port has not).
    if backend == "ref":
        o, _ = R.rwkv6_ref(*args)
    else:
        o, _ = ops.rwkv6(*args)
    o = o.transpose(1, 2).reshape(B, T, d) * (g * _sigmoid(g))
    x = x + o @ p["out_proj"]["w"]

    h2 = rms_norm(x, p["cnorm"]["scale"], cfg.norm_eps)
    return x + _channel_mix(p, h2, _shift(h2))


def rwkv_init_state(cfg: ModelConfig, batch: int, device, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {
        "tshift": torch.zeros((*lead, batch, d), dtype=cfg.torch_dtype,
                              device=device),
        "cshift": torch.zeros((*lead, batch, d), dtype=cfg.torch_dtype,
                              device=device),
        "wkv": torch.zeros((*lead, batch, d // hd, hd, hd),
                           dtype=torch.float32, device=device),
    }


def rwkv_step(cfg: ModelConfig, p, x, state):
    """x (B, 1, d); ``state`` {tshift, cshift (B, d) in the model dtype,
    wkv (B, H, hd, hd) fp32}; returns (x, state).  A plain recurrence step
    with no kernel, with w kept in fp32.

    The state is updated in place, where the reference returns a new one:
    ``tshift`` takes the normed h (model dtype), ``cshift`` the normed h2,
    and ``wkv`` the next S."""
    B, _, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)[:, 0]
    r, k, v, g, w = _time_mix_inputs(p, h, state["tshift"])

    rh, kh, vh = (t.reshape(B, H, hd).float() for t in (r, k, v))
    u = p["u"].float()
    kv = kh[..., :, None] * vh[..., None, :]
    S = state["wkv"]
    o = torch.einsum("bhk,bhkv->bhv", rh, S + u[None, :, :, None] * kv)
    S.mul_(w.reshape(B, H, hd, 1)).add_(kv)
    o = (o.reshape(B, d).to(x.dtype) * (g * _sigmoid(g)))[:, None]
    x = x + o @ p["out_proj"]["w"]

    h2 = rms_norm(x, p["cnorm"]["scale"], cfg.norm_eps)[:, 0]
    out = _channel_mix(p, h2, state["cshift"])[:, None]
    state["tshift"].copy_(h)
    state["cshift"].copy_(h2)
    return x + out, state

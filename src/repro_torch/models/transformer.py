"""The decoder LM of the port: embed → periods → norm → logits
(``repro.models.transformer``'s counterpart for layer patterns of attention
and Mamba blocks, each with a dense or an MoE FFN, and of RWKV-6 blocks;
``forward`` takes a vision or audio prefix of embeddings before the
tokens).  Encoder-decoder models are :mod:`repro_torch.models.encdec`'s.

Parameters and decode states are nested dicts of tensors with the same
keys and shapes as the reference's pytrees, stacked over the period axis,
so :func:`repro_torch.convert.params_from_jax` maps one onto the other
leaf by leaf.  The period loop is a Python loop (PyTorch runs eagerly).
"""

from __future__ import annotations

import math
import struct

import torch

from . import blocks as B
from .common import ModelConfig, check_device, make_dense, rms_norm, softcap

__all__ = ["init_params", "forward", "init_decode_state", "decode_step"]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this module does not run."""
    for spec in cfg.layer_pattern:
        if spec.kind not in ("attn", "mamba", "rwkv"):
            raise NotImplementedError(
                f"{cfg.name}: {spec.kind} blocks are not ported yet")
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: use "
            "repro_torch/models/encdec.py (init_params_encdec, "
            "forward_encdec, decode_step_encdec)")


def _check_backend(backend: str) -> None:
    if backend not in B.BACKENDS:
        raise ValueError(f"backend must be one of {B.BACKENDS}, "
                         f"got {backend!r}")


def _period(tree, i: int):
    """The parameters (or state) of period ``i`` as views of the stacks."""
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters on ``device`` from ``generator`` (a generator of
    that device; seeded 0 when omitted).  ``device="meta"`` gives shapes
    and dtypes only."""
    check_supported(cfg)
    device = check_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device).manual_seed(0)
    d, dt = cfg.d_model, cfg.torch_dtype
    params = {
        "embed": {"table": make_dense(generator, (cfg.vocab_size, d), dt,
                                      device, scale=0.02)},
        "final_norm": {"scale": torch.zeros((d,), dtype=dt, device=device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": make_dense(generator, (d, cfg.vocab_size),
                                             dt, device)}
    lead = (cfg.n_periods,)
    params["layers"] = {
        f"pos{i}": _block_init(cfg, spec, generator, device, lead)
        for i, spec in enumerate(cfg.layer_pattern)}
    return params


def _block_init(cfg: ModelConfig, spec, generator, device, lead) -> dict:
    if spec.kind == "rwkv":   # the RWKV block holds its own channel mix
        return {"core": B.rwkv_init(cfg, generator, device, lead)}
    core = B.mamba_init if spec.kind == "mamba" else B.attn_init
    ffn = B.moe_init if spec.moe else B.mlp_init
    return {"core": core(cfg, generator, device, lead),
            "ffn": ffn(cfg, generator, device, lead)}


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (to nearest even, through fp32 as
    ``torch.tensor(v, dtype=dtype)`` rounds it), as a Python float: a
    scalar the host holds, where a tensor made from it would be copied to
    the card on every call."""
    if dtype == torch.float64:
        return v
    bits = struct.unpack("<I", struct.pack("<f", v))[0]
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    v = struct.unpack("<f", struct.pack("<I", bits))[0]
    if dtype == torch.float16:
        return struct.unpack("<e", struct.pack("<e", v))[0]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"no rounding to {dtype}")
    return v


def _embed(params, tokens, cfg: ModelConfig):
    x = params["embed"]["table"][tokens.long()].to(cfg.torch_dtype)
    if cfg.scale_embeddings:
        # the factor rounded to the model dtype first, as the reference
        # does; x times a model-dtype scalar rounds once from the exact
        # product, as the reference's product of two model-dtype arrays
        x = x * _rounded(math.sqrt(cfg.d_model), cfg.torch_dtype)
    return x


def _logits(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
    return softcap((x @ head.to(x.dtype)).float(), cfg.final_softcap)


def forward(params, tokens, cfg: ModelConfig, prefix_embeds=None,
            backend: str = "kernel"):
    """tokens (B, T) int; ``prefix_embeds`` an optional (B, P, d) prefix
    of patch or frame embeddings, put before the (scaled) token embeddings.
    Returns fp32 logits (B, P + T, V) and the MoE aux loss summed over
    layers (a 0-d fp32 tensor, 0 without MoE layers)."""
    check_supported(cfg)
    _check_backend(backend)
    x = _embed(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    Bsz, T, _ = x.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device).expand(Bsz, T)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for per in range(cfg.n_periods):
        pp = _period(params["layers"], per)
        for i, spec in enumerate(cfg.layer_pattern):
            p = pp[f"pos{i}"]
            if spec.kind == "rwkv":   # time mix and channel mix in one
                x = B.rwkv_fwd(cfg, p["core"], x, backend)
                continue
            if spec.kind == "mamba":
                x = B.mamba_fwd(cfg, p["core"], x, backend)
            else:
                x = B.attn_fwd(cfg, spec, p["core"], x, positions, backend)
            if spec.moe:
                x, a = B.moe_fwd(cfg, p["ffn"], x)
                aux = aux + a
            else:
                x = B.mlp_fwd(cfg, p["ffn"], x)
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> dict:
    """KV caches (attention) or recurrent states (Mamba, RWKV) stacked over
    periods.  Every cache holds ``max_len`` positions, a windowed layer's
    too, as in the reference; a recurrent state does not depend on it."""
    check_supported(cfg)
    device = check_device(device)
    lead = (cfg.n_periods,)

    def one(spec):
        if spec.kind == "attn":
            return B.attn_init_state(cfg, batch, max_len, device, lead)
        if spec.kind == "mamba":
            return B.mamba_init_state(cfg, batch, device, lead)
        return B.rwkv_init_state(cfg, batch, device, lead)

    return {f"pos{i}": one(spec) for i, spec in enumerate(cfg.layer_pattern)}


def decode_step(params, state, token, pos, cfg: ModelConfig,
                backend: str = "kernel"):
    """token (B,) int; ``pos`` an int or a 0-d int32 tensor on the token's
    device.  Returns (logits (B, V) fp32, state); the state's caches and
    recurrent states are updated in place.  The MoE aux loss is dropped, as
    in the reference."""
    check_supported(cfg)
    _check_backend(backend)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=token.device)
    x = _embed(params, token, cfg)[:, None]
    for per in range(cfg.n_periods):
        pp = _period(params["layers"], per)
        st = _period(state, per)
        for i, spec in enumerate(cfg.layer_pattern):
            p, s = pp[f"pos{i}"], st[f"pos{i}"]
            if spec.kind == "rwkv":
                x, _ = B.rwkv_step(cfg, p["core"], x, s)
                continue
            if spec.kind == "mamba":
                x, _ = B.mamba_step(cfg, p["core"], x, s)
            else:
                x, _ = B.attn_step(cfg, spec, p["core"], x, s, pos, backend)
            if spec.moe:
                x, _ = B.moe_fwd(cfg, p["ffn"], x)
            else:
                x = B.mlp_fwd(cfg, p["ffn"], x)
    return _logits(params, x[:, 0], cfg), state

"""The decoder LM of the port: embed → periods → norm → logits
(``repro.models.transformer``'s counterpart for layer patterns of attention
and Mamba blocks, each with a dense or an MoE FFN, and of RWKV-6 blocks;
``forward`` takes a vision or audio prefix of embeddings before the
tokens) and ``loss_fn`` trains it.  Encoder-decoder models are
:mod:`repro_torch.models.encdec`'s.

Parameters and decode states are nested dicts of tensors with the same
keys and shapes as the reference's pytrees, stacked over the period axis,
so :func:`repro_torch.convert.params_from_jax` maps one onto the other
leaf by leaf.  The period loop is a Python loop (PyTorch runs eagerly);
with ``cfg.remat`` each period of a forward that records gradients is
rematerialized in the backward pass (the reference's ``jax.checkpoint``
with ``nothing_saveable``).

``mesh`` (a ``DeviceMesh``) makes the model run on DTensors over it, as
the reference runs under GSPMD: the parameters (and decode state) come in
laid out by :mod:`repro_torch.parallel.sharding`'s rules, token inputs are
laid out on ``batch``, and the reference's sharding constraints stand at
its four points here (the embedded input, each period's output, the
logits, the decode step's embedded token) and in the blocks.  With
``mesh=None`` nothing of this runs.
"""

from __future__ import annotations

import math
import struct

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..parallel.sharding import distribute, sharded_region, with_constraint
from . import blocks as B
from .common import ModelConfig, check_device, make_dense, rms_norm, softcap

__all__ = ["init_params", "forward", "loss_fn", "init_decode_state",
           "decode_step"]


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


def _unbind(tree, n: int) -> list:
    """The ``n`` periods' parameters as views of the stacks, each stack cut
    once: under autograd the backward of one ``unbind`` is one ``stack``,
    where indexing every period would make a zero stack per period."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


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


def _tokens_in(tokens, mesh):
    """Token inputs laid out on ``batch`` (the reference's jit input
    sharding); as they are without a mesh or when already DTensors."""
    if mesh is None or isinstance(tokens, DTensor):
        return tokens
    return distribute(tokens, mesh, ("batch",) + ("none",) * (tokens.ndim - 1))


def _embed(params, tokens, cfg: ModelConfig):
    # F.embedding, not indexing: its backward sums a row's gradients in a
    # fixed order (indexing's accumulates with atomics on the CPU)
    table = params["embed"]["table"]
    if isinstance(table, DTensor):
        x = B.vocab_parallel_embed(tokens, table).to(cfg.torch_dtype)
    else:
        x = F.embedding(tokens.long(), table).to(cfg.torch_dtype)
    if cfg.scale_embeddings:
        # the factor rounded to the model dtype first, as the reference
        # does; x times a model-dtype scalar rounds once from the exact
        # product, as the reference's product of two model-dtype arrays
        x = x * _rounded(math.sqrt(cfg.d_model), cfg.torch_dtype)
    return x


def _logits(params, x, cfg: ModelConfig, mesh=None, logical=None):
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"]["w"])
    logits = x @ head.to(x.dtype)
    if logical is not None:
        # keep the (B, T, V) tensor vocab-sharded, as the reference does
        logits = with_constraint(logits, mesh, logical)
    return softcap(logits.float(), cfg.final_softcap)


def _period_fwd(cfg: ModelConfig, pp, x, aux, positions, backend: str,
                mesh=None):
    """One period of the layer pattern: (x, aux) → (x, aux + its MoE aux
    losses, added layer by layer)."""
    for i, spec in enumerate(cfg.layer_pattern):
        p = pp[f"pos{i}"]
        if spec.kind == "rwkv":   # time mix and channel mix in one
            x = B.rwkv_fwd(cfg, p["core"], x, backend, mesh)
            continue
        if spec.kind == "mamba":
            x = B.mamba_fwd(cfg, p["core"], x, backend, mesh)
        else:
            x = B.attn_fwd(cfg, spec, p["core"], x, positions, backend, mesh)
        if spec.moe:
            x, a = B.moe_fwd(cfg, p["ffn"], x, mesh)
            aux = aux + a
        else:
            x = B.mlp_fwd(cfg, p["ffn"], x, mesh)
    # the sequence-parallel residual stream (Megatron-SP), as the
    # reference constrains its scan carry
    return with_constraint(x, mesh, ("batch", "seq_model", "none")), aux


def forward(params, tokens, cfg: ModelConfig, prefix_embeds=None,
            backend: str = "kernel", mesh=None):
    """tokens (B, T) int; ``prefix_embeds`` an optional (B, P, d) prefix
    of patch or frame embeddings, put before the (scaled) token embeddings.
    Returns fp32 logits (B, P + T, V) and the MoE aux loss summed over
    layers (a 0-d fp32 tensor, 0 without MoE layers).  With ``cfg.remat``
    and gradients recorded, each period keeps only its input for the
    backward pass and runs again there; the numbers are the same.  With a
    ``mesh`` the logits are a DTensor."""
    check_supported(cfg)
    _check_backend(backend)
    with sharded_region(mesh):
        x = _embed(params, _tokens_in(tokens, mesh), cfg)
        if prefix_embeds is not None:
            x = torch.cat([_tokens_in(prefix_embeds, mesh).to(x.dtype), x],
                          dim=1)
        Bsz, T, _ = x.shape
        positions = torch.arange(T, dtype=torch.int32,
                                 device=x.device).expand(Bsz, T)
        x = with_constraint(x, mesh, ("batch", "none", "none"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for pp in _unbind(params["layers"], cfg.n_periods):
            if remat:
                x, aux = checkpoint(_period_fwd, cfg, pp, x, aux, positions,
                                    backend, mesh, use_reentrant=False)
            else:
                x, aux = _period_fwd(cfg, pp, x, aux, positions, backend,
                                     mesh)
        return _logits(params, x, cfg, mesh, ("batch", "none", "vocab")), aux


def loss_fn(params, batch, cfg: ModelConfig, backend: str = "ref",
            mesh=None):
    """Next-token cross-entropy.  ``batch``: {tokens (B, T), labels (B, T)
    (< 0 masked)[, prefix_embeds (B, P, d)]}; the prefix's rows are
    dropped.  CE is ``logsumexp(logits) − logits[label]``, so the (B, T, V)
    log-probabilities are never made.  Returns (ce + aux, {"ce", "aux"}).
    ``backend`` "ref" by default: the reference trains on its plain path
    (``KB = "ref"``), and the kernels have no backward pass."""
    with sharded_region(mesh):
        logits, aux = forward(params, batch["tokens"], cfg,
                              batch.get("prefix_embeds"), backend=backend,
                              mesh=mesh)
        return _ce(logits, _tokens_in(batch["labels"], mesh), aux)


def _label_logit(logits, labels):
    """logits[..., label]: a gather, or on vocab-sharded DTensor logits a
    masked sum over the vocabulary, which each device does on its slice
    (the sum of one logit and zeros, so the same number; DTensor's own
    vocab-parallel gather misreads labels split over a mesh dim)."""
    if not isinstance(logits, DTensor):
        return logits.gather(-1, labels[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(labels[..., None] == vocab, logits, 0.0).sum(-1)


def _ce(logits, labels, aux):
    labels = labels.long()
    P = logits.shape[1] - labels.shape[1]
    if P:
        logits = logits[:, P:]
    lse = torch.logsumexp(logits, dim=-1)                     # (B, T)
    ll = _label_logit(logits, labels.clamp_min(0))
    mask = labels >= 0
    loss = ((lse - ll) * mask).sum() / mask.sum().clamp_min(1)
    return loss + aux, {"ce": loss, "aux": aux}


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
                backend: str = "kernel", mesh=None):
    """token (B,) int; ``pos`` an int or a 0-d int32 tensor on the token's
    device.  Returns (logits (B, V) fp32, state); the state's caches and
    recurrent states are updated in place.  The MoE aux loss is dropped, as
    in the reference."""
    check_supported(cfg)
    _check_backend(backend)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=token.device)
    with sharded_region(mesh):
        x = _embed(params, _tokens_in(token, mesh), cfg)[:, None]
        x = with_constraint(x, mesh, ("batch", "none", "none"))
        for per in range(cfg.n_periods):
            pp = _period(params["layers"], per)
            st = _period(state, per)
            for i, spec in enumerate(cfg.layer_pattern):
                p, s = pp[f"pos{i}"], st[f"pos{i}"]
                if spec.kind == "rwkv":
                    x, _ = B.rwkv_step(cfg, p["core"], x, s, mesh)
                    continue
                if spec.kind == "mamba":
                    x, _ = B.mamba_step(cfg, p["core"], x, s, mesh)
                else:
                    x, _ = B.attn_step(cfg, spec, p["core"], x, s, pos,
                                       backend, mesh)
                if spec.moe:
                    x, _ = B.moe_fwd(cfg, p["ffn"], x, mesh)
                else:
                    x = B.mlp_fwd(cfg, p["ffn"], x, mesh)
        return _logits(params, x[:, 0], cfg), state

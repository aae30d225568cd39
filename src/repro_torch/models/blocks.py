"""Blocks of the decoder LMs: GQA attention, the dense GLU FFN, the MoE
FFN, Mamba and RWKV-6 (time mix + channel mix) — ``repro.models.blocks``'s
counterparts.

Every block provides ``init``, ``fwd`` (full sequence) and, for attention,
Mamba and RWKV, ``init_state`` / ``step`` (one token with a KV cache or a
recurrent state).  ``lead`` is the leading shape of period-stacked
parameters and states.  ``backend`` "kernel" sends attention, the selective
scan and the wkv recurrence through :mod:`repro_torch.kernels.ops` (the CUDA
kernels on a card, the plain versions on the CPU); "ref" runs the plain
versions on any device, as the reference's ``KB = "ref"`` does.

``mesh`` (a ``DeviceMesh`` or None) is taken where the reference takes it.
With a mesh the tensors are DTensors: attention's
queries are laid out by the reference's constraint, the attention, scan
and recurrence run on each device's shards (:func:`_local`), and the MoE
takes :func:`_moe_fwd_shardmap` for 8192 tokens or more on a mesh of
more than one device.  Without a mesh every path is as it was.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops
from ..kernels import ref as R
from ..parallel.sharding import is_sharded, local_call, with_constraint
from .common import BlockSpec, ModelConfig, make_dense, rms_norm, rope

BACKENDS = ("kernel", "ref")


# per argument, the role of each dim for :func:`local_call`: "b" batch,
# "c" heads or channels (the op is independent along both), None whole
_BHTD = ("b", "c", None, None)
_ATTN = dict(roles=(_BHTD,) * 3, out_roles=(_BHTD,))


def _local(fn, args, roles, out_roles, **kw):
    """``fn(*args, **kw)``, on each device's shards when the arguments are
    DTensors (:func:`repro_torch.parallel.sharding.local_call`)."""
    return local_call(functools.partial(fn, **kw) if kw else fn, args,
                      roles, out_roles)


def vocab_parallel_embed(tokens, table):
    """``F.embedding(tokens, table)`` for a DTensor table (V, d): its d
    gathered, its vocab split kept; each device looks up the tokens in its
    slice of the vocabulary (zeros for the others'), and the partial rows
    sum across the vocab's mesh dims.  (DTensor's own masked lookup
    misreads tokens split over a mesh dim that also splits d.)"""
    mesh = table.device_mesh
    vdims = [i for i, pl in enumerate(table.placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    table = table.redistribute(mesh, tuple(
        Shard(0) if i in vdims else Replicate() for i in range(mesh.ndim)))
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    (Replicate(),) * mesh.ndim,
                                    run_check=False)
    tok_pl = tuple(Replicate() if i in vdims else pl
                   for i, pl in enumerate(tokens.placements))
    tokens = tokens.redistribute(mesh, tok_pl)
    t_loc = tokens.to_local().long()
    w_loc = table.to_local(grad_placements=tuple(
        Shard(0) if i in vdims else Partial() if isinstance(pl, Shard)
        else Replicate() for i, pl in enumerate(tok_pl)))
    V_loc, first = w_loc.shape[0], 0
    for i in vdims:                                   # major mesh dim first
        first = first * mesh.shape[i] + mesh.get_local_rank(i)
    at = t_loc - first * V_loc
    mine = (at >= 0) & (at < V_loc)
    rows = F.embedding(at.clamp(0, V_loc - 1), w_loc) * mine[..., None]
    out_pl = tuple(Partial() if i in vdims else pl
                   for i, pl in enumerate(tok_pl))
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


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
             backend: str = "kernel", mesh=None):
    B, T, d = x.shape
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # (B, H, T, D) layout for the kernel
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    qh = with_constraint(qh, mesh, ("batch", "tensor", "none", "none"))
    kw = dict(causal=True, window=spec.window, softcap=cfg.attn_softcap)
    plain = backend == "ref" or x.device.type == "cpu"
    if plain and cfg.chunk_threshold and T >= cfg.chunk_threshold:
        o = _local(R.chunked_attention_ref, (qh, kh, vh), **_ATTN,
                   kv_chunk=cfg.attn_kv_chunk, **kw)
    elif backend == "ref":
        o = _local(R.attention_ref, (qh, kh, vh), **_ATTN, **kw)
    else:
        # on a card the kernel takes every T
        o = ops.flash_attention(qh, kh, vh, **kw)
    # contiguous before the merge of heads (the copy reshape makes anyway):
    # DTensor's backward of that reshape is a view
    o = o.transpose(1, 2).contiguous().reshape(B, T, cfg.n_heads * cfg.hd)
    return _out(cfg, p, x, o)


def attn_init_state(cfg: ModelConfig, batch: int, max_len: int, device,
                    lead=()) -> dict:
    shape = (*lead, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def _cache_write(cache, idx, new):
    """``cache[:, :, idx] = new`` in place (cache (B, H, S, D), new (B, H,
    1, D), idx (1,) int64).  A DTensor cache whose S is sharded (the
    reference's ``seq`` fallback) is written on each device's slab: the
    device that holds position ``idx`` takes the row, the others write
    back what they hold, so nothing is gathered."""
    if not isinstance(cache, DTensor):
        return cache.index_copy_(2, idx, new)
    mesh = cache.device_mesh
    want = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == 2
                 else pl for pl in cache.placements)
    new = new if tuple(new.placements) == want else new.redistribute(
        mesh, want)
    local, S_loc = cache.to_local(), cache.to_local().shape[2]
    start = 0
    for i, pl in enumerate(cache.placements):
        if isinstance(pl, Shard) and pl.dim == 2:   # major mesh dim first
            start = start * mesh.shape[i] + mesh.get_local_rank(i)
    at = idx - start * S_loc
    mine = (at >= 0) & (at < S_loc)
    at = at.clamp(0, S_loc - 1)
    row = torch.where(mine, new.to_local(), local.index_select(2, at))
    local.index_copy_(2, at, row)
    return cache


def attn_step(cfg: ModelConfig, spec: BlockSpec, p, x, state, pos,
              backend: str = "kernel", mesh=None):
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
    kc = _cache_write(state["k"], idx, k.transpose(1, 2))
    vc = _cache_write(state["v"], idx, v.transpose(1, 2))
    qh = q.transpose(1, 2).contiguous()
    kw = dict(window=spec.window, softcap=cfg.attn_softcap, pos=pos)
    if backend == "ref":
        o = _local(R.decode_attention_ref, (qh, kc, vc), **_ATTN, **kw)
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


def _sigmoid(t):
    """``1 / (1 + exp(-t))`` op by op in t's dtype: in bf16 this rounds
    where the reference's ``jax.nn.sigmoid`` does (``torch.sigmoid`` rounds
    once, and the bf16 logits then drift past the parity tolerance)."""
    return 1 / (1 + torch.exp(-t))


def _silu(t):
    """``t · sigmoid(t)`` op by op, rounding in bf16 where the reference's
    ``jax.nn.silu`` does (``F.silu`` rounds once; in the hybrid and MoE
    models that one rounding flips router near-ties)."""
    return t * _sigmoid(t)


def _act(cfg):
    if cfg.activation == "silu":
        return _silu
    return lambda t: F.gelu(t, approximate="tanh")


def mlp_fwd(cfg: ModelConfig, p, x, mesh=None):
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
# MoE FFN (shared + routed experts; GShard-style capacity dispatch)
# ===========================================================================

def moe_init(cfg: ModelConfig, gen, device, lead=()) -> dict:
    d, f, E, dt = cfg.d_model, cfg.d_ff_e, cfg.n_experts, cfg.torch_dtype
    p = {
        "norm": {"scale": _zeros(lead, d, cfg, device)},
        "router": _dense(gen, lead, d, E, cfg, device),
        "experts": {
            "w_up": make_dense(gen, (*lead, E, d, f), dt, device),
            "w_gate": make_dense(gen, (*lead, E, d, f), dt, device),
            "w_down": make_dense(gen, (*lead, E, f, d), dt, device),
        },
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"up": _dense(gen, lead, d, fs, cfg, device),
                       "gate": _dense(gen, lead, d, fs, cfg, device),
                       "down": _dense(gen, lead, fs, d, cfg, device)}
    return p


def moe_capacity(cfg: ModelConfig, n_tok: int) -> int:
    """Slots per expert for ``n_tok`` tokens: max(1, min(ceil(n_tok·k·
    capacity_factor / E), n_tok)), the float product as the reference
    computes it."""
    C = math.ceil(n_tok * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(1, min(C, n_tok))


def moe_fwd(cfg: ModelConfig, p, x, mesh=None):
    """Token-choice top-k with capacity dispatch: x (B, T, d) → (x +
    moe(x), router aux loss), the aux returned where the reference puts it
    on the ``moe_fwd.aux`` side channel.  With a mesh of more than one
    device and at least 8192 tokens the dispatch runs on each device's
    tokens (:func:`_moe_fwd_shardmap`); on one device that path is this
    one."""
    B, T, d = x.shape
    if is_sharded(mesh) and B * T >= 8192:
        return _moe_fwd_shardmap(cfg, p, x, mesh)
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    if isinstance(h, DTensor):
        # the dispatch on every device over all tokens and whole weights
        # (GSPMD's replicated fallback for the scatter)
        paths, leaves = zip(*_moe_leaves(p))
        y, aux = local_call(
            lambda ht, *ws: _moe_local(cfg, _moe_tree(paths, ws), ht),
            (h.reshape(B * T, d), *leaves),
            ((None, None),) + tuple((None,) * w.ndim for w in leaves),
            ((None, None), ()))
        return x + y.reshape(B, T, d), aux
    y, aux = _moe_local(cfg, p, h.reshape(B * T, d))
    return x + y.reshape(B, T, d), aux


def _moe_leaves(p):
    """(path, tensor) of the MoE weights that :func:`_moe_local` reads."""
    out = [("router/w", p["router"]["w"])]
    out += [(f"experts/{k}", v) for k, v in p["experts"].items()]
    if "shared" in p:
        out += [(f"shared/{k}/w", v["w"]) for k, v in p["shared"].items()]
    return out


def _moe_tree(names, leaves) -> dict:
    tree: dict = {}
    for name, t in zip(names, leaves):
        *keys, last = name.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def _moe_fwd_shardmap(cfg: ModelConfig, p, x, mesh):
    """The reference's ``shard_map`` dispatch on DTensors: the MoE weights
    replicated (their all-gather), the tokens split over the batch axes
    and then, by the device's coordinate, over ``model`` when (Bl·Tl) is a
    multiple of its size M and at least M; :func:`_moe_local` on each
    device's tokens, whose capacity then counts local tokens (with drops
    the result differs from the unsharded one, as the reference's does);
    the outputs all-gathered over ``model``, or averaged over it when the
    tokens were not split; aux averaged over every axis."""
    d = x.shape[-1]
    names = mesh.mesh_dim_names
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    # each device's gradient of what it holds whole is a partial sum
    partial = (Partial(),) * mesh.ndim
    paths, leaves = zip(*_moe_leaves(p))
    w = _moe_tree(paths, [with_constraint(t, mesh, ("none",) * t.ndim)
                          .to_local(grad_placements=partial)
                          for t in leaves])
    batch = tuple(i for i, a in enumerate(names) if a in ("pod", "data"))
    mdl = names.index("model") if "model" in names else None
    tok_pl = tuple(Shard(0) if i in batch else Replicate()
                   for i in range(mesh.ndim))
    h_loc = h.redistribute(mesh, tok_pl).to_local(grad_placements=tuple(
        Shard(0) if i in batch else Partial() for i in range(mesh.ndim)))
    Bl, Tl, _ = h_loc.shape
    toks = h_loc.reshape(Bl * Tl, d)
    M = mesh.shape[mdl] if mdl is not None else 1
    split = mdl is not None and (Bl * Tl) % M == 0 and Bl * Tl >= M
    if split:
        per = (Bl * Tl) // M
        i = mesh.get_local_rank(mdl)
        toks = toks[i * per:(i + 1) * per]
    y_my, aux = _moe_local(cfg, w, toks)
    # the local results as one DTensor over the (B·T, d) tokens, then laid
    # out as the tokens came in
    last = Shard(0) if split else Partial("avg")
    pl = tuple(last if i == mdl else Shard(0) if i in batch
               else Replicate() for i in range(mesh.ndim))
    y = DTensor.from_local(y_my, mesh, pl, run_check=False)
    y = y.redistribute(mesh, tok_pl).to_local().reshape(Bl, Tl, d)
    y = DTensor.from_local(y, mesh, tok_pl, run_check=False)
    aux = DTensor.from_local(aux, mesh, (Partial("avg"),) * mesh.ndim,
                             run_check=False)
    return x + y, aux.redistribute(mesh, (Replicate(),) * mesh.ndim)


def _moe_local(cfg: ModelConfig, p, ht):
    """The MoE of ``n_tok`` tokens, ht (n_tok, d), exactly as the
    reference's ``_moe_local`` routes, drops and combines:

    - top-k of the fp32 softmax, ties to the lower expert index (as
      ``jax.lax.top_k``; a stable descending sort, where ``torch.topk``
      promises no order among ties), gates renormalized in fp32;
    - capacity C = :func:`moe_capacity`; a choice's slot is its rank
      among the choices of its expert in the token-major (n_tok·k) order,
      and a choice ranked ≥ C is dropped (its token adds a zero row at slot
      C − 1; the gather reads slot 0 and masks it);
    - the expert products in the model dtype (cuBLAS batched products, as
      XLA einsums in the reference); the output summed slot by slot, j = 0
      … k−1, in the model dtype, each gate cast to it first;
    - aux = router_aux_coef · E · Σ_e mean-prob_e · choice-share_e, the
      dropped choices counted."""
    E, k = cfg.n_experts, cfg.top_k
    n_tok, d = ht.shape
    experts = p["experts"]

    probs = torch.softmax((ht @ p["router"]["w"]).float(), dim=-1)
    gate_vals, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, eids = gate_vals[:, :k], eids[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing aux loss (Switch-style)
    flat_e = eids.reshape(-1)                                  # (n_tok·k,)
    # not F.one_hot, which on the CPU reads the ids' range on the host
    onehot = (flat_e[:, None] == torch.arange(E, device=ht.device)).long()
    ce = onehot.sum(0).float() / (n_tok * k)
    aux = cfg.router_aux_coef * E * torch.sum(probs.mean(dim=0) * ce)

    C = moe_capacity(cfg, n_tok)
    pos_k = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None]).reshape(n_tok, k)
    keep = pos_k < C

    buf = torch.zeros((E, C, d), dtype=ht.dtype, device=ht.device)
    scatter_at = torch.where(keep, pos_k, C - 1)
    for j in range(k):
        buf.index_put_((eids[:, j], scatter_at[:, j]),
                       torch.where(keep[:, j, None], ht, 0), accumulate=True)

    act = _act(cfg)
    h = act(torch.bmm(buf, experts["w_gate"])) * torch.bmm(buf, experts["w_up"])
    out_e = torch.bmm(h, experts["w_down"])                    # (E, C, d)

    y = torch.zeros_like(ht)
    gather_at = torch.where(keep, pos_k, 0)
    for j in range(k):
        g_j = torch.where(keep[:, j, None],
                          out_e[eids[:, j], gather_at[:, j]], 0)
        y = y + g_j * gate_vals[:, j, None].to(g_j.dtype)

    shared = p.get("shared")
    if shared is not None:
        y = y + (act(ht @ shared["gate"]["w"])
                 * (ht @ shared["up"]["w"])) @ shared["down"]["w"]
    return y, aux


# ===========================================================================
# Mamba (S6 selective scan)
# ===========================================================================

def mamba_init(cfg: ModelConfig, gen, device, lead=()) -> dict:
    """A_log and D stay fp32 in a bf16 model, as in the reference."""
    d, di, N, r, dt = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dtr,
                       cfg.torch_dtype)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "norm": {"scale": _zeros(lead, d, cfg, device)},
        "in_proj": _dense(gen, lead, d, 2 * di, cfg, device),
        "conv1d": {"w": make_dense(gen, (*lead, cfg.d_conv, di), dt, device)},
        "x_proj": {"w": make_dense(gen, (*lead, di, r + 2 * N), dt, device)},
        "dt_proj": {"w": make_dense(gen, (*lead, r, di), dt, device),
                    "bias": torch.full((*lead, di), -3.0, dtype=dt,
                                       device=device)},
        "A_log": torch.log(A).expand(*lead, di, N).contiguous(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
        "out_proj": _dense(gen, lead, di, d, cfg, device),
    }


def _causal_conv(x, w):
    """x (B, T, D), w (K, D): depthwise causal; the K shifted products are
    summed in order from 0, each add rounded in x's dtype, as the
    reference's ``sum`` does."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[i]
    return out


def _softplus(t):
    """``jax.nn.softplus`` = ``logaddexp(t, 0)`` = max(t, 0) +
    log1p(exp(−|t|)), op by op (``F.softplus`` switches to the identity
    above its threshold of 20)."""
    return t.clamp_min(0) + torch.log1p(torch.exp(-t.abs()))


def _mamba_dbc(cfg: ModelConfig, p, xs):
    """dt (after the softplus, in the model dtype), B and C from xs."""
    r, N = cfg.dtr, cfg.d_state
    dt, Bc, Cc = (xs @ p["x_proj"]["w"]).split([r, N, N], dim=-1)
    return (_softplus(dt @ p["dt_proj"]["w"] + p["dt_proj"]["bias"]), Bc, Cc)


_SCAN = dict(roles=ops.SCAN_ROLES, out_roles=ops.SCAN_OUT_ROLES)


def mamba_fwd(cfg: ModelConfig, p, x, backend: str = "kernel", mesh=None):
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    xs, z = (h @ p["in_proj"]["w"]).chunk(2, dim=-1)
    xs = _silu(_causal_conv(xs, p["conv1d"]["w"]))
    dt, Bc, Cc = _mamba_dbc(cfg, p, xs)
    # the scan takes dt in the model dtype (the reference's forward);
    # mamba_step keeps it in fp32
    args = (xs, dt, -torch.exp(p["A_log"].float()), Bc.contiguous(),
            Cc.contiguous(), p["D"])
    # Every T takes one path: the plain loop holds only the (Dm, N) state
    # (the reference chunks above ``chunk_threshold`` only to rematerialize
    # each chunk for its backward pass)
    if backend == "ref":
        y, _ = _local(R.selective_scan_ref, args, **_SCAN)
    else:
        y, _ = ops.ssm_scan(*args)
    return x + (y * _silu(z)) @ p["out_proj"]["w"]


def mamba_init_state(cfg: ModelConfig, batch: int, device, lead=()) -> dict:
    di = cfg.d_inner
    return {
        "conv": torch.zeros((*lead, batch, cfg.d_conv - 1, di),
                            dtype=cfg.torch_dtype, device=device),
        "ssm": torch.zeros((*lead, batch, di, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_step(cfg: ModelConfig, p, x, state, mesh=None):
    """x (B, 1, d); ``state`` {conv (B, K−1, di) in the model dtype, ssm
    (B, di, N) fp32}; returns (x, state).  A plain step with no kernel, dt
    kept in fp32 (the forward hands the scan dt in the model dtype, so bf16
    forward and decode differ by design).  The state is updated in place,
    where the reference returns a new one."""
    h = rms_norm(x, p["norm"]["scale"], cfg.norm_eps)
    xs, z = (h[:, 0] @ p["in_proj"]["w"]).chunk(2, dim=-1)
    window = torch.cat([state["conv"], xs[:, None]], dim=1)   # (B, K, di)
    xs = _silu(torch.einsum("bkd,kd->bd", window, p["conv1d"]["w"]))
    dt, Bc, Cc = _mamba_dbc(cfg, p, xs)
    dt, xf = dt.float(), xs.float()
    A = -torch.exp(p["A_log"].float())
    hnew = (torch.exp(dt[..., None] * A) * state["ssm"]
            + (dt * xf)[..., None] * Bc.float()[:, None, :])
    y = torch.einsum("bdn,bn->bd", hnew, Cc.float()) + xf * p["D"]
    y = (y.to(x.dtype) * _silu(z))[:, None]
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(hnew)
    return x + y @ p["out_proj"]["w"], state


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


def _channel_mix(p, h2, h2prev):
    """The channel mix reuses ``mix[1]`` for k and ``mix[0]`` for r, as the
    reference does."""
    xk = h2 + (h2prev - h2) * p["mix"][1]
    xr = h2 + (h2prev - h2) * p["mix"][0]
    kk = torch.square(F.relu(xk @ p["ck"]["w"]))
    return (kk @ p["cv"]["w"]) * _sigmoid(xr @ p["cr"]["w"])


_WKV = dict(roles=ops.WKV_ROLES, out_roles=ops.WKV_OUT_ROLES)


def rwkv_fwd(cfg: ModelConfig, p, x, backend: str = "kernel", mesh=None):
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
        o, _ = _local(R.rwkv6_ref, args, **_WKV)
    else:
        o, _ = ops.rwkv6(*args)
    o = o.transpose(1, 2).reshape(B, T, d) * _silu(g)
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


def rwkv_step(cfg: ModelConfig, p, x, state, mesh=None):
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
    o = (o.reshape(B, d).to(x.dtype) * _silu(g))[:, None]
    x = x + o @ p["out_proj"]["w"]

    h2 = rms_norm(x, p["cnorm"]["scale"], cfg.norm_eps)[:, 0]
    out = _channel_mix(p, h2, state["cshift"])[:, None]
    state["tshift"].copy_(h)
    state["cshift"].copy_(h2)
    return x + out, state

"""Plain float32 reference of a dense decoder with grouped-query attention
(Mistral-NeMo): embedding → layers of [RMSNorm → GQA attention with RoPE,
causal] and [RMSNorm → SwiGLU MLP], each added to the residual → RMSNorm →
head.  Published keys as in ``bench/configs``: ``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim``,
``intermediate_size``, ``num_hidden_layers``, ``vocab_size``,
``rms_norm_eps``, ``rope_theta``, ``tie_word_embeddings``.

Weights come in the benchmark's tree, stacked over layers:
``embed/table`` (V, d); ``final_norm/scale``; ``lm_head/w`` (d, V);
``layers/pos0/core/{norm/scale, wq/w (d, Hq·D), wkv/w (d, 2·Hkv·D: k then
v), wo/w}``; ``layers/pos0/ffn/{norm/scale, gate/w, up/w, down/w}``.
A norm's weight is stored as an offset from 1.  Query head h reads kv head
h // (Hq / Hkv).  Full attention over the sequence (no window, no
softcap), no cache: a sequence is one forward pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Exact, cross_entropy, get, rms_norm, rope

QUERY_BLOCK = 512      # queries a block, so that the scores fit at long T
LAYER_KEYS = ("core/norm/scale", "core/wq/w", "core/wkv/w", "core/wo/w",
              "ffn/norm/scale", "ffn/gate/w", "ffn/up/w", "ffn/down/w")


def _layer(hp: dict, P, x, *w):
    (n1, wq, wkv, wo, n2, wg, wu, wd) = w
    N, T, _ = x.shape
    hq, hkv, D = (hp["num_attention_heads"], hp["num_key_value_heads"],
                  hp["head_dim"])
    eps = hp["rms_norm_eps"]
    mm = P.mm
    h = rms_norm(x, n1, eps)
    q = mm(h, wq).view(N, T, hq, D)
    kv = mm(h, wkv)
    k = kv[..., :hkv * D].reshape(N, T, hkv, D)
    v = kv[..., hkv * D:].reshape(N, T, hkv, D)
    q, k = rope(q, hp["rope_theta"]), rope(k, hp["rope_theta"])
    g = hq // hkv
    qg = q.view(N, T, hkv, g, D).permute(0, 2, 3, 1, 4)      # N,hkv,g,T,D
    pos = torch.arange(T, device=x.device)
    blocks = []
    for a in range(0, T, QUERY_BLOCK):       # queries a … e − 1 see keys < e
        e = min(T, a + QUERY_BLOCK)
        s = torch.einsum("nhgtd,nshd->nhgts", qg[:, :, :, a:e],
                         k[:, :e]) * D ** -0.5
        causal = pos[a:e, None] >= pos[None, :e]
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        blocks.append(torch.einsum("nhgts,nshd->nhgtd", p, v[:, :e]))
    o = torch.cat(blocks, dim=3).permute(0, 3, 1, 2, 4).reshape(N, T,
                                                                hq * D)
    x = P.act(x + mm(o, wo))
    h2 = rms_norm(x, n2, eps)
    return P.act(x + mm(F.silu(mm(h2, wg)) * mm(h2, wu), wd))


def _head(weights: dict, hp: dict):
    if hp["tie_word_embeddings"]:
        return get(weights, "embed/table").T
    return get(weights, "lm_head/w")


def logits_at(weights: dict, tokens: torch.Tensor, rows: torch.Tensor,
              hp: dict, P=Exact) -> torch.Tensor:
    """float32 logits (M, V) at ``rows`` (M, 2) = (sequence, position) of
    ``tokens`` (N, T), each position seeing the tokens up to it, at
    precision ``P`` (``common.Exact`` or the control's ``common.FP8``).
    One layer's weights are widened to float32 at a time."""
    with torch.no_grad():
        x = P.act(F.embedding(tokens.long(),
                              get(weights, "embed/table")).float())
        for i in range(hp["num_hidden_layers"]):
            w = [get(weights, f"layers/pos0/{k}")[i].float()
                 for k in LAYER_KEYS]
            x = _layer(hp, P, x, *w)
            del w
        xs = x[rows[:, 0], rows[:, 1]]
        xs = rms_norm(xs, get(weights, "final_norm/scale").float(),
                      hp["rms_norm_eps"])
        return P.mm(xs, _head(weights, hp).float())


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         hp: dict, P=Exact) -> torch.Tensor:
    """Mean next-token cross-entropy (labels < 0 masked) of float32
    ``params`` (a tree as above, differentiable) at precision ``P``; each
    layer is recomputed in the backward pass."""
    x = P.act(F.embedding(tokens.long(), get(params, "embed/table")))
    stacks = [get(params, f"layers/pos0/{k}") for k in LAYER_KEYS]
    for i in range(hp["num_hidden_layers"]):
        x = checkpoint(_layer, hp, P, x, *(s[i] for s in stacks),
                       use_reentrant=False)
    x = rms_norm(x, get(params, "final_norm/scale"), hp["rms_norm_eps"])
    return cross_entropy(P.mm(x, _head(params, hp)), labels.long())

"""Plain float32 reference of RWKV-6 ("Finch", arXiv:2404.05892) as the
port runs it: embedding → layers of [RMSNorm → time mix] and [RMSNorm →
channel mix], each added to the residual → RMSNorm → head.

Per layer, with h the normed input and h' the same at t − 1 (0 at t = 0)
and x_i = h + (h' − h) ⊙ mix_i:

    r, k, v, g = x_0 W_r, x_1 W_k, x_2 W_v, x_4 W_g      (W_rkvg = [W_r W_k W_v W_g])
    log w     = −exp(time_decay + tanh(x_3 A) B)         (per channel)
    o_t       = r_t · (S_{t−1} + diag(u) k_tᵀ v_t),  S_t = diag(w_t) S_{t−1} + k_tᵀ v_t
    x        += (o ⊙ silu(g)) W_out
    channel:  x += (relu(c_1 W_ck)² W_cv) ⊙ σ(c_0 W_cr),   c_i = h2 + (h2' − h2) ⊙ mix_i

per head of ``head_size`` channels, S (head_size, head_size) from zero.
Departures of the port from the published RWKV-6 that this follows: RMS
norms in place of layer norms (no ln0), static token-shift mixes (no
data-dependent token-shift LoRA), no group norm on the wkv output.

The recurrence runs in chunks, exactly: within a chunk every pair's decay
is exp of a difference of cumulative log-decays (never above 1), and the
state crosses chunk boundaries.  Weights as in the benchmark's tree,
stacked over layers (``layers/pos0/core/...``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import Exact, cross_entropy, get, rms_norm

LAYER_KEYS = ("norm/scale", "mix", "rkvwg/w", "w_lora_a", "w_lora_b",
              "time_decay", "u", "out_proj/w", "cnorm/scale", "ck/w", "cv/w",
              "cr/w")
CHUNK = 32


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """o (B, H, T, K) of the recurrence above; r, k, v, logw (B, H, T, K)
    float32 (logw = log of the decay, ≤ 0), u (H, K)."""
    B, H, T, K = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    n = (T + pad) // chunk
    rc, kc, vc, lc = (t.reshape(B, H, n, chunk, K) for t in (r, k, v, logw))
    incl = lc.cumsum(3)                  # log decay through position i
    excl = incl - lc                     # … through i − 1
    below = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)[..., None]
    diag = (rc * u[None, :, None, None, :] * kc).sum(-1)        # B,H,n,C
    S = r.new_zeros(B, H, K, K)
    outs = []
    for c in range(n):
        ri, ki, vi = rc[:, :, c], kc[:, :, c], vc[:, :, c]
        ei, ii = excl[:, :, c], incl[:, :, c]
        o = (ri * ei.exp()) @ S
        pair = (ei[:, :, :, None, :] - ii[:, :, None, :, :]).masked_fill(
            ~below, float("-inf"))
        A = (ri[:, :, :, None, :] * ki[:, :, None, :, :]
             * pair.exp()).sum(-1)
        A = A + torch.diag_embed(diag[:, :, c])
        outs.append(o + A @ vi)
        tail = (ii[:, :, -1:, :] - ii).exp()
        S = S * ii[:, :, -1, :, None].exp() + (ki * tail).transpose(-1, -2) \
            @ vi
    return torch.cat(outs, dim=2)[:, :, :T]


def _shift(h):
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def _layer(hp: dict, P, x, *w):
    (n1, mix, w4, la, lb, decay, u, wout, n2, wck, wcv, wcr) = w
    N, T, d = x.shape
    K = hp["head_size"]
    H = d // K
    eps = hp["layer_norm_epsilon"]
    mm = P.mm
    h = rms_norm(x, n1, eps)
    hp_ = _shift(h)
    xr, xk, xv, xw, xg = (h + (hp_ - h) * mix[i] for i in range(5))
    r, k, v, g = (mm(xs, w4[:, i * d:(i + 1) * d])
                  for i, xs in enumerate((xr, xk, xv, xg)))
    logw = -torch.exp(decay + mm(torch.tanh(mm(xw, la)), lb))
    if P is not Exact:             # the decay itself held at P's precision
        logw = torch.log(P.act(torch.exp(logw)).clamp_min(1e-30))

    def heads(t):
        return t.reshape(N, T, H, K).transpose(1, 2)

    o = wkv(heads(r), heads(k), heads(v), heads(logw), u)
    o = P.act(o.transpose(1, 2).reshape(N, T, d)) * F.silu(g)
    x = P.act(x + mm(o, wout))
    h2 = rms_norm(x, n2, eps)
    h2p = _shift(h2)
    ck = h2 + (h2p - h2) * mix[1]
    cr = h2 + (h2p - h2) * mix[0]
    return P.act(x + mm(torch.square(F.relu(mm(ck, wck))), wcv)
                 * torch.sigmoid(mm(cr, wcr)))


def _head(weights: dict, hp: dict):
    if hp["tie_word_embeddings"]:
        return get(weights, "embed/table").T
    return get(weights, "lm_head/w")


def logits_at(weights: dict, tokens: torch.Tensor, rows: torch.Tensor,
              hp: dict, P=Exact) -> torch.Tensor:
    """float32 logits (M, V) at ``rows`` (M, 2) = (sequence, position) of
    ``tokens`` (N, T), at precision ``P``.  One layer's weights are
    widened at a time."""
    with torch.no_grad():
        x = P.act(F.embedding(tokens.long(),
                              get(weights, "embed/table")).float())
        for i in range(hp["num_hidden_layers"]):
            w = [get(weights, f"layers/pos0/core/{k}")[i].float()
                 for k in LAYER_KEYS]
            x = _layer(hp, P, x, *w)
            del w
        xs = x[rows[:, 0], rows[:, 1]]
        xs = rms_norm(xs, get(weights, "final_norm/scale").float(),
                      hp["layer_norm_epsilon"])
        return P.mm(xs, _head(weights, hp).float())


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
         hp: dict, P=Exact) -> torch.Tensor:
    """Mean next-token cross-entropy (labels < 0 masked) of float32
    ``params`` at precision ``P``; each layer is recomputed in the
    backward pass."""
    x = P.act(F.embedding(tokens.long(), get(params, "embed/table")))
    stacks = [get(params, f"layers/pos0/core/{k}") for k in LAYER_KEYS]
    for i in range(hp["num_hidden_layers"]):
        x = checkpoint(_layer, hp, P, x, *(s[i] for s in stacks),
                       use_reentrant=False)
    x = rms_norm(x, get(params, "final_norm/scale"),
                 hp["layer_norm_epsilon"])
    return cross_entropy(P.mm(x, _head(params, hp)), labels.long())

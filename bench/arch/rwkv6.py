"""RWKV-6 ("Finch", arXiv:2404.05892) as the port runs it: the time mix
with its data-dependent decay and the channel mix, in a configuration's
published keys (``time_decay_extra_dim`` is the decay LoRA's rank)."""

from __future__ import annotations


def matmul_params(hp: dict) -> int:
    """Parameters that multiply a token: r, k, v, g, the decay LoRA, the
    output projection, the channel mix, and the head."""
    d, f = hp["hidden_size"], hp["intermediate_size"]
    rank = hp["time_decay_extra_dim"]
    layer = 6 * d * d + 2 * d * rank + 2 * d * f
    return hp["num_hidden_layers"] * layer + d * hp["vocab_size"]


def param_count(hp: dict) -> int:
    """Every parameter: the products', the embedding, the five token-shift
    mixes, the decay bias, the bonus u and the norms'."""
    d, L = hp["hidden_size"], hp["num_hidden_layers"]
    embed = 0 if hp["tie_word_embeddings"] else hp["vocab_size"] * d
    per_layer = 5 * d + d + d + 2 * d      # mix, time_decay, u, 2 norms
    return matmul_params(hp) + embed + L * per_layer + d


def mixer_flops(hp: dict, pos: int) -> int:
    """The wkv recurrence of one token, all layers: r·S and k⊗v into S,
    2 FLOPs a multiply-add, over every head's (head_size)² state (the
    element-wise decay and bonus are not counted)."""
    return hp["num_hidden_layers"] * 4 * hp["hidden_size"] * hp["head_size"]


def port_pairs(hp: dict, cfg) -> list[tuple[str, object, object]]:
    return [
        ("hidden_size", hp["hidden_size"], cfg.d_model),
        ("num_hidden_layers", hp["num_hidden_layers"], cfg.n_layers),
        ("head_size", hp["head_size"], cfg.rwkv_head_dim),
        ("intermediate_size", hp["intermediate_size"], cfg.d_ff),
        ("vocab_size", hp["vocab_size"], cfg.vocab_size),
        ("layer_norm_epsilon", hp["layer_norm_epsilon"], cfg.norm_eps),
        ("time_decay_extra_dim", hp["time_decay_extra_dim"],
         cfg.rwkv_decay_rank),
        ("tie_word_embeddings", hp["tie_word_embeddings"],
         cfg.tie_embeddings),
        ("torch_dtype", hp["torch_dtype"], cfg.dtype),
        ("layer_kinds", ["rwkv"], [s.kind for s in cfg.layer_pattern]),
    ]


def weight_init(name: str, shape: tuple) -> tuple[str, float]:
    if name == "scale":
        return "normal", 0.1
    if name == "table":
        return "normal", 0.02
    if name == "mix":                   # token-shift interpolation
        return "normal", 0.02
    if name == "time_decay":            # per-channel decay bias, ~ -4
        return "decay", 1.0
    if name == "u":                     # the bonus of the current token
        return "normal", 0.1
    return "normal", shape[-2] ** -0.5

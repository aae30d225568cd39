"""A dense decoder with grouped-query attention, RoPE and a SwiGLU MLP
(Mistral-NeMo's family), in a configuration's published keys."""

from __future__ import annotations


def matmul_params(hp: dict) -> int:
    """Parameters that multiply a token: every layer's projections and
    the output head (the embedding is a lookup)."""
    d, hd = hp["hidden_size"], hp["head_dim"]
    hq, hkv = hp["num_attention_heads"], hp["num_key_value_heads"]
    layer = d * hd * (hq + 2 * hkv) + hq * hd * d \
        + 3 * d * hp["intermediate_size"]
    return hp["num_hidden_layers"] * layer + d * hp["vocab_size"]


def param_count(hp: dict) -> int:
    """Every parameter: the products', the embedding and the norms'."""
    d, L = hp["hidden_size"], hp["num_hidden_layers"]
    embed = 0 if hp["tie_word_embeddings"] else hp["vocab_size"] * d
    return matmul_params(hp) + embed + 2 * L * d + d


def mixer_flops(hp: dict, pos: int) -> int:
    """Attention of one token at ``pos`` over positions 0 … pos, all
    layers: QKᵀ and PV, 2 FLOPs a multiply-add."""
    return (hp["num_hidden_layers"] * 4 * hp["num_attention_heads"]
            * hp["head_dim"] * (pos + 1))


def port_pairs(hp: dict, cfg) -> list[tuple[str, object, object]]:
    """(published key, its value, the port config's value) for every
    setting the two share."""
    return [
        ("hidden_size", hp["hidden_size"], cfg.d_model),
        ("num_hidden_layers", hp["num_hidden_layers"], cfg.n_layers),
        ("num_attention_heads", hp["num_attention_heads"], cfg.n_heads),
        ("num_key_value_heads", hp["num_key_value_heads"], cfg.n_kv_heads),
        ("head_dim", hp["head_dim"], cfg.hd),
        ("intermediate_size", hp["intermediate_size"], cfg.d_ff),
        ("vocab_size", hp["vocab_size"], cfg.vocab_size),
        ("rms_norm_eps", hp["rms_norm_eps"], cfg.norm_eps),
        ("rope_theta", hp["rope_theta"], cfg.rope_theta),
        ("tie_word_embeddings", hp["tie_word_embeddings"],
         cfg.tie_embeddings),
        ("torch_dtype", hp["torch_dtype"], cfg.dtype),
        ("hidden_act", hp["hidden_act"], cfg.activation),
        ("sliding_window", hp["sliding_window"],
         cfg.layer_pattern[0].window),
        ("glu", True, cfg.glu),
        ("attn_softcap", None, cfg.attn_softcap),
        ("final_softcap", None, cfg.final_softcap),
        ("scale_embeddings", False, cfg.scale_embeddings),
        ("post_block_norm", False, cfg.post_block_norm),
        ("layer_kinds", ["attn"],
         [s.kind for s in cfg.layer_pattern if not s.moe]),
    ]


def weight_init(name: str, shape: tuple) -> tuple[str, float]:
    """How the benchmark draws the weight whose last key is ``name``:
    ("normal", std) or ("const", value)."""
    if name == "scale":                 # norms compute x · (1 + scale)
        return "normal", 0.1
    if name == "table":
        return "normal", 0.02
    return "normal", shape[-2] ** -0.5

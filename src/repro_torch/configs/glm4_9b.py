"""GLM-4 9B [hf:THUDM/glm-4-9b].  Dense, RoPE, aggressive GQA (kv=2).
40L, d_model 4096, 32 heads, d_ff 13696, vocab 151552."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        vocab_size=151552,
        d_model=4096,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=40,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13696,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        remat=False,
    )

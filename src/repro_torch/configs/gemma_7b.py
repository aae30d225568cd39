"""Gemma 7B [arXiv:2403.08295; hf].  Dense, GeGLU, head_dim 256, tied +
scaled embeddings.  28L, d_model 3072, 16 heads (kv=16), d_ff 24576,
vocab 256000."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        vocab_size=256000,
        d_model=3072,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=28,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        activation="gelu",
        tie_embeddings=True,
        scale_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=128,
        activation="gelu",
        tie_embeddings=True,
        scale_embeddings=True,
        remat=False,
    )

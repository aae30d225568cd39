"""Mistral-Nemo-Base-2407 12B [hf:mistralai/Mistral-Nemo-Base-2407].
Dense, 40L, d_model 5120, 32 heads head_dim 128 (GQA kv=8), d_ff 14336,
vocab 131072, 128k context (full attention)."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        vocab_size=131072,
        d_model=5120,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=40,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        remat=False,
    )

"""Gemma-2 9B [arXiv:2408.00118; hf].  Local(4096)/global alternating
attention, attention and final logit soft-capping, sandwich (post-block)
norms, GeGLU.  42L, d_model 3584, 16 heads head_dim 256 (GQA kv=8),
d_ff 14336, vocab 256000."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        vocab_size=256000,
        d_model=3584,
        layer_pattern=(BlockSpec(kind="attn", window=4096),
                       BlockSpec(kind="attn")),
        n_periods=21,                # 42 layers
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        activation="gelu",
        attn_softcap=50.0,
        final_softcap=30.0,
        post_block_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn", window=16),
                       BlockSpec(kind="attn")),
        n_periods=1,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        activation="gelu",
        attn_softcap=50.0,
        final_softcap=30.0,
        post_block_norm=True,
        tie_embeddings=True,
        scale_embeddings=True,
        remat=False,
    )

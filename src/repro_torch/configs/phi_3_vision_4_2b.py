"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].  phi3-mini
backbone + CLIP frontend (STUB: ``prefix_embeds`` arrive precomputed —
576 patch embeddings).  32L, d_model 3072, 32 heads (kv=32), d_ff 8192,
vocab 32064."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        vocab_size=32064,
        d_model=3072,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=32,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        prefix_len=576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        prefix_len=16,
        remat=False,
    )

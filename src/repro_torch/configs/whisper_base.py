"""Whisper-base [arXiv:2212.04356; unverified].  Encoder-decoder; the conv
frontend is a STUB (``enc_embeds`` = precomputed 1500 frame embeddings).
6+6L, d_model 512, 8 heads (kv=8), d_ff 2048, vocab 51865, plain GELU MLP
(no GLU)."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        vocab_size=51865,
        d_model=512,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=6,                 # decoder layers
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        activation="gelu",
        glu=False,
        is_encoder_decoder=True,
        n_enc_layers=6,
        enc_seq_len=1500,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn"),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        activation="gelu",
        glu=False,
        is_encoder_decoder=True,
        n_enc_layers=2,
        enc_seq_len=32,
        remat=False,
    )

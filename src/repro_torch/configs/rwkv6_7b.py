"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf:RWKV/v6-Finch-7B-HF].
Attention-free gated linear recurrence with data-dependent decay.  32L,
d_model 4096, 64 heads of 64, d_ff 14336, vocab 65536."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        vocab_size=65536,
        d_model=4096,
        layer_pattern=(BlockSpec(kind="rwkv"),),
        n_periods=32,
        d_ff=14336,
        rwkv_head_dim=64,
        rwkv_decay_rank=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="rwkv"),),
        n_periods=2,
        d_ff=128,
        rwkv_head_dim=16,
        rwkv_decay_rank=8,
        remat=False,
    )

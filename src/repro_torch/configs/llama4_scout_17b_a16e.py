"""Llama-4-Scout 17B-active / 16 experts
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  MoE top-1 with a shared
expert on every layer, early-fusion multimodal (text path modeled; fusion
stub).  48L, d_model 5120, 40 heads (GQA kv=8), expert d_ff 8192,
vocab 202048."""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        vocab_size=202048,
        d_model=5120,
        layer_pattern=(BlockSpec(kind="attn", moe=True),),
        n_periods=48,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        n_experts=16,
        top_k=1,
        n_shared_experts=1,
        d_ff_expert=8192,
        rope_theta=5e5,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn", moe=True),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        n_experts=4,
        top_k=1,
        n_shared_experts=1,
        d_ff_expert=128,
        remat=False,
    )

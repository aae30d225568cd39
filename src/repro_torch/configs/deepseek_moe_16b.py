"""DeepSeekMoE 16B [arXiv:2401.06066; hf].  Fine-grained MoE: 64 routed
experts top-6 + 2 shared experts, expert d_ff 1408.  28L, d_model 2048,
16 heads (kv=16), vocab 102400.  (The real model's first layer is dense
d_ff 10944; we keep the homogeneous MoE pattern and carry the dense width
in ``d_ff`` for the shared-path sizing.)"""

from ..models.common import BlockSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        vocab_size=102400,
        d_model=2048,
        layer_pattern=(BlockSpec(kind="attn", moe=True),),
        n_periods=28,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10944,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        d_ff_expert=1408,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=(BlockSpec(kind="attn", moe=True),),
        n_periods=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=256,
        n_experts=8,
        top_k=2,
        n_shared_experts=2,
        d_ff_expert=32,
        remat=False,
    )

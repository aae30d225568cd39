"""Jamba-1.5-Large (398B) [arXiv:2403.19887 / 2408.12570; hf].

Hybrid Mamba+attention, 1:7 attention:mamba interleave (one attention layer
per 8-layer Jamba block, at position 4), MoE (16 experts, top-2) on every
other layer.  72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576,
vocab 65536.
"""

from ..models.common import BlockSpec, ModelConfig


def _pattern(moe_every=2, attn_pos=4, period=8, window=None):
    out = []
    for i in range(period):
        kind = "attn" if i == attn_pos else "mamba"
        out.append(BlockSpec(kind=kind, moe=(i % moe_every == 1),
                             window=window))
    return tuple(out)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        vocab_size=65536,
        d_model=8192,
        layer_pattern=_pattern(),
        n_periods=9,                 # 72 layers
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        n_experts=16,
        top_k=2,
        d_ff_expert=24576,
        d_state=16,
        d_conv=4,
        mamba_expand=2,
        activation="silu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        vocab_size=512,
        d_model=64,
        layer_pattern=_pattern(),
        n_periods=1,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        n_experts=4,
        top_k=2,
        d_ff_expert=128,
        d_state=8,
        d_conv=4,
        mamba_expand=2,
        remat=False,
    )

"""Shared model machinery for the PyTorch port: config schema, norms, RoPE,
initializer.

``BlockSpec`` and ``ModelConfig`` are copies of ``repro.models.common``'s
(the port imports nothing of ``repro``); ``tests/test_torch_models.py``
holds the copies equal field by field.  A model is ``layer_pattern`` ×
``n_periods`` with parameters stacked over the period axis, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["BlockSpec", "ModelConfig", "rms_norm", "rope", "make_dense",
           "softcap", "check_device", "synchronize"]


@dataclass(frozen=True)
class BlockSpec:
    """One position in the repeating layer pattern."""

    kind: str = "attn"          # "attn" | "mamba" | "rwkv"
    window: int | None = None   # sliding-window size for local attention
    moe: bool = False           # routed-FFN instead of dense FFN


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    vocab_size: int = 32000
    d_model: int = 1024
    layer_pattern: tuple[BlockSpec, ...] = (BlockSpec(),)
    n_periods: int = 4

    # attention
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int | None = None
    rope_theta: float = 10000.0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_block_norm: bool = False   # Gemma-2 sandwich norms

    # FFN
    d_ff: int = 4096
    activation: str = "silu"        # "silu" (SwiGLU) | "gelu" (GeGLU)
    glu: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int | None = None
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gather"        # "gather" (GSPMD) | "ragged" (shard_map)

    # Mamba
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    dt_rank: int | None = None

    # RWKV
    rwkv_head_dim: int = 64
    rwkv_decay_rank: int = 64

    # long-sequence execution strategy: the plain path switches to chunked
    # streaming attention above the threshold; 0 disables
    chunk_threshold: int = 2048
    attn_kv_chunk: int = 1024
    scan_chunk: int = 256

    # embeddings / misc
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # Gemma multiplies by sqrt(d_model)
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True

    # modality stubs
    prefix_len: int = 0             # VLM patch / audio frame prefix length
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 0

    # ---------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.layer_pattern) * self.n_periods

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The model dtype as a torch dtype (``jdtype``'s counterpart)."""
        return getattr(torch, self.dtype)

    @property
    def d_ff_e(self) -> int:
        return self.d_ff_expert or self.d_ff

    def n_params(self) -> int:
        """Approximate parameter count (used for 6·N·D roofline terms)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.layer_pattern:
            if spec.kind == "attn":
                n_p = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            elif spec.kind == "mamba":
                di = self.d_inner
                n_p = d * 2 * di + di * (self.dtr + 2 * self.d_state) \
                    + self.dtr * di + di * self.d_state + di * d \
                    + self.d_conv * di
            else:  # rwkv: rkvwg 4d² + out d² + cr d² + lora + channel mix
                n_p = 6 * d * d + d * self.rwkv_decay_rank * 2 \
                    + 2 * d * self.d_ff
            if spec.kind != "rwkv":
                if spec.moe:
                    ff = self.d_ff_e
                    n_p += (self.n_experts + self.n_shared_experts) * 3 * d * ff \
                        + d * self.n_experts
                else:
                    n_p += (3 if self.glu else 2) * d * self.d_ff
            n += n_p * self.n_periods
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k counting)."""
        if not any(s.moe for s in self.layer_pattern):
            return self.n_params()
        d = self.d_model
        n = self.n_params()
        for spec in self.layer_pattern:
            if spec.moe:
                ff = self.d_ff_e
                inactive = (self.n_experts - self.top_k) * 3 * d * ff
                n -= inactive * self.n_periods
        return n


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def check_device(device) -> torch.device:
    """Resolve ``device``; a CUDA device must exist (no quiet CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain path on the CPU")
    return device


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x (..., T, H, D) with D even; positions (..., T).  Half-split
    rotation with fp32 angles."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].float() * freqs  # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def make_dense(gen: torch.Generator | None, shape, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, scale) weights, scale defaulting to fan_in^-0.5 (fan_in is
    ``shape[-2]``).  Filled one leading slice at a time so a period-stacked
    weight never needs a full fp32 copy.  On the ``meta`` device only the
    shape and dtype are made."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
    for sl in flat:
        sl.copy_(torch.randn(sl.shape, generator=gen, dtype=torch.float32,
                             device=out.device).mul_(scale))
    return out

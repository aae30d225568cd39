"""What the references share: float32 numerics, the product hooks (exact,
or with both operands rounded to fp8 for the control), and the weight
tree's access by key path."""

from __future__ import annotations

import torch

FP8_MAX = 448.0       # largest finite float8_e4m3fn


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8_e4m3fn with one scale per slice along ``dim``
    (each slice's absolute maximum mapped to 448), back in float32."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (t.detach() / s).to(torch.float8_e4m3fn).float() * s


def _st(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """t rounded to fp8 along ``dim``; gradients pass straight through."""
    return t + (_q8(t, dim) - t).detach()


class Exact:
    """float32 throughout (TF32 off: the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``)."""

    @staticmethod
    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    @staticmethod
    def act(t: torch.Tensor) -> torch.Tensor:
        return t


class FP8:
    """The control: what the program holds in bf16 held in fp8 (e4m3,
    one scale a row): every product's operands (w by column) and result,
    the residual stream and the recurrence's inputs; sums, softmax and
    recurrent states stay in float32."""

    @staticmethod
    def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _st(_st(x) @ _st(w, -2))

    @staticmethod
    def act(t: torch.Tensor) -> torch.Tensor:
        return _st(t)


PRECISION = {"exact": Exact, "fp8": FP8}


def get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """RMSNorm with the weight stored as an offset from 1: x / rms(x) ·
    (1 + scale)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on x (N, T, H, D) at positions 0 … T − 1, the two halves of D
    rotated as pairs (HF's ``rotate_half``)."""
    T, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * freqs
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean next-token cross-entropy over labels >= 0."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - ll) * mask).sum() / mask.sum().clamp_min(1)

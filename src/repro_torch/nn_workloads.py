"""Per-network layer tables for the end-to-end evaluation (paper §VI-A): the
port's copy of the reference's ``benchmarks/nn_workloads.py``.

Each network is a list of layers: (kind, dims, repeat, nontensor_elements)
with kind ∈ {conv, dwconv, gemm} — dims use the workload dim names from
:mod:`repro_torch.core.workload`.  Non-tensor elements (activations, norms,
softmax) run on the PPUs for LEGO and on the host CPU for the Gemmini
baseline (Fig. 12(b)).

Configurations follow the paper: 224×224×3 inputs (384 for EfficientNetV2),
BERT seq 16, GPT-2/LLaMA-7B prompt 1000 + 1 generated token.

The CNN topologies below are hand-maintained tables (they are network
architectures, not ``ModelConfig``s); the transformer entries (BERT, GPT-2,
LLaMA-7B) are **derived from the model-graph frontend**
(:func:`repro_torch.frontend.lower_model`) so there is exactly one config→workload
lowering in the repo — the ``NETWORKS`` keys stay the public interface for
:mod:`repro_torch.e2e`.  ``lm_head=False`` keeps the paper's transformer-
layers-only accounting.
"""

from __future__ import annotations

from .frontend import lower_model
from .models.common import BlockSpec, ModelConfig

__all__ = ["NETWORKS"]


def conv(n, ic, oc, hw, k, s=1, rep=1, nt=None):
    oh = hw // s
    d = dict(n=n, oc=oc, ic=ic, oh=oh, ow=oh, kh=k, kw=k)
    nt = nt if nt is not None else n * oc * oh * oh  # act/norm per output
    return ("conv", d, rep, nt)


def dwconv(n, c, hw, k, s=1, rep=1):
    oh = hw // s
    d = dict(n=n, c=c, oh=oh, ow=oh, kh=k, kw=k)
    return ("dwconv", d, rep, n * c * oh * oh)


def gemm(m, n_, k, rep=1, nt=None):
    return ("gemm", dict(i=m, j=n_, k=k), rep,
            nt if nt is not None else m * n_)


def _mbv2():
    # (t, c, n, s) table from the paper, 224×224
    layers = [conv(1, 3, 32, 224, 3, 2)]
    cin, hw = 32, 112
    for t, c, n, s in [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                       (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                       (6, 320, 1, 1)]:
        for i in range(n):
            stride = s if i == 0 else 1
            exp = cin * t
            if t != 1:
                layers.append(conv(1, cin, exp, hw, 1))
            layers.append(dwconv(1, exp, hw, 3, stride))
            hw = hw // stride
            layers.append(conv(1, exp, c, hw, 1))
            cin = c
    layers.append(conv(1, 320, 1280, 7, 1))
    layers.append(gemm(1, 1000, 1280))
    return layers


def _resnet50():
    layers = [conv(1, 3, 64, 224, 7, 2)]
    hw = 56
    cfg = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2),
           (512, 2048, 3, 2)]
    cin = 64
    for mid, out, n, s in cfg:
        for i in range(n):
            stride = s if i == 0 else 1
            layers.append(conv(1, cin, mid, hw, 1))
            layers.append(conv(1, mid, mid, hw, 3, stride))
            hw2 = hw // stride
            layers.append(conv(1, mid, out, hw2, 1))
            if i == 0:
                layers.append(conv(1, cin, out, hw, 1, stride))
            cin = out
            hw = hw2
    layers.append(gemm(1, 1000, 2048))
    return layers


def _alexnet():
    return [
        conv(1, 3, 64, 224, 11, 4), conv(1, 64, 192, 27, 5),
        conv(1, 192, 384, 13, 3), conv(1, 384, 256, 13, 3),
        conv(1, 256, 256, 13, 3),
        gemm(1, 4096, 9216), gemm(1, 4096, 4096), gemm(1, 1000, 4096),
    ]


def _effnetv2_s():
    # 384×384 input; fused-MBConv early, MBConv late (representative subset
    # with stage multiplicities)
    layers = [conv(1, 3, 24, 384, 3, 2)]
    hw, cin = 192, 24
    fused = [(1, 24, 2, 1), (4, 48, 4, 2), (4, 64, 4, 2)]
    for t, c, n, s in fused:
        for i in range(n):
            stride = s if i == 0 else 1
            layers.append(conv(1, cin, cin * t, hw, 3, stride))
            hw //= stride
            if t != 1:
                layers.append(conv(1, cin * t, c, hw, 1))
            cin = c
    mb = [(4, 128, 6, 2), (6, 160, 9, 1), (6, 256, 15, 2)]
    for t, c, n, s in mb:
        for i in range(n):
            stride = s if i == 0 else 1
            exp = cin * t
            layers.append(conv(1, cin, exp, hw, 1))
            layers.append(dwconv(1, exp, hw, 3, stride))
            hw //= stride
            layers.append(conv(1, exp, c, hw, 1))
            cin = c
    layers.append(conv(1, 256, 1280, hw, 1))
    layers.append(gemm(1, 1000, 1280))
    return layers


def _transformer(name, d, n_heads, d_ff, n_layers, *, glu=False,
                 activation="gelu"):
    """Dense-transformer ModelConfig for the frontend lowering (the head
    dim follows d_model // n_heads; MHA, no GQA — the paper's setups).
    The derived tables keep ``fused_attention=False``: these are the
    baseline-comparison shapes pinned by ``tests/test_model_graph.py``, one
    GEMM row per attention stage."""
    return ModelConfig(name=name, d_model=d, n_heads=n_heads,
                       n_kv_heads=n_heads, d_ff=d_ff, glu=glu,
                       activation=activation,
                       layer_pattern=(BlockSpec(kind="attn"),),
                       n_periods=n_layers)


_BERT = _transformer("bert-base", 768, 12, 3072, 12)
_GPT2 = _transformer("gpt2", 768, 12, 3072, 12)
_LLAMA7B = _transformer("llama-7b", 4096, 32, 11008, 32, glu=True,
                        activation="silu")


def _bert_base(seq=16):
    return lower_model(_BERT, seq=seq, lm_head=False,
                       fused_attention=False)


def _gpt2(prompt=1000):
    # one-token decode against a 1000-token prompt (paper setup)
    return lower_model(_GPT2, seq=prompt, phase="decode", lm_head=False,
                       fused_attention=False)


def _coatnet():
    # CoAtNet-0: conv stages (MBConv) then transformer stages, 224×224
    layers = [conv(1, 3, 64, 224, 3, 2), conv(1, 64, 96, 112, 3, 2)]
    hw, cin = 56, 96
    for c, n, s in [(96, 2, 1), (192, 3, 2)]:
        for i in range(n):
            stride = s if i == 0 else 1
            layers.append(conv(1, cin, cin * 4, hw, 1))
            layers.append(dwconv(1, cin * 4, hw, 3, stride))
            hw //= stride
            layers.append(conv(1, cin * 4, c, hw, 1))
            cin = c
    # transformer stages: 384d × 5 blocks @14², 768d × 2 blocks @7²
    for d, n, toks in [(384, 5, 196), (768, 2, 49)]:
        per = [gemm(toks, 3 * d, cin if cin != d else d),
               gemm(toks, toks, 64, rep=max(1, d // 64)),
               gemm(toks, 64, toks, rep=max(1, d // 64)),
               gemm(toks, d, d), gemm(toks, 4 * d, d), gemm(toks, d, 4 * d)]
        layers += [(k, dd, rep * n, nt) for (k, dd, rep, nt) in per]
        cin = d
    layers.append(gemm(1, 1000, 768))
    return layers


def _ddpm():
    # CIFAR-scale UNet (35M): 32×32, ch 128 with (1,2,2,2) multipliers,
    # 2 res blocks per level + attention at 16×16
    layers = []
    for ch, hw, n in [(128, 32, 4), (256, 16, 4), (256, 8, 4), (256, 4, 4)]:
        layers.append(conv(1, ch, ch, hw, 3, rep=2 * n))
    layers.append(gemm(256, 256, 256, rep=8))  # attention @16²
    return layers


def _stable_diffusion():
    # SD1.x UNet at 64×64 latent: res blocks + cross/self attention blocks
    layers = []
    for ch, hw, n in [(320, 64, 2), (640, 32, 2), (1280, 16, 2),
                      (1280, 8, 2)]:
        layers.append(conv(1, ch, ch, hw, 3, rep=2 * n))
        toks = hw * hw
        layers.append(gemm(toks, ch, ch, rep=2 * n))          # qkv-ish
        layers.append(gemm(toks, toks, ch // 8, rep=n))       # scores
        layers.append(gemm(toks, ch // 8, toks, rep=n))
        layers.append(gemm(toks, 4 * ch, ch, rep=n))          # FFN
        layers.append(gemm(toks, ch, 4 * ch, rep=n))
    return layers


def _llama7b(bs=1, prompt=1000):
    return lower_model(_LLAMA7B, seq=prompt, batch=bs, phase="decode",
                       lm_head=False, fused_attention=False)


NETWORKS = {
    "AlexNet": _alexnet,
    "MobileNetV2": _mbv2,
    "ResNet50": _resnet50,
    "EfficientNetV2": _effnetv2_s,
    "BERT": _bert_base,
    "GPT2": _gpt2,
    "CoAtNet": _coatnet,
    "DDPM": _ddpm,
    "StableDiffusion": _stable_diffusion,
    "LLaMA-7B-bs1": lambda: _llama7b(1),
    "LLaMA-7B-bs32": lambda: _llama7b(32),
}

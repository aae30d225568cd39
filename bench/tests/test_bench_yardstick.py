"""The yardstick against numbers worked by hand from the published
sizes."""

from __future__ import annotations

import json

import pytest

from benchlib import ROOT

from bench import arch, roofline


def _hp(name, layers):
    """A configuration's keys, at ``layers`` layers (the published depth
    where the file holds one pipeline stage)."""
    hp = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                    .read_text())
    return dict(hp, num_hidden_layers=layers)


def test_peaks_are_the_data_sheets():
    assert roofline.PEAK_FLOPS_BF16 == 989e12
    assert roofline.PEAK_BYTES == 3.35e12


def test_mistral_nemo_counts_and_weight_read_bound():
    hp, a = _hp("mistral_nemo_12b_pp10", 40), arch.load("dense_gqa")
    # a layer: q 5120x4096, kv 5120x2048, o 4096x5120, MLP 3 x 5120x14336
    layer = 5120 * 4096 + 5120 * 2048 + 4096 * 5120 + 3 * 5120 * 14336
    assert layer == 272_629_760
    head = 5120 * 131072
    assert a.matmul_params(hp) == 40 * layer + head
    total = 40 * layer + 2 * head + 2 * 40 * 5120 + 5120
    assert a.param_count(hp) == total == 12_247_782_400
    # every bf16 weight read once a step: 7.31 ms at 3.35 TB/s
    assert roofline.weight_read_bound_s(a, hp) * 1e3 == \
        pytest.approx(7.312, abs=5e-4)


def test_rwkv6_counts():
    hp, a = _hp("rwkv6_7b_pp4", 32), arch.load("rwkv6")
    d, f, r = 4096, 14336, 128
    layer = 6 * d * d + 2 * d * r + 2 * d * f
    assert a.matmul_params(hp) == 32 * layer + d * 65536
    assert a.param_count(hp) == 32 * layer + 2 * d * 65536 \
        + 32 * (5 * d + d + d + 2 * d) + d
    # a token's wkv: r.S and k (x) v into S, 64 heads of 64, 2 FLOPs each
    assert a.mixer_flops(hp, 0) == a.mixer_flops(hp, 999) == \
        32 * 4 * 4096 * 64


def test_k2_decode_bound_at_batch_4_over_4096_positions():
    # K and V: 2 x 4 x 8 x 4096 x 128 bf16 = 67.1 MB, q and o 65.5 kB:
    # 20.05 us at 3.35 TB/s; the operations take 0.27 us
    s = roofline.k2_decode_bound_s(4, 32, 8, 128, 4095)
    assert s * 1e3 == pytest.approx(0.02005, abs=1e-5)
    bytes_ = (2 * 4 * 8 * 4096 * 128 + 2 * 4 * 32 * 128) * 2
    assert s == bytes_ / 3.35e12


def test_mistral_nemo_train_step_flops_and_share():
    hp = _hp("mistral_nemo_12b_pp10", 4)
    a = arch.load("dense_gqa")
    layer = 272_629_760
    n = 4 * layer + 5120 * 131072
    T = 2048
    want = 6 * n * 2 * T + 6 * 4 * 2 * 32 * 128 * T * (T + 1)
    got = roofline.train_step_flops(a, hp, 2, T)
    assert got == want
    assert got == pytest.approx(4.41e13, rel=2e-3)
    # 8a's 391.8 ms step: 11.39% of the bf16 peak
    assert got / 0.3918 / roofline.PEAK_FLOPS_BF16 == \
        pytest.approx(0.1139, abs=5e-4)


def test_serve_call_flops_sums_each_position():
    hp, a = _hp("mistral_nemo_12b_pp10", 40), arch.load("dense_gqa")
    per_tok = 2 * a.matmul_params(hp)
    attn = 40 * 4 * 32 * 128
    want = 32 * (3 * per_tok + attn * (1 + 2 + 3))
    assert roofline.serve_call_flops(a, hp, 32, 3) == want

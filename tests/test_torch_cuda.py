"""The port's CUDA kernels against their plain versions, on the card.

These need an sm_90 card and skip elsewhere (the kernels have no CPU mode);
the file imports only torch and repro_torch, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_kernels.py: fp32 1e-5 (the GEMM, relative to
the output's largest magnitude: the kernel and cuBLAS sum K products in
other orders), 2e-4 (attention) and 1e-4 (the RWKV-6 and Mamba scans),
bf16 2e-2 (the GEMM) and 3e-2; the Mamba scan's bf16 y is rounded once
from fp32 on both sides, so it is held to one bf16 ulp (2^-7 relative).
The bf16 attention prefill and decode are also held to three bf16 ulps of
the plain version computed in fp32, relative to |want| plus its row's
rms; the bf16 RWKV-6 recurrence to one such ulp and to its chunked plain
version."""

import dataclasses

import pytest
import torch

from repro_torch.configs import PORTED_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels.autotile import (GEMM_TILES, attention_built_tiles,
                                         decode_splits, gemm_splits,
                                         gemm_tiles)
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 decode_attention_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.gemm import gemm_cuda
from repro_torch.kernels.rwkv6 import rwkv6_cuda
from repro_torch.kernels.ssm_scan import STATE_DIMS, ssm_scan_cuda
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import build_serve_step, generate

pytestmark = pytest.mark.cuda

TOLS = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# bf16 K2 prefill and decode against the plain version in fp32 from the
# same inputs, relative to |want| plus the row's rms
# (ref.attention_rel_err), as chip_smoke.py holds them: three bf16 ulps
BF16_REL_TOL = 3 * 2.0 ** -7
# bf16 K4 likewise (ref.rwkv6_rel_err): one bf16 ulp
RWKV_REL_TOL = 2.0 ** -7
# K3 inputs: dt after a softplus and the decays' range (_ssm_inputs)
SSM_DECAYS = ("softplus", "zero", "underflow", "mixed", "long_memory")
# K3's h_last (and, at long_memory, its fp32 y) relative to |want| plus
# the rms of want's row (ref.state_rel_err, ref.scan_rel_err), as
# chip_smoke.py's SCAN_ROW_TOL
SCAN_ROW_TOL = 2.0 ** -10
# the fp32 kernel and the fp32 plain scan over a long memory against the
# scan in float64, rtol = atol, as chip_smoke.py holds them
F64_KERNEL_TOL, F64_PLAIN_TOL = 1e-3, 2e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90); the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _assert_close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _assert_rel(got, q, k, v, **kw):
    """bf16: within BF16_REL_TOL of the fp32 plain version (fp32: nothing
    beyond the 2e-4 gate)."""
    if got.dtype == torch.bfloat16:
        err = R.attention_rel_err(got, q, k, v, **kw)
        assert err <= BF16_REL_TOL, f"rel_err {err:.3e} > {BF16_REL_TOL:g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Tq,Tk,D,causal,window,softcap,offset", [
    (4, 2, 64, 64, 128, True, None, None, 0),
    (8, 1, 100, 100, 256, True, 16, 50.0, 0),
    (4, 4, 33, 77, 128, False, None, None, 0),
    (4, 2, 40, 40, 16, True, 16, 30.0, 0),
    (4, 2, 16, 80, 32, True, None, None, 64),
])
def test_prefill_kernel_matches_plain(card, dtype, Hq, Hkv, Tq, Tk, D, causal,
                                      window, softcap, offset):
    gen = torch.Generator(card).manual_seed(0)
    q = _rand(gen, (2, Hq, Tq, D), dtype, card)
    k = _rand(gen, (2, Hkv, Tk, D), dtype, card)
    v = _rand(gen, (2, Hkv, Tk, D), dtype, card)
    kw = dict(causal=causal, window=window, softcap=softcap, offset=offset)
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    assert flash_attention_cuda.launches == before + 1
    _assert_close(got, R.attention_ref(q, k, v, **kw), TOLS[dtype])


# every instantiation: each dtype's own built tiles at each head_dim (bf16
# on the tensor cores, fp32 on the CUDA cores)
BUILT = [(dtype, D, bq, bk) for dtype in TOLS for D in HEAD_DIMS
         for bq, bk in attention_built_tiles(D, dtype.itemsize)]


@pytest.mark.parametrize("dtype,D,bq,bk", BUILT)
def test_every_built_tile_matches_plain(card, dtype, D, bq, bk):
    gen = torch.Generator(card).manual_seed(4)
    q = _rand(gen, (2, 4, 150, D), dtype, card)
    k = _rand(gen, (2, 2, 150, D), dtype, card)
    v = _rand(gen, (2, 2, 150, D), dtype, card)
    got = flash_attention_cuda(q, k, v, bq=bq, bk=bk, window=40, softcap=30.0)
    _assert_close(got, R.attention_ref(q, k, v, window=40, softcap=30.0),
                  TOLS[dtype])
    _assert_rel(got, q, k, v, window=40, softcap=30.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal,window,softcap,offset", [
    # ragged Tq and Tk with B*H > 1: a tile past T must read no row of the
    # next head and write none
    (2, 4, 2, 77, 150, 64, False, None, None, 0),
    (3, 4, 4, 33, 333, 96, True, None, None, 300),
    (4, 8, 8, 1, 1500, 64, False, None, None, 0),     # Whisper's cross step
    (1, 8, 2, 64, 512, 128, True, 256, None, 448),    # offset with a window
    (1, 4, 1, 100, 612, 128, True, 40, None, 512),
    (2, 4, 4, 130, 130, 64, True, None, None, 0),     # GQA group 1
    (2, 16, 4, 130, 130, 64, True, None, None, 0),    # group 4
    (1, 32, 1, 130, 130, 32, True, None, None, 0),    # group 32
    (2, 8, 4, 200, 200, 256, True, None, 50.0, 0),    # softcap at D = 256
    (1, 4, 2, 77, 130, 256, False, 30, 30.0, 0),
])
def test_prefill_kernel_ragged_heads_and_edges(card, dtype, B, Hq, Hkv, Tq,
                                               Tk, D, causal, window,
                                               softcap, offset):
    """Every (batch, head) output of the dtype's kernel, at every tile it
    builds, against the plain version."""
    gen = torch.Generator(card).manual_seed(11)
    q = _rand(gen, (B, Hq, Tq, D), dtype, card)
    k = _rand(gen, (B, Hkv, Tk, D), dtype, card)
    v = _rand(gen, (B, Hkv, Tk, D), dtype, card)
    kw = dict(causal=causal, window=window, softcap=softcap, offset=offset)
    want = R.attention_ref(q, k, v, **kw)
    for bq, bk in attention_built_tiles(D, dtype.itemsize):
        got = flash_attention_cuda(q, k, v, bq=bq, bk=bk, **kw)
        torch.cuda.synchronize()
        for b in range(B):
            for h in range(Hq):
                torch.testing.assert_close(
                    got[b, h].float(), want[b, h].float(), rtol=TOLS[dtype],
                    atol=TOLS[dtype], msg=lambda m: f"tile ({bq}, {bk}) "
                    f"b={b} h={h}: {m}")
        _assert_rel(got, q, k, v, **kw)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (1, 32, 8, 2048, 2048, 128, True),     # Mistral-NeMo
    (1, 32, 32, 2048, 2048, 96, True),     # Phi-3-vision
    (4, 8, 8, 1500, 1500, 64, False),      # Whisper's encoder
    (4, 8, 8, 1, 1500, 64, False),         # Whisper's cross step
])
def test_bf16_prefill_holds_to_fp32_plain_at_main_path_shapes(
        card, B, Hq, Hkv, Tq, Tk, D, causal):
    """At the shapes the models run, where long rows average many keys and
    their outputs are small, the 3e-2 gate is loose; the row-relative one
    is not."""
    gen = torch.Generator(card).manual_seed(7)
    q = _rand(gen, (B, Hq, Tq, D), torch.bfloat16, card)
    k = _rand(gen, (B, Hkv, Tk, D), torch.bfloat16, card)
    v = _rand(gen, (B, Hkv, Tk, D), torch.bfloat16, card)
    got = ops.flash_attention(q, k, v, causal=causal)
    _assert_close(got, R.attention_ref(q, k, v, causal=causal),
                  TOLS[torch.bfloat16])
    _assert_rel(got, q, k, v, causal=causal)


@pytest.mark.parametrize("B,Hq,Hkv,T,D,window,softcap", [
    (1, 16, 16, 2048, 256, None, None),    # Gemma-7B
    (1, 16, 8, 8192, 256, 4096, 50.0),     # Gemma-2, a windowed layer
    (1, 32, 2, 2048, 128, None, None),     # GLM-4, group 16
    (1, 40, 8, 2048, 128, None, None),     # Llama-4-Scout, group 5
])
def test_bf16_prefill_at_the_full_configs_shapes(card, B, Hq, Hkv, T, D,
                                                 window, softcap):
    """Causal bf16 prefill at the full shapes of the configs chip_smoke.py
    serves in phases 4g-4k (head_dim 256 on its one bf16 tile, 8192
    positions with Gemma-2's window and softcap, groups 16 and 5), within
    3e-2 and the row-relative gate."""
    gen = torch.Generator(card).manual_seed(8)
    q = _rand(gen, (B, Hq, T, D), torch.bfloat16, card)
    k = _rand(gen, (B, Hkv, T, D), torch.bfloat16, card)
    v = _rand(gen, (B, Hkv, T, D), torch.bfloat16, card)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    _assert_close(got, R.attention_ref(q, k, v, **kw), TOLS[torch.bfloat16])
    _assert_rel(got, q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [
    (32, 2, 128),     # GLM-4: group 16, two blocks of 8 rows a group
    (40, 8, 128),     # Llama-4-Scout: group 5, one block, 3 rows padded
    (16, 16, 256),    # Gemma-7B: head_dim 256 at group 1
])
def test_decode_at_the_full_configs_groups(card, dtype, Hq, Hkv, D):
    """Split-KV decode at batch 4 over a 4096-position cache at the groups
    and head_dim the configs of phases 4g-4k reach, pos at 0, 100, the
    chunk edges, S/2 and S - 1, against the plain version."""
    gen = torch.Generator(card).manual_seed(9)
    S = 4096
    q = _rand(gen, (4, Hq, 1, D), dtype, card)
    k = _rand(gen, (4, Hkv, S, D), dtype, card)
    v = _rand(gen, (4, Hkv, S, D), dtype, card)
    L, _ = decode_splits(4, Hkv, Hq // Hkv, S, D, q.element_size())
    for pos in sorted({0, 100, L - 1, L, S // 2, S - 1}):
        pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
        got = ops.decode_attention(q, k, v, pos=pos_t)
        _assert_close(got, R.decode_attention_ref(q, k, v, pos=pos),
                      TOLS[dtype])
        _assert_rel(got, q, k, v, causal=True, offset=pos)


def test_prefill_wrapper_refuses_unbuilt_tiles(card):
    """A tile that the dtype's kernel does not build is refused before any
    launch: the fp32 tiles in bf16, the bf16 tiles in fp32, and the bf16
    tiles that do not fit at head_dim 256 (shared memory or registers)."""
    before = flash_attention_cuda.launches
    for dtype, D, bq, bk in ((torch.bfloat16, 64, 16, 32),
                             (torch.bfloat16, 64, 64, 32),
                             (torch.float32, 64, 128, 128),
                             (torch.bfloat16, 256, 128, 128),
                             (torch.bfloat16, 256, 128, 64),
                             (torch.bfloat16, 256, 64, 128)):
        q = torch.zeros((1, 2, 8, D), device=card, dtype=dtype)
        with pytest.raises(ValueError, match="not built"):
            flash_attention_cuda(q, q, q, bq=bq, bk=bk)
    assert flash_attention_cuda.launches == before


def test_bf16_prefill_takes_the_tensor_core_kernel(card):
    """The library reports the kernel it launched: the tensor-core one for
    bf16, the CUDA-core one for fp32."""
    q = torch.zeros((1, 2, 8, 64), device=card, dtype=torch.bfloat16)
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.tensor_core_launches)
    ops.flash_attention(q, q, q)
    ops.flash_attention(q.float(), q.float(), q.float())
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.tensor_core_launches) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("S", [300, 4096, 4097])
def test_decode_kernel_matches_plain(card, dtype, D, group, S):
    """Split-KV decode against the plain version, with pos at 0, at the
    chunk edges L - 1 and L and at S - 1, no window, a window of 16 with a
    softcap, and a window of L/2 + 3 (it crosses a chunk edge or leaves
    whole chunks out); bf16 also within 3 bf16 ulps of the fp32 plain
    version.  One launch a call, a split launch when there are splits."""
    gen = torch.Generator(card).manual_seed(1)
    Hkv = 2
    q = _rand(gen, (2, Hkv * group, 1, D), dtype, card)
    k = _rand(gen, (2, Hkv, S, D), dtype, card)
    v = _rand(gen, (2, Hkv, S, D), dtype, card)
    L, splits = decode_splits(2, Hkv, group, S, D, q.element_size())
    before = (decode_attention_cuda.launches,
              decode_attention_cuda.split_launches)
    calls = 0
    for pos in sorted({0, L - 1, L, S - 1} & set(range(S))):
        pos_t = torch.tensor(pos, dtype=torch.int32, device=card)
        for window, softcap in ((None, None), (16, 30.0), (L // 2 + 3, None)):
            got = ops.decode_attention(q, k, v, window=window,
                                       softcap=softcap, pos=pos_t)
            calls += 1
            want = R.decode_attention_ref(q, k, v, window=window,
                                          softcap=softcap, pos=pos)
            _assert_close(got, want, TOLS[dtype])
            _assert_rel(got, q, k, v, causal=True, offset=pos, window=window,
                        softcap=softcap)
    assert (decode_attention_cuda.launches,
            decode_attention_cuda.split_launches) == \
        (before[0] + calls, before[1] + calls * (splits > 1))


def test_decode_captured_in_a_cuda_graph_replays_each_pos(card):
    """``ops.decode_attention`` captured once in a CUDA graph and replayed
    with three positions written into the captured ``pos`` tensor equals
    the eager call at each: the splits come from the shapes and nothing
    makes the host wait, as the captured serve step will need."""
    gen = torch.Generator(card).manual_seed(2)
    q = _rand(gen, (4, 32, 1, 128), torch.bfloat16, card)
    k = _rand(gen, (4, 8, 4096, 128), torch.bfloat16, card)
    v = _rand(gen, (4, 8, 4096, 128), torch.bfloat16, card)
    assert decode_splits(4, 8, 4, 4096, 128, 2)[1] > 1
    pos = torch.zeros((), dtype=torch.int32, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):   # warm-up: builds and loads the library
        ops.decode_attention(q, k, v, pos=pos, window=1000)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, pos=pos, window=1000)
    for p in (4095, 300, 256):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        eager = ops.decode_attention(q, k, v, pos=pos, window=1000)
        torch.testing.assert_close(out, eager, rtol=0, atol=0)
        _assert_close(out, R.decode_attention_ref(q, k, v, pos=p,
                                                  window=1000), 3e-2)


def test_wrappers_reject_what_the_kernel_does_not_take(card):
    q = torch.zeros((1, 2, 8, 48), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q, bq=16, bk=32)
    q = torch.zeros((1, 2, 8, 16), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(2, 3), q, q, bq=16, bk=32)
    with pytest.raises(ValueError, match="pos"):
        decode_attention_cuda(q[:, :, :1].contiguous(), q, q,
                              torch.tensor(3, device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,Tq,Tk", [(True, 2048, 2048),
                                          (False, 150, 1500),
                                          (False, 1, 1500)])
def test_prefill_kernel_head_dim_96(card, dtype, causal, Tq, Tk):
    """Phi-3-vision's head_dim: causal at its prefill length, and
    non-causal over Whisper's ragged 1500-frame key range."""
    gen = torch.Generator(card).manual_seed(9)
    q = _rand(gen, (1, 4, Tq, 96), dtype, card)
    k = _rand(gen, (1, 4, Tk, 96), dtype, card)
    v = _rand(gen, (1, 4, Tk, 96), dtype, card)
    _assert_close(ops.flash_attention(q, k, v, causal=causal),
                  R.attention_ref(q, k, v, causal=causal), TOLS[dtype])


def _gemm_close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.float32:
        scale = want.abs().max().clamp_min(1.0)
        assert (got - want).abs().max() <= 1e-5 * scale
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,K", [
    (32, 32, 64), (64, 48, 32), (16, 128, 16),   # tests/test_kernels.py:32
    (33, 45, 70),                                # the ragged case
    (1, 5120, 5120), (7, 4096, 1024),            # decode-shaped
    (100, 123, 77), (257, 250, 1001),            # K, N not multiples of 8
    (512, 512, 512),
])
def test_gemm_kernel_matches_plain(card, dtype, M, N, K):
    gen = torch.Generator(card).manual_seed(M + N + K)
    x, w = _rand(gen, (M, K), dtype, card), _rand(gen, (K, N), dtype, card)
    before = gemm_cuda.launches
    got = ops.gemm(x, w)
    assert gemm_cuda.launches == before + 1
    _gemm_close(got, R.gemm_ref(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_built_gemm_tile_matches_plain(card, dtype):
    gen = torch.Generator(card).manual_seed(5)
    for M, N, K in ((150, 200, 96), (150, 203, 97)):   # aligned, unaligned
        x, w = _rand(gen, (M, K), dtype, card), _rand(gen, (K, N), dtype,
                                                      card)
        want = R.gemm_ref(x, w)
        for bm, bn, bk in GEMM_TILES[x.element_size()]:
            _gemm_close(gemm_cuda(x, w, bm=bm, bn=bn, bk=bk), want, dtype)
    # an operand that is not 16-byte aligned takes the element-wise loads
    x = _rand(gen, (64 * 64 + 1,), dtype, card)[1:].view(64, 64)
    assert x.data_ptr() % 16 and x.is_contiguous()
    w = _rand(gen, (64, 64), dtype, card)
    _gemm_close(ops.gemm(x, w), R.gemm_ref(x, w), dtype)


def test_gemm_wrapper_rejects_what_the_kernel_does_not_take(card):
    x = torch.zeros((16, 32), device=card)
    w = torch.zeros((32, 64), device=card)
    with pytest.raises(ValueError, match="inner dimensions"):
        gemm_cuda(x, w[:16].contiguous(), bm=16, bn=64, bk=16)
    with pytest.raises(ValueError, match="mixed dtypes"):
        gemm_cuda(x, w.bfloat16(), bm=16, bn=64, bk=16)
    with pytest.raises(ValueError, match="not supported"):
        gemm_cuda(x.half(), w.half(), bm=16, bn=64, bk=32)
    with pytest.raises(ValueError, match="contiguous"):
        gemm_cuda(x, torch.zeros((64, 32), device=card).T, bm=16, bn=64,
                  bk=16)
    with pytest.raises(ValueError, match="not built"):
        gemm_cuda(x, w, bm=32, bn=64, bk=16)
    with pytest.raises(ValueError, match="2-D"):
        gemm_cuda(x[None], w, bm=16, bn=64, bk=16)
    xb, wb = x.bfloat16(), w.bfloat16()
    for tile in ((16, 64, 32), (128, 128, 32), (64, 256, 64), (128, 192, 64)):
        with pytest.raises(ValueError, match="not built"):
            gemm_cuda(xb, wb, bm=tile[0], bn=tile[1], bk=tile[2])
    with pytest.raises(ValueError, match="splits"):
        gemm_cuda(xb, wb, bm=128, bn=128, bk=64, splits=2)   # one k-step
    with pytest.raises(ValueError, match="splits"):
        gemm_cuda(x, w, bm=16, bn=64, bk=16, splits=0)


def _gemm_rel(got, x, w):
    """bf16: within 2 bf16 ulps of the fp32 product, relative to |want|
    plus the row's rms (ref.gemm_rel_err), as chip_smoke.py holds it."""
    if got.dtype == torch.bfloat16:
        err = R.gemm_rel_err(got, x, w)
        assert err <= 2 * 2.0 ** -7, f"gemm rel_err {err:.3e}"


# the wgmma kernel's edges: M, N, K not multiples of the tile (K, N
# multiples of 8, as TMA needs), K below one 64-deep k-step, M below one
# warpgroup's 64 rows, M = 1
WGMMA_EDGES = [(200, 392, 328), (130, 264, 40), (33, 520, 136), (1, 1000, 2000),
               (64, 136, 8), (129, 8, 72)]


@pytest.mark.parametrize("tile", GEMM_TILES[2])
@pytest.mark.parametrize("M,N,K", WGMMA_EDGES)
def test_every_wgmma_tile_at_ragged_aligned_shapes(card, tile, M, N, K):
    gen = torch.Generator(card).manual_seed(M + N + K)
    x = _rand(gen, (M, K), torch.bfloat16, card)
    w = _rand(gen, (K, N), torch.bfloat16, card)
    want = R.gemm_ref(x, w)
    steps = -(-K // tile[2])
    for splits in sorted({1, min(3, steps),
                          gemm_splits(M, N, K, tile, 2)}):
        before = gemm_cuda.wgmma_launches
        got = gemm_cuda(x, w, bm=tile[0], bn=tile[1], bk=tile[2],
                        splits=splits)
        assert gemm_cuda.wgmma_launches == before + 1
        _gemm_close(got, want, torch.bfloat16)
        _gemm_rel(got, x, w)


@pytest.mark.parametrize("tile", GEMM_TILES[2])
def test_wgmma_persistent_walk_over_more_tiles_than_blocks(card, tile):
    """More output tiles than SMs: each block walks several tiles of the
    grouped raster, the ring carrying on from one tile to the next."""
    M, N, K = 2176, 4104, 200   # ragged in M and N, 17 x 17+ tiles
    assert -(-M // tile[0]) * -(-N // tile[1]) > \
        torch.cuda.get_device_properties(card).multi_processor_count
    gen = torch.Generator(card).manual_seed(3)
    x = _rand(gen, (M, K), torch.bfloat16, card)
    w = _rand(gen, (K, N), torch.bfloat16, card)
    got = gemm_cuda(x, w, bm=tile[0], bn=tile[1], bk=tile[2], splits=1)
    _gemm_close(got, R.gemm_ref(x, w), torch.bfloat16)
    _gemm_rel(got, x, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,K", [(512, 512, 512), (1, 5120, 5120),
                                   (7, 5120, 5120)])
def test_gemm_split_k_is_deterministic(card, dtype, M, N, K):
    """The split-K path (autotile's split, and 4 splits at 512^3 where the
    bf16 pick runs unsplit) against the plain version, and two calls give
    the same bits: the partials are summed in a fixed order."""
    gen = torch.Generator(card).manual_seed(7)
    x, w = _rand(gen, (M, K), dtype, card), _rand(gen, (K, N), dtype, card)
    want = R.gemm_ref(x, w)
    t = gemm_tiles(M, N, K, dtype.itemsize)
    picked = gemm_splits(M, N, K, t, dtype.itemsize)
    assert picked > 1 or (M, dtype) == (512, torch.bfloat16)
    for splits in sorted({picked, 4}):
        call = lambda: gemm_cuda(x, w, bm=t.bm, bn=t.bn, bk=t.bk,
                                 splits=splits)
        first, second = call(), call()
        _gemm_close(first, want, dtype)
        _gemm_rel(first, x, w)
        assert torch.equal(first, second)
    assert torch.equal(ops.gemm(x, w), ops.gemm(x, w))


def test_gemm_wgmma_route_is_reported(card):
    """gemm_cuda.wgmma_launches rises by one for an aligned bf16 call (the
    library reports the wgmma kernel) and not for an unaligned one (K % 8)
    nor for a misaligned operand nor for fp32."""
    gen = torch.Generator(card).manual_seed(8)
    x = _rand(gen, (100, 96), torch.bfloat16, card)
    w = _rand(gen, (96, 120), torch.bfloat16, card)
    cases = [(x, w, 1), (x[:, :77].contiguous(), w[:77].contiguous(), 0),
             (_rand(gen, (100 * 96 + 1,), torch.bfloat16, card)[1:].view(
                 100, 96), w, 0), (x.float(), w.float(), 0)]
    for a, b, rise in cases:
        before = (gemm_cuda.launches, gemm_cuda.wgmma_launches)
        got = ops.gemm(a, b)
        assert (gemm_cuda.launches, gemm_cuda.wgmma_launches) == \
            (before[0] + 1, before[1] + rise)
        _gemm_close(got, R.gemm_ref(a, b), a.dtype)


def test_gemm_captured_in_a_cuda_graph_replays_to_the_eager_result(card):
    """ops.gemm captured once in a CUDA graph (a split decode-shaped
    product, whose workspace comes from the caching allocator, and an
    unsplit one; the tensor maps are kernel parameters) and replayed over
    new operands equals the eager calls."""
    gen = torch.Generator(card).manual_seed(9)
    shapes = ((1, 5120, 5120), (300, 1024, 512))
    xs = [_rand(gen, (M, K), torch.bfloat16, card) for M, N, K in shapes]
    ws = [_rand(gen, (K, N), torch.bfloat16, card) for M, N, K in shapes]
    assert gemm_splits(1, 5120, 5120, gemm_tiles(1, 5120, 5120, 2), 2) > 1
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):   # warm-up: builds and loads the library
        for x, w in zip(xs, ws):
            ops.gemm(x, w)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.gemm(x, w) for x, w in zip(xs, ws)]
    for seed in (10, 11):
        g2 = torch.Generator(card).manual_seed(seed)
        for x, w in zip(xs, ws):
            x.copy_(_rand(g2, tuple(x.shape), torch.bfloat16, card))
            w.copy_(_rand(g2, tuple(w.shape), torch.bfloat16, card))
        graph.replay()
        torch.cuda.synchronize()
        for out, x, w in zip(outs, xs, ws):
            torch.testing.assert_close(out, ops.gemm(x, w), rtol=0, atol=0)
            _gemm_rel(out, x, w)


def _rwkv_inputs(gen, B, H, T, D, dtype, dev, decay="sigmoid"):
    """r, k, v, w, u as tests/test_kernels.py draws them: w in (0, 1); the
    other decays as chip_smoke.py and tests/test_torch_kernels.py draw them
    (w = 0, w = 1e-30, w = 1 exactly, strong and mild mixed)."""
    r = _rand(gen, (B, H, T, D), dtype, dev)
    k = (torch.randn((B, H, T, D), generator=gen, device=dev) * 0.3).to(dtype)
    v = _rand(gen, (B, H, T, D), dtype, dev)
    w = torch.sigmoid(torch.randn((B, H, T, D), generator=gen, device=dev)
                      + 2.0)
    if decay == "zero":
        w[..., ::3, :] = 0.0
    elif decay == "tiny":
        w[..., 1::2, :] = 1e-30
    elif decay == "one":
        w[..., ::2] = 1.0
        w[..., ::4, :] = 1.0
    elif decay == "mixed":
        strong = 10.0 ** (-6.0 + 3.0 * torch.rand(w.shape, generator=gen,
                                                  device=dev))
        mild = 0.95 + 0.049 * torch.rand(w.shape, generator=gen, device=dev)
        w = torch.where(torch.rand(w.shape, generator=gen, device=dev) < 0.3,
                        strong, mild)
    u = (torch.randn((H, D), generator=gen, device=dev) * 0.1).to(dtype)
    return r, k, v, w.to(dtype), u


def _rwkv_check(o, s, args):
    """o at the dtype's tolerance, S_last at 1e-4; bf16 also within one
    bf16 ulp of the fp32 plain version (ref.rwkv6_rel_err) and against the
    chunked plain version, the kernel's own algorithm."""
    bf16 = o.dtype == torch.bfloat16
    tol = 3e-2 if bf16 else 1e-4
    o_ref, s_ref = R.rwkv6_ref(*args)
    _assert_close(o, o_ref, tol)
    _assert_close(s, s_ref, 1e-4)
    if bf16:
        rel = R.rwkv6_rel_err(o, *args)
        assert rel <= RWKV_REL_TOL, f"rel_err {rel:.3e} > {RWKV_REL_TOL:g}"
        o_c, s_c = R.rwkv6_chunked_ref(*args)
        _assert_close(o, o_c, tol)
        _assert_close(s, s_c, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("B,H", [(1, 64), (2, 4)])
@pytest.mark.parametrize("T", [1, 16, 77, 2048])
def test_rwkv6_kernel_matches_plain(card, dtype, D, B, H, T):
    """o at the dtype's tolerance; S_last is fp32 from the same rounded
    inputs on both sides, so it is held at the scan's fp32 1e-4."""
    gen = torch.Generator(card).manual_seed(5)
    args = _rwkv_inputs(gen, B, H, T, D, dtype, card)
    before = (rwkv6_cuda.launches, rwkv6_cuda.tensor_core_launches)
    o, s = ops.rwkv6(*args)
    assert rwkv6_cuda.launches == before[0] + 1
    assert rwkv6_cuda.tensor_core_launches == before[1] + int(
        dtype == torch.bfloat16)
    assert o.dtype == dtype and s.dtype == torch.float32
    _rwkv_check(o, s, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("decay", ["zero", "tiny", "one", "mixed"])
@pytest.mark.parametrize("B,H,T", [(2, 4, 131), (1, 8, 2048)])
def test_rwkv6_kernel_across_decays(card, dtype, D, decay, B, H, T):
    """Decays across the range a trained RWKV-6 has, w = 0, 1e-30 and 1
    exactly included, at a ragged T over three chunks and over 32; bf16 on
    the tensor-core kernel, as the library reports it."""
    gen = torch.Generator(card).manual_seed(7)
    args = _rwkv_inputs(gen, B, H, T, D, dtype, card, decay)
    before = rwkv6_cuda.tensor_core_launches
    o, s = rwkv6_cuda(*args)
    assert rwkv6_cuda.tensor_core_launches == before + int(
        dtype == torch.bfloat16)
    _rwkv_check(o, s, args)


def test_rwkv6_wrapper_rejects_what_the_kernel_does_not_take(card):
    gen = torch.Generator(card).manual_seed(6)
    r, k, v, w, u = _rwkv_inputs(gen, 1, 2, 8, 16, torch.float32, card)
    with pytest.raises(ValueError, match="not built"):
        rwkv6_cuda(*_rwkv_inputs(gen, 1, 2, 8, 32, torch.float32, card))
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_cuda(r.transpose(2, 3), k, v, w, u)
    with pytest.raises(ValueError, match="mixed dtypes"):
        rwkv6_cuda(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="not supported"):
        rwkv6_cuda(*(t.half() for t in (r, k, v, w, u)))
    with pytest.raises(ValueError, match="u has shape"):
        rwkv6_cuda(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(r.numel() + 1, device=card)
        rwkv6_cuda(flat[1:].view(r.shape), k, v, w, u)


def _ssm_inputs(gen, Bt, L, Dm, N, dtype, dev, decay="softplus"):
    """x, dt, A, B, C, D as tests/test_kernels.py draws them (dt after a
    softplus, A < 0); A and D fp32, as the Mamba block passes them.  Other
    ``decay``s cover exp(dt·A)'s range as chip_smoke.py draws them: dt = 0
    on every third step, A = -1e5 on the odd states (dt·A below -104),
    strong (|A| 5 to 50) and mild (|A| 0.02 to 0.2) decays mixed 30/70
    over (d, n), and ``long_memory`` |A| log-uniform in [1e-3, 5e-2] (h
    remembers hundreds to thousands of steps, as in a trained Mamba)."""
    x = _rand(gen, (Bt, L, Dm), dtype, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, L, Dm), generator=gen, device=dev) - 1.0)
    if decay == "zero":
        dt[:, ::3] = 0.0
    dt = dt.to(dtype)
    A = -torch.exp(0.5 * torch.randn((Dm, N), generator=gen, device=dev))
    if decay == "underflow":
        A[:, 1::2] = -1e5
    elif decay == "mixed":
        unit = lambda: torch.rand(A.shape, generator=gen, device=dev)
        strong, mild = 5.0 * 10.0 ** unit(), 0.02 * 10.0 ** unit()
        A = -torch.where(unit() < 0.3, strong, mild)
    elif decay == "long_memory":
        A = -1e-3 * 50.0 ** torch.rand((Dm, N), generator=gen, device=dev)
    B = _rand(gen, (Bt, L, N), dtype, dev)
    C = _rand(gen, (Bt, L, N), dtype, dev)
    D = torch.full((Dm,), 0.5, device=dev)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", STATE_DIMS)
@pytest.mark.parametrize("Bt,L,Dm", [(1, 2048, 16384), (2, 77, 48),
                                     (2, 1, 32), (2, 16, 32), (3, 45, 37)])
@pytest.mark.parametrize("decay", SSM_DECAYS)
def test_ssm_scan_kernel_matches_plain(card, dtype, N, Bt, L, Dm, decay):
    """Through ops.ssm_scan: y at 1e-4 (fp32) or one bf16 ulp, h_last at
    1e-4 and within SCAN_ROW_TOL of its (b, d) row (ref.state_rel_err), a
    bf16 y also within one ulp of the fp32 plain version relative to its
    row's scale (ref.scan_rel_err).  Over a long memory the exps' rounding
    compounds past 1e-4 of h, so there fp32 y and h_last are held by the
    row gates alone.  Dm = 37 takes the element-wise loads."""
    gen = torch.Generator(card).manual_seed(7)
    args = _ssm_inputs(gen, Bt, L, Dm, N, dtype, card, decay)
    before = ssm_scan_cuda.launches
    y, h = ops.ssm_scan(*args)
    assert ssm_scan_cuda.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y_ref, h_ref = R.selective_scan_ref(*args)
    long = decay == "long_memory"
    if dtype == torch.bfloat16:
        _assert_close(y, y_ref, 2.0 ** -7)
        assert R.scan_rel_err(y, *args) <= 2.0 ** -7
    elif long:
        assert R.scan_rel_err(y, *args) <= SCAN_ROW_TOL
    else:
        _assert_close(y, y_ref, 1e-4)
    if not long:
        _assert_close(h, h_ref, 1e-4)
    assert R.state_rel_err(h, *args) <= SCAN_ROW_TOL


@pytest.mark.parametrize("N", STATE_DIMS)
def test_ssm_scan_fp32_long_memory_holds_to_float64(card, N):
    """The fp32 route over a long memory at the main shape against
    selective_scan_ref run in float64 on the same inputs, the arbiter of
    the kernel and of the fp32 plain scan.  Neither holds to the fp32
    scans' 1e-4 there (the kernel's ex2.approx and the card's expf round
    decays near 1 with a bias that compounds over h's memory, and y sums
    N states of h): each is held at the tolerance measured, rtol = atol =
    F64_KERNEL_TOL and F64_PLAIN_TOL (chip_smoke.py's)."""
    gen = torch.Generator(card).manual_seed(7)
    args = _ssm_inputs(gen, 1, 2048, 16384, N, torch.float32, card,
                       "long_memory")
    y64, h64 = R.selective_scan_ref(*(t.double() for t in args))
    for (y, h), tol in ((ops.ssm_scan(*args), F64_KERNEL_TOL),
                        (R.selective_scan_ref(*args), F64_PLAIN_TOL)):
        torch.testing.assert_close(y.double(), y64, rtol=tol, atol=tol)
        torch.testing.assert_close(h.double(), h64, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_misaligned_operands(card, dtype):
    """x, dt, B and C one element past a 16-byte boundary, through
    ops.ssm_scan: all four take the element-wise loads."""
    gen = torch.Generator(card).manual_seed(13)
    args = list(_ssm_inputs(gen, 2, 70, 64, 16, dtype, card, "mixed"))

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    for i in (0, 1, 3, 4):       # x, dt, B, C
        args[i] = shifted(args[i])
    assert args[0].data_ptr() % 16 != 0 and args[3].data_ptr() % 16 != 0
    y, h = ops.ssm_scan(*args)
    y_ref, h_ref = R.selective_scan_ref(*args)
    _assert_close(y, y_ref, 1e-4 if dtype == torch.float32 else 2.0 ** -7)
    _assert_close(h, h_ref, 1e-4)


def test_ssm_scan_in_a_cuda_graph(card):
    """ops.ssm_scan captured in a CUDA graph and replayed on new inputs
    gives what an eager call gives on them."""
    gen = torch.Generator(card).manual_seed(12)
    args = _ssm_inputs(gen, 1, 200, 1024, 16, torch.bfloat16, card)
    ops.ssm_scan(*args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, h = ops.ssm_scan(*args)
    new = _ssm_inputs(gen, 1, 200, 1024, 16, torch.bfloat16, card, "mixed")
    for t, n in zip(args, new):
        t.copy_(n)
    g.replay()
    torch.cuda.synchronize()
    y_e, h_e = ops.ssm_scan(*new)
    assert torch.equal(y, y_e) and torch.equal(h, h_e)


def test_ssm_scan_wrapper_rejects_what_the_kernel_does_not_take(card):
    gen = torch.Generator(card).manual_seed(8)
    x, dt, A, B, C, D = _ssm_inputs(gen, 1, 8, 32, 16, torch.float32, card)
    with pytest.raises(ValueError, match="not built"):
        ssm_scan_cuda(*_ssm_inputs(gen, 1, 8, 32, 32, torch.float32, card))
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == x.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan_cuda(strided, dt, A, B, C, D)
    with pytest.raises(ValueError, match="mixed dtypes"):
        ssm_scan_cuda(x, dt.bfloat16(), A, B, C, D)
    with pytest.raises(ValueError, match="float32"):
        ssm_scan_cuda(x, dt, A.bfloat16(), B, C, D)
    with pytest.raises(ValueError, match="not supported"):
        ssm_scan_cuda(x.half(), dt.half(), A, B.half(), C.half(), D)
    with pytest.raises(ValueError, match="C has shape"):
        ssm_scan_cuda(x, dt, A, B, C[:, :4].contiguous(), D)


def _chunked_inputs(kind, dev):
    gen = torch.Generator().manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    if kind == "scan":
        x, B, C = rand(2, 64, 24), rand(2, 64, 8), rand(2, 64, 8)
        dt = torch.nn.functional.softplus(rand(2, 64, 24) - 1.0)
        A, D = -torch.exp(0.5 * rand(24, 8)), rand(24)
        args, fn = (x, dt, A, B, C, D), R.chunked_selective_scan_ref
    else:
        r, v = rand(2, 4, 64, 16), rand(2, 4, 64, 16)
        k, w = 0.3 * rand(2, 4, 64, 16), torch.sigmoid(rand(2, 4, 64, 16) + 2)
        args, fn = (r, k, v, w, 0.1 * rand(4, 16)), R.chunked_rwkv6_ref
    n_in = 4 if kind == "rwkv" else 5
    return fn, [a.to(dev).requires_grad_(i < n_in) for i, a in enumerate(args)]


@pytest.mark.parametrize("kind", ["scan", "rwkv"])
def test_chunked_forms_on_the_card_match_the_cpu(card, kind):
    """The plain path's chunked scans (what training and the dry run take
    above chunk_threshold) in fp32 on the card, TF32 off, against the CPU
    on the same inputs at chunk 16 over 64 steps: outputs, final states and
    the gradients of a scalar of both within 1e-4."""
    out = {}
    for dev in (torch.device("cpu"), card):
        fn, args = _chunked_inputs(kind, dev)
        y, h = fn(*args, chunk=16)
        loss = (y * torch.linspace(-1, 1, y.shape[-1], device=dev)).sum() \
            + h.square().sum()
        grads = torch.autograd.grad(loss, [a for a in args if a.requires_grad])
        out[dev.type] = [t.detach().cpu() for t in (y, h, *grads)]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [a for a in PORTED_IDS if a != "whisper_base"])
def test_model_kernel_path_matches_plain_path(card, arch):
    """fp32 smoke width: the kernels against the plain path, forward and
    teacher-forced decode, and identical greedy tokens.  Capacity factor
    8.0, so that an MoE layer drops no token in the forward or a step
    (their drops differ by design at the config's factor)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32",
                              capacity_factor=8.0)
    params = TF.init_params(cfg, torch.Generator(card).manual_seed(2), card)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=card,
                         dtype=torch.int32,
                         generator=torch.Generator(card).manual_seed(3))
    fwd, _ = TF.forward(params, toks, cfg)
    _assert_close(fwd, TF.forward(params, toks, cfg, backend="ref")[0], 1e-4)
    state = TF.init_decode_state(cfg, 2, 20, device=card)
    for t in range(20):
        lt, state = TF.decode_step(params, state, toks[:, t], t, cfg)
        _assert_close(lt, fwd[:, t], 1e-4)
    assert torch.equal(generate(params, cfg, toks[:, :8], 6),
                       generate(params, cfg, toks[:, :8], 6, backend="ref"))


def test_encdec_kernel_path_matches_plain_path(card):
    """Whisper smoke width in fp32 over a ragged encoder length: forward
    and every step of a serve-step loop, kernels against the plain path,
    the steps against the forward."""
    cfg = dataclasses.replace(get_config("whisper_base", reduced=True),
                              dtype="float32")
    params = ED.init_params_encdec(cfg, torch.Generator(card).manual_seed(2),
                                   card)
    gen = torch.Generator(card).manual_seed(3)
    frames = _rand(gen, (2, 29, cfg.d_model), torch.float32, card)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=card,
                         dtype=torch.int32, generator=gen)
    before = flash_attention_cuda.launches
    fwd = ED.forward_encdec(params, toks, frames, cfg)
    assert flash_attention_cuda.launches == before + 3 * cfg.n_layers
    _assert_close(fwd, ED.forward_encdec(params, toks, frames, cfg,
                                         backend="ref"), 1e-4)
    enc = ED.encode(params, frames, cfg)
    step = build_serve_step(cfg)
    state = ED.init_decode_state_encdec(cfg, 2, 12, device=card)
    pos = torch.zeros((), dtype=torch.int32, device=card)
    for t in range(12):
        lt, state = step(params, state, toks[:, t], pos, enc)
        pos += 1
        _assert_close(lt, fwd[:, t], 1e-4)


# ---------------------------------------------------------------------------
# the serve step captured in a CUDA graph and replayed (serve.engine)
# ---------------------------------------------------------------------------

def _greedy(step, params, state, prompts, new, *extra):
    """generate's loop over ``step``: the prompt teacher-forced, then
    ``new`` greedy tokens; pos a 0-d int32 tensor advanced in place."""
    pos = torch.zeros((), dtype=torch.int32, device=prompts.device)
    logits = None
    for t in range(prompts.shape[1]):
        logits, state = step(params, state, prompts[:, t], pos, *extra)
        pos += 1
    out = [prompts]
    tok = logits.argmax(-1).to(torch.int32)
    for i in range(new):
        out.append(tok[:, None])
        if i == new - 1:
            break
        logits, state = step(params, state, tok, pos, *extra)
        pos += 1
        tok = logits.argmax(-1).to(torch.int32)
    return torch.cat(out, dim=1)


def _same_state(a, b):
    for key in a:
        if isinstance(a[key], dict):
            _same_state(a[key], b[key])
        else:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("arch", [a for a in PORTED_IDS if a != "whisper_base"])
def test_captured_serve_step_gives_the_eager_tokens_and_state(card, arch):
    """Smoke width in the config's dtype: the captured step (one eager call
    that captures, then replays) and decode_step itself give the same
    tokens and every state leaf bit for bit (the kernels and cuBLAS are
    deterministic and replay the eager calls' own work); generate gives
    those tokens too; the launch counters count each replay."""
    cfg = get_config(arch, reduced=True)
    params = TF.init_params(cfg, torch.Generator(card).manual_seed(2), card)
    prompts = torch.randint(0, cfg.vocab_size, (3, 6), device=card,
                            dtype=torch.int32,
                            generator=torch.Generator(card).manual_seed(3))
    new = 5
    eager_state = TF.init_decode_state(cfg, 3, 11, device=card)
    want = _greedy(lambda p, s, t, pos: TF.decode_step(p, s, t, pos, cfg),
                   params, eager_state, prompts, new)
    step = build_serve_step(cfg)
    state = TF.init_decode_state(cfg, 3, 11, device=card)
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.layer_pattern)
    before = decode_attention_cuda.launches
    got = _greedy(step, params, state, prompts, new)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _same_state(state, eager_state)
    assert step.captures == 1 and step.replays == 6 + new - 2
    assert decode_attention_cuda.launches - before == n_attn * (6 + new - 1)
    assert torch.equal(generate(params, cfg, prompts, new), want)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "jamba_1_5_large_398b"])
def test_one_card_mesh_serve_step_gives_the_unsharded_tokens(card, arch):
    """The serve step on a one-card DeviceMesh (nccl, world size 1): its
    jit_with lays params and state out as DTensors without copying them,
    and the step (captured over their local tensors) gives the unsharded
    captured step's tokens and state bit for bit, launching K2 decode as
    often."""
    from repro_torch.launch.mesh import local_group, shape_mesh
    cfg = get_config(arch, reduced=True)
    params = TF.init_params(cfg, torch.Generator(card).manual_seed(2), card)
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), device=card,
                            dtype=torch.int32,
                            generator=torch.Generator(card).manual_seed(3))
    new = 4
    state = TF.init_decode_state(cfg, 2, 10, device=card)
    before = decode_attention_cuda.launches
    want = _greedy(build_serve_step(cfg), params, state, prompts, new)
    n_want = decode_attention_cuda.launches - before
    with local_group(str(card)):
        mesh = shape_mesh((1, 1), ("data", "model"), device_type="cuda")
        step, dparams, dstate = build_serve_step(cfg, mesh=mesh).jit_with(
            params, TF.init_decode_state(cfg, 2, 10, device=card))
        first = dparams["embed"]["table"]
        assert first.to_local().data_ptr() == \
            params["embed"]["table"].data_ptr()
        before = decode_attention_cuda.launches
        got = _greedy(step, dparams, dstate, prompts, new)
        torch.cuda.synchronize()
        assert decode_attention_cuda.launches - before == n_want
        assert step.captures == 1
    assert torch.equal(got, want)
    _same_state({k: {kk: vv.to_local() for kk, vv in v.items()}
                 for k, v in dstate.items()}, state)


def test_captured_encdec_step_gives_the_eager_tokens_and_cache(card):
    """Whisper smoke in bf16: the serve-step loop (the cross-attention's
    K2 prefill over the encoder's output, the self-attention's K2 decode)
    captured and replayed gives decode_step_encdec's tokens and caches bit
    for bit, enc_out copied into the graph's buffer each step."""
    cfg = get_config("whisper_base", reduced=True)
    params = ED.init_params_encdec(cfg, torch.Generator(card).manual_seed(2),
                                   card)
    gen = torch.Generator(card).manual_seed(3)
    enc = ED.encode(params, _rand(gen, (2, 29, cfg.d_model), cfg.torch_dtype,
                                  card), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 4), device=card,
                            dtype=torch.int32, generator=gen)
    eager_state = ED.init_decode_state_encdec(cfg, 2, 10, device=card)
    want = _greedy(lambda p, s, t, pos, e: ED.decode_step_encdec(
        p, s, t, pos, e, cfg), params, eager_state, prompts, 6, enc)
    step = build_serve_step(cfg)
    state = ED.init_decode_state_encdec(cfg, 2, 10, device=card)
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    got = _greedy(step, params, state, prompts, 6, enc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _same_state(state, eager_state)
    assert step.captures == 1 and step.replays == 8
    steps = 4 + 6 - 1
    assert (flash_attention_cuda.launches - before[0],
            decode_attention_cuda.launches - before[1]) == \
        (cfg.n_layers * steps, cfg.n_layers * steps)


def test_captured_step_recaptures_for_a_fresh_state(card):
    """The step called with another state (a second generate's) captures
    anew over it: its result is the eager step's on that state, and the
    first state, which the old graph wrote, is left as it was."""
    cfg = get_config("jamba_1_5_large_398b", reduced=True)
    params = TF.init_params(cfg, torch.Generator(card).manual_seed(4), card)
    tok = torch.tensor([3, 8], dtype=torch.int32, device=card)
    step = build_serve_step(cfg)
    first = TF.init_decode_state(cfg, 2, 6, device=card)
    pos = torch.zeros((), dtype=torch.int32, device=card)
    for _ in range(3):
        step(params, first, tok, pos)
        pos += 1
    assert step.captures == 1 and step.replays == 2
    kept = {k: {n: t.clone() for n, t in v.items()} for k, v in first.items()}
    fresh = TF.init_decode_state(cfg, 2, 6, device=card)
    eager = TF.init_decode_state(cfg, 2, 6, device=card)
    pos.zero_()
    for _ in range(3):
        got, fresh = step(params, fresh, tok, pos)
        want, eager = TF.decode_step(params, eager, tok, pos, cfg)
        assert torch.equal(got, want)
        pos += 1
    assert step.captures == 2 and step.replays == 4
    _same_state(fresh, eager)
    _same_state(first, kept)


def test_captured_step_logits_are_the_callers(card):
    """The logits a replay returns are a clone: a later replay leaves them
    as they were, and two steps' logits share no storage."""
    cfg = get_config("mistral_nemo_12b", reduced=True)
    params = TF.init_params(cfg, torch.Generator(card).manual_seed(5), card)
    step = build_serve_step(cfg)
    state = TF.init_decode_state(cfg, 2, 5, device=card)
    toks = torch.tensor([[1, 2], [7, 3], [5, 9], [4, 6]], dtype=torch.int32,
                        device=card)
    pos = torch.zeros((), dtype=torch.int32, device=card)
    outs = []
    for tok in toks:
        logits, state = step(params, state, tok, pos)
        outs.append((logits, logits.clone()))
        pos += 1
    torch.cuda.synchronize()
    assert step.replays == 3
    for logits, copy in outs:
        assert torch.equal(logits, copy)
    ptrs = {logits.data_ptr() for logits, _ in outs}
    assert len(ptrs) == 4
    assert not torch.equal(outs[1][0], outs[2][0])


# ---------------------------------------------------------------------------
# training: the plain path under autograd, the kernels refusing it
# ---------------------------------------------------------------------------

def _train_inputs(cfg, dev):
    from repro_torch.data.pipeline import SyntheticLM, batch_at
    from repro_torch.train.step import make_train_state
    state = make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = batch_at(SyntheticLM(cfg.vocab_size, 16, 4, seed=2), 0, "cpu")
    if dev.type == "cpu":
        return state, batch
    from repro_torch.tree import tree_map
    return (tree_map(lambda t: t.to(dev), state),
            {k: v.to(dev) for k, v in batch.items()})


def test_train_step_on_the_card_matches_the_cpu(card):
    """glm4 smoke in fp32, TF32 off, from the same parameters and batch:
    the loss and the gradient norm within 1e-5 relative, the gradients
    within 1e-4 of each leaf's largest magnitude, every updated parameter
    within 2e-5 + 2e-4 · |x| where the gradient is above that bound (AdamW's
    first step moves an element by about lr · sign(g)); then accumulation
    over 4 microbatches against 1 on the card at that tolerance."""
    from repro_torch.train.step import build_train_step, loss_and_grads
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("glm4_9b", reduced=True),
                              dtype="float32")
    out = {}
    for dev in (torch.device("cpu"), card):
        state, batch = _train_inputs(cfg, dev)
        _, _, grads = loss_and_grads(cfg, state.params, batch)
        state, m = build_train_step(cfg, lr=1e-3)(state, batch)
        out[dev.type] = (m, [g.cpu() for g in tree_leaves(grads)],
                         [p.cpu() for p in tree_leaves(state.params)])
    (mc, gc, pc), (mg, gg, pg) = out["cpu"], out["cuda"]
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-5, atol=0)
    for a, b, want, got in zip(gc, gg, pc, pg):
        tol = 1e-4 * float(a.abs().max())
        assert float((a - b).abs().max()) <= tol
        bad = (got - want).abs() > 2e-5 + 2e-4 * want.abs()
        assert bool((a.abs()[bad] < tol).all())
    # accumulation over 4 microbatches against the whole batch, on the card
    res = []
    for accum in (1, 4):
        state, batch = _train_inputs(cfg, card)
        state, _ = build_train_step(cfg, lr=1e-3, accum_steps=accum)(
            state, batch)
        res.append([p.cpu() for p in tree_leaves(state.params)])
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=2e-4, atol=2e-5)


def test_every_kernel_wrapper_raises_under_autograd(card):
    """Each ops.* entry point on card tensors that require grad raises (no
    kernel has a backward pass) and launches nothing; under no_grad the
    same call launches."""
    g = torch.Generator(card).manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, dtype=bf):
        return _rand(g, shape, dtype, card)

    calls = {
        "gemm": lambda t: ops.gemm(t(r(64, 64)), r(64, 64)),
        "flash_attention": lambda t: ops.flash_attention(
            t(r(1, 2, 64, 64)), r(1, 2, 64, 64), r(1, 2, 64, 64)),
        "decode_attention": lambda t: ops.decode_attention(
            t(r(1, 2, 1, 64)), r(1, 2, 64, 64), r(1, 2, 64, 64)),
        "rwkv6": lambda t: ops.rwkv6(
            t(r(1, 2, 32, 64)), r(1, 2, 32, 64), r(1, 2, 32, 64),
            torch.rand(1, 2, 32, 64, generator=g, device=card).to(bf),
            r(2, 64)),
        "ssm_scan": lambda t: ops.ssm_scan(
            t(r(1, 32, 64)), torch.rand(1, 32, 64, generator=g,
                                        device=card).to(bf),
            -torch.rand(64, 16, generator=g, device=card), r(1, 32, 16),
            r(1, 32, 16), torch.ones(64, device=card)),
    }
    for name, call in calls.items():
        before = ops.launch_counts()
        with pytest.raises(RuntimeError, match="no backward pass"):
            call(lambda t: t.requires_grad_())
        assert ops.launch_counts() == before, name
        with torch.no_grad():
            call(lambda t: t.requires_grad_())
        assert ops.launch_counts() != before, name


def test_async_checkpoint_snapshot_survives_an_update_on_the_card(card,
                                                                  tmp_path):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.train.step import build_train_step, make_train_state
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("glm4_9b", reduced=True),
                              dtype="float32")
    state, batch = _train_inputs(cfg, card)
    before = [t.clone() for t in tree_leaves(state)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    state, _ = build_train_step(cfg, lr=1e-2)(state, batch)
    mgr.wait()
    _, got = mgr.restore(make_train_state(cfg, device="meta"), device=card)
    for x, y in zip(tree_leaves(got), before):
        assert torch.equal(x, y)
    assert not torch.equal(tree_leaves(state)[0], before[0])


def _large_gemm_tile():
    """The GEMM queries of the `large` space's first tile (4096 FUs) over
    the DSE's default zoo at seq 512 and 4096, as one candidate batch."""
    import numpy as np

    from repro_torch.core.mapper_batch import _dn_row, _true_rows, build_batch
    from repro_torch.dse import batch_sweep as B
    from repro_torch.dse.space import SPACES
    tile = B.plan_tiles(list(SPACES["large"].enumerate()))[0]
    zoo = B.sweep_zoo(B.DEFAULT_ZOO, (512, 4096))
    (wl, sps, dn, queries), = [q for q in B.prefill_queries(zoo, tile[0])
                               if q[0].name == "gemm"]
    hws = [p.hw_config() for p in tile]
    b = build_batch(wl, [q[0] for q in queries], sps, hws[0])
    true = _true_rows(wl, [q[0] for q in queries])[b.layer_id]
    ppu = np.array([q[1] for q in queries])[b.layer_id]
    dn_rows = np.array([_dn_row(wl, hw, dn) for hw in hws])
    return wl, hws, b, true, ppu, dn_rows


def _held_to_numpy(got, want):
    """The engine contract: integer-derived outputs bit-identical,
    energy_pj within ENERGY_RTOL."""
    import numpy as np

    from repro_torch.core.perf_model_torch import ENERGY_RTOL, RESULT_KEYS
    for k in RESULT_KEYS:
        if k == "energy_pj":
            np.testing.assert_allclose(got[k], want[k], rtol=ENERGY_RTOL,
                                       atol=0)
        else:
            assert np.array_equal(got[k], want[k]), k


def test_dse_scoring_engine_on_the_card_matches_numpy(card):
    """The int64 footprint contraction and the level choice run on the card
    only here (the CPU takes int64 matrix products, CUDA does not)."""
    import numpy as np

    from repro_torch.core.perf_model import perf_kernel
    from repro_torch.core.perf_model_torch import (perf_kernel_torch,
                                                   perf_kernel_torch_design)
    wl, hws, b, true, ppu, dn_rows = _large_gemm_tile()
    assert b.n_candidates > 20000
    args = (b.loop_dim, b.loop_size, b.S, b.n_fus, b.fill, true)
    got = perf_kernel_torch_design(wl, hws, *args, dn_rows, ppu)
    for di, hw in enumerate(hws):
        dn = np.broadcast_to(dn_rows[di], (b.n_candidates, dn_rows.shape[1]))
        want = perf_kernel(wl, hw, *args, dn, ppu)
        _held_to_numpy({k: v[di] for k, v in got.items()}, want)
        if di == 0:
            _held_to_numpy(perf_kernel_torch(wl, hw, *args, dn, ppu), want)


def test_importing_the_dse_leaves_cuda_uninitialised(card):
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import torch, repro_torch.dse.batch_sweep, repro_torch.core, "
            "repro_torch.dse\n"
            "assert torch.cuda.is_available()\n"
            "assert not torch.cuda.is_initialized()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------------------
# the LEGO generator's simulators on the card (no kernel of their own: plain
# PyTorch in float64/int64), held to the same calls on the CPU
# ---------------------------------------------------------------------------

def _gen_design(kind):
    from repro_torch.core import workload as W
    from repro_torch.core.adg import generate_adg
    from repro_torch.core.dag import codegen
    from repro_torch.core.dataflow import build_dataflow
    from repro_torch.core.passes import run_backend
    if kind == "GEMM-MJ":  # benchmarks/designs.py's recipes
        wl = W.gemm()
        specs = [(wl, build_dataflow(wl, spatial=[("k", 16), ("j", 16)],
                                     temporal=[("i", 4), ("j", 4), ("k", 4),
                                               ("i", 8)],
                                     c=(1, 1), name="gemm-jk")),
                 (wl, build_dataflow(wl, spatial=[("i", 16), ("j", 16)],
                                     temporal=[("i", 4), ("j", 4),
                                               ("k", 32)],
                                     c=(1, 1), name="gemm-ij"))]
    else:
        loops = dict(spatial=[("m", 16), ("n", 16)],
                     temporal=[("b", 2), ("m", 2), ("n", 2), ("d", 16)],
                     c=(0, 0))
        qk, pv = W.attention_qk(), W.attention_pv()
        specs = [(qk, build_dataflow(qk, name="attn-qk", **loops)),
                 (pv, build_dataflow(pv, name="attn-pv", **loops))]
    adg = generate_adg(specs, name=kind)
    dag = codegen(adg)
    run_backend(dag)
    return adg, dag


def _gen_inputs(adg, names, seed):
    import numpy as np
    r = np.random.default_rng(seed)
    out = {}
    for dfn, tensors in names:
        spec = adg.spec(dfn)
        for t in tensors:
            shape = spec.workload.tensor_shape(spec.workload.tensor(t),
                                               spec.dataflow.sizes())
            out[t] = torch.from_numpy(
                r.integers(-4, 5, size=shape).astype(np.float64))
    return out


def _gen_same(card_res, cpu_res, fields):
    assert torch.equal(card_res.output.cpu(), cpu_res.output)
    for f in fields:
        assert getattr(card_res, f) == getattr(cpu_res, f), f


_GEN_RTL_FIELDS = ("fills", "mem_reads", "link_transfers", "cycles",
                   "pipeline_depth", "checks", "hw")


def test_gemm_mj_oracle_and_netlist_on_the_card_match_the_cpu(card):
    from repro_torch.core.funcsim import oracle, simulate
    from repro_torch.core.rtlsim import simulate_rtl
    adg, dag = _gen_design("GEMM-MJ")
    for seed, dfn in enumerate(adg.dataflow_names):
        host = _gen_inputs(adg, [(dfn, ("X", "W"))], seed)
        dev = {k: v.to(card) for k, v in host.items()}
        spec = adg.spec(dfn)
        wl, sizes = spec.workload, spec.dataflow.sizes()
        ref = oracle(wl, sizes, dev)
        assert ref.device.type == card.type
        assert torch.equal(ref.cpu(), oracle(wl, sizes, host))
        got = simulate_rtl(dag, adg, dfn, dev)
        assert got.output.device.type == card.type
        assert torch.equal(got.output, ref)
        _gen_same(got, simulate_rtl(dag, adg, dfn, host), _GEN_RTL_FIELDS)
        sim = simulate(adg, dfn, dev)
        assert torch.equal(sim.output, ref)
        _gen_same(sim, simulate(adg, dfn, host),
                  ("fills", "mem_reads", "link_transfers", "cycles"))


def test_staged_attention_on_the_card_matches_the_cpu(card):
    from repro_torch.core.funcsim import staged_oracle
    from repro_torch.core.rtlsim import simulate_rtl_stages
    adg, dag = _gen_design("Attention")
    host = _gen_inputs(adg, [("attn-qk", ("Q", "K")), ("attn-pv", ("V",))],
                       3)
    dev = {k: v.to(card) for k, v in host.items()}
    stages, resident = ["attn-qk", "attn-pv"], {"S": "P"}
    refs = staged_oracle(adg, stages, dev, resident=resident)
    got = simulate_rtl_stages(dag, adg, stages, dev, resident=resident)
    want = simulate_rtl_stages(dag, adg, stages, host, resident=resident)
    for g, w, o in zip(got, want, refs):
        assert torch.equal(g.output, o)
        _gen_same(g, w, _GEN_RTL_FIELDS)

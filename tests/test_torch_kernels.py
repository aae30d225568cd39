"""The port's attention (repro_torch.kernels) against the JAX reference
(repro.kernels) on the CPU, with inputs made by numpy from a seed.  The
CUDA kernels themselves are held against these plain versions by
tests/test_torch_cuda.py and chip_smoke.py on the card.

Tolerances are those of tests/test_kernels.py: fp32 2e-4 (streaming vs
direct softmax), bf16 3e-2 (bf16 operands and P)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, autotile
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 decode_attention_cuda,
                                                 flash_attention_cuda)

F32_TOL = 2e-4
BF16_TOL = 3e-2


def _case(B, Hq, Hkv, Tq, Tk, D, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rs.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rs.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _both(arrs, dtype="float32"):
    """The same inputs as JAX arrays and torch tensors of ``dtype``."""
    j = tuple(jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs)
    t = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# plain versions against the JAX refs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1)])
def test_attention_ref_gqa(Hq, Hkv):
    j, t = _both(_case(2, Hq, Hkv, 64, 64, 32))
    _close(TR.attention_ref(*t, causal=True), JR.attention_ref(*j), F32_TOL)


@pytest.mark.parametrize("window", [None, 16, 32])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_attention_ref_window_softcap(window, softcap):
    j, t = _both(_case(1, 2, 2, 64, 64, 16, seed=1))
    kw = dict(causal=True, window=window, softcap=softcap)
    _close(TR.attention_ref(*t, **kw), JR.attention_ref(*j, **kw), F32_TOL)


@pytest.mark.parametrize("Tq,Tk,offset", [(32, 64, 0), (24, 50, 0),
                                          (16, 48, 32)])
def test_attention_ref_noncausal_and_offset(Tq, Tk, offset):
    j, t = _both(_case(1, 2, 2, Tq, Tk, 16, seed=2))
    _close(TR.attention_ref(*t, causal=False), JR.attention_ref(
        *j, causal=False), F32_TOL)
    _close(TR.attention_ref(*t, causal=True, offset=offset),
           JR.attention_ref(*j, causal=True, offset=offset), F32_TOL)


def test_attention_ref_bf16():
    j, t = _both(_case(1, 2, 2, 32, 32, 16, seed=3), "bfloat16")
    out = TR.attention_ref(*t, causal=True)
    assert out.dtype == torch.bfloat16
    _close(out, JR.attention_ref(*j, causal=True), BF16_TOL)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_chunked_attention_ref(window, softcap):
    j, t = _both(_case(1, 4, 2, 64, 64, 16, seed=4))
    kw = dict(causal=True, window=window, softcap=softcap, kv_chunk=16)
    _close(TR.chunked_attention_ref(*t, **kw),
           JR.chunked_attention_ref(*j, **kw), F32_TOL)
    _close(TR.chunked_attention_ref(*t, **kw),
           TR.attention_ref(*t, causal=True, window=window, softcap=softcap),
           F32_TOL)


def test_decode_matches_full_attention_last_row():
    B, H, S, D = 2, 4, 48, 16
    (q, k, v), _ = _both(_case(B, H, H, S, S, D, seed=3))
    _, (qt, kt, vt) = _both(_case(B, H, H, S, S, D, seed=3))
    full = TR.attention_ref(qt, kt, vt, causal=True)
    out = TR.decode_attention_ref(qt[:, :, -1:], kt, vt)
    _close(out[:, :, 0], np.asarray(full[:, :, -1]), F32_TOL)
    _close(out, JR.decode_attention_ref(q[:, :, -1:], k, v), F32_TOL)


@pytest.mark.parametrize("pos", [0, 7, 30])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_decode_ref_pos_before_end(pos, window, softcap):
    j, t = _both(_case(2, 8, 2, 1, 48, 16, seed=5))
    kw = dict(window=window, softcap=softcap)
    want = JR.decode_attention_ref(*j, pos=pos, **kw)
    _close(TR.decode_attention_ref(*t, pos=pos, **kw), want, F32_TOL)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    _close(TR.decode_attention_ref(*t, pos=pos_t, **kw), want, F32_TOL)


# ---------------------------------------------------------------------------
# ops on CPU tensors against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bq,bk,window,softcap", [(16, 16, None, None),
                                                  (8, 32, 16, 30.0),
                                                  (32, 16, None, 50.0)])
def test_ops_flash_cpu_vs_pallas_interpret(bq, bk, window, softcap):
    j, t = _both(_case(1, 4, 2, 64, 64, 16, seed=6))
    kw = dict(causal=True, window=window, softcap=softcap)
    want = flash_attention_pallas(*j, bq=bq, bk=bk, interpret=True, **kw)
    _close(ops.flash_attention(*t, **kw), want, F32_TOL)


def test_ops_decode_cpu_vs_reference_ops():
    j, t = _both(_case(2, 4, 2, 1, 32, 16, seed=7))
    for pos in (None, 5, 31):
        _close(ops.decode_attention(*t, window=8, pos=pos),
               jops.decode_attention(*j, window=8, pos=pos, backend="ref"),
               F32_TOL)


# ---------------------------------------------------------------------------
# tiles and the no-fallback contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (8, 40), (2048, 2048),
                                   (4608, 4608)])
def test_attention_tiles_fit_shared_memory(D, Tq, Tk):
    bq, bk = autotile.attention_tiles(Tq, Tk, D)
    assert bq in autotile.BQ_CHOICES and bk in autotile.BK_CHOICES
    assert autotile.attention_smem_bytes(bq, bk, D) <= autotile.SMEM_BYTES
    if Tq >= 64 and Tk >= 64:
        assert (bq, bk) == (64, 64)   # the largest tiles fit even at D=256
    if Tq <= 16:
        assert bq == 16


def test_attention_tiles_respect_budget():
    with pytest.raises(ValueError):
        autotile.attention_tiles(64, 64, 256, smem_budget=1024)
    bq, bk = autotile.attention_tiles(64, 64, 256, smem_budget=100 * 1024)
    assert autotile.attention_smem_bytes(bq, bk, 256) <= 100 * 1024


def test_cuda_wrappers_reject_cpu_tensors():
    _, (q, k, v) = _both(_case(1, 2, 2, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, k, v, bq=16, bk=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(q[:, :, :1], k, v,
                              torch.tensor(3, dtype=torch.int32))


def test_ops_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version."""
    q, k, v = (torch.empty(s, device="meta") for s in
               ((1, 2, 16, 16), (1, 2, 16, 16), (1, 2, 16, 16)))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :, :1], k, v, pos=3)

"""The port's GEMM, attention, selective scan and RWKV-6 recurrence
(repro_torch.kernels) against the JAX reference (repro.kernels) on the CPU,
with inputs made by numpy from a seed.  The CUDA kernels themselves are
held against these plain versions by tests/test_torch_cuda.py and
chip_smoke.py on the card.

Tolerances are those of tests/test_kernels.py: fp32 1e-5 for the GEMM,
2e-4 for attention (streaming vs direct softmax) and 1e-4 for the scans,
bf16 2e-2 for the GEMM and 3e-2 for attention (bf16 operands and P)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.gemm import gemm_pallas
from repro.kernels.rwkv6 import rwkv6_pallas
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro_torch.kernels import ops, autotile
from repro_torch.kernels import ref as TR
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 decode_attention_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.gemm import gemm_cuda
from repro_torch.kernels.rwkv6 import rwkv6_cuda
from repro_torch.kernels.ssm_scan import ssm_scan_cuda

F32_TOL = 2e-4
SCAN_TOL = 1e-4
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
# GEMM (K1's plain version and tiles)
# ---------------------------------------------------------------------------

def _gemm_case(M, N, K, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((M, K)).astype(np.float32),
            rs.standard_normal((K, N)).astype(np.float32))


@pytest.mark.parametrize("M,N,K,bm,bn,bk", [
    (32, 32, 64, 16, 16, 32),
    (64, 48, 32, 16, 16, 16),
    (16, 128, 16, 16, 64, 16),
])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_gemm_ref_and_ops_vs_pallas_interpret(M, N, K, bm, bn, bk, dtype,
                                             tol):
    """tests/test_kernels.py:32-36's shapes and tiles: the Pallas kernel
    in interpret mode against gemm_ref and ops.gemm on CPU tensors."""
    j, t = _both(_gemm_case(M, N, K, seed=M + N), dtype)
    want = gemm_pallas(*j, bm=bm, bn=bn, bk=bk, interpret=True)
    for got in (TR.gemm_ref(*t), ops.gemm(*t)):
        assert got.dtype == t[0].dtype and got.shape == (M, N)
        _close(got, want, tol)
    _close(TR.gemm_ref(*t), JR.gemm_ref(*j), tol)


def test_ops_gemm_ragged_vs_reference_ops():
    """The ragged (33x70)·(70x45) case of tests/test_kernels.py:50: the
    reference pads to its tiles, the port pads nothing."""
    j, t = _both(_gemm_case(33, 45, 70, seed=5))
    want = jops.gemm(*j, backend="interpret")
    _close(ops.gemm(*t), want, 1e-4)
    np.testing.assert_allclose(ops.gemm(*t).numpy(), t[0].numpy() @
                               t[1].numpy(), rtol=1e-4, atol=1e-4)


def _gemm_candidates(M, N, K, dtype_bytes):
    """The built tiles gemm_tiles may pick: no side wider than the problem
    needs (the smallest built sides always qualify)."""
    tiles = autotile.GEMM_TILES[dtype_bytes]
    small = [min(t[i] for t in tiles) for i in range(3)]
    return [t for t in tiles if t[0] <= max(small[0], M)
            and t[1] <= max(small[1], N) and t[2] <= max(small[2], K)]


def _units(M, N, tile, splits):
    return -(-M // tile[0]) * -(-N // tile[1]) * splits


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("M,N,K", [(1, 1, 1), (1, 5120, 5120), (7, 45, 70),
                                   (33, 45, 70), (2048, 14336, 5120),
                                   (512, 512, 512), (8192, 8192, 8192)])
def test_gemm_tiles_fit_and_are_built(dtype_bytes, M, N, K):
    """The picked tile is built and its ring, at the depth autotile states,
    fits the card's 227 KB; tile x split fills the 132 SMs wherever some
    candidate tile's largest split can, and the split count never exceeds
    the k-steps."""
    t = autotile.gemm_tiles(M, N, K, dtype_bytes)
    tile = (t.bm, t.bn, t.bk)
    assert tile in autotile.GEMM_TILES[dtype_bytes]
    stages = autotile.gemm_stages(*tile, dtype_bytes)
    assert stages >= (3 if dtype_bytes == 2 else 2)
    assert autotile.gemm_smem_bytes(*tile, dtype_bytes, stages) \
        <= autotile.SMEM_BYTES
    if M <= 16:   # decode-shaped products take the fewest rows built
        assert t.bm == min(b for b, _, _ in autotile.GEMM_TILES[dtype_bytes])
    splits = autotile.gemm_splits(M, N, K, t, dtype_bytes)
    assert 1 <= splits <= max(1, -(-K // t.bk))
    can_fill = any(
        _units(M, N, c, autotile.gemm_max_splits(M, N, K, c, dtype_bytes))
        >= autotile.H100_SMS for c in _gemm_candidates(M, N, K, dtype_bytes))
    if can_fill:
        assert _units(M, N, tile, splits) >= autotile.H100_SMS


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("M,N,K", [
    (1, 5120, 5120), (7, 5120, 5120), (512, 512, 512), (1, 64, 64),
    (64, 4096, 4096), (1000, 3000, 2000), (257, 250, 1001), (1, 14336, 96),
    (2048, 14336, 5120), (3, 40, 100000)])
def test_gemm_splits_fill_the_card_within_the_floor(dtype_bytes, M, N, K):
    """For every built tile: one split when the output tiles fill the SMs;
    else at least enough to fill them where the floor allows, and never
    more than the floor (each split at least GEMM_SPLIT_MIN_STEPS k-steps,
    none empty)."""
    for tile in autotile.GEMM_TILES[dtype_bytes]:
        s = autotile.gemm_splits(M, N, K, tile, dtype_bytes)
        most = autotile.gemm_max_splits(M, N, K, tile, dtype_bytes)
        steps = -(-K // tile[2])
        assert 1 <= s <= most <= max(1, steps)
        if s > 1:
            assert steps // s >= autotile.GEMM_SPLIT_MIN_STEPS
            # the kernel's ranges [z*steps/s, (z+1)*steps/s) cover the steps
            starts = [z * steps // s for z in range(s + 1)]
            assert starts[0] == 0 and starts[-1] == steps
            assert all(b > a for a, b in zip(starts, starts[1:]))
        tiles = _units(M, N, tile, 1)
        if tiles >= autotile.H100_SMS:
            assert s == 1
        elif most * tiles >= autotile.H100_SMS:
            assert s * tiles >= autotile.H100_SMS
        else:
            assert s == most


def test_gemm_splits_at_the_decode_and_micro_bench_shapes():
    """The shapes the split was made for: Mistral-NeMo's decode-shaped
    (1 or 7) x 5120 . (5120 x 5120) in both dtypes and 512^3 in fp32 each
    run at least 132 blocks; the up-projection at T = 2048 runs unsplit on
    896 tiles of (128, 256)."""
    for M in (1, 7):
        for eb in (2, 4):
            t = autotile.gemm_tiles(M, 5120, 5120, eb)
            s = autotile.gemm_splits(M, 5120, 5120, t, eb)
            assert s > 1 and _units(M, 5120, (t.bm, t.bn), s) >= 132
    t = autotile.gemm_tiles(512, 512, 512, 4)
    s = autotile.gemm_splits(512, 512, 512, t, 4)
    assert s > 1 and _units(512, 512, (t.bm, t.bn), s) >= 132
    t = autotile.gemm_tiles(2048, 14336, 5120, 2)
    assert (t.bm, t.bn, t.bk) == (128, 256, 64)
    assert autotile.gemm_splits(2048, 14336, 5120, t, 2) == 1
    assert _units(2048, 14336, (128, 256), 1) == 896


def test_gemm_tiles_and_splits_are_pure_functions_of_the_shapes():
    shapes = [(1, 5120, 5120, 2), (512, 512, 512, 4), (33, 45, 70, 2),
              (2048, 14336, 5120, 2), (7, 5120, 5120, 4)]
    first = [(autotile.gemm_tiles(M, N, K, eb),
              autotile.gemm_splits(M, N, K, autotile.gemm_tiles(M, N, K, eb),
                                   eb)) for M, N, K, eb in shapes]
    autotile.gemm_tiles.cache_clear()
    autotile.gemm_splits.cache_clear()
    again = [(autotile.gemm_tiles(M, N, K, eb),
              autotile.gemm_splits(M, N, K, (t.bm, t.bn, t.bk), eb))
             for (M, N, K, eb), (t, _) in zip(shapes, first)]
    assert again == first


def test_gemm_layout_matches_the_kernel():
    """The bf16 block's shared memory as WgLayout lays it out (its
    static_assert refuses a ring that exceeds the card's): STAGES x (the
    128 x 64 X tile and the 64 x BN W tile), the 128 x 64 bf16 staging
    tile of the epilogue, two barriers a stage and the 1024-byte
    alignment; the ring is 5 deep at BN = 128 and 4 at 256.  The fp32
    kernel keeps its padded two-stage cp.async ring."""
    assert autotile.gemm_stages(128, 128, 64, 2) == 5
    assert autotile.gemm_stages(128, 256, 64, 2) == 4
    assert autotile.gemm_smem_bytes(128, 256, 64, 2) == \
        4 * (2 * (128 * 64 + 64 * 256) + 16) + 2 * 128 * 64 + 1024 \
        <= 232448
    assert autotile.gemm_smem_bytes(128, 128, 16, 4) == \
        2 * 4 * (128 * 20 + 16 * 132)
    for tile in autotile.GEMM_TILES[2]:
        assert tile[0] == 128 and tile[2] == 64 and tile[1] in (128, 256)


def test_gemm_tiles_header_lists_the_built_tiles():
    """csrc/gemm.cu instantiates what the generated header lists, and the
    header lists exactly GEMM_TILES, the bf16 ones with their ring depth,
    and the epilogue's columns a pass that gemm_smem_bytes counts: the
    tiles and the layout are decided in one place."""
    import re

    from repro_torch.kernels import _build
    text = _build.header("gemm")
    lines = {ln.split("(X)")[0].split()[-1]: ln for ln in text.splitlines()
             if ln.startswith("#define")}
    f32 = [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", lines["LEGO_GEMM_F32_TILES"])]
    assert f32 == list(autotile.GEMM_TILES[4])
    bf16 = [tuple(map(int, t)) for t in re.findall(
        r"X\((\d+), (\d+), (\d+), (\d+)\)", lines["LEGO_GEMM_BF16_TILES"])]
    assert bf16 == [(*t, autotile.gemm_stages(*t, 2))
                    for t in autotile.GEMM_TILES[2]]
    assert f"#define LEGO_GEMM_EPI_COLS {autotile.GEMM_EPI_COLS}\n" in text
    src = (_build.CSRC_DIR / "gemm.cu").read_text()
    assert "LEGO_GEMM_F32_TILES(LEGO_F32)" in src
    assert "LEGO_GEMM_BF16_TILES(LEGO_BF16)" in src
    assert "constexpr int WG_EPI = LEGO_GEMM_EPI_COLS;" in src
    assert '#include "hopper.cuh"' in src


def test_package_data_ships_every_included_header():
    """Every ``#include "..."`` of a csrc/*.cu source matches a glob of the
    package data in pyproject.toml, so an installed (not editable) package
    can build its kernels."""
    import fnmatch
    import re
    import tomllib

    from repro_torch.kernels import _build
    pyproject = Path(__file__).resolve().parents[1] / "pyproject.toml"
    globs = tomllib.loads(pyproject.read_text())["tool"]["setuptools"][
        "package-data"]["repro_torch"]
    shipped = {p.relative_to(_build.PKG_DIR).as_posix()
               for p in _build.PKG_DIR.rglob("*")
               if any(fnmatch.fnmatch(p.relative_to(_build.PKG_DIR)
                                      .as_posix(), g) for g in globs)}
    for name in _build.sources():
        assert f"csrc/{name}.cu" in shipped
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for inc in re.findall(r'^#include "([^"]+)"', src, re.M):
            assert f"csrc/{inc}" in shipped, (name, inc, globs)


def test_lib_path_follows_the_shared_header(tmp_path, monkeypatch):
    """A library's hash covers csrc/*.cuh: an edit to hopper.cuh, which
    gemm.cu includes, names another library (no stale load)."""
    import shutil

    from repro_torch.kernels import _build
    csrc = tmp_path / "repro_torch" / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "repro_torch" /
                        "build")
    before = {n: _build.lib_path(n) for n in _build.sources()}
    assert before == {n: _build.lib_path(n) for n in _build.sources()}
    assert all(p.parent == tmp_path / "repro_torch" / "build"
               for p in before.values())
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.sources()}
    assert all(after[n] != before[n] for n in before)
    (csrc / "hopper.cuh").write_bytes(
        (_build.PKG_DIR / "csrc" / "hopper.cuh").read_bytes())
    assert {n: _build.lib_path(n) for n in _build.sources()} == before


def test_gemm_tiles_respect_budget_and_raise():
    for eb in (2, 4):
        sizes = sorted(autotile.gemm_smem_bytes(*t, eb)
                       for t in autotile.GEMM_TILES[eb])
        with pytest.raises(ValueError, match="no GEMM tile fits"):
            autotile.gemm_tiles(8192, 8192, 8192, eb,
                                smem_budget=sizes[0] - 1)
        t = autotile.gemm_tiles(8192, 8192, 8192, eb,
                                smem_budget=sizes[-1] - 1)
        assert autotile.gemm_smem_bytes(t.bm, t.bn, t.bk, eb) < sizes[-1]
    t = autotile.gemm_tiles(8192, 8192, 8192, 4, smem_budget=24 * 1024)
    assert autotile.gemm_smem_bytes(t.bm, t.bn, t.bk, 4) <= 24 * 1024
    assert t.bm < 128
    with pytest.raises(ValueError, match="no GEMM tiles built"):
        autotile.gemm_tiles(64, 64, 64, 8)


@pytest.mark.parametrize("M,N,K", [(2048 // 16, 14336 // 16, 5120), (1, 256, 5120),
                                   (33, 45, 70)])
def test_gemm_rel_err_admits_one_rounding_and_no_fault(M, N, K):
    """ref.gemm_rel_err of the bf16 product rounded once from fp32 reads
    under 2^-8 (half of the 2-ulp gate); a product missing one k16 slice,
    or with one 64-deep k-step read twice (a stale ring stage), reads over
    the 2-ulp gate at K = 5120."""
    rs = np.random.RandomState(M + N)
    x = torch.from_numpy(rs.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((K, N)).astype(np.float32))
    xb, wb = x.bfloat16(), w.bfloat16()
    assert TR.gemm_rel_err(TR.gemm_ref(xb, wb), xb, wb) <= 2.0 ** -8
    if K < 5120:
        return
    gate = 2 * 2.0 ** -7
    drop = wb.clone()
    drop[1024:1040] = 0
    assert TR.gemm_rel_err(TR.gemm_ref(xb, drop), xb, wb) > gate
    stale = wb.clone()
    stale[2048:2112] = wb[1984:2048]
    xs = xb.clone()
    xs[:, 2048:2112] = xb[:, 1984:2048]
    assert TR.gemm_rel_err(TR.gemm_ref(xs, stale), xb, wb) > gate


def test_gemm_cuda_rejects_cpu_and_meta_tensors():
    _, (x, w) = _both(_gemm_case(16, 64, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gemm_cuda(x, w, bm=16, bn=64, bk=16)
    xm, wm = x.to("meta"), w.to("meta")
    with pytest.raises(ValueError):
        ops.gemm(xm, wm)


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


@pytest.mark.parametrize("causal,Tq,Tk", [(True, 40, 40), (False, 24, 50),
                                           (False, 1, 77)])
def test_attention_ref_head_dim_96(causal, Tq, Tk):
    """Phi-3-vision's head_dim; non-causal over a ragged Tk as in
    cross-attention (Tq = 1 is a decode step's query over the frames)."""
    j, t = _both(_case(2, 4, 4, Tq, Tk, 96, seed=12))
    _close(TR.attention_ref(*t, causal=causal),
           JR.attention_ref(*j, causal=causal), F32_TOL)
    _close(ops.flash_attention(*t, causal=causal),
           JR.attention_ref(*j, causal=causal), F32_TOL)


def test_attention_ref_bf16():
    j, t = _both(_case(1, 2, 2, 32, 32, 16, seed=3), "bfloat16")
    out = TR.attention_ref(*t, causal=True)
    assert out.dtype == torch.bfloat16
    _close(out, JR.attention_ref(*j, causal=True), BF16_TOL)


def test_attention_rel_err_admits_the_reference_kernel_and_no_fault():
    """The yardstick of the bf16 prefill (ref.attention_rel_err, held to
    three bf16 ulps on the card): the reference's own bf16 Pallas kernel
    reads under it; an output with one kv tile of twelve skipped, or with
    the later rows 10% off, reads far over it.  The 3e-2 gate passes the
    latter: over 1536 keys the outputs are about 0.04."""
    j, t = _both(_case(1, 2, 2, 256, 1536, 64, seed=9), "bfloat16")
    got = torch.from_numpy(np.asarray(
        flash_attention_pallas(*j, bq=128, bk=128, causal=False,
                               interpret=True), np.float32)).bfloat16()
    tol = 3 * 2.0 ** -7
    assert TR.attention_rel_err(got, *t, causal=False) <= tol
    q, k, v = t
    keep = torch.cat([torch.arange(0, 640), torch.arange(768, 1536)])
    skipped = TR.attention_ref(q, k[:, :, keep], v[:, :, keep], causal=False)
    assert TR.attention_rel_err(skipped, *t, causal=False) > 4 * tol
    late = got.clone()
    late[:, :, 128:] *= 1.1
    assert TR.attention_rel_err(late, *t, causal=False) > 2 * tol
    _close(late, JR.attention_ref(*j, causal=False), BF16_TOL)


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
# K2 decode's split-KV form (flash-decoding): the splits and the merge
# ---------------------------------------------------------------------------

# (B, Hkv, group, S, D, dtype_bytes): the main paths' decode shapes
# (Mistral-NeMo, Phi-3-vision, Jamba, Gemma-2's window at 8192, phase 4's
# 40-position cache), ragged, tiny and very long caches, fp32
_DECODE_SHAPES = [
    (4, 8, 4, 4096, 128, 2), (4, 32, 1, 4096, 96, 2),
    (4, 8, 8, 4096, 128, 2), (4, 8, 2, 8192, 256, 2),
    (4, 8, 4, 40, 128, 2), (2, 2, 4, 300, 64, 4), (2, 2, 4, 4097, 16, 2),
    (1, 1, 1, 1, 16, 4), (1, 1, 1, 1 << 20, 128, 2),
    (1, 2, 32, 4097, 256, 4), (8, 32, 1, 100000, 64, 2),
    (1, 8, 5, 1024, 128, 2),
]


@pytest.mark.parametrize("B,Hkv,group,S,D,dtype_bytes", _DECODE_SHAPES)
def test_decode_splits_cover_the_cache_and_fill_the_card(B, Hkv, group, S, D,
                                                         dtype_bytes):
    L, splits = autotile.decode_splits(B, Hkv, group, S, D, dtype_bytes)
    assert splits >= 1 and splits == max(1, -(-S // L))
    assert (splits - 1) * L < max(S, 1) <= splits * L   # chunks cover [0, S)
    if S <= L:
        assert splits == 1
    assert splits <= autotile.DECODE_MAX_SPLITS
    assert L & (L - 1) == 0
    assert 2 * L * D * dtype_bytes >= autotile.DECODE_MIN_BYTES
    blocks = (-(-group // autotile.decode_rows(group)) * Hkv * B * splits)
    # at least two blocks a SM, unless the chunk is at its least or the
    # cache is too short for that
    smallest = 2 * (L // 2) * D * dtype_bytes < autotile.DECODE_MIN_BYTES
    assert blocks >= autotile.DECODE_WAVES * autotile.H100_SMS or smallest
    assert blocks < 2 * autotile.DECODE_WAVES * autotile.H100_SMS or \
        splits == 1


def test_decode_splits_at_mistral_nemo_fill_two_waves():
    """Mistral-NeMo's decode over a 4096-position cache (B = 4, 32 q heads,
    8 kv heads, head_dim 128, bf16): at least 2 blocks on each of 132
    SMs, and phase 4's 40-position cache takes one split."""
    L, splits = autotile.decode_splits(4, 8, 4, 4096, 128, 2)
    assert autotile.decode_rows(4) == 4
    assert 1 * 8 * 4 * splits >= 2 * 132
    assert autotile.decode_splits(4, 8, 4, 40, 128, 2)[1] == 1


def test_decode_splits_are_a_pure_function_of_the_shapes():
    """No position among the arguments (it lives on the device), the same
    answer every time and without the cache."""
    import inspect
    params = list(inspect.signature(autotile.decode_splits).parameters)
    assert params == ["B", "Hkv", "group", "S", "D", "dtype_bytes"]
    for shape in _DECODE_SHAPES:
        got = autotile.decode_splits(*shape)
        assert got == autotile.decode_splits(*shape)
        assert got == autotile.decode_splits.__wrapped__(*shape)


@pytest.mark.parametrize("group,rows", [(1, 1), (2, 2), (3, 4), (4, 4),
                                        (5, 8), (8, 8), (16, 8), (32, 8)])
def test_decode_rows_take_the_whole_group_up_to_8(group, rows):
    assert autotile.decode_rows(group) == rows


# (where pos sits, window, softcap): chunk edges, a window that crosses
# one, windows that leave whole chunks out, a softcap
_SPLIT_CASES = [
    ("0", None, None), ("L-1", None, None), ("L", None, None),
    ("S-1", None, None), ("L", 100, None), ("L-1", 300, 30.0),
    ("S-1", 50, None), ("S-1", None, 30.0),
]


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("where,window,softcap", _SPLIT_CASES)
def test_decode_split_ref_equals_decode_ref(dtype, tol, group, where, window,
                                            softcap):
    """The cache cut at ``decode_splits``' own chunk edges and merged as
    the combine kernel merges gives the port's and the reference's
    ``decode_attention_ref``."""
    S, D, Hkv = 1100, 16, 2
    j, t = _both(_case(1, Hkv * group, Hkv, 1, S, D, seed=17), dtype)
    L, splits = autotile.decode_splits(1, Hkv, group, S, D,
                                       t[0].element_size())
    assert splits >= 2
    pos = {"0": 0, "L-1": L - 1, "L": L, "S-1": S - 1}[where]
    kw = dict(window=window, softcap=softcap)
    got = TR.decode_attention_split_ref(*t, pos=pos, **kw)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    _close(got, np.asarray(TR.decode_attention_ref(*t, pos=pos, **kw)
                           .float()), tol)
    _close(got, JR.decode_attention_ref(*j, pos=pos, **kw), tol)


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

# the fp32 tiles chosen before the tensor-core kernel, by (Tq, Tk): the
# fp32 kernel and its choice are unchanged
_F32_TILES = {(1, 1): (16, 32), (8, 40): (16, 32), (2048, 2048): (64, 64),
              (4608, 4608): (64, 64)}


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (8, 40), (2048, 2048),
                                   (4608, 4608)])
def test_attention_tiles_fit_shared_memory(D, Tq, Tk, dtype_bytes):
    bq, bk = autotile.attention_tiles(Tq, Tk, D, dtype_bytes)
    assert (bq, bk) in autotile.ATTN_TILES[dtype_bytes]
    assert (bq, bk) in autotile.attention_built_tiles(D, dtype_bytes)
    assert autotile.attention_smem_bytes(bq, bk, D, dtype_bytes) \
        <= autotile.SMEM_BYTES == 227 * 1024
    if dtype_bytes == 4:
        assert (bq, bk) == _F32_TILES[(Tq, Tk)]
    else:
        # a warpgroup per 64 q rows, bk keys a wgmma
        assert bq % 64 == 0 and bk in (64, 128)
        assert autotile.attention_acc_registers(bk, D) \
            + autotile.ATTN_SPARE_REGS <= autotile.attention_register_limit(bq)
        if Tq >= 128 and Tk >= 128:
            assert (bq, bk) == ((64, 64) if D == 256 else (128, 128))
        if Tq <= 64:
            assert bq == 64


def test_attention_tc_layout_matches_the_kernel():
    """The bf16 block's shared memory as TcLayout lays it out (its
    static_assert refuses a tile that exceeds the card's): the Q tile,
    two stages of K and V, seven barriers and the 1024-byte alignment; the
    registers a thread gets (255 beside one consumer warpgroup, 168 beside
    two); at D = 256 only (64, 64) fits both (with bk = 128 the K/V stages
    exceed 227 KB, with two warpgroups the 64x256 fp32 output and the score
    tile exceed 168 registers a thread)."""
    assert autotile.attention_smem_bytes(128, 128, 128, 2) == \
        2 * (128 * 128 + 4 * 128 * 128) + 8 * 7 + 1024
    assert autotile.attention_register_limit(64) == 255
    assert autotile.attention_register_limit(128) == 168
    assert autotile.attention_built_tiles(256, 2) == ((64, 64),)
    for D in (16, 32, 64, 96, 128):
        assert autotile.attention_built_tiles(D, 2) == autotile.ATTN_TILES[2]
    assert autotile.attention_built_tiles(128, 4) == autotile.ATTN_TILES[4]
    with pytest.raises(ValueError, match="8-byte"):
        autotile.attention_built_tiles(64, 8)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_attention_tiles_are_always_built(dtype_bytes):
    """Over a grid of (Tq, Tk, D), attention_tiles returns only a tile that
    its dtype's kernel builds (the wrapper refuses any other)."""
    for D in HEAD_DIMS:
        built = autotile.attention_built_tiles(D, dtype_bytes)
        assert built
        for Tq in (1, 7, 16, 33, 64, 100, 128, 150, 1500, 2048, 4224):
            for Tk in (1, 40, 64, 77, 128, 333, 1500, 4096):
                assert autotile.attention_tiles(Tq, Tk, D, dtype_bytes) \
                    in built


def test_attention_tiles_respect_budget():
    with pytest.raises(ValueError):
        autotile.attention_tiles(64, 64, 256, 4, smem_budget=1024)
    bq, bk = autotile.attention_tiles(64, 64, 256, 4,
                                      smem_budget=100 * 1024)
    assert autotile.attention_smem_bytes(bq, bk, 256, 4) <= 100 * 1024


def test_attention_tiles_header_lists_the_built_tiles():
    """The kernel source instantiates what the generated header lists, and
    the header lists exactly attention_built_tiles at each head_dim: the
    tiles are decided in one place."""
    import re

    from repro_torch.kernels import _build
    text = _build.header("flash_attention")
    for macro, dtype_bytes in (("LEGO_F32_TILES", 4), ("LEGO_BF16_TILES", 2)):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"#define {macro}(X)"))
        listed = [tuple(map(int, t)) for t in
                  re.findall(r"X\((\d+), (\d+), (\d+)\)", line)]
        assert listed == [(D, bq, bk) for D in HEAD_DIMS for bq, bk in
                          autotile.attention_built_tiles(D, dtype_bytes)]
    src = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    assert "LEGO_F32_TILES(LEGO_F32)" in src
    assert "LEGO_BF16_TILES(LEGO_BF16)" in src
    assert _build.header("gemm") == autotile.gemm_tiles_header()


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


# ---------------------------------------------------------------------------
# RWKV-6 recurrence (K4's plain versions)
# ---------------------------------------------------------------------------

def _rwkv_case(B, H, T, Dk, Dv, seed=0):
    """tests/test_kernels.py's _rwkv_case, drawn with numpy: w in (0, 1)."""
    rs = np.random.RandomState(seed)
    r = rs.standard_normal((B, H, T, Dk)).astype(np.float32)
    k = (rs.standard_normal((B, H, T, Dk)) * 0.3).astype(np.float32)
    v = rs.standard_normal((B, H, T, Dv)).astype(np.float32)
    w = (1 / (1 + np.exp(-(rs.standard_normal((B, H, T, Dk)) + 2.0)))
         ).astype(np.float32)
    u = (rs.standard_normal((H, Dk)) * 0.1).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("T,bt", [(32, 8), (64, 16), (16, 16)])
def test_rwkv6_ref_vs_pallas_interpret(T, bt):
    j, t = _both(_rwkv_case(2, 2, T, 8, 8, seed=1))
    o, s = TR.rwkv6_ref(*t)
    assert o.dtype == torch.float32 and s.shape == (2, 2, 8, 8)
    o_p, s_p = rwkv6_pallas(*j, bt=bt, interpret=True)
    o_r, s_r = JR.rwkv6_ref(*j)
    for got, want in ((o, o_p), (s, s_p), (o, o_r), (s, s_r)):
        _close(got, want, SCAN_TOL)


def test_rwkv6_state_handoff():
    """Two halves with the state handed over == the full sequence (the
    invariant behind decode and the chunked path), in the port and against
    the reference's ``s0`` path."""
    j, t = _both(_rwkv_case(1, 2, 32, 8, 8, seed=2))
    o_full, s_full = TR.rwkv6_ref(*t)
    r, k, v, w, u = t
    o1, s1 = TR.rwkv6_ref(r[:, :, :16], k[:, :, :16], v[:, :, :16],
                          w[:, :, :16], u)
    o2, s2 = TR.rwkv6_ref(r[:, :, 16:], k[:, :, 16:], v[:, :, 16:],
                          w[:, :, 16:], u, s0=s1)
    _close(o2, np.asarray(o_full[:, :, 16:]), SCAN_TOL)
    _close(s2, np.asarray(s_full), SCAN_TOL)
    jr, jk, jv, jw, ju = j
    _, js1 = JR.rwkv6_ref(jr[:, :, :16], jk[:, :, :16], jv[:, :, :16],
                          jw[:, :, :16], ju)
    jo2, js2 = JR.rwkv6_ref(jr[:, :, 16:], jk[:, :, 16:], jv[:, :, 16:],
                            jw[:, :, 16:], ju, s0=js1)
    _close(o2, jo2, SCAN_TOL)
    _close(s2, js2, SCAN_TOL)


@pytest.mark.parametrize("T,chunk", [(32, 8), (48, 16), (16, 64)])
def test_rwkv6_ref_matches_reference_chunked(T, chunk):
    """The port's one loop over T gives what the reference's chunked
    recurrence gives, so the port needs no copy of that per-step chunked
    loop (ref.rwkv6_chunked_ref is the bf16 kernel's other algorithm)."""
    j, t = _both(_rwkv_case(2, 2, T, 8, 8, seed=3))
    o, s = TR.rwkv6_ref(*t)
    o_j, s_j = JR.chunked_rwkv6_ref(*j, chunk=chunk)
    _close(o, o_j, SCAN_TOL)
    _close(s, s_j, SCAN_TOL)


def test_rwkv6_ref_bf16():
    """bf16 inputs: fp32 state and arithmetic, o rounded to bf16, S fp32."""
    j, t = _both(_rwkv_case(1, 2, 24, 16, 16, seed=4), "bfloat16")
    o, s = TR.rwkv6_ref(*t)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    o_j, s_j = JR.rwkv6_ref(*j)
    _close(o, o_j, BF16_TOL)
    _close(s, s_j, SCAN_TOL)


def test_ops_rwkv6_cpu_never_reaches_the_cuda_wrapper(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(ops, "rwkv6_cuda", boom)
    j, t = _both(_rwkv_case(1, 2, 20, 16, 16, seed=5))
    o, s = ops.rwkv6(*t)
    o_j, s_j = jops.rwkv6(*j, backend="ref")
    _close(o, o_j, SCAN_TOL)
    _close(s, s_j, SCAN_TOL)


def test_rwkv6_cuda_rejects_cpu_and_meta_tensors():
    _, t = _both(_rwkv_case(1, 2, 16, 16, 16))
    before = rwkv6_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv6_cuda(*t)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rwkv6(*meta)    # off the CPU, ops goes to the wrapper or raises
    assert rwkv6_cuda.launches == before


def _rwkv_decays(kind, shape, rs):
    """Decays across the range a trained RWKV-6 has (w = exp(-exp(w_raw)),
    models/blocks.py): ``sigmoid`` tests/test_kernels.py's (0.5, 0.99);
    ``zero`` w = 0 exactly on a third of the steps; ``tiny`` w = 1e-30 on
    every other step; ``one`` w = 1 exactly on the even channels and every
    fourth step; ``mixed`` strong (1e-6 .. 1e-3) and mild (0.95 .. 0.999)
    decays mixed within one chunk and channel."""
    w = 1 / (1 + np.exp(-(rs.standard_normal(shape) + 2.0)))
    if kind == "zero":
        w[..., ::3, :] = 0.0
    elif kind == "tiny":
        w[..., 1::2, :] = 1e-30
    elif kind == "one":
        w[..., ::2] = 1.0
        w[..., ::4, :] = 1.0
    elif kind == "mixed":
        strong = 10.0 ** rs.uniform(-6, -3, shape)
        mild = rs.uniform(0.95, 0.999, shape)
        w = np.where(rs.random_sample(shape) < 0.3, strong, mild)
    return w.astype(np.float32)


def _rwkv_range_case(T, kind, D=16, seed=11):
    r, k, v, _, u = _rwkv_case(1, 2, T, D, D, seed=seed)
    w = _rwkv_decays(kind, r.shape, np.random.RandomState(seed + T))
    return r, k, v, w, u


RWKV_C = autotile.RWKV_CHUNK
RWKV_RAGGED_T = (1, 15, 16, 17, RWKV_C - 1, RWKV_C, RWKV_C + 1, 77,
                 2 * RWKV_C + 3)
RWKV_KINDS = ("sigmoid", "zero", "tiny", "one", "mixed")
RWKV_REL_TOL = 2.0 ** -7     # chip_smoke.py's one bf16 ulp


@pytest.mark.parametrize("kind", RWKV_KINDS)
@pytest.mark.parametrize("T", RWKV_RAGGED_T)
def test_rwkv6_chunked_ref_vs_reference_fp32(T, kind):
    """The bf16 kernel's algorithm (chunks, sub-chunk products, products of
    w over explicit ranges, split products) in fp32 against the reference's
    loop and the Pallas kernel in interpret mode: o and S_last within 1e-4
    at ragged T and across the range of decays, w = 0 and w = 1 included."""
    j, t = _both(_rwkv_range_case(T, kind))
    o, s = TR.rwkv6_chunked_ref(*t)
    assert o.dtype == torch.float32 and o.shape == (1, 2, T, 16)
    o_r, s_r = JR.rwkv6_ref(*j)
    o_p, s_p = rwkv6_pallas(*j, bt=T, interpret=True)
    for got, want in ((o, o_r), (s, s_r), (o, o_p), (s, s_p)):
        _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("kind", RWKV_KINDS)
@pytest.mark.parametrize("T", (17, RWKV_C + 1, 2 * RWKV_C + 3))
def test_rwkv6_chunked_ref_vs_reference_bf16(T, kind):
    """bf16 inputs at the kernel's rounding points: o within the bf16 gate
    of the reference's loop and the Pallas kernel and within one bf16 ulp of
    the loop in fp32 (ref.rwkv6_rel_err); S_last within 1e-4."""
    j, t = _both(_rwkv_range_case(T, kind, D=64), "bfloat16")
    o, s = TR.rwkv6_chunked_ref(*t)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    o_r, s_r = JR.rwkv6_ref(*j)
    o_p, s_p = rwkv6_pallas(*j, bt=T, interpret=True)
    for got, want, tol in ((o, o_r, BF16_TOL), (o, o_p, BF16_TOL),
                           (s, s_r, SCAN_TOL), (s, s_p, SCAN_TOL)):
        _close(got, want, tol)
    assert TR.rwkv6_rel_err(o, *t) <= RWKV_REL_TOL


def test_rwkv6_rel_err_admits_the_rounding_and_no_planted_fault():
    """tools/k4_fault_check on the CPU: the sound matrix form passes the
    3e-2 gate, the ulp gate and S_last's 1e-4, and every planted fault (u
    dropped, decay one step late, a chunk's state lost, the state in bf16)
    is caught by at least one; the 3e-2 gate alone misses the bf16 state."""
    import contextlib
    import io
    import json

    from repro_torch.tools import k4_fault_check
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = k4_fault_check.main(["--device", "cpu", "--H", "4", "--T", "150"])
    rows = {r["variant"]: r for r in map(json.loads,
                                        out.getvalue().splitlines())}
    assert rc == 0 and rows["sound"]["caught_by"] == []
    assert set(rows) == set(k4_fault_check.VARIANTS)
    assert all(rows[v]["caught_by"] for v in rows if v != "sound")
    assert "3e-2" not in rows["state_bf16"]["caught_by"]


@pytest.mark.parametrize("B,H,T", [(1, 64, 2048), (2, 4, 2048), (1, 1, 77),
                                   (4, 64, 2048), (1, 2, 1), (3, 5, 640)])
def test_rwkv6_tiles_fill_the_card_and_leave_no_run_empty(B, H, T):
    """Segments are a power of two, B x H x segments blocks fit one a SM
    (or there is one segment), every run of chunks holds one at least, and the runs cover the chunks
    in order; two segments at RWKV-6 7B's forward shape, 20 + 12 chunks."""
    tiles = autotile.rwkv6_tiles(B, H, T, 64, 64)
    P = tiles.segments
    assert (tiles.chunk, tiles.sub) == (autotile.RWKV_CHUNK,
                                       autotile.RWKV_SUB)
    assert P & (P - 1) == 0 and (P == 1 or B * H * P <= autotile.H100_SMS)
    starts = autotile.rwkv6_segment_starts(T, P)
    assert starts[0] == 0 and starts[-1] == -(-T // RWKV_C)
    assert all(b - a >= 1 for a, b in zip(starts, starts[1:]))
    if (B, H, T) == (1, 64, 2048):
        assert P == 2 and starts == [0, 20, 32]
    assert autotile.rwkv6_tiles(B, H, T, 64, 64) is tiles


def test_rwkv6_layout_and_header():
    """TcLayout's shared memory (three stages, the hi/lo operand halves,
    the scores, the state and two factor tables) fits the card at both
    built head sizes; the header the build includes lists them, the chunk,
    the sub-chunk and the carried chunk's cost, and csrc/rwkv6.cu builds
    exactly that list; an unbuilt head size is refused."""
    from repro_torch.kernels import _build
    for dk, dv in autotile.RWKV_HEAD_DIMS:
        assert autotile.rwkv6_smem_bytes(dk, dv) <= 232448
    assert autotile.rwkv6_smem_bytes(64, 64) == 231952
    text = _build.header("rwkv6")
    assert f"#define LEGO_RWKV_CHUNK {autotile.RWKV_CHUNK}\n" in text
    assert f"#define LEGO_RWKV_SUB {autotile.RWKV_SUB}\n" in text
    assert "#define LEGO_RWKV_PRE_COST 0.375f\n" in text
    assert "#define LEGO_RWKV_TC_TILES(X) X(16, 16) X(64, 64)\n" in text
    src = (_build.CSRC_DIR / "rwkv6.cu").read_text()
    assert "LEGO_RWKV_TC_TILES(LEGO_RWKV_TC)" in src
    assert '#include "hopper.cuh"' in src
    with pytest.raises(ValueError, match="no bf16 rwkv6 kernel"):
        autotile.rwkv6_tiles(1, 2, 16, 32, 32)


# ---------------------------------------------------------------------------
# Mamba selective scan (K3's plain version)
# ---------------------------------------------------------------------------

def _ssm_case(Bt, L, Dm, N, seed=0):
    """tests/test_kernels.py's _ssm_case, drawn with numpy: dt after a
    softplus, A < 0."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((Bt, L, Dm)).astype(np.float32)
    dt = np.logaddexp(rs.standard_normal((Bt, L, Dm)) - 1.0, 0.0
                      ).astype(np.float32)
    A = (-np.exp(rs.standard_normal((Dm, N)) * 0.5)).astype(np.float32)
    B = rs.standard_normal((Bt, L, N)).astype(np.float32)
    C = rs.standard_normal((Bt, L, N)).astype(np.float32)
    D = np.full((Dm,), 0.5, np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("Bt,L,Dm,N,bd,bl", [(2, 32, 16, 8, 8, 16),
                                             (1, 64, 8, 4, 8, 16),
                                             (2, 16, 32, 16, 16, 8)])
def test_selective_scan_ref_vs_pallas_interpret(Bt, L, Dm, N, bd, bl):
    """tests/test_kernels.py:186-189's cases: the port's loop against the
    Pallas kernel in interpret mode and the reference's associative scan."""
    j, t = _both(_ssm_case(Bt, L, Dm, N, seed=7))
    y, h = TR.selective_scan_ref(*t)
    assert y.dtype == torch.float32 and h.shape == (Bt, Dm, N)
    y_p, h_p = ssm_scan_pallas(*j, bd=bd, bl=bl, interpret=True)
    y_r, h_r = JR.selective_scan_ref(*j)
    for got, want in ((y, y_p), (h, h_p), (y, y_r), (h, h_r)):
        _close(got, want, SCAN_TOL)


def test_selective_scan_state_handoff():
    """Two halves with the state handed over == the full sequence, in the
    port and against the reference's ``h0`` path."""
    j, t = _both(_ssm_case(2, 32, 16, 8, seed=2))
    y_full, h_full = TR.selective_scan_ref(*t)
    x, dt, A, B, C, D = t
    _, h1 = TR.selective_scan_ref(x[:, :16], dt[:, :16], A, B[:, :16],
                                  C[:, :16], D)
    y2, h2 = TR.selective_scan_ref(x[:, 16:], dt[:, 16:], A, B[:, 16:],
                                   C[:, 16:], D, h0=h1)
    _close(y2, np.asarray(y_full[:, 16:]), SCAN_TOL)
    _close(h2, np.asarray(h_full), SCAN_TOL)
    jx, jdt, jA, jB, jC, jD = j
    y2_j, h2_j = JR.selective_scan_ref(jx[:, 16:], jdt[:, 16:], jA,
                                       jB[:, 16:], jC[:, 16:], jD,
                                       h0=jnp.asarray(h1.numpy()))
    _close(y2, y2_j, SCAN_TOL)
    _close(h2, h2_j, SCAN_TOL)


@pytest.mark.parametrize("L,chunk", [(32, 8), (48, 16), (16, 64)])
def test_selective_scan_ref_matches_reference_chunked(L, chunk):
    """The port's one loop over L gives what the reference's chunked scan
    gives, so the port needs no chunked version."""
    j, t = _both(_ssm_case(2, L, 16, 8, seed=3))
    y, h = TR.selective_scan_ref(*t)
    y_j, h_j = JR.chunked_selective_scan_ref(*j, chunk=chunk)
    _close(y, y_j, SCAN_TOL)
    _close(h, h_j, SCAN_TOL)


def test_selective_scan_ref_bf16():
    """bf16 x, dt, B, C (A and D fp32, as the Mamba block passes them): fp32
    state and arithmetic, y rounded once to bf16, h_last fp32."""
    x, dt, A, B, C, D = _ssm_case(1, 24, 32, 16, seed=4)
    jb, tb = _both((x, dt, B, C), "bfloat16")
    jf, tf = _both((A, D))
    y, h = TR.selective_scan_ref(tb[0], tb[1], tf[0], tb[2], tb[3], tf[1])
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_j, h_j = JR.selective_scan_ref(jb[0], jb[1], jf[0], jb[2], jb[3], jf[1])
    _close(y, y_j, BF16_TOL)
    _close(h, h_j, SCAN_TOL)


def test_ops_ssm_scan_cpu_never_reaches_the_cuda_wrapper(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(ops, "ssm_scan_cuda", boom)
    j, t = _both(_ssm_case(2, 20, 24, 16, seed=5))   # no multiple of a tile
    y, h = ops.ssm_scan(*t)
    y_j, h_j = jops.ssm_scan(*j, backend="ref")
    _close(y, y_j, SCAN_TOL)
    _close(h, h_j, SCAN_TOL)


def test_ssm_scan_cuda_rejects_cpu_and_meta_tensors():
    _, t = _both(_ssm_case(1, 16, 32, 16))
    before = ssm_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_scan_cuda(*t)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssm_scan(*meta)    # off the CPU, ops goes to the wrapper or raises
    assert ssm_scan_cuda.launches == before


# the range exp(dt·A) takes in a trained Mamba (dt after a softplus of a
# learned projection, A learned per (d, n)), as chip_smoke.py and
# tests/test_torch_cuda.py draw it: dt = 0 (a decay of exactly 1) on every
# third step, A = -1e5 on the odd states (dt·A below -104: the decay
# underflows fp32), strong (|A| 5 to 50) and mild (|A| 0.02 to 0.2) decays
# mixed 30/70 over (d, n), and the long memory of a trained Mamba (|A|
# log-uniform in [1e-3, 5e-2]: decays within ~1e-3 of 1)
SSM_DECAYS = ("zero", "underflow", "mixed", "long_memory")
# K3's h_last against the fp32 plain version relative to its (b, d) row
# (ref.state_rel_err), as chip_smoke.py's SCAN_ROW_TOL
SCAN_ROW_TOL = 2.0 ** -10


def _ssm_decay_case(Bt, L, Dm, N, decay, seed=0):
    x, dt, A, B, C, D = _ssm_case(Bt, L, Dm, N, seed=seed)
    rs = np.random.RandomState(seed + 100)
    if decay == "zero":
        dt[:, ::3] = 0.0
    elif decay == "underflow":
        A[:, 1::2] = -1e5
        assert (dt[..., None] * A[:, 1::2]).max() < -104.0
    elif decay == "mixed":
        strong = 5.0 * 10.0 ** rs.uniform(size=A.shape)
        mild = 0.02 * 10.0 ** rs.uniform(size=A.shape)
        A = -np.where(rs.uniform(size=A.shape) < 0.3, strong,
                      mild).astype(np.float32)
    elif decay == "long_memory":
        A = (-1e-3 * 50.0 ** rs.uniform(size=A.shape)).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("decay", SSM_DECAYS)
def test_selective_scan_ref_across_decays_vs_pallas_interpret(decay):
    """The port's loop against the Pallas kernel in interpret mode and the
    reference's associative scan over the decays' range, in fp32."""
    j, t = _both(_ssm_decay_case(2, 32, 16, 8, decay, seed=11))
    y, h = TR.selective_scan_ref(*t)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    y_p, h_p = ssm_scan_pallas(*j, bd=8, bl=16, interpret=True)
    y_r, h_r = JR.selective_scan_ref(*j)
    for got, want in ((y, y_p), (h, h_p), (y, y_r), (h, h_r)):
        _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("decay", SSM_DECAYS)
def test_selective_scan_ref_across_decays_bf16(decay, N):
    """bf16 x, dt, B, C over the decays' range: the port's loop against the
    reference's, y at the bf16 tolerance and h_last (fp32 from the same
    rounded inputs) at the scan's; the fp32 plain version reads within one
    bf16 ulp by ``scan_rel_err``."""
    x, dt, A, B, C, D = _ssm_decay_case(2, 45, 37, N, decay, seed=N)
    jb, tb = _both((x, dt, B, C), "bfloat16")
    jf, tf = _both((A, D))
    args = (tb[0], tb[1], tf[0], tb[2], tb[3], tf[1])
    y, h = TR.selective_scan_ref(*args)
    y_j, h_j = JR.selective_scan_ref(jb[0], jb[1], jf[0], jb[2], jb[3], jf[1])
    _close(y, y_j, BF16_TOL)
    _close(h, h_j, SCAN_TOL)
    assert TR.scan_rel_err(y, *args) <= 2.0 ** -8 + 1e-6


def test_scan_rel_err_reads_rounding_and_scales():
    """``scan_rel_err``: 0 for the fp32 plain version itself, at most half
    an ulp (2^-8) for its bf16 rounding, unchanged when y's scale changes
    (x and D scaled together), and the skip dropped reads far above one
    ulp."""
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in
                         _ssm_case(2, 40, 24, 16, seed=9))
    y, _ = TR.selective_scan_ref(x, dt, A, B, C, D)
    assert TR.scan_rel_err(y, x, dt, A, B, C, D) == 0.0
    rounded = TR.scan_rel_err(y.bfloat16(), x, dt, A, B, C, D)
    assert 0.0 < rounded <= 2.0 ** -8
    y4, _ = TR.selective_scan_ref(4 * x, dt, A, B, C, D)
    scaled = TR.scan_rel_err(y4.bfloat16(), 4 * x, dt, A, B, C, D)
    assert scaled == pytest.approx(rounded, rel=1e-5)
    no_skip = y - x * D
    assert TR.scan_rel_err(no_skip, x, dt, A, B, C, D) > 10 * 2.0 ** -7


def test_k3_gates_admit_the_sound_scan_and_no_planted_fault():
    """tools/k3_fault_check on the CPU: the sound plain version passes the
    bf16 K3 gates in both decay draws (softplus and long memory), and each
    planted fault is caught by at least one gate in each."""
    import contextlib
    import io
    import json

    from repro_torch.tools import k3_fault_check
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = k3_fault_check.main(["--device", "cpu", "--L", "100", "--Dm", "48"])
    rows = {(r["variant"], r["decay"]): r
            for r in map(json.loads, buf.getvalue().splitlines())}
    assert rc == 0
    assert set(rows) == {(v, d) for v in k3_fault_check.VARIANTS
                         for d in k3_fault_check.DECAYS}
    assert k3_fault_check.STATE_ROW_TOL == SCAN_ROW_TOL
    for (name, _), row in rows.items():
        assert bool(row["caught_by"]) == (name != "sound"), row


def _scan_with_decay_dt(x, dt, dt_decay, A, B, bias=0.0, h_bf16_every=0):
    """h_last of the scan with each step's decay taken from ``dt_decay``,
    scaled by (1 + ``bias``), and h rounded to bf16 every
    ``h_bf16_every`` steps (0: never)."""
    h = torch.zeros(x.shape[0], x.shape[2], A.shape[1])
    for l in range(x.shape[1]):
        h = (torch.exp(dt_decay[:, l, :, None] * A) * (1.0 + bias) * h
             + (dt[:, l] * x[:, l])[:, :, None] * B[:, l, None, :])
        if h_bf16_every and (l + 1) % h_bf16_every == 0:
            h = h.bfloat16().float()
    return h


def test_state_rel_err_reads_rounding_and_scales():
    """``state_rel_err``: 0 for the plain version's own h_last, at most
    2^-8 for it rounded to bf16, unchanged when h's scale changes (x
    scaled), and a decay one step late reads far above SCAN_ROW_TOL."""
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in
                         _ssm_case(2, 40, 24, 16, seed=9))
    _, h = TR.selective_scan_ref(x, dt, A, B, C, D)
    assert TR.state_rel_err(h, x, dt, A, B, C, D) == 0.0
    rounded = TR.state_rel_err(h.bfloat16().float(), x, dt, A, B, C, D)
    assert 0.0 < rounded <= 2.0 ** -8
    _, h4 = TR.selective_scan_ref(4 * x, dt, A, B, C, D)
    scaled = TR.state_rel_err(h4.bfloat16().float(), 4 * x, dt, A, B, C, D)
    assert scaled == pytest.approx(rounded, rel=1e-5)
    dt_late = torch.cat([dt[:, :1], dt[:, :-1]], dim=1)
    h_late = _scan_with_decay_dt(x, dt, dt_late, A, B)
    assert TR.state_rel_err(h_late, x, dt, A, B, C, D) > 10 * SCAN_ROW_TOL


def test_state_row_gate_admits_the_exps_rounding_not_h_in_bf16():
    """SCAN_ROW_TOL over 2048 steps of the long-memory draw: every decay 2
    fp32 ulps high (ex2.approx's most, as a bias that compounds over h's
    memory) stays under it, though it moves h past the absolute 1e-4; h
    rounded to bf16 once a chunk of 32 steps reads above it."""
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in
                         _ssm_decay_case(1, 2048, 16, 16, "long_memory",
                                         seed=3))
    _, h = TR.selective_scan_ref(x, dt, A, B, C, D)
    biased = _scan_with_decay_dt(x, dt, dt, A, B, bias=2.0 ** -23)
    assert (biased - h).abs().max().item() > 1e-4
    assert TR.state_rel_err(biased, x, dt, A, B, C, D) < SCAN_ROW_TOL / 2
    h_bf16 = _scan_with_decay_dt(x, dt, dt, A, B, h_bf16_every=32)
    assert TR.state_rel_err(h_bf16, x, dt, A, B, C, D) > 4 * SCAN_ROW_TOL


def _exp_fma_model(v):
    """``exp_fma``, the exp on the FMA pipe that tools/k3_probe.py's
    ``exp_fma`` variant gives K3's fp32 route, in numpy, its constants read
    from the variant's text in order: the clamp, log2(e), the two parts of
    -ln 2, P's seven coefficients and the 1 of e^r = 1 + q.  Each fp32
    product and sum rounds as on the card; an fmaf is its exact value
    (float64 holds an fp32 product exactly) rounded once."""
    import re

    from repro_torch.tools import k3_probe
    c = [np.float32(t[:-1]) for t in
         re.findall(r"-?\d+\.\d*(?:e[-+]?\d+)?f", k3_probe._EXP_FMA)]
    assert len(c) == 13, c
    lo, hi, log2e, ln2_hi, ln2_lo, *P, one = c
    f32 = np.float32

    def fma(a, b, x):
        return (a.astype(np.float64) * b + x).astype(f32)

    v = np.minimum(np.maximum(v.astype(f32), lo), hi)
    k = np.rint(v * log2e).astype(f32)
    r = fma(k, ln2_hi, v)
    r = fma(k, ln2_lo, r)
    p = np.full_like(v, P[0])
    for coef in P[1:]:
        p = fma(p, r, coef)
    e = one + fma((p * r).astype(f32), r, r)
    bits = (np.maximum(k.astype(np.int64) + 127, 0) << 23).astype(np.uint32)
    return (e * bits.view(f32)).astype(f32)


def test_k3_fp32_exp_is_within_one_ulp_and_unbiased_near_one():
    """k3_probe's exp_fma (modelled from its text) over [-87, 88]
    and over decays within 1e-8 .. 0.3 of 1: within one fp32 ulp of e^v,
    0 at e^v < 2^-126, exactly 1 at v = 0; within 1e-3 of 1 (a long
    memory's decays) rounded to nearest on nearly all, and over each
    decade of 1 - e^v without bias: the mean signed error is below 0.01
    ulp (ex2.approx's is up to 2 ulps)."""
    f32 = np.float32
    v = np.concatenate([np.linspace(-87.3, 88.0, 2_000_001, dtype=f32),
                        -np.logspace(-8, -0.5, 1_000_000).astype(f32)])
    got = _exp_fma_model(v)
    want = np.exp(v.astype(np.float64))
    ulps = np.abs(got - want) / np.spacing(want.astype(f32))
    assert ulps.max() <= 1.0, ulps.max()
    assert _exp_fma_model(np.array([0.0, -0.0], f32)).tolist() == [1.0, 1.0]
    tiny = _exp_fma_model(np.linspace(-104.0, -87.4, 1001, dtype=f32))
    assert (tiny < 2.0 ** -126).all() and (tiny >= 0).all()
    assert _exp_fma_model(np.array([-1e4], f32))[0] == 0.0
    for lo, hi in ((-8, -3), (-3, -2), (-2, -1), (-1, -0.5)):
        near = -np.logspace(lo, hi, 300_000).astype(f32)
        got, want = _exp_fma_model(near), np.exp(near.astype(np.float64))
        signed = (got - want) / np.spacing(want.astype(f32))
        assert abs(signed.mean()) < 0.01, (lo, hi, signed.mean())
        if hi <= -3:
            assert (got == want.astype(f32)).mean() > 0.999


def test_k3_float64_arbiter_sees_the_exps_bias():
    """``selective_scan_ref`` given float64 runs in float64 (the arbiter
    of the fp32 kernel and the fp32 plain scan).  In the long_memory draw
    over 2048 steps (16 channels) the scan with unbiased fp32 decays
    (exp_fma's, modelled above) and the fp32 plain scan (``torch.exp`` on
    the CPU) are within rtol = atol = 1e-4 of it; every decay 2 ulps high
    (ex2.approx's most) moves h_last past that."""
    args = [torch.from_numpy(a) for a in
            _ssm_decay_case(1, 2048, 16, 16, "long_memory", seed=5)]
    x, dt, A, B, C, D = args
    y64, h64 = TR.selective_scan_ref(*(t.double() for t in args))
    assert y64.dtype == h64.dtype == torch.float64
    v = (dt[..., None] * A).numpy()           # dt·A rounded to fp32
    decays = torch.from_numpy(_exp_fma_model(v.ravel()).reshape(v.shape))

    def scan(decays):
        h, ys = torch.zeros(1, 16, 16), []
        for l in range(x.shape[1]):
            h = decays[:, l] * h + (dt[:, l] * x[:, l])[:, :, None] * B[:, l,
                                                                        None]
            ys.append(torch.einsum("bdn,bn->bd", h, C[:, l]))
        return torch.stack(ys, 1) + x * D, h

    for y, h in (scan(decays), TR.selective_scan_ref(*args)):
        torch.testing.assert_close(y.double(), y64, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h.double(), h64, rtol=1e-4, atol=1e-4)
    _, h_biased = scan(decays * (1 + 2.0 ** -23))
    assert ((h_biased.double() - h64).abs()
            > 1e-4 + 1e-4 * h64.abs()).any()


def test_ssm_layout_and_header():
    """The K3 header lists exactly SSM_TILES, one states-a-thread S for
    each built N, the chunk, the consumer threads and the ring's stages,
    and the source instantiates from it (its static_assert holds each
    tile's shared memory to one block's budget at build time)."""
    from repro_torch.kernels import _build
    text = _build.header("ssm_scan")
    assert f"#define LEGO_SSM_CHUNK {autotile.SSM_CHUNK}\n" in text
    assert f"#define LEGO_SSM_THREADS {autotile.SSM_THREADS}\n" in text
    tiles = " ".join(f"X({n}, {s})" for n, s in autotile.SSM_TILES)
    assert f"#define LEGO_SSM_TILES(X) {tiles}\n" in text
    src = (_build.CSRC_DIR / "ssm_scan.cu").read_text()
    assert "LEGO_SSM_TILES(LEGO_SSM_TILE)" in src
    assert "ex2.approx.ftz.f32" in src and "exp2f(" not in src
    assert autotile.SSM_STATE_DIMS == (4, 8, 16)
    assert [n for n, _ in autotile.SSM_TILES] == list(autotile.SSM_STATE_DIMS)
    assert dict(autotile.SSM_TILES)[16] == 8
    assert f"#define LEGO_SSM_STAGES {autotile.SSM_STAGES}\n" in text
    assert f"#define LEGO_SSM_PRODUCERS {autotile.SSM_PRODUCERS}\n" in text
    assert "static_assert(BYTES <= 232448" in src
    for N, S in autotile.SSM_TILES:
        assert N % S == 0 and S % 4 == 0
        assert autotile.SSM_THREADS // (N // S) % 32 == 0

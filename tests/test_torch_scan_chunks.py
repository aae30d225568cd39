"""The port's chunked scans (``ref.chunked_selective_scan_ref``,
``ref.chunked_rwkv6_ref``) against the JAX reference's on the CPU, with
inputs made by numpy from a seed, and their structure: no loop over the
steps of a chunk, and a backward pass that keeps the carries between
chunks and one chunk, not L steps of state.

Tolerances as in tests/test_kernels.py for the scans: fp32 1e-4 (rtol =
atol), outputs, final states and gradients.  In bf16 both sides round each
chunk's output once from fp32 at the same points, so an output is held to
one bf16 ulp of the reference's (:func:`_within_one_bf16_ulp`), the fp32
final state to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import ref as JR
from repro_torch.configs import get_config
from repro_torch.kernels import ref as TR
from repro_torch.launch.opcount import _FREE, OpCounter
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TF

SCAN_TOL = 1e-4


def _close(t, j, tol=SCAN_TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


def _within_one_bf16_ulp(t, j):
    """Each bf16 output at most one bf16 ulp (at the reference value's
    binade) from the reference's: both round the same fp32 value, which
    the two sides compute in different orders."""
    got = t.float().numpy()
    want = np.asarray(jnp.asarray(j, jnp.float32))
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def _to(arrs, dtype):
    j = tuple(jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs)
    t = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return j, t


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _ssm_case(Bt, L, Dm, N, decay, seed=0):
    """x, dt (after a softplus), A < 0, B, C, D.  ``decay`` sets
    exp(dt·A): ``mixed`` the model's range, ``near_one`` within ~1e-3 of
    1 (a memory of ~1000 steps), ``near_zero`` below ~1e-4."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((Bt, L, Dm))
    dt = np.log1p(np.exp(rs.standard_normal((Bt, L, Dm)) - 1.0))
    A = -np.exp(rs.standard_normal((Dm, N)) * 0.5)
    if decay == "near_one":
        dt = dt * 1e-3
    elif decay == "near_zero":
        dt, A = dt + 8.0, A - 1.0
    B, C = rs.standard_normal((2, Bt, L, N))
    D = rs.standard_normal(Dm)
    return tuple(a.astype(np.float32) for a in (x, dt, A, B, C, D))


def _rwkv_case(B, H, T, Dk, Dv, decay, seed=0):
    """r, k, v, w, u.  ``decay`` sets w: ``sigmoid`` (0.5 .. 0.99),
    ``near_one`` 1 − 10^U(−4, −2), ``near_zero`` 10^U(−6, −2) with exact
    zeros on a third of the steps."""
    rs = np.random.RandomState(seed)
    r = rs.standard_normal((B, H, T, Dk))
    k = rs.standard_normal((B, H, T, Dk)) * 0.3
    v = rs.standard_normal((B, H, T, Dv))
    shape = (B, H, T, Dk)
    if decay == "sigmoid":
        w = 1 / (1 + np.exp(-(rs.standard_normal(shape) + 2.0)))
    elif decay == "near_one":
        w = 1 - 10.0 ** rs.uniform(-4, -2, shape)
    else:
        w = 10.0 ** rs.uniform(-6, -2, shape)
        w[..., ::3, :] = 0.0
    u = rs.standard_normal((H, Dk)) * 0.1
    return tuple(a.astype(np.float32) for a in (r, k, v, w, u))


SSM_SHAPES = [(2, 32, 8, 4, 8), (1, 48, 16, 16, 48), (2, 40, 6, 4, 8),
              (1, 64, 8, 16, 256)]          # the last: chunk cut to L
RWKV_SHAPES = [(1, 2, 32, 8, 8, 8), (2, 2, 64, 16, 16, 32),
               (1, 1, 48, 8, 8, 48), (1, 2, 24, 8, 8, 4),
               (1, 2, 96, 16, 8, 24), (1, 2, 64, 8, 8, 256)]
DECAYS = ("mixed", "near_one", "near_zero")
RWKV_DECAYS = ("sigmoid", "near_one", "near_zero")


# ---------------------------------------------------------------------------
# parity with the reference: outputs, final states, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("Bt,L,Dm,N,chunk", SSM_SHAPES)
def test_chunked_selective_scan_matches_reference(Bt, L, Dm, N, chunk,
                                                  decay):
    j, t = _to(_ssm_case(Bt, L, Dm, N, decay, seed=L + N), "float32")
    y, h = TR.chunked_selective_scan_ref(*t, chunk=chunk)
    y_j, h_j = JR.chunked_selective_scan_ref(*j, chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (Bt, L, Dm)
    assert h.dtype == torch.float32 and h.shape == (Bt, Dm, N)
    _close(y, y_j)
    _close(h, h_j)


@pytest.mark.parametrize("decay", RWKV_DECAYS)
@pytest.mark.parametrize("B,H,T,Dk,Dv,chunk", RWKV_SHAPES)
def test_chunked_rwkv6_matches_reference(B, H, T, Dk, Dv, chunk, decay):
    j, t = _to(_rwkv_case(B, H, T, Dk, Dv, decay, seed=T + Dk), "float32")
    o, s = TR.chunked_rwkv6_ref(*t, chunk=chunk)
    o_j, s_j = JR.chunked_rwkv6_ref(*j, chunk=chunk)
    assert o.dtype == torch.float32 and o.shape == (B, H, T, Dv)
    assert s.dtype == torch.float32 and s.shape == (B, H, Dk, Dv)
    _close(o, o_j)
    _close(s, s_j)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_selective_scan_bf16(chunk, decay):
    """bf16 x, dt, B, C (A and D fp32, as the model passes them): y bf16
    within one bf16 ulp of the reference's, h_last fp32 within 1e-4."""
    x, dt, A, B, C, D = _ssm_case(2, 32, 8, 4, decay, seed=chunk)
    jb, tb = _to((x, dt, B, C), "bfloat16")
    jf, tf = _to((A, D), "float32")
    y, h = TR.chunked_selective_scan_ref(tb[0], tb[1], tf[0], tb[2], tb[3],
                                         tf[1], chunk=chunk)
    y_j, h_j = JR.chunked_selective_scan_ref(jb[0], jb[1], jf[0], jb[2],
                                             jb[3], jf[1], chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _within_one_bf16_ulp(y, y_j)
    _close(h, h_j)


@pytest.mark.parametrize("decay", RWKV_DECAYS)
@pytest.mark.parametrize("chunk", [16, 32])
def test_chunked_rwkv6_bf16(chunk, decay):
    """bf16 r, k, v, w, u: o bf16 within one bf16 ulp of the reference's,
    S_last fp32 within 1e-4."""
    j, t = _to(_rwkv_case(1, 2, 64, 16, 16, decay, seed=chunk), "bfloat16")
    o, s = TR.chunked_rwkv6_ref(*t, chunk=chunk)
    o_j, s_j = JR.chunked_rwkv6_ref(*j, chunk=chunk)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    _within_one_bf16_ulp(o, o_j)
    _close(s, s_j)


def _grads_torch(fn, arrs, cots, chunk):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    outs = fn(*ts, chunk=chunk)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, ts)


def _grads_jax(fn, arrs, cots, chunk):
    def loss(*xs):
        outs = fn(*xs, chunk=chunk)
        return sum((o * c).sum() for o, c in zip(outs, cots))
    return jax.grad(loss, argnums=tuple(range(len(arrs))))(
        *(jnp.asarray(a) for a in arrs))


def _cotangents(outs, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(o.shape).astype(np.float32) for o in outs]


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_selective_scan_grads_match_reference(chunk, decay):
    """The gradients of a scalar of y and h_last with respect to every
    input (A and D included) against ``jax.grad`` of the reference's."""
    arrs = _ssm_case(2, 32, 8, 4, decay, seed=3 + chunk)
    y, h = JR.chunked_selective_scan_ref(*map(jnp.asarray, arrs),
                                         chunk=chunk)
    cots = _cotangents((y, h), seed=chunk)
    got = _grads_torch(TR.chunked_selective_scan_ref, arrs, cots, chunk)
    want = _grads_jax(JR.chunked_selective_scan_ref, arrs, cots, chunk)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("decay", RWKV_DECAYS)
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_rwkv6_grads_match_reference(chunk, decay):
    """The gradients of a scalar of o and S_last with respect to r, k, v,
    w and u against ``jax.grad`` of the reference's."""
    arrs = _rwkv_case(1, 2, 64, 8, 8, decay, seed=5 + chunk)
    o, s = JR.chunked_rwkv6_ref(*map(jnp.asarray, arrs), chunk=chunk)
    cots = _cotangents((o, s), seed=chunk)
    got = _grads_torch(TR.chunked_rwkv6_ref, arrs, cots, chunk)
    want = _grads_jax(JR.chunked_rwkv6_ref, arrs, cots, chunk)
    for g, w in zip(got, want):
        _close(g, w)


def test_a_chunk_that_does_not_divide_the_sequence_raises():
    """As in the reference: ``chunk`` (cut to L) must divide L."""
    ssm = _ssm_case(1, 24, 4, 4, "mixed")
    rwkv = _rwkv_case(1, 1, 24, 4, 4, "sigmoid")
    for fn_t, fn_j, arrs in (
            (TR.chunked_selective_scan_ref, JR.chunked_selective_scan_ref,
             ssm),
            (TR.chunked_rwkv6_ref, JR.chunked_rwkv6_ref, rwkv)):
        j, t = _to(arrs, "float32")
        with pytest.raises(AssertionError):
            fn_j(*j, chunk=16)
        with pytest.raises(AssertionError):
            fn_t(*t, chunk=16)
        fn_t(*t, chunk=8)                    # 8 divides 24


# ---------------------------------------------------------------------------
# structure: no loop over a chunk's steps; one chunk kept for the backward
# ---------------------------------------------------------------------------

class _KernelOps(TorchDispatchMode):
    """Counts the dispatched ops that run a kernel in eager PyTorch: not a
    view, an alias or an allocation (``launch/opcount.py``'s free ops)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not (func.is_view or func._schema.name.split("::")[-1] in _FREE):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _torch_ssm(L, Bt=1, Dm=4, N=2, grad=False):
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in
                         _ssm_case(Bt, L, Dm, N, "mixed"))
    for a in (x, dt, B, C):
        a.requires_grad_(grad)
    return x, dt, A, B, C, D


def _torch_rwkv(T, B=1, H=2, D=8, grad=False):
    ts = [torch.from_numpy(a) for a in _rwkv_case(B, H, T, D, D, "sigmoid")]
    for a in ts[:4]:
        a.requires_grad_(grad)
    return ts


def _count(fn, args, **kw):
    with _KernelOps() as c:
        fn(*args, **kw)
    return c.n


@pytest.mark.parametrize("grad", [False, True])
def test_chunked_forms_dispatch_no_op_per_step(grad):
    """At L = 1024 and chunk = 64 each chunked form dispatches fewer than
    L/2 kernel ops (Mamba: ~27 a chunk, 6 levels of the scan; RWKV-6:
    ~26 a chunk for its 4 sub-chunks), where the per-step loops dispatch
    several a step; doubling L with the chunk fixed doubles the count
    (per chunk, not per step)."""
    L = 1024
    n_ssm = _count(TR.chunked_selective_scan_ref, _torch_ssm(L, grad=grad),
                   chunk=64)
    n_rwkv = _count(TR.chunked_rwkv6_ref, _torch_rwkv(L, grad=grad),
                    chunk=64)
    assert n_ssm < L // 2 and n_rwkv < L // 2, (n_ssm, n_rwkv)
    assert _count(TR.selective_scan_ref, _torch_ssm(L)) > 4 * L
    assert _count(TR.rwkv6_ref, _torch_rwkv(L)) > 4 * L
    n_ssm2 = _count(TR.chunked_selective_scan_ref, _torch_ssm(2 * L),
                    chunk=64)
    n_rwkv2 = _count(TR.chunked_rwkv6_ref, _torch_rwkv(2 * L), chunk=64)
    assert 1.8 * n_ssm < n_ssm2 < 2.2 * n_ssm
    assert 1.8 * n_rwkv < n_rwkv2 < 2.2 * n_rwkv


def _saved(fn, args, **kw):
    """The shapes the forward pass saves for the backward."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        outs = fn(*args, **kw)
    return outs, shapes


def test_chunked_scan_backward_keeps_the_carries_and_one_chunk():
    """The forward saves the carries h (Bt, Dm, N) between chunks and the
    chunks' inputs: no tensor larger than an input (a chunk's states,
    (Bt, chunk, Dm, N), are larger) and far fewer elements than the loop's
    L steps of state; the backward recomputes one chunk at a time, so its
    peak of live tensors does not grow with L at a fixed chunk."""
    Bt, Dm, N, chunk = 1, 8, 32, 32
    peaks = []
    for L in (256, 512):
        args = _torch_ssm(L, Bt, Dm, N, grad=True)
        (y, h), shapes = _saved(TR.chunked_selective_scan_ref, args,
                                chunk=chunk)
        carries = [s for s in shapes if s == (Bt, Dm, N)]
        assert len(carries) == L // chunk - 1
        assert max(map(np.prod, shapes)) <= Bt * L * Dm < Bt * chunk * Dm * N
        _, loop = _saved(TR.selective_scan_ref, args)
        assert sum(map(np.prod, shapes)) * 4 < sum(map(np.prod, loop))
        assert sum(map(np.prod, loop)) >= L * Bt * Dm * N
        with OpCounter() as oc:
            torch.autograd.grad((y.sum() + h.sum()), args[:2])
        peaks.append(oc.counts.peak_live_bytes)
    assert peaks[1] < 1.25 * peaks[0], peaks


def test_chunked_rwkv6_backward_keeps_the_carries_and_one_chunk():
    """As for the scan: the forward saves the (Dk, Dv) states that start
    each chunk (the zero one and the carries) and the chunks' inputs, far
    fewer elements than the loop's T steps of state, and the backward's
    peak does not grow with T."""
    B, H, D, chunk = 1, 2, 16, 32
    peaks = []
    for T in (256, 512):
        args = _torch_rwkv(T, B, H, D, grad=True)
        (o, s), shapes = _saved(TR.chunked_rwkv6_ref, args, chunk=chunk)
        carries = [x for x in shapes if x == (B, H, D, D)]
        assert len(carries) == T // chunk
        assert max(map(np.prod, shapes)) <= B * H * chunk * D
        _, loop = _saved(TR.rwkv6_ref, args)
        assert sum(map(np.prod, shapes)) * 4 < sum(map(np.prod, loop))
        assert sum(map(np.prod, loop)) >= T * B * H * D * D
        with OpCounter() as oc:
            torch.autograd.grad((o.sum() + s.sum()), args[:4])
        peaks.append(oc.counts.peak_live_bytes)
    assert peaks[1] < 1.25 * peaks[0], peaks


# ---------------------------------------------------------------------------
# the model's plain path takes them where the reference does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6_7b", "jamba_1_5_large_398b"])
def test_plain_path_takes_the_chunked_forms_from_the_threshold(arch,
                                                               monkeypatch):
    """backend="ref" takes the chunked forms at T >= chunk_threshold (with
    chunk = scan_chunk) and the per-step loops below it; backend="kernel"
    (here the plain loops, on CPU tensors) never takes them."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              chunk_threshold=8, scan_chunk=4,
                              attn_kv_chunk=4)
    calls = []

    def spy(name):
        orig = getattr(TB.R, name)

        def wrapped(*a, **kw):
            calls.append((name, kw.get("chunk")))
            return orig(*a, **kw)
        monkeypatch.setattr(TB.R, name, wrapped)

    for name in ("chunked_selective_scan_ref", "chunked_rwkv6_ref",
                 "selective_scan_ref", "rwkv6_ref"):
        spy(name)
    params = TF.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for T, backend, want in ((8, "ref", True), (7, "ref", False),
                             (8, "kernel", False)):
        calls.clear()
        tokens = torch.zeros((1, T), dtype=torch.int32)
        with torch.no_grad():
            TF.forward(params, tokens, cfg, backend=backend)
        chunked = {c for n, c in calls if n.startswith("chunked")}
        assert calls and (chunked == {4} if want else not chunked), calls


# ---------------------------------------------------------------------------
# K4's gate stays as it was: a frozen copy of ``rwkv6_chunked_ref``
# ---------------------------------------------------------------------------

def _frozen_rwkv6_chunked_ref(r, k, v, w, u):
    """``ref.rwkv6_chunked_ref`` as K4's fault checks were calibrated on
    it, copied unchanged: the gate must go on computing this, bit for
    bit, whatever of its algebra the chunked form shares."""
    RWKV_CHUNK, RWKV_SUB = TR.RWKV_CHUNK, TR.RWKV_SUB
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    C, SUB = RWKV_CHUNK, RWKV_SUB
    NS, n = C // SUB, -(-T // C)
    dt = r.dtype

    def padded(x, fill):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, n * C - T),
                                       value=fill)

    rs, ks, ws = (padded(x, f).reshape(B, H, n, NS, SUB, Dk)
                  for x, f in ((r, 0.0), (k, 0.0), (w, 1.0)))
    vc = padded(v, 0.0).reshape(B, H, n, C, Dv)
    uf = u.float()[None, :, None, :]

    def split(x):
        hi = x.to(dt).float()
        return hi, (x - hi).to(dt).float()

    def mm3(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return ah @ bh + ah @ bl + al @ bh

    def mm2(a, b):          # b exact in dt (v)
        ah, al = split(a)
        return ah @ b + al @ b

    ones = torch.ones_like(ws[..., :1, :])
    cp = torch.cumprod(ws, -2)
    pex = torch.cat([ones, cp[..., :-1, :]], -2)      # Π_{J_0 ≤ τ < t} w
    sex = torch.cat([torch.cumprod(ws.flip(-2), -2).flip(-2)[..., 1:, :],
                     ones], -2)                       # Π_{s < τ ≤ J_end} w
    Wsub = cp[..., -1, :]                             # (B, H, n, NS, Dk)

    def wprod(a, b):                                  # Π_{a ≤ J < b} Wsub_J
        out = torch.ones_like(Wsub[..., 0, :])
        for J in range(a, b):
            out = out * Wsub[..., J, :]
        return out

    A = torch.zeros((B, H, n, C, C), dtype=torch.float32, device=r.device)
    ksex = ks * sex
    for I in range(1, NS):
        rows = slice(I * SUB, (I + 1) * SUB)
        KI = torch.cat([ksex[..., J, :, :] * wprod(J + 1, I)[..., None, :]
                        for J in range(I)], -2)
        A[..., rows, :I * SUB] = mm3(rs[..., I, :, :] * pex[..., I, :, :],
                                     KI.transpose(-1, -2))
    for I in range(NS):                               # diagonal sub-blocks
        for s in range(SUB):
            kd = ks[..., I, s, :]
            A[..., I * SUB + s, I * SUB + s] = \
                (rs[..., I, s, :] * uf * kd).sum(-1)
            for t in range(s + 1, SUB):
                if t > s + 1:
                    kd = kd * ws[..., I, t - 1, :]
                A[..., I * SUB + t, I * SUB + s] = (rs[..., I, t, :]
                                                    * kd).sum(-1)
    o_intra = mm2(A, vc)
    Rs = torch.stack([rs[..., J, :, :] * (pex[..., J, :, :]
                                          * wprod(0, J)[..., None, :])
                      for J in range(NS)], 3).reshape(B, H, n, C, Dk)
    after = [wprod(J + 1, NS)[..., None] for J in range(NS)]
    Wtot = wprod(0, NS)
    S = torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(n):
        outs.append(o_intra[:, :, c] + mm3(Rs[:, :, c], S))
        S = Wtot[:, :, c, :, None] * S
        for J in range(NS):
            S = S + after[J][:, :, c] * mm2(
                ksex[:, :, c, J].transpose(-1, -2),
                vc[:, :, c, J * SUB:(J + 1) * SUB])
    o = torch.cat(outs, 2)[:, :, :T] if outs else vc[:, :, :0].reshape(
        B, H, 0, Dv)
    return o.to(dt), S


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", RWKV_DECAYS)
@pytest.mark.parametrize("T", [16, 70, 128])
def test_k4_gate_is_bit_for_bit_its_frozen_copy(T, decay, dtype):
    _, t = _to(_rwkv_case(1, 2, T, 16, 16, decay, seed=T), dtype)
    o, s = TR.rwkv6_chunked_ref(*t)
    o_f, s_f = _frozen_rwkv6_chunked_ref(*t)
    assert o.dtype == o_f.dtype and s.dtype == s_f.dtype
    assert torch.equal(o, o_f) and torch.equal(s, s_f)

"""Plain PyTorch versions of the GEMM, attention, selective-scan and
RWKV-6 kernels (the port's counterpart of ``repro.kernels.ref``; same
semantics, fp32 accumulation):

  gemm_ref             : (M, K) @ (K, N) -> (M, N)
  attention_ref        : q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D) -> (B, Hq, Tq, D)
                         causal / sliding-window / logit-softcap / GQA
  chunked_attention_ref: the same, streamed over kv chunks
  decode_attention_ref : q (B, Hq, 1, D) over a KV cache (B, Hkv, S, D)
  decode_attention_split_ref: the same, cut at the decode kernel's chunk
                         edges and merged as its combine pass merges
  selective_scan_ref   : the Mamba S6 scan, a loop over L
  scan_rel_err         : a scan's y against it run in fp32, per (b, l) row
  state_rel_err        : a scan's h_last against it run in fp32, per (b, d)
  rwkv6_ref            : the RWKV-6 wkv recurrence, a loop over T
  rwkv6_chunked_ref    : the same in the bf16 kernel's chunked matrix form

These are what the CPU runs and what the CUDA kernels are held against.
"""

from __future__ import annotations

import torch

from .autotile import RWKV_CHUNK, RWKV_SUB, decode_splits

NEG_INF = -1e30


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product in fp32 (no TF32 on a card: the callers turn it off),
    cast back to ``a``'s dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def gemm_rel_err(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """How far a bf16 product ``got`` of a (M, K) and b (K, N) is from the
    product in fp32 of the same inputs: the largest |got - want| /
    (|want| + rms(want's row)).  One rounding to bf16 reads at most 2^-8;
    a k16 slice dropped or a stale ring stage at K = 5120 moves a row by a
    few hundredths of its rms, which the 2e-2 gate can miss where |want|
    is large."""
    want = gemm_ref(a.float(), b.float())
    rms = want.square().mean(-1, keepdim=True).sqrt()
    den = (want.abs() + rms).clamp_min(torch.finfo(torch.float32).tiny)
    return ((got.float() - want).abs() / den).max().item()


def _mask(tq: int, tk: int, *, causal: bool, window: int | None,
          offset: int = 0, device=None) -> torch.Tensor:
    """(tq, tk) boolean mask. ``offset`` = absolute position of q row 0 minus
    k col 0 (for decode: offset = S - 1)."""
    qpos = torch.arange(tq, device=device)[:, None] + offset
    kpos = torch.arange(tk, device=device)[None, :]
    m = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _lowp_pv(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """bf16 operands keep fp32 accumulation but P is rounded to bf16 before
    the PV product, as ``repro.kernels.ref`` does; fp32 stays exact."""
    return p.to(dtype).float() if dtype == torch.bfloat16 else p


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  offset: int = 0) -> torch.Tensor:
    """Grouped-query attention without materializing repeated KV: q is
    reshaped to (B, Hkv, G, Tq, D) and contracted against the shared KV."""
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, Hkv, g, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m = _mask(Tq, Tk, causal=causal, window=window, offset=offset,
              device=q.device)
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", _lowp_pv(p, q.dtype), v.float())
    return o.reshape(B, Hq, Tq, D).to(q.dtype)


def attention_rel_err(got, q, k, v, **kw) -> float:
    """How far a bf16 attention output ``got`` is from the plain version
    computed in fp32 from the same inputs: the largest
    |got - want| / (|want| + rms(want's row)).  Dividing by the row's rms
    holds long rows, whose outputs average many values and are small, to
    the same relative scale as short ones.  A kernel with the reference's
    roundings (P and O to bf16) reads a few times 2^-8; one that drops a kv
    tile or mis-weights rows reads tenths."""
    want = attention_ref(q.float(), k.float(), v.float(), **kw)
    rms = want.square().mean(-1, keepdim=True).sqrt()
    den = (want.abs() + rms).clamp_min(torch.finfo(torch.float32).tiny)
    return ((got.float() - want).abs() / den).max().item()


def chunked_attention_ref(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None,
                          kv_chunk: int = 1024) -> torch.Tensor:
    """Streaming attention in plain PyTorch: a loop over KV chunks with
    running (max, sum, acc) — O(T·chunk) score memory instead of O(T²)."""
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    kv_chunk = min(kv_chunk, Tk)
    if Tk % kv_chunk:
        raise ValueError(f"Tk={Tk} is not a multiple of kv_chunk={kv_chunk}")
    dev = q.device
    qg = q.float().reshape(B, Hkv, g, Tq, D)
    qpos = torch.arange(Tq, device=dev)

    m = torch.full((B, Hkv, g, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, Tq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, Tk, kv_chunk):
        kc = k[:, :, c0:c0 + kv_chunk].float()
        vc = v[:, :, c0:c0 + kv_chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kc) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = c0 + torch.arange(kv_chunk, device=dev)
        mask = torch.ones((Tq, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bhkd->bhgqd", _lowp_pv(p, q.dtype), vc)
        acc = acc * corr[..., None] + pv
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def decode_attention_ref(q, k, v, *, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None,
                         pos: int | torch.Tensor | None = None) -> torch.Tensor:
    """One-token decode: q (B, Hq, 1, D), cache (B, Hkv, S, D).  ``pos`` is
    the query's absolute position, an int or a 0-d tensor (cache entries
    beyond it are masked); with a full cache pos = S-1."""
    B, Hq, Tq, Dh = q.shape
    _, Hkv, S, _ = k.shape
    g = Hq // Hkv
    if pos is None:
        pos = S - 1
    sc = scale if scale is not None else Dh ** -0.5
    qg = q.float().reshape(B, Hkv, g * Tq, Dh)
    s = torch.einsum("bhqd,bhkd->bhqk", qg, k.float()) * sc
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)
    m = kpos <= pos
    if window is not None:
        m &= kpos > pos - window
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", _lowp_pv(p, q.dtype), v.float())
    return o.reshape(B, Hq, Tq, Dh).to(q.dtype)


def decode_attention_split_ref(q, k, v, *, window: int | None = None,
                               softcap: float | None = None,
                               scale: float | None = None,
                               pos: int | torch.Tensor | None = None
                               ) -> torch.Tensor:
    """``decode_attention_ref`` as the split-KV decode kernel computes it:
    the cache cut into the chunks of ``autotile.decode_splits``, each
    chunk's (m, l, acc) in fp32 over its unmasked keys (an empty chunk gives
    m = NEG_INF, l = 0, acc = 0), merged as M = max m_i, l = Σ l_i e^(m_i −
    M) (0 → 1), o = Σ acc_i e^(m_i − M) / l and rounded once.  P stays fp32,
    as in the kernel.  For the tests: it checks the split and the merge."""
    B, Hq, _, D = q.shape
    _, Hkv, S, _ = k.shape
    g = Hq // Hkv
    pos = S - 1 if pos is None else pos
    sc = scale if scale is not None else D ** -0.5
    chunk, splits = decode_splits(B, Hkv, g, S, D, q.element_size())
    qg = q.float().reshape(B, Hkv, g, D)
    ms, ls, accs = [], [], []
    for c in range(splits):
        kc = k[:, :, c * chunk:(c + 1) * chunk].float()
        vc = v[:, :, c * chunk:(c + 1) * chunk].float()
        s = torch.einsum("bhgd,bhkd->bhgk", qg, kc) * sc
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = c * chunk + torch.arange(kc.shape[2], device=q.device)
        keep = kpos <= pos
        if window is not None:
            keep &= kpos > pos - window
        m = torch.where(keep, s, NEG_INF).amax(-1)
        p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, vc))
    m = torch.stack(ms)
    M = m.amax(0)
    w = torch.exp(m - M)
    l = (torch.stack(ls) * w).sum(0)
    acc = (torch.stack(accs) * w[..., None]).sum(0)
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l[..., None]).reshape(B, Hq, 1, D).to(q.dtype)


def rwkv6_ref(r, k, v, w, u, s0=None):
    """RWKV-6 (Finch) wkv: per head, state S (Dk, Dv):

        o_t = rᵗ · (S + diag(u) kᵗ vᵗᵀ)
        S   = diag(w_t) S + kᵗ vᵗᵀ            (w_t data-dependent, in (0,1))

    r/k/w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk); fp32 state and
    arithmetic.  Returns (o (B, H, T, Dv) in r.dtype, S_last (B, H, Dk, Dv)
    fp32)."""
    B, H, T, Dk = r.shape
    Dv = v.shape[-1]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]       # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], S + uf * kv))
        S = wf[:, :, t, :, None] * S + kv
    o = (torch.stack(outs, dim=2) if outs else
         torch.zeros((B, H, 0, Dv), dtype=torch.float32, device=r.device))
    return o.to(r.dtype), S


def rwkv6_rel_err(got, r, k, v, w, u) -> float:
    """How far a bf16 wkv output ``got`` is from :func:`rwkv6_ref` run in
    fp32 on the same inputs: the largest |got - want| / (|want| + rms of
    want's row).  The bf16 kernel rounds o once (at most 2^-8 of |want|)
    and runs every product as split bf16 products (about 2^-16 of each
    term); the u term dropped, the decay taken one step late or a chunk's
    state lost move rows by hundredths of their rms, which the 3e-2 gate
    can miss where |want| is large."""
    want, _ = rwkv6_ref(*(t.float() for t in (r, k, v, w, u)))
    rms = want.square().mean(-1, keepdim=True).sqrt()
    den = (want.abs() + rms).clamp_min(torch.finfo(torch.float32).tiny)
    return ((got.float() - want).abs() / den).max().item()


def rwkv6_chunked_ref(r, k, v, w, u):
    """:func:`rwkv6_ref` computed as the bf16 tensor-core kernel computes
    it (``csrc/rwkv6.cu``), so that its algebra can be held against the
    reference where the kernel cannot run.  Unlike the per-step chunked
    copy that the port once had (bit for bit the loop), this is another
    algorithm: T is cut into chunks of ``RWKV_CHUNK`` steps and each into
    sub-chunks of ``RWKV_SUB``; inside a chunk

        o_t = (r_t ⊙ Π_{τ<t} w_τ) · S_0 + Σ_{s<t} A_ts v_s + (r_t ⊙ u · k_t) v_t
        S_C = diag(Π_τ w_τ) · S_0 + Σ_s (k_s ⊙ Π_{τ>s} w_τ) v_sᵀ

    with A_ts = Σ_i r_ti k_si Π_{s<τ<t} w_τi.  Every decay is a product of
    w over an explicit range, never a ratio of products and never a
    logarithm, so each factor is at most 1, w = 0 gives exact zeros and
    nothing can overflow.  Between sub-chunks J < I, A is one product
    (r_t ⊙ Π_{I_0 ≤ τ < t} w)·(k_s ⊙ Π_{s < τ < I_0} w)ᵀ factored at the
    start I_0 of the row's sub-chunk; inside a sub-chunk A is summed
    element by element in fp32.  Steps past T decay by 1 and add nothing.

    The state's update takes each sub-chunk's (k_s ⊙ Π_{s<τ≤J_end} w)ᵀ v
    and rescales it in fp32 by the decay of the later sub-chunks.  The
    rounding points are the kernel's, in the inputs' dtype: each product's
    operands are split into a rounded high part and the rounded rest, and
    the product is hi·hi + hi·lo + lo·hi (v is exact, so A·V and the
    state's update take hi·v + lo·v); o is rounded once.  In fp32 the
    low parts are zero and the products exact fp32.  Callers on a card
    turn TF32 off.  Returns (o (B, H, T, Dv) in r.dtype, S_last
    (B, H, Dk, Dv) fp32)."""
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


def selective_scan_ref(x, dt, A, B, C, D_skip, h0=None):
    """Mamba S6 selective scan (diagonal, real A < 0), per channel d and
    state n, with an fp32 state h (Bt, Dm, N):

        h_l = exp(dt_l·A)·h_{l-1} + (dt_l·x_l)·B_l,    y_l = h_l·C_l + x_l·D

    x/dt (Bt, L, Dm) (dt after the softplus), A (Dm, N), B/C (Bt, L, N),
    D_skip (Dm,).  One loop over L that holds only h, where the reference
    runs an associative scan over (Bt, L, Dm, N) tensors (at Jamba's width
    four of 2.1 GB each).  Returns (y (Bt, L, Dm) in x.dtype, h_last
    (Bt, Dm, N) fp32).  Given float64 x, it runs in float64 throughout and
    returns float64 y and h_last: the arbiter that the fp32 kernel and
    this scan in fp32 are both held to over a long memory."""
    Bt, L, Dm = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf, Bf, Cf, Af = (t.to(acc) for t in (x, dt, B, C, A))
    h = (torch.zeros((Bt, Dm, A.shape[1]), dtype=acc, device=x.device)
         if h0 is None else h0.to(acc))
    ys = []
    for l in range(L):
        h = (torch.exp(dtf[:, l, :, None] * Af) * h
             + (dtf[:, l] * xf[:, l])[:, :, None] * Bf[:, l, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, l]))
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((Bt, 0, Dm), dtype=acc, device=x.device))
    return (y + xf * D_skip.to(acc)).to(x.dtype), h


def _row_rel_err(got, want) -> float:
    """The largest |got - want| / (|want| + rms of want's last-axis row)."""
    rms = want.square().mean(-1, keepdim=True).sqrt()
    den = (want.abs() + rms).clamp_min(torch.finfo(torch.float32).tiny)
    return ((got.float() - want).abs() / den).max().item()


def scan_rel_err(got, x, dt, A, B, C, D_skip) -> float:
    """How far a scan output ``got`` is from :func:`selective_scan_ref` run
    in fp32 on the same inputs: the largest |got - want| / (|want| + rms of
    want's (b, l) row).  A bf16 y is rounded once from fp32 h and y (at
    most 2^-8 of |want|); a decay taken one step late, the skip x·D
    dropped or one lane's states lost move rows by tenths of their rms,
    and the 2^-7 + 2^-7·|want| gate (its absolute floor) can miss a fault
    on small outputs."""
    want, _ = selective_scan_ref(*(t.float() for t in (x, dt, A, B, C,
                                                       D_skip)))
    return _row_rel_err(got, want)


def state_rel_err(h_last, x, dt, A, B, C, D_skip) -> float:
    """How far a scan's final state ``h_last`` (Bt, Dm, N) is from
    :func:`selective_scan_ref`'s run in fp32 on the same inputs: the
    largest |got - want| / (|want| + rms of want's (b, d) row over the N
    states).  Where decays lie within ~1e-3 of 1 (h remembers ~1000 steps)
    the exps' own rounding compounds over the memory, so h is held
    relative to its size, not to an absolute 1e-4; h rounded to bf16 reads
    up to 2^-8 of |want|."""
    _, want = selective_scan_ref(*(t.float() for t in (x, dt, A, B, C,
                                                       D_skip)))
    return _row_rel_err(h_last, want)

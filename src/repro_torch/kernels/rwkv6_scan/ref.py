"""Plain PyTorch version of the RWKV-6 (Finch) WKV recurrence, the
function the Pallas kernel ``repro/kernels/rwkv6_scan/rwkv6_scan.py::
_wkv6_kernel`` and the CUDA kernel beside it (``csrc/rwkv6_scan.cu``)
compute. Per (batch, head), with head size n and state S in R^{n x n}
(key index x value index):

    out_t = sum_i r_t[i] * (S[i, :] + u[i] * k_t[i] * v_t)
    S     = diag(w_t) S + k_t v_t^T

with the data-dependent decay w_t in (0, 1) and the per-head bonus u.
A Python loop over t in float32, batched over (batch, head); the sum
over i is taken as the Pallas kernel takes it, elementwise then summed
(no matrix product, so no TF32 on the card). The CPU path runs this
version; on the card it is the oracle (``mode="torch"``).

:func:`wkv6_chunked` is the same function in the order of the chunked
tensor-core kernel (``csrc/rwkv6_scan_hopper.cu``): 16 steps at a time,
from prefix, suffix and pairwise products of the decays, with the option
of the kernel's 3xTF32 operand splits. The CPU tests hold it to
:func:`wkv6_ref`; nothing on the card's path calls it.

:func:`wkv6_bwd_ref` is the recurrence's gradient, the reverse scan
written out in torch ops: the plain version of both backward kernels
(``csrc/rwkv6_scan_bwd.cu``, ``csrc/rwkv6_scan_bwd_hopper.cu``), which
the CPU path runs and the card's tests hold the kernels to.
:func:`wkv6_chunked_bwd` is the same gradient in the order of the chunked
backward kernel (``csrc/rwkv6_scan_bwd_hopper.cu``); the CPU tests hold
it to :func:`wkv6_bwd_ref` and to the JAX reference; nothing on the
card's path calls it.
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_bwd_ref", "wkv6_chunked", "wkv6_chunked_bwd", "wkv6_ref"]


def wkv6_ref(r, k, v, w, u, state=None):
    """r, k, v, w: (b, t, h, n); u: (h, n); state: (b, h, n, n) or None
    (zeros). Returns (out (b, t, h, n) in r's dtype, final state (b, h,
    n, n) float32, a new tensor)."""
    b, t, h, n = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]                        # (1, h, n, 1)
    if state is None:
        s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    else:
        s = state.float().clone()
    out = torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
    for i in range(t):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]    # (b, h, n, n)
        out[:, i] = ((s + uf * kv) * rf[:, i, :, :, None]).sum(dim=-2)
        s = wf[:, i, :, :, None] * s + kv
    return out.to(r.dtype), s


_BWD_CHUNK = 64                   # wkv6_bwd_ref's steps between snapshots


def wkv6_bwd_ref(r, k, v, w, u, state, dout, dstate):
    """The gradient of :func:`wkv6_ref` at r, k, v, w (b, t, h, n), u (h,
    n) and ``state`` (b, h, n, n) float32 or None (zeros), given ``dout``
    (b, t, h, n), the output's cotangent, and ``dstate`` (b, h, n, n), the
    final state's. Returns (dr, dk, dv in r's, k's, v's types, dw in
    w's, du (h, n) float32, dstate0 (b, h, n, n) float32, the initial
    state's). In float32, per (b, h), from dS = dstate back to step 0:

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dout_t
        dk_t = dS_t v_t + u * r_t (v_t . dout_t)
        dv_t = dS_t^T k_t + (sum_i r_t,i u_i k_t,i) dout_t
        dw_t = rowsum(dS_t * S_{t-1})
        du  += r_t * k_t (v_t . dout_t)                 (summed over b too)
        dS_{t-1} = diag(w_t) dS_t + r_t dout_t^T

    The forward states are recomputed a chunk at a time from snapshots
    taken every ``_BWD_CHUNK`` steps; none is recovered by dividing by w,
    which may be 0."""
    b, t, h, n = r.shape
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()[None]                                   # (1, h, n)
    if state is None:
        s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    else:
        s = state.float().clone()
    snaps = []
    for c0 in range(0, t, _BWD_CHUNK):
        snaps.append(s)
        for i in range(c0, min(t, c0 + _BWD_CHUNK)):
            s = wf[:, i, :, :, None] * s \
                + kf[:, i, :, :, None] * vf[:, i, :, None, :]
    ds = dstate.float().clone()
    grads = [torch.empty((b, t, h, n), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((h, n), dtype=torch.float32, device=r.device)
    for c, s in reversed(list(enumerate(snaps))):
        c0 = c * _BWD_CHUNK
        c1 = min(t, c0 + _BWD_CHUNK)
        prev = []                                          # S_{t-1}
        for i in range(c0, c1):
            prev.append(s)
            s = wf[:, i, :, :, None] * s \
                + kf[:, i, :, :, None] * vf[:, i, :, None, :]
        for i in reversed(range(c0, c1)):
            sp = prev[i - c0]
            ri, ki, vi, wi, di = (x[:, i] for x in (rf, kf, vf, wf, df))
            vdo = (vi * di).sum(-1, keepdim=True)          # (b, h, 1)
            ruk = (ri * uf * ki).sum(-1, keepdim=True)
            dr[:, i] = (sp * di[..., None, :]).sum(-1) + uf * ki * vdo
            dk[:, i] = (ds * vi[..., None, :]).sum(-1) + uf * ri * vdo
            dv[:, i] = (ds * ki[..., :, None]).sum(-2) + ruk * di
            dw[:, i] = (ds * sp).sum(-1)
            du += (ri * ki * vdo).sum(0)
            ds = wi[..., :, None] * ds + ri[..., :, None] * di[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, ds)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds it: float32 in and out."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """x = hi + lo, both TF32 (lo the rounded remainder)."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a, b, passes):
    """a @ b in float32; with ``passes`` 3 or 2 the kernel's split
    product: hi.hi' + hi.lo' + lo.hi' (3) or, b exact in TF32, a's hi and
    lo times b (2); None takes it as it is."""
    if passes is None:
        return a @ b
    ah, al = _split(a)
    if passes == 2:
        b = _tf32(b)
        return al @ b + ah @ b
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def wkv6_chunked(r, k, v, w, u, state=None, *, chunk=16, split_tf32=False):
    """:func:`wkv6_ref` taken ``chunk`` steps at a time, as the chunked
    kernel takes it. Per (batch, head) and key i, over a chunk's L steps
    from the state S_c at its start: prefix P_t = prod_{m<t} w_m, suffix
    Q_s = prod_{s<m<L} w_m, total D = prod_m w_m, and the pairwise decay
    W(t, s) = prod_{s<m<t} w_m as running products along t (no division,
    no logarithm); then

        A[t, s] = sum_i r_t W(t, s) k_s (s < t),  A[t, t] = sum_i r_t u k_t,
        out     = (r * P) . S_c + A . v,
        S_c+1   = diag(D) S_c + (k * Q)^T . v.

    The last chunk runs its own steps only. With ``split_tf32`` each
    product takes its operands as the kernel does: ``(r * P) . S`` in 3
    TF32 passes, ``A . v`` and ``(k * Q)^T . v`` in 2 (v taken as TF32).
    Same arguments and results as :func:`wkv6_ref`."""
    b, t, h, n = r.shape
    rf, kf, vf, wf = (x.float().transpose(1, 2) for x in (r, k, v, w))
    uf = u.float()[None, :, :]                              # (1, h, n)
    if state is None:
        s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    else:
        s = state.float().clone()
    out = torch.empty((b, h, t, n), dtype=torch.float32, device=r.device)
    p3, p2 = (3, 2) if split_tf32 else (None, None)
    for c0 in range(0, t, chunk):
        rc, kc, vc, wc = (x[:, :, c0:c0 + chunk] for x in (rf, kf, vf, wf))
        L = rc.shape[2]
        pre = torch.empty_like(rc)                          # P_t
        suf = torch.empty_like(kc)                          # Q_s
        run = torch.ones_like(rc[:, :, 0])
        for i in range(L):
            pre[:, :, i] = run
            run = run * wc[:, :, i]
        d = run                                             # D
        run = torch.ones_like(kc[:, :, 0])
        for i in reversed(range(L)):
            suf[:, :, i] = run
            run = run * wc[:, :, i]
        a = torch.zeros((b, h, L, L), dtype=torch.float32, device=r.device)
        for j in range(L):
            kw = kc[:, :, j]
            for i in range(j + 1, L):
                if i > j + 1:
                    kw = kw * wc[:, :, i - 1]
                a[:, :, i, j] = (rc[:, :, i] * kw).sum(-1)
            a[:, :, j, j] = (rc[:, :, j] * uf * kc[:, :, j]).sum(-1)
        out[:, :, c0:c0 + L] = _mm(rc * pre, s, p3) + _mm(a, vc, p2)
        s = d[..., None] * s + _mm((kc * suf).transpose(-1, -2), vc, p2)
    return out.transpose(1, 2).to(r.dtype), s


def _pad_rows(x, rows, fill):
    """x (b, h, L, n) padded to ``rows`` steps with ``fill``."""
    if x.shape[2] == rows:
        return x
    pad = x.new_full((*x.shape[:2], rows - x.shape[2], x.shape[3]), fill)
    return torch.cat([x, pad], dim=2)


def wkv6_chunked_bwd(r, k, v, w, u, state, dout, dstate, *, chunk=16,
                     split_tf32=False):
    """:func:`wkv6_bwd_ref` taken ``chunk`` steps at a time, in the order
    of the chunked backward kernel. Same arguments and results.

    Per (batch, head), the chunks run backward from G = ``dstate``, each
    from its start state S_c (recomputed forward, as :func:`wkv6_chunked`
    takes it). With the chunk's L steps padded to ``chunk`` (r, k, v,
    dout 0 and w 1 past L, so every padded term is 0), per key i the
    prefix P_t = prod_{m<t} w_m, suffix Q_s = prod_{s<m<L} w_m, total D
    and pairwise decay M(t, s) = prod_{s<m<t} w_m (s < t), all plain
    products (no division, no logarithm):

        dA    = tril(dout . v^T)                 X = S_c . dout^T
        Y     = G . v^T                          rs = rowsum(S_c * G)
        dv    = A^T . dout + (k * Q) . G         (A as in wkv6_chunked)
        dS_c  = diag(D) G + (r * P)^T . dout     (G of the chunk before)

    and per key i and step t the in-chunk sums by the kernel's
    recurrence: Z_{m+1}(t) = w_m Z_m(t) + dA[t, m] k_m from Z_0 = 0, so
    Z_m(t) = sum_{s<m} dA[t, s] M(m, s) k_s, then

        dr_t = P_t X[:, t] + Z_t(t) + dA[t, t] u k_t
        dk_s = Q_s Y[:, s] + sum_{t>s} dA[t, s] M(t, s) r_t + dA[s, s] r_s u
        dw_m = P_m Q_m rs + sum_{t>m} M(t, m) r_t (Z_m(t) + P_m X[:, t])
               + Q_m sum_{s<m} M(m, s) k_s Y[:, s]
        du  += sum_t dA[t, t] r_t k_t            (summed over b too)

    (dw_m is rowsum(dS_m * S_{m-1}) split into its cross-chunk and
    in-chunk parts). With ``split_tf32`` each product takes its operands
    as the kernel does: bf16 operands exact, each float32 one split into
    two TF32 parts, so X, Y, (r * P)^T . dout, A^T . dout and the state
    update (k * Q)^T . v take 2 passes and (k * Q) . G takes 3; dA is a
    product of bf16 values summed in float32 (exact terms)."""
    b, t, h, n = r.shape
    rf, kf, vf, wf, df = (x.float().transpose(1, 2)
                          for x in (r, k, v, w, dout))      # (b, h, t, n)
    uf = u.float()[None, :, :, None]                        # (1, h, n, 1)
    p2, p3 = (2, 3) if split_tf32 else (None, None)
    dev = r.device
    if state is None:
        s = torch.zeros((b, h, n, n), dtype=torch.float32, device=dev)
    else:
        s = state.float().clone()
    steps = torch.arange(chunk, device=dev)

    def tiles(c0):
        """The chunk's r, k, v, dout, w, padded; keys-first copies of r,
        k, w (b, h, n, chunk); Q (b, h, n, chunk) and D (b, h, n)."""
        sl = slice(c0, c0 + chunk)
        rc, kc, vc, dc = (_pad_rows(x[:, :, sl], chunk, 0.0)
                          for x in (rf, kf, vf, df))
        wc = _pad_rows(wf[:, :, sl], chunk, 1.0)
        rk, kk, wk = (x.transpose(-1, -2) for x in (rc, kc, wc))
        q = torch.empty_like(wk)
        run = torch.ones_like(wk[..., 0])
        for i in reversed(range(chunk)):
            q[..., i] = run
            run = run * wk[..., i]
        return rc, kc, vc, dc, rk, kk, wk, q, run

    starts = []
    for c0 in range(0, t, chunk):
        starts.append(s)
        if c0 + chunk < t:
            _, kc, vc, _, _, kk, _, q, d = tiles(c0)
            s = d[..., None] * s + _mm(kk * q, vc, p2)
    g = dstate.float().clone()
    grads = [torch.empty((b, h, t, n), dtype=torch.float32, device=dev)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((h, n), dtype=torch.float32, device=dev)
    for c, sc in reversed(list(enumerate(starts))):
        c0 = c * chunk
        L = min(chunk, t - c0)
        rc, kc, vc, dc, rk, kk, wk, q, d = tiles(c0)
        x = _mm(sc, dc.transpose(-1, -2), p2)               # X (b, h, n, C)
        y = _mm(g, vc.transpose(-1, -2), p2)                # Y
        da = torch.tril(dc @ vc.transpose(-1, -2))          # dA[t, s]
        rs = (sc * g).sum(-1)[..., None]                    # (b, h, n, 1)
        # M(t, m) per key as the kernel's thread (key, t) builds it: a
        # running product down from m = t - 1
        mrow = torch.zeros((b, h, n, chunk, chunk), dtype=torch.float32,
                           device=dev)
        run = torch.ones_like(rk)
        for m in reversed(range(chunk)):
            on = steps > m
            mrow[..., m] = torch.where(on, run, 0.0)
            run = torch.where(on, run * wk[..., m:m + 1], run)
        z = torch.zeros_like(rk)                            # Z_m(t)
        f = torch.zeros_like(rk)
        pm = torch.ones_like(rk[..., 0])                    # P_m
        pt = torch.ones_like(rk)                            # P_t
        part = torch.zeros_like(mrow)                       # [.., t, m]
        part3 = torch.zeros_like(mrow)
        aterm = torch.zeros_like(mrow)                      # A's terms
        for m in range(chunk):
            on = steps > m
            dam = da[:, :, None, :, m]                      # dA[t, m]
            mrr = mrow[..., m] * rk
            part[..., m] = mrr * (z + pm[..., None] * x)
            part3[..., m] = mrr * dam
            cm = mrow[..., m] * kk[..., m:m + 1]
            f = f + cm * y[..., m:m + 1]
            aterm[..., m] = torch.where(
                on, rk * cm, torch.where(steps == m, rk * uf * kk, 0.0))
            z = torch.where(on, wk[..., m:m + 1] * z + dam * kk[..., m:m + 1],
                            z)
            pt = torch.where(steps == m, pm[..., None], pt)
            pm = pm * wk[..., m]
        dag = torch.diagonal(da, dim1=-2, dim2=-1)[:, :, None, :]
        dr_c = pt * x + z + dag * uf * kk
        dk_c = q * y + part3.sum(-2) + dag * rk * uf
        dw_c = pt * q * rs + part.sum(-2) + q * f
        du += (dag * rk * kk).sum((0, 3))
        a = aterm.sum(2)                                    # (b, h, C, C)
        kq = (kk * q).transpose(-1, -2)                     # (k * Q)[s, i]
        dv_c = _mm(a.transpose(-1, -2), dc, p2) + _mm(kq, g, p3)
        g = d[..., None] * g + _mm(rk * pt, dc, p2)
        for out, val in ((dr, dr_c.transpose(-1, -2)),
                         (dk, dk_c.transpose(-1, -2)), (dv, dv_c),
                         (dw, dw_c.transpose(-1, -2))):
            out[:, :, c0:c0 + L] = val[:, :, :L]
    dr, dk, dv, dw = (x.transpose(1, 2) for x in grads)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, g)

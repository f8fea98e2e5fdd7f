"""Plain PyTorch version of Mamba's selective scan, the function the CUDA
kernels beside it (``csrc/mamba_scan.cu``, ``csrc/mamba_scan_bwd.cu``)
compute. Per (batch, channel d) with a state of N elements:

    a_t = exp(dt_t A),   u_t = f32(dt_t) f32(x_t)
    h_t = a_t h_{t-1} + u_t B_t,   y_t = sum_n C_{t,n} h_{t,n}

dt * x is a float32 product (the reference's scan multiplies it in
float32, its decode step in the activation dtype), the state is float32,
and y is rounded to the activation dtype once a step. The reference has
no Pallas kernel here: it runs an XLA ``lax.scan``
(``repro/models/mamba.py:124``) and differentiates it with ``jax.grad``.

:func:`scan_ref` is the port's scan as ``models/mamba.py`` ran it before
the kernel: its elementwise terms, exp(dt A) and dt x B, for a segment of
steps at once, the recurrence one in-place multiply-add a step, and the
read-out C . h as a float32 einsum a segment. With ``snapshots`` it also
returns the state at the start of each segment, from which
:func:`scan_bwd_ref` recomputes the segment's states and runs back
through it. Going backward, with g_t the state's cotangent:

    g_t    = a_{t+1} g_{t+1} + dy_t C_t       (g_T: the final state's)
    dC_t   = sum_d dy_t h_t        du_t = sum_n g_t B_t
    dB_t   = sum_d g_t u_t         dx_t = du_t dt_t
    ddt_t  = sum_n g_t h_{t-1} a_t A + du_t x_t
    dA     = sum_{b,t} g_t h_{t-1} a_t dt_t,   dh0 = a_1 g_1

The CPU path runs these versions; on the card they are the kernels'
oracle (``mode="torch"``).
"""
from __future__ import annotations

import torch

__all__ = ["SEGMENT", "scan_bwd_ref", "scan_ref"]

# steps a segment: the scan's block of elementwise terms, and the steps
# between the snapshots the backward recomputes from
SEGMENT = 64


def scan_ref(xc, dt, b_mat, c_mat, a, h0=None, *, segment=SEGMENT,
             snapshots=False, out_dtype=None):
    """The selective scan over s steps. xc, dt (b, s, d_in); b_mat, c_mat
    (b, s, N) (any strides); a (d_in, N) float32; h0 (b, d_in, N) float32
    (read, not written) or None for zeros. Returns (y (b, s, d_in) in
    ``out_dtype`` (default xc's), the state after the last step (b, d_in,
    N) float32) and, with ``snapshots``, the float32 state at the start
    of each ``segment``-step segment (b, ceil(s / segment), d_in, N)."""
    b, s, d_in = xc.shape
    out_dtype = out_dtype or xc.dtype
    if h0 is None:
        h0 = torch.zeros((b, d_in, a.shape[-1]), dtype=torch.float32,
                         device=xc.device)
    # step-major copies, so that each segment's and each step's slices are
    # contiguous
    xc_t, dt_t, b_t, c_t = (v.transpose(0, 1).contiguous()
                            for v in (xc, dt, b_mat, c_mat))
    y_t = torch.empty((s, b, d_in), dtype=out_dtype, device=xc.device)
    h, snaps = h0, []
    for t0 in range(0, s, segment):
        t1 = min(s, t0 + segment)
        snaps.append(h)
        dt_c = dt_t[t0:t1].float()                            # (L, b, d_in)
        da = torch.exp(dt_c[..., None] * a)                   # (L, b, d_in, N)
        hs = (dt_c * xc_t[t0:t1].float())[..., None] \
            * b_t[t0:t1].float()[:, :, None, :]               # dt x B
        for i in range(t1 - t0):                  # h_i = da_i h_{i-1} + bb_i
            h = hs[i].addcmul_(da[i], h)
        y_t[t0:t1] = torch.einsum("lbdn,lbn->lbd", hs, c_t[t0:t1].float())
        h = h.clone() if t1 < s else h            # hs is freed with the block
    y = y_t.transpose(0, 1)
    if not snapshots:
        return y, h
    return y, h, torch.stack(snaps, 1)


def scan_bwd_ref(xc, dt, b_mat, c_mat, a, h0, dy, dh=None, *, snaps=None,
                 segment=SEGMENT, want_dh0=False):
    """The gradient of :func:`scan_ref` at xc, dt, b_mat, c_mat, a, h0
    (None: zeros), given y's cotangent ``dy`` (b, s, d_in) and the final
    state's ``dh`` (b, d_in, N) float32 or None (zeros). ``snaps``: the
    forward's snapshots at this ``segment`` (recomputed if None). Each
    segment's states are recomputed from its snapshot as the forward
    computes them, then the segment is run backward. Returns (dxc, ddt,
    dB, dC, each in its input's dtype, accumulated in float32 and rounded
    once; dA (d_in, N) float32; dh0 (b, d_in, N) float32 with
    ``want_dh0``, else None)."""
    b, s, d_in = xc.shape
    n = a.shape[-1]
    dev, f32 = xc.device, torch.float32
    if snaps is None:
        snaps = scan_ref(xc, dt, b_mat, c_mat, a, h0, segment=segment,
                         snapshots=True)[2]
    xf, dtf, bf, cf, dyf = (v.float() for v in (xc, dt, b_mat, c_mat, dy))
    uf = dtf * xf                                             # (b, s, d_in)
    g = (torch.zeros((b, d_in, n), dtype=f32, device=dev) if dh is None
         else dh.float().clone())
    dx = torch.empty((b, s, d_in), dtype=f32, device=dev)
    ddt = torch.empty_like(dx)
    db = torch.empty((b, s, n), dtype=f32, device=dev)
    dc = torch.empty_like(db)
    da_sum = torch.zeros((d_in, n), dtype=f32, device=dev)
    for k in reversed(range(snaps.shape[1])):
        t0, t1 = k * segment, min(s, (k + 1) * segment)
        da = torch.exp(dtf[:, t0:t1, :, None] * a)            # (b, L, d, N)
        bb = uf[:, t0:t1, :, None] * bf[:, t0:t1, None, :]
        hs = [snaps[:, k]]                        # hs[i]: before step t0 + i
        for i in range(t1 - t0):
            hs.append(torch.addcmul(bb[:, i], da[:, i], hs[-1]))
        for i in reversed(range(t1 - t0)):
            t = t0 + i
            g = g + dyf[:, t, :, None] * cf[:, t, None, :]    # g_t
            dc[:, t] = torch.einsum("bdn,bd->bn", hs[i + 1], dyf[:, t])
            du = (g * bf[:, t, None, :]).sum(-1)              # (b, d_in)
            db[:, t] = torch.einsum("bdn,bd->bn", g, uf[:, t])
            gha = g * hs[i] * da[:, i]
            ddt[:, t] = (gha * a).sum(-1) + du * xf[:, t]
            da_sum += (gha * dtf[:, t, :, None]).sum(0)
            dx[:, t] = du * dtf[:, t]
            g = da[:, i] * g                      # a_t g_t, into g_{t-1}
    return (dx.to(xc.dtype), ddt.to(dt.dtype), db.to(b_mat.dtype),
            dc.to(c_mat.dtype), da_sum, g if want_dh0 else None)

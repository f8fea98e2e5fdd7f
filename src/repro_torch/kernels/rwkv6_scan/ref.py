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
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_ref"]


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

"""Plain PyTorch version of flash attention (causal / sliding-window /
non-causal, GQA), the function the Pallas kernel
``repro/kernels/flash_attention/flash_attention.py::_attn_kernel``
computes and the CUDA kernel beside it (``csrc/flash_attention.cu``)
computes:

    s    = (f32(q) * f32(d ** -0.5)) @ f32(k)^T       masked to -1e30
    p    = exp(s - rowmax(s)), and 0 where masked
    out  = (p @ f32(v)) / max(sum(p), 1e-30)          in q's dtype

with the mask ``k_pos < kv_len``, causal ``k_pos <= q_pos`` and, for a
window w > 0, ``k_pos > q_pos - w``, where ``q_pos = q_offset + i``.
Rows with no key to see come out 0, as in the Pallas kernel. q-head h
reads kv-head ``h // (hq // hkv)`` without repeating K/V.

``p`` stays float32 into the PV product, as in the Pallas kernel. (The
reference's XLA path, ``repro/kernels/flash_attention/ref.py``, rounds
``p`` to the activation dtype first, so in bfloat16 the two agree only
to bfloat16 rounding.) The softmax is taken over the whole row at once;
the kernel's online softmax over kv tiles gives the same function up to
float32 rounding. The CPU path runs this version.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref", "live_pairs", "sm_scale"]

NEG_INF = -1e30


def sm_scale(d: int) -> float:
    """``d ** -0.5`` rounded to float32, as the reference multiplies it
    into a float32 array."""
    return float(torch.tensor(d ** -0.5, dtype=torch.float32))


def _mask(sq, skv, q_offset, causal, window, device):
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def live_pairs(sq, skv, *, causal=True, window=0, q_offset=None) -> int:
    """Number of (query, key) pairs the mask lets through, per (batch,
    head): the work a kernel that skips masked keys has to do."""
    if q_offset is None:
        q_offset = skv - sq
    return int(_mask(sq, skv, q_offset, causal, window, "cpu").sum())


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=None):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d), float32 or bfloat16
    (q and k/v may differ). Returns (b, sq, hq, d) in q's dtype.
    ``q_offset`` is the absolute position of q[:, 0]: None means
    ``skv - sq`` (aligned to the end)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    group = hq // hkv
    qf = (q.float() * sm_scale(d)).reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    mask = _mask(sq, skv, int(q_offset), causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)

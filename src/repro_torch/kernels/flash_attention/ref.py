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

``p`` stays float32 into the PV product, as in the Pallas kernel and the
CUDA-core kernel (``simt``). The reference's XLA path,
``repro/kernels/flash_attention/ref.py``, rounds ``p`` to the activation
dtype first, and so does the tensor-core kernel (``wgmma``,
``csrc/flash_attention_hopper.cu``): in bfloat16 those agree with this
version only to bfloat16 rounding. The softmax is taken over the whole row at once;
the kernel's online softmax over kv tiles gives the same function up to
float32 rounding. The CPU path runs this version.

:func:`attention_lse_ref` adds each row's log-sum-exp, which the forward
kernels write when a gradient is asked for, and :func:`attention_bwd_ref`
is the backward from it (the backward kernels' math, with the tensor-core
one's rounding of ds as an option): the CPU path's gradient, and what
the kernels are held against on the card.

:func:`attention_partials` and :func:`combine_partials` are the split-kv
decode's math in plain PyTorch (``csrc/flash_attention_hopper.cu``): the
keys one query sees, cut into chunks, each chunk's (m, l, acc), and the
merge. Together they equal :func:`attention_ref` for a single query row.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_bwd_ref", "attention_lse_ref",
           "attention_partials", "attention_ref", "combine_partials",
           "live_pairs", "sm_scale", "visible_keys"]

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
    return attention_lse_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)[0]


def attention_lse_ref(q, k, v, *, causal=True, window=0, q_offset=None):
    """:func:`attention_ref` and each row's log-sum-exp of its scaled,
    masked scores, ``m + log(max(l, 1e-30))``: (out, lse (b, hq, sq)
    float32), what the forward kernels write for the backward."""
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
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    o = o / l
    lse = (m + torch.log(l)).reshape(b, hq, sq)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype), lse


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, window=0,
                      q_offset=None, variant="simt"):
    """The gradient of :func:`attention_ref` by explicit formulas from the
    forward's log-sum-exp, as the backward kernels
    (``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd_hopper.cu``)
    compute it:

        p  = exp(s - lse), 0 where masked;   D = rowsum(dout * out)
        dv = r(p)^T dout;   dp = dout v^T;   ds = p * (dp - D)
        dq = r'(ds) k * d ** -0.5;   dk = r'(ds)^T (q * d ** -0.5)

    in float32, where ``r`` rounds p to bfloat16 when q is bfloat16 (the
    JAX package's ``attention_ref`` rounds p to q's type before its PV
    product, so its gradient forms dv from the rounded p). ``r'`` is the
    identity for ``variant="simt"`` (the CUDA-core kernel, and the JAX
    package's gradient, keep ds in float32) and, for ``variant="wgmma"``
    with a bfloat16 q, rounds ds to bfloat16 as the tensor-core kernel's
    operands are. GQA: dk and dv of a kv-head sum over its q-heads.
    ``out`` (q's shape) and ``lse`` (b, hq, sq) are the forward's;
    ``dout`` the gradient of ``out``. Returns (dq in q's dtype, dk and dv
    in k's)."""
    if variant not in ("simt", "wgmma"):
        raise ValueError(f"variant must be 'simt' or 'wgmma', got {variant!r}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    group = hq // hkv
    scale = sm_scale(d)
    qf = (q.float() * scale).reshape(b, sq, hkv, group, d)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(b, sq, hkv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    mask = _mask(sq, skv, int(q_offset), causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, group, sq, 1)),
                    0.0)
    pv = p.to(torch.bfloat16).float() if q.dtype == torch.bfloat16 else p
    delta = (dout.float() * out.float()).sum(-1)              # (b, sq, hq)
    delta = delta.permute(0, 2, 1).reshape(b, hkv, group, sq, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pv, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta)
    if variant == "wgmma" and q.dtype == torch.bfloat16:
        ds = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def visible_keys(skv, *, causal=True, window=0, q_offset=0):
    """(lo, n): the keys [lo, lo + n) a single query at position
    ``q_offset`` sees in a cache of ``skv`` slots (n may be 0)."""
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(skv - 1, q_offset) if causal else skv - 1
    return lo, max(0, hi - lo + 1)


def attention_partials(q, k, v, *, causal=True, window=0, q_offset=None,
                       splits=1):
    """The split-kv decode's chunks: for q (b, 1, hq, d) and k, v (b, skv,
    hkv, d), the visible keys [lo, lo + n) cut into ``splits`` chunks of
    ceil(n / splits) rows; per chunk and (batch, q-head) the float32 row
    max m of the scores, l = sum(exp(s - m)) and acc = exp(s - m) @ v.
    Returns m, l (b, hq, splits) and acc (b, hq, splits, d); a chunk in
    which nothing is seen has m = -1e30, l = 0, acc = 0."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sq != 1:
        raise ValueError(f"split-kv takes one query row, got {sq}")
    if q_offset is None:
        q_offset = skv - 1
    lo, n = visible_keys(skv, causal=causal, window=window,
                         q_offset=int(q_offset))
    chunk = -(-n // splits) if n else 1
    group = hq // hkv
    qf = (q.float() * sm_scale(d)).reshape(b, hkv, group, d)
    m = torch.full((b, hq, splits), NEG_INF, device=q.device)
    l = torch.zeros(b, hq, splits, device=q.device)
    acc = torch.zeros(b, hq, splits, d, device=q.device)
    for i in range(splits):
        a, e = lo + i * chunk, min(lo + (i + 1) * chunk, lo + n)
        if a >= e:
            continue
        s = torch.einsum("bhgd,bkhd->bhgk", qf, k[:, a:e].float())
        mi = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - mi)
        m[:, :, i] = mi.reshape(b, hq)
        l[:, :, i] = p.sum(dim=-1).reshape(b, hq)
        acc[:, :, i] = torch.einsum("bhgk,bkhd->bhgd", p,
                                    v[:, a:e].float()).reshape(b, hq, d)
    return m, l, acc


def combine_partials(m, l, acc, dtype=torch.float32):
    """Merge the chunks of :func:`attention_partials`: weights w_i =
    exp(m_i - max m), out = sum(acc_i w_i) / max(sum(l_i w_i), 1e-30).
    Returns (b, 1, hq, d) in ``dtype``."""
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    num = (acc * w[..., None]).sum(dim=2)
    den = (l * w).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (num / den)[:, None].to(dtype)

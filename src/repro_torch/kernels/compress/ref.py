"""Plain PyTorch versions of the compression kernels.

Semantics and wire formats are the reference's
(``repro/kernels/compress/ref.py``); every function here takes a batch
of senders, one row each, for ONE leaf of ``p`` values:

* top-k / rand-k select is *strict-above + tie-fill*: every position
  whose score is strictly above the k-th largest score is kept, and the
  remaining ``k - n_strict`` slots go to ``== threshold`` ties in index
  order -- ``lax.top_k``'s exact kept set. ``ranks`` holds each kept
  coordinate's wire slot in [0, k), else -1. Unbiased rand-k multiplies
  the kept values by the float32 ``scale`` = f32(p / k).
* int8: ``repro_torch.kernels.quantize.ref`` -- per 128-value row of the
  leaf (the last row zero-padded), ``scale = max(absmax * (1/127),
  1e-12)``, ``q = clip(floor(msg / scale + u), -127, 127)``,
  ``dq = q * scale``.
* sign: one bit per value, 8 per byte, (rows, 16) uint8 per leaf; lane
  ``8c + j`` of a row at bit ``j`` of byte ``c``, 1 where ``msg >= 0``
  (padding lanes read 0, so their bit is 1); ``dq = scale * sign(msg)``
  with ``sign(0) = 0``.
* error feedback (the ``ef_*`` functions): ``msg = delta + ef``; outputs
  are ``dq`` and ``ef_new = msg - dq``. Without it the message is the
  input ``v`` itself and there is no residual.

The threshold (:func:`kth_threshold`) and the sign scale (``mean |msg|``)
are computed outside the kernels, as in the reference, and handed to
both versions. Each operation is one rounding in the reference's order,
so the CUDA kernels (``csrc/compress.cu``) agree with these bit for bit.
The CPU path runs them; on the card they run only under
``mode="torch"``, for comparisons.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize.ref import INV127, quantize_int8_ref, \
    to_rows
from repro_torch.kernels.segments import LANES

__all__ = ["INV127", "LANES", "ef_quantize_int8_ref", "ef_randk_select_ref",
           "ef_sign_compress_ref", "ef_topk_select_ref", "kth_threshold",
           "pack_topk", "randk_select_ref", "select_tiled",
           "sign_compress_ref", "sign_unpack", "topk_select_ref",
           "unpack_topk"]


def kth_threshold(score: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest entry of each row of ``score`` (B, p) -> (B,): the
    least of an unsorted top-k (the k largest need no order). For
    finite scores it equals the k-th of a sorted top-k; a row holding a
    NaN among its k largest reads NaN."""
    return torch.topk(score, k, dim=-1, sorted=False).values.amin(-1)


def _select(score, v, thresh, k: int, scale=None):
    """Strict-above + tie-fill select on (B, p) -> (dq, ranks int32);
    kept values times ``scale`` where one is given."""
    t = thresh[..., None]
    strict = score > t
    tie = score == t
    cap = k - strict.sum(dim=-1, keepdim=True, dtype=torch.int32)
    inc_s = strict.cumsum(dim=-1, dtype=torch.int32)
    inc_t = tie.cumsum(dim=-1, dtype=torch.int32)
    sel = strict | (tie & (inc_t <= cap))
    rank = inc_s + torch.minimum(inc_t, cap) - 1
    kept = v if scale is None else v * scale
    dq = torch.where(sel, kept,
                     torch.zeros((), dtype=v.dtype, device=v.device))
    ranks = torch.where(sel, rank, torch.full_like(rank, -1))
    return dq, ranks


def select_tiled(score, v, thresh, k: int, tile: int, scale=None):
    """:func:`_select` as the tiled kernel computes it
    (``csrc/select_hopper.cu``), on (B, p) cut into tiles of ``tile``
    values: (1) each tile's strict and tie counts; (2) for each tile the
    counts of the tiles before it, the leaf's cap = k - (its strict
    count), and the inclusive counts inside the tile on top. Returns
    (dq, ranks int32), equal to :func:`_select`'s."""
    b, p = score.shape
    nt = -(-p // tile)
    t = thresh[..., None]

    def tiles(mask):
        return torch.nn.functional.pad(mask.to(torch.int64),
                                       (0, nt * tile - p)).view(b, nt, tile)

    strict, tie = tiles(score > t), tiles(score == t)
    n_s, n_t = strict.sum(-1), tie.sum(-1)                # (B, tiles)
    cap = k - n_s.sum(-1)[:, None, None]
    inc_s = (n_s.cumsum(-1) - n_s)[..., None] + strict.cumsum(-1)
    inc_t = (n_t.cumsum(-1) - n_t)[..., None] + tie.cumsum(-1)
    sel = (strict == 1) | ((tie == 1) & (inc_t <= cap))
    rank = inc_s + torch.minimum(inc_t, cap) - 1
    sel = sel.view(b, -1)[:, :p]
    kept = v if scale is None else v * scale
    dq = torch.where(sel, kept,
                     torch.zeros((), dtype=v.dtype, device=v.device))
    ranks = torch.where(sel, rank.view(b, -1)[:, :p].to(torch.int32),
                        torch.full((), -1, dtype=torch.int32,
                                   device=v.device))
    return dq, ranks


def topk_select_ref(v, k: int, thresh=None):
    """Magnitude top-k: select on ``|v|``. ``thresh`` (B,) is the k-th
    largest ``|v|`` (computed here if None). Returns (dq, ranks)."""
    score = v.abs()
    if thresh is None:
        thresh = kth_threshold(score, k)
    return _select(score, v, thresh, k)


def randk_select_ref(u, v, k: int, scale=None, thresh=None):
    """Rand-k: keep the k positions with the largest uniforms ``u``
    (B, p), values times the float32 ``scale`` (f32(p / k) for the
    unbiased estimator; None keeps them as they are); ``thresh`` is the
    k-th largest ``u``. Returns (dq, ranks)."""
    if thresh is None:
        thresh = kth_threshold(u, k)
    return _select(u, v, thresh, k, scale)


def ef_topk_select_ref(delta, ef, k: int, thresh=None):
    """EF + magnitude top-k on ``msg = delta + ef``. Returns (dq, ranks,
    ef_new)."""
    msg = delta + ef
    dq, ranks = topk_select_ref(msg, k, thresh)
    return dq, ranks, msg - dq


def ef_randk_select_ref(u, delta, ef, k: int, thresh=None):
    """EF + contractive rand-k (values unscaled). Returns (dq, ranks,
    ef_new)."""
    msg = delta + ef
    dq, ranks = randk_select_ref(u, msg, k, None, thresh)
    return dq, ranks, msg - dq


def ef_quantize_int8_ref(delta, ef, noise):
    """EF + stochastic int8 over the leaf's 128-value rows. Returns
    (q (B, p) int8, scales (B, rows) f32, dq (B, p), ef_new (B, p))."""
    msg = delta + ef
    q, scales, dq = quantize_int8_ref(msg, noise)
    return q, scales, dq, msg - dq


def _pack_bits(nonneg):
    """(B, rows, 128) bool -> (B, rows, 16) uint8, lane 8c+j at bit j of
    byte c."""
    b = nonneg.to(torch.uint8).unflatten(-1, (LANES // 8, 8))
    weights = (1 << torch.arange(8, dtype=torch.uint8, device=b.device))
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def sign_compress_ref(v, scale=None):
    """1-bit sign; ``scale`` (B,) defaults to ``mean |v|``. Returns
    (bits (B, rows, 16) uint8, scale (B,), dq)."""
    if scale is None:
        scale = v.abs().mean(dim=-1)
    bits = _pack_bits(to_rows(v) >= 0)
    return bits, scale, scale[..., None] * torch.sign(v)


def ef_sign_compress_ref(delta, ef, scale=None):
    """EF + 1-bit sign; ``scale`` (B,) defaults to ``mean |msg|``.
    Returns (bits (B, rows, 16) uint8, scale (B,), dq, ef_new)."""
    msg = delta + ef
    bits, scale, dq = sign_compress_ref(msg, scale)
    return bits, scale, dq, msg - dq


def pack_topk(dq, ranks, k: int):
    """Dense (dq, ranks) of one leaf (p,) -> the (k,) wire buffers
    (values, int32 indices); slots no coordinate fills read 0 / -1."""
    p = dq.shape[-1]
    safe = torch.where(ranks >= 0, ranks.long(), torch.full_like(
        ranks, k, dtype=torch.long))
    vals = dq.new_zeros((k + 1,)).scatter(0, safe, dq)[:k]
    idx = torch.full((k + 1,), -1, dtype=torch.int32,
                     device=dq.device).scatter(
        0, safe, torch.arange(p, dtype=torch.int32, device=dq.device))[:k]
    return vals, idx


def unpack_topk(vals, idx, p: int):
    """Scatter the (k,) wire buffers back to a dense (p,) leaf: the
    receiver side of the top-k / rand-k link."""
    safe = torch.where(idx >= 0, idx.long(),
                       torch.full_like(idx, p, dtype=torch.long))
    kept = torch.where(idx >= 0, vals, torch.zeros_like(vals))
    return vals.new_zeros((p + 1,)).scatter(0, safe, kept)[:p]


def sign_unpack(bits, scale, p: int):
    """Decode one leaf's 1-bit wire, (rows, 16) uint8 + scale, to (p,)
    values of ``±scale``. Exact zeros were sent as ``+scale``, the one
    lossy edge of the wire format."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    lanes = (bits[..., None] >> shifts) & 1
    pm1 = lanes.reshape(-1).to(torch.float32) * 2.0 - 1.0
    return (scale * pm1)[:p]

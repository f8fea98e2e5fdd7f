"""Plain PyTorch versions of MoE routing.

:func:`route_ref` is the function the Pallas kernel
``repro/kernels/moe_router/moe_router.py::_router_kernel`` computes and
the CUDA kernel beside it (``csrc/moe_router.cu``) computes:

    p      = softmax(f32(logits))                      over experts
    top-k  by k rounds of max / argmax / mask          (ties: lower index)
    gates  = g_j, renormalised by max(sum_j g_j, 1e-20) (in logits' type)
    stats  = per-expert sum of p and count of selections over tokens

``mean_prob = sum(p) / t`` and ``frac_tokens = count / (t * k)``. The
softmax sums each row in the order the kernel's warp does (lane i holds
experts i, i+32, ...; then an xor butterfly over the 32 lanes), so on
the card the two give the same probabilities, bit for bit, and the same
choices. The CPU path runs this version.

:func:`route_tokens_ref` is the whole routing of the MoE layer, which
``csrc/moe_router_hopper.cu`` computes in one kernel: the float32 router
product, :func:`route_ref` on its logits, and :func:`positions_ref`, the
reference's ``cumsum`` over the (groups, group * k, E) one-hot selection
(``repro/models/moe.py``) that gives each choice its place in its
expert's capacity buffer, before capacity is applied.

Both are differentiable in the logits (and in x and w) by autograd, as
the reference's ``route_ref`` is by ``jax.grad``: the top-k rounds mask
the chosen expert out of a new tensor each round, so no tensor autograd
saved is written. :func:`route_tokens_bwd_ref` is the same gradient in
closed form, the plain version of the backward kernel
``csrc/moe_router_bwd.cu``; :func:`route_tokens_full_bwd_ref` adds the
router product's dx and dw, the plain version of
``csrc/moe_router_bwd_hopper.cu``, and :func:`full_bwd_pieces` computes
them in that kernel's arithmetic (bf16 pieces, its products, its running
sum), for the tests to hold to the exact products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "full_bwd_pieces", "load_balance_loss",
           "positions_blocked", "positions_ref", "route_ref",
           "route_tokens_bwd_ref", "route_tokens_full_bwd_ref",
           "route_tokens_ref", "softmax_rows"]

NEG_INF = -1e30
_LANES = 32


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of float32 (t, E), each row's sum taken
    in the router kernel's order."""
    t, e = x.shape
    ex = torch.exp(x - x.amax(dim=-1, keepdim=True))
    n = -(-e // _LANES)
    lanes = torch.zeros(t, n * _LANES, dtype=x.dtype, device=x.device)
    lanes[:, :e] = ex
    lanes = lanes.view(t, n, _LANES)
    s = lanes[:, 0]
    for i in range(1, n):                      # each lane's own experts
        s = s + lanes[:, i]
    o = _LANES // 2
    while o:                                   # the xor butterfly
        s = s[:, :o] + s[:, o:2 * o]
        o //= 2
    return ex / s


def route_ref(logits, *, top_k: int, renormalize: bool = True):
    """logits: (t, E) float32 or bfloat16 -> (gates (t, k) in logits'
    type, idx (t, k) int32, probs (t, E) float32, aux {"mean_prob",
    "frac_tokens"} (E,) float32)."""
    t, e = logits.shape
    probs = softmax_rows(logits.float())
    work = probs.clone()
    gs, ids = [], []
    gsum = torch.zeros(t, dtype=torch.float32, device=logits.device)
    for _ in range(top_k):
        a = work.argmax(dim=-1, keepdim=True)     # first index of the max
        g = work.gather(1, a)
        work = work.scatter(1, a, NEG_INF)     # out of place: autograd
                                               # saved the old work
        gs.append(g)
        ids.append(a)
        gsum = gsum + g[:, 0]
    gates = torch.cat(gs, dim=1).to(logits.dtype)
    if renormalize:
        gates = (gates.float() / gsum.clamp_min(1e-20)[:, None]) \
            .to(logits.dtype)
    idx = torch.cat(ids, dim=1)
    sel = torch.zeros(t, e, dtype=torch.float32, device=logits.device)
    sel.scatter_(1, idx, 1.0)
    aux = {"mean_prob": probs.sum(0) / t,
           "frac_tokens": sel.sum(0) / (t * top_k)}
    return gates, idx.to(torch.int32), probs, aux


def load_balance_loss(aux, num_experts: int):
    """Switch-transformer aux loss: E * sum(frac_tokens * mean_prob)."""
    return num_experts * torch.sum(aux["frac_tokens"] * aux["mean_prob"])


def positions_ref(idx, group_size: int, num_experts: int):
    """idx (t, k) expert ids -> (t, k) int32: for choice j of token i,
    the number of earlier (token, choice) pairs of its group (rows
    [G * group_size, (G + 1) * group_size), the last group possibly
    shorter) that chose the same expert -- the reference's
    ``cumsum(sel) - sel`` over the (groups, group * k, E) selection, read
    at the chosen expert."""
    t, k = idx.shape
    n_groups = -(-t // group_size)
    sel = F.one_hot(idx.long(), num_experts).float()              # (t,k,E)
    pad = n_groups * group_size - t
    if pad:             # rows that choose nothing move no earlier position
        sel = F.pad(sel, (0, 0, 0, 0, 0, pad))
    flat = sel.reshape(n_groups, group_size * k, num_experts)
    pos = (flat.cumsum(dim=1) - flat).reshape(n_groups * group_size, k,
                                              num_experts)[:t]
    return (pos * sel[:t]).sum(dim=-1).to(torch.int32)


def positions_blocked(idx, group_size: int, num_experts: int, rows: int):
    """:func:`positions_ref` computed as the fused kernel does, over blocks
    of ``rows`` tokens (a CTA's, at most 32): each block counts, per
    expert, its rows of its last row's group (its "tail"); a row's
    position is the count of the earlier rows of its group in its block,
    plus, when its group began at or before the block's first row, the
    tails of the earlier blocks of that group."""
    t, k = idx.shape
    sel = torch.zeros(t, num_experts, dtype=torch.int64)
    sel.scatter_(1, idx.long().cpu(), 1)
    starts = range(0, t, rows)
    tails = []
    for lo in starts:
        hi = min(t, lo + rows)
        g_last = (hi - 1) // group_size * group_size
        tails.append(sel[max(g_last, lo):hi].sum(0))
    out = torch.empty(t, k, dtype=torch.int32)
    for b, lo in enumerate(starts):
        g_first = lo // group_size * group_size
        before = sum(tails[g_first // rows:b], torch.zeros(num_experts,
                                                          dtype=torch.int64))
        for r in range(lo, min(t, lo + rows)):
            g_r = r // group_size * group_size
            count = sel[max(g_r, lo):r].sum(0)
            if g_r <= lo:
                count = count + before
            out[r] = count[idx[r].long().cpu()].to(torch.int32)
    return out.to(idx.device)


def route_tokens_ref(x, w, *, top_k: int, renormalize: bool = True,
                     group_size: int):
    """x (t, d) float32 or bfloat16, w (d, E) float32 -> (gates (t, k)
    float32, idx (t, k) int32, pos (t, k) int32, aux {"mean_prob",
    "frac_tokens"} (E,) float32): :func:`route_ref` on ``f32(x) @ w``
    and :func:`positions_ref` of its ids."""
    logits = x.float() @ w
    gates, idx, _, aux = route_ref(logits, top_k=top_k,
                                   renormalize=renormalize)
    return gates, idx, positions_ref(idx, group_size, w.shape[1]), aux


def route_tokens_bwd_ref(logits, idx, gates, dgates, dmean, *,
                         renormalize: bool = True):
    """The gradient of the router's logits (t, E), float32, given the
    logits, the chosen ids ``idx`` (t, k), the gates (t, k) the forward
    returned, the gates' cotangent ``dgates`` (t, k) and ``mean_prob``'s
    ``dmean`` (E,). Per row, with p = softmax(l), g_j = p[idx_j] and s =
    sum_j g_j:

        dg_j  = (dG_j - sum_i dG_i gates_i) / s     (renormalised; else dG_j)
        dp[e] = sum_j [idx_j = e] dg_j + dM[e] / T
        dl    = p * (dp - sum_e p_e dp_e)

    T = t counts every row ``mean_prob`` averaged over (a padded group's
    zero rows are rows of the routed tensor). ``frac_tokens`` is a count
    and carries none."""
    lf = logits.float()
    t = lf.shape[0]
    p = softmax_rows(lf)
    ids = idx.long()
    dg = dgates.float()
    if renormalize:
        s = p.gather(1, ids).sum(1, keepdim=True).clamp_min(1e-20)
        dg = (dg - (dg * gates.float()).sum(1, keepdim=True)) / s
    dp = torch.zeros_like(p).scatter_add(1, ids, dg) \
        + dmean.float()[None, :] / t
    return p * (dp - (p * dp).sum(1, keepdim=True))


def route_tokens_full_bwd_ref(x, w, logits, idx, gates, dgates, dmean, *,
                              renormalize: bool = True):
    """The gradient of :func:`route_tokens_ref`'s gates and ``mean_prob``
    in its logits, x and w: (dl (t, E) float32 by
    :func:`route_tokens_bwd_ref`, dx = (dl w^T) in x's type, dw = f32(x)^T
    dl float32), given the forward's float32 ``logits`` (None: f32(x) @ w)
    and the rest as :func:`route_tokens_bwd_ref` takes them."""
    if logits is None:
        logits = x.float() @ w
    dl = route_tokens_bwd_ref(logits, idx, gates, dgates, dmean,
                              renormalize=renormalize)
    return dl, (dl @ w.T).to(x.dtype), x.float().T @ dl


def _bf16_pieces(v, n):
    """float32 v as n bfloat16 pieces, each the rounding to nearest of
    what the earlier ones leave."""
    out, rest = [], v.float()
    for _ in range(n):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out


def full_bwd_pieces(x, w, dl, *, stage: int = 64):
    """(dx float32, before its rounding to x's type; dw float32) of
    bfloat16 x (t, d), float32 w (d, E) and dl (t, E) in the arithmetic of
    ``csrc/moe_router_bwd_hopper.cu``: dl and w each split into three bf16
    pieces (l1 + l2 + l3, w1 + w2 + w3, each rounded to nearest); dx = the
    six products of a term down to 2^-16, l3.w1 + l2.w2 + l1.w3 + l2.w1 +
    l1.w2 + l1.w1 (transposed w), each exact (float64) and summed in
    float32 in that order; dw per stage of ``stage`` token rows x^T.l3 +
    x^T.l2 + x^T.l1 likewise, each stage's sum added to a float32 running
    sum in stage order. (The tensor cores' own sums inside a product, and
    the sum of the token ranges' partials, are not modelled.)"""
    lp = [p.double() for p in _bf16_pieces(dl, 3)]
    wp = [p.double() for p in _bf16_pieces(w, 3)]
    dx = torch.zeros(dl.shape[0], w.shape[0], dtype=torch.float32,
                     device=dl.device)
    for a, b in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        dx = dx + (lp[a] @ wp[b].T).float()
    xd = x.double()
    dw = torch.zeros(w.shape, dtype=torch.float32, device=dl.device)
    for s in range(0, x.shape[0], stage):
        xs = xd[s:s + stage].T
        acc = torch.zeros_like(dw)
        for piece in lp[::-1]:
            acc = acc + (xs @ piece[s:s + stage]).float()
        dw = dw + acc
    return dx, dw

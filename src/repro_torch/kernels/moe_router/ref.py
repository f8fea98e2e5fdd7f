"""Plain PyTorch version of fused MoE routing, the function the Pallas
kernel ``repro/kernels/moe_router/moe_router.py::_router_kernel``
computes and the CUDA kernel beside it (``csrc/moe_router.cu``) computes:

    p      = softmax(f32(logits))                      over experts
    top-k  by k rounds of max / argmax / mask          (ties: lower index)
    gates  = g_j, renormalised by max(sum_j g_j, 1e-20) (in logits' type)
    stats  = per-expert sum of p and count of selections over tokens

``mean_prob = sum(p) / t`` and ``frac_tokens = count / (t * k)``. The
softmax sums each row in the order the kernel's warp does (lane i holds
experts i, i+32, ...; then an xor butterfly over the 32 lanes), so on
the card the two give the same probabilities, bit for bit, and the same
choices. The CPU path runs this version.
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "load_balance_loss", "route_ref", "softmax_rows"]

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
        work.scatter_(1, a, NEG_INF)
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

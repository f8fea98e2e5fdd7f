"""Fine-grained Mixture-of-Experts layer, DeepSeek-MoE / DBRX style (the
port of ``repro/models/moe.py``).

Shared experts (always on) plus routed experts with top-k gating and
capacity-based dispatch, with the reference's GShard semantics: tokens in
groups of ``DEFAULT_GROUP``, capacity ``int(gs * k / E * factor)`` (at
least k) per expert and group, earlier tokens and earlier choices win
capacity (cumsum priority), padded tokens' gates zeroed. Routing goes
through one seam, :func:`route`: on a CUDA tensor the fused ``moe_router``
kernel (``repro_torch.kernels.moe_router.route_tokens``: router product,
top-k, each choice's place in capacity, statistics), on the CPU or with
``mode="torch"`` the reference's own steps (float32 logits,
``route_topk``, the cumsum over the one-hot selection). Dispatch and
combine are one-hot einsums, the expert products batched einsums, as the
reference leaves them to XLA. The router weight is float32 even in a
bfloat16 model, and the router logits are computed in float32. The layer
is differentiable: the routing ops' gates and ``mean_prob`` carry the
gradient into x and the router weight (on the card through the router's
backward kernel, ``moe_router_bwd``); the dispatch, the expert products
and the combine differentiate as torch ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.interface import KernelType, kernel_mode
from repro_torch.kernels.moe_router import positions_ref, route_tokens, \
    route_topk
from repro_torch.models import layers
from repro_torch.obs.spans import current_log, span

__all__ = ["DEFAULT_GROUP", "moe_apply", "moe_init", "route"]

DEFAULT_GROUP = 1024


def moe_init(gen, cfg, dtype=torch.float32, lead=()):
    """router (d, E) float32; experts {"w_gate", "w_up"} (E, d, e_ff),
    {"w_down"} (E, e_ff, d); shared SwiGLU of width e_ff * shared."""
    d = cfg.d_model
    m = cfg.moe
    e_ff = m.expert_d_ff or cfg.d_ff
    lead = tuple(lead)
    n = m.num_experts
    bank = lead + (n,)          # one (d_in, d_out) matrix per expert
    p = {
        "router": layers.dense_init(gen, d, n, torch.float32, lead=lead),
        "experts": {
            "w_gate": layers.dense_init(gen, d, e_ff, dtype, lead=bank),
            "w_up": layers.dense_init(gen, d, e_ff, dtype, lead=bank),
            "w_down": layers.dense_init(gen, e_ff, d, dtype, lead=bank),
        },
    }
    if m.num_shared_experts:
        p["shared"] = layers.swiglu_init(gen, d, e_ff * m.num_shared_experts,
                                         dtype, lead=lead)
    return p


def _capacity(group_size: int, num_experts: int, top_k: int,
              factor: float) -> int:
    cap = int(group_size * top_k / num_experts * factor)
    return max(cap, top_k)


def route(xp, w, *, top_k: int, group_size: int, renormalize: bool = True,
          mode=None):
    """Route the group-padded tokens xp (T, d) with the router weight w
    (d, E): (gates (T, k) float32, idx (T, k) int32, pos (T, k) int32,
    aux), pos each choice's position in its expert's capacity buffer
    within its group of ``group_size`` tokens, before capacity; the gates
    divided by their sum when ``renormalize``, else the top-k softmax
    probabilities as they are. A CUDA tensor (``mode`` None or "cuda")
    takes the fused kernel, which launches or raises; the CPU or
    ``mode="torch"`` runs the reference's steps: float32 logits,
    ``route_topk``, and the cumsum over the one-hot selection
    (``positions_ref``)."""
    if kernel_mode(xp, mode) is KernelType.CUDA:
        return route_tokens(xp, w, top_k=top_k, renormalize=renormalize,
                            group_size=group_size)
    logits = xp.float() @ w                                       # (T, E)
    gates, idx, aux = route_topk(logits, top_k=top_k,
                                 renormalize=renormalize, mode=mode)
    # earlier tokens (and earlier choices) win capacity
    return gates, idx, positions_ref(idx, group_size, w.shape[1]), aux


def moe_apply(params, cfg, x, *, group_size: int = DEFAULT_GROUP,
              mode=None):
    """x: (b, s, d) -> (y (b, s, d), aux_loss scalar float32).

    Tokens over capacity are dropped: their output is the shared experts'
    alone (the residual is added by the caller). ``mode`` picks the
    router's implementation (see :func:`route`); ``cfg.moe.renormalize``
    whether the top-k gates are divided by their sum. Under an active
    span log the layer records ``moe`` over ``route``, ``dispatch`` (the
    one-hot tensors and the gather), ``experts`` (the three batched
    products and SiLU), ``combine`` and ``shared``; ``moe`` carries
    ``pairs`` (the valid tokens' (token, choice) pairs) and ``dropped``
    (those over capacity, a 0-d tensor on x's device, so the log never
    waits for the card: read it after the window)."""
    with span("moe") as sp:
        return _moe(params, cfg, x, group_size, mode, sp)


def _moe(params, cfg, x, group_size, mode, sp):
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gs = min(group_size, t)
    n_groups = -(-t // gs)
    pad = n_groups * gs - t
    xp = F.pad(xt, (0, 0, 0, pad)) if pad else xt

    with span("route"):
        gates, idx, pos, aux = route(xp, params["router"], top_k=m.top_k,
                                     group_size=gs,
                                     renormalize=m.renormalize, mode=mode)
    e, k = m.num_experts, m.top_k
    cap = _capacity(gs, e, k, m.capacity_factor)
    with span("dispatch"):
        if pad:
            valid = torch.arange(n_groups * gs, device=x.device) < t
            gates = torch.where(valid[:, None], gates, 0.0)
        gates_g = gates.reshape(n_groups, gs, k).float()
        idx_g = idx.reshape(n_groups, gs, k).long()
        pos_g = pos.reshape(n_groups, gs, k).long()
        keep = pos_g < cap                    # earlier choices win capacity
        if current_log() is not None:         # the padded rows come last
            sp.set(pairs=t * k, dropped=(~keep).reshape(-1, k)[:t].sum())
        sel = F.one_hot(idx_g, e).float() * keep[..., None]       # (g,s,k,E)
        cap_onehot = F.one_hot(torch.where(keep, pos_g, 0), cap).float()
        dispatch = torch.einsum("gske,gskc->gsec", sel, cap_onehot)
        xg = xp.reshape(n_groups, gs, d)
        expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    with span("experts"):
        ex = params["experts"]
        h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, ex["w_gate"]))
        h = h * torch.einsum("gecd,edf->gecf", expert_in, ex["w_up"])
        expert_out = torch.einsum("gecf,efd->gecd", h, ex["w_down"])
    with span("combine"):
        # each (token, expert) has at most one choice, so folding the gate
        # into sel first is the reference's three-operand einsum exactly
        combine = torch.einsum("gske,gskc->gsec", sel * gates_g[..., None],
                               cap_onehot)
        yt = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), expert_out)
        yt = yt.reshape(n_groups * gs, d)[:t]

    if m.num_shared_experts:
        with span("shared"):
            yt = yt + layers.swiglu_apply(params["shared"], xt)

    aux_loss = m.router_aux_weight * e * torch.sum(
        aux["frac_tokens"] * aux["mean_prob"])
    return yt.reshape(b, s, d), aux_loss

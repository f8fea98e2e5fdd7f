"""PerMFL -- Algorithm 1 of the paper, as a stacked simulator in PyTorch.

State layout ("stacked FL"): the global model x, the team models w
(M, ...) and the device models theta (M, N, ...), each tier kept as one
flat buffer whose last axis holds every parameter leaf
(``repro_torch.flat``): x (S,), w (M, S), theta (M, N, S) for a padded
row of S >= P values. Device steps run over all M*N devices at once;
team aggregation is a (masked) mean over N, global aggregation a
(masked) mean over M.

One call = one global round t:

    w_i^{t,0} = x^t
    repeat K:  theta^{k,0} = w^k;  L prox-SGD device steps (eq. 4, the
               prox_update kernel: one launch per step for all devices);
               team update (eq. 9)
    x^{t+1} = (1 - beta*gamma) x^t + beta*gamma * mean_i w_i^{t,K}  (eq. 13)

With a ``CommConfig`` the device->team and team->server uplinks cross
compressed (``repro_torch.comm``): one compress launch per uplink, with
error feedback or without. The JAX reference's fori_loops become host
loops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.comm import (CommConfig, CommState, compress_flat,
                              compress_flat_ef, init_comm_state,
                              needs_uniforms)
from repro_torch.flat import Layout
from repro_torch.kernels.prox_update import prox_step_

__all__ = ["PerMFLHParams", "PerMFLState", "SWEEPABLE_HPARAMS",
           "device_grads", "eval_stacked", "init_state", "normalize_masks",
           "permfl_round", "tier_norms"]

# the float knobs the paper's Fig 3 / §D.4 grids vary
SWEEPABLE_HPARAMS = ("alpha", "eta", "beta", "lam", "gamma")


@dataclass(frozen=True)
class PerMFLHParams:
    """Algorithm 1 hyperparameters (paper §3 / Theorem 1 notation)."""
    alpha: float = 0.01      # device LR
    eta: float = 0.03        # team LR
    beta: float = 0.6        # server LR
    lam: float = 0.5         # device<->team proximity (lambda)
    gamma: float = 1.5       # team<->global proximity (gamma)
    k_team: int = 10         # K: team iterations per global round
    l_local: int = 20        # L: device iterations per team iteration
    momentum: float = 0.0    # optional heavy-ball on the device step
    weight_decay: float = 0.0


@dataclass
class PerMFLState:
    """x (S,): global model; w (M, S): team models; theta (M, N, S):
    device models -- flat tier buffers laid out by ``layout``;
    round: rounds done so far; comm: the error-feedback state when the
    uplinks are compressed, else None."""
    x: torch.Tensor
    w: torch.Tensor
    theta: torch.Tensor
    round: int
    layout: Layout
    comm: Optional[CommState] = None

    def params(self, tier: str) -> dict:
        """Tier ``"x"``, ``"w"`` or ``"theta"`` as a parameter tree (views
        with leading (), (M,) or (M, N) axes)."""
        return self.layout.unflatten(getattr(self, tier))


def init_state(params, m_teams: int, n_devices: int,
               comm: Optional[CommConfig] = None) -> PerMFLState:
    """All tiers initialized from one (unstacked) model, on the device
    its leaves are on (Algorithm 1, init); zero residuals and a seeded
    generator when ``comm`` is given."""
    layout = Layout.of(params)
    x = layout.flatten(params)
    cs = None if comm is None else init_comm_state(params, m_teams,
                                                   n_devices, comm)
    return PerMFLState(
        x=x, w=x.expand(m_teams, -1).clone(),
        theta=x.expand(m_teams, n_devices, -1).clone(), round=0,
        layout=layout, comm=cs)


def _keep_where(mask, new, old):
    """Participation gate: ``new`` where the leading-axes mask is set,
    else ``old``."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m > 0, new, old)


def _masked_mean(x, mask, axis, fallback=None):
    """Mean over ``axis`` weighted by ``mask``; where the mask is all zero
    along the axis, ``fallback`` (or the zero-weight mean, 0) instead."""
    denom = mask.sum(dim=axis)
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    num = (x * m).sum(dim=axis)
    d = denom.reshape(denom.shape + (1,) * (num.dim() - denom.dim()))
    mean = num / d.clamp_min(1.0)
    if fallback is not None:
        mean = torch.where(d > 0, mean, fallback)
    return mean


def normalize_masks(team_mask, device_mask, m_teams: int, n_devices: int,
                    device=None):
    """None -> all-ones participation; masks become (M,) / (M, N) float32
    tensors on ``device``."""
    def as_mask(mask, shape):
        if mask is None:
            return torch.ones(shape, dtype=torch.float32, device=device)
        return torch.as_tensor(mask, dtype=torch.float32, device=device)
    return (as_mask(team_mask, (m_teams,)),
            as_mask(device_mask, (m_teams, n_devices)))


def device_grads(loss_fn: Callable, layout: Layout, theta: torch.Tensor,
                 batch) -> torch.Tensor:
    """Every device's gradient at once: theta (D, S) flat device models,
    batch leaves (D, ...). One forward of the D models and one backward
    of the SUM of their losses; the result is one (D, S) buffer (zero in
    the padding)."""
    t = theta.detach().requires_grad_(True)
    loss = loss_fn(layout.unflatten(t), batch).sum()
    (g,) = torch.autograd.grad(loss, t)
    return g


def _uplink_uniforms(comm: CommConfig, uniforms, gen, t: int, k: int,
                     b: int, layout: Layout, dev):
    """The uniforms of uplink ``k`` of round ``t`` (k < K: a LAN uplink,
    k == K: the WAN uplink) as a (b, S) buffer whose first P columns are
    the values, or None when the compressor uses none: from the injected
    source, else drawn from ``gen``. Rows of S columns keep every row
    start 16-byte aligned for the kernels."""
    if not needs_uniforms(comm):
        return None
    if uniforms is None:
        return torch.rand((b, layout.stride), generator=gen, device=dev)
    u = torch.as_tensor(uniforms(t, k, b), dtype=torch.float32)
    if tuple(u.shape) != (b, layout.size):
        raise ValueError(f"uniforms({t}, {k}, {b}) gave {tuple(u.shape)}, "
                         f"expected {(b, layout.size)}")
    buf = torch.zeros((b, layout.stride), dtype=torch.float32, device=dev)
    buf[:, :layout.size] = u
    return buf


def permfl_round(state: PerMFLState, data, hp: PerMFLHParams,
                 loss_fn: Callable, *, m_teams: int, n_devices: int,
                 team_mask=None, device_mask=None,
                 comm: Optional[CommConfig] = None, uniforms=None,
                 mode=None):
    """One global round.

    data: dict of tensors with leading (M, N, ...) -- each device's
        (full) batch, on the state's device; loss_fn(params, batch) ->
        (D,) per-device losses for parameter leaves (D, ...).
    team_mask: (M,) in {0,1}; device_mask: (M, N). None = full
        participation (the paper's default mode 1).
    comm: optional CommConfig: the device->team theta deltas (each team
        iteration) and the team->server w deltas (once per round) cross
        compressed, with the per-sender residuals in ``state.comm``
        (build the state with ``init_state(..., comm=cfg)``). With error
        feedback each sender ships C(delta + ef) and keeps the new
        residual; without, it ships C(delta + ef) with ``ef`` left as it
        was (zero from ``init_state``), as the reference does.
    uniforms: optional ``uniforms(t, k, b) -> (b, P)`` source of the
        rand-k / int8 uniforms of uplink k of round t (k < K: the LAN
        uplink of team iteration k, M*N senders; k == K: the WAN uplink,
        M senders), leaves back to back in row order. None draws them
        from the state's generator; the parity tests hand the port the
        reference's streams this way.
    mode: kernel mode of the device step and the compress ops (None: by
        device; "torch": the plain versions, for comparisons on the card).
    Returns the new state; ``state`` is left as it was.
    """
    if comm is not None:
        if state.comm is None:
            raise ValueError("comm config given but state carries no "
                             "CommState; build the state with "
                             "init_state(..., comm=cfg)")
    m, n = m_teams, n_devices
    dev = state.x.device
    team_mask, device_mask = normalize_masks(team_mask, device_mask, m, n,
                                             dev)
    layout = state.layout
    x = state.x
    stride = x.shape[-1]
    batch = {k: v.reshape((m * n,) + tuple(v.shape[2:]))
             for k, v in data.items()}
    c = 1.0 - hp.eta * hp.lam - hp.eta * hp.gamma
    if comm is not None:
        # devices of masked-out teams may run locally but never transmit:
        # their residuals must not record undelivered messages
        ef_gate = device_mask * team_mask[:, None]
        ef_dev = state.comm.ef_dev
        gen = state.comm.generator_copy()

    # w_i^{t,0} = x^t
    w = x.expand(m, stride).clone()
    theta = state.theta
    for k in range(hp.k_team):
        # re-init theta from w (LAN downlink); momentum restarts at zero
        theta = w[:, None].expand(m, n, stride).clone()
        flat = theta.view(m * n, stride)
        mom = (torch.zeros_like(flat, dtype=torch.float32)
               if hp.momentum > 0.0 else None)
        for _ in range(hp.l_local):
            g = device_grads(loss_fn, layout, flat, batch)
            prox_step_(layout.columns(flat), layout.columns(g),
                       layout.columns(w),
                       None if mom is None else layout.columns(mom),
                       alpha=hp.alpha, lam=hp.lam, momentum=hp.momentum,
                       weight_decay=hp.weight_decay, mode=mode)
        if comm is None:
            theta_up = theta
        else:
            # LAN uplink: each device ships C(theta - w + ef); the team
            # adds the decompressed delta to the anchor w it holds
            anchor = w[:, None].expand(m, n, stride)
            u = _uplink_uniforms(comm, uniforms, gen, state.round, k,
                                 m * n, layout, dev)
            if comm.error_feedback:
                chat, ef_new = compress_flat_ef(
                    comm, layout, (theta - anchor).view(m * n, stride),
                    ef_dev.reshape(m * n, stride), u, mode=mode)
                ef_dev = _keep_where(ef_gate, ef_new.view(m, n, stride),
                                     ef_dev)
            else:
                chat = compress_flat(
                    comm, layout, (theta - anchor + ef_dev).view(m * n,
                                                                 stride),
                    u, mode=mode)
            theta_up = anchor + chat.view(m, n, stride)
        # team update (eq. 9)
        theta_bar = _masked_mean(theta_up, device_mask, axis=1, fallback=w)
        w = c * w + hp.eta * hp.gamma * x[None] + hp.lam * hp.eta * theta_bar

    # eq. 13 (global) -- non-participating teams keep w out of the average
    # and do not move (their w snaps back to x next round anyway)
    w_eff = _keep_where(team_mask, w, state.w)
    if comm is None:
        w_bar = _masked_mean(w_eff, team_mask, axis=0, fallback=x)
        comm_state = state.comm
    else:
        # WAN uplink: each team ships C(w - x + ef); the server adds the
        # decompressed delta to the x it holds. Masked-out teams need no
        # substitute value: the masked mean zeroes their contribution.
        u = _uplink_uniforms(comm, uniforms, gen, state.round, hp.k_team, m,
                             layout, dev)
        ef_team = state.comm.ef_team
        if comm.error_feedback:
            chat, ef_new = compress_flat_ef(comm, layout, w - x[None],
                                            ef_team, u, mode=mode)
            ef_team = _keep_where(team_mask, ef_new, ef_team)
        else:
            chat = compress_flat(comm, layout, w - x[None] + ef_team, u,
                                 mode=mode)
        w_bar = _masked_mean(x[None] + chat, team_mask, axis=0, fallback=x)
        comm_state = CommState(ef_dev=ef_dev, ef_team=ef_team, gen=gen)
    x_new = (1.0 - hp.beta * hp.gamma) * x + hp.beta * hp.gamma * w_bar
    # devices that did not participate keep their previous theta
    th_eff = _keep_where(device_mask, theta, state.theta)
    return PerMFLState(x=x_new, w=w_eff, theta=th_eff,
                       round=state.round + 1, layout=layout, comm=comm_state)


# ---------------------------------------------------------------------------
# Evaluation helpers
# ---------------------------------------------------------------------------

def tier_norms(state: PerMFLState):
    """``(pers_gap (M, N), tier_drift (M,))``: the personalization gaps
    ``||theta_ij - w_i||`` and the team-vs-server drifts ``||w_i - x||``
    the paper's rates are stated in."""
    gap = (state.theta - state.w[:, None]).norm(dim=-1)
    drift = (state.w - state.x[None]).norm(dim=-1)
    return gap, drift


@torch.no_grad()
def eval_stacked(state: PerMFLState, data, metric_fn, *, which: str = "pm"):
    """metric_fn(params, batch) -> (D,) for leaves (D, ...); data leading
    (M, N, ...).

    which: 'pm' -- per-device personalized models theta_ij on their data
           'tm' -- team models w_i on each device's data
           'gm' -- global model x on each device's data
    Returns the (M, N) matrix of metric values.
    """
    m, n, stride = state.theta.shape
    if which == "pm":
        models = state.theta
    elif which == "tm":
        models = state.w[:, None].expand(m, n, stride)
    elif which == "gm":
        models = state.x.expand(m, n, stride)
    else:
        raise ValueError(which)
    batch = {k: v.reshape((m * n,) + tuple(v.shape[2:]))
             for k, v in data.items()}
    params = state.layout.unflatten(models.reshape(m * n, stride))
    return metric_fn(params, batch).reshape(m, n)

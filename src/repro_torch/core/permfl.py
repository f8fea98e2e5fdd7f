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

A sweep (``repro_torch.train.sweep``) runs C configurations through this
same round at once: every tier gains a leading config axis -- x (C, S),
w (C, M, S), theta (C, M, N, S), the masks (C, M) / (C, M, N), the data
(C, M, N, ...) -- and each float hyperparameter holds C values, float64,
one per config. A coefficient is formed on the host by the expression a
single run evaluates, in float64, and cast to float32 once
(:func:`coef`), as PyTorch casts a Python float; so each config's
arithmetic is its own single run's, and a device step stays one forward,
one backward and one prox_update launch for all C*M*N devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.comm import (CommConfig, CommState, compress_flat,
                              compress_flat_ef, init_comm_state,
                              needs_uniforms)
from repro_torch.flat import Layout
from repro_torch.kernels.prox_update import prox_step_

__all__ = ["PerMFLHParams", "PerMFLState", "SWEEPABLE_HPARAMS", "coef",
           "device_grads", "eval_stacked", "init_state", "normalize_masks",
           "per_config", "permfl_round", "tier_norms"]

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
    device models -- flat tier buffers laid out by ``layout``, each with a
    leading config axis (C,) in a sweep's stacked state;
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


def per_config(v, device: torch.device):
    """A hyperparameter value as the tier ops and kernels take it: a
    Python float as it is; a sweep's per-config values (float64, one per
    config) as one float32 tensor (C,) on ``device``, each value cast
    once, as PyTorch casts a Python float. The copy to the card is
    asynchronous (from pinned memory)."""
    if isinstance(v, (int, float)):
        return v
    t = torch.from_numpy(np.asarray(v, np.float64).astype(np.float32))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def coef(v, like: torch.Tensor):
    """``v`` (see :func:`per_config`) as a factor of ``like``, a tier with
    the config axis leading: a float as it is, per-config values as
    (C, 1, ..., 1)."""
    t = per_config(v, like.device)
    if isinstance(t, torch.Tensor):
        t = t.reshape(t.shape + (1,) * (like.dim() - 1))
    return t


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
                    device=None, lead=()):
    """None -> all-ones participation; masks become lead + (M,) / lead +
    (M, N) float32 tensors on ``device`` (``lead``: () or a sweep's
    (C,))."""
    def as_mask(mask, shape):
        if mask is None:
            return torch.ones(tuple(lead) + shape, dtype=torch.float32,
                              device=device)
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
    start 16-byte aligned for the kernels. A stacked state's ``gen`` is a
    tuple of C generators (and ``uniforms`` a sequence of C sources): each
    config's b rows come from its own, in the order of its single run,
    and the configs' rows follow each other, (C*b, S) in all."""
    if not needs_uniforms(comm):
        return None
    if uniforms is None:
        if isinstance(gen, torch.Generator):
            return torch.rand((b, layout.stride), generator=gen, device=dev)
        return torch.cat([torch.rand((b, layout.stride), generator=g,
                                     device=dev) for g in gen])
    srcs = uniforms if isinstance(uniforms, (list, tuple)) else (uniforms,)
    buf = torch.zeros((len(srcs) * b, layout.stride), dtype=torch.float32,
                      device=dev)
    for i, src in enumerate(srcs):
        u = torch.as_tensor(src(t, k, b), dtype=torch.float32)
        if tuple(u.shape) != (b, layout.size):
            raise ValueError(f"uniforms({t}, {k}, {b}) gave "
                             f"{tuple(u.shape)}, expected {(b, layout.size)}")
        buf[i * b:(i + 1) * b, :layout.size] = u
    return buf


def permfl_round(state: PerMFLState, data, hp: PerMFLHParams,
                 loss_fn: Callable, *, m_teams: int, n_devices: int,
                 team_mask=None, device_mask=None,
                 comm: Optional[CommConfig] = None, uniforms=None,
                 mode=None):
    """One global round.

    state: a single run's state, or a sweep's stacked one (a leading
        config axis on every tier, ``hp``'s floats holding one value per
        config, the masks and data leading (C,) too: module docstring).
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
        reference's streams this way. A stacked state takes one source
        per config.
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
    x = state.x
    lead = tuple(x.shape[:-1])
    nl = len(lead)
    team_mask, device_mask = normalize_masks(team_mask, device_mask, m, n,
                                             dev, lead)
    layout = state.layout
    stride = x.shape[-1]
    batch = {k: v.flatten(0, nl + 1) for k, v in data.items()}
    if comm is not None:
        # devices of masked-out teams may run locally but never transmit:
        # their residuals must not record undelivered messages
        ef_gate = device_mask * team_mask[..., None]
        ef_dev = state.comm.ef_dev
        gen = state.comm.generator_copy()

    # w_i^{t,0} = x^t
    w = x.unsqueeze(-2).expand(lead + (m, stride)).clone()
    c = coef(1.0 - hp.eta * hp.lam - hp.eta * hp.gamma, w)
    eg = coef(hp.eta * hp.gamma, w)
    le = coef(hp.lam * hp.eta, w)
    alpha, lam = per_config(hp.alpha, dev), per_config(hp.lam, dev)
    theta = state.theta
    for k in range(hp.k_team):
        # re-init theta from w (LAN downlink); momentum restarts at zero
        theta = w.unsqueeze(-2).expand(lead + (m, n, stride)).clone()
        flat = theta.view(-1, stride)
        mom = (torch.zeros_like(flat, dtype=torch.float32)
               if hp.momentum > 0.0 else None)
        for _ in range(hp.l_local):
            g = device_grads(loss_fn, layout, flat, batch)
            prox_step_(layout.columns(flat), layout.columns(g),
                       layout.columns(w.view(-1, stride)),
                       None if mom is None else layout.columns(mom),
                       alpha=alpha, lam=lam, momentum=hp.momentum,
                       weight_decay=hp.weight_decay, mode=mode)
        if comm is None:
            theta_up = theta
        else:
            # LAN uplink: each device ships C(theta - w + ef); the team
            # adds the decompressed delta to the anchor w it holds
            anchor = w.unsqueeze(-2).expand(lead + (m, n, stride))
            u = _uplink_uniforms(comm, uniforms, gen, state.round, k, m * n,
                                 layout, dev)
            if comm.error_feedback:
                chat, ef_new = compress_flat_ef(
                    comm, layout, (theta - anchor).view(-1, stride),
                    ef_dev.reshape(-1, stride), u, mode=mode)
                ef_dev = _keep_where(ef_gate, ef_new.view(theta.shape),
                                     ef_dev)
            else:
                chat = compress_flat(
                    comm, layout, (theta - anchor + ef_dev).view(-1, stride),
                    u, mode=mode)
            theta_up = anchor + chat.view(theta.shape)
        # team update (eq. 9)
        theta_bar = _masked_mean(theta_up, device_mask, axis=nl + 1,
                                 fallback=w)
        w = c * w + eg * x.unsqueeze(-2) + le * theta_bar

    # eq. 13 (global) -- non-participating teams keep w out of the average
    # and do not move (their w snaps back to x next round anyway)
    w_eff = _keep_where(team_mask, w, state.w)
    if comm is None:
        w_bar = _masked_mean(w_eff, team_mask, axis=nl, fallback=x)
        comm_state = state.comm
    else:
        # WAN uplink: each team ships C(w - x + ef); the server adds the
        # decompressed delta to the x it holds. Masked-out teams need no
        # substitute value: the masked mean zeroes their contribution.
        u = _uplink_uniforms(comm, uniforms, gen, state.round, hp.k_team, m,
                             layout, dev)
        ef_team = state.comm.ef_team
        delta = (w - x.unsqueeze(-2)).view(-1, stride)
        if comm.error_feedback:
            chat, ef_new = compress_flat_ef(comm, layout, delta,
                                            ef_team.reshape(-1, stride), u,
                                            mode=mode)
            ef_team = _keep_where(team_mask, ef_new.view(w.shape), ef_team)
        else:
            chat = compress_flat(comm, layout,
                                 delta + ef_team.reshape(-1, stride), u,
                                 mode=mode)
        w_bar = _masked_mean(x.unsqueeze(-2) + chat.view(w.shape), team_mask,
                             axis=nl, fallback=x)
        comm_state = CommState(ef_dev=ef_dev, ef_team=ef_team, gen=gen)
    x_new = coef(1.0 - hp.beta * hp.gamma, x) * x \
        + coef(hp.beta * hp.gamma, x) * w_bar
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
    the paper's rates are stated in (leading (C,) for a stacked state),
    over the layout's columns: the probes of ``repro_torch.obs`` read
    them after every round."""
    cols = state.layout.columns
    gap = cols(state.theta - state.w.unsqueeze(-2)).norm(dim=-1)
    drift = cols(state.w - state.x.unsqueeze(-2)).norm(dim=-1)
    return gap, drift


@torch.no_grad()
def eval_stacked(state: PerMFLState, data, metric_fn, *, which: str = "pm",
                 chunk=None):
    """metric_fn(params, batch) -> (D,) for leaves (D, ...); data leading
    (M, N, ...).

    which: 'pm' -- per-device personalized models theta_ij on their data
           'tm' -- team models w_i on each device's data
           'gm' -- global model x on each device's data
    Returns the (M, N) matrix of metric values; a stacked state (data
    leading (C, M, N, ...)) gives (C, M, N). Devices are evaluated
    ``chunk`` at a time (``core.algorithm.device_rows``), a team or
    global row broadcast to one chunk at a time, never to the whole
    (M, N, S) tier.
    """
    from repro_torch.core.algorithm import broadcast_rows, device_rows

    shape = state.theta.shape
    lead, stride = shape[:-3], shape[-1]
    n = shape[-2]
    if which == "pm":
        flat = state.theta.reshape(-1, stride)
        rows = lambda a, b: flat[a:b]             # noqa: E731
    elif which == "tm":
        rows = broadcast_rows(state.w, n)
    elif which == "gm":
        rows = broadcast_rows(state.x, shape[-3] * n)
    else:
        raise ValueError(which)
    batch = {k: v.flatten(0, len(lead) + 1) for k, v in data.items()}
    d = 1
    for s in shape[:-1]:
        d *= s
    return device_rows(metric_fn, state.layout, rows, batch, d,
                       chunk).reshape(shape[:-1])

"""Baselines from Table 1 / Fig 2, in the same stacked-FL representation.

All operate on data with leading (M, N, ...) so results are directly
comparable to PerMFL on identical partitions. Conventional (single-tier)
methods treat all M*N devices as one flat pool.

  FedAvg      [1]  -- local SGD + global averaging (GM).
  Per-FedAvg  [13] -- MAML-style: the PM is one adaptation step from GM.
  pFedMe      [11] -- Moreau-envelope personalization, single tier.
  Ditto       [10] -- FedAvg GM + per-device PM trained with a prox term
                      toward the GM.
  h-SGD       [5]  -- hierarchical local SGD: device steps, team average
                      every L steps, global average every K*L (GM).
  L2GD        [18] -- global/cluster/personal mixture, the synchronous
                      variant of the loopless method.

Models are flat rows laid out by a :class:`repro_torch.flat.Layout`, as in
``repro_torch.core.permfl``: the global model x (S,), the device tier
(M*N, S) while a round runs, the personal tier (M, N, S) in the state.
Device gradients are one forward and one backward of the sum of every
device's loss (``permfl.device_grads``). A step that is eq. 4's update
with momentum 0 and weight decay 0, ``t - lr * (g + lam * (t - a))``, is
the ``prox_update`` kernel, one launch per step for all M*N devices:
pFedMe's inner prox steps (anchor: each device's own local copy, M*N
anchor rows), Ditto's personal steps (the global model, one row) and
L2GD's local steps (the team means, M rows). Plain SGD steps are one
torch op. Every round function takes ``mode``: None runs the kernel on
CUDA tensors, ``"torch"`` its plain version (for comparisons on the card).
The reference's ``fori_loop``s become host loops.

A sweep's stacked state (``repro_torch.train.sweep``) runs through the
same functions: x (C, S), the personal tier (C, M, N, S), the data
(C, M, N, ...), each float hyperparameter C float64 values; coefficients
are formed as in ``core.permfl`` (:func:`~repro_torch.core.permfl.coef`).
An SGD step is ``theta - lr * g``, a multiply and a subtract, in one form
for a float and a per-config ``lr`` (``add_(g, alpha=-lr)`` may fuse the
two into one rounding on some devices, which a per-config tensor
cannot).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.algorithm import (FLAlgorithmBase, _stacked,
                                        eval_global, eval_personal,
                                        metric_values)
from repro_torch.core.permfl import coef, device_grads, per_config
from repro_torch.flat import Layout
from repro_torch.kernels.prox_update import prox_step_

__all__ = ["BaselineState", "Ditto", "FedAvg", "HSGD", "L2GD", "PFedMe",
           "PerFedAvg", "ditto_round", "fedavg_round", "hsgd_round",
           "init_baseline_state", "l2gd_round", "meta_grads",
           "perfedavg_personalize", "perfedavg_round", "pfedme_round"]


@dataclass
class BaselineState:
    """x (S,): the global model; personal (M, N, S): the per-device models
    of pFedMe, Ditto and L2GD (None for FedAvg, Per-FedAvg and h-SGD) --
    flat rows laid out by ``layout``, with a leading config axis (C,) in
    a sweep's stacked state; round: rounds done so far."""
    x: torch.Tensor
    layout: Layout
    personal: Optional[torch.Tensor] = None
    round: int = 0

    def params(self, tier: str) -> dict:
        """Tier ``"x"`` or ``"personal"`` as a parameter tree (views with
        leading () or (M, N) axes)."""
        return self.layout.unflatten(getattr(self, tier))


def init_baseline_state(params, m: int, n: int,
                        personal: bool) -> BaselineState:
    """The state from one (unstacked) model, on its leaves' device; with
    ``personal`` the per-device tier starts as M*N copies of it."""
    layout = Layout.of(params)
    x = layout.flatten(params)
    return BaselineState(
        x=x, layout=layout,
        personal=x.expand(m, n, -1).clone() if personal else None)


def _bcast(row, d):
    """A new lead + (d, S) buffer of copies of ``row`` (lead + (S,))."""
    return row.unsqueeze(-2).expand(
        tuple(row.shape[:-1]) + (d, row.shape[-1])).clone()


def _grads(loss_fn, layout, theta, batch):
    """``device_grads`` of every row of ``theta`` (lead + (D, S)), shaped
    as ``theta``."""
    return device_grads(loss_fn, layout, theta.view(-1, theta.shape[-1]),
                        batch).view(theta.shape)


def _sgd_steps_(theta, batch, layout, loss_fn, lr, steps):
    """``steps`` plain SGD steps of every device row of ``theta``
    (lead + (D, S)), in place."""
    lr = coef(lr, theta)
    for _ in range(steps):
        theta.sub_(lr * _grads(loss_fn, layout, theta, batch))
    return theta


def _prox_steps_(theta, anchor, batch, layout, loss_fn, lr, lam, steps,
                 mode):
    """``steps`` prox steps ``t - lr * (g + lam * (t - a))`` of ``theta``
    (lead + (D, S)) in place, device row r anchored to ``anchor`` (lead +
    (A, S)) row r // (D / A): one ``prox_update`` launch per step."""
    cols = layout.columns
    stride = theta.shape[-1]
    rows, anchors = theta.view(-1, stride), anchor.reshape(-1, stride)
    lr, lam = per_config(lr, theta.device), per_config(lam, theta.device)
    for _ in range(steps):
        g = device_grads(loss_fn, layout, rows, batch)
        prox_step_(cols(rows), cols(g), cols(anchors), alpha=lr, lam=lam,
                   mode=mode)
    return theta


def _lead(x):
    """The config axes of a global-model row: () or a sweep's (C,)."""
    return tuple(x.shape[:-1])


# ---------------------------------------------------------------------------
# FedAvg
# ---------------------------------------------------------------------------

def fedavg_round(x, data, layout: Layout, *, loss_fn: Callable, lr: float,
                 local_steps: int, m: int, n: int, mode=None):
    """Every device starts from x (S,), takes ``local_steps`` SGD steps on
    its own batch; the new x is their mean. ``mode`` is accepted for a
    uniform signature (no kernel runs)."""
    theta = _sgd_steps_(_bcast(x, m * n), _stacked(data, _lead(x)), layout,
                        loss_fn, lr, local_steps)
    return theta.mean(dim=-2)


# ---------------------------------------------------------------------------
# Per-FedAvg
# ---------------------------------------------------------------------------

def meta_grads(loss_fn: Callable, layout: Layout, theta: torch.Tensor,
               batch, inner_lr: float) -> torch.Tensor:
    """Every device's MAML meta-gradient at once: the gradient of
    ``loss(t - inner_lr * grad loss(t))`` at each row of ``theta`` (D, S),
    second order (through the inner gradient), as the reference's
    ``jax.grad(meta_loss)`` is. Devices do not interact, so the gradient
    of the SUM of the D meta-losses gives each row its own. A stacked
    ``theta`` (C, D, S) takes C values of ``inner_lr``."""
    stride = theta.shape[-1]
    with torch.enable_grad():
        t = theta.detach().requires_grad_(True)
        loss = loss_fn(layout.unflatten(t.view(-1, stride)), batch).sum()
        (g,) = torch.autograd.grad(loss, t, create_graph=True)
        inner = t - coef(inner_lr, t) * g
        meta = loss_fn(layout.unflatten(inner.view(-1, stride)), batch).sum()
        (mg,) = torch.autograd.grad(meta, t)
    return mg


def perfedavg_round(x, data, layout: Layout, *, loss_fn: Callable,
                    lr: float, inner_lr: float, local_steps: int, m: int,
                    n: int, mode=None):
    """``local_steps`` meta-gradient steps per device from x; the new x is
    their mean. ``mode`` is accepted for a uniform signature."""
    batch = _stacked(data, _lead(x))
    theta = _bcast(x, m * n)
    lr_t = coef(lr, theta)
    for _ in range(local_steps):
        theta.sub_(lr_t * meta_grads(loss_fn, layout, theta, batch,
                                     inner_lr))
    return theta.mean(dim=-2)


def perfedavg_personalize(x, data, layout: Layout, *, loss_fn, inner_lr,
                          m: int, n: int):
    """PM = one adaptation step of the global model on each device's
    data: (M, N, S)."""
    theta = _bcast(x, m * n)
    g = _grads(loss_fn, layout, theta, _stacked(data, _lead(x)))
    theta.sub_(coef(inner_lr, theta) * g)
    return theta.view(_lead(x) + (m, n, -1))


# ---------------------------------------------------------------------------
# pFedMe
# ---------------------------------------------------------------------------

def pfedme_round(x, data, layout: Layout, *, loss_fn: Callable, lr: float,
                 inner_lr: float, lam: float, inner_steps: int,
                 local_rounds: int, m: int, n: int, mode=None):
    """Returns (new x (S,), theta (M, N, S)): theta are the personalized
    models. Local copies w restart from x; each local round solves the
    Moreau subproblem from w by ``inner_steps`` prox steps (anchor: each
    device's own w), then moves w toward them; the personal models are
    ``inner_steps`` prox steps anchored on the final w."""
    batch = _stacked(data, _lead(x))
    w = _bcast(x, m * n)
    step = coef(lr * lam, w)
    for _ in range(local_rounds):
        theta = _prox_steps_(w.clone(), w, batch, layout, loss_fn, inner_lr,
                             lam, inner_steps, mode)
        w = w - step * (w - theta)
    new_x = w.mean(dim=-2)
    theta = _prox_steps_(w.clone(), w, batch, layout, loss_fn, inner_lr,
                         lam, inner_steps, mode)
    return new_x, theta.view(_lead(x) + (m, n, -1))


# ---------------------------------------------------------------------------
# Ditto
# ---------------------------------------------------------------------------

def ditto_round(x, v, data, layout: Layout, *, loss_fn: Callable,
                lr: float, lam: float, local_steps: int, m: int, n: int,
                mode=None):
    """Returns (new x (S,), new v (M, N, S)). x: FedAvg's SGD steps from
    x, then the mean; v: the personal models, ``local_steps`` prox steps
    anchored on the round's incoming x (one anchor row a config)."""
    lead = _lead(x)
    batch = _stacked(data, lead)
    theta = _sgd_steps_(_bcast(x, m * n), batch, layout, loss_fn, lr,
                        local_steps)
    new_v = _prox_steps_(v.reshape(lead + (m * n, -1)).clone(),
                         x.unsqueeze(-2), batch, layout, loss_fn, lr, lam,
                         local_steps, mode)
    return theta.mean(dim=-2), new_v.view(lead + (m, n, -1))


# ---------------------------------------------------------------------------
# h-SGD (hierarchical FedAvg)
# ---------------------------------------------------------------------------

def hsgd_round(x, data, layout: Layout, *, loss_fn: Callable, lr: float,
               k_team: int, l_local: int, m: int, n: int, mode=None):
    """K team iterations: the team rows (M, S) go to their devices, each
    takes ``l_local`` SGD steps, each team averages its devices; the new x
    is the mean over teams. ``mode`` is accepted for a uniform
    signature."""
    lead = _lead(x)
    batch = _stacked(data, lead)
    w = _bcast(x, m)
    for _ in range(k_team):
        theta = _sgd_steps_(w.repeat_interleave(n, dim=-2), batch, layout,
                            loss_fn, lr, l_local)
        w = theta.view(lead + (m, n, -1)).mean(dim=-2)
    return w.mean(dim=-2)


# ---------------------------------------------------------------------------
# L2GD (synchronous variant of the cluster/loopless method)
# ---------------------------------------------------------------------------

def l2gd_round(x, theta, data, layout: Layout, *, loss_fn: Callable,
               lr: float, lam_c: float, lam_g: float, k_team: int,
               l_local: int, m: int, n: int, mode=None):
    """Three models: global x (S,), cluster c_i = the team mean of theta,
    personal theta (M, N, S). Each team iteration holds the cluster mean
    of its start fixed through ``l_local`` prox steps toward it (M anchor
    rows), then pulls every device by ``lr * lam_g`` times its team mean
    (recomputed) minus x, which stays fixed for the round.
    Returns (new x (S,), new theta (M, N, S))."""
    lead = _lead(x)
    batch = _stacked(data, lead)
    th = theta.reshape(lead + (m * n, -1)).clone()
    teams = lead + (m, n, -1)
    pull = coef(lr * lam_g, th.view(teams))
    x_rows = x[..., None, None, :]
    for _ in range(k_team):
        cluster = th.view(teams).mean(dim=-2)
        th = _prox_steps_(th, cluster, batch, layout, loss_fn, lr, lam_c,
                          l_local, mode)
        cl = th.view(teams).mean(dim=-2, keepdim=True)
        th = (th.view(teams) - pull * (cl - x_rows)).reshape(
            lead + (m * n, -1))
    return th.mean(dim=-2), th.view(teams)


# ---------------------------------------------------------------------------
# FLAlgorithm adapters -- the round functions above behind the unified API
# (core.algorithm). Single-tier methods ignore the participation masks
# (the paper ablates participation for PerMFL only).
# ---------------------------------------------------------------------------

class _Global(FLAlgorithmBase):
    """The state, GM eval and serving of the baselines whose state is the
    global model alone."""

    def init_state(self, params, m, n) -> BaselineState:
        """The global model only."""
        return init_baseline_state(params, m, n, personal=False)

    @torch.no_grad()
    def eval(self, state, train_data, val_data, metric_fn):
        """{"gm": mean accuracy of x over all devices}."""
        return {"gm": metric_values(eval_global(state.x, state.layout,
                                                val_data, metric_fn))}

    def serving_params(self, state, team=None, device=None):
        """x to every principal."""
        return super().serving_params(state.x, team, device)

    def device_axes(self, state, m, n):
        """The global model alone: nothing rides the cohort gather."""
        return ()


class _Personal(FLAlgorithmBase):
    """The state, PM/GM eval and serving of the baselines with a personal
    tier."""

    def init_state(self, params, m, n) -> BaselineState:
        """x and the personal tier, both from ``params``."""
        return init_baseline_state(params, m, n, personal=True)

    @torch.no_grad()
    def eval(self, state, train_data, val_data, metric_fn):
        """PM (the personal tier) and GM (x) mean accuracy."""
        return {"pm": metric_values(eval_personal(
                    state.personal, state.layout, val_data, metric_fn)),
                "gm": metric_values(eval_global(
                    state.x, state.layout, val_data, metric_fn))}

    def serving_params(self, state, team=None, device=None):
        """Device (t, d) gets its personal row; team and global requests
        both get x (a single-tier method has no team tier to fall back
        through). Integer tensors index whole tiers."""
        if team is None or device is None:
            return super().serving_params(state.x, team, device)
        return state.personal[team, device]

    def device_axes(self, state, m, n):
        """The personal tier (pFedMe's and L2GD's theta, Ditto's v) is
        device-tier; x stays resident."""
        return ("personal",)


@dataclass(frozen=True)
class FedAvg(_Global):
    """FedAvg behind the FLAlgorithm API; reports GM."""
    loss_fn: Callable
    lr: float
    local_steps: int

    name = "fedavg"

    def round(self, state, data, *, team_mask, device_mask, mode=None):
        """One round; the masks are ignored."""
        m, n = device_mask.shape[-2:]
        x = fedavg_round(state.x, data, state.layout, loss_fn=self.loss_fn,
                         lr=self.lr, local_steps=self.local_steps, m=m, n=n)
        return BaselineState(x, state.layout, None, state.round + 1)


@dataclass(frozen=True)
class PerFedAvg(_Global):
    """Per-FedAvg behind the FLAlgorithm API; reports PM (one adaptation
    step from x on each device's train data) and GM; serves x (the PM
    needs data a parameter store cannot hold)."""
    loss_fn: Callable
    lr: float
    inner_lr: float
    local_steps: int

    name = "perfedavg"

    def round(self, state, data, *, team_mask, device_mask, mode=None):
        """One round of meta-gradient steps; the masks are ignored."""
        m, n = device_mask.shape[-2:]
        x = perfedavg_round(state.x, data, state.layout,
                            loss_fn=self.loss_fn, lr=self.lr,
                            inner_lr=self.inner_lr,
                            local_steps=self.local_steps, m=m, n=n)
        return BaselineState(x, state.layout, None, state.round + 1)

    def eval(self, state, train_data, val_data, metric_fn):
        """PM and GM mean accuracy. Not under ``torch.no_grad``: the PM is
        a gradient step on the train data."""
        nl = state.x.dim() - 1
        m, n = next(iter(train_data.values())).shape[nl:nl + 2]
        theta = perfedavg_personalize(state.x, train_data, state.layout,
                                      loss_fn=self.loss_fn,
                                      inner_lr=self.inner_lr, m=m, n=n)
        with torch.no_grad():
            return {"pm": metric_values(eval_personal(
                        theta, state.layout, val_data, metric_fn)),
                    "gm": metric_values(eval_global(
                        state.x, state.layout, val_data, metric_fn))}


@dataclass(frozen=True)
class PFedMe(_Personal):
    """pFedMe behind the FLAlgorithm API; the round ignores the incoming
    personal tier and returns a new one."""
    loss_fn: Callable
    lr: float
    inner_lr: float
    lam: float
    inner_steps: int
    local_rounds: int

    name = "pfedme"

    def round(self, state, data, *, team_mask, device_mask, mode=None):
        """One round: ``local_rounds * inner_steps + inner_steps`` prox
        kernel launches; the masks are ignored."""
        m, n = device_mask.shape[-2:]
        x, theta = pfedme_round(
            state.x, data, state.layout, loss_fn=self.loss_fn, lr=self.lr,
            inner_lr=self.inner_lr, lam=self.lam,
            inner_steps=self.inner_steps, local_rounds=self.local_rounds,
            m=m, n=n, mode=mode)
        return BaselineState(x, state.layout, theta, state.round + 1)


@dataclass(frozen=True)
class Ditto(_Personal):
    """Ditto behind the FLAlgorithm API: FedAvg's global model and the
    prox-regularized personal models v."""
    loss_fn: Callable
    lr: float
    lam: float
    local_steps: int

    name = "ditto"

    def round(self, state, data, *, team_mask, device_mask, mode=None):
        """One round: ``local_steps`` prox kernel launches (v); the masks
        are ignored."""
        m, n = device_mask.shape[-2:]
        x, v = ditto_round(state.x, state.personal, data, state.layout,
                           loss_fn=self.loss_fn, lr=self.lr, lam=self.lam,
                           local_steps=self.local_steps, m=m, n=n,
                           mode=mode)
        return BaselineState(x, state.layout, v, state.round + 1)


@dataclass(frozen=True)
class HSGD(_Global):
    """h-SGD behind the FLAlgorithm API; reports GM."""
    loss_fn: Callable
    lr: float
    k_team: int
    l_local: int

    name = "hsgd"

    def round(self, state, data, *, team_mask, device_mask, mode=None):
        """One round; the masks are ignored."""
        m, n = device_mask.shape[-2:]
        x = hsgd_round(state.x, data, state.layout, loss_fn=self.loss_fn,
                       lr=self.lr, k_team=self.k_team, l_local=self.l_local,
                       m=m, n=n)
        return BaselineState(x, state.layout, None, state.round + 1)


@dataclass(frozen=True)
class L2GD(_Personal):
    """L2GD (synchronous variant) behind the FLAlgorithm API."""
    loss_fn: Callable
    lr: float
    lam_c: float
    lam_g: float
    k_team: int
    l_local: int

    name = "l2gd"

    def round(self, state, data, *, team_mask, device_mask, mode=None):
        """One round: ``k_team * l_local`` prox kernel launches; the masks
        are ignored."""
        m, n = device_mask.shape[-2:]
        x, theta = l2gd_round(
            state.x, state.personal, data, state.layout,
            loss_fn=self.loss_fn, lr=self.lr, lam_c=self.lam_c,
            lam_g=self.lam_g, k_team=self.k_team, l_local=self.l_local,
            m=m, n=n, mode=mode)
        return BaselineState(x, state.layout, theta, state.round + 1)

"""Central and tiered LM trainers (the port of ``repro/train/trainer.py``).

``make_train_step`` is standard LM training of any dense zoo architecture
-- the paper's implicit baseline (1), plain ERM with a single decision
variable. ``make_permfl_device_step`` and ``make_tier_round`` are PerMFL
at LLM scale, the production "tier mode" (DESIGN.md §2): a device's
prox-SGD steps toward its team model w (eq. 4, ``prox_update``, one
launch per parameter leaf), the team update (eq. 9) and the server update
(eq. 13), both in one pass (``tier_update``, one launch per parameter
leaf).

Parameters are nested dicts of tensors on one device (the card by
default); a batch is ``{"tokens", "targets"}`` (b, s) integer tensors on
that device. Gradients come from ``torch.autograd`` through
``models.model.loss_fn``: on the card through the attention kernels'
backward, on the CPU (or with ``mode="torch"``) through the plain
versions. The returned losses are 0-d tensors on the device, so a step
does not wait for the card. The reference's mesh arguments
(``data_axis``, ``pod_axis``) are accepted and unused: the port trains on
one card, where the team and server updates are local.

Under an active span log (``repro_torch.obs.spans``) the phases record
spans: ``forward`` (with the model's ``embed``, ``blocks`` and ``head``)
and ``backward`` in :func:`value_and_grad`, ``prox_step`` around
``prox_sgd_tree``, and in a tier round ``tier_round`` over
``local_step`` and the ``team_update`` and ``server_update``: both
updates run in ``team_update`` (one ``tier_update`` launch a leaf on the
card), and ``server_update`` holds no device work; readers sum the two.
With no log active they cost one context-variable read each.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.flat import tree_leaves
from repro_torch.kernels.prox_update import prox_sgd_tree
from repro_torch.kernels.tier_update import tier_update_tree
from repro_torch.models import model as model_lib
from repro_torch.obs.spans import span
from repro_torch.train.optim import Optimizer, clip_by_global_norm, tree_map
from repro_torch.train.train_state import TrainState

__all__ = ["make_permfl_device_step", "make_tier_round", "make_train_step",
           "train_loop", "value_and_grad"]


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, in
    ``flat.tree_leaves``' sorted key order) in its places."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def value_and_grad(params, cfg, batch, *, remat=False, mode=None):
    """(loss, grads) of ``model.loss_fn`` at ``params``: the loss a 0-d
    float32 tensor (detached), the gradients a tree of params' structure
    in each leaf's dtype (zeros for a leaf the loss does not read, as
    ``jax.grad`` gives). The params themselves are not marked."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = [p for _, p in tree_leaves(live)]
    with torch.enable_grad():
        with span("forward"):
            loss = model_lib.loss_fn(live, cfg, batch, remat=remat,
                                     mode=mode)
        with span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
    return loss.detach(), _rebuild(params, iter(grads))


def make_train_step(cfg, opt: Optimizer, *, lr: float = 3e-4,
                    grad_clip: float = 1.0, remat: bool = False, mode=None):
    """Returns train_step(state, batch) -> (state, metrics {"loss",
    "grad_norm"})."""

    def train_step(state: TrainState, batch):
        loss_val, grads = value_and_grad(state.params, cfg, batch,
                                         remat=remat, mode=mode)
        if grad_clip:
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        else:
            gnorm = torch.zeros((), device=loss_val.device)
        state = state.apply_gradients(grads, opt, lr)
        return state, {"loss": loss_val, "grad_norm": gnorm}

    return train_step


def make_permfl_device_step(cfg, *, alpha: float, lam: float,
                            remat: bool = False, mode=None):
    """PerMFL device step at LLM scale (tier mode, DESIGN.md §2): one
    prox-SGD step of theta toward the team anchor w (eq. 4).

    step(theta, w, batch) -> (theta', metrics {"loss"}); theta' is a new
    tree, theta and w are left as they are."""

    def device_step(theta, w, batch):
        loss_val, grads = value_and_grad(theta, cfg, batch, remat=remat,
                                         mode=mode)
        with torch.no_grad(), span("prox_step"):
            theta, _ = prox_sgd_tree(theta, grads, w, alpha=alpha, lam=lam,
                                     mode=mode)
        return theta, {"loss": loss_val}

    return device_step


def make_tier_round(cfg, *, alpha: float, lam: float, gamma: float,
                    eta: float, beta: float, l_local: int,
                    data_axis: str = "data", pod_axis: Optional[str] = "pod",
                    remat: bool = False, mode=None):
    """Tiered PerMFL round at LLM scale.

    round_fn(theta, w, x, batch) -> (theta', w', x', metrics {"loss"}):
    ``l_local`` prox steps of theta toward w on ``batch``, then the team
    update (eq. 9, theta-bar = theta: one device's view)

        w' = (1 - eta lam - eta gamma) w + eta gamma x + lam eta theta'

    and the server update (eq. 13)

        x' = (1 - beta gamma) x + beta gamma w'

    both in one pass, leaf by leaf (``tier_update_tree``: one kernel
    launch a leaf on the card, bit-equal to the plain version's eight
    eager ops), inside the ``team_update`` span; the ``server_update``
    span that follows holds no device work. ``loss`` is the mean of the
    local steps' losses. Every output is a new tree: theta, w and x are
    never written, so one x can be handed to every team (the caller
    averages the teams' x' itself, as the reference's example does). The
    mesh arguments are unused (module docstring)."""
    del data_axis, pod_axis

    def round_fn(theta, w, x, batch):
        with span("tier_round"):
            loss_val = None
            for _ in range(l_local):
                with span("local_step"):
                    lv, grads = value_and_grad(theta, cfg, batch,
                                               remat=remat, mode=mode)
                    with torch.no_grad(), span("prox_step"):
                        theta, _ = prox_sgd_tree(theta, grads, w,
                                                 alpha=alpha, lam=lam,
                                                 mode=mode)
                    del grads
                    loss_val = lv if loss_val is None else loss_val + lv
            with torch.no_grad(), span("team_update"):
                w, x = tier_update_tree(w, x, theta, eta=eta, lam=lam,
                                        gamma=gamma, beta=beta, mode=mode)
            # eq. 13 ran in the pass above; the span stays, so that a
            # reader of the two spans keeps its meaning
            with span("server_update"):
                pass
            return theta, w, x, {"loss": loss_val / l_local}

    return round_fn


def train_loop(cfg, batches, *, opt: Optimizer, lr: float = 3e-4,
               steps: int = 100, seed: int = 0, log_every: int = 10,
               param_dtype=torch.float32, callback=None, params=None,
               device=DEFAULT_DEVICE, mode=None):
    """Simple single-device loop used by examples and tests. ``batches``
    yields {"tokens", "targets"} arrays (numpy or tensors); ``params``
    (default ``model.init_params(seed, cfg, param_dtype, device)``) are
    the initial parameters, e.g. a reference tree carried across. Returns
    (state, history [(step, loss), ...])."""
    dev = resolve_device(device)
    if params is None:
        params = model_lib.init_params(seed, cfg, dtype=param_dtype,
                                       device=dev)
    state = TrainState.create(params, opt)
    step_fn = make_train_step(cfg, opt, lr=lr, mode=mode)
    history = []
    for i, batch in zip(range(steps), batches):
        batch = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            history.append((i, loss))
            if callback:
                callback(i, loss)
    return state, history

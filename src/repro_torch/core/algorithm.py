"""Unified FL algorithm API, as the engine (``repro_torch.train.engine``)
drives it:

    init_state(params, m, n)       -> state (stacked tiers)
    round(state, data, team_mask=, device_mask=) -> new state
    eval(state, train_data, val_data, metric_fn) -> {metric: float}

Masks are (M,) / (M, N) float32 tensors; algorithms without a
participation notion ignore them. ``eval`` returns scalar metrics (keys
among "pm" / "tm" / "gm" / "train_loss"). Implementations are frozen
dataclasses: change a hyperparameter by building a new instance.

Only PerMFL is ported so far; the baselines, probes, health detectors,
serving export and byte ledger are later items of ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import permfl as P

__all__ = ["FLAlgorithm", "FLAlgorithmBase", "PerMFL"]


@runtime_checkable
class FLAlgorithm(Protocol):
    """Structural type the engine drives; see module docstring."""
    name: str

    def init_state(self, params, m: int, n: int) -> Any:
        """Initial state from one model for M teams x N devices."""
        ...

    def round(self, state, data, *, team_mask, device_mask) -> Any:
        """One global round: state + (M, N, ...) data + masks -> state."""
        ...

    def eval(self, state, train_data, val_data,
             metric_fn: Callable) -> dict:
        """Metrics: {'pm'|'tm'|'gm'|'train_loss': float}."""
        ...


class FLAlgorithmBase:
    """Defaults: no participation support (the engine then refuses
    team_frac/device_frac < 1)."""

    supports_participation = False


@dataclass(frozen=True)
class PerMFL(FLAlgorithmBase):
    """Algorithm 1 (``core.permfl``) behind the unified API.

    comm: compressed uplinks are not ported yet; anything but None
    raises.
    """
    loss_fn: Callable
    hp: P.PerMFLHParams
    comm: Optional[Any] = None

    name = "permfl"
    supports_participation = True   # paper modes 1-4 (§3.1)

    def __post_init__(self):
        if self.comm is not None:
            raise NotImplementedError(
                "compressed uplinks are not ported yet (ROADMAP.md queue "
                "1, item 6)")

    def init_state(self, params, m: int, n: int) -> P.PerMFLState:
        """All tiers (x / w / theta) broadcast from one model."""
        return P.init_state(params, m, n)

    def round(self, state, data, *, team_mask, device_mask):
        """One Algorithm-1 global round (K team iters x L device steps)."""
        m, n = device_mask.shape
        return P.permfl_round(state, data, self.hp, self.loss_fn,
                              m_teams=m, n_devices=n, team_mask=team_mask,
                              device_mask=device_mask)

    def tree_hparams(self):
        """``(leaves, rebuild)``: the SWEEPABLE_HPARAMS floats of ``hp`` by
        name, and a function returning an equal instance with some of
        them replaced; loop bounds and the momentum / weight-decay
        branches stay fixed."""
        leaves = {k: float(getattr(self.hp, k))
                  for k in P.SWEEPABLE_HPARAMS}

        def rebuild(values):
            return dataclasses.replace(
                self, hp=dataclasses.replace(self.hp, **values))

        return leaves, rebuild

    @torch.no_grad()
    def eval(self, state, train_data, val_data, metric_fn):
        """PM/TM/GM mean accuracy over all devices + mean train loss."""
        m, n, _ = state.theta.shape
        train = {k: v.reshape((m * n,) + tuple(v.shape[2:]))
                 for k, v in train_data.items()}
        out = {w: float(P.eval_stacked(state, val_data, metric_fn,
                                       which=w).mean())
               for w in ("pm", "tm", "gm")}
        theta = state.theta.reshape(m * n, -1)
        out["train_loss"] = float(
            self.loss_fn(state.layout.unflatten(theta), train).mean())
        return out

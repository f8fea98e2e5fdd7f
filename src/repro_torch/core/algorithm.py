"""Unified FL algorithm API, as the engine (``repro_torch.train.engine``)
drives it:

    init_state(params, m, n)       -> state (stacked tiers)
    round(state, data, team_mask=, device_mask=) -> new state
    eval(state, train_data, val_data, metric_fn) -> {metric: float}

Masks are (M,) / (M, N) float32 tensors; algorithms without a
participation notion ignore them. ``eval`` returns scalar metrics (keys
among "pm" / "tm" / "gm" / "train_loss"). Implementations are frozen
dataclasses: change a hyperparameter by building a new instance.
``tree_hparams`` splits one into its sweepable floats and a ``rebuild``;
a sweep (``repro_torch.train.sweep``) rebuilds it with C values per
float (float64 arrays) and drives the same ``round`` / ``eval`` on a
stacked state, whose tiers, masks and data lead with a config axis (C,);
``eval`` then returns a list of C values per metric.
Algorithms that move compressed bytes implement ``make_ledger`` /
``log_comm_round``, and the engine feeds them the realized (team-gated)
participation counts. ``serving_params`` is the export hook of the
personalized serving store (``repro_torch.serve.store``).
``device_axes`` names the state fields that are device-tier, the ones
the cohort engine (``repro_torch.train.store``) keeps resident for the
whole population and gathers to cohort width each round.
``probe_round`` and ``health_round`` are the run telemetry's
(``repro_torch.obs``): scalar diagnostics and health detectors of one
round, read from the states before and after it, never changing them;
``round`` must therefore leave its input state's tensors as they were.

Evaluation runs in chunks of at most ``EVAL_CHUNK`` devices, so that no
model tier is ever copied at population size: each device's arithmetic
is that of one call over all devices, and the mean is taken over the
concatenated per-device values.

PerMFL lives here; the six Table-1 baselines in
``repro_torch.core.baselines``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, runtime_checkable

import torch

from repro_torch.comm import CommConfig, CommLedger
from repro_torch.core import permfl as P
from repro_torch.obs.health import nonfinite_count
from repro_torch.obs.probes import (float_tensors, masked_max, masked_mean,
                                    stacked_sq_norm, tree_diff_norm)

__all__ = ["EVAL_CHUNK", "FLAlgorithm", "FLAlgorithmBase", "PerMFL",
           "broadcast_rows", "device_rows", "eval_global", "eval_personal",
           "metric_values"]

# devices per metric call of an eval: the models of a chunk are at most
# EVAL_CHUNK rows (167 MB of MCLR rows), however large the population
EVAL_CHUNK = 1 << 16


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
    team_frac/device_frac < 1) and no byte ledger."""

    supports_participation = False

    def make_ledger(self, params) -> Optional[CommLedger]:
        """Host-side byte ledger for this algorithm, or None (no comm
        accounting). params: one (unstacked) model giving the leaf
        sizes."""
        return None

    def log_comm_round(self, ledger: CommLedger, *, n_teams: int,
                       n_devices: int) -> None:
        """Account one round's bytes from realized (team-gated)
        participation counts. No-op unless the algorithm moves bytes."""

    @torch.no_grad()
    def probe_round(self, prev_state, state, data, *, team_mask,
                    device_mask, trace):
        """Per-round scalar diagnostics (``repro_torch.obs``): called by
        the engine right after ``round`` when a ``TraceConfig`` is
        active, returning ``{name: float32 tensor}``, each 0-d, or (C,)
        for a sweep's stacked state (one value per config). Pure
        measurement: reads the states, launches none of the port's
        kernels and draws from no generator.

        Default: the whole-state update norm (``trace.grads``) over the
        float fields' ``layout.columns``. Algorithms with tiered state
        override to add drift, residual and loss probes."""
        out = {}
        if trace.grads:
            out["update_norm"] = tree_diff_norm(prev_state, state,
                                                team_mask.dim() - 1)
        return out

    @torch.no_grad()
    def health_round(self, prev_state, state, data, *, team_mask,
                     device_mask, trace):
        """Per-round health detectors (``repro_torch.obs.health``):
        called by the engine when ``trace.health`` is on, returning
        ``{name: float32 tensor}`` values where > 0 means "this round is
        bad". Same purity as ``probe_round``.

        Default: counts of non-finite entries in the post-round state and
        in the round's update (``state - prev_state``): the update catches
        an inf - inf that cancels back to a finite state. Algorithms with
        a cheap loss at hand override to add an explosion flag against
        ``trace.health_loss_max``."""
        lead = team_mask.dim() - 1
        delta = [b - a for a, b in zip(float_tensors(prev_state),
                                       float_tensors(state))]
        return {"nonfinite_params": nonfinite_count(state, lead),
                "nonfinite_update": nonfinite_count(delta, lead)}

    def serving_params(self, state, team=None, device=None):
        """The flat parameter row this algorithm serves to one principal:
        the export hook the serving store builds its tiers from.

        ``serving_params(state)`` is the global model,
        ``serving_params(state, t)`` team t's and
        ``serving_params(state, t, d)`` device (t, d)'s; integer tensors
        for ``team`` / ``device`` give stacked rows, so a whole tier is
        one gather. Default: the state is one global model row, served
        to everybody; personalized algorithms override this."""
        if team is None:
            return state
        shape = torch.as_tensor(team).shape
        if device is not None:
            shape = torch.broadcast_shapes(shape,
                                           torch.as_tensor(device).shape)
        return state.expand(tuple(shape) + tuple(state.shape))

    def device_axes(self, state, m: int, n: int) -> tuple:
        """The dotted paths of the state's device-tier fields, stacked
        (M, N, ...) per (team, device): what the cohort engine keeps in
        its store and gathers to cohort width each round; every other
        field (team and global tiers, counters, generators) stays
        resident at full shape. Default: the reference's shape rule, a
        tensor field whose leading axes are exactly (m, n). Algorithms
        whose tier split that rule could misread (a model dimension equal
        to n) name their fields themselves."""
        from repro_torch.train.store import state_fields

        return tuple(path for path, v in state_fields(state)
                     if isinstance(v, torch.Tensor) and v.dim() >= 2
                     and tuple(v.shape[:2]) == (m, n))

    def tree_hparams(self):
        """``(leaves, rebuild)``: every float-annotated field by name (a
        float field given an int sweeps too), and a function returning an
        equal instance with some of them replaced. Ints (loop bounds) and
        callables stay fixed."""
        leaves = {f.name: float(getattr(self, f.name))
                  for f in dataclasses.fields(self)
                  if f.type in (float, "float")}

        def rebuild(values):
            return dataclasses.replace(self, **values)

        return leaves, rebuild


# ---------------------------------------------------------------------------
# metric helpers shared by the implementations
# ---------------------------------------------------------------------------

def _stacked(data, lead=()):
    """Leaves with leading lead + (M, N, ...) as (prod(lead)*M*N, ...)."""
    return {k: v.flatten(0, len(lead) + 1) for k, v in data.items()}


def metric_values(t: torch.Tensor):
    """A metric as ``eval`` returns it: a float for a 0-d tensor, a list
    of floats (one per config) for a stacked state's (C,)."""
    return float(t) if t.dim() == 0 else t.tolist()


def device_rows(metric_fn, layout, rows, batch, d: int, chunk=None):
    """``metric_fn`` of d devices, ``chunk`` (default ``EVAL_CHUNK``) at a
    time: ``rows(a, b)`` gives the flat models of devices a..b-1 (b - a,
    S), ``batch`` leaves lead with the d devices. Returns the (d,)
    per-device values, each computed as one call over all d would."""
    chunk = EVAL_CHUNK if chunk is None else int(chunk)
    out = [metric_fn(layout.unflatten(rows(a, min(d, a + chunk))),
                     {k: v[a:a + chunk] for k, v in batch.items()})
           for a in range(0, d, chunk)]
    return out[0] if len(out) == 1 else torch.cat(out)


def broadcast_rows(tier: torch.Tensor, per: int):
    """``rows(a, b)`` for :func:`device_rows` where every ``per``
    consecutive devices share one row of ``tier`` (lead + (S,) flattened
    to rows): a new contiguous (b - a, S) buffer, never the whole tier's
    broadcast."""
    flat = tier.reshape(-1, tier.shape[-1])

    def rows(a, b):
        i = torch.arange(a, b, device=flat.device) // per
        return flat[i]

    return rows


def eval_global(x, layout, val_data, metric_fn, chunk=None) -> torch.Tensor:
    """One flat model row ``x`` (S,) evaluated on every device's data
    (leading (M, N, ...)), the mean (a 0-d tensor). A stacked x (C, S)
    with data leading (C, M, N) gives each config's mean, (C,). The row
    is broadcast to a chunk of devices at a time (``device_rows``)."""
    lead = tuple(x.shape[:-1])
    m, n = next(iter(val_data.values())).shape[len(lead):len(lead) + 2]
    d = m * n
    for c in lead:
        d *= c
    vals = device_rows(metric_fn, layout, broadcast_rows(x, m * n),
                       _stacked(val_data, lead), d, chunk)
    return vals.reshape(lead + (m * n,)).mean(-1)


def eval_personal(theta, layout, val_data, metric_fn,
                  chunk=None) -> torch.Tensor:
    """A tier of flat rows ``theta`` (M, N, S), each on its own device's
    data; the mean (a 0-d tensor), or each config's, (C,), for (C, M, N,
    S)."""
    lead, stride = tuple(theta.shape[:-3]), theta.shape[-1]
    flat = theta.reshape(-1, stride)
    vals = device_rows(metric_fn, layout, lambda a, b: flat[a:b],
                       _stacked(val_data, lead), flat.shape[0], chunk)
    return vals.reshape(lead + (-1,)).mean(-1)


@dataclass(frozen=True)
class PerMFL(FLAlgorithmBase):
    """Algorithm 1 (``core.permfl``) behind the unified API.

    comm: optional CommConfig -- uplinks cross compressed, with
    per-sender error feedback or without; the engine accounts bytes via
    make_ledger / log_comm_round from realized (gated) participation
    counts.
    """
    loss_fn: Callable
    hp: P.PerMFLHParams
    comm: Optional[CommConfig] = None

    name = "permfl"
    supports_participation = True   # paper modes 1-4 (§3.1)

    def init_state(self, params, m: int, n: int) -> P.PerMFLState:
        """All tiers (x / w / theta) broadcast from one model; EF
        residuals zeroed when comm is configured."""
        return P.init_state(params, m, n, comm=self.comm)

    def round(self, state, data, *, team_mask, device_mask, uniforms=None,
              mode=None):
        """One Algorithm-1 global round (K team iters x L device steps);
        ``uniforms`` injects the compressors' uniforms, ``mode`` picks the
        kernels' implementation (see ``permfl_round``)."""
        m, n = device_mask.shape[-2:]
        return P.permfl_round(state, data, self.hp, self.loss_fn,
                              m_teams=m, n_devices=n, team_mask=team_mask,
                              device_mask=device_mask, comm=self.comm,
                              uniforms=uniforms, mode=mode)

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
        """PM/TM/GM mean accuracy over all devices + mean train loss (per
        config for a stacked state)."""
        lead = tuple(state.theta.shape[:-3])
        out = {w: metric_values(P.eval_stacked(
            state, val_data, metric_fn, which=w).flatten(-2).mean(-1))
            for w in ("pm", "tm", "gm")}
        theta = state.theta.reshape(-1, state.theta.shape[-1])
        loss = device_rows(self.loss_fn, state.layout,
                           lambda a, b: theta[a:b],
                           _stacked(train_data, lead), theta.shape[0])
        out["train_loss"] = metric_values(loss.reshape(lead + (-1,)).mean(-1))
        return out

    def _device_losses(self, state, data, grads: bool):
        """Every device's train loss at the state's theta, lead + (M, N),
        and with ``grads`` its gradient, lead + (M, N, S), from one
        forward and one backward (``permfl.device_grads``' arithmetic)."""
        theta = state.theta
        lead = theta.dim() - 3
        flat = theta.reshape(-1, theta.shape[-1])
        batch = _stacked(data, theta.shape[:lead])
        if not grads:
            return self.loss_fn(state.layout.unflatten(flat),
                                batch).view(theta.shape[:-1]), None
        with torch.enable_grad():
            t = flat.detach().requires_grad_(True)
            losses = self.loss_fn(state.layout.unflatten(t), batch)
            (g,) = torch.autograd.grad(losses.sum(), t)
        return losses.detach().view(theta.shape[:-1]), g.view(theta.shape)

    @torch.no_grad()
    def probe_round(self, prev_state, state, data, *, team_mask,
                    device_mask, trace):
        """PerMFL's probes on top of the update norm: the personalization
        gap and tier drift Theorems 1-2 bound (mean / max over
        participants), the post-round device gradient norm, per-tier
        error-feedback residual norms (compressed runs) and the
        participation-weighted train loss. The gradient and the loss come
        from one extra forward and backward of every device."""
        out = super().probe_round(prev_state, state, data,
                                  team_mask=team_mask,
                                  device_mask=device_mask, trace=trace)
        lead = team_mask.dim() - 1
        gated = device_mask * team_mask[..., None]
        cols = state.layout.columns
        if trace.drift:
            gap, drift = P.tier_norms(state)
            out["pers_gap_mean"] = masked_mean(gap, gated, lead)
            out["pers_gap_max"] = masked_max(gap, gated, lead)
            out["tier_drift_mean"] = masked_mean(drift, team_mask, lead)
            out["tier_drift_max"] = masked_max(drift, team_mask, lead)
        if trace.grads or trace.loss:
            losses, g = self._device_losses(state, data, trace.grads)
            if trace.grads:
                out["grad_norm"] = masked_mean(
                    stacked_sq_norm(cols(g), lead + 2).sqrt(), gated, lead)
        if trace.residuals and state.comm is not None:
            out["ef_dev_norm"] = masked_mean(
                stacked_sq_norm(cols(state.comm.ef_dev), lead + 2).sqrt(),
                gated, lead)
            out["ef_team_norm"] = masked_mean(
                stacked_sq_norm(cols(state.comm.ef_team), lead + 1).sqrt(),
                team_mask, lead)
        if trace.loss:
            out["part_loss"] = masked_mean(losses, gated, lead)
        return out

    @torch.no_grad()
    def health_round(self, prev_state, state, data, *, team_mask,
                     device_mask, trace):
        """The nonfinite detectors plus a loss-explosion flag: the
        participation-weighted personalized train loss trips when it goes
        non-finite or exceeds ``trace.health_loss_max``."""
        out = super().health_round(prev_state, state, data,
                                   team_mask=team_mask,
                                   device_mask=device_mask, trace=trace)
        gated = device_mask * team_mask[..., None]
        losses, _ = self._device_losses(state, data, False)
        ploss = masked_mean(losses, gated, team_mask.dim() - 1)
        out["loss_exploded"] = (~torch.isfinite(ploss)
                                | (ploss > trace.health_loss_max)).float()
        return out

    def serving_params(self, state, team=None, device=None):
        """Three-tier serving: device (t, d) gets its personal row
        ``theta[t, d]``, a team-only principal ``w[t]`` and the global
        tier is ``x`` -- the fallback ladder the serving store resolves
        unknown principals down. Integer tensors index whole tiers."""
        if team is None:
            return state.x
        if device is None:
            return state.w[team]
        return state.theta[team, device]

    def make_ledger(self, params):
        """CommLedger sized from the model's leaf sizes; None when no
        compression is configured."""
        if self.comm is None:
            return None
        return CommLedger.for_params(self.comm, params)

    def log_comm_round(self, ledger, *, n_teams, n_devices):
        """Bill one round: K LAN uplinks per participating device, one WAN
        uplink per participating team (counts pre-gated by the engine)."""
        ledger.log_round(k_team=self.hp.k_team, n_teams=n_teams,
                         n_devices=n_devices)

    def device_axes(self, state, m, n):
        """The reference's explicit split: the device models ``theta`` and
        the per-device residuals ``comm.ef_dev`` are device-tier; x, w,
        the round counter, the team residuals and the generator stay
        resident."""
        return ("theta",) if state.comm is None else ("theta", "comm.ef_dev")

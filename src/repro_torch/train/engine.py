"""Multi-round FL engine: a host loop over rounds.

The reference compiles a whole experiment into one ``lax.scan``; PyTorch
runs eagerly, so here the rounds are a plain loop with the same
semantics:

    for each round:
        participation masks (all ones, sampled, or injected)
        state = algo.round(state, data, masks)
        record realized (team-gated) participation counts
        every eval_every rounds, and after the last: algo.eval(state, ...)
    then, for a compressed run, the byte ledger from the realized counts

The eval points are those of the reference's chunked scan (chunks of
``eval_every`` rounds, then a remainder chunk ending at the last round).
Full participation draws no random numbers and uses all-ones masks.
Sampled participation draws from a ``torch.Generator`` seeded with
``seed``; its masks cannot equal the reference's threefry masks, so a
parity run injects the reference's masks through ``masks=``, and the
reference's compressor uniforms through ``uniforms=``.

The host loop over rounds (:func:`drive`) is shared with
``repro_torch.train.sweep``, which runs C configurations through it at
once on a stacked state. Cohort sampling, the system simulator and run
telemetry are not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.participation import sample_masks
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize

__all__ = ["FLResult", "bill_comm", "check_participation", "drive",
           "eval_points", "hparam_skeleton", "mask_source", "run_experiment"]


@dataclass
class FLResult:
    """One experiment's outcome: metric histories (one entry per eval
    point), host-clock times, final state and realized per-round
    participation counts.

    ``round_seconds[t]`` is the host clock around round t (and its eval,
    when it has one), ending after the device has finished its work;
    ``seconds`` is their sum."""
    pm_acc: list = field(default_factory=list)   # per-eval personalized acc
    tm_acc: list = field(default_factory=list)
    gm_acc: list = field(default_factory=list)
    train_loss: list = field(default_factory=list)
    seconds: float = 0.0
    round_seconds: list = field(default_factory=list)
    state: Any = None
    participation: list = field(default_factory=list)  # (teams, devices)/rnd
    comm: Any = None        # CommLedger of a compressed run, else None
    rounds: int = 0
    eval_every: int = 1
    device: str = ""

    def last(self, which="pm"):
        """Final-eval value of metric `which` ('pm'|'tm'|'gm'); NaN if the
        algorithm never reported it."""
        hist = {"pm": self.pm_acc, "tm": self.tm_acc, "gm": self.gm_acc}[which]
        return hist[-1] if hist else float("nan")

    def best(self, which="pm"):
        """Best eval value of metric `which` over the whole run; NaN if the
        algorithm never reported it."""
        hist = {"pm": self.pm_acc, "tm": self.tm_acc, "gm": self.gm_acc}[which]
        return max(hist) if hist else float("nan")


_METRIC_FIELDS = {"pm": "pm_acc", "tm": "tm_acc", "gm": "gm_acc",
                  "train_loss": "train_loss"}


def eval_points(rounds: int, eval_every: int) -> list:
    """1-based rounds after which the engine evaluates: every
    ``eval_every`` rounds and after the final round."""
    return [t + 1 for t in range(rounds)
            if (t + 1) % eval_every == 0 or t == rounds - 1]


def check_participation(algo, team_frac: float, device_frac: float):
    """Reject sampled participation for algorithms that ignore masks."""
    if (team_frac < 1.0 or device_frac < 1.0) and \
            not getattr(algo, "supports_participation", False):
        raise ValueError(
            f"{getattr(algo, 'name', type(algo).__name__)} ignores "
            "participation masks; team_frac/device_frac < 1 would sample "
            "masks that never gate anything")


def hparam_skeleton(algo):
    """``(skeleton, leaves)``: the instance with every sweepable float
    zeroed (what all hyperparameter values share) and its float leaves
    by name (``algo.tree_hparams()``). A sweep rebuilds the skeleton with
    its per-config values."""
    leaves, rebuild = algo.tree_hparams()
    return rebuild({k: 0.0 for k in leaves}), leaves


def _mask(a) -> torch.Tensor:
    """A participation mask as a new float32 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(a, np.float32))


def mask_source(m: int, n: int, *, team_frac: float, device_frac: float,
                seed: int, masks: Optional[Callable] = None) -> Callable:
    """One run's participation, round t -> (team_mask, device_mask): the
    injected ``masks``; else, for partial participation, draws from a
    ``torch.Generator`` seeded with ``seed`` (call it once a round, in
    order); else all ones."""
    if masks is not None:
        return masks
    if team_frac < 1.0 or device_frac < 1.0:
        gen = torch.Generator().manual_seed(seed)
        return lambda t: sample_masks(gen, m, n, team_frac=team_frac,
                                      device_frac=device_frac)
    return lambda t: (torch.ones(m), torch.ones(m, n))


def _to_device(data, device):
    return {k: torch.as_tensor(v).to(device) for k, v in data.items()}


def drive(algo, state, train, val, *, metric_fn, rounds: int,
          eval_every: int, draw_masks: Callable, results: list,
          stacked: bool, device: torch.device, round_kw: dict):
    """The host loop over rounds, shared by ``run_experiment`` and the
    sweep (``repro_torch.train.sweep``).

    state: one run's state, or (``stacked``) a sweep's, whose configs
        lead every tier, and ``train`` / ``val`` with them.
    draw_masks(t): one (team_mask, device_mask) pair per config for round
        t (0-based); a stacked round takes them stacked.
    results: one FLResult per config: each round's realized (team-gated)
        participation and each eval's metrics are appended to its own.
    round_kw: extra keywords of ``algo.round`` (``uniforms``, ``mode``).
    Returns (final state, host-clock seconds of each round, eval
    included, to a synchronized device).
    """
    evals = set(eval_points(rounds, eval_every))
    seconds = []
    for t in range(rounds):
        t0 = time.perf_counter()
        pairs = [(_mask(tm), _mask(dm)) for tm, dm in draw_masks(t)]
        for res, (tm, dm) in zip(results, pairs):
            gated = dm * tm[:, None]
            res.participation.append((int(tm.sum()), int(gated.sum())))
        if stacked:
            tm, dm = (torch.stack(ms) for ms in zip(*pairs))
        else:
            (tm, dm), = pairs
        state = algo.round(state, train, team_mask=tm.to(device),
                           device_mask=dm.to(device), **round_kw)
        if t + 1 in evals:
            for k, v in algo.eval(state, train, val, metric_fn).items():
                for res, x in zip(results, v if stacked else [v]):
                    getattr(res, _METRIC_FIELDS[k]).append(float(x))
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return state, seconds


def bill_comm(algo, params, res: FLResult) -> None:
    """``res.comm``: the byte ledger of ``res``'s realized participation,
    for an algorithm that moves compressed bytes (else left None)."""
    ledger = algo.make_ledger(params)
    if ledger is not None:
        for n_teams, n_devices in res.participation:
            algo.log_comm_round(ledger, n_teams=n_teams, n_devices=n_devices)
        res.comm = ledger


def run_experiment(algo, params0, train_data, val_data, *,
                   metric_fn: Callable, rounds: int, m: int, n: int,
                   team_frac: float = 1.0, device_frac: float = 1.0,
                   seed: int = 0, eval_every: int = 1,
                   masks: Optional[Callable] = None,
                   uniforms: Optional[Callable] = None,
                   device=DEFAULT_DEVICE, cohort=None, system=None,
                   trace=None, trace_dir=None) -> FLResult:
    """Drive ``algo`` for ``rounds`` global rounds on ``device``,
    evaluating every ``eval_every`` rounds and after the final round.

    params0: one model, a nested dict of tensors or numpy arrays.
    train_data / val_data: {"x", "y"} with leading (M, N) axes, tensors
        or numpy arrays; moved to ``device``.
    masks: optional ``masks(t) -> (team_mask (M,), device_mask (M, N))``
        for round t (0-based), replacing sampling: the parity tests hand
        the port the reference's masks this way.
    uniforms: optional ``uniforms(t, k, b)`` source of the compressors'
        uniforms, handed to ``algo.round`` (see ``permfl_round``).
    device: "cuda" (default; raises without a card) or "cpu".
    """
    for name, val in (("cohort", cohort), ("system", system),
                      ("trace", trace), ("trace_dir", trace_dir)):
        if val is not None:
            raise NotImplementedError(
                f"run_experiment({name}=...) is not ported yet "
                "(ROADMAP.md queue 1)")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    check_participation(algo, team_frac, device_frac)
    dev = resolve_device(device)
    params0 = params_from_numpy(params0, dev)
    train, val = _to_device(train_data, dev), _to_device(val_data, dev)

    src = mask_source(m, n, team_frac=team_frac, device_frac=device_frac,
                      seed=seed, masks=masks)
    res = FLResult(rounds=rounds, eval_every=eval_every, device=str(dev))
    state, res.round_seconds = drive(
        algo, algo.init_state(params0, m, n), train, val,
        metric_fn=metric_fn, rounds=rounds, eval_every=eval_every,
        draw_masks=lambda t: [src(t)], results=[res], stacked=False,
        device=dev,
        round_kw={} if uniforms is None else {"uniforms": uniforms})
    res.seconds = sum(res.round_seconds)
    res.state = state
    bill_comm(algo, params0, res)
    return res

"""Scenario execution: build a scenario and run it through the engine,
or sweep a grid of its hyperparameters and seeds (``train.sweep``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.convert import params_from_numpy
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.scenarios.registry import get_scenario
from repro_torch.scenarios.spec import (FLScenario, fns_for, init_model,
                                        to_torch)
from repro_torch.train.engine import FLResult, run_experiment
from repro_torch.train.sweep import FLSweepResult, run_sweep

__all__ = ["ScenarioBuild", "build_scenario", "run_scenario",
           "sweep_scenario"]


@dataclass
class ScenarioBuild:
    """Everything materialized from one (scenario, seed): the stacked
    data (host numpy and device tensors), resolved model config,
    loss/metric closures, the algorithm instance, the seed's params."""
    scenario: FLScenario
    fd: Any            # FederatedData (host numpy)
    config: Any        # PaperModelConfig
    train: dict        # stacked train batch on `device`
    val: dict          # stacked val batch on `device`
    loss_fn: Callable
    metric_fn: Callable
    algo: Any
    params0: dict      # model init for this seed, on `device`
    device: torch.device

    @property
    def m(self) -> int:
        """M: number of teams."""
        return self.fd.m_teams

    @property
    def n(self) -> int:
        """N: devices per team."""
        return self.fd.n_devices


def build_scenario(name_or_spec, seed: int = 0,
                   device=DEFAULT_DEVICE) -> ScenarioBuild:
    """Materialize a scenario (registry name, spec dict, or FLScenario)
    on ``device`` with model-init seed ``seed`` (data from the spec's
    ``data_seed``)."""
    s = get_scenario(name_or_spec)
    dev = resolve_device(device)
    fd = s.data.build(s.data_seed)
    train, val = to_torch(fd, dev)
    cfg = s.model_config()
    loss, metric = fns_for(cfg)
    params0 = params_from_numpy(init_model(cfg, seed), dev)
    return ScenarioBuild(scenario=s, fd=fd, config=cfg, train=train,
                         val=val, loss_fn=loss, metric_fn=metric,
                         algo=s.algo.build(loss, comm=s.comm),
                         params0=params0,
                         device=dev)


def run_scenario(name_or_spec, *, rounds: Optional[int] = None,
                 seed: int = 0, init_seed: Optional[int] = None,
                 eval_every: int = 1, masks: Optional[Callable] = None,
                 uniforms: Optional[Callable] = None,
                 device=DEFAULT_DEVICE) -> FLResult:
    """Run one scenario through the engine on ``device`` (default the
    card; raises without one).

    rounds: override the spec's default round budget.
    seed: participation-sampling seed and (by default) model-init seed.
    init_seed: a separate model-init seed.
    masks: injected participation masks (see ``run_experiment``).
    uniforms: injected compressor uniforms (see ``permfl_round``).
    """
    s = get_scenario(name_or_spec)
    b = build_scenario(s, seed if init_seed is None else init_seed,
                       device=device)
    return run_experiment(
        b.algo, b.params0, b.train, b.val, metric_fn=b.metric_fn,
        rounds=s.rounds if rounds is None else rounds, m=b.m, n=b.n,
        team_frac=s.team_frac, device_frac=s.device_frac, seed=seed,
        eval_every=eval_every, masks=masks, uniforms=uniforms,
        device=b.device)



def sweep_scenario(name_or_spec, grid: Sequence = ({},), seeds=(0,), *,
                   rounds: Optional[int] = None, eval_every: int = 1,
                   device=DEFAULT_DEVICE) -> FLSweepResult:
    """Run a hyperparameter grid x seeds over one scenario as one stacked
    run (``train.sweep.run_sweep``) on ``device`` (default the card;
    raises without one).

    grid: list of {hparam: value} overrides on the scenario algorithm's
        sweepable floats (or a {name: [values...]} product dict); ``[{}]``
        for a seeds-only sweep.
    seeds: each seed gets its own model init (the tables' multi-seed
        protocol) and participation sampling; the shared data comes from
        the spec's ``data_seed``.
    """
    s = get_scenario(name_or_spec)
    if isinstance(seeds, int):
        seeds = (seeds,)
    seeds = tuple(int(x) for x in seeds)
    b = build_scenario(s, seeds[0] if seeds else 0, device=device)
    return run_sweep(
        b.algo, grid, seeds, lambda sd: init_model(b.config, sd), b.train,
        b.val, metric_fn=b.metric_fn,
        rounds=s.rounds if rounds is None else rounds, m=b.m, n=b.n,
        team_frac=s.team_frac, device_frac=s.device_frac,
        eval_every=eval_every, device=b.device)

"""Scenario execution: build a scenario and run it through the engine,
or sweep a grid of its hyperparameters and seeds (``train.sweep``).

``system=`` and ``cohort=`` default to the spec's own ``system`` and
``cohort_size``; passing None turns either off for this run.

With a ``trace_dir`` the runner owns the run's span log (unless a caller
already activated one): the ``scenario_build`` span (with its
``data_build``) and the engine's spans land in one Chrome-trace file,
and the JSONL event log's header carries the scenario's identity (name,
family, spec hash)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.convert import params_from_numpy
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize
from repro_torch.obs.spans import owned_log, span
from repro_torch.scenarios.registry import get_scenario
from repro_torch.scenarios.spec import (FLScenario, fns_for, init_model,
                                        to_torch)
from repro_torch.train.engine import FLResult, run_experiment
from repro_torch.train.sweep import FLSweepResult, run_sweep

__all__ = ["ScenarioBuild", "build_scenario", "run_scenario",
           "sweep_scenario"]

# the run/sweep default for `system` and `cohort`: "not passed -- keep the
# spec's own". Distinct from None, which turns the spec's off.
_KEEP_SPEC = object()


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
    seconds: dict = field(default_factory=dict)  # data build, copy

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
    with span("scenario_build", scenario=s.name, seed=seed):
        with span("data_build", seed=s.data_seed):
            t0 = time.perf_counter()
            fd = s.data.build(s.data_seed)
            t1 = time.perf_counter()
            train, val = to_torch(fd, dev)
            synchronize(dev)
        seconds = {"data": t1 - t0, "to_device": time.perf_counter() - t1}
        cfg = s.model_config()
        loss, metric = fns_for(cfg)
        params0 = params_from_numpy(init_model(cfg, seed), dev)
    return ScenarioBuild(scenario=s, fd=fd, config=cfg, train=train,
                         val=val, loss_fn=loss, metric_fn=metric,
                         algo=s.algo.build(loss, comm=s.comm),
                         params0=params0, device=dev, seconds=seconds)


def _keep(value, own):
    return own if value is _KEEP_SPEC else value


def _identity(s: FLScenario) -> dict:
    """The event log header's scenario identity."""
    return {"scenario": s.name, "family": s.family,
            "spec_hash": s.spec_hash()}


def run_scenario(name_or_spec, *, rounds: Optional[int] = None,
                 seed: int = 0, init_seed: Optional[int] = None,
                 eval_every: int = 1, masks: Optional[Callable] = None,
                 uniforms: Optional[Callable] = None, system=_KEEP_SPEC,
                 cohort=_KEEP_SPEC, links: Optional[Callable] = None,
                 time_parts: bool = False, trace=None, trace_dir=None,
                 device=DEFAULT_DEVICE) -> FLResult:
    """Run one scenario through the engine on ``device`` (default the
    card; raises without one).

    rounds: override the spec's default round budget.
    seed: participation-sampling seed and (by default) model-init seed.
    init_seed: a separate model-init seed.
    masks: injected participation masks (see ``run_experiment``).
    uniforms: injected compressor uniforms (see ``permfl_round``).
    system: wall-clock model (SystemSpec, profile name or spec dict) in
        place of the spec's own; None runs without one.
    cohort: cohort width in place of the spec's ``cohort_size``; None
        runs the stacked path.
    links / time_parts: as ``run_experiment``'s.
    trace / trace_dir: run telemetry (``repro_torch.obs``), as
        ``run_experiment``'s: probe and detector streams on
        ``FLResult.trace`` / ``.health``, and in ``trace_dir`` the JSONL
        event log and one span file covering the scenario build and the
        engine's rounds.
    ``FLResult.setup_seconds`` holds the data's build and copy time.
    """
    s = get_scenario(name_or_spec)
    with owned_log(trace_dir, {"kind": "scenario", "scenario": s.name},
                  s.name):
        b = build_scenario(s, seed if init_seed is None else init_seed,
                           device=device)
        res = run_experiment(
            b.algo, b.params0, b.train, b.val, metric_fn=b.metric_fn,
            rounds=s.rounds if rounds is None else rounds, m=b.m, n=b.n,
            team_frac=s.team_frac, device_frac=s.device_frac, seed=seed,
            eval_every=eval_every, masks=masks, uniforms=uniforms,
            system=_keep(system, s.system),
            cohort=_keep(cohort, s.cohort_size), links=links,
            time_parts=time_parts, trace=trace, trace_dir=trace_dir,
            event_meta=_identity(s), device=b.device)
    res.setup_seconds = dict(b.seconds)
    return res


def sweep_scenario(name_or_spec, grid: Sequence = ({},), seeds=(0,), *,
                   rounds: Optional[int] = None, eval_every: int = 1,
                   mesh=None, system=_KEEP_SPEC, cohort=_KEEP_SPEC,
                   trace=None, trace_dir=None,
                   device=None) -> FLSweepResult:
    """Run a hyperparameter grid x seeds over one scenario as one stacked
    run (``train.sweep.run_sweep``) on ``device`` (default the card;
    raises without one), or on ``mesh``'s device: the one-card sweep
    mesh (``launch.mesh.make_host_mesh(n_sweep=1)``), passed through.

    grid: list of {hparam: value} overrides on the scenario algorithm's
        sweepable floats (or a {name: [values...]} product dict); ``[{}]``
        for a seeds-only sweep.
    seeds: each seed gets its own model init (the tables' multi-seed
        protocol) and participation sampling; the shared data comes from
        the spec's ``data_seed``.
    system: wall-clock model(s) -- one profile, or a sequence adding a
        profile axis to the configs; None runs without one, unpassed the
        spec's own applies.
    cohort: cohort width in place of the spec's ``cohort_size``; None
        runs the stacked path.
    trace / trace_dir: run telemetry, as ``run_scenario``'s: per-config
        probe and detector streams, one sweep event file.
    """
    s = get_scenario(name_or_spec)
    if isinstance(seeds, int):
        seeds = (seeds,)
    seeds = tuple(int(x) for x in seeds)
    with owned_log(trace_dir, {"kind": "scenario_sweep", "scenario": s.name},
                  f"sweep-{s.name}"):
        if mesh is not None and device is None:
            device = mesh.device
        b = build_scenario(s, seeds[0] if seeds else 0, device=device)
        return run_sweep(
            b.algo, grid, seeds, lambda sd: init_model(b.config, sd),
            b.train, b.val, metric_fn=b.metric_fn,
            rounds=s.rounds if rounds is None else rounds, m=b.m, n=b.n,
            team_frac=s.team_frac, device_frac=s.device_frac,
            eval_every=eval_every, system=_keep(system, s.system),
            cohort=_keep(cohort, s.cohort_size), trace=trace,
            trace_dir=trace_dir, event_meta=_identity(s), device=b.device,
            mesh=mesh)

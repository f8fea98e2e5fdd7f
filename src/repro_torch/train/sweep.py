"""Hyperparameter and seed sweeps: a whole grid as one stacked run.

The paper's results are sweeps: Fig 3 varies beta / gamma / lambda, the
tables average over seeds. Looped, each configuration pays every round's
launches again: a CNN round is ~105 launches a device step, whatever
the work in them. This module runs ``len(grid) * len(seeds)``
configurations of one algorithm at once, so that each round launches
each kernel once for all of them:

    the algorithm rebuilt with C values per float hyperparameter
        (``tree_hparams``: float64 arrays, one value per config);
    one init state per seed, stacked on a leading config axis (C, ...);
    the data expanded over C once (the models' batched products take
        one data row per model, so this is one copy per sweep);
    the engine's round loop (``train.engine.drive``) on the stacked
        state: per-config participation masks (each config's own
        generator, seeded with its seed, or injected), one round, one
        eval -- the same round body as a single run;
    one FLResult per config, with its own byte ledger from its realized
        participation.

Configurations never interact, and each config's coefficients are cast
to float32 from the float64 expression its single run evaluates
(``core.permfl.coef``), so config i follows ``run_experiment`` of the
same hyperparameters and seed (``tests/test_torch_sweep.py`` pins it).
The reference compiles the grid into one vmapped program
(``src/repro/train/sweep.py``); PyTorch runs eagerly, so here the stacked
round is the batching.

System profiles ride the config axis too: ``system=[...]`` stacks
several wall-clock worlds (their ``tree_floats`` as (C,) tensors), and
each config comes back with its own ``Timeline``; its links come from
its own generator, seeded from its seed as its single run's are. With
``cohort=c`` every config runs the cohort engine: each round gathers
per-config index maps (C, M, c) along dim 2 of the stacked store, each
config's map from its own generator. On a sweep mesh (``mesh=``, the
one-card (sweep, data, model) mesh of ``launch.mesh.make_host_mesh``)
the stacked states, hyperparameters and system leaves are laid out by
``sharding.specs.sweep_pspecs`` (configs on the sweep axis, the
generators put there explicitly) and the data replicated, through
``sharding.specs.place``: on one card every axis has size 1, so the run
equals the unsharded one bit for bit.

Run telemetry (``trace=``) rides the same stacked round: each config's
probe and detector values come out of the algorithm's ``probe_round`` /
``health_round`` with the config axis leading, and each config's
FLResult gets its own ``RunTrace`` and ``HealthReport``, the streams its
single run would give. ``trace.fail_fast`` checks every round and names
the first bad config (``config i``); ``trace_dir`` writes the whole
sweep's JSONL event stream (a ``sweep_header``, then each config's run
section) and one span file.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm.config import copy_generator
from repro_torch.convert import params_from_numpy
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs.events import write_sweep
from repro_torch.obs.spans import owned_log, span
from repro_torch.obs.trace import TraceConfig
from repro_torch.sharding.specs import P, place, sweep_pspecs
from repro_torch.system import SystemSpec, Timeline, get_profile, \
    workload_for
from repro_torch.train.engine import (FLResult, RoundSystem, _to_device,
                                      assemble_timeline, bill_comm,
                                      check_cohort, check_participation,
                                      cohort_source, drive, finish_times,
                                      hparam_skeleton, link_source,
                                      mask_source, spec_leaves)
from repro_torch.train.store import config_state

__all__ = ["FLSweepResult", "grid_product", "run_multi_sweep", "run_sweep",
           "stack_states"]


def grid_product(**axes) -> list:
    """Cartesian product of named value lists as a list of config dicts.

    ``grid_product(beta=[0.1, 0.5], lam=[1.0])`` ->
    ``[{"beta": 0.1, "lam": 1.0}, {"beta": 0.5, "lam": 1.0}]``.
    """
    names = list(axes)
    return [dict(zip(names, vals))
            for vals in itertools.product(*axes.values())]


@dataclass
class FLSweepResult:
    """One stacked sweep: C = len(grid) * len(seeds) configurations.

    configs: per-config dicts -- every sweepable hyperparameter, the
        config's ``seed`` (and its ``system`` profile's name when system
        models ride the axis) -- in grid-major order (all seeds of
        grid[0], then grid[1], ...; profiles innermost).
    results: one FLResult per config (histories, participation, final
        state slice, byte ledger, probe and detector streams). Its
        ``seconds``, ``round_seconds`` and compile / run split are the
        sweep's divided by C.
    state_stacked: the final state with the leading (C,) config axis.
    seconds / round_seconds: host clock of the whole sweep, each round
        (eval included) to a synchronized device; ``compile_seconds`` is
        the first round, ``run_seconds`` the rest.
    dispatches: rounds run plus evals, as ``FLResult.dispatches``.
    events_path: the JSONL event log of a ``trace_dir`` sweep.
    """
    configs: list = field(default_factory=list)
    results: list = field(default_factory=list)
    state_stacked: Any = None
    seconds: float = 0.0
    round_seconds: list = field(default_factory=list)
    compile_seconds: float = 0.0
    run_seconds: float = 0.0
    dispatches: int = 0
    events_path: Optional[str] = None

    def __len__(self):
        return len(self.results)

    def __getitem__(self, i) -> FLResult:
        return self.results[i]

    def __iter__(self):
        return iter(self.results)

    def best(self, which="pm") -> list:
        """Per-config best metric (see FLResult.best)."""
        return [r.best(which) for r in self.results]

    def final(self, which="pm") -> list:
        """Per-config final-eval metric."""
        return [r.last(which) for r in self.results]


def stack_states(states: Sequence):
    """Single-run states of one algorithm -> one state with a leading
    config axis: tensors stacked, generators copied into a tuple, nested
    state dataclasses stacked field by field; other fields (layout,
    round) must agree and are kept."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(states))
    if isinstance(first, torch.Generator):
        return tuple(copy_generator(g) for g in states)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: stack_states([getattr(s, f.name) for s in states])
            for f in dataclasses.fields(first)})
    if any(s != first for s in states[1:]):
        raise ValueError(f"states differ in a field that does not stack: "
                         f"{first!r}")
    return first


@dataclass
class _Prepared:
    """One sweep's validated, stacked operands."""
    algo: Any              # rebuilt with C values per float hyperparameter
    state: Any             # stacked init states
    configs: list
    seeds: tuple           # each config's seed
    profiles: list         # each config's SystemSpec, or None
    ledger_params: Any
    hstack: dict           # each float hyperparameter's (C,) values


def _profiles(system) -> list:
    """The sweep's system profiles: [None] without a model; one spec, or
    a sequence of them, as a list of SystemSpecs."""
    if system is None:
        return [None]
    if isinstance(system, (str, dict, SystemSpec)):
        system = [system]
    profiles = [get_profile(p) for p in system]
    if not profiles:
        raise ValueError("empty system: pass None or at least one profile")
    if len({p.skeleton() for p in profiles}) != 1:
        raise ValueError("system profiles on one sweep axis must share a "
                         "static skeleton")
    return profiles


def _prepare(algo, grid, seeds, params0, m, n, team_frac, device_frac,
             dev, system=None) -> _Prepared:
    """Validate one sweep and stack its operands."""
    if isinstance(grid, dict):
        grid = grid_product(**grid)
    grid = [dict(g) for g in grid]
    if not grid:
        raise ValueError("empty grid: pass [{}] for a seeds-only sweep")
    if isinstance(seeds, int):
        seeds = (seeds,)
    seeds = tuple(int(s) for s in seeds)
    if not seeds:
        raise ValueError("empty seeds: pass at least one seed")
    check_participation(algo, team_frac, device_frac)

    leaves0, _ = algo.tree_hparams()
    for g in grid:
        unknown = set(g) - set(leaves0)
        if unknown:
            raise ValueError(
                f"unknown sweepable hyperparameter(s) {sorted(unknown)}; "
                f"{type(algo).__name__} sweeps over {sorted(leaves0)}")

    profiles = _profiles(system)
    combos = [(g, s, p) for g in grid for s in seeds for p in profiles]
    configs = [dict(leaves0, **g, seed=s,
                    **({"system": p.name} if p is not None else {}))
               for g, s, p in combos]
    values = {k: np.asarray([float(dict(leaves0, **g)[k])
                             for g, _, _ in combos], np.float64)
              for k in leaves0}
    skel, _ = hparam_skeleton(algo)
    stacked_algo = skel.tree_hparams()[1](values)

    # one init per seed, however many grid points share it
    if callable(params0):
        p_by_seed = {s: params_from_numpy(params0(s), dev) for s in seeds}
    else:
        shared = params_from_numpy(params0, dev)
        p_by_seed = {s: shared for s in seeds}
    st_by_seed = {s: algo.init_state(p_by_seed[s], m, n) for s in seeds}
    return _Prepared(
        algo=stacked_algo,
        state=stack_states([st_by_seed[s] for _, s, _ in combos]),
        configs=configs, seeds=tuple(s for _, s, _ in combos),
        profiles=[p for _, _, p in combos],
        ledger_params=p_by_seed[seeds[0]], hstack=values)


def _per_config(hook, name, c):
    """An injection hook given per config: None, or a sequence of C."""
    if hook is None:
        return None
    hook = list(hook)
    if len(hook) != c:
        raise ValueError(f"{name}: {len(hook)} sources for {c} configs")
    return hook


def _expand(data, c, dev):
    """Data leading (M, N, ...) as (C, M, N, ...) on ``dev``, one copy."""
    return {k: v.expand((c,) + tuple(v.shape)).contiguous()
            for k, v in _to_device(data, dev).items()}


def _device(device, mesh) -> torch.device:
    """The sweep's device: ``device`` (None: the card), or the mesh's,
    which ``device`` may name."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device).type != \
            mesh.device.type:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def _place(prep, train, val, sys_leaves, mesh, m, n):
    """The sweep's operands laid out on ``mesh``: the stacked states,
    hyperparameters and system leaves by ``sweep_pspecs`` (the configs'
    generators on the sweep axis, explicitly), the data replicated."""
    def by_sweep(tree):
        return place(tree, sweep_pspecs(tree, m=m, n=n), mesh)

    def replicated(data):
        return place(data, {k: P() for k in data}, mesh)

    prep = dataclasses.replace(prep, state=by_sweep(prep.state),
                               hstack=by_sweep(prep.hstack))
    return (prep, replicated(train), replicated(val),
            None if sys_leaves is None else by_sweep(sys_leaves))


def run_sweep(algo, grid, seeds, params0, train_data, val_data, *,
              metric_fn: Callable, rounds: int, m: int, n: int,
              team_frac: float = 1.0, device_frac: float = 1.0,
              eval_every: int = 1, masks: Optional[Sequence] = None,
              uniforms: Optional[Sequence] = None, mode=None,
              device=None, mesh=None, system=None, trace=None,
              trace_dir=None, event_meta: Optional[dict] = None,
              cohort: Optional[int] = None,
              cohort_indices: Optional[Sequence] = None,
              links: Optional[Sequence] = None) -> FLSweepResult:
    """Run ``len(grid) * len(seeds) [* len(system)]`` experiments of
    ``algo`` as one stacked run on ``device`` (default the card; raises
    without one).

    algo: the template FLAlgorithm -- its float hyperparameters
        (``algo.tree_hparams()``) are the sweepable names; loop bounds,
        the loss and ``comm`` are shared by every configuration.
    grid: list of {hparam: value} overrides, one per grid point (unset
        names keep the template's value), or a {name: [values...]} dict
        taken as the full cartesian product.
    seeds: int or sequence of ints; every grid point runs once per seed.
        The seed seeds the config's participation sampling, cohort maps
        and links exactly as ``run_experiment(seed=...)`` does.
    params0: one model shared by all configs (a nested dict of tensors or
        numpy arrays), or a callable ``seed -> params`` (one init per
        seed).
    masks: optional sequence of C ``masks(t)`` hooks, one per config, as
        ``run_experiment`` takes one; uniforms: likewise C ``uniforms(t,
        k, b)`` sources of the compressors' uniforms; cohort_indices and
        links likewise C hooks of ``run_experiment``'s.
    mode: kernel mode of the rounds (None: by device; "torch": the plain
        versions, for comparisons on the card).
    system: optional wall-clock model(s): one SystemSpec, profile name or
        spec dict, or a sequence of them -- a sequence adds a profile
        axis (innermost) to the configs, each config priced on its own.
    cohort: optional cohort width: every config runs the cohort engine.
    trace: optional ``repro_torch.obs.TraceConfig`` (or True): each
        config's FLResult gets its own ``RunTrace`` (and ``HealthReport``)
        -- the streams of running the config alone; ``trace.fail_fast``
        raises ``HealthError`` naming the round and ``config i``.
    trace_dir / event_meta: when set, write the whole sweep's JSONL
        event stream (sweep_header + per-config run sections) and a span
        file into trace_dir (the spans into a caller's active log, if
        any).
    mesh: optional one-card sweep mesh (module docstring); the run's
        device is the mesh's (``device`` left None, or naming it).
    Remaining arguments match ``run_experiment``.
    """
    name = getattr(algo, "name", None)
    with owned_log(trace_dir, {"kind": "sweep", "algo": name},
                   f"sweep-{name or 'run'}"):
        if trace is True:
            trace = TraceConfig()
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        cohort = check_cohort(cohort, n)
        if cohort_indices is not None and cohort is None:
            raise ValueError("cohort_indices= needs cohort=")
        if links is not None and system is None:
            raise ValueError("links= needs system=")
        dev = _device(device, mesh)
        with span("build", algo=getattr(algo, "name", "?"), m=m, n=n,
                  rounds=rounds):
            prep = _prepare(algo, grid, seeds, params0, m, n, team_frac,
                            device_frac, dev, system)
            train = _expand(train_data, len(prep.configs), dev)
            val = _expand(val_data, len(prep.configs), dev)
            sys_leaves = (None if prep.profiles[0] is None
                          else spec_leaves(prep.profiles, dev))
            if mesh is not None:
                prep, train, val, sys_leaves = _place(
                    prep, train, val, sys_leaves, mesh, m, n)
        c = len(prep.configs)
        masks = _per_config(masks, "masks", c)
        uniforms = _per_config(uniforms, "uniforms", c)
        cohort_indices = _per_config(cohort_indices, "cohort_indices", c)
        links = _per_config(links, "links", c)
        width = n if cohort is None else cohort
        srcs = [mask_source(m, width, team_frac=team_frac,
                            device_frac=device_frac, seed=s,
                            masks=None if masks is None else masks[i])
                for i, s in enumerate(prep.seeds)]
        results = [FLResult(rounds=rounds, eval_every=eval_every,
                            device=str(dev), cohort=cohort,
                            population=None if cohort is None else n)
                   for _ in prep.configs]
        draw_cohort = sysrun = None
        if cohort is not None:
            csrcs = [cohort_source(
                m, n, cohort, seed=s, device=dev,
                cohort_indices=None if cohort_indices is None
                else cohort_indices[i]) for i, s in enumerate(prep.seeds)]
            draw_cohort = lambda t: torch.stack([f(t) for f in csrcs])  # noqa
        if prep.profiles[0] is not None:
            for res, p in zip(results, prep.profiles):
                res.timeline = Timeline(profile=p.name)
            lsrcs = [link_source(spec_leaves(p, dev), m, width, seed=s,
                                 device=dev,
                                 links=None if links is None else links[i])
                     for i, (s, p) in enumerate(zip(prep.seeds,
                                                    prep.profiles))]
            sysrun = RoundSystem(
                sys_leaves,
                workload_for(algo, prep.ledger_params),
                lambda t: tuple(torch.stack(ls) for ls in
                                zip(*[f(t) for f in lsrcs])))
        round_kw = {} if mode is None else {"mode": mode}
        if uniforms is not None:
            round_kw["uniforms"] = uniforms
        state, seconds = drive(
            prep.algo, prep.state, train, val, metric_fn=metric_fn,
            rounds=rounds, eval_every=eval_every,
            draw_masks=lambda t: [src(t) for src in srcs], results=results,
            stacked=True, device=dev, round_kw=round_kw, m=m, n=n,
            draw_cohort=draw_cohort, system=sysrun, trace=trace,
            contexts=[f"config {i}" for i in range(c)])
        with span("collect", configs=c):
            for i, res in enumerate(results):
                finish_times(res, seconds, c)
                res.state = config_state(state, i)
                if res.timeline is not None:
                    assemble_timeline(res)
                bill_comm(algo, prep.ledger_params, res)
            first, later = sum(seconds[:1]), sum(seconds[1:])
            out = FLSweepResult(configs=prep.configs, results=results,
                                state_stacked=state, seconds=first + later,
                                round_seconds=seconds, compile_seconds=first,
                                run_seconds=later,
                                dispatches=results[0].dispatches)
        if trace_dir is not None:
            out.events_path = str(write_sweep(
                trace_dir, out, algo=algo,
                meta={"m": m, "n": n, "team_frac": team_frac,
                      "device_frac": device_frac, **(event_meta or {})}))
        return out


def run_multi_sweep(variants, train_data, val_data, *,
                    metric_fn: Callable, rounds: int, m: int, n: int,
                    eval_every: int = 1, device=DEFAULT_DEVICE) -> list:
    """Several sweeps whose round differs in structure (another
    compressor, another algorithm, a cohort engine or not) over one
    experiment's data.

    variants: dicts with keys ``algo`` and ``params0`` and optional
        ``grid`` (default ``[{}]``), ``seeds`` (default ``(0,)``),
        ``team_frac`` / ``device_frac`` (default 1.0), ``system`` and
        ``cohort`` and ``trace`` (as in ``run_sweep``; members choose
        each on their own).

    Returns one FLSweepResult per variant, in order. The reference fuses
    the variants into one compiled program; eagerly they run one after
    another, each a stacked ``run_sweep``.
    """
    return [run_sweep(
        v["algo"], v.get("grid", [{}]), v.get("seeds", (0,)), v["params0"],
        train_data, val_data, metric_fn=metric_fn, rounds=rounds, m=m, n=n,
        team_frac=v.get("team_frac", 1.0),
        device_frac=v.get("device_frac", 1.0), eval_every=eval_every,
        device=device, system=v.get("system"), trace=v.get("trace"),
        cohort=v.get("cohort")) for v in variants]

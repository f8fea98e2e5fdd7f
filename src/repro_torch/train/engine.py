"""Multi-round FL engine: a host loop over rounds.

The reference compiles a whole experiment into one ``lax.scan``; PyTorch
runs eagerly, so here the rounds are a plain loop with the same
semantics, in the order of the reference's round body:

    for each round:
        participation masks (all ones, sampled, or injected), at the
            cohort's width under the cohort engine
        cohort engine (``cohort=c``): the round's (M, c) index map, and
            the cohort's data and device tier gathered from the store
        system model (``system=``): the round's links drawn, the round
            priced along the critical path and, with a deadline, the
            masks thinned (``repro_torch.system``)
        state = algo.round(state, data, masks)
        record realized (team-gated) participation counts
        cohort engine: the cohort's device tier scattered back, in place
        every eval_every rounds, and after the last: algo.eval on the
            full population's state
    then, for a compressed run, the byte ledger from the realized counts,
    and with a system model the simulated ``Timeline``

The eval points are those of the reference's chunked scan (chunks of
``eval_every`` rounds, then a remainder chunk ending at the last round).

The cohort engine keeps the population's device tier resident
(``repro_torch.train.store``) and runs each round on a sampled cohort
of c devices per team; masks, ledger counts and the system model all see
the (M, c) cohort. With ``c == n`` the index map is ``arange(n)``, so
the run is the stacked run, bit for bit; ``cohort=None`` is the stacked
path itself.

Random streams: three ``torch.Generator``s, one each for the masks (on
the CPU, seeded with ``seed``; full participation draws nothing), the
cohort maps and the links (on the run's device, seeded from ``seed``
and the reference's salts), so turning a cohort or a system model on
never moves the mask stream. Their draws cannot equal the reference's
threefry streams, so a parity run injects the reference's masks
(``masks=``), cohort maps (``cohort_indices=``), links (``links=``) and
compressor uniforms (``uniforms=``).

The host loop over rounds (:func:`drive`) is shared with
``repro_torch.train.sweep``, which runs C configurations through it at
once on a stacked state.

Run telemetry (``trace=``, ``trace_dir=``; ``repro_torch.obs``): with a
``TraceConfig`` the algorithm's ``probe_round`` (and, under
``trace.health``, ``health_round``) reads the states before and after
each round, before the cohort's scatter, and their float32 scalars join
the round's participation counts in the one copy to the host the loop
makes each round anyway: probes add no synchronize, and fail-fast checks
every round. Each round runs in a span (``compile`` for the first,
``dispatch`` after), each eval in an ``eval`` span; with ``trace_dir``
the run writes the reference's JSONL event log and a Chrome-trace span
file there. With ``trace=None`` the loop does nothing it did not do
before: no extra tensor, launch or synchronize.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core.participation import sample_cohort, sample_masks
from repro_torch.device import DEFAULT_DEVICE, resolve_device, synchronize
from repro_torch.obs.events import write_run
from repro_torch.obs.health import HealthReport
from repro_torch.obs.profiling import compiled_cost, profile_ctx
from repro_torch.obs.spans import owned_log, span
from repro_torch.obs.trace import RunTrace, TraceConfig, eval_points
from repro_torch.system import (Timeline, get_profile, sample_links,
                                simulate_round, workload_for)
from repro_torch.train.store import (DeviceStateStore, gather_cohort,
                                     split_device_state)

__all__ = ["FLResult", "RoundSystem", "assemble_timeline", "bill_comm",
           "check_cohort", "check_participation", "cohort_source", "drive",
           "eval_points", "finish_times", "hparam_skeleton", "link_source",
           "mask_source", "run_experiment", "spec_leaves"]

# salts separating the cohort and the system streams from the mask
# stream (ASCII "CHRT" and "SYST", the reference's)
_COHORT_SALT = 0x43485254
_SYSTEM_SALT = 0x53595354


@dataclass
class FLResult:
    """One experiment's outcome: metric histories (one entry per eval
    point), host-clock times, final state and realized per-round
    participation counts.

    ``round_seconds[t]`` is the host clock around round t (and its eval,
    when it has one), ending after the device has finished its work;
    ``seconds`` is their sum. ``part_seconds`` (``time_parts=True``)
    splits each round into synchronized parts: "sample" (masks and cohort
    map), "gather", "system", "round", "scatter", "eval", each a list
    over the rounds that ran it. ``setup_seconds`` is filled by
    ``run_scenario``: the data's build and its copy to the device.

    A cohort run records ``cohort`` (c), ``population`` (n) and each
    round's (M, c) index map in ``cohort_indices``; a run with a system
    model its ``timeline`` and the cumulative simulated seconds at each
    eval point, ``sim_seconds``.

    The reference's cost split, in the port's terms: ``compile_seconds``
    is the first round's ``round_seconds`` (its kernels built and loaded,
    cuBLAS warmed up; eval included when it has one), ``run_seconds``
    the rest, so ``seconds = compile_seconds + run_seconds``;
    ``dispatches`` counts rounds run plus evals, as the reference's
    per-round dispatch path counts its jitted calls. A traced run
    (``trace=``) carries its probe streams in ``trace`` and, under
    ``trace.health``, its detector streams in ``health``; with
    ``trace_dir`` its JSONL event log's path is ``events_path``."""
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
    timeline: Optional[Timeline] = None   # per-round simulated clock
    sim_seconds: list = field(default_factory=list)  # cum sim time @ evals
    cohort: Optional[int] = None          # cohort width (cohort runs)
    population: Optional[int] = None      # resident devices per team
    cohort_indices: list = field(default_factory=list)  # (M, c) idx / rnd
    part_seconds: dict = field(default_factory=dict)
    setup_seconds: dict = field(default_factory=dict)
    compile_seconds: float = 0.0          # the first round
    run_seconds: float = 0.0              # every later round
    dispatches: int = 0                   # rounds run + evals
    trace: Optional[RunTrace] = None      # per-round probe streams
    health: Optional[HealthReport] = None  # per-round detector streams
    events_path: Optional[str] = None     # JSONL event log (trace_dir)

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


def check_participation(algo, team_frac: float, device_frac: float):
    """Reject sampled participation for algorithms that ignore masks."""
    if (team_frac < 1.0 or device_frac < 1.0) and \
            not getattr(algo, "supports_participation", False):
        raise ValueError(
            f"{getattr(algo, 'name', type(algo).__name__)} ignores "
            "participation masks; team_frac/device_frac < 1 would sample "
            "masks that never gate anything")


def check_cohort(cohort, n: int) -> Optional[int]:
    """``cohort`` as an int in [1, n], or None."""
    if cohort is None:
        return None
    cohort = int(cohort)
    if not 1 <= cohort <= n:
        raise ValueError(f"cohort must be in [1, n_devices={n}], got "
                         f"{cohort}")
    return cohort


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


def _salted(seed: int, salt: int) -> int:
    """The seed of a stream that ``salt`` separates from ``seed``'s: the
    salt in the high 32 bits, and mixed into the low 32, which are all
    that a CPU generator (mt19937) keeps."""
    return (salt << 32) | ((int(seed) + salt * 0x9E3779B1) & 0xFFFF_FFFF)


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


def cohort_source(m: int, n: int, cohort: int, *, seed: int,
                  device: torch.device,
                  cohort_indices: Optional[Callable] = None) -> Callable:
    """One run's cohort maps, round t -> (M, c) int64 on ``device``: the
    injected ``cohort_indices(t)``; else :func:`sample_cohort` from a
    generator on ``device`` seeded from ``seed`` and the cohort salt."""
    if cohort_indices is not None:
        def given(t):
            idx = torch.as_tensor(cohort_indices(t), dtype=torch.int64,
                                  device=device)
            if tuple(idx.shape) != (m, cohort):
                raise ValueError(f"cohort_indices({t}) gave "
                                 f"{tuple(idx.shape)}, expected "
                                 f"{(m, cohort)}")
            return idx
        return given
    gen = torch.Generator(device=device).manual_seed(
        _salted(seed, _COHORT_SALT))
    return lambda t: sample_cohort(gen, m, n, cohort)


def link_source(leaves: dict, m: int, n: int, *, seed: int,
                device: torch.device,
                links: Optional[Callable] = None) -> Callable:
    """One run's links, round t -> (rate (M, N), lan_bps (M, N), wan_bps
    (M,)) float32 on ``device``: the injected ``links(t)``; else
    ``sample_links`` from a generator on ``device`` seeded from ``seed``
    and the system salt."""
    if links is not None:
        def given(t):
            out = tuple(torch.as_tensor(a, dtype=torch.float32,
                                        device=device) for a in links(t))
            if [tuple(a.shape) for a in out] != [(m, n), (m, n), (m,)]:
                raise ValueError(f"links({t}) gave shapes "
                                 f"{[tuple(a.shape) for a in out]}, "
                                 f"expected {[(m, n), (m, n), (m,)]}")
            return out
        return given
    gen = torch.Generator(device=device).manual_seed(
        _salted(seed, _SYSTEM_SALT))
    return lambda t: sample_links(leaves, gen, m, n)


@dataclass
class RoundSystem:
    """What ``drive`` needs of a system model: the spec's float leaves as
    float32 tensors on the run's device (0-d, or (C,) for a sweep), the
    algorithm's RoundWorkload, and ``links(t)``, the round's links
    (lead + (M, N) and lead + (M,))."""
    leaves: dict
    workload: Any
    links: Callable


def spec_leaves(specs, device) -> dict:
    """A SystemSpec's float leaves as float32 tensors on ``device``; a
    list of specs gives (C,) per-config values."""
    if isinstance(specs, (list, tuple)):
        rows = [p.tree_floats()[0] for p in specs]
        return {k: torch.tensor([r[k] for r in rows], dtype=torch.float32,
                                device=device) for k in rows[0]}
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in specs.tree_floats()[0].items()}


def _to_device(data, device):
    return {k: torch.as_tensor(v).to(device) for k, v in data.items()}


class _Clock:
    """Synchronized host-clock laps of one round's parts, into ``parts``
    (name -> list of seconds); does nothing when ``parts`` is None."""

    def __init__(self, device, parts):
        self.device, self.parts = device, parts
        self.t = time.perf_counter()

    def lap(self, name):
        if self.parts is None:
            return
        synchronize(self.device)
        now = time.perf_counter()
        self.parts.setdefault(name, []).append(now - self.t)
        self.t = now


def drive(algo, state, train, val, *, metric_fn, rounds: int,
          eval_every: int, draw_masks: Callable, results: list,
          stacked: bool, device: torch.device, round_kw: dict, m: int,
          n: int, draw_cohort: Optional[Callable] = None,
          system: Optional[RoundSystem] = None, parts=None, trace=None,
          contexts: Optional[list] = None):
    """The host loop over rounds, shared by ``run_experiment`` and the
    sweep (``repro_torch.train.sweep``).

    state: one run's state, or (``stacked``) a sweep's, whose configs
        lead every tier, and ``train`` / ``val`` with them.
    draw_masks(t): one (team_mask, device_mask) pair per config for round
        t (0-based), at the round's width (n, or the cohort's); a stacked
        round takes them stacked.
    results: one FLResult per config: each round's realized (team-gated)
        participation, cohort map, simulated time and probe and detector
        values, and each eval's metrics are appended to its own (its
        ``timeline`` set when a system model runs).
    round_kw: extra keywords of ``algo.round`` (``uniforms``, ``mode``).
    draw_cohort: the cohort engine's round t -> index map (lead + (M, c)
        int64 on ``device``): the device tier lives in a
        ``DeviceStateStore`` and each round runs on the gathered cohort.
    system: a RoundSystem, priced each round before the algorithm's
        round (its masks thinned under a deadline).
    parts: None, or a dict the rounds' synchronized parts are added to.
    trace: None, or a ``TraceConfig``: each result gets a ``RunTrace``
        (and a ``HealthReport`` under ``trace.health``) filled round by
        round; ``trace.cost_analysis`` counts the first round's FLOPs,
        ``trace.fail_fast`` raises ``HealthError`` naming the first bad
        round and ``contexts[i]`` (config i's identity).
    Returns (final state, host-clock seconds of each round, eval
    included, to a synchronized device).
    """
    evals = set(eval_points(rounds, eval_every))
    cohort = draw_cohort is not None
    if cohort:
        tier, rest, merge = split_device_state(algo, state, m, n,
                                               stacked=stacked)
        store = DeviceStateStore(tier, m, n)
        state = None
    if trace is not None:
        for res in results:
            res.trace = RunTrace(config=trace)
            res.health = HealthReport() if trace.health else None
    seconds = []
    for t in range(rounds):
        t0 = time.perf_counter()
        with span("compile" if t == 0 else "dispatch", round=t + 1) as sp:
            clock = _Clock(device, parts)
            pairs = [(_mask(tm), _mask(dm)) for tm, dm in draw_masks(t)]
            if stacked:
                tm, dm = (torch.stack(ms) for ms in zip(*pairs))
            else:
                (tm, dm), = pairs
            tm, dm = tm.to(device), dm.to(device)
            data, cur, idx = train, state, None
            if cohort:
                idx = draw_cohort(t)
            clock.lap("sample")
            if cohort:
                data = gather_cohort(train, idx)
                cur = merge(store.gather(idx), rest)
                clock.lap("gather")
            sim = []
            if system is not None:
                tm, dm, *sim = simulate_round(system.leaves,
                                              system.workload,
                                              system.links(t), tm, dm)
                clock.lap("system")
            prev = cur
            if t == 0 and trace is not None and trace.cost_analysis:
                cur, cost = compiled_cost(algo.round, cur, data,
                                          team_mask=tm, device_mask=dm,
                                          **round_kw)
                sp.set(**cost)
                for res in results:
                    res.trace.cost = dict(cost)
            else:
                cur = algo.round(cur, data, team_mask=tm, device_mask=dm,
                                 **round_kw)
            clock.lap("round")
            obs = {}
            if trace is not None:
                kw = dict(team_mask=tm, device_mask=dm, trace=trace)
                obs = {("probe", k): v for k, v in algo.probe_round(
                    prev, cur, data, **kw).items()}
                if trace.health:
                    obs.update({("health", k): v for k, v in
                                algo.health_round(prev, cur, data,
                                                  **kw).items()})
            if not cohort:
                state = cur
            else:
                tier, rest, _ = split_device_state(
                    algo, cur, m, idx.shape[-1], stacked=stacked)
                store.scatter(idx, tier)
                clock.lap("scatter")
            # one copy to the host a round: counts, simulated time, drops,
            # probe and detector values
            gated = dm * tm[..., None]
            rec = torch.stack(
                [v.to(torch.float64) for v in
                 [tm.sum(dim=-1), gated.sum(dim=(-2, -1))] + sim
                 + list(obs.values())],
                dim=-1).reshape(len(results), -1).tolist()
            idx_host = None if idx is None else idx.tolist()
            for i, (res, row) in enumerate(zip(results, rec)):
                res.participation.append((int(row[0]), int(row[1])))
                if system is not None:
                    res.timeline.round_seconds.append(row[2])
                    res.timeline.dropped_teams.append(int(row[3]))
                    res.timeline.dropped_devices.append(int(row[4]))
                if idx_host is not None:
                    res.cohort_indices.append(idx_host[i] if stacked
                                              else idx_host)
                for (kind, k), v in zip(obs, row[2 + len(sim):]):
                    out = res.trace if kind == "probe" else res.health
                    out.series.setdefault(k, []).append(v)
            if trace is not None and trace.health and trace.fail_fast:
                for i, res in enumerate(results):
                    res.health.check(contexts[i] if contexts else "")
        if t + 1 in evals:
            with span("eval", round=t + 1):
                full = merge(store.tree, rest) if cohort else state
                for k, v in algo.eval(full, train, val, metric_fn).items():
                    for res, x in zip(results, v if stacked else [v]):
                        getattr(res, _METRIC_FIELDS[k]).append(float(x))
                clock.lap("eval")
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
    if cohort:
        state = merge(store.tree, rest)
    return state, seconds


def finish_times(res: FLResult, seconds: list, scale: float = 1.0) -> None:
    """``res``'s host-clock fields from a run's per-round ``seconds``
    (each divided by ``scale``, a sweep's config count): the rounds, their
    sum, the first round as ``compile_seconds`` and the rest as
    ``run_seconds``; and ``dispatches``, its rounds plus its evals."""
    res.round_seconds = [x / scale for x in seconds]
    res.compile_seconds = sum(res.round_seconds[:1])
    res.run_seconds = sum(res.round_seconds[1:])
    res.seconds = res.compile_seconds + res.run_seconds
    res.dispatches = len(seconds) + len(eval_points(res.rounds,
                                                    res.eval_every))


def assemble_timeline(res: FLResult) -> None:
    """``res.sim_seconds``: the cumulative simulated time of its timeline
    at each eval point (the rounds' values appended by ``drive``)."""
    res.sim_seconds = res.timeline.at_rounds(
        eval_points(res.rounds, res.eval_every))


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
                   device=DEFAULT_DEVICE, cohort: Optional[int] = None,
                   system=None, cohort_indices: Optional[Callable] = None,
                   links: Optional[Callable] = None,
                   time_parts: bool = False, trace=None,
                   trace_dir=None,
                   event_meta: Optional[dict] = None) -> FLResult:
    """Drive ``algo`` for ``rounds`` global rounds on ``device``,
    evaluating every ``eval_every`` rounds and after the final round.

    params0: one model, a nested dict of tensors or numpy arrays.
    train_data / val_data: {"x", "y"} with leading (M, N) axes, tensors
        or numpy arrays; moved to ``device``.
    masks: optional ``masks(t) -> (team_mask (M,), device_mask (M, W))``
        for round t (0-based), W the round's width (n, or the cohort's),
        replacing sampling: the parity tests hand the port the
        reference's masks this way.
    uniforms: optional ``uniforms(t, k, b)`` source of the compressors'
        uniforms, handed to ``algo.round`` (see ``permfl_round``).
    cohort: optional cohort width c in [1, n]: the cohort engine (module
        docstring); ``team_frac`` / ``device_frac`` then sample within
        the cohort. ``cohort_indices(t) -> (M, c)`` injects the maps.
    system: optional wall-clock model (a ``repro_torch.system.SystemSpec``,
        a profile name or a spec dict): each round is priced and, with a
        deadline, its stragglers dropped; the result gets a ``timeline``
        and ``sim_seconds``. ``links(t) -> (rate, lan_bps, wan_bps)``
        injects the round's links.
    time_parts: synchronize around each part of a round and record it in
        ``FLResult.part_seconds``.
    device: "cuda" (default; raises without a card) or "cpu".
    trace: optional ``repro_torch.obs.TraceConfig`` (or True for the
        default one): per-round probe values on ``FLResult.trace`` and,
        under ``trace.health``, detector values on ``FLResult.health``;
        ``trace.fail_fast`` raises ``HealthError`` naming the first bad
        round; ``trace.profile_dir`` runs the rounds under
        ``torch.profiler``; ``trace.cost_analysis`` counts the first
        round's FLOPs. None (default) changes nothing.
    trace_dir: when set, write the run's JSONL event log
        (``repro_torch.obs.events``) into this directory, plus a
        Chrome-trace span file covering build, rounds and evals -- unless
        a caller already activated a ``SpanLog``, in which case the spans
        land there and the caller saves; ``event_meta`` is merged into
        the log's header (scenario identity etc.).
    """
    # span-log ownership: the outermost layer with a trace_dir creates,
    # activates and saves one; under a caller's active log (run_scenario,
    # the scenarios CLI) our spans land there and the caller saves
    tag = getattr(algo, "name", None) or "run"
    with owned_log(trace_dir, {"kind": "experiment", "algo": tag}, tag):
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        check_participation(algo, team_frac, device_frac)
        cohort = check_cohort(cohort, n)
        if cohort_indices is not None and cohort is None:
            raise ValueError("cohort_indices= needs cohort=")
        if links is not None and system is None:
            raise ValueError("links= needs system=")
        if trace is True:
            trace = TraceConfig()
        with span("build", algo=getattr(algo, "name", "?"), m=m, n=n,
                  rounds=rounds):
            dev = resolve_device(device)
            params0 = params_from_numpy(params0, dev)
            train, val = _to_device(train_data, dev), _to_device(val_data, dev)

            width = n if cohort is None else cohort
            src = mask_source(m, width, team_frac=team_frac,
                              device_frac=device_frac, seed=seed, masks=masks)
            res = FLResult(rounds=rounds, eval_every=eval_every,
                           device=str(dev), cohort=cohort,
                           population=None if cohort is None else n)
            sysrun = spec = None
            if system is not None:
                spec = get_profile(system)
                res.timeline = Timeline(profile=spec.name)
                leaves = spec_leaves(spec, dev)
                sysrun = RoundSystem(leaves, workload_for(algo, params0),
                                     link_source(leaves, m, width, seed=seed,
                                                 device=dev, links=links))
            draw_cohort = None if cohort is None else cohort_source(
                m, n, cohort, seed=seed, device=dev,
                cohort_indices=cohort_indices)
            state0 = algo.init_state(params0, m, n)
        fail_ctx = (event_meta or {}).get("scenario") or tag
        with profile_ctx(trace):
            state, seconds = drive(
                algo, state0, train, val, metric_fn=metric_fn, rounds=rounds,
                eval_every=eval_every, draw_masks=lambda t: [src(t)],
                results=[res], stacked=False, device=dev,
                round_kw={} if uniforms is None else {"uniforms": uniforms},
                m=m, n=n, draw_cohort=draw_cohort, system=sysrun,
                parts=res.part_seconds if time_parts else None, trace=trace,
                contexts=[fail_ctx])
        finish_times(res, seconds)
        res.state = state
        if res.timeline is not None:
            assemble_timeline(res)
        bill_comm(algo, params0, res)
        if trace_dir is not None:
            # "scan": False -- the port's loop is the reference's per-round
            # dispatch path, and its log says so in the reference's terms
            res.events_path = str(write_run(
                trace_dir, res, algo=algo,
                meta={"m": m, "n": n, "seed": seed, "team_frac": team_frac,
                      "device_frac": device_frac, "scan": False,
                      "system": spec.name if spec is not None else None,
                      **({"cohort": cohort} if cohort is not None else {}),
                      **(event_meta or {})}))
        return res

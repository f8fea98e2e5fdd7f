"""CLI for the port's scenario registry.

    PYTHONPATH=src python -m repro_torch.scenarios list [--family F]
    PYTHONPATH=src python -m repro_torch.scenarios describe NAME
    PYTHONPATH=src python -m repro_torch.scenarios dump NAME
    PYTHONPATH=src python -m repro_torch.scenarios profiles
    PYTHONPATH=src python -m repro_torch.scenarios run NAME [--rounds R]
        [--eval-every E] [--seed S] [--system PROFILE]
        [--deadline SECONDS] [--smoke] [--cohort C] [--trace-dir DIR]
        [--profile-dir DIR] [--fail-fast] [--hparam NAME=VALUE]
        [--device cuda|cpu] [--json]
    PYTHONPATH=src python -m repro_torch.scenarios serve NAME [--rounds R]
        [--seed S] [--smoke] [--encoding delta|int8|raw] [--store PATH]
        [--requests Q] [--batch B] [--alpha A] [--unknown-frac F]
        [--cached] [--trace-dir DIR] [--device cuda|cpu] [--json]

``list`` prints one line per registered scenario (name, topology,
partitioner, model, algorithm, default rounds, spec hash -- the same
hash as the reference's); ``describe`` shows one scenario's full spec,
its paper references and a reproduce line; ``dump`` prints the spec as
JSON (``FLScenario.from_dict`` reads it back, in either package);
``profiles`` lists the wall-clock system profiles (``repro_torch.system``).
``run`` trains it through the engine on the card (``--device cpu`` for
the CPU) and prints the final value of each metric the algorithm
reports (PerMFL: pm, tm, gm and train_loss; FedAvg and h-SGD: gm; the
personalized baselines: pm and gm), for a compressed scenario the
megabytes its links carried, and with a system model its simulated
seconds; ``--json`` prints instead, as one JSON object on stdout, the
reference's ``run_footer`` event of ``repro_torch.obs.events.run_events``
(the metrics under ``final``; ``seconds``, ``compile_seconds``,
``run_seconds``, ``dispatches``; ``comm``, ``timeline``, ``probes``,
``cost`` and ``health`` where the run has them) with ``scenario``,
``spec_hash``, ``events_path`` when traced, and ``device``. The rounds,
cohort and population are in the event log's header (``--trace-dir``).
``--system PROFILE`` prices the run on that profile, ``--deadline
SECONDS`` drops the stragglers of each round (it needs a system model:
``--system``, or a spec that carries one), ``--cohort C`` runs C devices
per team a round through the cohort engine (0: the stacked path). ``--hparam NAME=VALUE`` (repeatable) overrides one of
the algorithm's float hyperparameters, parsed as a float as the
reference parses it (an integer loop bound is refused). ``serve``
closes the train -> deploy -> measure loop: it trains the scenario,
exports the personalized (team, device) ``ModelStore`` (``--encoding``
picks the device-tier encoding; ``--store PATH`` saves it and reloads it
from disk), then replays Zipf-popularity traffic through the
tier-fallback batched server (``--cached``: through the LRU) and prints
the latency percentiles and queries per second. ``--smoke`` shrinks the
scenario to 2 teams x 3 devices x 16 samples for 2 rounds.

Run telemetry (``repro_torch.obs``): ``run --trace-dir DIR`` turns on
the probes and health monitors and writes the JSONL event log and a
Chrome-trace span file there (read them back with ``python -m
repro_torch.obs report DIR``); ``--profile-dir DIR`` also runs the
rounds under ``torch.profiler`` and exports its Chrome trace there;
``--fail-fast`` stops at the first unhealthy round with exit code 3,
naming the round. ``serve --trace-dir DIR`` records one span log over
train -> export -> replay, the training events, and the serving metrics
as ``metrics-serve.jsonl`` and Prometheus text ``metrics-serve.prom``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# the --smoke topology and rounds
_SMOKE = dict(m_teams=2, n_devices=3, samples_per_device=16, rounds=2)


def _cmd_list(args) -> int:
    from repro_torch.scenarios import SCENARIOS, families

    rows = [s for s in SCENARIOS.values()
            if not args.family or s.family == args.family]
    if not rows:
        print(f"no scenarios in family {args.family!r}; "
              f"families: {families()}")
        return 1
    print(f"{'name':44} {'M x N':7} {'partition':10} {'model':5} "
          f"{'algo':9} {'rounds':6} hash")
    for s in rows:
        d = s.data
        print(f"{s.name:44} {d.m_teams}x{d.n_devices:<5} "
              f"{d.partitioner:10} {s.model.kind:5} {s.algo.name:9} "
              f"{s.rounds:<6} {s.spec_hash()}")
    print(f"\n{len(rows)} scenario(s)"
          + ("" if args.family else f" in {len(families())} families"))
    return 0


def _cmd_describe(args) -> int:
    from repro_torch.scenarios import get_scenario

    s = get_scenario(args.name)
    print(f"{s.name}  [{s.family}]  hash={s.spec_hash()}")
    if s.notes:
        print(f"  {s.notes}")
    print(f"  data:  {s.data}")
    print(f"  model: {s.model.kind} -> {s.model_config().name}")
    print(f"  algo:  {s.algo.name} "
          f"{dict(s.algo.overrides) or '(paper defaults)'}")
    print(f"  rounds={s.rounds} team_frac={s.team_frac} "
          f"device_frac={s.device_frac} data_seed={s.data_seed}")
    if s.cohort_size is not None:
        print(f"  cohort: {s.cohort_size} of {s.data.n_devices} devices "
              "materialized per team per round")
    if s.comm is not None:
        print(f"  comm:  {s.comm}")
    if s.system is not None:
        print(f"  system: {s.system}")
    for metric, acc in s.paper_ref:
        print(f"  paper: {metric} = {acc}%")
    print(f"\n  reproduce: PYTHONPATH=src python -m repro_torch.scenarios "
          f"run {s.name}")
    return 0


def _cmd_dump(args) -> int:
    from repro_torch.scenarios import get_scenario

    print(json.dumps(get_scenario(args.name).to_dict(), indent=2))
    return 0


def _cmd_profiles(args) -> int:
    from repro_torch.system import SYSTEM_PROFILES

    print(f"{'profile':14} {'compute':16} {'LAN':22} {'WAN':22}")
    for name, p in SYSTEM_PROFILES.items():
        print(f"{name:14} "
              f"{p.compute_gflops:g}GF/s s={p.compute_sigma:g}   "
              f"{p.lan_mbps:g}Mbps {p.lan_latency_ms:g}ms "
              f"s={p.lan_sigma:<5g} "
              f"{p.wan_mbps:g}Mbps {p.wan_latency_ms:g}ms "
              f"s={p.wan_sigma:g}")
    print("\nattach one with: run NAME --system PROFILE "
          "[--deadline SECONDS]")
    return 0


def _with_hparams(s, items):
    """``s`` with each ``NAME=VALUE`` of ``items`` as an algorithm
    override, the value parsed as a float; (scenario, None) or (None,
    error message)."""
    from repro_torch.scenarios.spec import AlgoSpec

    overrides = dict(s.algo.overrides)
    for item in items:
        name, sep, val = item.partition("=")
        if not sep:
            return None, f"--hparam wants NAME=VALUE, got {item!r}"
        try:
            overrides[name] = float(val)
        except ValueError:
            return None, f"--hparam value {val!r} is not a number"
        default = s.algo.resolved().get(name)
        if isinstance(default, int) and not isinstance(default, bool):
            return None, (f"--hparam {name} is a loop bound ({default}), "
                          "not a float hyperparameter")
    try:
        algo = AlgoSpec(s.algo.name, tuple(overrides.items()))
    except ValueError as e:
        return None, str(e)
    return dataclasses.replace(s, algo=algo), None


def _cmd_run(args) -> int:
    from repro_torch.obs import HealthError, TraceConfig
    from repro_torch.scenarios import get_scenario, run_scenario

    s = get_scenario(args.name)
    if args.smoke:
        s = s.scaled(**_SMOKE)
    if args.cohort is not None:
        s = dataclasses.replace(s, cohort_size=args.cohort or None)
    if args.system:
        s = s.with_system(args.system)
    if args.deadline:
        if s.system is None:
            print("error: --deadline needs a system model (pass --system "
                  "PROFILE, or run a scenario whose spec carries one)")
            return 2
        s = s.with_system(s.system.with_deadline(args.deadline))
    if args.hparam:
        s, err = _with_hparams(s, args.hparam)
        if err:
            print(f"error: {err}")
            return 2
    rounds = args.rounds or s.rounds
    trace = None
    if args.trace_dir or args.profile_dir or args.fail_fast:
        # cost_analysis rides trace_dir, so the saved compile span carries
        # the first round's FLOP count next to its measured time
        trace = TraceConfig(cost_analysis=bool(args.trace_dir),
                            profile_dir=args.profile_dir,
                            fail_fast=args.fail_fast)
    try:
        res = run_scenario(s, rounds=rounds, seed=args.seed,
                           eval_every=args.eval_every, trace=trace,
                           trace_dir=args.trace_dir, device=args.device)
    except HealthError as e:
        print(f"error: {e}")
        return 3
    if args.json:
        from repro_torch.obs.events import run_events

        # the reference's footer (obs.events.run_events) and its keys, plus
        # the device the run took, as serve --json prints it
        footer = run_events(
            res, algo=None,
            meta={"scenario": s.name, "spec_hash": s.spec_hash()})[-1]
        footer["scenario"] = s.name
        footer["spec_hash"] = s.spec_hash()
        footer["device"] = res.device
        if res.events_path:
            footer["events_path"] = res.events_path
        print(json.dumps(footer, sort_keys=True))
        return 0
    # only the metrics the algorithm reported (the baselines report no
    # team model and no train loss)
    hists = {"pm": res.pm_acc, "tm": res.tm_acc, "gm": res.gm_acc,
             "train_loss": res.train_loss}
    finals = {m: hist[-1] for m, hist in hists.items() if hist}
    print(f"{s.name}: rounds={rounds} "
          + " ".join(f"{m}={v:.4f}" for m, v in finals.items())
          + f" ({res.seconds:.1f}s on {res.device})")
    if res.comm is not None:
        t = res.comm.totals()
        print(f"  comm: {t.total / 1e6:.2f} MB total "
              f"(wan_up {t.wan_up / 1e6:.2f} MB, "
              f"lan_up {t.lan_up / 1e6:.2f} MB)")
    if res.timeline is not None:
        tl = res.timeline.summary()
        print(f"  system[{tl['profile']}]: {tl['sim_seconds']:.2f} "
              f"simulated s over {tl['rounds']} rounds "
              f"(mean {tl['mean_round_seconds']:.3f}s/round, "
              f"{tl['dropped_devices']} device straggler drops)")
    if res.cohort is not None:
        print(f"  cohort: {res.cohort} of {res.population} devices per "
              "team a round")
    if res.health is not None:
        h = res.health.summary()
        print("  health: ok" if h["ok"] else
              f"  health: FAILED at round {h['first_bad_round']}")
    if res.events_path:
        print(f"  events: {res.events_path} "
              f"(python -m repro_torch.obs report {args.trace_dir})")
    for metric, acc in s.paper_ref:
        print(f"  paper {metric}: {acc}% (A100, full rounds)")
    return 0


def _cmd_serve(args) -> int:
    import contextlib

    from repro_torch.models import paper_models as pm
    from repro_torch.obs import MetricsRegistry, SpanLog
    from repro_torch.scenarios import (build_scenario, get_scenario,
                                       run_scenario)
    from repro_torch.serve import (ModelStore, PersonalizedServer,
                                   replay_traffic)

    s = get_scenario(args.name)
    if args.smoke:
        s = s.scaled(**_SMOKE)
    # with --trace-dir the CLI owns one span log over train -> export ->
    # replay, so training and serving spans land in a single trace
    log = metrics = None
    if args.trace_dir:
        log = SpanLog(meta={"kind": "serve", "scenario": s.name})
        metrics = MetricsRegistry()
    with log.activate() if log is not None else contextlib.nullcontext():
        res = run_scenario(s, rounds=args.rounds, seed=args.seed,
                           trace=True if args.trace_dir else None,
                           trace_dir=args.trace_dir, device=args.device)
        b = build_scenario(s, seed=args.seed, device=args.device)
        store = ModelStore.from_result(b.algo, res, m=b.m, n=b.n,
                                       encoding=args.encoding)
        if args.store:
            store.save(args.store)
            store = ModelStore.load(args.store, device=args.device)
            print(f"# store: {args.store} ({store.encoding}, "
                  f"{store.m}x{store.n}, device tier "
                  f"{store.device_tier_nbytes() / 1e6:.2f} MB)")
        cfg = b.config
        xv = b.val["x"]
        pool = xv.reshape((-1,) + tuple(xv.shape[3:]))
        server = PersonalizedServer(
            store, lambda p, x: pm.apply(p, cfg, x[:, None])[:, 0])
        stats = replay_traffic(server, pool, requests=args.requests,
                               batch=args.batch, alpha=args.alpha,
                               unknown_frac=args.unknown_frac,
                               seed=args.seed, cached=args.cached,
                               metrics=metrics)
    stats["scenario"] = s.name
    if args.trace_dir:
        log.save(args.trace_dir, tag=f"serve-{s.name}")
        metrics.write_jsonl(f"{args.trace_dir}/metrics-serve.jsonl")
        metrics.write_prom(f"{args.trace_dir}/metrics-serve.prom")
    if args.json:
        print(json.dumps({k: v for k, v in stats.items() if k != "lat_ms"},
                         sort_keys=True))
        return 0
    print(f"{s.name}: served {stats['requests']} requests "
          f"(batch {stats['batch']}, Zipf a={stats['alpha']:g}, "
          f"{stats['unknown_frac']:.0%} unknown, "
          f"encoding={stats['encoding']}"
          + (", cached" if stats["cached"] else "")
          + f") on {stats['device']}")
    print(f"  qps={stats['qps']:.1f} p50={stats['p50_ms']:.3f}ms "
          f"p95={stats['p95_ms']:.3f}ms p99={stats['p99_ms']:.3f}ms "
          f"mean={stats['mean_ms']:.3f}ms")
    tiers = stats["tier_counts"]
    print(f"  tiers: device={tiers['device']} team={tiers['team']} "
          f"global={tiers['global']}"
          + (f"  cache_hit_rate={stats['cache_hit_rate']:.2%}"
             if "cache_hit_rate" in stats else ""))
    print(f"  stages: gather {stats['stage_gather_ms']:.3f}ms, forward "
          f"{stats['stage_forward_ms']:.3f}ms")
    print(f"  device tier: {stats['device_tier_bytes'] / 1e6:.2f} MB "
          f"({stats['m']}x{stats['n']} devices)")
    if args.trace_dir:
        print(f"  telemetry: {args.trace_dir} "
              f"(python -m repro_torch.obs report {args.trace_dir})")
    return 0


def main(argv=None) -> int:
    """Entry point: dispatch list / describe / dump / profiles / run /
    serve."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="Browse and run the port's scenario registry.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="list registered scenarios")
    p.add_argument("--family", default=None)
    p.set_defaults(fn=_cmd_list)
    p = sub.add_parser("describe", help="show one scenario's full spec")
    p.add_argument("name")
    p.set_defaults(fn=_cmd_describe)
    p = sub.add_parser("dump", help="print one scenario as JSON")
    p.add_argument("name")
    p.set_defaults(fn=_cmd_dump)
    p = sub.add_parser("profiles", help="list wall-clock system profiles")
    p.set_defaults(fn=_cmd_profiles)
    p = sub.add_parser("run", help="run a scenario through the engine")
    p.add_argument("name")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--system", default=None,
                   help="wall-clock profile (see `profiles`)")
    p.add_argument("--deadline", type=float, default=None,
                   help="per-round straggler deadline, simulated seconds")
    p.add_argument("--smoke", action="store_true",
                   help="2x3x16 topology, 2 rounds")
    p.add_argument("--cohort", type=int, default=None,
                   help="override cohort_size (devices materialized per "
                        "team per round); 0 runs the stacked path")
    p.add_argument("--trace-dir", default=None,
                   help="turn on probes + health monitors and write the "
                        "JSONL event log + Chrome-trace spans here")
    p.add_argument("--profile-dir", default=None,
                   help="run the rounds under torch.profiler and export "
                        "its Chrome trace here")
    p.add_argument("--fail-fast", action="store_true",
                   help="stop at the first unhealthy round (nonfinite "
                        "state / exploded loss); exit code 3")
    p.add_argument("--hparam", action="append", default=None,
                   metavar="NAME=VALUE",
                   help="override one float hyperparameter (repeatable)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--json", action="store_true",
                   help="print the final metrics as JSON on stdout")
    p.set_defaults(fn=_cmd_run)
    p = sub.add_parser(
        "serve", help="train -> export personalized store -> replay "
                      "Zipf traffic")
    p.add_argument("name")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="2x3x16 topology, 2 rounds")
    p.add_argument("--encoding", default="delta",
                   choices=("delta", "int8", "raw"),
                   help="device-tier encoding (delta = exact bit-pattern "
                        "residual, int8 = quantized residual)")
    p.add_argument("--store", default=None,
                   help="save the exported store here and reload it from "
                        "disk before serving")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--alpha", type=float, default=1.2,
                   help="Zipf popularity exponent (>1)")
    p.add_argument("--unknown-frac", type=float, default=0.0,
                   help="fraction of requests tagged with unknown "
                        "principals (exercises tier fallback)")
    p.add_argument("--cached", action="store_true",
                   help="serve through the LRU unique-principal path")
    p.add_argument("--trace-dir", default=None,
                   help="write spans + serving metrics (JSONL and "
                        "Prometheus text) + training events here")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--json", action="store_true",
                   help="print the replay stats as JSON on stdout")
    p.set_defaults(fn=_cmd_serve)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

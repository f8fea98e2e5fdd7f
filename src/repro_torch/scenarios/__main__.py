"""CLI for the port's scenario registry.

    PYTHONPATH=src python -m repro_torch.scenarios list [--family F]
    PYTHONPATH=src python -m repro_torch.scenarios run NAME [--rounds R]
        [--eval-every E] [--seed S] [--device cuda|cpu] [--json]

``list`` prints one line per registered scenario (name, topology,
partitioner, model, algorithm, default rounds, spec hash -- the same
hash as the reference's). ``run`` trains it through the engine on the
card (``--device cpu`` for the CPU) and prints the final metrics, and
for a compressed scenario the megabytes its links carried; ``--json``
prints them as one JSON object on stdout instead.
"""
from __future__ import annotations

import argparse
import json
import sys


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
    print(f"\n{len(rows)} scenario(s)")
    return 0


def _cmd_run(args) -> int:
    from repro_torch.scenarios import get_scenario, run_scenario

    s = get_scenario(args.name)
    rounds = args.rounds or s.rounds
    res = run_scenario(s, rounds=rounds, seed=args.seed,
                       eval_every=args.eval_every, device=args.device)
    finals = {m: getattr(res, f"{m}_acc")[-1] for m in ("pm", "tm", "gm")}
    if args.json:
        rec = {"scenario": s.name, "spec_hash": s.spec_hash(),
               "rounds": rounds, "device": res.device, **finals,
               "train_loss": res.train_loss[-1], "seconds": res.seconds,
               "participation": res.participation[-1]}
        if res.comm is not None:
            rec["comm"] = res.comm.summary()
        print(json.dumps(rec, sort_keys=True))
        return 0
    print(f"{s.name}: rounds={rounds} "
          + " ".join(f"{m}={v:.4f}" for m, v in finals.items())
          + f" train_loss={res.train_loss[-1]:.4f} ({res.seconds:.1f}s on "
          f"{res.device})")
    if res.comm is not None:
        t = res.comm.totals()
        print(f"  comm: {t.total / 1e6:.2f} MB total "
              f"(wan_up {t.wan_up / 1e6:.2f} MB, "
              f"lan_up {t.lan_up / 1e6:.2f} MB)")
    for metric, acc in s.paper_ref:
        print(f"  paper {metric}: {acc}% (A100, full rounds)")
    return 0


def main(argv=None) -> int:
    """Entry point: dispatch list / run."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="Browse and run the port's scenario registry.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="list registered scenarios")
    p.add_argument("--family", default=None)
    p.set_defaults(fn=_cmd_list)
    p = sub.add_parser("run", help="run a scenario through the engine")
    p.add_argument("name")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--json", action="store_true",
                   help="print the final metrics as JSON on stdout")
    p.set_defaults(fn=_cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""CLI for the run-telemetry layer.

    PYTHONPATH=src python -m repro_torch.obs summarize PATH [PATH2]
    PYTHONPATH=src python -m repro_torch.obs report DIR

``summarize PATH`` reads a JSONL trace (one file, or every ``*.jsonl``
in a directory) and renders each run: header identity, the eval-point
table joining metrics x bytes x simulated seconds x probe summaries, and
the footer cost split — plus, when the directory holds span trace
files, the wall-clock span breakdown. With two paths it also diffs the
final runs of each (metric deltas, wall/bytes deltas). ``report DIR``
renders the full joined picture — events × spans × metrics × health
(see `repro_torch.obs.report`).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.obs import events as E
from repro_torch.obs import report as REP


def _fmt_run(run: list) -> None:
    s = E.summarize_run(run)
    who = s["run"]
    if s.get("scenario"):
        who += f"  [{s['scenario']} @{s.get('spec_hash')}]"
    print(f"run {who}  algo={s.get('algo')}  rounds={s.get('rounds')}  "
          f"evals={s['evals']}")
    evals = [e for e in run if e.get("event") == "eval"]
    if evals:
        probe_names = sorted(evals[-1].get("probes", {}))[:3]
        head = f"  {'round':>6} " + "".join(
            f"{m:>11}" for m in sorted(evals[-1].get("metrics", {})))
        head += f" {'MB':>9} {'sim_s':>9}"
        head += "".join(f" {p[:14]:>15}" for p in probe_names)
        print(head)
        for e in evals:
            row = f"  {e['round']:>6} " + "".join(
                f"{v:>11.4f}" for _, v in sorted(e["metrics"].items()))
            row += (f" {e['cum_bytes'] / 1e6:>9.2f}"
                    if "cum_bytes" in e else f" {'-':>9}")
            row += (f" {e['sim_seconds']:>9.2f}"
                    if "sim_seconds" in e else f" {'-':>9}")
            for p in probe_names:
                v = e.get("probes", {}).get(p)
                row += (f" {v:>15.4e}" if v is not None else f" {'-':>15}")
            print(row)
    cost = f", {s['cost'].get('flops', 0):.3g} flops/dispatch" \
        if s.get("cost") else ""
    print(f"  footer: {s.get('seconds', 0):.2f}s "
          f"(compile {s.get('compile_seconds', 0):.2f}s), "
          f"{s.get('dispatches')} dispatch(es){cost}")


def _print_spans(path) -> None:
    p = pathlib.Path(path)
    if not p.is_dir():
        return
    traces = []
    for f in sorted(p.glob("spans-*.trace.json")):
        try:
            traces.append(json.loads(f.read_text()))
        except (json.JSONDecodeError, OSError):
            continue
    lines = REP.format_spans(traces)
    if lines:
        print(f"spans ({len(traces)} trace file(s)):")
        for line in lines:
            print(line)


def _cmd_summarize(args) -> int:
    records = E.read_jsonl(args.path)
    runs = E.split_runs([r for r in records if "event" in r])
    if not runs:
        print(f"no run events under {args.path}")
        return 1
    for run in runs:
        _fmt_run(run)
    _print_spans(args.path)
    if args.path2:
        other = E.split_runs([r for r in E.read_jsonl(args.path2)
                              if "event" in r])
        if not other:
            print(f"no run events under {args.path2}")
            return 1
        a = E.summarize_run(runs[-1])
        b = E.summarize_run(other[-1])
        print(f"\ndiff {a['run']} -> {b['run']} (b - a):")
        delta = E.diff_summaries(a, b)
        if not delta:
            print("  no shared numeric fields")
        for k, v in sorted(delta.items()):
            print(f"  {k:>24}: {v:+.6g}")
    return 0


def _cmd_report(args) -> int:
    print(REP.report_text(args.path), end="")
    art = REP.load_artifacts(args.path)
    if not (art["runs"] or art["spans"] or art["metrics"]):
        print(f"no observability artifacts under {args.path}")
        return 1
    return 0


def main(argv=None) -> int:
    """Entry point: dispatch summarize / report."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Read and render run-telemetry artifacts.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize",
                       help="render a JSONL run trace (or diff two)")
    p.add_argument("path", help="trace file or directory")
    p.add_argument("path2", nargs="?", default=None,
                   help="second trace to diff against")
    p.set_defaults(fn=_cmd_summarize)
    p = sub.add_parser("report",
                       help="joined events x spans x metrics x health")
    p.add_argument("path", help="trace directory")
    p.set_defaults(fn=_cmd_report)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Perf-regression gate over ``BENCH_*.json`` markers (the reference's
marker format; the port writes no marker of its own yet).

CI used to only *upload* the benchmark marker; this comparator makes it a
gate: load the committed baseline and the freshly produced marker,
extract every throughput metric present in both (engine rounds/sec per
execution model, sweep configs/sec, probes-on rounds/sec, comm-round
rounds/sec fused and unfused, cohort-engine rounds/sec per population
size, per-compressor kernel rates (``xla_meps``) from
``BENCH_kernels.json``, and the personalized-serving qps /
inverted-latency rates from ``BENCH_serving.json``), and fail when
any current rate falls more than ``tol`` below its baseline:

    python -m repro_torch.obs.regress benchmarks/baselines/BENCH_engine.json \
        BENCH_engine.json --tol 0.2
    python -m repro_torch.obs.regress benchmarks/baselines/BENCH_kernels.json \
        BENCH_kernels.json --tol 0.5
    python -m repro_torch.obs.regress benchmarks/baselines/BENCH_serving.json \
        BENCH_serving.json --tol 0.5

Rate shapes are normalized across bench modes: smoke mode reports single
scalars (the scanned/vmapped paths only), quick/full mode per-model
dicts — a scalar compares against the dict's matching entry, so a smoke
run in CI can gate against any committed baseline. Improvements always
pass; a missing baseline warns and passes (first run bootstraps it).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

__all__ = ["compare", "load_rates", "main"]

# default tolerance band: fail on >20% throughput regression (ROADMAP)
DEFAULT_TOL = 0.2


def load_rates(payload: dict) -> dict:
    """Flatten one marker's gateable throughput metrics to
    ``{dotted.path: rate}``. Scalars are normalized to the execution
    model they measure (smoke's engine scalar is the scanned path, its
    sweep scalar the vmapped path)."""
    out = {}

    def rate_group(group: str, value, scalar_key: str):
        if isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, (int, float)):
                    out[f"{group}.{k}"] = float(v)
        elif isinstance(value, (int, float)):
            out[f"{group}.{scalar_key}"] = float(value)

    rate_group("engine.rounds_per_sec",
               payload.get("engine", {}).get("rounds_per_sec"), "scan")
    rate_group("sweep.configs_per_sec",
               payload.get("sweep", {}).get("configs_per_sec"), "sweep")
    rate_group("obs.rounds_per_sec",
               payload.get("obs", {}).get("rounds_per_sec_probes"),
               "probes")
    # cohort section: gate the absolute per-N rounds/sec rates (the
    # N-scaling *ratio* is asserted inside bench_engine itself — a ratio
    # is not a throughput, so gating it here would invert the direction)
    rate_group("cohort.rounds_per_sec",
               payload.get("cohort", {}).get("rounds_per_sec"), "cohort")

    # BENCH_serving section: every entry is a higher-is-better rate by
    # construction (qps, inverted-latency rates, the LRU hit rate, and
    # the per-tier resolution rates; raw ms latencies and counts live in
    # the ungated serving_detail section), so the generic flatten is the
    # whole gate — serving.cache_hit_rate / serving.tier_*_rate gate a
    # broken cache or fallback ladder, not just throughput
    rate_group("serving", payload.get("serving"), "qps")

    # BENCH_engine comm section: fused/unfused compressed-round rates
    comm = payload.get("comm")
    if isinstance(comm, dict):
        for k in ("rounds_per_sec_fused", "rounds_per_sec_unfused"):
            if isinstance(comm.get(k), (int, float)):
                out[f"comm.{k}"] = float(comm[k])

    # BENCH_kernels compress section: gate the XLA rate per compressor
    # (the pallas column is interpret-mode on CPU — a correctness probe
    # whose wall-time is meaningless, so it is reported but never gated)
    compress = payload.get("compress")
    if isinstance(compress, dict):
        for name, entry in compress.items():
            if isinstance(entry, dict) and \
                    isinstance(entry.get("xla_meps"), (int, float)):
                out[f"compress.{name}.xla_meps"] = float(entry["xla_meps"])
    return out


def compare(baseline: dict, current: dict, tol: float = DEFAULT_TOL):
    """Compare two marker payloads; returns ``(failures, report)`` line
    lists. A metric fails when ``current < baseline * (1 - tol)``; metrics
    present in only one payload are reported but never gate."""
    base, cur = load_rates(baseline), load_rates(current)
    failures, report = [], []
    for k in sorted(set(base) | set(cur)):
        if k not in base or k not in cur:
            where = "current" if k in cur else "baseline"
            report.append(f"  {k}: only in {where} — skipped")
            continue
        floor = base[k] * (1.0 - tol)
        ratio = cur[k] / base[k] if base[k] else float("inf")
        line = (f"  {k}: baseline {base[k]:.2f} -> current {cur[k]:.2f} "
                f"({ratio:.2f}x, floor {floor:.2f})")
        if cur[k] < floor:
            failures.append(f"REGRESSION {k}: {cur[k]:.2f} < "
                            f"{floor:.2f} (baseline {base[k]:.2f}, "
                            f"tol {tol:.0%})")
            line += "  FAIL"
        report.append(line)
    if not (set(base) & set(cur)):
        report.append("  (no shared throughput metrics — nothing gated)")
    return failures, report


def main(argv=None) -> int:
    """CLI: compare a committed baseline marker against a fresh one."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Gate BENCH_engine.json against a committed baseline.")
    ap.add_argument("baseline", help="committed baseline marker (JSON)")
    ap.add_argument("current", help="freshly produced marker (JSON)")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="allowed fractional regression (default 0.2)")
    args = ap.parse_args(argv)

    base_path = pathlib.Path(args.baseline)
    if not base_path.exists():
        print(f"regress: no baseline at {base_path} — nothing to gate "
              "(commit the current marker to bootstrap)")
        return 0
    baseline = json.loads(base_path.read_text())
    current = json.loads(pathlib.Path(args.current).read_text())

    failures, report = compare(baseline, current, tol=args.tol)
    print(f"regress: {args.current} vs {args.baseline} "
          f"(tol {args.tol:.0%}, baseline mode "
          f"{baseline.get('mode')!r}, current mode {current.get('mode')!r})")
    for line in report:
        print(line)
    for f in failures:
        print(f)
    print(f"regress: {'FAIL' if failures else 'OK'} "
          f"({len(failures)} regression(s))")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

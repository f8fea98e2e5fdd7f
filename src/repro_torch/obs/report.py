"""Joined run report: events × spans × metrics × health from one dir.

A traced run leaves up to four artifact kinds in its ``--trace-dir``:
the JSONL run-event stream (`repro_torch.obs.events`), Chrome-trace span files
(`repro_torch.obs.spans`, ``spans-*.trace.json``), metrics snapshots
(`repro_torch.obs.metrics`, ``metrics-*.jsonl``), and the health section each
run footer now carries. ``python -m repro_torch.obs report DIR`` — backed by
:func:`report_text` here — renders them as one document: per-run eval
tables and health verdicts, the wall-clock span breakdown (with the
compile span's cost-analysis attrs), and the metrics table.

Loading is forgiving by design: any subset of the four may be present
(a pure-serving dir has spans + metrics but no run events), and the
report says what it found rather than failing on what it didn't.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

__all__ = ["load_artifacts", "report_text"]


def load_artifacts(trace_dir) -> dict:
    """Collect everything observability wrote under ``trace_dir``:
    ``{"runs": [per-run event lists], "spans": [chrome-trace dicts],
    "metrics": [snapshot records], "health": {run_id: summary}}``.
    Metrics records (``metric`` key, no ``event`` key) may share a
    directory — or even a file — with run events; they are partitioned
    by shape, not filename."""
    from repro_torch.obs import events as E
    d = pathlib.Path(trace_dir)
    records = E.read_jsonl(d) if d.exists() else []
    ev = [r for r in records if "event" in r]
    metrics = [r for r in records if "metric" in r and "event" not in r]
    runs = E.split_runs(ev)
    spans = []
    if d.is_dir():
        for f in sorted(d.glob("spans-*.trace.json")):
            try:
                spans.append(json.loads(f.read_text()))
            except (json.JSONDecodeError, OSError):
                continue
    health = {}
    for run in runs:
        footer = next((e for e in run if e.get("event") == "run_footer"),
                      {})
        if "health" in footer:
            health[footer.get("run", "?")] = footer["health"]
    return {"runs": runs, "spans": spans, "metrics": metrics,
            "health": health}


def _span_summary(trace: dict) -> dict:
    out: dict = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        agg = out.setdefault(ev["name"],
                             {"count": 0, "total_ms": 0.0, "args": {}})
        agg["count"] += 1
        agg["total_ms"] += float(ev.get("dur", 0.0)) / 1e3
        for k, v in (ev.get("args") or {}).items():
            agg["args"].setdefault(k, v)
    return out


def format_spans(spans: list) -> list:
    """Per-name span aggregate lines across all trace files — count,
    total/mean wall ms, plus any cost-analysis attrs the compile span
    carries."""
    merged: dict = {}
    for tr in spans:
        for name, agg in _span_summary(tr).items():
            m = merged.setdefault(name, {"count": 0, "total_ms": 0.0,
                                         "args": {}})
            m["count"] += agg["count"]
            m["total_ms"] += agg["total_ms"]
            for k, v in agg["args"].items():
                m["args"].setdefault(k, v)
    lines = []
    for name, m in sorted(merged.items(),
                          key=lambda kv: -kv[1]["total_ms"]):
        extra = "".join(
            f"  {k}={v:.3g}" if isinstance(v, float) else f"  {k}={v}"
            for k, v in sorted(m["args"].items())
            if k in ("flops", "bytes_accessed", "rounds", "chunks",
                     "requests", "batches", "hit"))
        lines.append(f"  {name:<18} x{m['count']:<4} "
                     f"{m['total_ms']:>10.2f} ms total  "
                     f"{m['total_ms'] / m['count']:>9.3f} ms mean{extra}")
    return lines


def _fmt_metric(rec: dict) -> str:
    lbl = ",".join(f"{k}={v}" for k, v in
                   sorted((rec.get("labels") or {}).items()))
    who = rec["metric"] + (f"{{{lbl}}}" if lbl else "")
    if rec.get("type") == "histogram":
        return (f"  {who:<42} n={rec.get('count', 0):<6} "
                f"p50={rec.get('p50', float('nan')):.4g} "
                f"p95={rec.get('p95', float('nan')):.4g} "
                f"p99={rec.get('p99', float('nan')):.4g}")
    return f"  {who:<42} {rec.get('value', float('nan')):.6g}"


def report_text(trace_dir) -> str:
    """The joined report ``python -m repro_torch.obs report DIR`` prints."""
    from repro_torch.obs import events as E
    art = load_artifacts(trace_dir)
    lines = [f"obs report: {trace_dir}"]

    if art["runs"]:
        lines.append(f"\n== runs ({len(art['runs'])}) ==")
        for run in art["runs"]:
            s = E.summarize_run(run)
            who = s["run"]
            if s.get("scenario"):
                who += f"  [{s['scenario']}]"
            final = "  ".join(f"{k}={v:.4f}"
                              for k, v in sorted(s["final"].items()))
            lines.append(f"  {who}  algo={s.get('algo')} "
                         f"rounds={s.get('rounds')} evals={s['evals']}  "
                         f"{final}")
            h = art["health"].get(s["run"])
            if h is not None:
                if h.get("ok"):
                    lines.append(f"    health: ok "
                                 f"({len(h.get('series', {}))} detectors"
                                 f" clean)")
                else:
                    fired = ", ".join(
                        f"{k} x{v['fired_rounds']}"
                        for k, v in sorted(h.get("series", {}).items())
                        if v.get("fired_rounds"))
                    lines.append(f"    health: FAILED at round "
                                 f"{h.get('first_bad_round')} ({fired})")
    else:
        lines.append("\n== runs ==\n  (no run events)")

    lines.append(f"\n== spans ({len(art['spans'])} trace file(s)) ==")
    span_lines = format_spans(art["spans"])
    lines.extend(span_lines or ["  (no spans)"])

    lines.append(f"\n== metrics ({len(art['metrics'])}) ==")
    if art["metrics"]:
        lines.extend(_fmt_metric(r) for r in art["metrics"])
    else:
        lines.append("  (no metrics)")
    return "\n".join(lines) + "\n"

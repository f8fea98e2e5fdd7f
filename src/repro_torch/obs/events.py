"""Structured run events: one JSONL schema for every experiment, field
for field the reference's (``repro/obs/events.py``), so each package's
``summarize`` and ``report`` read the other's files.

Each run is a short stream of JSON objects, one per line:

  run_header   — identity + configuration: run id, algorithm name, the
                 sweepable hyperparameter leaves, dims/rounds/seed, and
                 any caller metadata (scenario name, ``spec_hash``, ...).
  eval         — one record per eval point, *joining* the quantities the
                 repo previously surfaced in separate objects: metrics
                 (pm/tm/gm/train_loss) x cumulative bytes (CommLedger) x
                 cumulative simulated seconds (Timeline) x probe-segment
                 summaries (RunTrace).
  run_footer   — outcome + cost: final metrics, wall-clock split
                 (compile/run seconds), dispatch count, byte and
                 timeline totals, probe summaries, the health-detector
                 verdict (``HealthReport.summary()``) when monitors ran,
                 and the first round's FLOP count when cost analysis
                 was on (``repro_torch.obs.profiling.compiled_cost``).

A sweep writes one file: a ``sweep_header`` followed by each
configuration's header/eval/footer section (run ids ``<base>/c<i>``).
Every record carries ``run`` and ``schema`` so files concatenate and
stream safely. ``python -m repro_torch.obs summarize`` renders or diffs them.

The writers take anything FLResult-shaped (duck-typed on the metric
histories and the ``comm``/``timeline``/``trace`` attachments) — this
module never imports the engine, the engine imports it.
"""
from __future__ import annotations

import json
import os
import pathlib
import uuid
from typing import Any, Optional

from repro_torch.obs.trace import eval_points

__all__ = ["diff_summaries", "new_run_id", "read_jsonl", "run_events",
           "split_runs", "summarize_run", "sweep_events", "write_jsonl",
           "write_run", "write_sweep"]

SCHEMA = 1

_METRICS = ("pm", "tm", "gm", "train_loss")
_HIST = {"pm": "pm_acc", "tm": "tm_acc", "gm": "gm_acc",
         "train_loss": "train_loss"}


def new_run_id(tag: str = "run") -> str:
    """Fresh run id ``<tag>-<8 hex>`` — public so callers that emit
    several artifacts for one run (events + spans + metrics) can mint
    the id once and thread it through."""
    return f"{tag}-{uuid.uuid4().hex[:8]}"


_new_run_id = new_run_id


def _metric_hists(res) -> dict:
    return {m: list(getattr(res, _HIST[m], []) or []) for m in _METRICS
            if getattr(res, _HIST[m], None)}


def run_events(res, *, run_id: Optional[str] = None, algo: Any = None,
               meta: Optional[dict] = None) -> list:
    """Build one run's event stream (header, evals, footer) from an
    FLResult-shaped object.

    res must carry ``rounds`` / ``eval_every`` (the engine sets them);
    algo, when given, contributes its name and hyperparameter leaves to
    the header; meta is merged into the header verbatim.
    """
    run_id = run_id or _new_run_id(getattr(algo, "name", None) or "run")
    hists = _metric_hists(res)
    rounds = int(getattr(res, "rounds", 0))
    eval_every = max(int(getattr(res, "eval_every", 1)), 1)
    points = eval_points(rounds, eval_every)

    header = {"event": "run_header", "schema": SCHEMA, "run": run_id,
              "algo": getattr(algo, "name", None),
              "hparams": (dict(algo.tree_hparams()[0])
                          if hasattr(algo, "tree_hparams") else {}),
              "rounds": rounds, "eval_every": eval_every}
    cohort = getattr(res, "cohort", None)
    if cohort is not None:
        header["cohort"] = int(cohort)
        header["population"] = int(getattr(res, "population", 0) or 0)
    header.update(meta or {})
    events = [header]

    comm = getattr(res, "comm", None)
    cum_bytes = comm.cum_total_bytes() if comm is not None else None
    sim = list(getattr(res, "sim_seconds", []) or [])
    trace = getattr(res, "trace", None)
    probe_segs = trace.at_points(points) if trace is not None else None
    cohort_idx = (list(getattr(res, "cohort_indices", []) or [])
                  if cohort is not None else None)

    prev_rnd = 0
    for i, rnd in enumerate(points):
        ev = {"event": "eval", "schema": SCHEMA, "run": run_id,
              "round": rnd,
              "metrics": {m: float(h[i]) for m, h in hists.items()
                          if i < len(h)}}
        if cum_bytes is not None and rnd - 1 < len(cum_bytes):
            ev["cum_bytes"] = int(cum_bytes[rnd - 1])
        if i < len(sim):
            ev["sim_seconds"] = float(sim[i])
        if probe_segs is not None:
            ev["probes"] = probe_segs[i]
        if cohort_idx:
            ev["cohort_indices"] = cohort_idx[prev_rnd:rnd]
        prev_rnd = rnd
        events.append(ev)

    footer = {"event": "run_footer", "schema": SCHEMA, "run": run_id,
              "final": {m: float(h[-1]) for m, h in hists.items() if h},
              "seconds": float(getattr(res, "seconds", 0.0)),
              "compile_seconds": float(getattr(res, "compile_seconds", 0.0)),
              "run_seconds": float(getattr(res, "run_seconds", 0.0)),
              "dispatches": int(getattr(res, "dispatches", 0))}
    if comm is not None:
        footer["comm"] = comm.summary()
    timeline = getattr(res, "timeline", None)
    if timeline is not None:
        footer["timeline"] = timeline.summary()
    if trace is not None:
        footer["probes"] = trace.summary()
        if trace.cost is not None:
            footer["cost"] = trace.cost
    health = getattr(res, "health", None)
    if health is not None:
        footer["health"] = health.summary()
    events.append(footer)
    return events


def sweep_events(sweep, *, run_id: Optional[str] = None, algo: Any = None,
                 meta: Optional[dict] = None) -> list:
    """Event stream for a whole FLSweepResult: a ``sweep_header`` then
    each configuration's run section (run ids ``<base>/c<i>``)."""
    run_id = run_id or _new_run_id("sweep")
    events = [{"event": "sweep_header", "schema": SCHEMA, "run": run_id,
               "configs": len(sweep.results),
               "dispatches": int(getattr(sweep, "dispatches", 0)),
               "seconds": float(getattr(sweep, "seconds", 0.0)),
               **(meta or {})}]
    for i, res in enumerate(sweep.results):
        cfg = sweep.configs[i] if i < len(sweep.configs) else {}
        events.extend(run_events(
            res, run_id=f"{run_id}/c{i}", algo=algo,
            meta={"config": {k: v for k, v in cfg.items()}}))
    return events


# ---------------------------------------------------------------------------
# file I/O
# ---------------------------------------------------------------------------

def write_jsonl(path, events) -> pathlib.Path:
    """Write one event per line; parent directories are created."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for ev in events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return path


def _unique_path(trace_dir, run_id: str) -> pathlib.Path:
    safe = run_id.replace("/", "_")
    return pathlib.Path(trace_dir) / f"{safe}-{os.getpid()}.jsonl"


def write_run(trace_dir, res, *, algo: Any = None,
              meta: Optional[dict] = None,
              run_id: Optional[str] = None) -> pathlib.Path:
    """Serialize one run's events into ``<trace_dir>/<run_id>.jsonl``."""
    run_id = run_id or _new_run_id(getattr(algo, "name", None) or "run")
    return write_jsonl(_unique_path(trace_dir, run_id),
                       run_events(res, run_id=run_id, algo=algo, meta=meta))


def write_sweep(trace_dir, sweep, *, algo: Any = None,
                meta: Optional[dict] = None,
                run_id: Optional[str] = None) -> pathlib.Path:
    """Serialize a sweep's events into one ``<trace_dir>/*.jsonl`` file."""
    run_id = run_id or _new_run_id("sweep")
    return write_jsonl(_unique_path(trace_dir, run_id),
                       sweep_events(sweep, run_id=run_id, algo=algo,
                                    meta=meta))


def read_jsonl(path) -> list:
    """Load events from a ``.jsonl`` file, or from every ``*.jsonl`` in a
    directory (sorted by name)."""
    p = pathlib.Path(path)
    files = sorted(p.glob("*.jsonl")) if p.is_dir() else [p]
    events = []
    for f in files:
        for line in f.read_text().splitlines():
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def split_runs(events) -> list:
    """Group a flat event stream into per-run lists (keyed on each
    record's ``run`` id; sweep headers form their own group)."""
    by_run, order = {}, []
    for ev in events:
        rid = ev.get("run", "?")
        if rid not in by_run:
            by_run[rid] = []
            order.append(rid)
        by_run[rid].append(ev)
    return [by_run[r] for r in order
            if any(e.get("event") != "sweep_header" for e in by_run[r])]


# ---------------------------------------------------------------------------
# summaries
# ---------------------------------------------------------------------------

def summarize_run(run: list) -> dict:
    """Flatten one run's events into the fields the CLI renders/diffs."""
    header = next((e for e in run if e.get("event") == "run_header"), {})
    footer = next((e for e in run if e.get("event") == "run_footer"), {})
    evals = [e for e in run if e.get("event") == "eval"]
    out = {"run": header.get("run", footer.get("run", "?")),
           "algo": header.get("algo"),
           "scenario": header.get("scenario"),
           "spec_hash": header.get("spec_hash"),
           "rounds": header.get("rounds"),
           "evals": len(evals),
           "final": footer.get("final", {}),
           "seconds": footer.get("seconds"),
           "compile_seconds": footer.get("compile_seconds"),
           "dispatches": footer.get("dispatches")}
    if evals:
        last = evals[-1]
        out["cum_bytes"] = last.get("cum_bytes")
        out["sim_seconds"] = last.get("sim_seconds")
    if "probes" in footer:
        out["probes"] = footer["probes"]
    if "cost" in footer:
        out["cost"] = footer["cost"]
    return out


def diff_summaries(a: dict, b: dict) -> dict:
    """Numeric deltas (b - a) for every shared metric/cost field of two
    run summaries — the two-run comparison the CLI prints."""
    out = {}
    for m, va in (a.get("final") or {}).items():
        vb = (b.get("final") or {}).get(m)
        if vb is not None:
            out[f"final.{m}"] = float(vb) - float(va)
    for k in ("seconds", "compile_seconds", "cum_bytes", "sim_seconds"):
        va, vb = a.get(k), b.get(k)
        if va is not None and vb is not None:
            out[k] = float(vb) - float(va)
    return out

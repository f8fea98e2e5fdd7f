"""Run telemetry of the port: probes, health, spans, events, metrics.

The reference's telemetry layer (``repro/obs``), module for module, on
the port's eager engine:

* probes -- a frozen `TraceConfig` selects scalar diagnostics (drift,
  gradient, residual and loss norms) that an algorithm's ``probe_round``
  computes after each round; the engine copies them to the host in the
  copy it makes each round anyway and assembles them into a `RunTrace`
  on ``FLResult.trace``. ``trace=None`` is the default and changes
  nothing.
* health monitors (`repro_torch.obs.health`) -- nonfinite and explosion
  detectors, assembled into a `HealthReport` on ``FLResult.health``,
  with opt-in fail-fast raising `HealthError` naming the first bad
  round.
* host-side spans (`repro_torch.obs.spans`) -- nested wall-clock
  intervals (build, the first round, later rounds, eval, store export,
  replay batches) exported as Chrome-trace JSON into the run's trace
  dir.
* metrics (`repro_torch.obs.metrics`) -- a counter/gauge/histogram
  registry with JSONL and Prometheus-text export; serving publishes its
  LRU hits and misses, tier counts and replay latency into it.
* structured run events -- the reference's JSONL schema
  (`repro_torch.obs.events`), written by ``run_experiment(trace_dir=)``,
  ``run_sweep`` and the scenarios CLI, read back by ``python -m
  repro_torch.obs summarize``; ``python -m repro_torch.obs report DIR``
  joins events, spans, metrics and health. Either package's readers
  read the other's files.
* profiling hooks -- ``torch.profiler`` traces and a FLOP count of the
  first round behind `TraceConfig`.
"""
from repro_torch.obs.events import (read_jsonl, run_events, summarize_run,
                                    sweep_events, write_jsonl, write_run,
                                    write_sweep)
from repro_torch.obs.health import HealthError, HealthReport, nonfinite_count
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profiling import compiled_cost, profile_ctx
from repro_torch.obs.report import report_text
from repro_torch.obs.spans import SpanLog, current_log, span
from repro_torch.obs.trace import RunTrace, TraceConfig, eval_points

__all__ = ["HealthError", "HealthReport", "MetricsRegistry", "RunTrace",
           "SpanLog", "TraceConfig", "compiled_cost",
           "current_log", "eval_points", "nonfinite_count",
           "profile_ctx", "read_jsonl", "report_text", "run_events",
           "span", "summarize_run", "sweep_events", "write_jsonl",
           "write_run", "write_sweep"]

"""The harness: resolve a cell of ``BENCHMARK.json`` to its files, drive
its path through set-up, the timed (or traced) window and the check,
and build the result line.

Nothing here names a configuration, a traffic mix or a metric: a cell's
configuration file names its path (``paths/<path>.py``), its traffic
names its mix (``workloads/<traffic>.json``), and each per-layer metric
its reader (``metrics/<metric>.py``).
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level modules no run may hold: the JAX package and JAX, and the
# older benchmark suite that measures it
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


@dataclass
class Cell:
    """One cell, resolved: its names, configuration and mix as read from
    their files, the run's seed and device, and the metrics it
    reports."""
    name: str
    config_name: str
    traffic: str
    config: dict
    mix: dict
    seed: int
    device: str = "cuda"
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (a manifest entry)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, seed: int, device: str = "cuda",
              spec: dict = None) -> Cell:
    """The cell ``name`` of ``spec`` (default ``BENCHMARK.json``)."""
    spec = manifest() if spec is None else spec
    try:
        w = next(c for c in spec["workloads"] if c["name"] == name)
    except StopIteration:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((BENCH / "workloads" / f"{w['traffic']}.json")
                     .read_text())
    return Cell(name=name, config_name=w["config"], traffic=w["traffic"],
                config=cfg, mix=mix, seed=int(seed), device=device,
                chips=w["chips"],
                end_to_end=[m for m in spec["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def load(kind: str, name: str):
    """The module ``bench/<kind>/<name>.py`` (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.{kind}.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def closed_loop(step, seconds: float, sync) -> tuple:
    """Call ``step()`` until ``seconds`` have passed, then ``sync()``.
    Returns (the steps' counts summed, steps, elapsed seconds): every
    step and all the time to the synchronized end."""
    t0 = time.perf_counter()
    total, steps = {}, 0
    while True:
        for k, v in step().items():
            total[k] = total.get(k, 0) + v
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return total, steps, time.perf_counter() - t0


def forbidden_modules(names=None) -> list:
    """The ``FORBIDDEN`` top-level names among ``names`` (default the
    modules this process holds), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def check_lines(checks: list) -> list:
    """One line a compared number: its name, value, limit and verdict."""
    return [f"check {c['name']} = {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if passed(c) else 'FAIL'}" for c in checks]


def passed(c: dict) -> bool:
    return isinstance(c["value"], (int, float)) \
        and math.isfinite(c["value"]) and c["value"] <= c["limit"]


def run(cell: Cell, *, seconds: float, trace: bool, t0: float,
        out_dir: Path = None) -> dict:
    """Set-up, window and check of ``cell``; returns the result line's
    object (``correct`` false where any compared number fails)."""
    import torch

    from bench.trace import Tracer, breakdown

    path = load("paths", cell.config["path"]).Path(cell)
    cuda = torch.device(cell.device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    before = time.perf_counter() - t0
    path.setup()
    setup_s = time.perf_counter() - t0 - path.check_seconds
    parts = ", ".join(f"{k} {v:.2f}" for k, v in path.setup_parts.items())
    print(f"bench: set-up {setup_s:.2f} s: start to the card {before:.2f}, "
          f"{parts}", file=sys.stderr)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": 1}
    extra = {}
    if not trace:
        metrics, attempted, failed = path.window(seconds)
        metrics["setup_s"] = setup_s
    else:
        tracer = Tracer(cell, out_dir or ROOT / "build" / "bench")
        attempted, failed = path.traced(tracer)
        data = tracer.data
        metrics = {}
        for m in cell.per_layer:
            v = load("metrics", m["name"]).read(data)
            if v is not None:
                metrics[m["name"]] = v
        device.update(busy_s=data.busy_s, window_s=data.window_s)
        extra["breakdown"] = breakdown(data)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device["memory_peak_bytes"] = peak
    if "peak_mem_gib" in {m["name"] for m in cell.end_to_end} and not trace:
        metrics["peak_mem_gib"] = peak / 2 ** 30
    path.release()
    checks = path.check()
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {"correct": bool(checks) and all(passed(c) for c in checks),
              "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in metrics.items() if k in units},
              "device": device, **extra,
              "checks": {c["name"]: {"value": c["value"],
                                     "limit": c["limit"]} for c in checks}}
    return result

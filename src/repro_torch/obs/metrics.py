"""Counter / gauge / histogram registry with JSONL + Prometheus export.

Serving needed what the training side already had: the training loop
reports through probe streams and run events (`repro_torch.obs.trace` /
`repro_torch.obs.events`), but `ModelStore`'s LRU, the tier-fallback ladder,
and traffic replay had nothing to report *into*. A `MetricsRegistry` is
that sink: a small host-side label-aware registry of the three standard
instrument kinds —

* :class:`Counter` — monotone totals (requests served, LRU hits/misses,
  per-tier resolution counts);
* :class:`Gauge` — last-write-wins values (cache hit rate, store bytes);
* :class:`Histogram` — raw observation lists with rank-based percentiles
  (per-batch replay latency, gather-decode vs forward stage splits).

Exports: :meth:`MetricsRegistry.write_jsonl` emits one JSON object per
instrument (the form ``python -m repro_torch.obs report`` joins with events,
spans, and health), and :meth:`MetricsRegistry.write_prom` emits
Prometheus text exposition (counters/gauges as samples, histograms as
summaries with quantile labels) so the same numbers scrape into a real
monitoring stack. ``replay_traffic(metrics=...)`` publishes into a
registry, and ``python -m repro_torch.scenarios serve --trace-dir DIR``
writes its snapshot next to the run's events and spans. The text is the
reference's, byte for byte, for the same observations.
"""
from __future__ import annotations

import pathlib
import re
from typing import Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "percentile"]


def percentile(values, p: float) -> float:
    """Nearest-rank percentile (ceil(p/100 * n)-th smallest) over raw
    observations — the convention `replay_traffic` always used, shared
    here so benchmark and registry report identical numbers."""
    a = np.sort(np.asarray(values, dtype=np.float64))
    if a.size == 0:
        return float("nan")
    rank = min(a.size - 1, int(np.ceil(p / 100 * a.size)) - 1)
    return float(a[max(rank, 0)])


class Counter:
    """Monotone counter: ``inc`` only ever adds (negative increments are
    rejected — a counter that can fall is a gauge)."""

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        """Add ``v`` (>= 0) to the running total."""
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += float(v)


class Gauge:
    """Last-write-wins scalar."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        """Record the current value."""
        self.value = float(v)


class Histogram:
    """Raw-observation histogram; percentiles computed at read time via
    the shared nearest-rank :func:`percentile`."""

    def __init__(self):
        self.observations: list = []

    def observe(self, v: float) -> None:
        """Record one observation."""
        self.observations.append(float(v))

    def count(self) -> int:
        """Number of observations recorded."""
        return len(self.observations)

    def sum(self) -> float:
        """Sum of all observations."""
        return float(np.sum(self.observations)) if self.observations \
            else 0.0

    def quantile(self, p: float) -> float:
        """Nearest-rank percentile over the raw observations."""
        return percentile(self.observations, p)

    def summary(self) -> dict:
        """{count, sum, mean, p50, p95, p99, max} over the observations
        (NaNs when empty)."""
        n = self.count()
        return {"count": n, "sum": self.sum(),
                "mean": self.sum() / n if n else float("nan"),
                "p50": self.quantile(50), "p95": self.quantile(95),
                "p99": self.quantile(99),
                "max": float(max(self.observations)) if n
                else float("nan")}


class MetricsRegistry:
    """Get-or-create instrument registry keyed on (name, labels).

    Names are dotted (``serving.lru.hits``); labels are keyword pairs
    (``encoding="delta"``). The JSONL export keeps dotted names; the
    Prometheus export sanitizes them to ``_``-separated metric names.
    """

    def __init__(self):
        self._instruments: dict = {}

    def _get(self, kind, name: str, labels: dict):
        key = (name, tuple(sorted(labels.items())))
        inst = self._instruments.get(key)
        if inst is None:
            inst = self._instruments[key] = kind()
        elif not isinstance(inst, kind):
            raise TypeError(
                f"metric {name!r}{labels} already registered as "
                f"{type(inst).__name__}, requested {kind.__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the `Counter` for (name, labels)."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        """Get-or-create the `Gauge` for (name, labels)."""
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        """Get-or-create the `Histogram` for (name, labels)."""
        return self._get(Histogram, name, labels)

    def __len__(self):
        return len(self._instruments)

    # ------------------------------------------------------------ export

    _TYPE = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}

    def snapshot(self) -> list:
        """One dict per instrument: ``{metric, type, labels, value}`` for
        counters/gauges, ``{metric, type, labels, **summary}`` for
        histograms — sorted by (metric, labels) for stable output."""
        out = []
        for (name, labels), inst in sorted(
                self._instruments.items(), key=lambda kv: kv[0]):
            rec = {"metric": name, "type": self._TYPE[type(inst)],
                   "labels": dict(labels)}
            if isinstance(inst, Histogram):
                rec.update(inst.summary())
            else:
                rec["value"] = inst.value
            out.append(rec)
        return out

    def write_jsonl(self, path) -> pathlib.Path:
        """Write :meth:`snapshot` as JSONL (one instrument per line)."""
        from repro_torch.obs.events import write_jsonl
        return write_jsonl(path, self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters and gauges as plain
        samples, histograms as summaries (quantile-labelled samples plus
        ``_count``/``_sum``)."""
        lines = []
        for rec in self.snapshot():
            name = re.sub(r"[^a-zA-Z0-9_:]", "_", rec["metric"])
            lbl = ",".join(f'{k}="{v}"'
                           for k, v in sorted(rec["labels"].items()))
            lbl_b = "{" + lbl + "}" if lbl else ""
            if rec["type"] == "histogram":
                lines.append(f"# TYPE {name} summary")
                for q in (50, 95, 99):
                    ql = (lbl + "," if lbl else "") + \
                        f'quantile="0.{q}"'
                    lines.append(
                        f"{name}{{{ql}}} {rec[f'p{q}']:.6g}")
                lines.append(f"{name}_count{lbl_b} {rec['count']}")
                lines.append(f"{name}_sum{lbl_b} {rec['sum']:.6g}")
            else:
                lines.append(f"# TYPE {name} {rec['type']}")
                lines.append(f"{name}{lbl_b} {rec['value']:.6g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prom(self, path) -> pathlib.Path:
        """Write :meth:`to_prometheus` text to ``path``."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_prometheus())
        return path

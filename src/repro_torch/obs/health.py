"""Health monitors: nonfinite and explosion detection per round.

Probes (`repro_torch.obs.trace`) measure convergence quantities; health
monitors answer a blunter question -- *is this run still numerically
alive?* Each algorithm's ``health_round`` computes a few scalar detector
values per global round: counts of nonfinite entries in the post-round
state and in the round's update, plus an algorithm-specific
loss-explosion flag. The engine copies them to the host with the round's
other outputs and assembles them into a :class:`HealthReport` on
``FLResult.health``.

The contract is the probes': detectors only read the state, so with
``TraceConfig.health`` on the trajectory is bit-identical to the run
without it.

A detector value > 0 marks the round as bad. ``TraceConfig.fail_fast``
turns detection into action: the engine raises :class:`HealthError`
naming the first bad 1-based round as soon as that round's values reach
the host, so a poisoned sweep dies at its first diverged round instead
of burning hours silently.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.obs.probes import float_tensors, reduce_tail

__all__ = ["HealthError", "HealthReport", "first_bad_round",
           "nonfinite_count"]


def nonfinite_count(tree, lead: int = 0) -> torch.Tensor:
    """Float32 count of non-finite entries over the float tensors of
    ``tree`` (a state's ``layout.columns``; integer fields and generators
    are skipped -- round counters and generators cannot go NaN), keeping
    the first ``lead`` axes. Counted in int64, so the count is exact."""
    total = None
    for t in float_tensors(tree):
        s = reduce_tail((~torch.isfinite(t)).to(torch.int64), lead)
        total = s if total is None else total + s
    return total.to(torch.float32)


def _bad(value: float) -> bool:
    v = float(value)
    return v > 0.0 or not math.isfinite(v)


def first_bad_round(series: dict) -> Optional[int]:
    """First 1-based round at which any detector stream fired (value > 0
    or itself nonfinite -- a NaN count means the detector's own reduction
    saw garbage), or None when every round is clean."""
    rounds = max((len(v) for v in series.values()), default=0)
    for r in range(rounds):
        for v in series.values():
            if r < len(v) and _bad(v[r]):
                return r + 1
    return None


class HealthError(RuntimeError):
    """Raised by the engine under ``TraceConfig.fail_fast`` when a health
    detector fires; carries the first bad 1-based round index."""

    def __init__(self, round_index: int, detectors: dict,
                 context: str = ""):
        """detectors: {name: value} of the streams that fired at that
        round; context: optional run identity for the message."""
        self.round_index = int(round_index)
        self.detectors = dict(detectors)
        where = f" [{context}]" if context else ""
        fired = ", ".join(f"{k}={float(v):g}"
                          for k, v in sorted(detectors.items()))
        super().__init__(
            f"health check failed at round {self.round_index}{where}: "
            f"{fired}")


@dataclass
class HealthReport:
    """Host-side per-round health detector streams for one experiment.

    series: detector name -> per-round list of floats (aligned with the
        run's global rounds, like ``RunTrace.series``); a value > 0 at
        round r means that detector fired there.
    """
    series: dict = field(default_factory=dict)

    def __len__(self):
        return max((len(v) for v in self.series.values()), default=0)

    def names(self) -> list:
        """Detector names present, sorted."""
        return sorted(self.series)

    def __getitem__(self, name: str) -> list:
        return self.series[name]

    def first_bad_round(self) -> Optional[int]:
        """First 1-based round where any detector fired, or None."""
        return first_bad_round(self.series)

    def ok(self) -> bool:
        """True when no detector fired at any round."""
        return self.first_bad_round() is None

    def check(self, context: str = "") -> "HealthReport":
        """Raise :class:`HealthError` naming the first bad round if any
        detector fired; return self otherwise (chainable). The engine's
        fail-fast path is exactly this call."""
        bad = self.first_bad_round()
        if bad is not None:
            r = bad - 1
            fired = {k: v[r] for k, v in self.series.items()
                     if r < len(v) and _bad(v[r])}
            raise HealthError(bad, fired, context)
        return self

    def summary(self) -> dict:
        """Footer material: ``{ok, first_bad_round, series: {name:
        {fired_rounds, max}}}`` -- compact enough for the JSONL run
        footer, complete enough for ``obs report``."""
        per = {}
        for k, v in self.series.items():
            a = np.asarray(v, dtype=np.float64)
            if a.size:
                bad = ~np.isfinite(a) | (a > 0)
                per[k] = {"fired_rounds": int(bad.sum()),
                          "max": float(np.nanmax(a))
                          if np.isfinite(a).any() else float("nan")}
        return {"ok": self.ok(), "first_bad_round": self.first_bad_round(),
                "series": per}

"""Probe selection (`TraceConfig`) and its host-side product (`RunTrace`).

The paper's convergence theory is stated in quantities a plain run never
shows: the personalization gap ``||theta_ij - w_i||`` (device vs team
model), the tier drift ``||w_i - x||`` (team vs server model), gradient
and update norms and, under compression, the error-feedback residuals. A
`TraceConfig` selects which of these scalar diagnostics an algorithm's
``probe_round`` computes after each round; the engine
(``repro_torch.train.engine.drive``) copies them to the host with the
round's participation counts, in the one copy it makes each round, and
assembles the per-round streams into a `RunTrace` on ``FLResult.trace``.

Probes only read the state: they launch none of the port's kernels and
draw from no ``torch.Generator``, so with probes on the trajectory is
bit-identical to the run without them, and with ``trace=None`` (the
default) the engine does nothing it did not do before.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["RunTrace", "TraceConfig", "eval_points"]


def eval_points(rounds: int, eval_every: int) -> list:
    """1-based round indices at which the engine evaluates: every
    `eval_every` rounds plus the final round. The engine, the sweep and
    the event log all align metric histories on these points."""
    n_chunks, rem = divmod(rounds, eval_every)
    return [eval_every * (k + 1) for k in range(n_chunks)] \
        + ([rounds] if rem else [])


@dataclass(frozen=True)
class TraceConfig:
    """Which per-round diagnostics to compute, plus the profiling hooks
    (the reference's fields and defaults).

    Probe groups:

    drift: personalization gap ``||theta_ij - w_i||`` (mean/max over
        participating devices) and tier drift ``||w_i - x||`` (mean/max
        over participating teams) -- the residuals Theorems 1-2 bound.
    grads: whole-state update norm, and the post-round gradient norm of
        the device objective (one extra forward and backward of every
        device a round -- 1/(K*L) of the round's gradient work).
    residuals: per-tier error-feedback residual norms (device and team
        senders), when the algorithm runs compressed uplinks.
    loss: participation-weighted train loss of the personalized models
        (only devices whose team also participated contribute).

    Health monitors (`repro_torch.obs.health`):

    health: compute the algorithm's ``health_round`` detectors (nonfinite
        param/update counts, loss-explosion flag), assembled into
        ``FLResult.health``.
    fail_fast: raise `repro_torch.obs.health.HealthError` naming the
        first bad round as soon as a round's detectors fire (requires
        ``health``).
    health_loss_max: participation-weighted train loss above this
        threshold trips the loss-explosion detector.

    Host-side hooks:

    cost_analysis: count the first round's matmul/conv FLOPs
        (`repro_torch.obs.profiling.compiled_cost`) onto ``RunTrace.cost``.
    profile_dir: when set, run the experiment's rounds under
        ``torch.profiler`` and export a Chrome trace into this directory.
    """
    drift: bool = True
    grads: bool = True
    residuals: bool = True
    loss: bool = True
    health: bool = True
    fail_fast: bool = False
    health_loss_max: float = 1e6
    cost_analysis: bool = False
    profile_dir: Optional[str] = None


@dataclass
class RunTrace:
    """Host-side per-round probe streams for one experiment.

    config: the `TraceConfig` that selected the probes.
    series: probe name -> per-round list of floats (one entry per global
        round, aligned with ``FLResult.participation``).
    cost: ``{"flops": ...}`` of the first round, when the config asked
        for it (`repro_torch.obs.profiling.compiled_cost`).
    """
    config: TraceConfig
    series: dict = field(default_factory=dict)
    cost: Optional[dict] = None

    def __len__(self):
        return max((len(v) for v in self.series.values()), default=0)

    def names(self) -> list:
        """Probe names present in this trace, sorted."""
        return sorted(self.series)

    def __getitem__(self, name: str) -> list:
        return self.series[name]

    def last(self, name: str) -> float:
        """Final-round value of one probe (NaN when the stream is empty)."""
        s = self.series.get(name, [])
        return float(s[-1]) if s else float("nan")

    def at_points(self, points) -> list:
        """Per-eval-segment probe summaries: for each 1-based round index
        in `points`, the mean of every series over the rounds since the
        previous point -- the join key the JSONL eval events use."""
        out, lo = [], 0
        for p in points:
            seg = {}
            for k, v in self.series.items():
                window = np.asarray(v[lo:p], dtype=np.float64)
                seg[k] = float(window.mean()) if window.size else float("nan")
            out.append(seg)
            lo = p
        return out

    def summary(self) -> dict:
        """Per-probe {mean, max, last} over the whole run -- run-footer
        material."""
        out = {}
        for k, v in self.series.items():
            a = np.asarray(v, dtype=np.float64)
            if a.size:
                out[k] = {"mean": float(a.mean()), "max": float(a.max()),
                          "last": float(a[-1])}
        return out

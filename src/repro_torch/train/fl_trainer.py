"""FL trainer: the ``run_<algo>`` entry points over the engine.

Only ``run_permfl`` is ported so far; the baselines' runners come with
their algorithms (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.comm import CommConfig
from repro_torch.core import PerMFL, PerMFLHParams
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.train.engine import FLResult, run_experiment

__all__ = ["FLResult", "run_permfl"]


def run_permfl(params0, train_data, val_data, *, loss_fn, metric_fn,
               hp: PerMFLHParams, rounds: int, m: int, n: int,
               team_frac: float = 1.0, device_frac: float = 1.0,
               seed: int = 0, eval_every: int = 1,
               comm: Optional[CommConfig] = None,
               masks: Optional[Callable] = None,
               uniforms: Optional[Callable] = None,
               device=DEFAULT_DEVICE) -> FLResult:
    """PerMFL (Algorithm 1); optional ``comm`` compresses the uplinks and
    fills ``FLResult.comm`` with the byte ledger."""
    return run_experiment(
        PerMFL(loss_fn, hp, comm=comm), params0, train_data, val_data,
        metric_fn=metric_fn, rounds=rounds, m=m, n=n, team_frac=team_frac,
        device_frac=device_frac, seed=seed, eval_every=eval_every,
        masks=masks, uniforms=uniforms, device=device)

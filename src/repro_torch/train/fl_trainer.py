"""FL trainer: the seven ``run_<algo>`` entry points over the engine.

Each builds the matching FLAlgorithm (``core.algorithm``,
``core.baselines``) and hands it to ``train.engine.run_experiment``, with
the reference's keyword signatures plus ``masks=`` and ``device=``.
``FLResult.state`` is each algorithm's final state:

    permfl                    -> PerMFLState
    fedavg, perfedavg, hsgd   -> BaselineState (x)
    pfedme, ditto, l2gd       -> BaselineState (x, personal)

Only PerMFL takes sampled participation; the baselines ignore the masks
and the engine refuses ``team_frac`` / ``device_frac`` < 1 for them.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.comm import CommConfig
from repro_torch.core import PerMFL, PerMFLHParams
from repro_torch.core import baselines as B
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.train.engine import FLResult, run_experiment

__all__ = ["ALGORITHMS", "FLResult", "run_ditto", "run_fedavg",
           "run_hsgd", "run_l2gd", "run_perfedavg", "run_permfl",
           "run_pfedme"]


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


def _run(algo, params0, train_data, val_data, metric_fn, rounds, m, n,
         eval_every, masks, device):
    return run_experiment(algo, params0, train_data, val_data,
                          metric_fn=metric_fn, rounds=rounds, m=m, n=n,
                          eval_every=eval_every, masks=masks, device=device)


def run_fedavg(params0, train_data, val_data, *, loss_fn, metric_fn,
               lr: float, local_steps: int, rounds: int, m: int, n: int,
               eval_every: int = 1, masks: Optional[Callable] = None,
               device=DEFAULT_DEVICE) -> FLResult:
    """FedAvg: local SGD + global averaging; metrics report GM only."""
    return _run(B.FedAvg(loss_fn, lr=lr, local_steps=local_steps), params0,
                train_data, val_data, metric_fn, rounds, m, n, eval_every,
                masks, device)


def run_perfedavg(params0, train_data, val_data, *, loss_fn, metric_fn,
                  lr: float, inner_lr: float, local_steps: int, rounds: int,
                  m: int, n: int, eval_every: int = 1,
                  masks: Optional[Callable] = None,
                  device=DEFAULT_DEVICE) -> FLResult:
    """Per-FedAvg (second-order MAML); PM is one adaptation step from
    GM."""
    return _run(B.PerFedAvg(loss_fn, lr=lr, inner_lr=inner_lr,
                            local_steps=local_steps), params0, train_data,
                val_data, metric_fn, rounds, m, n, eval_every, masks,
                device)


def run_pfedme(params0, train_data, val_data, *, loss_fn, metric_fn,
               lr: float, inner_lr: float, lam: float, inner_steps: int,
               local_rounds: int, rounds: int, m: int, n: int,
               eval_every: int = 1, masks: Optional[Callable] = None,
               device=DEFAULT_DEVICE) -> FLResult:
    """pFedMe: Moreau-envelope personalization, single tier."""
    return _run(B.PFedMe(loss_fn, lr=lr, inner_lr=inner_lr, lam=lam,
                         inner_steps=inner_steps,
                         local_rounds=local_rounds), params0, train_data,
                val_data, metric_fn, rounds, m, n, eval_every, masks,
                device)


def run_ditto(params0, train_data, val_data, *, loss_fn, metric_fn,
              lr: float, lam: float, local_steps: int, rounds: int, m: int,
              n: int, eval_every: int = 1, masks: Optional[Callable] = None,
              device=DEFAULT_DEVICE) -> FLResult:
    """Ditto: FedAvg GM + per-device prox-regularized PM."""
    return _run(B.Ditto(loss_fn, lr=lr, lam=lam, local_steps=local_steps),
                params0, train_data, val_data, metric_fn, rounds, m, n,
                eval_every, masks, device)


def run_hsgd(params0, train_data, val_data, *, loss_fn, metric_fn,
             lr: float, k_team: int, l_local: int, rounds: int, m: int,
             n: int, eval_every: int = 1, masks: Optional[Callable] = None,
             device=DEFAULT_DEVICE) -> FLResult:
    """h-SGD: hierarchical local SGD (team avg every L, global every
    K*L)."""
    return _run(B.HSGD(loss_fn, lr=lr, k_team=k_team, l_local=l_local),
                params0, train_data, val_data, metric_fn, rounds, m, n,
                eval_every, masks, device)


def run_l2gd(params0, train_data, val_data, *, loss_fn, metric_fn,
             lr: float, lam_c: float, lam_g: float, k_team: int,
             l_local: int, rounds: int, m: int, n: int,
             eval_every: int = 1, masks: Optional[Callable] = None,
             device=DEFAULT_DEVICE) -> FLResult:
    """L2GD (synchronous variant): global/cluster/personal mixture."""
    return _run(B.L2GD(loss_fn, lr=lr, lam_c=lam_c, lam_g=lam_g,
                       k_team=k_team, l_local=l_local), params0, train_data,
                val_data, metric_fn, rounds, m, n, eval_every, masks,
                device)


ALGORITHMS = {
    "permfl": run_permfl,
    "fedavg": run_fedavg,
    "perfedavg": run_perfedavg,
    "pfedme": run_pfedme,
    "ditto": run_ditto,
    "hsgd": run_hsgd,
    "l2gd": run_l2gd,
}

"""Experiment runners of the port: the round-loop engine, run_permfl and
the other trainers, the stacked sweep, the cohort engine's device-state
store, checkpoints, and LM training (central and tiered PerMFL steps,
optimizers, train state, metrics)."""
from repro_torch.train import (checkpoint, engine, fl_trainer, metrics, optim,
                               store, sweep, trainer)
from repro_torch.train.engine import FLResult, run_experiment
from repro_torch.train.optim import adamw, momentum, sgd
from repro_torch.train.sweep import FLSweepResult, grid_product, run_sweep
from repro_torch.train.train_state import TrainState

__all__ = ["checkpoint", "engine", "fl_trainer", "metrics", "optim", "store",
           "sweep", "trainer", "FLResult", "run_experiment", "FLSweepResult",
           "grid_product", "run_sweep", "adamw", "momentum", "sgd",
           "TrainState"]

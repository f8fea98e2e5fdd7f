"""Experiment runners of the port: the round-loop engine, run_permfl and
the other trainers, the stacked sweep, the cohort engine's device-state
store, and checkpoints."""
from repro_torch.train import checkpoint, engine, fl_trainer, store, sweep
from repro_torch.train.engine import FLResult, run_experiment
from repro_torch.train.sweep import FLSweepResult, grid_product, run_sweep

__all__ = ["checkpoint", "engine", "fl_trainer", "store", "sweep", "FLResult",
           "run_experiment", "FLSweepResult", "grid_product", "run_sweep"]

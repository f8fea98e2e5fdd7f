"""Core of the port: Algorithm 1 (permfl), the unified FLAlgorithm API
(algorithm), the Table-1 baselines, participation sampling, team
formation and the Theorem-1/2 rate helpers (theory)."""
from repro_torch.core.algorithm import FLAlgorithm, FLAlgorithmBase, PerMFL
from repro_torch.core.permfl import (PerMFLHParams, PerMFLState,
                                     eval_stacked, init_state,
                                     normalize_masks, permfl_round)
from repro_torch.core import (algorithm, baselines, participation,  # noqa: E402,E501
                              team_formation, theory)

__all__ = ["FLAlgorithm", "FLAlgorithmBase", "PerMFL", "PerMFLHParams",
           "PerMFLState", "algorithm", "baselines", "eval_stacked",
           "init_state", "normalize_masks", "participation", "permfl_round",
           "team_formation", "theory"]

"""PerMFL core of the port: Algorithm 1, participation, the algorithm API."""
from repro_torch.core.algorithm import FLAlgorithm, FLAlgorithmBase, PerMFL
from repro_torch.core.permfl import (PerMFLHParams, PerMFLState, init_state,
                                     permfl_round)

__all__ = ["FLAlgorithm", "FLAlgorithmBase", "PerMFL", "PerMFLHParams",
           "PerMFLState", "init_state", "permfl_round"]

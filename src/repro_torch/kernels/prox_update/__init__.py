"""PerMFL device prox step: Hopper CUDA kernel + plain PyTorch version."""
from repro_torch.kernels.prox_update.ops import (prox_sgd, prox_sgd_tree,
                                                 prox_step_)
from repro_torch.kernels.prox_update.ref import prox_sgd_ref

__all__ = ["prox_sgd", "prox_sgd_ref", "prox_sgd_tree", "prox_step_"]

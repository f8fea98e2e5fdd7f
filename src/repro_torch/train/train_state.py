"""TrainState: params + optimizer state + step (the port of
``repro/train/train_state.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.flat import tree_leaves
from repro_torch.train.optim import Optimizer, tree_map

__all__ = ["TrainState"]


@dataclass
class TrainState:
    """The parameters, the optimizer's state and the step count."""
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32 on the parameters' device

    @classmethod
    def create(cls, params, opt: Optimizer):
        """Step 0, the optimizer's state from ``opt.init(params)``."""
        dev = tree_leaves(params)[0][1].device
        return cls(params=params, opt_state=opt.init(params),
                   step=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def apply_gradients(self, grads, opt: Optimizer, lr):
        """A new state: params ``(p - u)`` cast to p's dtype, for the
        optimizer's updates u (new tensors: the old params stay as they
        are; the optimizer's moments are updated in place, see
        ``optim``)."""
        updates, new_opt = opt.update(grads, self.opt_state, self.params, lr)
        new_params = tree_map(lambda p, u: (p - u).to(p.dtype), self.params,
                              updates)
        return TrainState(params=new_params, opt_state=new_opt,
                          step=self.step + 1)

"""Small metric utilities shared by trainers and benchmarks (the port of
``repro/train/metrics.py``)."""
from __future__ import annotations

import operator

import torch

__all__ = ["RunningMean", "perplexity", "token_accuracy"]


def token_accuracy(logits, targets):
    """Fraction of non-padding tokens (targets >= 0) predicted exactly;
    0 when every position is padding."""
    mask = targets >= 0
    pred = logits.argmax(dim=-1)
    return (((pred == targets) & mask).sum()
            / mask.sum().clamp_min(1)).float()


def perplexity(loss):
    """exp(mean cross-entropy) -- the LM eval number."""
    return torch.exp(torch.as_tensor(loss))


class RunningMean:
    """Weighted streaming mean of host-side scalars.

    ``update(value, n)`` folds in a batch mean over ``n`` samples; the
    weight must be a positive integer -- zero or negative counts would
    silently skew (or poison) the aggregate, so they raise instead.
    """

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        """Fold in `value` with integer weight ``n >= 1``."""
        n = operator.index(n)
        if n <= 0:
            raise ValueError(f"RunningMean.update needs n >= 1, got {n}")
        self.total += float(value) * n
        self.count += n

    def reset(self):
        """Forget everything; the instance is reusable across epochs."""
        self.total = 0.0
        self.count = 0

    @property
    def mean(self):
        """Current weighted mean; 0.0 before any update."""
        return self.total / max(self.count, 1)

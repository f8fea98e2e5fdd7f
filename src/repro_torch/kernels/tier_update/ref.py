"""Plain PyTorch version of PerMFL's team and server updates at LLM scale
(paper eqs. 9 and 13), on one leaf:

    w' = (1 - eta lam - eta gamma) w + eta gamma x + lam eta theta
    x' = (1 - beta gamma) x + beta gamma w'

op by op in the leaves' type, as the tier round ran them before the
kernel: five scalings and three adds, each rounded to the leaves' type.
The CPU path runs it, and the CUDA kernel beside it
(``csrc/tier_update.cu``) is held against it: the kernel rounds each
operation in the same order, so on the card the two agree bit for bit.
"""
from __future__ import annotations

__all__ = ["tier_update_ref"]


def tier_update_ref(w, x, theta, *, eta, lam, gamma, beta):
    """(w', x') of one leaf: w, x and theta tensors of one shape and type
    (they may be the same tensor), eta, lam, gamma and beta floats.
    Returns new tensors and leaves the inputs as they are."""
    c = 1.0 - eta * lam - eta * gamma
    w_new = c * w + eta * gamma * x + lam * eta * theta
    return w_new, (1 - beta * gamma) * x + beta * gamma * w_new

"""Plain PyTorch version of the PerMFL device prox step (paper eq. 4).

    theta_new = theta - alpha * grad - alpha * lam * (theta - anchor)

optionally with heavy-ball momentum and weight decay. ``alpha`` and
``lam`` are Python floats, or float32 tensors of one value per group of
rows (a hyperparameter sweep's configurations). The CPU path runs it,
and the CUDA kernel beside it (``csrc/prox_update.cu``) is held against
it: the kernel rounds each operation in the same order, so on the card
the two agree bit for bit.
"""
from __future__ import annotations

import torch


def prox_sgd_ref(theta, grad, anchor, *, alpha, lam, momentum=0.0,
                 mom_buf=None, weight_decay=0.0):
    """``anchor`` broadcasts against ``theta``; ``grad`` and ``mom_buf``
    have theta's shape. ``alpha`` / ``lam``: floats, or float32 tensors of
    shape (G,) with G = ``theta.shape[0]``, broadcast as (G, 1, ..., 1).
    Returns (theta_new in theta's dtype, mom_new in float32). With
    ``momentum == 0`` the buffer is returned as given (zeros if None)."""
    alpha, lam = (_groups(v, theta) for v in (alpha, lam))
    tf = theta.float()
    gf = grad.float()
    af = anchor.float()
    update = gf + lam * (tf - af) + weight_decay * tf
    if momentum > 0.0:
        mb = (torch.zeros_like(tf) if mom_buf is None
              else mom_buf.float())
        mb = momentum * mb + update
        update = mb
    else:
        mb = torch.zeros_like(tf) if mom_buf is None else mom_buf
    new = tf - alpha * update
    return new.to(theta.dtype), mb


def _groups(v, theta):
    """A per-group tensor (G,) as (G, 1, ..., 1) against ``theta``; a float
    as it is."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.shape != theta.shape[:1] or v.dtype != torch.float32:
        raise ValueError(f"per-group hyperparameters must be float32 of "
                         f"shape ({theta.shape[0]},), got {v.dtype} "
                         f"{tuple(v.shape)}")
    return v.reshape(v.shape + (1,) * (theta.dim() - 1))

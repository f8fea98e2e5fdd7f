"""Optimizers on parameter trees (the port of ``repro/train/optim.py``).

sgd / momentum / adamw, each as (init(params) -> opt_state,
update(grads, opt_state, params, lr) -> (updates, opt_state)), with the
reference's arithmetic (not ``torch.optim``): moments in float32, AdamW's
``weight_decay * p`` inside the update, ``(lr * u)`` cast to the
parameter's dtype. Updates are *subtracted* by the caller
(``TrainState.apply_gradients``). Trees are nested dicts of tensors.

To save memory at full width, ``update`` writes the new moments into the
state's own buffers in place (the returned state holds the same tensors,
and the step count ``t`` is a new 0-d tensor): a state must not be
updated twice from the same old value. Each in-place form rounds the
same operations in the same order as the reference's expressions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.flat import tree_leaves

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "momentum", "sgd", "tree_map"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclass(frozen=True)
class Optimizer:
    """An optimizer as the pair ``init(params) -> opt_state`` and
    ``update(grads, opt_state, params, lr) -> (updates, opt_state)``."""
    init: Callable[[Any], Any]
    update: Callable[..., Any]
    name: str = "opt"


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd() -> Optimizer:
    """Plain SGD: updates ``lr * g``; no state (``()``)."""
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_map(lambda g: lr * g, grads), state

    return Optimizer(init, update, "sgd")


def momentum(mu: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum: a float32 buffer b <- mu b + g (in place);
    updates ``lr * b``, or ``lr * (mu b + g)`` with ``nesterov``."""
    def init(params):
        return tree_map(_zeros32, params)

    def update(grads, buf, params, lr):
        def step(b, g):             # mu * b + f32(g), into b
            return b.mul_(mu).add_(g.float())

        buf = tree_map(step, buf, grads)
        if nesterov:
            upd = tree_map(lambda b, g: lr * (mu * b + g), buf, grads)
        else:
            upd = tree_map(lambda b: lr * b, buf)
        return upd, buf

    return Optimizer(init, update, "momentum")


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW: float32 moments m, v (in place) and an int32 step t;
    updates ``(lr * (m^ / (sqrt(v^) + eps) + weight_decay * p))`` in p's
    dtype, m^ and v^ bias-corrected by 1 - b ** t."""
    def init(params):
        dev = tree_leaves(params)[0][1].device
        return {"m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        t = state["t"] + 1

        def first(mm, g):           # b1 * m + (1 - b1) * f32(g), into m
            return mm.mul_(b1).add_(g.float() * (1 - b1))

        def second(vv, g):          # b2 * v + (1 - b2) * f32(g)^2, into v
            return vv.mul_(b2).add_(g.float().square().mul_(1 - b2))

        m = tree_map(first, state["m"], grads)
        v = tree_map(second, state["v"], grads)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=tf.device), tf)

        def upd(mm, vv, p):
            u = (mm / bc1).div_((vv / bc2).sqrt_().add_(eps))
            if weight_decay:
                u = u.add_(weight_decay * p.float())
            return u.mul_(lr).to(p.dtype)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adamw")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared entries, in float32."""
    return torch.sqrt(sum(
        torch.linalg.vector_norm(x, dtype=torch.float32).square()
        for _, x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads * min(1, max_norm / max(norm, 1e-12)), norm): new tensors in
    each gradient's dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm

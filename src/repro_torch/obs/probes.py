"""Norm and aggregation helpers the probe implementations share.

The port's state is a dataclass of flat tier buffers: rows of ``stride``
values over a ``repro_torch.flat.Layout``, of which the first
``layout.size`` are the parameters and the rest zero padding. Every
helper here reads only those ``layout.columns``, so the padding never
enters a probe. Integer fields (the round counter), generators (the
compressors' uniforms) and the layout itself are skipped, as the
reference skips its integer and PRNG-key leaves: probes measure the
float state.

``lead`` counts the leading axes kept: 0 for a single run, 1 for a
sweep's stacked state, whose configs lead every tier, so that each
config gets its own value, as each lane of the reference's vmap does.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["float_tensors", "masked_max", "masked_mean", "reduce_tail",
           "stacked_sq_norm", "tree_diff_norm"]


def float_tensors(tree, layout=None) -> list:
    """The float tensors of ``tree`` (a tensor, a state dataclass, or a
    dict, list or tuple of them), each cut to ``layout.columns`` where its
    rows are ``layout.stride`` long; a dataclass with a ``layout`` field
    supplies it to everything below it."""
    if isinstance(tree, torch.Tensor):
        if not tree.is_floating_point():
            return []
        if layout is not None and tree.dim() and \
                tree.shape[-1] == layout.stride:
            return [layout.columns(tree)]
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        layout = getattr(tree, "layout", layout)
        return [t for f in dataclasses.fields(tree)
                for t in float_tensors(getattr(tree, f.name), layout)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in float_tensors(v, layout)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in float_tensors(v, layout)]
    return []


def reduce_tail(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` summed over every axis after the first ``lead``."""
    if t.dim() == lead:
        return t
    return t.sum(dim=tuple(range(lead, t.dim())))


def stacked_sq_norm(tree, lead: int) -> torch.Tensor:
    """Squared l2 norm, float32, summed over the float tensors of
    ``tree``, keeping the first ``lead`` axes.

    ``stacked_sq_norm(layout.columns(theta), 2)`` on (M, N, S) rows
    gives the (M, N) matrix of per-device squared model norms;
    ``lead=0`` a scalar.
    """
    total = None
    for t in float_tensors(tree):
        s = reduce_tail(t.float().square(), lead)
        total = s if total is None else total + s
    return total


def tree_diff_norm(a, b, lead: int = 0) -> torch.Tensor:
    """The l2 distance between two states' float tensors (float32), one
    value per leading config when ``lead`` is 1 -- the generic
    whole-state update norm."""
    total = None
    for ta, tb in zip(float_tensors(a), float_tensors(b)):
        s = reduce_tail((tb.float() - ta.float()).square(), lead)
        total = s if total is None else total + s
    return total.sqrt()


def masked_mean(values, mask, lead: int = 0) -> torch.Tensor:
    """Participation-weighted mean of ``values`` (mask-shaped) over the
    axes after the first ``lead``; 0 where the mask is empty."""
    return reduce_tail(values * mask, lead) / \
        reduce_tail(mask, lead).clamp_min(1.0)


def masked_max(values, mask, lead: int = 0) -> torch.Tensor:
    """Max of ``values`` over set mask entries, over the axes after the
    first ``lead``. Values must be >= 0 (norms are): masked-out entries
    contribute 0, and an all-zero mask gives 0."""
    v = values * mask
    return v.flatten(lead).amax(-1) if v.dim() > lead else v

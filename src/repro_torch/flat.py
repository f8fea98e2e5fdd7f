"""Parameter trees kept as one flat buffer per tier.

A model's parameters are a nested dict of tensors with the JAX package's
leaf names and shapes. The port stores a whole tier of the PerMFL state
-- the global model x (P,), the team models w (M, P), the device models
theta (M, N, P) -- as ONE buffer whose last axis holds every leaf, and
hands the leaves out as views (:meth:`Layout.unflatten`). So tier
arithmetic (masked means, gates, the team and global updates) is one
tensor op per tier, autograd returns the gradient of every leaf as one
buffer, and the prox kernel updates every leaf of every device in one
launch.

Leaves sit in sorted key order, the order ``jax.tree.leaves`` gives a
nested dict. The row is padded to a multiple of ``ROW_ALIGN`` elements so
that every row of a stacked buffer starts 16-byte aligned (the kernel's
vector accesses); the padding is zero and stays zero under every tier
update (its gradient is zero, and the kernel is given only the P real
columns).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Layout", "ROW_ALIGN", "tree_leaves"]

ROW_ALIGN = 64


def tree_leaves(tree, prefix=()):
    """[(key path, leaf)] of a nested dict, in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(tree_leaves(tree[k], prefix + (k,)))
    return out


@dataclass(frozen=True)
class Layout:
    """Where each leaf of a parameter tree sits in a flat row.

    paths / shapes: the leaves' key paths and (unstacked) shapes;
    size: P, the number of parameters; stride: the padded row length.
    """
    paths: tuple
    shapes: tuple
    size: int
    stride: int

    @classmethod
    def of(cls, tree) -> "Layout":
        """The layout of an unstacked parameter tree."""
        leaves = tree_leaves(tree)
        shapes = tuple(tuple(leaf.shape) for _, leaf in leaves)
        size = sum(_numel(s) for s in shapes)
        stride = -(-size // ROW_ALIGN) * ROW_ALIGN
        return cls(tuple(p for p, _ in leaves), shapes, size, stride)

    def flatten(self, tree, lead=()) -> torch.Tensor:
        """Copy ``tree`` (leaves shaped ``lead + shape``) into a new
        zero-padded buffer of shape ``lead + (stride,)``, on the leaves'
        device."""
        leaves = tree_leaves(tree)
        if tuple(p for p, _ in leaves) != self.paths:
            raise ValueError("tree does not match this layout")
        first = leaves[0][1]
        buf = torch.zeros(tuple(lead) + (self.stride,), dtype=first.dtype,
                          device=first.device)
        off = 0
        for (_, leaf), shape in zip(leaves, self.shapes):
            n = _numel(shape)
            buf[..., off:off + n] = leaf.reshape(tuple(lead) + (n,))
            off += n
        return buf

    def unflatten(self, buf: torch.Tensor) -> dict:
        """Nested dict of views into ``buf`` (shape ``lead + (stride,)``),
        each leaf shaped ``lead + shape``. Autograd through the views
        gives the gradient of ``buf`` as one tensor."""
        if buf.shape[-1] != self.stride:
            raise ValueError(f"buffer rows hold {buf.shape[-1]} values, "
                             f"layout needs {self.stride}")
        sizes = [_numel(s) for s in self.shapes]
        if self.stride > self.size:
            sizes.append(self.stride - self.size)
        chunks = buf.split(sizes, dim=-1)
        tree = {}
        for path, shape, chunk in zip(self.paths, self.shapes, chunks):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = (chunk.unflatten(-1, shape) if shape
                              else chunk.squeeze(-1))
        return tree

    @property
    def leaf_sizes(self) -> tuple:
        """The number of values of each leaf, in row order."""
        return tuple(_numel(s) for s in self.shapes)

    def columns(self, buf: torch.Tensor) -> torch.Tensor:
        """The P real columns of ``buf`` (a view without the padding)."""
        return buf[..., :self.size]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n

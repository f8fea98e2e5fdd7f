"""Partition specs of the port's trees: the reference's rules
(``repro/sharding/specs.py``), leaf path by leaf path, on one card.

The rules are the reference's (DESIGN.md §2/§5): the ``model`` axis
takes attention heads, FFN hidden dims and MoE experts, the ``data``
axis FSDP's d_model dim and the batch, the ``pod`` axis batch and teams;
sweeps put configs on the ``sweep`` axis. A spec is a :class:`P`, a
tuple with one entry a dim: an axis name, a tuple of names, or None.
Trees are the port's: nested dicts of tensors (parameters, batches,
caches), and for the FL specs also dataclass states and tuples of
generators; paths read like the reference's (``blocks/pos0/attn/wq``).

:func:`place` is the port of ``to_named``: it validates the specs
against the mesh (:func:`validate_pspecs`) and puts every leaf whole on
the mesh's one device, where every axis has size 1. Non-tensor leaves
stay as they are: host arrays, generators (which must already live on
that device) and fields that carry no spec.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch

__all__ = ["P", "batch_pspecs", "cache_pspecs", "fl_pspecs",
           "param_pspecs", "place", "store_pspecs", "sweep_pspecs",
           "validate_pspecs"]


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over the data
    axis and keeps dim 1 whole; ``P()`` replicates every dim."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _rules(data_axes):
    """(path regex, spec of the leaf's ndim) pairs; data_axes: name or
    tuple for the FSDP ("reduce") dim, None without FSDP. Leaves under
    blocks/ carry a leading n_blocks axis."""
    da = data_axes

    def lead(nd, k):
        return [None] * (nd - k)

    return [
        # --- attention ---
        (r"attn/wq$|attn/wk$|attn/wv$|cross/wq$|cross/wk$|cross/wv$",
         lambda nd: P(*lead(nd, 2), da, "model")),
        (r"attn/wo$|cross/wo$", lambda nd: P(*lead(nd, 2), "model", da)),
        (r"attn/b[qkv]$", lambda nd: P(*lead(nd, 1), "model")),
        # --- dense mlp ---
        (r"mlp/w_gate$|mlp/w_up$|shared/w_gate$|shared/w_up$|mlp/w_in$",
         lambda nd: P(*lead(nd, 2), da, "model")),
        (r"mlp/w_down$|shared/w_down$|mlp/w_out$",
         lambda nd: P(*lead(nd, 2), "model", da)),
        (r"mlp/b_in$", lambda nd: P(*lead(nd, 1), "model")),
        # --- moe: expert parallel over `model`, FSDP on the d dim ---
        (r"experts/w_(gate|up)$", lambda nd: P(*lead(nd, 3), "model", da,
                                               None)),
        (r"experts/w_down$", lambda nd: P(*lead(nd, 3), "model", None, da)),
        (r"moe/router$", lambda nd: P()),
        # --- mamba ---
        (r"mamba/in_proj$", lambda nd: P(*lead(nd, 2), da, "model")),
        (r"mamba/out_proj$", lambda nd: P(*lead(nd, 2), "model", da)),
        (r"mamba/conv_w$", lambda nd: P(*lead(nd, 1), "model")),
        (r"mamba/conv_b$|mamba/dt_bias$|mamba/D$",
         lambda nd: P(*lead(nd, 1), "model")),
        (r"mamba/x_proj$", lambda nd: P(*lead(nd, 2), "model", None)),
        (r"mamba/dt_proj$", lambda nd: P(*lead(nd, 2), None, "model")),
        (r"mamba/A_log$", lambda nd: P(*lead(nd, 2), "model", None)),
        # --- rwkv ---
        (r"tm/w_[rkvg]$", lambda nd: P(*lead(nd, 2), da, "model")),
        (r"tm/w_o$", lambda nd: P(*lead(nd, 2), "model", da)),
        (r"tm/decay_A$", lambda nd: P(*lead(nd, 2), da, None)),
        (r"tm/decay_B$", lambda nd: P(*lead(nd, 2), None, "model")),
        (r"tm/bonus_u$", lambda nd: P(*lead(nd, 2), "model", None)),
        (r"cm/w_k$", lambda nd: P(*lead(nd, 2), da, "model")),
        (r"cm/w_v$", lambda nd: P(*lead(nd, 2), "model", da)),
        (r"cm/w_r$", lambda nd: P(*lead(nd, 2), da, "model")),
        # --- embeddings / head ---
        (r"^embed$", lambda nd: P("model", None)),
        (r"^lm_head$", lambda nd: P(None, "model")),
        # everything else (norm scales, mu_*, decay_w0, biases) replicated
    ]


def _is_generators(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(g, torch.Generator) for g in x)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) or _is_generators(x)


def _shape(leaf) -> tuple:
    """A leaf's shape; a tuple of C generators is (C,)."""
    return (len(leaf),) if _is_generators(leaf) else tuple(leaf.shape)


def _map(fn, tree, *rest, path=(), keep=False):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree`` (dicts,
    dataclasses, lists and tuples descended into), ``rest`` trees of the
    same structure; a field that is no leaf and no container maps to
    None, or with ``keep`` to itself."""
    def sub(v, rs, key):
        return _map(fn, v, *rs, path=path + (key,), keep=keep)

    if _is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: sub(v, [r[k] for r in rest], str(k))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: sub(getattr(tree, f.name),
                        [getattr(r, f.name) for r in rest], f.name)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(sub(v, [r[i] for r in rest], str(i))
                          for i, v in enumerate(tree))
    return tree if keep else None


def param_pspecs(params_tree, *, fsdp: bool = True, fsdp_axes="data"):
    """A tree of :class:`P` matching ``params_tree``, by the path rules;
    ``fsdp=False`` replicates the FSDP dim (pure tensor parallel)."""
    rules = _rules(fsdp_axes if fsdp else None)

    def spec_for(path, leaf):
        pstr = "/".join(path)
        for pat, spec in rules:
            if re.search(pat, pstr):
                return spec(len(_shape(leaf)))
        return P()

    return _map(spec_for, params_tree)


def batch_pspecs(batch_tree, *, batch_axes):
    """Shard the leading (batch) dim of every input over ``batch_axes``."""
    return _map(lambda _, leaf: P(batch_axes,
                                  *([None] * (len(_shape(leaf)) - 1))),
                batch_tree)


def cache_pspecs(cache_tree, *, batch_axes, mesh_batch: int):
    """KV and state cache specs: batch over the data axes where it
    divides, heads / features over ``model``; a batch of 1 (long_500k)
    shards the KV sequence over the data axes instead."""
    def spec_for(path, leaf):
        pstr = "/".join(path)
        shape = _shape(leaf)
        b_ok = len(shape) >= 2 and shape[1] % mesh_batch == 0 and \
            shape[1] >= mesh_batch
        b_ax = batch_axes if b_ok else None
        if re.search(r"/k$|/v$|cross_k$|cross_v$", pstr):
            # (n_blocks, b, s, h_kv, hd)
            s_ok = (b_ax is None and len(shape) >= 3 and
                    shape[2] % mesh_batch == 0 and shape[2] >= mesh_batch)
            return P(None, b_ax, batch_axes if s_ok else None, "model",
                     None)
        if re.search(r"/conv$", pstr):      # (n_blocks, b, d_conv-1, d_in)
            return P(None, b_ax, None, "model")
        if re.search(r"/ssm$", pstr):       # (n_blocks, b, d_in, N)
            return P(None, b_ax, "model", None)
        if re.search(r"/wkv$", pstr):       # (n_blocks, b, h, n, n)
            return P(None, b_ax, "model", None, None)
        if re.search(r"tm_last$|cm_last$", pstr):  # (n_blocks, b, d)
            return P(None, b_ax, "model")
        return P()
    return _map(spec_for, cache_tree)


def _axes_size(sizes, axes) -> int:
    if axes is None:
        return 1
    names = axes if isinstance(axes, (tuple, list)) else (axes,)
    missing = [a for a in names if a not in sizes]
    if missing:
        raise ValueError(f"spec axes {missing} are not the mesh's "
                         f"{list(sizes)}")
    return math.prod(sizes[a] for a in names)


def validate_pspecs(shape_tree, pspec_tree, mesh):
    """Drop spec axes that do not divide their dim (an explicit placement
    needs exact divisibility: whisper's vocab 51,865 on a 16-way model
    axis, 8 kv heads on 16). ``mesh``: a
    :class:`~repro_torch.launch.mesh.Mesh`, or an {axis: size} mapping to
    check specs for a mesh larger than the card. Leaves with no spec
    (None) stay None."""
    sizes = dict(getattr(mesh, "shape", mesh))

    def fix(_, leaf, spec):
        if spec is None:
            return None
        shape = _shape(leaf)
        return P(*(None if axes is not None and (
            i >= len(shape) or shape[i] % _axes_size(sizes, axes)
            or shape[i] < _axes_size(sizes, axes)) else axes
            for i, axes in enumerate(spec)))
    return _map(fix, shape_tree, pspec_tree)


def place(tree, pspec_tree, mesh):
    """``tree`` laid out by ``pspec_tree`` on ``mesh`` (the port of
    ``to_named`` + ``device_put``): the specs validated against the mesh,
    then every tensor leaf put whole on ``mesh.device`` (a tensor already
    there is returned as it is). Host arrays stay on the host; generators
    must already live on the mesh's device; fields without a spec are
    kept."""
    specs = validate_pspecs(tree, pspec_tree, mesh)

    def put(path, leaf, spec):
        if isinstance(leaf, torch.Tensor):
            return leaf.to(mesh.device)
        if _is_generators(leaf):
            if any(g.device.type != mesh.device.type for g in leaf):
                raise ValueError(f"{'/'.join(path)}: generators on "
                                 f"{leaf[0].device}, the mesh on "
                                 f"{mesh.device}")
        return leaf

    return _map(put, tree, specs, keep=True)


def fl_pspecs(stacked_tree, *, team_axis="pod", device_axis="data"):
    """Stacked-FL specs (DESIGN.md §2 mode 1): theta (M, N, ...) shards
    teams over ``team_axis`` and devices over ``device_axis``."""
    def spec_for(_, leaf):
        nd = len(_shape(leaf))
        if nd >= 2:
            return P(team_axis, device_axis, *([None] * (nd - 2)))
        return P(team_axis)
    return _map(spec_for, stacked_tree)


def store_pspecs(store_tree, *, m: int, population: int,
                 population_axis="data", sweep: bool = False,
                 sweep_axis="sweep"):
    """Device-state-store specs (DESIGN.md §11): (M, N_pop, ...) leaves
    shard the population axis over ``population_axis``, teams stay
    replicated; ``sweep=True`` adds a leading (S,) config axis over
    ``sweep_axis``. m / population tell the tier axes from model dims;
    :func:`place` drops axes that do not divide."""
    lead = (sweep_axis,) if sweep else ()
    off = len(lead)

    def spec_for(_, leaf):
        shape = _shape(leaf)
        if len(shape) >= off + 2 and shape[off] == m \
                and shape[off + 1] == population:
            return P(*lead, None, population_axis,
                     *([None] * (len(shape) - off - 2)))
        return P(*lead, *([None] * (len(shape) - off)))
    return _map(spec_for, store_tree)


def sweep_pspecs(sweep_tree, *, m: int, n: int, sweep_axis="sweep",
                 team_axis="data", device_axis="model"):
    """Sweep-stacked FL specs (DESIGN.md §6): every leaf's leading (S,)
    config axis over ``sweep_axis``; behind it (S, M, N, ...) leaves
    shard teams over ``team_axis`` and devices over ``device_axis``, (S,
    M, ...) leaves teams; anything else only the config axis. A tuple of
    the configs' generators is put on the sweep axis explicitly (no
    shape to mistake for a team axis). m, n tell the tier axes from
    model dims; :func:`place` drops axes that do not divide."""
    def spec_for(_, leaf):
        if _is_generators(leaf):
            return P(sweep_axis)
        shape = _shape(leaf)
        if len(shape) >= 3 and shape[1] == m and shape[2] == n:
            return P(sweep_axis, team_axis, device_axis,
                     *([None] * (len(shape) - 3)))
        if len(shape) >= 2 and shape[1] == m:
            return P(sweep_axis, team_axis, *([None] * (len(shape) - 2)))
        return P(sweep_axis, *([None] * (len(shape) - 1)))
    return _map(spec_for, sweep_tree)

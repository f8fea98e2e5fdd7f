"""The device-tier state store of the cohort engine.

The stacked engine holds every device's state as (M, N, ...) tiers and
runs every round over all of them, so memory, not compute, caps the
population. The cohort engine (``train.engine``, ``cohort=``) keeps the
whole population's device tier resident in a :class:`DeviceStateStore`
and, each round, gathers only the sampled cohort (M, c), runs the
unchanged algorithm round at cohort width, and scatters the updated rows
back into the resident buffers in place (``index_put_``): no round ever
copies the population. Which state fields are device-tier is the
algorithm's ``device_axes`` (PerMFL: ``theta`` and the error-feedback
residuals ``comm.ef_dev``; the personalized baselines: ``personal``).

The port's states are dataclasses of flat tier buffers, so a field is
named by its dotted path (``"comm.ef_dev"``), and a gather indexes the
N axis: dim 1, or dim 2 under a sweep's leading config axis, where the
index map is (C, M, c). Cohort index maps are sorted and distinct
(``core.participation.sample_cohort``), so ``scatter`` after ``gather``
is an exact round trip: rows never sampled are bit-unchanged, and with
``c == n`` the map is ``arange(n)`` and the gather an identity copy.
:meth:`DeviceStateStore.pspecs` gives the store's partition specs
(``sharding.specs.store_pspecs``: the population axis over the mesh's
data axis).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Tuple

import torch

__all__ = ["DeviceStateStore", "config_state", "gather_cohort",
           "scatter_cohort", "split_device_state", "state_fields"]


def _index(idx: torch.Tensor) -> tuple:
    """Advanced-indexing tuple selecting ``idx``'s rows: idx lead + (M, c)
    indexes the axis after lead + (M,) of a tier; one arange per leading
    axis, shaped to broadcast with ``idx``."""
    nd = idx.dim()
    out = []
    for d in range(nd - 1):
        shape = [1] * nd
        shape[d] = idx.shape[d]
        out.append(torch.arange(idx.shape[d],
                                device=idx.device).view(shape))
    return tuple(out) + (idx,)


def _map(fn, tree, *rest):
    """``fn`` over a tensor or over each value of a dict of tensors."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def gather_cohort(tree, idx: torch.Tensor):
    """The cohort rows of a device tier: ``tree`` a tensor or a dict of
    tensors, each lead + (M, N, ...); ``idx`` lead + (M, c) int64 on
    their device. Returns new tensors lead + (M, c, ...), row ``[.., t,
    j]`` = ``leaf[.., t, idx[.., t, j]]``."""
    ix = _index(idx)
    return _map(lambda leaf: leaf[ix], tree)


def scatter_cohort(tree, idx: torch.Tensor, update):
    """Write cohort rows back into a device tier, in place:
    ``leaf[.., t, idx[.., t]] = update_leaf[.., t]`` for every leaf, every
    row not in ``idx`` untouched. ``idx``'s rows are distinct, so the
    write is unambiguous. Returns ``tree``."""
    ix = _index(idx)

    def put(leaf, up):
        leaf[ix] = up
        return leaf

    return _map(put, tree, update)


def _get(state, path: str):
    for name in path.split("."):
        state = getattr(state, name)
    return state


def _replace(state, values: dict):
    """``state`` with the fields at dotted ``values`` paths replaced
    (nested dataclasses rebuilt, nothing copied)."""
    top = {}
    for path, v in values.items():
        head, _, tail = path.partition(".")
        top.setdefault(head, {})[tail] = v
    return dataclasses.replace(state, **{
        head: sub[""] if "" in sub else _replace(getattr(state, head), sub)
        for head, sub in top.items()})


def state_fields(state, prefix="") -> list:
    """``[(dotted path, value)]`` of every leaf field of a state
    dataclass, nested dataclasses (``comm``) descended into."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        path = prefix + f.name
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out.extend(state_fields(v, path + "."))
        else:
            out.append((path, v))
    return out


def config_state(state, i: int):
    """Config ``i``'s single-run state out of a sweep's stacked one:
    tensors are views of the stacked buffers, a tuple of generators gives
    its i-th."""
    if isinstance(state, torch.Tensor):
        return state[i]
    if isinstance(state, tuple) and state and \
            isinstance(state[0], torch.Generator):
        return state[i]
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return dataclasses.replace(state, **{
            f.name: config_state(getattr(state, f.name), i)
            for f in dataclasses.fields(state)})
    return state


def split_device_state(algo, state, m: int, n: int, *, stacked=False
                       ) -> Tuple[dict, object, Callable]:
    """Split an algorithm state into its device tier and the resident rest.

    The paths come from ``algo.device_axes(state, m, n)`` (for a sweep's
    ``stacked`` state, asked of config 0's view); ``n`` is the width of
    the device axis in this state: the population when splitting the
    store, the cohort width when splitting a round's cohort state.

    Returns ``(dev, rest, merge)``: ``{path: tensor}`` of the device-tier
    fields (lead + (M, n, ...) each), the state with those fields set to
    None, and ``merge(dev, rest)``, which puts them back.
    """
    paths = tuple(algo.device_axes(config_state(state, 0) if stacked
                                   else state, m, n))
    axis = 2 if stacked else 1
    known = dict(state_fields(state))
    dev = {}
    for path in paths:
        leaf = known.get(path)
        if not isinstance(leaf, torch.Tensor) or \
                tuple(leaf.shape[axis - 1:axis + 1]) != (m, n):
            raise ValueError(
                f"device_axes of {getattr(algo, 'name', algo)} named "
                f"{path!r}, which is not a device-tier field (lead, {m}, "
                f"{n}, ...) of the state")
        dev[path] = leaf
    rest = _replace(state, {p: None for p in paths}) if paths else state

    def merge(dev_tree, rest_state):
        """The full state: ``rest_state`` with the device tier put back."""
        return _replace(rest_state, dev_tree) if dev_tree else rest_state

    return dev, rest, merge


@dataclass
class DeviceStateStore:
    """The resident population's device tier: ``{path: tensor}`` of
    lead + (M, N, ...) buffers (``m`` / ``n`` the population's shape),
    of which a round materializes only a gathered cohort."""
    tree: dict
    m: int
    n: int

    def gather(self, idx: torch.Tensor) -> dict:
        """The cohort's rows (:func:`gather_cohort`), new tensors."""
        return gather_cohort(self.tree, idx)

    def scatter(self, idx: torch.Tensor, update: dict) -> "DeviceStateStore":
        """Write the cohort's rows back into the resident buffers in place
        (:func:`scatter_cohort`); rows never sampled stay bit-unchanged.
        Returns this store."""
        scatter_cohort(self.tree, idx, update)
        return self

    def pspecs(self, *, sweep: bool = False) -> dict:
        """Partition specs sharding the population axis over the mesh's
        data axis (:func:`repro_torch.sharding.specs.store_pspecs`);
        ``sweep`` for leaves behind a sweep's config axis."""
        from repro_torch.sharding.specs import store_pspecs
        return store_pspecs(self.tree, m=self.m, population=self.n,
                            sweep=sweep)

"""Parameters and state across the framework boundary, as numpy.

The JAX package and the port use the same parameter trees: nested dicts
with the same leaf names and shapes. These helpers carry them across as
numpy arrays (which is how the parity tests hand the reference's initial
parameters and states to the port), and bring the port's results back.
A compressed run's error-feedback residuals cross the same way: the
reference's ``CommState`` trees (ef_dev (M, N, ...), ef_team (M, ...))
become the port's flat buffers, so a JAX state can be continued. The LLM
zoo's trees cross with :func:`params_from_numpy` as they are: a
``repro.models.model.init_params`` tree (blocks stacked ``(n_blocks,
...)``) and an ``init_cache`` tree have the port's leaf names and
shapes; bfloat16 leaves (``ml_dtypes``' numpy type) arrive as
``torch.bfloat16`` bit for bit, and every leaf keeps its own type (a
bfloat16 Jamba tree's float32 ``A_log``, ``D``, ``dt_bias`` and router
stay float32). A baseline's state crosses as the
reference holds it: the global model tree ``x`` (FedAvg, Per-FedAvg,
h-SGD) or the pair ``(x, personal)`` (pFedMe and L2GD's theta, Ditto's
v). A sweep's stacked state (``FLSweepResult.state_stacked``, every leaf
leading (C,)) crosses with :func:`sweep_state_from_numpy`. An LM
trainer's ``TrainState`` (params, the optimizer's state -- sgd's (),
momentum's buffer tree, AdamW's {"m", "v", "t"} -- and the step) crosses
with :func:`train_state_from_numpy`, and comes back through
:func:`to_numpy` as {"params", "opt_state", "step"}.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comm import CommState
from repro_torch.core.baselines import BaselineState
from repro_torch.core.permfl import PerMFLState
from repro_torch.flat import Layout

__all__ = ["baseline_state_from_numpy", "comm_state_from_numpy",
           "params_from_numpy", "state_from_numpy", "sweep_state_from_numpy",
           "to_numpy", "train_state_from_numpy"]


def params_from_numpy(tree, device="cpu", dtype=None) -> dict:
    """Nested dict of arrays (numpy, anything ``np.asarray`` takes, or
    tensors) -> nested dict of tensors on ``device`` (new copies)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to(device, copy=True)
    else:
        arr = np.array(tree, copy=True)
        if arr.dtype.name == "bfloat16":       # ml_dtypes, as JAX gives it
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        t = t.to(device)
    return t if dtype is None else t.to(dtype)


def comm_state_from_numpy(comm, layout: Layout, device="cpu") -> CommState:
    """The reference's error-feedback residuals, ``{"ef_dev", "ef_team"}``
    (trees with leading (M, N) and (M,) axes; its ``CommState`` fields)
    -> the port's flat ``CommState`` on ``device``. The reference's
    threefry key has no counterpart: the new generator is seeded with 0
    (build ``CommState`` directly for another stream)."""
    ef_dev = params_from_numpy(comm["ef_dev"], device, torch.float32)
    ef_team = params_from_numpy(comm["ef_team"], device, torch.float32)
    lead_d = next(iter(_leaves(ef_dev))).shape[:2]
    lead_t = next(iter(_leaves(ef_team))).shape[:1]
    return CommState(
        ef_dev=layout.flatten(ef_dev, lead=lead_d),
        ef_team=layout.flatten(ef_team, lead=lead_t),
        gen=torch.Generator(device=torch.device(device)).manual_seed(0))


def state_from_numpy(state, device="cpu") -> PerMFLState:
    """A PerMFL state given as ``{"x", "w", "theta", "round"}`` (tiers as
    nested dicts of arrays with leading (), (M,), (M, N) axes; the
    reference's ``PerMFLState`` fields), plus ``"comm"`` for a compressed
    run (see :func:`comm_state_from_numpy`) -> the port's flat state."""
    x = params_from_numpy(state["x"], device)
    w = params_from_numpy(state["w"], device)
    theta = params_from_numpy(state["theta"], device)
    layout = Layout.of(x)
    first_w = next(iter(_leaves(w)))
    first_t = next(iter(_leaves(theta)))
    comm = state.get("comm")
    return PerMFLState(
        x=layout.flatten(x), w=layout.flatten(w, lead=first_w.shape[:1]),
        theta=layout.flatten(theta, lead=first_t.shape[:2]),
        round=int(state.get("round", 0)), layout=layout,
        comm=None if comm is None else comm_state_from_numpy(
            comm, layout, device))


def baseline_state_from_numpy(state, device="cpu",
                              round: int = 0) -> BaselineState:
    """A baseline's state as the reference holds it -- the global model
    tree ``x``, or the pair ``(x, personal)`` with the personal tree's
    leaves leading (M, N) -- as the port's flat ``BaselineState`` on
    ``device``; ``round``: the rounds done (the reference's state does
    not count them)."""
    x_tree, personal = (state if isinstance(state, (tuple, list))
                        else (state, None))
    x = params_from_numpy(x_tree, device)
    layout = Layout.of(x)
    if personal is not None:
        personal = params_from_numpy(personal, device)
        lead = next(iter(_leaves(personal))).shape[:2]
        personal = layout.flatten(personal, lead=lead)
    return BaselineState(x=layout.flatten(x), layout=layout,
                         personal=personal, round=int(round))


def sweep_state_from_numpy(state, device="cpu", round: int = 0):
    """The reference's stacked sweep state (its ``FLSweepResult.
    state_stacked`` as numpy: a PerMFL state dict as
    :func:`state_from_numpy` takes, or a baseline's ``x`` / ``(x,
    personal)``, every leaf with a leading (C,) config axis) -> the
    port's stacked state (``train.sweep.stack_states`` of the C configs'
    states). ``round`` as in :func:`baseline_state_from_numpy`."""
    from repro_torch.train.sweep import stack_states

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(take(v, i) for v in tree)
        return np.asarray(tree)[i]

    if isinstance(state, dict) and "theta" in state:
        tiers = {k: v for k, v in state.items() if k != "round"}
        c = next(iter(_leaves(tiers["x"]))).shape[0]
        done = int(np.asarray(state.get("round", 0)).reshape(-1)[0])
        return stack_states([state_from_numpy(dict(take(tiers, i),
                                                   round=done), device)
                             for i in range(c)])
    x = state[0] if isinstance(state, (tuple, list)) else state
    c = next(iter(_leaves(x))).shape[0]
    return stack_states([baseline_state_from_numpy(take(state, i), device,
                                                   round)
                         for i in range(c)])


def train_state_from_numpy(state, device="cpu"):
    """A reference ``TrainState`` (or anything with its ``params``,
    ``opt_state`` and ``step``; or a dict of those three) -> the port's
    ``TrainState`` on ``device``: the params tree, the optimizer state
    (``()``, a tree, or a dict with AdamW's int32 step ``t``) and the
    int32 step, every leaf in its own type."""
    from repro_torch.train.train_state import TrainState

    get = (state.get if isinstance(state, dict)
           else lambda k: getattr(state, k))
    opt = get("opt_state")
    if isinstance(opt, (tuple, list)) and not opt:
        opt = ()
    else:
        opt = params_from_numpy(opt, device)
    return TrainState(params=params_from_numpy(get("params"), device),
                      opt_state=opt,
                      step=params_from_numpy(get("step"), device))


def to_numpy(obj):
    """Tensors, nested dicts of tensors, a ``PerMFLState`` (as ``{"x",
    "w", "theta", "round"}`` of nested numpy dicts, plus ``"comm":
    {"ef_dev", "ef_team"}`` for a compressed run), or a ``BaselineState``
    (as the reference's state: the tree ``x``, or ``(x, personal)``), or
    a ``TrainState`` (as {"params", "opt_state", "step"}) -> numpy."""
    from repro_torch.train.train_state import TrainState

    if isinstance(obj, TrainState):
        return {"params": to_numpy(obj.params),
                "opt_state": (() if isinstance(obj.opt_state, tuple)
                              else to_numpy(obj.opt_state)),
                "step": to_numpy(obj.step)}
    if isinstance(obj, BaselineState):
        x = to_numpy(obj.params("x"))
        if obj.personal is None:
            return x
        return x, to_numpy(obj.params("personal"))
    if isinstance(obj, PerMFLState):
        out = {"x": to_numpy(obj.params("x")),
               "w": to_numpy(obj.params("w")),
               "theta": to_numpy(obj.params("theta")),
               "round": obj.round}
        if obj.comm is not None:
            out["comm"] = {
                "ef_dev": to_numpy(obj.layout.unflatten(obj.comm.ef_dev)),
                "ef_team": to_numpy(obj.layout.unflatten(obj.comm.ef_team))}
        return out
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree

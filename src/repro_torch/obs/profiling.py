"""Profiling hooks: a FLOP count of one round and ``torch.profiler``
traces.

Both are host-side and opt-in via `TraceConfig`; neither changes what a
round computes. ``profile_ctx`` wraps the experiment's rounds in
``torch.profiler`` (CPU activity, and CUDA activity when a card is
present) and exports a Chrome trace into ``TraceConfig.profile_dir``,
where the card's kernels appear by name. ``compiled_cost`` stands in for
the reference's, which reads XLA's cost analysis of the compiled
program: PyTorch compiles nothing, so it counts FLOPs instead.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pathlib

import torch

__all__ = ["compiled_cost", "profile_ctx"]

_TRACES = itertools.count()


@contextlib.contextmanager
def profile_ctx(trace):
    """``torch.profiler.profile`` around the body when ``trace`` (a
    `TraceConfig`) names a ``profile_dir``; the trace is exported on exit
    to ``<profile_dir>/torch-<pid>-<n>.trace.json``. Otherwise a null
    context. Yields the profiler, or None."""
    out = getattr(trace, "profile_dir", None) if trace is not None else None
    if not out:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    path = pathlib.Path(out) / \
        f"torch-{os.getpid()}-{next(_TRACES)}.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


def compiled_cost(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), {"flops": ...})``: the call's result and
    the FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts in it.

    What it counts: the matmuls and convolutions of the call (forward and
    the backward autograd runs inside it), as PyTorch's FLOP formulas
    give them -- for one round of the engine, every device's products.
    It is not the reference's XLA cost analysis: no per-dispatch flops
    of every op, no bytes accessed and no transcendentals, so those keys
    are left out, and elementwise work and the port's own CUDA kernels
    (launched outside PyTorch's operators) count nothing.
    """
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, {"flops": float(counter.get_total_flops())}

"""Kernel dispatch for the PyTorch port, and the kernels' launch counts.

Every kernel package under ``repro_torch.kernels`` holds a CUDA kernel
written for Hopper and its plain PyTorch version (``ref.py``). Which one
runs follows the device of the tensors it is given:

  * ``CUDA``  -- the hand-written kernel; for tensors on a CUDA device.
  * ``TORCH`` -- the plain PyTorch version; for tensors on the CPU.

An explicit ``mode="torch"`` runs the plain version on any device. It
exists so that a comparison (``chip_smoke.py``, the GPU-marked tests)
can hold the kernel against its plain version on the card. No
environment variable switches the main path: a CUDA tensor launches the
kernel or raises, and nothing falls back to the plain version.

``LAUNCHES`` counts, per kernel name, the launches each wrapper made: a
run can read it to show that its main path went through the kernels.

Every kernel op is a *seam* (:func:`seam`): under an active work
counter (``repro_torch.roofline.op_analysis.OpCounter``, kept in
``RECORDERS``) it records its family's work once a call, computed from
shapes and types (``repro_torch.roofline.kernels``), and the counter
does not count the plain version's ops beneath it; on fake tensors
(``FakeTensorMode``: a dry run) it returns outputs of the kernel's
shapes and types without running anything. A fake tensor stands for one
on the card: :func:`kernel_mode` gives it the kernel's path, so a dry run
takes the card's route through the model. With real tensors and no
counter a seam is the plain call.

A kernel returns new tensors with no ``grad_fn``. A kernel op that has
no backward (the wire compressors and ``quantize``: nothing trains
through them) calls :func:`refuse_grad` before it launches, so that a
caller who asked for a gradient gets an error and not a silently
detached result.
"""
from __future__ import annotations

import contextlib
import functools
from enum import Enum

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["KernelType", "LAUNCHES", "RECORDERS", "count_launch", "is_fake",
           "kernel_mode", "refuse_grad", "reset_launches", "seam",
           "vec_aligned"]


class KernelType(Enum):
    """Which implementation of a kernel runs (see module docstring)."""
    CUDA = "cuda"
    TORCH = "torch"


# kernel name -> launches since the last reset_launches()
LAUNCHES: dict = {}
# the active work counters, innermost last (an OpCounter appends itself
# when entered and removes itself when left)
RECORDERS: list = []


def is_fake(tensor) -> bool:
    """True for a ``FakeTensor`` (shapes and types, no storage)."""
    return isinstance(tensor, FakeTensor)


def seam(name, work, fake):
    """Decorate a kernel op as a seam (module docstring): ``name`` (a
    kernel family, or a function of the op's arguments giving it) and
    ``work``, a function of the op's arguments giving its
    ``roofline.kernels.Work``, are recorded under the innermost counter of
    ``RECORDERS``; ``fake``, a function of the op's arguments, gives its
    outputs when one of its tensor arguments is fake."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            faked = any(is_fake(a) for a in (*args, *kw.values()))
            if not (RECORDERS or faked):
                return fn(*args, **kw)
            rec = (RECORDERS[-1].kernel(
                name(*args, **kw) if callable(name) else name,
                lambda: work(*args, **kw))
                if RECORDERS else contextlib.nullcontext())
            with rec:
                return fake(*args, **kw) if faked else fn(*args, **kw)
        return call
    return wrap


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name``: called by a wrapper right where
    it launches its kernel, and nowhere else."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` (None entries skipped) requires a gradient: kernel
    ``name`` has no backward, and its outputs would carry none."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward (nothing trains "
            f"through it); run it under torch.no_grad(), or differentiate "
            f"the plain version (mode='torch')")


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_mode(tensor: torch.Tensor, mode=None) -> KernelType:
    """The implementation that runs on ``tensor``.

    ``mode`` None follows the tensor's device: CUDA kernel for a CUDA
    tensor or a fake one (a dry run stands for the card), plain version
    for a CPU tensor. ``mode`` "torch" (or
    ``KernelType.TORCH``) forces the plain version; "cuda" demands the
    kernel and raises for a tensor that is not on a CUDA device.
    """
    dev = "cuda" if is_fake(tensor) else tensor.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for tensors on {tensor.device}")
    if mode is None:
        return KernelType.CUDA if dev == "cuda" else KernelType.TORCH
    if not isinstance(mode, KernelType):
        try:
            mode = KernelType(str(mode).strip().lower())
        except ValueError:
            raise ValueError(
                f"unknown kernel mode {mode!r}; expected one of "
                f"{[t.value for t in KernelType]}") from None
    if mode is KernelType.CUDA and dev != "cuda":
        raise ValueError(f"mode='cuda' needs CUDA tensors, got {dev}")
    return mode


def vec_aligned(*tensors) -> bool:
    """True when 16-byte vector accesses are valid for every 2-D operand:
    the data pointer and every row start 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        if t.shape[0] > 1 and (t.stride(0) * t.element_size()) % 16:
            return False
    return True

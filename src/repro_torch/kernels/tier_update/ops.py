"""PerMFL's team and server updates at LLM scale (paper eqs. 9 and 13):
CUDA kernel or plain version.

Two wrappers over one kernel (``csrc/tier_update.cu``):

  * :func:`tier_update` -- one leaf: (w', x') from w, x and theta in one
    pass, new outputs.
  * :func:`tier_update_tree` -- a parameter tree (nested dicts), leaf by
    leaf through :func:`tier_update`: one launch per leaf; the tier
    round's updates (``repro_torch.train.trainer.make_tier_round``).

Which implementation runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors or for an
explicit ``mode="torch"``. Each launch adds one to
``LAUNCHES["tier_update"]``.

:func:`tier_update` is a seam (:func:`repro_torch.kernels.interface.
seam`): it records ``roofline.kernels.tier_update`` under an active work
counter and returns outputs of its shapes on fake tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import (KernelType, count_launch,
                                           kernel_mode, refuse_grad, seam,
                                           vec_aligned)
from repro_torch.kernels.tier_update.ref import tier_update_ref
from repro_torch.roofline import kernels as work

__all__ = ["tier_update", "tier_update_tree"]

_NAME = "tier_update"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    fn = load(_NAME).tier_update
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int64] + [ctypes.c_float] * 5
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(w, x, theta):
    for name, t in (("x", x), ("theta", theta)):
        if t.dtype != w.dtype:
            raise TypeError(f"{name} is {t.dtype}, w is {w.dtype}")
        if t.shape != w.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != w "
                             f"{tuple(w.shape)}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")


@seam(_NAME, lambda w, *_, **__: work.tier_update(w.numel(),
                                                  w.element_size()),
      lambda w, x, *_, **__: (w.new_empty(w.shape), x.new_empty(x.shape)))
def tier_update(w, x, theta, *, eta, lam, gamma, beta, mode=None):
    """Eqs. 9 and 13 on one leaf: w, x and theta tensors of one shape and
    type (float32 or bfloat16 on CUDA; they may be the same tensor), eta,
    lam, gamma and beta floats. Returns new (w', x') and leaves the
    inputs as they are. On CUDA the operands must be contiguous; the
    result is the plain version's bit for bit."""
    _check(w, x, theta)
    if kernel_mode(w, mode) is KernelType.TORCH:
        return tier_update_ref(w, x, theta, eta=eta, lam=lam, gamma=gamma,
                               beta=beta)
    if w.dtype not in _DTYPE_CODES:
        raise TypeError(f"tier_update takes float32 or bfloat16, got "
                        f"{w.dtype}")
    for name, t in (("w", w), ("x", x), ("theta", theta)):
        if not t.is_contiguous():
            raise ValueError(f"tier_update kernel needs contiguous {name}")
    refuse_grad(_NAME, w, x, theta)
    w_out, x_out = torch.empty_like(w), torch.empty_like(x)
    n = w.numel()
    if n:
        flat = [t.view(1, -1) for t in (w_out, x_out, w, x, theta)]
        fn = _library()
        stream = torch.cuda.current_stream(w.device).cuda_stream
        count_launch(_NAME)
        # the scalars as the plain version's eager kernels get them: each
        # Python product in double, cast to float32 by the call
        err = fn(_DTYPE_CODES[w.dtype], w_out.data_ptr(), x_out.data_ptr(),
                 w.data_ptr(), x.data_ptr(), theta.data_ptr(), n,
                 1.0 - eta * lam - eta * gamma, eta * gamma, lam * eta,
                 1 - beta * gamma, beta * gamma, int(vec_aligned(*flat)),
                 stream)
        if err:
            raise RuntimeError(f"tier_update kernel launch failed: CUDA "
                               f"error {err} (n={n})")
    return w_out, x_out


def tier_update_tree(w, x, theta, *, eta, lam, gamma, beta, mode=None):
    """The team update (eq. 9) and the server update (eq. 13) over a
    parameter tree: nested dicts of tensors, ``x`` and ``theta`` of w's
    structure, leaf by leaf through :func:`tier_update` (one kernel
    launch per leaf on the card). Returns (w', x') as new trees; the
    inputs, which may be one tree, are left as they are. Raises on
    trees of different structure, and on leaves of different shape,
    type or device."""
    if isinstance(w, dict):
        for name, t in (("x", x), ("theta", theta)):
            if not isinstance(t, dict) or t.keys() != w.keys():
                raise ValueError(f"{name}'s tree does not match w's: "
                                 f"{sorted(w)} against "
                                 f"{sorted(t) if isinstance(t, dict) else t}")
        out = {k: tier_update_tree(v, x[k], theta[k], eta=eta, lam=lam,
                                   gamma=gamma, beta=beta, mode=mode)
               for k, v in w.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    for name, t in (("x", x), ("theta", theta)):
        if isinstance(t, dict):
            raise ValueError(f"{name} has a subtree where w has a leaf")
    return tier_update(w, x, theta, eta=eta, lam=lam, gamma=gamma,
                       beta=beta, mode=mode)

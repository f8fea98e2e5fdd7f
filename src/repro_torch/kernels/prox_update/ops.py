"""The PerMFL device step (paper eq. 4): CUDA kernel or plain version.

Three wrappers over one kernel (``csrc/prox_update.cu``):

  * :func:`prox_sgd` -- one tensor of any shape, new outputs; the port of
    the reference's single-array ``prox_sgd``.
  * :func:`prox_sgd_tree` -- a parameter tree (nested dicts), leaf by
    leaf through :func:`prox_sgd`: one launch per leaf; the LLM trainers'
    device step (``repro_torch.train.trainer``).
  * :func:`prox_step_` -- the op the round runs: the whole stacked device
    tier as one (rows, cols) tensor, updated in place by one launch, with
    the anchor given per team (one anchor row for every ``rows //
    anchor_rows`` device rows).

Which implementation runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors or for an
explicit ``mode="torch"``. Each launch adds one to
``LAUNCHES["prox_update"]``.

:func:`prox_sgd` and :func:`prox_step_` are seams
(:func:`repro_torch.kernels.interface.seam`): each records
``roofline.kernels.prox_update`` under an active work counter and
returns outputs of its shapes (the in-place step its own operands) on
fake tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import (KernelType, count_launch,
                                           kernel_mode, seam, vec_aligned)
from repro_torch.kernels.prox_update.ref import prox_sgd_ref
from repro_torch.roofline import kernels as work

__all__ = ["prox_sgd", "prox_sgd_tree", "prox_step_"]

_NAME = "prox_update"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    lib = load(_NAME)
    fn = lib.prox_update
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int64] * 7 + [ctypes.c_void_p] * 2
                       + [ctypes.c_int64] + [ctypes.c_float] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(out, theta, grad, anchor, m_out, mom, *, alpha, lam, momentum,
            weight_decay):
    """Launch the kernel on 2-D CUDA operands whose columns are unit
    stride; ``out``/``m_out`` may be ``theta``/``mom`` themselves.
    ``alpha`` / ``lam``: floats (passed by value) or (G,) float32 tensors
    on the card (read by the kernel, row r from entry r // (rows // G))."""
    rows, cols = theta.shape
    use_mom = momentum > 0.0
    moms = (m_out, mom) if use_mom else ()
    vec = vec_aligned(out, theta, grad, anchor, *moms)
    per_group = isinstance(alpha, torch.Tensor)
    fn = _library()
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[theta.dtype], out.data_ptr(), theta.data_ptr(),
             grad.data_ptr(), anchor.data_ptr(),
             m_out.data_ptr() if use_mom else None,
             mom.data_ptr() if use_mom else None,
             rows, cols, theta.stride(0), grad.stride(0), anchor.stride(0),
             mom.stride(0) if use_mom else 0, rows // anchor.shape[0],
             alpha.data_ptr() if per_group else None,
             lam.data_ptr() if per_group else None,
             rows // alpha.shape[0] if per_group else 0,
             0.0 if per_group else float(alpha),
             0.0 if per_group else float(lam), float(momentum),
             float(weight_decay), int(vec), stream)
    if err:
        raise RuntimeError(f"prox_update kernel launch failed: CUDA error "
                           f"{err} (rows={rows}, cols={cols})")


def _check_groups(alpha, lam, rows, anchor_rows, device):
    """Both floats, or both contiguous (G,) float32 tensors on ``device``
    with G dividing the anchor rows (so each anchor row, and each row,
    lies in one group)."""
    tensors = [isinstance(v, torch.Tensor) for v in (alpha, lam)]
    if not any(tensors):
        return
    if not all(tensors):
        raise TypeError("alpha and lam must both be floats or both tensors")
    if alpha.shape != lam.shape or alpha.dim() != 1:
        raise ValueError(f"per-group alpha {tuple(alpha.shape)} and lam "
                         f"{tuple(lam.shape)} must be (G,)")
    for name, v in (("alpha", alpha), ("lam", lam)):
        if v.dtype != torch.float32 or v.device != device or \
                not v.is_contiguous():
            raise ValueError(f"per-group {name} must be a contiguous "
                             f"float32 tensor on {device}")
    g = alpha.shape[0]
    if g < 1 or anchor_rows % g or rows % g:
        raise ValueError(f"{g} hyperparameter groups do not tile {rows} "
                         f"rows and {anchor_rows} anchor rows")


def _check(theta, grad, anchor, mom, momentum):
    if theta.dtype not in _DTYPE_CODES:
        raise TypeError(f"prox_update takes float32 or bfloat16, got "
                        f"{theta.dtype}")
    for name, t in (("grad", grad), ("anchor", anchor)):
        if t.dtype != theta.dtype:
            raise TypeError(f"{name} is {t.dtype}, theta is {theta.dtype}")
    if grad.shape != theta.shape:
        raise ValueError(f"grad {tuple(grad.shape)} != theta "
                         f"{tuple(theta.shape)}")
    if momentum > 0.0:
        if mom is None:
            raise ValueError("momentum > 0 needs a momentum buffer")
        if mom.dtype != torch.float32 or mom.shape != theta.shape:
            raise ValueError(f"momentum buffer must be float32 of shape "
                             f"{tuple(theta.shape)}, got {mom.dtype} "
                             f"{tuple(mom.shape)}")
    devs = {t.device for t in (theta, grad, anchor, mom) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _sgd_fake(theta, grad, anchor, mom_buf=None, *, momentum=0.0, **_):
    if momentum > 0.0:
        return theta.new_empty(theta.shape), \
            theta.new_empty(theta.shape, dtype=torch.float32)
    return theta.new_empty(theta.shape), \
        _zeros(theta, momentum) if mom_buf is None else mom_buf


@seam(_NAME, lambda theta, *_, momentum=0.0, **__: work.prox_update(
    1, theta.numel(), itemsize=theta.element_size(), anchor_rows=1,
    momentum=momentum > 0.0), _sgd_fake)
def prox_sgd(theta, grad, anchor, mom_buf=None, *, alpha, lam,
             momentum=0.0, weight_decay=0.0, mode=None):
    """One tensor of any shape; theta/grad/anchor share shape and dtype;
    alpha, lam: floats (per-group values are :func:`prox_step_`'s).
    Returns new (theta, mom) and leaves the inputs as they are; with
    ``momentum == 0`` the returned buffer is ``mom_buf`` itself (if None,
    float32 zeros expanded to theta's shape with stride 0: no memory).
    On CUDA the operands must be contiguous (``mom_buf`` only when
    momentum > 0: the kernel reads it then only)."""
    alpha, lam = float(alpha), float(lam)
    if mom_buf is None:
        mom_buf = _zeros(theta, momentum)
    if anchor.shape != theta.shape:
        raise ValueError(f"anchor {tuple(anchor.shape)} != theta "
                         f"{tuple(theta.shape)}")
    _check(theta, grad, anchor, mom_buf, momentum)
    if kernel_mode(theta, mode) is KernelType.TORCH:
        return prox_sgd_ref(theta, grad, anchor, mom_buf=mom_buf,
                            alpha=alpha, lam=lam, momentum=momentum,
                            weight_decay=weight_decay)
    for name, t in (("theta", theta), ("grad", grad), ("anchor", anchor),
                    ("mom_buf", mom_buf if momentum > 0.0 else theta)):
        if not t.is_contiguous():
            raise ValueError(f"prox_sgd kernel needs contiguous {name}")
    out = torch.empty_like(theta)
    m_out = torch.empty_like(mom_buf) if momentum > 0.0 else mom_buf
    if theta.numel():
        flat = lambda t: t.view(1, -1)
        _launch(flat(out), flat(theta), flat(grad), flat(anchor),
                flat(m_out), flat(mom_buf), alpha=alpha, lam=lam,
                momentum=momentum, weight_decay=weight_decay)
    return out, m_out


def _zeros(theta, momentum):
    """A float32 zero buffer of theta's shape: allocated when momentum > 0
    (the step reads and replaces it), else one zero expanded (stride 0)."""
    if momentum > 0.0:
        return torch.zeros(theta.shape, dtype=torch.float32,
                           device=theta.device)
    return torch.zeros((), dtype=torch.float32,
                       device=theta.device).expand(theta.shape)


def prox_sgd_tree(theta, grad, anchor, mom_tree=None, *, alpha, lam,
                  momentum=0.0, weight_decay=0.0, mode=None):
    """The PerMFL device step (eq. 4) over a parameter tree: nested dicts
    of tensors, ``grad`` and ``anchor`` (and ``mom_tree``) of theta's
    structure, leaf by leaf through :func:`prox_sgd` (one kernel launch
    per leaf on the card). Returns (theta', mom_tree') as new trees, the
    inputs left as they are, as the reference's ``prox_sgd_tree``; with
    ``mom_tree`` None and ``momentum == 0`` each returned buffer is zeros
    expanded with stride 0, so a full-width tree costs no float32 copy."""
    if isinstance(theta, dict):
        out = {k: prox_sgd_tree(
            v, grad[k], anchor[k], None if mom_tree is None else mom_tree[k],
            alpha=alpha, lam=lam, momentum=momentum,
            weight_decay=weight_decay, mode=mode) for k, v in theta.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return prox_sgd(theta, grad, anchor, mom_tree, alpha=alpha, lam=lam,
                    momentum=momentum, weight_decay=weight_decay, mode=mode)


def _step_work(theta, grad, anchor, mom=None, *, alpha, momentum=0.0,
               **_):
    return work.prox_update(
        *theta.shape, itemsize=theta.element_size(),
        anchor_rows=anchor.shape[0], momentum=momentum > 0.0,
        groups=alpha.shape[0] if isinstance(alpha, torch.Tensor) else 0)


@torch.no_grad()
@seam(_NAME, _step_work,
      lambda theta, grad, anchor, mom=None, **_: (theta, mom))
def prox_step_(theta, grad, anchor, mom=None, *, alpha, lam, momentum=0.0,
               weight_decay=0.0, mode=None):
    """The stacked device step, in place: one launch for all devices.

    theta, grad: (rows, cols); anchor: (anchor_rows, cols) with
    ``rows % anchor_rows == 0``, device row r anchored to anchor row
    ``r // (rows // anchor_rows)`` -- the team tier w (M, P) for the
    device tier theta (M*N, P). alpha, lam: floats, or (G,) float32
    tensors on theta's device with G dividing ``anchor_rows``, row r
    taking entry ``r // (rows // G)``. mom: (rows, cols) float32, needed when
    ``momentum > 0``. Rows may be strided (a padded row length); columns
    must be unit stride.

    theta (and mom, when momentum > 0) are overwritten with the updated
    values, which saves a buffer of the tier's size per step; the
    caller's autograd graph must not need their old values. Returns
    (theta, mom).
    """
    _check(theta, grad, anchor, mom, momentum)
    if theta.dim() != 2 or anchor.dim() != 2 or grad.dim() != 2:
        raise ValueError("prox_step_ takes 2-D (rows, cols) operands")
    rows, cols = theta.shape
    if anchor.shape[1] != cols or anchor.shape[0] < 1 \
            or rows % anchor.shape[0]:
        raise ValueError(f"anchor {tuple(anchor.shape)} does not tile "
                         f"theta {tuple(theta.shape)} by rows")
    _check_groups(alpha, lam, rows, anchor.shape[0], theta.device)
    ops = (theta, grad, anchor) + ((mom,) if momentum > 0.0 else ())
    if any(t.stride(1) != 1 for t in ops):
        raise ValueError("prox_step_ needs unit-stride columns")
    if kernel_mode(theta, mode) is KernelType.TORCH:
        q = rows // anchor.shape[0]
        # per-group values, one per anchor row
        a, lm = ((v.repeat_interleave(anchor.shape[0] // v.shape[0])
                  if isinstance(v, torch.Tensor) else v)
                 for v in (alpha, lam))
        new, mb = prox_sgd_ref(
            theta.unflatten(0, (-1, q)), grad.unflatten(0, (-1, q)),
            anchor[:, None], alpha=a, lam=lm, momentum=momentum,
            mom_buf=None if mom is None else mom.unflatten(0, (-1, q)),
            weight_decay=weight_decay)
        theta.copy_(new.flatten(0, 1))
        if momentum > 0.0:
            mom.copy_(mb.flatten(0, 1))
        return theta, mom
    if rows and cols:
        _launch(theta, theta, grad, anchor, mom, mom, alpha=alpha, lam=lam,
                momentum=momentum, weight_decay=weight_decay)
    return theta, mom

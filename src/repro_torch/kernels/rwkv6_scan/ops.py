"""Public WKV-6 op: the CUDA scan kernel or its plain version.

:func:`wkv` takes r, k, v, w (b, t, h, n), u (h, n) and an optional
float32 state (b, h, n, n), and returns the output in r's type and the
final state in float32. Which implementation runs follows the tensors'
device (:func:`repro_torch.kernels.interface.kernel_mode`): the kernel
(``csrc/rwkv6_scan.cu``) for CUDA tensors, the plain version (``ref.py``)
for CPU tensors or an explicit ``mode="torch"``. The kernel takes r, k, v
in float32 or bfloat16 (one type for the three) and w in float32 or
bfloat16 (its own type, never rounded: the model's decay is float32),
head size n in :data:`HEAD_SIZES`, and raises for anything else; there
is no fallback to the plain version for a CUDA tensor. ``out_state``
names where the final state goes, and may be ``state`` itself (the
model's recurrent cache, updated in place). Each launch adds one to
``LAUNCHES["rwkv6_scan"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

__all__ = ["HEAD_SIZES", "KERNELS", "launch", "wkv"]

_NAME = "rwkv6_scan"
KERNELS = (_NAME,)
HEAD_SIZES = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    fn = load(_NAME).rwkv6_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state, out_state):
    if r.dim() != 4:
        raise ValueError(f"wkv takes (b, t, h, n) r, k, v, w; r is "
                         f"{tuple(r.shape)}")
    b, t, h, n = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} {tuple(x.shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape != (h, n):
        raise ValueError(f"u {tuple(u.shape)} is not (h, n) = {(h, n)}")
    for name, s in (("state", state), ("out_state", out_state)):
        if s is not None and s.shape != (b, h, n, n):
            raise ValueError(f"{name} {tuple(s.shape)} is not (b, h, n, n) "
                             f"= {(b, h, n, n)}")
    devs = {x.device for x in (r, k, v, w, u, state, out_state)
            if x is not None}
    if len(devs) != 1:
        raise ValueError(f"wkv operands on several devices: {devs}")


def launch(r, k, v, w, u, state, out, out_state):
    """One launch of the kernel into given outputs: r, k, v, w (b, t, h,
    n) and ``out`` (r's shape and type), u (h, n) float32, ``state``
    (float32 (b, h, n, n), or None for zeros) and ``out_state`` (the
    same; may be ``state``), all contiguous on one CUDA device. Checks
    what the kernel takes, head size first, and raises before building
    or launching anything it would refuse."""
    b, t, h, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan kernel takes head size n in "
                         f"{HEAD_SIZES}, got {n}")
    if r.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"rwkv6_scan kernel takes float32 or bfloat16 r and "
                        f"w, got {r.dtype} and {w.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype or out.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan kernel takes r, k, v, out in one type, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}, {out.dtype}")
    floats = [u, out_state] + ([] if state is None else [state])
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError("rwkv6_scan kernel takes u and the states in float32")
    if not all(x.is_contiguous() for x in [r, k, v, w, out] + floats):
        raise ValueError("rwkv6_scan kernel takes contiguous operands")
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan kernel needs CUDA tensors, got "
                         f"{r.device}")
    if b * h == 0:
        return
    fn = _library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[r.dtype], _DTYPE_CODES[w.dtype], n, r.data_ptr(),
             k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
             None if state is None else state.data_ptr(), out.data_ptr(),
             out_state.data_ptr(), b, t, h, stream)
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err} (r {tuple(r.shape)} {r.dtype}, w "
                           f"{w.dtype})")


def wkv(r, k, v, w, u, state=None, *, out_state=None, mode=None):
    """WKV-6 scan over (b, t, h, n) inputs from ``state`` (None: zeros).
    Returns (out (b, t, h, n) in r's dtype, final state (b, h, n, n)
    float32): ``out_state`` when given (written in place; it may be
    ``state``), else a new tensor."""
    _check(r, k, v, w, u, state, out_state)
    if kernel_mode(r, mode) is KernelType.TORCH:
        out, s = wkv6_ref(r, k, v, w, u, state)
        if out_state is None:
            return out, s
        return out, out_state.copy_(s)
    b, t, h, n = r.shape
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    if state is not None:
        state = state.to(torch.float32).contiguous()
    if out_state is None:
        out_state = torch.empty((b, h, n, n), dtype=torch.float32,
                                device=r.device)
    out = torch.empty((b, t, h, n), dtype=r.dtype, device=r.device)
    launch(r, k, v, w, u, state, out, out_state)
    return out, out_state

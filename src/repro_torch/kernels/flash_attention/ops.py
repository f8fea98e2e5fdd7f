"""Public attention op: the CUDA flash-attention kernel or its plain
version.

:func:`attention` takes q (b, sq, hq, d) and k, v (b, skv, hkv, d) in the
reference's (batch, sequence, head, dim) layout, float32 or bfloat16, q
and k/v each in its own type; the output has q's shape and type. Which
implementation runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel
(``csrc/flash_attention.cu``) for CUDA tensors, the plain version
(``ref.py``) for CPU tensors or an explicit ``mode="torch"``. The kernel
reads q, k and v through their strides (unit stride along d) and takes
head_dim 32, 64, 96 or 128; it raises for anything else. Each launch
adds one to ``LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import attention_ref, sm_scale
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode

__all__ = ["HEAD_DIMS", "KERNELS", "attention"]

_NAME = "flash_attention"
KERNELS = (_NAME,)
HEAD_DIMS = (32, 64, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    fn = load(_NAME).flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention takes 4-D (b, s, h, d) q, k and v")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "differ in batch or head_dim")
    if k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"{hq} q-heads are not a multiple of "
                         f"{k.shape[2]} kv-heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"attention takes float32 or bfloat16, {name} "
                            f"is {t.dtype}")
    if k.dtype != v.dtype:
        raise TypeError(f"k is {k.dtype}, v is {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v on several devices")


def _aligned(t) -> bool:
    """Every (b, s, h) row of ``t`` starts on a 16-byte boundary."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * es) % 16 == 0 for i in range(3))


def attention(q, k, v, *, causal=True, window=0, q_offset=None, mode=None):
    """Multi-head (optionally causal / windowed) attention over (b, s, h,
    d) tensors, GQA-aware: q-head h reads kv-head ``h // (hq // hkv)``.

    ``q_offset`` is the absolute position of q[:, 0] (a Python int):
    None means ``skv - sq`` (aligned to the end); decode passes the cache
    position. ``window`` > 0 lets a query see only the ``window`` keys
    up to its own position.
    """
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q_offset = skv - sq if q_offset is None else int(q_offset)
    if kernel_mode(q, mode) is KernelType.TORCH:
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs unit stride along d")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 "
                         f"batch rows and heads, got {b} x {hq}")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or skv == 0:
        return out.zero_()
    fn = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], d, q.data_ptr(),
             k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], q_offset, int(bool(causal)), int(window),
             sm_scale(d), int(_aligned(k) and _aligned(v)), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    return out

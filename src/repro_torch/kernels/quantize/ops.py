"""Stochastic int8 quantize of flat sender rows: the CUDA kernel or its
plain version.

:func:`quantize_int8` takes a batch of senders as (B, C) float32 rows
(unit column stride; rows may be strided) and a :class:`Segments` table
of the leaves in them, and quantizes each leaf of each sender over the
leaf's own 128-value rows -- as the reference's ``quantize_int8`` does
for one flattened leaf -- in ONE launch for every (sender, leaf) pair. A
one-segment table (the default) quantizes the whole row as one leaf, the
reference's "flatten anything" form. q and dq have the rows' shape;
columns past the last leaf read 0. scales are (B, rows), ``rows``
counting each leaf's wire rows in leaf order.

Two callers launch it: the int8 uplinks without error feedback
(``repro_torch.comm``) and the int8 export of the serving store
(``repro_torch.serve.store``, noise 0.5: round to nearest). The error-
feedback uplink (``repro_torch.kernels.compress.ef_int8``) launches the
same kernel template with the residual fused in, through
:func:`quantize_rows`.

Which version runs follows the tensors' device: the kernel
(``compress/csrc/compress.cu``, ``int8_kernel``) for CUDA tensors, the
plain version (``ref.py``) for CPU tensors or ``mode="torch"``. Each
launch adds one to ``LAUNCHES["quantize"]`` (``"ef_int8"`` with error
feedback). Like the reference's op, :func:`quantize_int8` has no custom
gradient.

:func:`quantize_rows` is a seam (:func:`repro_torch.kernels.interface.seam`):
it records ``roofline.kernels.compress`` ("quantize" or "ef_int8") under
an active work counter and returns empty outputs of its shapes on fake
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import (KernelType, count_launch,
                                           kernel_mode, refuse_grad, seam,
                                           vec_aligned)
from repro_torch.kernels.quantize import ref as R
from repro_torch.kernels.segments import (Segments, check_rows,
                                          leaf_columns, raise_on, segments,
                                          senders_ok, stream)
from repro_torch.roofline import kernels as work

__all__ = ["KERNELS", "dequantize_int8", "quantize_int8", "quantize_rows",
           "row_of_column"]

# launch-count names of the kernels this module launches
KERNELS = ("quantize",)


def _function():
    fn = load("compress").compress_int8
    if fn.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p] * 8 + [i] + [n] * 8 + [i, p]
        fn.restype = ctypes.c_int
    return fn


def _int8_name(v, ef, *_):
    return "quantize" if ef is None else "ef_int8"


def _int8_work(v, ef, noise, segs, mode=None):
    # a stride-0 noise row (the store export's constant) is read once
    return work.compress(_int8_name(v, ef), v.shape[0], v.shape[1],
                         segs.end, len(segs.lengths), segs.rows,
                         1 if noise.stride(0) == 0 else None)


def _int8_fake(v, ef, noise, segs, mode=None):
    f32 = lambda: v.new_empty(v.shape, dtype=torch.float32)  # noqa: E731
    return (v.new_empty(v.shape, dtype=torch.int8),
            v.new_empty((v.shape[0], segs.rows), dtype=torch.float32), f32(),
            None if ef is None else f32())


@seam(_int8_name, _int8_work, _int8_fake)
def quantize_rows(v, ef, noise, segs: Segments, mode=None):
    """The int8 launch: msg = v (+ ef, where ``ef`` is given); returns
    (q int8 (B, C), scales (B, segs.rows), dq (B, C), ef_new = msg - dq
    or None). Columns past the last leaf read q 0, dq 0, ef_new msg."""
    check_rows(segs, v=v, ef=ef, noise=noise)
    b = v.shape[0]
    q = torch.empty(v.shape, dtype=torch.int8, device=v.device)
    scales = torch.empty((b, segs.rows), dtype=torch.float32,
                         device=v.device)
    dq = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    ef_new = None
    if kernel_mode(v, mode) is KernelType.CUDA:
        refuse_grad("quantize", v, ef, noise)
    if kernel_mode(v, mode) is KernelType.TORCH:
        msg = v if ef is None else v + ef
        for i, sl, _ in leaf_columns(segs):
            qi, si, di = R.quantize_int8_ref(msg[:, sl], noise[:, sl])
            r0 = segs.row0[i]
            q[:, sl], dq[:, sl] = qi, di
            scales[:, r0:r0 + si.shape[1]] = si
        e = segs.end
        q[:, e:] = 0
        dq[:, e:] = 0.0
        if ef is not None:
            ef_new = msg - dq
    elif senders_ok(v):
        name = "quantize" if ef is None else "ef_int8"
        if ef is not None:
            ef_new = torch.empty_like(dq)
        ops = (v, noise, q, dq) + (() if ef is None else (ef, ef_new))
        fn = _function()
        count_launch(name)
        err = fn(v.data_ptr(), None if ef is None else ef.data_ptr(),
                 noise.data_ptr(), q.data_ptr(), scales.data_ptr(),
                 dq.data_ptr(), None if ef is None else ef_new.data_ptr(),
                 segs.table(v.device).data_ptr(), len(segs.lengths),
                 segs.rows, segs.end, v.shape[1], b, v.stride(0),
                 0 if ef is None else ef.stride(0), noise.stride(0),
                 dq.stride(0), int(vec_aligned(*ops)), stream(v))
        raise_on(err, name, v)
    return q, scales, dq, ef_new


def quantize_int8(v, noise, segs: Segments = None, *, mode=None):
    """Stochastic int8 of every (sender, leaf) of the rows ``v`` (B, C)
    over the leaf's 128-value rows, rounding noise ``noise`` (B, >=
    segs.end); ``segs`` None: the whole row is one leaf. Returns (q int8
    (B, C), scales (B, rows) f32, dq (B, C))."""
    if segs is None:
        segs = segments((v.shape[-1],))
    q, scales, dq, _ = quantize_rows(v, None, noise, segs, mode)
    return q, scales, dq


def row_of_column(segs: Segments, device) -> torch.Tensor:
    """(segs.end,) int64: the wire row of each column of the leaves."""
    cols = [torch.arange(n, device=device) // R.LANES + r0
            for n, r0 in zip(segs.lengths, segs.row0)]
    return torch.cat(cols)


def dequantize_int8(q, scales, segs: Segments = None):
    """(q int8 (B, C), scales (B, rows)) -> (B, C) float32 ``q * scale``,
    each column times its wire row's scale, columns past the last leaf
    0; ``segs`` None: the whole row is one leaf."""
    if segs is None:
        segs = segments((q.shape[-1],))
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    out[..., :segs.end] = q[..., :segs.end].to(torch.float32) \
        * scales[..., row_of_column(segs, q.device)]
    return out

"""Error-feedback compression of flat sender rows: CUDA kernels or plain
versions, with the reference's gradient rules.

Every op takes a batch of senders as (B, C) float32 rows (unit column
stride; rows may be strided) holding several parameter leaves back to
back, and a :class:`Segments` table of where each leaf lies. Each leaf
of each sender is compressed on its own -- its own k, int8 rows and sign
scale -- as the reference's ``compress_tree_ef`` does per (sender, leaf)
pair, but ONE kernel launch covers every (sender, leaf) pair:

  * :func:`ef_topk`  -> (dq, ranks, ef_new)        kernel ``ef_topk``
  * :func:`ef_randk` -> (dq, ranks, ef_new)        kernel ``ef_randk``
  * :func:`ef_int8`  -> (q, scales, dq, ef_new)    kernel ``ef_int8``
  * :func:`ef_sign`  -> (bits, scales, dq, ef_new) kernel ``ef_sign``

dq, ranks, ef_new and q have the rows' shape (B, C); columns past the
last leaf read dq 0, ranks -1, q 0 and ef_new = delta + ef. int8 scales
are (B, rows) and sign bits (B, rows, 16), ``rows`` counting each leaf's
128-value rows in leaf order; sign scales are (B, leaves).

The select threshold (the k-th largest score of each (sender, leaf),
``ref.kth_threshold``) and the sign scale (``mean |msg|``) are torch ops
computed here, outside the kernels, as the reference computes them in
XLA outside its Pallas kernels; both versions get the same values.

Which version runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel
(``csrc/compress.cu``) for CUDA tensors, the plain version (``ref.py``)
for CPU tensors or an explicit ``mode="torch"``. Each launch adds one to
``LAUNCHES[name]``.

Each op is a ``torch.autograd.Function`` with the reference's backward
rules (``repro/kernels/compress/ops.py``): top-k and rand-k route the
cotangent of a kept coordinate to dq and of a dropped one to ef_new;
int8 and sign are straight-through (d dq / d msg = I).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.compress import ref as R
from repro_torch.kernels.interface import (KernelType, count_launch,
                                           kernel_mode, vec_aligned)

__all__ = ["KERNELS", "Segments", "ef_int8", "ef_randk", "ef_sign",
           "ef_topk", "segment_thresholds", "segments", "sign_scales"]

_LIB = "compress"
# launch-count names of the kernels this module launches
KERNELS = ("ef_topk", "ef_randk", "ef_int8", "ef_sign")


@dataclass(frozen=True)
class Segments:
    """Where each leaf lies in a flat sender row.

    offsets / lengths: each leaf's first column and size p (>= 1), in
    row order, back to back from column 0; ks: the values top-k / rand-k
    keep of each leaf (0 where unused); row0: each leaf's first 128-value
    wire row among all leaves' rows.
    """
    offsets: tuple
    lengths: tuple
    ks: tuple
    row0: tuple

    @property
    def end(self) -> int:
        """One past the last leaf's last column."""
        return self.offsets[-1] + self.lengths[-1]

    @property
    def rows(self) -> int:
        """The 128-value wire rows of all leaves together."""
        return self.row0[-1] + -(-self.lengths[-1] // R.LANES)

    def table(self, device) -> torch.Tensor:
        """The kernels' (leaves, 4) int64 table on ``device``: offset,
        length, k, first wire row."""
        return _table(self, str(torch.device(device)))


@functools.lru_cache(maxsize=1024)
def segments(lengths: tuple, ks: tuple = None) -> Segments:
    """The (cached) :class:`Segments` of leaves of ``lengths`` packed
    back to back; ``ks`` the kept counts for top-k / rand-k."""
    lengths = tuple(int(n) for n in lengths)
    if not lengths or min(lengths) < 1:
        raise ValueError(f"every leaf needs at least one value: {lengths}")
    ks = (0,) * len(lengths) if ks is None else tuple(int(k) for k in ks)
    if len(ks) != len(lengths) or any(
            not 0 <= k <= n for k, n in zip(ks, lengths)):
        raise ValueError(f"bad k per leaf {ks} for leaves {lengths}")
    offsets, row0 = [0], [0]
    for n in lengths[:-1]:
        offsets.append(offsets[-1] + n)
        row0.append(row0[-1] + -(-n // R.LANES))
    return Segments(tuple(offsets), lengths, ks, tuple(row0))


@functools.lru_cache(maxsize=256)
def _table(segs: Segments, device: str) -> torch.Tensor:
    rows = list(zip(segs.offsets, segs.lengths, segs.ks, segs.row0))
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _cols(segs: Segments):
    """(leaf index, column slice, k) per leaf."""
    return [(i, slice(o, o + n), k) for i, (o, n, k) in
            enumerate(zip(segs.offsets, segs.lengths, segs.ks))]


def segment_thresholds(score: torch.Tensor, segs: Segments) -> torch.Tensor:
    """(B, leaves) k-th largest ``score`` of each (sender, leaf)."""
    return torch.stack([R.kth_threshold(score[:, sl], k)
                        for _, sl, k in _cols(segs)], dim=1).contiguous()


def sign_scales(delta, ef, segs: Segments) -> torch.Tensor:
    """(B, leaves) ``mean |delta + ef|`` of each (sender, leaf)."""
    return torch.stack([(delta[:, sl] + ef[:, sl]).abs().mean(dim=-1)
                        for _, sl, _ in _cols(segs)], dim=1).contiguous()


def _check(segs: Segments, **rows):
    b = None
    devs = set()
    for name, t in rows.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be (senders, columns), got "
                             f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} needs unit-stride columns")
        if t.shape[1] < segs.end:
            raise ValueError(f"{name} has {t.shape[1]} columns, the leaves "
                             f"need {segs.end}")
        if b is not None and t.shape[0] != b:
            raise ValueError(f"{name} has {t.shape[0]} senders, not {b}")
        b = t.shape[0]
        devs.add(t.device)
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def _tail(segs, delta, ef, dq, ef_new, *ints):
    """Plain version of the columns past the last leaf: nothing sent, the
    message kept (the kernels write them themselves)."""
    e = segs.end
    if e < delta.shape[1]:
        dq[:, e:] = 0.0
        ef_new[:, e:] = delta[:, e:] + ef[:, e:]
        for t, fill in ints:
            t[:, e:] = fill


def _library():
    lib = load(_LIB)
    if lib.ef_select.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ef_select.argtypes = [i] + [p] * 8 + [i] + [n] * 6 + [i, p]
        lib.ef_int8.argtypes = [p] * 8 + [i] + [n] * 8 + [i, p]
        lib.ef_sign.argtypes = [p] * 7 + [i] + [n] * 7 + [i, p]
        for fn in (lib.ef_select, lib.ef_int8, lib.ef_sign):
            fn.restype = ctypes.c_int
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err, name, t):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"(senders={t.shape[0]}, columns={t.shape[1]})")


def _senders_ok(t):
    if t.shape[0] > 65535:
        raise ValueError(f"the compress kernels take at most 65535 "
                         f"senders, got {t.shape[0]}")
    return t.shape[0] > 0


# ------------------------------------------------------------ select

def _given(t, b, segs, what):
    """A caller's (B, leaves) per-(sender, leaf) value, checked."""
    if t.shape != (b, len(segs.lengths)) or t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32 (senders, leaves) = "
                         f"{(b, len(segs.lengths))}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _select(randk, u, delta, ef, segs, thresh, mode):
    if randk:
        _check(segs, u=u, delta=delta, ef=ef)
    else:
        _check(segs, delta=delta, ef=ef)
    if thresh is None:
        thresh = segment_thresholds(u if randk else (delta + ef).abs(), segs)
    thresh = _given(thresh, delta.shape[0], segs, "thresh")
    dq = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    ranks = torch.empty(delta.shape, dtype=torch.int32, device=delta.device)
    ef_new = torch.empty_like(dq)
    if kernel_mode(delta, mode) is KernelType.TORCH:
        for i, sl, k in _cols(segs):
            if randk:
                out = R.ef_randk_select_ref(u[:, sl], delta[:, sl],
                                            ef[:, sl], k, thresh[:, i])
            else:
                out = R.ef_topk_select_ref(delta[:, sl], ef[:, sl], k,
                                           thresh[:, i])
            dq[:, sl], ranks[:, sl], ef_new[:, sl] = out
        _tail(segs, delta, ef, dq, ef_new, (ranks, -1))
    elif _senders_ok(delta):
        name = "ef_randk" if randk else "ef_topk"
        ops = (delta, ef, dq, ranks, ef_new) + ((u,) if randk else ())
        fn = _library().ef_select
        count_launch(name)
        err = fn(int(randk), delta.data_ptr(), ef.data_ptr(),
                 u.data_ptr() if randk else None, dq.data_ptr(),
                 ranks.data_ptr(), ef_new.data_ptr(),
                 segs.table(delta.device).data_ptr(), thresh.data_ptr(),
                 len(segs.lengths), delta.shape[1], delta.shape[0],
                 delta.stride(0), ef.stride(0), u.stride(0) if randk else 0,
                 dq.stride(0), int(vec_aligned(*ops)), _stream(delta))
        _raise_on(err, name, delta)
    return dq, ranks, ef_new


class _EFSelect(torch.autograd.Function):
    """EF top-k (``u`` None) or rand-k; the cotangent of a kept
    coordinate goes to dq, of a dropped one to ef_new."""

    @staticmethod
    def forward(ctx, u, delta, ef, segs, thresh, mode):
        dq, ranks, ef_new = _select(u is not None, u, delta, ef, segs,
                                    thresh, mode)
        ctx.mark_non_differentiable(ranks)
        ctx.save_for_backward(ranks)
        return dq, ranks, ef_new

    @staticmethod
    def backward(ctx, g_dq, _g_ranks, g_ef):
        (ranks,) = ctx.saved_tensors
        g_msg = torch.where(ranks >= 0, g_dq, g_ef)
        return None, g_msg, g_msg, None, None, None


def ef_topk(delta, ef, segs: Segments, *, thresh=None, mode=None):
    """EF + magnitude top-k of every (sender, leaf): keep each leaf's
    ``segs.ks`` largest ``|delta + ef|`` (ties to the lowest index).
    ``thresh`` (B, leaves): the thresholds, if the caller has them
    (:func:`segment_thresholds`). Returns (dq, ranks int32,
    ef_new = msg - dq)."""
    return _EFSelect.apply(None, delta, ef, segs, thresh, mode)


def ef_randk(u, delta, ef, segs: Segments, *, thresh=None, mode=None):
    """EF + contractive rand-k of every (sender, leaf): keep the k
    positions with the largest uniforms ``u`` (B, >= segs.end), values
    unscaled; ``thresh`` as for :func:`ef_topk`, on ``u``. Returns (dq,
    ranks int32, ef_new)."""
    return _EFSelect.apply(u, delta, ef, segs, thresh, mode)


# -------------------------------------------------------------- int8

def _int8(delta, ef, noise, segs, mode):
    _check(segs, delta=delta, ef=ef, noise=noise)
    b = delta.shape[0]
    q = torch.empty(delta.shape, dtype=torch.int8, device=delta.device)
    scales = torch.empty((b, segs.rows), dtype=torch.float32,
                         device=delta.device)
    dq = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    ef_new = torch.empty_like(dq)
    if kernel_mode(delta, mode) is KernelType.TORCH:
        for i, sl, _ in _cols(segs):
            qi, si, di, ei = R.ef_quantize_int8_ref(delta[:, sl], ef[:, sl],
                                                    noise[:, sl])
            r0 = segs.row0[i]
            q[:, sl], dq[:, sl], ef_new[:, sl] = qi, di, ei
            scales[:, r0:r0 + si.shape[1]] = si
        _tail(segs, delta, ef, dq, ef_new, (q, 0))
    elif _senders_ok(delta):
        fn = _library().ef_int8
        count_launch("ef_int8")
        err = fn(delta.data_ptr(), ef.data_ptr(), noise.data_ptr(),
                 q.data_ptr(), scales.data_ptr(), dq.data_ptr(),
                 ef_new.data_ptr(), segs.table(delta.device).data_ptr(),
                 len(segs.lengths), segs.rows, segs.end, delta.shape[1], b,
                 delta.stride(0), ef.stride(0), noise.stride(0),
                 dq.stride(0),
                 int(vec_aligned(delta, ef, noise, q, dq, ef_new)),
                 _stream(delta))
        _raise_on(err, "ef_int8", delta)
    return q, scales, dq, ef_new


class _EFInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, ef, noise, segs, mode):
        q, scales, dq, ef_new = _int8(delta, ef, noise, segs, mode)
        ctx.mark_non_differentiable(q, scales)
        return q, scales, dq, ef_new

    @staticmethod
    def backward(ctx, _g_q, _g_scales, g_dq, _g_ef):
        return g_dq, g_dq, None, None, None


def ef_int8(delta, ef, noise, segs: Segments, *, mode=None):
    """EF + stochastic int8 of every (sender, leaf) over the leaf's
    128-value rows, rounding noise ``noise`` (B, >= segs.end). Returns
    (q int8, scales (B, rows), dq, ef_new)."""
    return _EFInt8.apply(delta, ef, noise, segs, mode)


# -------------------------------------------------------------- sign

def _sign(delta, ef, segs, scales, mode):
    _check(segs, delta=delta, ef=ef)
    b = delta.shape[0]
    if scales is None:
        scales = sign_scales(delta, ef, segs)
    scales = _given(scales, b, segs, "scales")
    bits = torch.empty((b, segs.rows, R.LANES // 8), dtype=torch.uint8,
                       device=delta.device)
    dq = torch.empty(delta.shape, dtype=torch.float32, device=delta.device)
    ef_new = torch.empty_like(dq)
    if kernel_mode(delta, mode) is KernelType.TORCH:
        for i, sl, _ in _cols(segs):
            bi, _, di, ei = R.ef_sign_compress_ref(delta[:, sl], ef[:, sl],
                                                   scales[:, i])
            r0 = segs.row0[i]
            bits[:, r0:r0 + bi.shape[1]] = bi
            dq[:, sl], ef_new[:, sl] = di, ei
        _tail(segs, delta, ef, dq, ef_new)
    elif _senders_ok(delta):
        fn = _library().ef_sign
        count_launch("ef_sign")
        err = fn(delta.data_ptr(), ef.data_ptr(), scales.data_ptr(),
                 bits.data_ptr(), dq.data_ptr(), ef_new.data_ptr(),
                 segs.table(delta.device).data_ptr(), len(segs.lengths),
                 segs.rows, segs.end, delta.shape[1], b, delta.stride(0),
                 ef.stride(0), dq.stride(0),
                 int(vec_aligned(delta, ef, dq, ef_new)), _stream(delta))
        _raise_on(err, "ef_sign", delta)
    return bits, scales, dq, ef_new


class _EFSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, ef, segs, scales, mode):
        bits, scales, dq, ef_new = _sign(delta, ef, segs, scales, mode)
        ctx.mark_non_differentiable(bits, scales)
        return bits, scales, dq, ef_new

    @staticmethod
    def backward(ctx, _g_bits, _g_scales, g_dq, _g_ef):
        return g_dq, g_dq, None, None, None


def ef_sign(delta, ef, segs: Segments, *, scales=None, mode=None):
    """EF + 1-bit sign of every (sender, leaf), scaled by the leaf's
    ``mean |msg|`` (``scales`` (B, leaves), if the caller has them:
    :func:`sign_scales`). Returns (bits (B, rows, 16) uint8, scales (B,
    leaves), dq, ef_new)."""
    return _EFSign.apply(delta, ef, segs, scales, mode)

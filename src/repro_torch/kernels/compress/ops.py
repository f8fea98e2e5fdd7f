"""Compression of flat sender rows, with error feedback (EF) and without:
CUDA kernels or plain versions, with the reference's gradient rules.

Every op takes a batch of senders as (B, C) float32 rows (unit column
stride; rows may be strided) holding several parameter leaves back to
back, and a :class:`Segments` table of where each leaf lies
(``repro_torch.kernels.segments``). Each leaf of each sender is
compressed on its own -- its own k, int8 rows and sign scale -- as the
reference compresses each (sender, leaf) pair, but ONE kernel launch
covers every (sender, leaf) pair:

  * :func:`ef_topk`  -> (dq, ranks, ef_new)        kernel ``ef_topk``
  * :func:`ef_randk` -> (dq, ranks, ef_new)        kernel ``ef_randk``
  * :func:`ef_int8`  -> (q, scales, dq, ef_new)    kernel ``ef_int8``
  * :func:`ef_sign`  -> (bits, scales, dq, ef_new) kernel ``ef_sign``
  * :func:`topk`     -> (dq, ranks)                kernel ``topk``
  * :func:`randk`    -> (dq, ranks)                kernel ``randk``
  * :func:`sign`     -> (bits, scales, dq)         kernel ``sign``

(int8 without error feedback is ``repro_torch.kernels.quantize``.) With
EF the message is ``delta + ef``; without, the rows ``v`` themselves.
dq, ranks, ef_new and q have the rows' shape (B, C); columns past the
last leaf read dq 0, ranks -1, q 0 and ef_new = msg. int8 scales are
(B, rows) and sign bits (B, rows, 16), ``rows`` counting each leaf's
128-value rows in leaf order; sign scales are (B, leaves).

The select threshold (the k-th largest score of each (sender, leaf),
``ref.kth_threshold``) and the sign scale (``mean |msg|``) are torch ops
computed here, outside the kernels, as the reference computes them in
XLA outside its Pallas kernels; both versions get the same values.
Unbiased rand-k multiplies the kept values by each leaf's float32
f32(p / k), the reference's Python ``p / k`` rounded once.

Which version runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors or an explicit
``mode="torch"``. Each op call adds one to ``LAUNCHES[name]``. The
kernels are ``csrc/compress.cu`` (int8, sign) and, for top-k and rand-k,
``csrc/select_hopper.cu``: a count of each tile's strict and tie values,
then the scan, each over every (tile, sender) -- :func:`tiles` says
where the tiles of :data:`TILE` values lie -- so an op call is two CUDA
launches.

Each op is a ``torch.autograd.Function`` with the reference's backward
rules (``repro/kernels/compress/ops.py``): with EF, top-k and rand-k
route the cotangent of a kept coordinate to dq and of a dropped one to
ef_new; without, a kept coordinate's cotangent (times rand-k's scale)
reaches v and a dropped one's is 0, and rand-k's uniforms get 0; int8
and sign are straight-through (d dq / d msg = I).

The launches -- the select, the sign and (``quantize.ops``) the int8 op,
each after its thresholds or scales -- are seams
(:func:`repro_torch.kernels.interface.seam`): each records
``roofline.kernels.compress`` under its kernel's name under an active
work counter and returns empty outputs of its shapes on fake tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.compress import ref as R
from repro_torch.kernels.interface import (KernelType, count_launch,
                                           kernel_mode, refuse_grad, seam,
                                           vec_aligned)
from repro_torch.kernels.quantize.ops import quantize_rows
from repro_torch.kernels.segments import (Segments, check_rows, given,
                                          leaf_columns, raise_on, segments,
                                          senders_ok, stream)
from repro_torch.roofline import kernels as work

__all__ = ["KERNELS", "Segments", "TILE", "ef_int8", "ef_randk", "ef_sign",
           "ef_topk", "randk", "segment_thresholds", "segments", "sign",
           "sign_scales", "tiles", "topk", "unbiased_scales"]

# launch-count names of the kernels this module launches
KERNELS = ("ef_topk", "ef_randk", "ef_int8", "ef_sign", "topk", "randk",
           "sign")
# values a tile of the select kernel holds (csrc/select_hopper.cu)
TILE = 4096


def segment_thresholds(score: torch.Tensor, segs: Segments) -> torch.Tensor:
    """(B, leaves) k-th largest ``score`` of each (sender, leaf)."""
    return torch.stack([R.kth_threshold(score[:, sl], k)
                        for _, sl, k in leaf_columns(segs)],
                       dim=1).contiguous()


def sign_scales(v, segs: Segments, ef=None) -> torch.Tensor:
    """(B, leaves) ``mean |msg|`` of each (sender, leaf); msg = v (+ ef)."""
    msg = v if ef is None else v + ef
    return torch.stack([msg[:, sl].abs().mean(dim=-1)
                        for _, sl, _ in leaf_columns(segs)],
                       dim=1).contiguous()


@functools.lru_cache(maxsize=256)
def _unbiased(segs: Segments, device: str) -> torch.Tensor:
    return torch.tensor([p / k for p, k in zip(segs.lengths, segs.ks)],
                        dtype=torch.float32, device=device)


def unbiased_scales(segs: Segments, device) -> torch.Tensor:
    """(leaves,) float32 f32(p / k) of each leaf: unbiased rand-k's factor
    of the kept values (cached per table and device)."""
    return _unbiased(segs, str(torch.device(device)))


def _sign_fn():
    fn = load("compress").compress_sign
    if fn.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p] * 7 + [i] + [n] * 7 + [i, p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------ select

def _select_fn():
    lib = load("select_hopper")
    fn = lib.select_tiled
    if fn.argtypes is None:
        if lib.select_tile_values() != TILE:
            raise RuntimeError(f"select_hopper.cu tiles "
                               f"{lib.select_tile_values()} values, "
                               f"ops.TILE says {TILE}")
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [i] + [p] * 11 + [i, i] + [n] * 6 + [i, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def tiles(segs: Segments) -> tuple:
    """Where the select kernel's tiles of :data:`TILE` values lie, none
    across a leaf's end: each leaf's first tile among all leaves' tiles,
    then the total (the kernel's grid is that many tiles by the
    senders)."""
    starts = [0]
    for n in segs.lengths:
        starts.append(starts[-1] + -(-n // TILE))
    return tuple(starts)


@functools.lru_cache(maxsize=256)
def _tile_table(segs: Segments, device: str) -> torch.Tensor:
    return torch.tensor(tiles(segs), dtype=torch.int32, device=device)


def _select(u, v, ef, segs, thresh, unbiased, mode):
    """Top-k (``u`` None) or rand-k of msg = v (+ ef): (dq, ranks,
    ef_new or None)."""
    randk = u is not None
    check_rows(segs, u=u, v=v, ef=ef)
    b = v.shape[0]
    if thresh is None:
        thresh = segment_thresholds(
            u if randk else (v if ef is None else v + ef).abs(), segs)
    thresh = given(thresh, b, segs, "thresh")
    return _select_rows(u, v, ef, segs, thresh, unbiased, mode)


def _select_name(u, v, ef, *_):
    return ("ef_" if ef is not None else "") + \
        ("randk" if u is not None else "topk")


def _rows_work(name, v, segs, noise_rows=None):
    """``roofline.kernels.compress`` of kernel ``name`` on rows ``v``."""
    return work.compress(name, v.shape[0], v.shape[1], segs.end,
                         len(segs.lengths), segs.rows, noise_rows)


def _select_fake(u, v, ef, *_):
    return (v.new_empty(v.shape, dtype=torch.float32),
            v.new_empty(v.shape, dtype=torch.int32),
            None if ef is None else v.new_empty(v.shape,
                                                dtype=torch.float32))


@seam(_select_name, lambda u, v, ef, segs, *_: _rows_work(
    _select_name(u, v, ef), v, segs), _select_fake)
def _select_rows(u, v, ef, segs, thresh, unbiased, mode):
    """The select launch of :func:`_select`, given the thresholds."""
    randk = u is not None
    b = v.shape[0]
    scale = unbiased_scales(segs, v.device) if unbiased else None
    dq = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    ranks = torch.empty(v.shape, dtype=torch.int32, device=v.device)
    ef_new = None
    if kernel_mode(v, mode) is KernelType.CUDA:
        refuse_grad("compress select", u, v, ef)
    if kernel_mode(v, mode) is KernelType.TORCH:
        msg = v if ef is None else v + ef
        for i, sl, k in leaf_columns(segs):
            if randk:
                out = R.randk_select_ref(
                    u[:, sl], msg[:, sl], k,
                    None if scale is None else scale[i], thresh[:, i])
            else:
                out = R.topk_select_ref(msg[:, sl], k, thresh[:, i])
            dq[:, sl], ranks[:, sl] = out
        dq[:, segs.end:] = 0.0
        ranks[:, segs.end:] = -1
        if ef is not None:
            ef_new = msg - dq
    elif senders_ok(v):
        name = ("ef_" if ef is not None else "") + \
            ("randk" if randk else "topk")
        if max(segs.lengths) >= 2**31:
            raise ValueError("the select kernel takes leaves under 2^31 "
                             "values")
        if ef is not None:
            ef_new = torch.empty_like(dq)
        ntiles = tiles(segs)[-1]
        counts = torch.empty((b, ntiles), dtype=torch.int32, device=v.device)
        ops = [t for t in (v, ef, u, dq, ranks, ef_new) if t is not None]
        fn = _select_fn()
        count_launch(name)
        err = fn(int(randk), v.data_ptr(), _ptr(ef), _ptr(u), dq.data_ptr(),
                 ranks.data_ptr(), _ptr(ef_new),
                 segs.table(v.device).data_ptr(),
                 _tile_table(segs, str(v.device)).data_ptr(),
                 thresh.data_ptr(), _ptr(scale), counts.data_ptr(),
                 len(segs.lengths), ntiles, v.shape[1], b, v.stride(0),
                 0 if ef is None else ef.stride(0),
                 u.stride(0) if randk else 0, dq.stride(0),
                 int(vec_aligned(*ops)), stream(v))
        raise_on(err, name, v)
    return dq, ranks, ef_new


class _EFSelect(torch.autograd.Function):
    """EF top-k (``u`` None) or rand-k; the cotangent of a kept
    coordinate goes to dq, of a dropped one to ef_new."""

    @staticmethod
    def forward(ctx, u, delta, ef, segs, thresh, mode):
        dq, ranks, ef_new = _select(u, delta, ef, segs, thresh, False, mode)
        ctx.mark_non_differentiable(ranks)
        ctx.save_for_backward(ranks)
        return dq, ranks, ef_new

    @staticmethod
    def backward(ctx, g_dq, _g_ranks, g_ef):
        (ranks,) = ctx.saved_tensors
        g_msg = torch.where(ranks >= 0, g_dq, g_ef)
        return None, g_msg, g_msg, None, None, None


class _Select(torch.autograd.Function):
    """Top-k (``u`` None) or rand-k without EF; a kept coordinate's
    cotangent (times rand-k's scale where unbiased) reaches v, a dropped
    one's is 0; the uniforms get 0."""

    @staticmethod
    def forward(ctx, u, v, segs, thresh, unbiased, mode):
        dq, ranks, _ = _select(u, v, None, segs, thresh, unbiased, mode)
        ctx.mark_non_differentiable(ranks)
        ctx.save_for_backward(ranks)
        ctx.segs, ctx.unbiased, ctx.u_shape = segs, unbiased, \
            None if u is None else u.shape
        return dq, ranks

    @staticmethod
    def backward(ctx, g_dq, _g_ranks):
        (ranks,) = ctx.saved_tensors
        g = g_dq
        if ctx.unbiased:
            scale = unbiased_scales(ctx.segs, g_dq.device)
            g = g_dq.clone()
            for i, sl, _ in leaf_columns(ctx.segs):
                g[:, sl] = g_dq[:, sl] * scale[i]
        g_v = torch.where(ranks >= 0, g, torch.zeros_like(g))
        g_u = None
        if ctx.needs_input_grad[0]:
            g_u = torch.zeros(ctx.u_shape, dtype=g_dq.dtype,
                              device=g_dq.device)
        return g_u, g_v, None, None, None, None


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


def topk(v, segs: Segments, *, thresh=None, mode=None):
    """Magnitude top-k of every (sender, leaf) of the rows ``v``: keep
    each leaf's ``segs.ks`` largest ``|v|`` (ties to the lowest index).
    Returns (dq, ranks int32)."""
    return _Select.apply(None, v, segs, thresh, False, mode)


def randk(u, v, segs: Segments, *, unbiased=False, thresh=None,
          mode=None):
    """Rand-k of every (sender, leaf): keep the k positions with the
    largest uniforms ``u`` (B, >= segs.end); ``unbiased`` multiplies the
    kept values by f32(p / k) (:func:`unbiased_scales`), the estimator
    used without error feedback. Returns (dq, ranks int32)."""
    return _Select.apply(u, v, segs, thresh, bool(unbiased), mode)


# -------------------------------------------------------------- int8

class _EFInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, ef, noise, segs, mode):
        q, scales, dq, ef_new = quantize_rows(delta, ef, noise, segs, mode)
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

def _sign(v, ef, segs, scales, mode):
    """Sign of msg = v (+ ef): (bits, scales, dq, ef_new or None)."""
    check_rows(segs, v=v, ef=ef)
    b = v.shape[0]
    if scales is None:
        scales = sign_scales(v, segs, ef)
    scales = given(scales, b, segs, "scales")
    return _sign_rows(v, ef, segs, scales, mode)


def _sign_fake(v, ef, segs, scales, mode):
    f32 = lambda: v.new_empty(v.shape, dtype=torch.float32)  # noqa: E731
    return (v.new_empty((v.shape[0], segs.rows, R.LANES // 8),
                        dtype=torch.uint8), scales, f32(),
            None if ef is None else f32())


@seam(lambda v, ef, *_: "sign" if ef is None else "ef_sign",
      lambda v, ef, segs, *_: _rows_work(
          "sign" if ef is None else "ef_sign", v, segs), _sign_fake)
def _sign_rows(v, ef, segs, scales, mode):
    """The sign launch of :func:`_sign`, given the scales."""
    b = v.shape[0]
    bits = torch.empty((b, segs.rows, R.LANES // 8), dtype=torch.uint8,
                       device=v.device)
    dq = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    ef_new = None
    if kernel_mode(v, mode) is KernelType.CUDA:
        refuse_grad("compress sign", v, ef)
    if kernel_mode(v, mode) is KernelType.TORCH:
        msg = v if ef is None else v + ef
        for i, sl, _ in leaf_columns(segs):
            bi, _, di = R.sign_compress_ref(msg[:, sl], scales[:, i])
            r0 = segs.row0[i]
            bits[:, r0:r0 + bi.shape[1]] = bi
            dq[:, sl] = di
        dq[:, segs.end:] = 0.0
        if ef is not None:
            ef_new = msg - dq
    elif senders_ok(v):
        name = "sign" if ef is None else "ef_sign"
        if ef is not None:
            ef_new = torch.empty_like(dq)
        ops = [t for t in (v, ef, dq, ef_new) if t is not None]
        fn = _sign_fn()
        count_launch(name)
        err = fn(v.data_ptr(), _ptr(ef), scales.data_ptr(), bits.data_ptr(),
                 dq.data_ptr(), _ptr(ef_new),
                 segs.table(v.device).data_ptr(), len(segs.lengths),
                 segs.rows, segs.end, v.shape[1], b, v.stride(0),
                 0 if ef is None else ef.stride(0), dq.stride(0),
                 int(vec_aligned(*ops)), stream(v))
        raise_on(err, name, v)
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


class _Sign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, segs, scales, mode):
        bits, scales, dq, _ = _sign(v, None, segs, scales, mode)
        ctx.mark_non_differentiable(bits, scales)
        return bits, scales, dq

    @staticmethod
    def backward(ctx, _g_bits, _g_scales, g_dq):
        return g_dq, None, None, None


def ef_sign(delta, ef, segs: Segments, *, scales=None, mode=None):
    """EF + 1-bit sign of every (sender, leaf), scaled by the leaf's
    ``mean |msg|`` (``scales`` (B, leaves), if the caller has them:
    :func:`sign_scales`). Returns (bits (B, rows, 16) uint8, scales (B,
    leaves), dq, ef_new)."""
    return _EFSign.apply(delta, ef, segs, scales, mode)


def sign(v, segs: Segments, *, scales=None, mode=None):
    """1-bit sign of every (sender, leaf) of the rows ``v``, scaled by the
    leaf's ``mean |v|`` (``scales`` (B, leaves), if the caller has them).
    Returns (bits (B, rows, 16) uint8, scales (B, leaves), dq)."""
    return _Sign.apply(v, segs, scales, mode)

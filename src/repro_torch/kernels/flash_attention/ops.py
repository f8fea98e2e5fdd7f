"""Public attention op: the CUDA flash-attention kernels or their plain
version.

:func:`attention` takes q (b, sq, hq, d) and k, v (b, skv, hkv, d) in the
reference's (batch, sequence, head, dim) layout, float32 or bfloat16, q
and k/v each in its own type; the output has q's shape and type. Which
implementation runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): a kernel for CUDA
tensors, the plain version (``ref.py``) for CPU tensors or an explicit
``mode="torch"``.

On a CUDA tensor, :func:`plan` picks one of three kernel variants by type
and shape, written out (no variant gives way to another):

  * ``"wgmma"``: bfloat16 q, k, v, more than one query row, head_dim 64,
    96 or 128, 16-byte aligned rows. The tensor-core prefill
    (``csrc/flash_attention_hopper.cu``, TMA + wgmma; a row of 96 is a
    64-column box and half a box that TMA fills with zeros); p is rounded
    to bfloat16 before the PV product, as the JAX package's
    ``attention_ref`` rounds it.
  * ``"split_kv"``: the same types, head dims and alignment, one query row
    (decode). The visible keys are cut into ``splits`` chunks, one CTA per
    (chunk, kv-head, batch); the last CTA of each (batch, kv-head) merges
    them (an atomic ticket): one CUDA launch. Its tickets are int32
    counters that each launch leaves at 0, kept per (device, stream).
  * ``"simt"``: everything else -- float32, a bfloat16 q against a float32
    cache, rows that are not 16-byte aligned, head_dim 32. The CUDA-core
    kernel ``csrc/flash_attention.cu`` (p stays float32).

All read q, k and v through their strides (unit stride along d). Each op
call adds one to ``LAUNCHES["flash_attention"]`` and to
``VARIANTS[variant]``.

The op is differentiable. When grad mode is on and q, k or v requires a
gradient, the forward runs the kernel :func:`plan` picks (``wgmma`` or
``simt``; the ``split_kv`` decode has no log-sum-exp output and raises)
with each row's log-sum-exp written to a float32 (b, hq, sq) buffer, and
the backward is :func:`attention_bwd`: for CUDA tensors the backward
kernel :func:`plan_bwd` picks, written out (no variant gives way to the
other; a failed build or launch raises):

  * ``"wgmma"``: bfloat16 q, k, v, out and dout, head_dim 64, 96 or 128,
    16-byte aligned rows. The tensor-core backward
    (``csrc/flash_attention_bwd_hopper.cu``: a D pre-pass, a dq pass with
    queries stationary, a dk/dv pass with keys stationary; TMA + wgmma).
    p and ds are rounded to bfloat16 before their products
    (``ref.attention_bwd_ref(variant="wgmma")`` models it).
  * ``"simt"``: everything else -- float32, a bfloat16 q over a float32
    k and v, head_dim 32, rows that are not 16-byte aligned. The CUDA-core
    backward ``csrc/flash_attention_bwd.cu`` (f32; ds stays f32).

Neither uses float atomics: two launches are bit-equal. One call adds one
to ``LAUNCHES["flash_attention_bwd"]`` and to ``BWD_VARIANTS[variant]``;
on CPU tensors or with ``mode="torch"`` ``ref.attention_bwd_ref`` runs.
Without a gradient the forward kernels run exactly as before (no
log-sum-exp is written).

The forward and the backward are seams
(:func:`repro_torch.kernels.interface.seam`): each records
``roofline.kernels.attention`` / ``attention_bwd`` under an active work
counter and returns empty outputs of its shapes on fake tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import NEG_INF, \
    attention_bwd_ref, attention_lse_ref, attention_ref, sm_scale, \
    visible_keys
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode, seam
from repro_torch.roofline import kernels as work

__all__ = ["BWD_VARIANTS", "HEAD_DIMS", "KERNELS", "VARIANTS", "attention",
           "attention_bwd", "plan", "plan_bwd", "reset_variants"]

_NAME = "flash_attention"
_BWD = "flash_attention_bwd"
KERNELS = (_NAME, _BWD)
HEAD_DIMS = (32, 64, 96, 128)
_TC_HEAD_DIMS = (64, 96, 128)     # wgmma, split_kv and the wgmma backward
_BWD_PAD = 128                    # rows of its lse2 / delta scratch: a
                                  # multiple of its query block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT = 132                   # H100 SXM
_SPLIT_WAVES = 4                  # split_kv: aim for 4 CTAs per SM
_SPLIT_MIN_ROWS = 64              # ... of at least 64 keys each
_SPLIT_MAX = 64
_SPLIT_HEADS = 8                  # q-heads one split_kv CTA serves at most

# variant -> op calls that ran it since the last reset_variants()
VARIANTS = {"wgmma": 0, "split_kv": 0, "simt": 0}
# backward variant -> attention_bwd kernel calls that ran it, likewise
BWD_VARIANTS = {"wgmma": 0, "simt": 0}


def reset_variants() -> None:
    """Set every variant's count to 0, forward and backward."""
    for counts in (VARIANTS, BWD_VARIANTS):
        for name in counts:
            counts[name] = 0


def _fn(lib, name, argtypes):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


def _simt_fn():
    return _fn(_NAME, "flash_attention",
               [_I] * 3 + [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 3
               + [_F, _I, _P, _P])


def _wgmma_fn():
    return _fn("flash_attention_hopper", "flash_attention_wgmma",
               [_I] + [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I] * 3
               + [_F, _P, _P])


def _bwd_fn():
    return _fn(_BWD, "flash_attention_bwd",
               [_I] * 3 + [_P] * 10 + [_I] * 5 + [_L] * 15 + [_I] * 3
               + [_F, _P])


def _bwd_wgmma_fn():
    return _fn("flash_attention_bwd_hopper", "flash_attention_bwd_wgmma",
               [_I] + [_P] * 11 + [_I] * 6 + [_L] * 15 + [_I] * 3
               + [_F, _P])


def _split_fn():
    return _fn("flash_attention_hopper", "flash_attention_split_kv",
               [_I] + [_P] * 8 + [_I] * 3 + [_L] * 10 + [_I] * 4 + [_F, _P])


# (device, stream) -> int32 zeros: the split_kv tickets, which every launch
# leaves at 0 again (launches on one stream never overlap)
_TICKETS: dict = {}


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    return t


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
    """Every (b, s, h) row of ``t`` starts on a 16-byte boundary (the
    stride of an axis of length 1 is never followed)."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (t.stride(i) * es) % 16 == 0 for i in range(3) if t.shape[i] > 1)


def plan(q, k, v, *, causal=True, window=0, q_offset=None):
    """(variant, splits) of the kernel :func:`attention` launches for these
    tensors: ``"wgmma"`` for bfloat16 q, k, v with sq > 1, head_dim 64, 96
    or 128 and 16-byte aligned rows with unit stride along d;
    ``"split_kv"`` for the same with sq == 1; ``"simt"`` otherwise
    (float32, a bfloat16 q over a float32 cache, unaligned rows, head_dim
    32). ``splits`` (1 but for split_kv) cuts the visible keys into chunks
    so that the grid holds about 4 CTAs per SM, of at least 64 keys each,
    at most 64 chunks. A pure function of shapes, types, strides and
    addresses."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    fast = (all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and d in _TC_HEAD_DIMS
            and all(t.stride(3) == 1 and _aligned(t) for t in (q, k, v)))
    if not fast:
        return "simt", 1
    if sq > 1:
        return "wgmma", 1
    q_offset = skv - 1 if q_offset is None else int(q_offset)
    _, n = visible_keys(skv, causal=causal, window=window, q_offset=q_offset)
    blocks = b * hkv * math.ceil(hq // hkv / _SPLIT_HEADS)
    splits = min(_SPLIT_MAX, n // _SPLIT_MIN_ROWS,
                 math.ceil(_SPLIT_WAVES * _SM_COUNT / blocks))
    return "split_kv", max(1, splits)


def plan_bwd(q, k, v, out=None, dout=None) -> str:
    """The backward kernel :func:`attention_bwd` launches for these
    tensors: ``"wgmma"`` for bfloat16 q, k, v (and out, dout where given)
    with head_dim 64, 96 or 128 and 16-byte aligned rows with unit stride
    along d; ``"simt"`` otherwise. A pure function of types, shapes,
    strides and addresses."""
    ts = [t for t in (q, k, v, out, dout) if t is not None]
    fast = (all(t.dtype == torch.bfloat16 for t in ts)
            and q.shape[3] in _TC_HEAD_DIMS
            and all(t.stride(3) == 1 and _aligned(t) for t in ts))
    return "wgmma" if fast else "simt"


def attention(q, k, v, *, causal=True, window=0, q_offset=None, mode=None):
    """Multi-head (optionally causal / windowed) attention over (b, s, h,
    d) tensors, GQA-aware: q-head h reads kv-head ``h // (hq // hkv)``.

    ``q_offset`` is the absolute position of q[:, 0] (a Python int):
    None means ``skv - sq`` (aligned to the end); decode passes the cache
    position. ``window`` > 0 lets a query see only the ``window`` keys
    up to its own position. Differentiable in q, k and v (module
    docstring).
    """
    _check(q, k, v)
    sq, skv = q.shape[1], k.shape[1]
    q_offset = skv - sq if q_offset is None else int(q_offset)
    kt = kernel_mode(q, mode)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, bool(causal), int(window), q_offset,
                                kt)
    return _forward(q, k, v, causal, window, q_offset, kt, False)[0]


class _Attention(torch.autograd.Function):
    """The forward with its log-sum-exp, then :func:`attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kt):
        out, lse = _forward(q, k, v, causal, window, q_offset, kt, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, q_offset, kt)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        causal, window, q_offset, kt = ctx.opts
        dq, dk, dv = attention_bwd(*ctx.saved_tensors, dout, causal=causal,
                                   window=window, q_offset=q_offset, mode=kt)
        return dq, dk, dv, None, None, None, None


def _fwd_work(q, k, v, causal, window, q_offset, kt, want_lse):
    b, sq, hq, d = q.shape
    return work.attention(b, sq, k.shape[1], hq, k.shape[2], d,
                          causal=causal, window=window, q_offset=q_offset,
                          q_itemsize=q.element_size(),
                          kv_itemsize=k.element_size(), lse=want_lse)


def _fwd_fake(q, k, v, causal, window, q_offset, kt, want_lse):
    b, sq, hq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, hq, sq), dtype=torch.float32) if want_lse
            else None)


@seam(_NAME, _fwd_work, _fwd_fake)
def _forward(q, k, v, causal, window, q_offset, kt, want_lse):
    """(out, lse or None): the plain version for ``KernelType.TORCH``, else
    the kernel :func:`plan` picks, writing the log-sum-exp when
    ``want_lse``."""
    if kt is KernelType.TORCH:
        if want_lse:
            return attention_lse_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset), None
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs unit stride along d")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 "
                         f"batch rows and heads, got {b} x {hq}")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0 or skv == 0:
        if lse is not None:
            lse.fill_(NEG_INF)
        return out.zero_(), lse
    variant, splits = plan(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
    if variant == "split_kv" and want_lse:
        raise NotImplementedError(
            "flash_attention: the split_kv decode kernel (one bfloat16 query "
            "row, head_dim 64/96/128) writes no log-sum-exp, so it has no "
            "backward; differentiate a prefill (sq > 1) instead")
    lse_ptr = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3])
    if variant == "wgmma":
        fn = _wgmma_fn()
        count_launch(_NAME)
        err = fn(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, skv, hq, hkv, *strides, q_offset, int(bool(causal)),
                 int(window), sm_scale(d) * math.log2(math.e), lse_ptr,
                 stream)
    elif variant == "split_kv":
        fn = _split_fn()
        lo, n = visible_keys(skv, causal=causal, window=window,
                             q_offset=q_offset)
        rows = b * hq * splits
        part = torch.empty((2 + d) * rows, dtype=torch.float32,
                           device=q.device)     # m, l, acc of each chunk
        pm, pl, pacc = part[:rows], part[rows:2 * rows], part[2 * rows:]
        tickets = _tickets(q.device, stream,
                           b * hkv * math.ceil(hq // hkv / _SPLIT_HEADS))
        count_launch(_NAME)
        err = fn(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
                 tickets.data_ptr(), b, hq, hkv,
                 q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
                 out.stride(0), out.stride(2), lo, n,
                 max(1, -(-n // splits)), splits, sm_scale(d), stream)
    else:
        fn = _simt_fn()
        count_launch(_NAME)
        err = fn(_DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], d,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 sq, skv, hq, hkv, *strides, q_offset, int(bool(causal)),
                 int(window), sm_scale(d),
                 int(_aligned(k) and _aligned(v)), lse_ptr, stream)
    VARIANTS[variant] += 1
    if err:
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    return out, lse


def _bwd_work(q, k, v, out, lse, dout, *, causal=True, window=0,
              q_offset=None, mode=None):
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    return work.attention_bwd(
        b, sq, skv, hq, k.shape[2], d, causal=causal, window=window,
        q_offset=skv - sq if q_offset is None else int(q_offset),
        q_itemsize=q.element_size(), kv_itemsize=k.element_size())


def _bwd_fake(q, k, v, out, lse, dout, **_):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@seam(_BWD, _bwd_work, _bwd_fake)
def attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                  q_offset=None, mode=None):
    """(dq, dk, dv) of :func:`attention` at q, k, v, given its output
    ``out``, its log-sum-exp ``lse`` (b, hq, sq) float32 and the gradient
    ``dout`` of ``out``: the backward kernel :func:`plan_bwd` picks for
    CUDA tensors, the plain ``attention_bwd_ref`` for CPU tensors or
    ``mode="torch"``. dq has q's dtype, dk and dv k's; all three are new
    contiguous tensors."""
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    q_offset = skv - sq if q_offset is None else int(q_offset)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out is {out.dtype} and dout {dout.dtype}, q is "
                        f"{q.dtype}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({b}, {hq}, {sq}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if kernel_mode(q, mode) is KernelType.TORCH:
        return attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                 window=window, q_offset=q_offset)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention_bwd kernel takes at most 65535 "
                         f"batch rows and heads, got {b} x {hq}")
    dout = dout if dout.stride(3) == 1 else dout.contiguous()
    if any(t.stride(3) != 1 for t in (q, k, v, out)):
        raise ValueError("flash_attention_bwd kernel needs unit stride "
                         "along d")
    lse = lse.contiguous()
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, skv, hkv, d), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    variant = plan_bwd(q, k, v, out, dout)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:3], *dout.stride()[:3])
    flags = (q_offset, int(bool(causal)), int(window), sm_scale(d), stream)
    if variant == "wgmma":
        fn = _bwd_wgmma_fn()
        sq_pad = -(-sq // _BWD_PAD) * _BWD_PAD
        stats = torch.empty((2, b, hq, sq_pad), dtype=torch.float32,
                            device=q.device)       # lse * log2(e), D
        count_launch(_BWD)
        err = fn(d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), stats[0].data_ptr(),
                 stats[1].data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, sq, skv, hq, hkv, sq_pad, *strides,
                 *flags)
    else:
        fn = _bwd_fn()
        delta = torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)
        count_launch(_BWD)
        err = fn(_DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], d,
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, hq,
                 hkv, *strides, *flags)
    BWD_VARIANTS[variant] += 1
    if err:
        raise RuntimeError(f"flash_attention_bwd {variant} kernel launch "
                           f"failed: error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)})")
    return dq, dk, dv

"""Public WKV-6 op: the CUDA scan kernels or their plain version.

:func:`wkv` takes r, k, v, w (b, t, h, n), u (h, n) and an optional
float32 state (b, h, n, n), and returns the output in r's type and the
final state in float32. Which implementation runs follows the tensors'
device (:func:`repro_torch.kernels.interface.kernel_mode`): a kernel for
CUDA tensors, the plain version (``ref.py``) for CPU tensors or an
explicit ``mode="torch"``.

On a CUDA tensor, :func:`plan` picks one of two kernel variants by type
and shape, written out (no variant gives way to another):

  * ``"chunked"``: bfloat16 r, k, v, float32 or bfloat16 w, head size 64,
    t >= 16 (a prefill). The scan 16 steps at a time with its products on
    the tensor cores (``csrc/rwkv6_scan_hopper.cu``, 3xTF32 mma.sync).
  * ``"simt"``: everything else -- the decode (t < 16), float32 r/k/v, head
    sizes 16 and 32. The sequential scan on CUDA cores
    (``csrc/rwkv6_scan.cu``).

Both take w in its own type and never round it (the model's decay is
float32), and raise for what they do not take; there is no fallback to
the plain version for a CUDA tensor. ``out_state`` names where the final
state goes, and may be ``state`` itself (the model's recurrent cache,
updated in place). Each launch adds one to ``LAUNCHES["rwkv6_scan"]``
and to ``VARIANTS[variant]``.

The op is differentiable in r, k, v, w, u and ``state``. When grad mode
is on and one of them requires a gradient, the forward runs as above
(the variant :func:`plan` picks; ``out_state`` is refused there: a state
written in place has no gradient) and saves r, k, v, w, u and the
initial state; the backward is :func:`wkv_bwd`: on CPU tensors or with
``mode="torch"`` ``ref.wkv6_bwd_ref``; on CUDA tensors the backward
kernel :func:`plan_bwd` picks, written out as :func:`plan`'s:

  * ``"chunked"``: bfloat16 r, k, v, float32 or bfloat16 w, head size 64,
    t >= 16 (the training path). The reverse scan 16 steps at a time with
    its products on the tensor cores, a cluster of 4 CTAs per (batch,
    head), each 16 keys (``csrc/rwkv6_scan_bwd_hopper.cu``); it recomputes
    the forward states from a snapshot every ``BWD_SEGMENT`` steps.
  * ``"simt"``: everything else. The step-by-step reverse scan on CUDA
    cores, float32 (``csrc/rwkv6_scan_bwd.cu``), from a snapshot every
    ``BWD_CHUNK`` steps.

Both take their snapshots in a float32 scratch the wrapper allocates
(:func:`bwd_scratch`). Each launch adds one to
``LAUNCHES["rwkv6_scan_bwd"]`` and to ``BWD_VARIANTS[variant]``.

The scan and its backward are seams
(:func:`repro_torch.kernels.interface.seam`): each records
``roofline.kernels.rwkv6_scan`` / ``rwkv6_scan_bwd`` under an active work
counter and returns empty outputs of its shapes on fake tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode, seam
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref, wkv6_ref
from repro_torch.roofline import kernels as work

__all__ = ["BWD_CHUNK", "BWD_SEGMENT", "BWD_VARIANTS", "HEAD_SIZES",
           "KERNELS", "VARIANTS", "bwd_scratch", "launch", "launch_bwd",
           "plan", "plan_bwd", "reset_variants", "wkv", "wkv_bwd"]

_NAME = "rwkv6_scan"
_BWD = "rwkv6_scan_bwd"
KERNELS = (_NAME, _BWD)
BWD_CHUNK = 8                     # simt backward: steps between snapshots
BWD_SEGMENT = 64                  # chunked backward: steps between snapshots
HEAD_SIZES = (16, 32, 64)
_CHUNK = 16                       # chunked: steps a chunk, and its least t
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# variant -> launches that ran it since the last reset_variants(): the
# forward's and the backward's
VARIANTS = {"chunked": 0, "simt": 0}
BWD_VARIANTS = {"chunked": 0, "simt": 0}


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


_P, _I = ctypes.c_void_p, ctypes.c_int


def _simt_fn():
    return _fn(_NAME, "rwkv6_scan", [_I] * 3 + [_P] * 8 + [_I] * 3 + [_P])


def _chunked_fn():
    return _fn("rwkv6_scan_hopper", "rwkv6_scan_chunked",
               [_I] + [_P] * 8 + [_I] * 3 + [_P])


def _bwd_fn():
    return _fn(_BWD, "rwkv6_scan_bwd", [_I] * 3 + [_P] * 15 + [_I] * 3
               + [_P])


def _bwd_chunked_fn():
    return _fn("rwkv6_scan_bwd_hopper", "rwkv6_scan_bwd_chunked",
               [_I] + [_P] * 15 + [_I] * 3 + [_P])


def plan(r, k, v, w, state=None):
    """The kernel variant :func:`wkv` launches for these tensors:
    ``"chunked"`` for bfloat16 r, k, v with float32 or bfloat16 w, head
    size 64 and t >= 16; ``"simt"`` otherwise. A pure function of types
    and shapes (``state`` is float32 or None either way)."""
    t, n = r.shape[1], r.shape[3]
    if (all(x.dtype == torch.bfloat16 for x in (r, k, v))
            and w.dtype in _DTYPE_CODES and n == 64 and t >= _CHUNK):
        return "chunked"
    return "simt"


def plan_bwd(r, k, v, w, state=None):
    """The backward kernel :func:`wkv_bwd` launches for these tensors: the
    same rule as :func:`plan` (``"chunked"`` for bfloat16 r, k, v with
    float32 or bfloat16 w, head size 64 and t >= 16; ``"simt"``
    otherwise). A pure function of types and shapes."""
    return plan(r, k, v, w, state)


def bwd_scratch(r, variant):
    """The float32 snapshot scratch :func:`launch_bwd` takes for ``r``'s
    shape and ``variant``: b * h * (snapshots) * n * n floats, a snapshot
    every BWD_CHUNK steps (``simt``) or every BWD_SEGMENT steps
    (``chunked``)."""
    b, t, h, n = r.shape
    every = BWD_SEGMENT if variant == "chunked" else BWD_CHUNK
    return torch.empty(b * h * -(-t // every) * n * n, dtype=torch.float32,
                       device=r.device)


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


def launch(r, k, v, w, u, state, out, out_state, *, variant=None):
    """One launch of the variant :func:`plan` picks (or ``variant``,
    named explicitly, as a measurement compares the two), into given
    outputs: r, k, v, w (b, t, h, n) and ``out`` (r's shape and type), u
    (h, n) float32, ``state`` (float32 (b, h, n, n), or None for zeros)
    and ``out_state`` (the same; may be ``state``), all contiguous on one
    CUDA device; for ``chunked`` also 16-byte aligned. Checks what the
    variant takes, head size first, and raises before building or
    launching anything it would refuse."""
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
    if variant is None:
        variant = plan(r, k, v, w, state)
    elif variant not in VARIANTS:
        raise ValueError(f"rwkv6_scan variant {variant!r} is not one of "
                         f"{tuple(VARIANTS)}")
    if variant == "chunked":
        if n != 64 or r.dtype != torch.bfloat16 or t < 1:
            raise ValueError(f"rwkv6_scan chunked kernel takes bfloat16 r, "
                             f"k, v of head size 64 and t >= 1, got "
                             f"{r.dtype}, n {n}, t {t}")
        if any(x.data_ptr() % 16 for x in (r, k, v, w, out)):
            raise ValueError("rwkv6_scan chunked kernel takes r, k, v, w, "
                             "out on 16-byte boundaries")
    if b * h == 0:
        return
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            out.data_ptr(), out_state.data_ptr(), b, t, h, stream)
    if variant == "chunked":
        fn = _chunked_fn()
        count_launch(_NAME)
        err = fn(_DTYPE_CODES[w.dtype], *ptrs)
    else:
        fn = _simt_fn()
        count_launch(_NAME)
        err = fn(_DTYPE_CODES[r.dtype], _DTYPE_CODES[w.dtype], n, *ptrs)
    VARIANTS[variant] += 1
    if err:
        raise RuntimeError(f"rwkv6_scan {variant} kernel launch failed: "
                           f"CUDA error {err} (r {tuple(r.shape)} {r.dtype}, "
                           f"w {w.dtype})")


def wkv(r, k, v, w, u, state=None, *, out_state=None, mode=None):
    """WKV-6 scan over (b, t, h, n) inputs from ``state`` (None: zeros).
    Returns (out (b, t, h, n) in r's dtype, final state (b, h, n, n)
    float32): ``out_state`` when given (written in place; it may be
    ``state``), else a new tensor. Differentiable (module docstring)."""
    _check(r, k, v, w, u, state, out_state)
    kt = kernel_mode(r, mode)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w, u,
                                                       state)):
        if out_state is not None:
            raise ValueError("wkv: a state written in place (out_state) "
                             "has no gradient; differentiate with "
                             "out_state=None")
        return _WKV.apply(r, k, v, w, u, state, kt)
    return _forward(r, k, v, w, u, state, out_state, kt)


def _fwd_fake(r, k, v, w, u, state, out_state, kt):
    b, _, h, n = r.shape
    return (r.new_empty(r.shape),
            r.new_empty((b, h, n, n), dtype=torch.float32)
            if out_state is None else out_state)


@seam(_NAME, lambda r, k, v, w, u, state, *_: work.rwkv6_scan(
    *r.shape, itemsize=r.element_size(), state=state is not None,
    w_itemsize=w.element_size()), _fwd_fake)
def _forward(r, k, v, w, u, state, out_state, kt):
    """(out, final state) of :func:`wkv`: the plain version for
    ``KernelType.TORCH``, else the kernel :func:`plan` picks."""
    if kt is KernelType.TORCH:
        out, s = wkv6_ref(r, k, v, w, u, state)
        if out_state is None:
            return out, s
        return out, out_state.copy_(s)
    b, t, h, n = r.shape
    # contiguous, and on 16-byte boundaries (a new allocation is)
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    u = u.to(torch.float32).contiguous()
    if state is not None:
        state = state.to(torch.float32).contiguous()
    if out_state is None:
        out_state = torch.empty((b, h, n, n), dtype=torch.float32,
                                device=r.device)
    out = torch.empty((b, t, h, n), dtype=r.dtype, device=r.device)
    launch(r, k, v, w, u, state, out, out_state)
    return out, out_state


def _aligned(x):
    """``x``, or a contiguous copy where it is not contiguous or not on a
    16-byte boundary."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


class _WKV(torch.autograd.Function):
    """The scan, then :func:`wkv_bwd` from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, kt):
        with torch.no_grad():
            out, s = _forward(r, k, v, w, u, state, None, kt)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.kt = kt
        return out, s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        dr, dk, dv, dw, du, ds = wkv_bwd(r, k, v, w, u, state, dout, dstate,
                                         mode=ctx.kt)
        return (dr, dk, dv, dw, du.to(u.dtype),
                None if state is None else ds.to(state.dtype), None)


def launch_bwd(r, k, v, w, u, state, dout, dstate, grads, snap, *,
               variant=None):
    """One launch of the backward kernel :func:`plan_bwd` picks (or
    ``variant``, named explicitly, as a measurement compares the two) into
    ``grads`` = (dr, dk, dv, dw (r's shape, dr/dk/dv in r's type, dw in
    w's), du_part (b, h, n) float32, dstate0 (b, h, n, n) float32): CUDA
    r, k, v, w, dout (b, t, h, n), u (h, n) float32, ``state`` (b, h, n,
    n) float32 or None (zeros), ``dstate`` (b, h, n, n) float32, ``snap``
    :func:`bwd_scratch` of the variant, all contiguous and 16-byte
    aligned. Checks only what picks the variant: :func:`wkv_bwd` makes the
    rest (a timing loop calls this directly)."""
    b, t, h, n = r.shape
    if variant is None:
        variant = plan_bwd(r, k, v, w, state)
    elif variant not in BWD_VARIANTS:
        raise ValueError(f"rwkv6_scan_bwd variant {variant!r} is not one of "
                         f"{tuple(BWD_VARIANTS)}")
    if variant == "chunked":
        if n != 64 or r.dtype != torch.bfloat16:
            raise ValueError(f"rwkv6_scan_bwd chunked kernel takes bfloat16 "
                             f"r, k, v of head size 64, got {r.dtype}, n {n}")
        if any(x.data_ptr() % 16 for x in (r, k, v, w, dout)):
            raise ValueError("rwkv6_scan_bwd chunked kernel takes r, k, v, w, "
                             "dout on 16-byte boundaries")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (*(x.data_ptr() for x in (r, k, v, w, u)),
            None if state is None else state.data_ptr(),
            *(x.data_ptr() for x in (dout, dstate) + tuple(grads)),
            snap.data_ptr(), b, t, h, stream)
    if variant == "chunked":
        fn = _bwd_chunked_fn()
        count_launch(_BWD)
        err = fn(_DTYPE_CODES[w.dtype], *ptrs)
    else:
        fn = _bwd_fn()
        count_launch(_BWD)
        err = fn(_DTYPE_CODES[r.dtype], _DTYPE_CODES[w.dtype], n, *ptrs)
    BWD_VARIANTS[variant] += 1
    if err:
        raise RuntimeError(f"rwkv6_scan_bwd {variant} kernel launch failed: "
                           f"CUDA error {err} (r {tuple(r.shape)} {r.dtype}, "
                           f"w {w.dtype})")


def _bwd_fake(r, k, v, w, u, state, dout, dstate, **_):
    b, _, h, n = r.shape
    f32 = torch.float32
    return (r.new_empty(r.shape), r.new_empty(r.shape), r.new_empty(r.shape),
            w.new_empty(w.shape), r.new_empty((h, n), dtype=f32),
            r.new_empty((b, h, n, n), dtype=f32))


@seam(_BWD, lambda r, k, v, w, u, state, *_, **__: work.rwkv6_scan_bwd(
    *r.shape, itemsize=r.element_size(), state=state is not None,
    w_itemsize=w.element_size()), _bwd_fake)
def wkv_bwd(r, k, v, w, u, state, dout, dstate, *, mode=None,
            variant=None):
    """The gradient of :func:`wkv` at r, k, v, w, u, ``state`` (None:
    zeros), given the output's cotangent ``dout`` and the final state's
    ``dstate``: (dr, dk, dv in r's type, dw in w's, du (h, n) float32,
    dstate0 (b, h, n, n) float32). For CUDA tensors the kernel
    :func:`plan_bwd` picks, or ``variant`` named explicitly (as a
    measurement compares the two; one the tensors do not fit raises);
    ``ref.wkv6_bwd_ref`` for CPU tensors or ``mode="torch"``."""
    _check(r, k, v, w, u, state, dstate)
    b, t, h, n = r.shape
    if dout.shape != r.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != r {tuple(r.shape)}")
    if kernel_mode(r, mode) is KernelType.TORCH:
        return wkv6_bwd_ref(r, k, v, w, u, state, dout, dstate)
    if n not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan_bwd kernel takes head size n in "
                         f"{HEAD_SIZES}, got {n}")
    if r.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"rwkv6_scan_bwd kernel takes float32 or bfloat16 r "
                        f"and w, got {r.dtype} and {w.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan_bwd kernel takes r, k, v in one type, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    dout = _aligned(dout.to(r.dtype))
    u, dstate = (_aligned(x.to(torch.float32)) for x in (u, dstate))
    if state is not None:
        state = _aligned(state.to(torch.float32))
    dev = r.device
    grads = (torch.empty_like(r), torch.empty_like(r), torch.empty_like(r),
             torch.empty_like(w),
             torch.empty((b, h, n), dtype=torch.float32, device=dev),
             torch.empty((b, h, n, n), dtype=torch.float32, device=dev))
    if variant is None:
        variant = plan_bwd(r, k, v, w, state)
    launch_bwd(r, k, v, w, u, state, dout, dstate, grads,
               bwd_scratch(r, variant), variant=variant)
    dr, dk, dv, dw, du_part, ds = grads
    return dr, dk, dv, dw, du_part.sum(0), ds

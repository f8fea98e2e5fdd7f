"""Public selective-scan op of Mamba's mixer: the CUDA kernels or their
plain version.

:func:`scan` takes xc, dt (b, s, d_in), B, C (b, s, N) (the strided views
of the mixer's ``x_proj`` output), A (d_in, N) float32 and an optional
float32 state h0 (b, d_in, N), and returns y (b, s, d_in) in the
activation dtype and the final state in float32. Which implementation
runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel
(``csrc/mamba_scan.cu``) for CUDA tensors, the plain version
(``ref.scan_ref``) for CPU tensors or an explicit ``mode="torch"``. The
kernel takes xc, dt, B and C in one type, float32 or bfloat16, y in that
type, N = 16, and raises for anything else; nothing falls back to the
plain version for a CUDA tensor. Each launch adds one to
``LAUNCHES["mamba_scan"]``.

The op is differentiable in xc, dt, B, C, A and h0. When grad mode is
on and one of them requires a gradient, the forward also writes the
float32 state at the start of every ``segment`` steps of the plain
version, ``SNAPSHOT_EVERY`` of the kernel (its snapshots: b * ceil(s /
32) * d_in * N floats, 134.2 MB at Jamba's (4, 1,024, 16,384, 16)) and
saves them beside its inputs; the backward is
:func:`scan_bwd`: the kernel ``csrc/mamba_scan_bwd.cu`` on CUDA tensors,
``ref.scan_bwd_ref`` on the CPU or with ``mode="torch"``. It returns
the gradients autograd asks for (``ctx.needs_input_grad``; dh0 is
computed only when h0 needs one). Each backward launch (a scan kernel
and the kernel that sums its partial dB, dC and dA in a fixed order,
both in one call) adds one to ``LAUNCHES["mamba_scan_bwd"]``.

``segment`` sets the plain version's steps a segment (the model's
``SCAN_BLOCK``); the kernels always take ``SNAPSHOT_EVERY``. The output
does not depend on it but for the read-out's summation order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode
from repro_torch.kernels.mamba_scan.ref import SEGMENT, scan_bwd_ref, \
    scan_ref

__all__ = ["BWD_CHANNELS", "D_STATE", "KERNELS", "SEGMENT",
           "SNAPSHOT_EVERY", "bwd_scratch", "launch", "launch_bwd", "scan",
           "scan_bwd"]

_NAME = "mamba_scan"
_BWD = "mamba_scan_bwd"
KERNELS = (_NAME, _BWD)
D_STATE = 16                      # the kernels' state size N
BWD_CHANNELS = 64                 # channels a CTA of the backward kernel
SNAPSHOT_EVERY = 32               # the kernels' steps between snapshots
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn(lib, name, argtypes):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _scan_fn():
    return _fn(_NAME, "mamba_scan", [_I] + [_P] * 4 + [_L] * 2 + [_P] * 5
               + [_I] * 3 + [_P])


def _bwd_fn():
    return _fn(_BWD, "mamba_scan_bwd", [_I] + [_P] * 4 + [_L] * 2
               + [_P] * 12 + [_I] * 3 + [_P])


def _check(xc, dt, b_mat, c_mat, a, h0):
    if xc.dim() != 3:
        raise ValueError(f"scan takes (b, s, d_in) xc and dt; xc is "
                         f"{tuple(xc.shape)}")
    b, s, d_in = xc.shape
    if dt.shape != xc.shape:
        raise ValueError(f"dt {tuple(dt.shape)} != xc {tuple(xc.shape)}")
    if a.dim() != 2 or a.shape[0] != d_in:
        raise ValueError(f"A {tuple(a.shape)} is not (d_in, N) with d_in "
                         f"{d_in}")
    n = a.shape[1]
    for name, m in (("B", b_mat), ("C", c_mat)):
        if m.shape != (b, s, n):
            raise ValueError(f"{name} {tuple(m.shape)} is not (b, s, N) = "
                             f"{(b, s, n)}")
    if h0 is not None and h0.shape != (b, d_in, n):
        raise ValueError(f"h0 {tuple(h0.shape)} is not (b, d_in, N) = "
                         f"{(b, d_in, n)}")
    devs = {x.device for x in (xc, dt, b_mat, c_mat, a, h0) if x is not None}
    if len(devs) != 1:
        raise ValueError(f"scan operands on several devices: {devs}")


def _bc_views(b_mat, c_mat):
    """B and C as the kernels read them: unit stride along N and one pair
    of (batch, step) strides for both (the views ``x_proj``'s split
    gives), else contiguous copies of both."""
    if (b_mat.stride(2) == 1 and c_mat.stride(2) == 1
            and b_mat.stride()[:2] == c_mat.stride()[:2]):
        return b_mat, c_mat
    return b_mat.contiguous(), c_mat.contiguous()


def _check_kernel(name, xc, dt, b_mat, c_mat, a, out_dtype):
    """Raise for what the kernels do not take."""
    if xc.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 xc, got "
                        f"{xc.dtype}")
    if any(x.dtype != xc.dtype for x in (dt, b_mat, c_mat)) or \
            out_dtype != xc.dtype:
        raise TypeError(f"{name} kernel takes xc, dt, B, C and y in one "
                        f"type, got {xc.dtype}, {dt.dtype}, {b_mat.dtype}, "
                        f"{c_mat.dtype} and {out_dtype}")
    if a.shape[1] != D_STATE:
        raise ValueError(f"{name} kernel takes N = {D_STATE}, got "
                         f"{a.shape[1]}")


def launch(xc, dt, b_mat, c_mat, a, h0, y, h_out, snaps=None):
    """One launch of the forward kernel into given outputs: xc, dt and y
    (b, s, d_in) contiguous, B and C from :func:`_bc_views`' rule, a
    (d_in, N) and h0 (b, d_in, N) (or None: zeros) float32 contiguous,
    h_out (b, d_in, N) float32, ``snaps`` None or (b, ceil(s / SNAPSHOT_EVERY),
    d_in, N) float32; all on one CUDA device, checked by :func:`scan`
    (a timing loop calls this directly)."""
    b, s, d_in = xc.shape
    if b * s * d_in == 0:
        return
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    fn = _scan_fn()
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[xc.dtype], xc.data_ptr(), dt.data_ptr(),
             b_mat.data_ptr(), c_mat.data_ptr(), b_mat.stride(0),
             b_mat.stride(1), a.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h_out.data_ptr(), None if snaps is None else snaps.data_ptr(),
             b, s, d_in, stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err} (xc {tuple(xc.shape)} {xc.dtype})")


def scan(xc, dt, b_mat, c_mat, a, h0=None, *, segment=SEGMENT,
         out_dtype=None, mode=None):
    """The selective scan from ``h0`` (None: zeros). Returns (y (b, s,
    d_in) in ``out_dtype`` (default xc's), the final state (b, d_in, N)
    float32). Differentiable (module docstring)."""
    _check(xc, dt, b_mat, c_mat, a, h0)
    kt = kernel_mode(xc, mode)
    out_dtype = out_dtype or xc.dtype
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (xc, dt, b_mat, c_mat, a, h0)):
        return _Scan.apply(xc, dt, b_mat, c_mat, a, h0, segment, out_dtype,
                           kt)
    return _forward(xc, dt, b_mat, c_mat, a, h0, segment, out_dtype, kt,
                    False)[:2]


def _forward(xc, dt, b_mat, c_mat, a, h0, segment, out_dtype, kt,
             snapshots):
    """(y, final state, snapshots or None) of :func:`scan`: the plain
    version for ``KernelType.TORCH``, else the kernel."""
    if kt is KernelType.TORCH:
        out = scan_ref(xc, dt, b_mat, c_mat, a, h0, segment=segment,
                       snapshots=snapshots, out_dtype=out_dtype)
        return out if snapshots else (*out, None)
    _check_kernel(_NAME, xc, dt, b_mat, c_mat, a, out_dtype)
    b, s, d_in = xc.shape
    xc, dt = xc.contiguous(), dt.contiguous()
    b_mat, c_mat = _bc_views(b_mat, c_mat)
    a = a.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    dev = xc.device
    y = torch.empty((b, s, d_in), dtype=out_dtype, device=dev)
    h_out = torch.empty((b, d_in, D_STATE), dtype=torch.float32, device=dev)
    snaps = (torch.empty((b, -(-s // SNAPSHOT_EVERY), d_in, D_STATE),
                         dtype=torch.float32, device=dev)
             if snapshots else None)
    launch(xc, dt, b_mat, c_mat, a, h0, y, h_out, snaps)
    return y, h_out, snaps


class _Scan(torch.autograd.Function):
    """The scan with its snapshots, then :func:`scan_bwd` from them."""

    @staticmethod
    def forward(ctx, xc, dt, b_mat, c_mat, a, h0, segment, out_dtype, kt):
        with torch.no_grad():
            y, h, snaps = _forward(xc, dt, b_mat, c_mat, a, h0, segment,
                                   out_dtype, kt, True)
        ctx.save_for_backward(xc, dt, b_mat, c_mat, a, snaps)
        ctx.segment, ctx.kt = segment, kt
        return y, h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh):
        xc, dt, b_mat, c_mat, a, snaps = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        if not any(need):
            return (None,) * 9
        grads = scan_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh,
                         segment=ctx.segment, want_dh0=need[5], mode=ctx.kt)
        return tuple(g if want else None
                     for g, want in zip(grads, need)) + (None,) * 3


def bwd_scratch(xc):
    """The backward kernel's float32 scratch for xc's shape: the partial
    dC and dB of each CTA of BWD_CHANNELS channels, (b, s, ceil(d_in /
    BWD_CHANNELS), 2 N) (134.2 MB at Jamba's shape), and the partial dA of
    each batch row, (b, d_in, N)."""
    b, s, d_in = xc.shape
    blocks = -(-d_in // BWD_CHANNELS)
    return (torch.empty((b, s, blocks, 2 * D_STATE), dtype=torch.float32,
                        device=xc.device),
            torch.empty((b, d_in, D_STATE), dtype=torch.float32,
                        device=xc.device))


def launch_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh, grads, scratch):
    """One call of the backward (its scan kernel, then the kernel that sums
    the partials) into ``grads`` = (dxc (xc's shape and type), ddt (dt's),
    dB, dC ((b, s, N) contiguous in B's type), dA (d_in, N) float32, dh0
    (b, d_in, N) float32 or None): CUDA tensors as :func:`launch` takes
    them, ``snaps`` the forward's, dy (b, s, d_in) contiguous in xc's type,
    dh (b, d_in, N) float32 or None (zeros), ``scratch``
    :func:`bwd_scratch`. Checks nothing: :func:`scan_bwd` makes the
    operands (a timing loop calls this directly)."""
    b, s, d_in = xc.shape
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    dx, ddt, db, dc, da, dh0 = grads
    fn = _bwd_fn()
    count_launch(_BWD)
    err = fn(_DTYPE_CODES[xc.dtype], xc.data_ptr(), dt.data_ptr(),
             b_mat.data_ptr(), c_mat.data_ptr(), b_mat.stride(0),
             b_mat.stride(1), a.data_ptr(), snaps.data_ptr(), dy.data_ptr(),
             None if dh is None else dh.data_ptr(), dx.data_ptr(),
             ddt.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
             None if dh0 is None else dh0.data_ptr(), scratch[0].data_ptr(),
             scratch[1].data_ptr(), b, s, d_in, stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed: CUDA error "
                           f"{err} (xc {tuple(xc.shape)} {xc.dtype})")


def scan_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh=None, *,
             segment=SEGMENT, want_dh0=False, mode=None):
    """The gradient of :func:`scan` from the forward's snapshots
    ``snaps`` (the plain version's at ``segment``, the kernel's at
    SNAPSHOT_EVERY), given y's cotangent ``dy`` and the final state's ``dh``
    (None: zeros): (dxc, ddt, dB, dC in their inputs' types, dA (d_in,
    N) float32, dh0 (b, d_in, N) float32 with ``want_dh0``, else None).
    The backward kernel for CUDA tensors; ``ref.scan_bwd_ref`` for CPU
    tensors or ``mode="torch"``."""
    _check(xc, dt, b_mat, c_mat, a, None)
    b, s, d_in = xc.shape
    if dy.shape != xc.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != xc {tuple(xc.shape)}")
    if kernel_mode(xc, mode) is KernelType.TORCH:
        return scan_bwd_ref(xc, dt, b_mat, c_mat, a, None, dy, dh,
                            snaps=snaps, segment=segment, want_dh0=want_dh0)
    _check_kernel(_BWD, xc, dt, b_mat, c_mat, a, xc.dtype)
    if snaps.shape != (b, -(-s // SNAPSHOT_EVERY), d_in, D_STATE) or \
            snaps.dtype != torch.float32:
        raise ValueError(f"mamba_scan_bwd takes the kernel's snapshots, "
                         f"(b, ceil(s / {SNAPSHOT_EVERY}), d_in, N) float32; "
                         f"got "
                         f"{tuple(snaps.shape)} {snaps.dtype}")
    xc, dt = xc.contiguous(), dt.contiguous()
    b_mat, c_mat = _bc_views(b_mat, c_mat)
    a, snaps = a.to(torch.float32).contiguous(), snaps.contiguous()
    dy = dy.to(xc.dtype).contiguous()
    if dh is not None:
        dh = dh.to(torch.float32).contiguous()
    dev, f32 = xc.device, torch.float32
    grads = (torch.empty_like(xc), torch.empty_like(dt),
             torch.empty((b, s, D_STATE), dtype=b_mat.dtype, device=dev),
             torch.empty((b, s, D_STATE), dtype=c_mat.dtype, device=dev),
             torch.empty((d_in, D_STATE), dtype=f32, device=dev),
             torch.empty((b, d_in, D_STATE), dtype=f32, device=dev)
             if want_dh0 else None)
    if b * s * d_in:
        launch_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh, grads,
                   bwd_scratch(xc))
    return grads

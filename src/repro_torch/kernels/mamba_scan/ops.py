"""Public selective-scan op of Mamba's mixer: the CUDA kernels or their
plain version.

:func:`scan` takes xc, dt (b, s, d_in), B, C (b, s, N) (the strided views
of the mixer's ``x_proj`` output), A (d_in, N) float32 and an optional
float32 state h0 (b, d_in, N), and returns y (b, s, d_in) in the
activation dtype and the final state in float32. Which implementation
runs follows the tensors' device
(:func:`repro_torch.kernels.interface.kernel_mode`): a kernel for CUDA
tensors, the plain version (``ref.scan_ref``) for CPU tensors or an
explicit ``mode="torch"``. Both kernels take xc, dt, B and C in one type,
float32 or bfloat16, y in that type, N = 16, and raise for anything else;
nothing falls back to the plain version for a CUDA tensor. On a CUDA
tensor :func:`plan` picks one of two variants by shape, written out (no
variant gives way to another):

  * ``"ring"``: d_in a multiple of 128 (Jamba's 16,384), either type.
    ``csrc/mamba_scan_hopper.cu``: exp(dt A) as one MUFU.EX2 of dt A log2 e,
    dt, x, B and C through a cp.async ring in shared memory, a thread a
    (batch, channel).
  * ``"simt"``: everything else. ``csrc/mamba_scan.cu``: the accurate expf,
    a thread a (batch, channel).

Each launch adds one to ``LAUNCHES["mamba_scan"]`` and to
``VARIANTS[variant]``.

The op is differentiable in xc, dt, B, C, A and h0. When grad mode is
on and one of them requires a gradient, the forward also writes the
float32 state at the start of every ``segment`` steps (the plain version)
or every ``SNAPSHOT_EVERY[variant]`` steps (a kernel: 8 for ``ring``,
536.9 MB at Jamba's (4, 1,024, 16,384, 16); 32 for ``simt``, 134.2 MB)
and saves them beside its inputs, with their cadence. The backward is
:func:`scan_bwd`: ``ref.scan_bwd_ref`` on the CPU or with
``mode="torch"``; on CUDA tensors the backward kernel :func:`plan_bwd`
takes for that cadence, the forward variant's own (its recomputed states
are the forward's bit for bit):

  * ``"ring"``: ``csrc/mamba_scan_bwd_hopper.cu``, a window of 8 steps
    from each snapshot, a thread 4 state elements of 2 channels, dB and dC
    summed by shuffles into partials of 128 channels.
  * ``"simt"``: ``csrc/mamba_scan_bwd.cu``, from snapshots every 32 steps,
    a thread a channel, partials of 64 channels.

It returns the gradients autograd asks for (``ctx.needs_input_grad``;
dh0 is computed only when h0 needs one). Each backward call (the scan
kernel and the two kernels that sum its partial dB, dC and dA in a fixed
order) adds one to ``LAUNCHES["mamba_scan_bwd"]`` and to
``BWD_VARIANTS[variant]``.

``segment`` sets the plain version's steps a segment (the model's
``SCAN_BLOCK``); the kernels take their own cadence. The output does not
depend on it but for the read-out's summation order.

The scan and its backward are seams
(:func:`repro_torch.kernels.interface.seam`): each records
``roofline.kernels.mamba_scan`` under an active work counter and returns
empty outputs of its shapes on fake tensors (the forward's snapshots at
the cadence of the path it stands for).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode, seam
from repro_torch.kernels.mamba_scan.ref import SEGMENT, scan_bwd_ref, \
    scan_ref
from repro_torch.roofline import kernels as work

__all__ = ["BWD_CHANNELS", "BWD_VARIANTS", "D_STATE", "KERNELS",
           "RING_CHANNELS", "SEGMENT", "SNAPSHOT_EVERY", "VARIANTS",
           "bwd_scratch", "launch", "launch_bwd", "plan", "plan_bwd",
           "reset_variants", "scan", "scan_bwd"]

_NAME = "mamba_scan"
_BWD = "mamba_scan_bwd"
KERNELS = (_NAME, _BWD)
D_STATE = 16                      # the kernels' state size N
RING_CHANNELS = 128               # ring: channels a CTA (d_in's multiple)
# the backward kernels' channels a CTA, whose partial dB, dC it writes
BWD_CHANNELS = {"ring": RING_CHANNELS, "simt": 64}
# each forward variant's steps between snapshots, which its backward reads
# (fixed in each kernel, so the cadence names the variant that wrote them)
SNAPSHOT_EVERY = {"ring": 8, "simt": 32}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# variant -> launches that ran it since the last reset_variants(): the
# forward's and the backward's
VARIANTS = {"ring": 0, "simt": 0}
BWD_VARIANTS = {"ring": 0, "simt": 0}


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


def _scan_fn():
    return _fn(_NAME, "mamba_scan", [_I] + [_P] * 4 + [_L] * 2 + [_P] * 5
               + [_I] * 3 + [_P])


def _bwd_fn():
    return _fn(_BWD, "mamba_scan_bwd", [_I] + [_P] * 4 + [_L] * 2
               + [_P] * 12 + [_I] * 3 + [_P])


def _scan_ring_fn():
    return _fn("mamba_scan_hopper", "mamba_scan_ring", [_I] + [_P] * 4
               + [_L] * 2 + [_P] * 5 + [_I] * 3 + [_P])


def _bwd_ring_fn():
    return _fn("mamba_scan_bwd_hopper", "mamba_scan_bwd_ring", [_I]
               + [_P] * 4 + [_L] * 2 + [_P] * 12 + [_I] * 3 + [_P])


def plan(xc, dt, b_mat, c_mat, a, h0=None):
    """The forward kernel variant :func:`scan` launches for these tensors:
    ``"ring"`` where d_in is a multiple of RING_CHANNELS (and b at most
    65,535), ``"simt"`` otherwise. A pure function of shapes: the types
    both variants take are checked at launch, and B, C that are not
    16-byte aligned views are copied for ``ring``."""
    b, _, d_in = xc.shape
    if d_in >= RING_CHANNELS and d_in % RING_CHANNELS == 0 and b <= 65535:
        return "ring"
    return "simt"


def plan_bwd(xc, dt, b_mat, c_mat, a, every=None):
    """The backward kernel :func:`scan_bwd` launches for these tensors and
    snapshots every ``every`` steps (None: the cadence of the forward
    variant :func:`plan` picks): the forward variant that writes that
    cadence (``"ring"`` where :func:`plan` picks it and every is
    SNAPSHOT_EVERY["ring"], ``"simt"`` where every is
    SNAPSHOT_EVERY["simt"]), so that the backward recomputes states by the
    expression that wrote them. Raises for a cadence neither takes."""
    fwd = plan(xc, dt, b_mat, c_mat, a)
    if every is None:
        every = SNAPSHOT_EVERY[fwd]
    if fwd == "ring" and every == SNAPSHOT_EVERY["ring"]:
        return "ring"
    if every == SNAPSHOT_EVERY["simt"]:
        return "simt"
    raise ValueError(f"no mamba_scan_bwd kernel reads snapshots every "
                     f"{every} steps at xc {tuple(xc.shape)} (ring: "
                     f"{SNAPSHOT_EVERY['ring']}, d_in a multiple of "
                     f"{RING_CHANNELS}; simt: {SNAPSHOT_EVERY['simt']})")


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


def _aligned16(x):
    return x.data_ptr() % 16 == 0


def _bc_views(b_mat, c_mat, variant="simt"):
    """B and C as the kernels read them: unit stride along N and one pair
    of (batch, step) strides for both (the views ``x_proj``'s split
    gives), for ``ring`` also 16-byte aligned pointers and strides, else
    contiguous copies of both."""
    ok = (b_mat.stride(2) == 1 and c_mat.stride(2) == 1
          and b_mat.stride()[:2] == c_mat.stride()[:2])
    if ok and variant == "ring":
        es = b_mat.element_size()
        ok = (_aligned16(b_mat) and _aligned16(c_mat)
              and all(st * es % 16 == 0 for st in b_mat.stride()[:2]))
    if ok:
        return b_mat, c_mat
    return b_mat.contiguous(), c_mat.contiguous()


def _contiguous16(x):
    """``x`` contiguous and on a 16-byte boundary (a copy where needed)."""
    if x.is_contiguous() and _aligned16(x):
        return x
    return x.clone(memory_format=torch.contiguous_format)


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


def _variant_and_cadence(name, xc, variant, every):
    """Check ``variant`` (a name of VARIANTS) against what its kernel takes
    and ``every`` (None: the variant's) against its cadence,
    SNAPSHOT_EVERY[variant]; return the cadence."""
    if variant not in VARIANTS:
        raise ValueError(f"{name} variant {variant!r} is not one of "
                         f"{tuple(VARIANTS)}")
    if variant == "ring":
        b, _, d_in = xc.shape
        if d_in < RING_CHANNELS or d_in % RING_CHANNELS or b > 65535:
            raise ValueError(f"{name} ring kernel takes d_in a multiple of "
                             f"{RING_CHANNELS} and b <= 65535, got "
                             f"{tuple(xc.shape)}")
    if every is not None and every != SNAPSHOT_EVERY[variant]:
        raise ValueError(f"{name} {variant} kernel takes snapshots every "
                         f"{SNAPSHOT_EVERY[variant]} steps, got {every}")
    return SNAPSHOT_EVERY[variant]


def launch(xc, dt, b_mat, c_mat, a, h0, y, h_out, snaps=None, *,
           variant=None):
    """One launch of the forward kernel :func:`plan` picks (or
    ``variant``, named explicitly, as a measurement compares the two) into
    given outputs: xc, dt and y (b, s, d_in) contiguous, B and C from
    :func:`_bc_views`' rule, a (d_in, N) and h0 (b, d_in, N) (or None:
    zeros) float32 contiguous, h_out (b, d_in, N) float32, ``snaps`` None
    or (b, ceil(s / SNAPSHOT_EVERY[variant]), d_in, N) float32; all on one
    CUDA device and, for ``ring``, on 16-byte boundaries; the types checked
    by :func:`scan` (a timing loop calls this directly)."""
    b, s, d_in = xc.shape
    if variant is None:
        variant = plan(xc, dt, b_mat, c_mat, a, h0)
    _variant_and_cadence(_NAME, xc, variant, None)
    if b * s * d_in == 0:
        return
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    args = (xc.data_ptr(), dt.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), b_mat.stride(0), b_mat.stride(1),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(),
            None if snaps is None else snaps.data_ptr(), b, s, d_in, stream)
    fn = _scan_ring_fn() if variant == "ring" else _scan_fn()
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[xc.dtype], *args)
    VARIANTS[variant] += 1
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed ({variant}): "
                           f"CUDA error {err} (xc {tuple(xc.shape)} "
                           f"{xc.dtype})")


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


def _fwd_fake(xc, dt, b_mat, c_mat, a, h0, segment, out_dtype, kt,
              snapshots, variant=None):
    (b, s, d_in), n = xc.shape, a.shape[1]
    f32 = torch.float32
    every = (segment if kt is KernelType.TORCH else
             SNAPSHOT_EVERY[variant or plan(xc, dt, b_mat, c_mat, a, h0)])
    return (xc.new_empty(xc.shape, dtype=out_dtype or xc.dtype),
            xc.new_empty((b, d_in, n), dtype=f32),
            xc.new_empty((b, -(-s // every), d_in, n), dtype=f32)
            if snapshots else None)


@seam(_NAME, lambda xc, dt, b_mat, c_mat, a, h0, *_, **__: work.mamba_scan(
    *xc.shape, a.shape[1], itemsize=xc.element_size(), backward=False,
    state=h0 is not None), _fwd_fake)
def _forward(xc, dt, b_mat, c_mat, a, h0, segment, out_dtype, kt,
             snapshots, variant=None):
    """(y, final state, snapshots or None) of :func:`scan`: the plain
    version for ``KernelType.TORCH`` (snapshots every ``segment`` steps),
    else the kernel :func:`plan` picks (or ``variant``; snapshots every
    SNAPSHOT_EVERY[variant] steps)."""
    if kt is KernelType.TORCH:
        out = scan_ref(xc, dt, b_mat, c_mat, a, h0, segment=segment,
                       snapshots=snapshots, out_dtype=out_dtype)
        return out if snapshots else (*out, None)
    _check_kernel(_NAME, xc, dt, b_mat, c_mat, a, out_dtype)
    b, s, d_in = xc.shape
    if variant is None:
        variant = plan(xc, dt, b_mat, c_mat, a, h0)
    every = _variant_and_cadence(_NAME, xc, variant, None)
    xc, dt = _contiguous16(xc), _contiguous16(dt)
    b_mat, c_mat = _bc_views(b_mat, c_mat, variant)
    a = a.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    dev = xc.device
    y = torch.empty((b, s, d_in), dtype=out_dtype, device=dev)
    h_out = torch.empty((b, d_in, D_STATE), dtype=torch.float32, device=dev)
    snaps = (torch.empty((b, -(-s // every), d_in, D_STATE),
                         dtype=torch.float32, device=dev)
             if snapshots else None)
    launch(xc, dt, b_mat, c_mat, a, h0, y, h_out, snaps, variant=variant)
    return y, h_out, snaps


class _Scan(torch.autograd.Function):
    """The scan with its snapshots, then :func:`scan_bwd` from them; the
    context keeps the snapshots' cadence (``ctx.every``: the kernel
    variant's SNAPSHOT_EVERY, or ``segment`` on the plain path)."""

    @staticmethod
    def forward(ctx, xc, dt, b_mat, c_mat, a, h0, segment, out_dtype, kt):
        every = (segment if kt is KernelType.TORCH
                 else SNAPSHOT_EVERY[plan(xc, dt, b_mat, c_mat, a, h0)])
        with torch.no_grad():
            y, h, snaps = _forward(xc, dt, b_mat, c_mat, a, h0, segment,
                                   out_dtype, kt, True)
        ctx.save_for_backward(xc, dt, b_mat, c_mat, a, snaps)
        ctx.segment, ctx.kt, ctx.every = segment, kt, every
        return y, h

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dh):
        xc, dt, b_mat, c_mat, a, snaps = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        if not any(need):
            return (None,) * 9
        every = None if ctx.kt is KernelType.TORCH else ctx.every
        grads = scan_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh,
                         segment=ctx.segment, every=every,
                         want_dh0=need[5], mode=ctx.kt)
        return tuple(g if want else None
                     for g, want in zip(grads, need)) + (None,) * 3


def bwd_scratch(xc, variant):
    """The backward kernel's float32 scratch for xc's shape and
    ``variant``: the partial dC and dB of each CTA of BWD_CHANNELS[variant]
    channels, (b, s, ceil(d_in / channels), 2 N) (67.1 MB for ``ring``,
    134.2 MB for ``simt`` at Jamba's shape), and the partial dA of each
    batch row, (b, d_in, N)."""
    b, s, d_in = xc.shape
    blocks = -(-d_in // BWD_CHANNELS[variant])
    return (torch.empty((b, s, blocks, 2 * D_STATE), dtype=torch.float32,
                        device=xc.device),
            torch.empty((b, d_in, D_STATE), dtype=torch.float32,
                        device=xc.device))


def launch_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh, grads, scratch, *,
               variant=None):
    """One call of the backward :func:`plan_bwd` picks (or ``variant``,
    named explicitly) -- its scan kernel, then the kernels that sum the
    partials -- into ``grads`` = (dxc (xc's shape and type), ddt (dt's),
    dB, dC ((b, s, N) contiguous in B's type), dA (d_in, N) float32, dh0
    (b, d_in, N) float32 or None): CUDA tensors as :func:`launch` takes
    them, ``snaps`` the same variant's forward's, dy (b, s, d_in)
    contiguous in xc's type, dh (b, d_in, N) float32 or None (zeros),
    ``scratch`` :func:`bwd_scratch` of the variant. Checks the variant
    only: :func:`scan_bwd` makes the operands (a timing loop calls this
    directly)."""
    b, s, d_in = xc.shape
    if variant is None:
        variant = plan_bwd(xc, dt, b_mat, c_mat, a)
    _variant_and_cadence(_BWD, xc, variant, None)
    stream = torch.cuda.current_stream(xc.device).cuda_stream
    dx, ddt, db, dc, da, dh0 = grads
    args = (xc.data_ptr(), dt.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), b_mat.stride(0), b_mat.stride(1),
            a.data_ptr(), snaps.data_ptr(), dy.data_ptr(),
            None if dh is None else dh.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
            None if dh0 is None else dh0.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), b, s, d_in, stream)
    fn = _bwd_ring_fn() if variant == "ring" else _bwd_fn()
    count_launch(_BWD)
    err = fn(_DTYPE_CODES[xc.dtype], *args)
    BWD_VARIANTS[variant] += 1
    if err:
        raise RuntimeError(f"mamba_scan_bwd kernel launch failed "
                           f"({variant}): CUDA error {err} (xc "
                           f"{tuple(xc.shape)} {xc.dtype})")


def _bwd_fake(xc, dt, b_mat, c_mat, a, snaps, dy, dh=None, *,
              want_dh0=False, **_):
    (b, s, d_in), n = xc.shape, a.shape[1]
    f32 = torch.float32
    return (xc.new_empty(xc.shape), dt.new_empty(dt.shape),
            b_mat.new_empty((b, s, n)), c_mat.new_empty((b, s, n)),
            a.new_empty((d_in, n), dtype=f32),
            a.new_empty((b, d_in, n), dtype=f32) if want_dh0 else None)


def _bwd_work(xc, dt, b_mat, c_mat, a, snaps, dy, dh=None, *,
              want_dh0=False, **_):
    return work.mamba_scan(*xc.shape, a.shape[1],
                           itemsize=xc.element_size(), backward=True,
                           state=want_dh0, final=dh is not None)


@seam(_BWD, _bwd_work, _bwd_fake)
def scan_bwd(xc, dt, b_mat, c_mat, a, snaps, dy, dh=None, *,
             segment=SEGMENT, every=None, variant=None, want_dh0=False,
             mode=None):
    """The gradient of :func:`scan` from the forward's snapshots
    ``snaps`` (the plain version's at ``segment``; a kernel's every
    ``every`` steps, None: the cadence of the variant :func:`plan` picks),
    given y's cotangent ``dy`` and the final state's ``dh`` (None:
    zeros): (dxc, ddt, dB, dC in their inputs' types, dA (d_in, N)
    float32, dh0 (b, d_in, N) float32 with ``want_dh0``, else None). The
    backward kernel :func:`plan_bwd` takes for that cadence (or
    ``variant``, named explicitly; ``every`` must then be None or its
    cadence) for CUDA tensors; ``ref.scan_bwd_ref`` for CPU tensors or
    ``mode="torch"``."""
    _check(xc, dt, b_mat, c_mat, a, None)
    b, s, d_in = xc.shape
    if dy.shape != xc.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != xc {tuple(xc.shape)}")
    if kernel_mode(xc, mode) is KernelType.TORCH:
        return scan_bwd_ref(xc, dt, b_mat, c_mat, a, None, dy, dh,
                            snaps=snaps, segment=segment, want_dh0=want_dh0)
    _check_kernel(_BWD, xc, dt, b_mat, c_mat, a, xc.dtype)
    if variant is None:
        variant = plan_bwd(xc, dt, b_mat, c_mat, a, every)
    every = _variant_and_cadence(_BWD, xc, variant, every)
    if snaps.shape != (b, -(-s // every), d_in, D_STATE) or \
            snaps.dtype != torch.float32:
        raise ValueError(f"mamba_scan_bwd {variant} takes its forward's "
                         f"snapshots, (b, ceil(s / {every}), d_in, N) "
                         f"float32; got {tuple(snaps.shape)} {snaps.dtype}")
    xc, dt = _contiguous16(xc), _contiguous16(dt)
    b_mat, c_mat = _bc_views(b_mat, c_mat, variant)
    a, snaps = a.to(torch.float32).contiguous(), _contiguous16(snaps)
    dy = _contiguous16(dy.to(xc.dtype))
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
                   bwd_scratch(xc, variant), variant=variant)
    return grads

"""Public MoE routing ops: the CUDA router kernels or their plain version.

:func:`route_tokens` is the MoE layer's routing in one op: it takes the
tokens x (t, d), float32 or bfloat16, and the float32 router weight w
(d, E), and returns the top-k gates (float32), the expert ids, each
choice's position in its expert's capacity buffer (int32, before
capacity) and the load statistics ``mean_prob`` and ``frac_tokens``. On a
CUDA tensor it launches the fused kernel (``csrc/moe_router_hopper.cu``:
the router product on the tensor cores, softmax, top-k, positions and
statistics), in the form :func:`plan` picks; E <= 64.

:func:`route_topk` routes given logits (t, E), float32 or bfloat16, E <=
64 for the kernel (``csrc/moe_router.cu``), the counterpart of the JAX
package's ``route``; it writes per-block partial statistics (blocks, 2,
E), summed here as the reference sums its blocks', with no float
atomics.

Which implementation runs follows the tensor's device
(:func:`repro_torch.kernels.interface.kernel_mode`): a kernel for a CUDA
tensor, the plain version (``ref.py``) for a CPU tensor or an explicit
``mode="torch"``; a CUDA tensor launches its kernel or raises. Each op
call adds one to ``LAUNCHES["moe_router"]``, and to ``VARIANTS["fused"]``
or ``VARIANTS["logits"]``; a fused launch also to ``FORMS["tile"]`` or
``FORMS["split"]``, the form it ran.

Both ops are differentiable: the gates in the logits (and so in x and
w), ``mean_prob`` likewise; the ids, the positions and ``frac_tokens``
carry no gradient. When grad mode is on and an input requires a
gradient, the fused kernel also writes the float32 logits it took the
softmax of (an optional pointer; without a gradient it writes none).
:func:`route_topk`'s backward is :func:`logits_bwd`: on CUDA tensors the
kernel ``csrc/moe_router_bwd.cu``, on CPU tensors or with ``mode="torch"``
``ref.route_tokens_bwd_ref``. :func:`route_tokens`' backward is
:func:`tokens_bwd`, dl and the router product's ``dx = dl w^T`` (in x's
type) and ``dw = f32(x)^T dl`` (float32) in the variant :func:`plan_bwd`
picks: ``fused`` (bfloat16 x: one kernel, ``csrc/moe_router_bwd_hopper.cu``,
dl once a row, then both products on the tensor cores) or
``logits`` (float32 x: ``moe_router_bwd.cu``'s dl and two float32
``torch.matmul`` products); on CPU tensors ``ref.route_tokens_full_bwd_ref``.
Every backward launch adds one to ``LAUNCHES["moe_router_bwd"]`` and to
``BWD_VARIANTS["fused"]`` or ``BWD_VARIANTS["logits"]``.

The four ops' forwards and backwards are seams
(:func:`repro_torch.kernels.interface.seam`): each records its
``roofline.kernels`` work (``moe_router``, ``moe_router_bwd``,
``route_topk``, ``route_topk_bwd``) under the kernel's launch name under
an active work counter, and returns empty outputs of its shapes on fake
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode, seam
from repro_torch.kernels.moe_router.ref import route_ref, \
    route_tokens_bwd_ref, route_tokens_full_bwd_ref, route_tokens_ref
from repro_torch.roofline import kernels as work

__all__ = ["BLOCK_TOKENS", "BWD_VARIANTS", "FORMS", "KERNELS", "MAX_EXPERTS",
           "SLICE_D", "VARIANTS", "launch", "launch_bwd", "launch_bwd_fused",
           "launch_fused", "logits_bwd", "plan", "plan_bwd", "reset_variants",
           "route_tokens", "route_topk", "tokens_bwd"]

_NAME = "moe_router"
_FUSED = "moe_router_hopper"
_BWD = "moe_router_bwd"               # the launch count of both backwards
_BWD_FUSED = "moe_router_bwd_hopper"
KERNELS = (_NAME, _BWD)
MAX_EXPERTS = 64
BLOCK_TOKENS = 16          # token rows per block of the kernel (stats row)
SPLIT_TOKENS = 32          # the fused op's split form: at most this many
_CHUNK = 64                # values of d a stage of the fused kernel
SLICE_D = 128              # values of d a CTA of the fused backward
_BWD_STAGE = 64            # token rows a stage of the fused backward
_SMS = 132                 # H100 SXM: the fused backward's grid fills them
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# variant -> launches that ran it since the last reset_variants()
VARIANTS = {"fused": 0, "logits": 0}
# the fused kernel's form (plan's "form") -> launches since the last reset
FORMS = {"tile": 0, "split": 0}
# the backward's variant (plan_bwd's "variant") -> launches since the last
# reset; route_topk's backward counts as "logits"
BWD_VARIANTS = {"fused": 0, "logits": 0}


def reset_variants() -> None:
    """Set every variant's and every form's count to 0."""
    for counts in (VARIANTS, FORMS, BWD_VARIANTS):
        for name in counts:
            counts[name] = 0


def _fn(lib, name, argtypes):
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _library():
    return _fn(_NAME, "moe_router", [_I] + [_P] * 4 + [_L] + [_I] * 4 + [_P])


def _fused_fn():
    return _fn(_FUSED, "moe_route_tokens", [_I, _P, _L, _P] + [_I] * 8
               + [_P] * 9)


def _bwd_fn():
    return _fn(_BWD, "moe_router_bwd", [_P] * 6 + [_I] * 4 + [_P])


def _bwd_fused_fn():
    return _fn(_BWD_FUSED, "moe_router_bwd_fused", [_P, _L] + [_P] * 11
               + [_I] * 7 + [_P])


def launch(logits, gates, idx, stats, *, top_k: int, renormalize: bool):
    """One launch of the logits kernel into given outputs: CUDA logits
    (t, E), gates (t, k) in their type, idx (t, k) int32, stats (ceil(t /
    BLOCK_TOKENS), 2, E) float32, the last three contiguous. No checks:
    :func:`route_topk` makes them (a timing loop calls this directly)."""
    t, e = logits.shape
    fn = _library()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[logits.dtype], logits.data_ptr(), gates.data_ptr(),
             idx.data_ptr(), stats.data_ptr(), logits.stride(0), t, e, top_k,
             int(bool(renormalize)), stream)
    VARIANTS["logits"] += 1
    if err:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err} (logits {tuple(logits.shape)}, k {top_k})")


def route_topk(logits, *, top_k: int, renormalize: bool = True, mode=None):
    """logits: (t, E). Returns (gates (t, k), idx (t, k) int32, aux
    {"mean_prob", "frac_tokens"}); differentiable in the logits (module
    docstring)."""
    if logits.dim() != 2:
        raise ValueError(f"route_topk takes (tokens, experts) logits, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"route_topk takes float32 or bfloat16, got "
                        f"{logits.dtype}")
    t, e = logits.shape
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k {top_k} outside [1, {e}]")
    if t == 0:
        raise ValueError("route_topk needs at least one token")
    kt = kernel_mode(logits, mode)
    if kt is KernelType.CUDA:
        if e > MAX_EXPERTS:
            raise ValueError(f"moe_router kernel takes at most "
                             f"{MAX_EXPERTS} experts, got {e}")
        if logits.stride(1) != 1:
            raise ValueError("moe_router kernel needs unit-stride experts")
    if torch.is_grad_enabled() and logits.requires_grad:
        gates, idx, mean, frac = _RouteTopk.apply(logits, top_k,
                                                  bool(renormalize), kt)
    else:
        gates, idx, mean, frac = _topk_forward(logits, top_k, renormalize, kt)
    return gates, idx, {"mean_prob": mean, "frac_tokens": frac}


def _topk_fake(logits, top_k, renormalize, kt):
    t, e = logits.shape
    return (logits.new_empty((t, top_k)),
            logits.new_empty((t, top_k), dtype=torch.int32),
            logits.new_empty((e,), dtype=torch.float32),
            logits.new_empty((e,), dtype=torch.float32))


@seam(_NAME, lambda logits, top_k, *_: work.route_topk(
    *logits.shape, top_k, itemsize=logits.element_size()), _topk_fake)
def _topk_forward(logits, top_k, renormalize, kt):
    """(gates, idx, mean_prob, frac_tokens) of :func:`route_topk`."""
    if kt is KernelType.TORCH:
        gates, idx, _, aux = route_ref(logits, top_k=top_k,
                                       renormalize=renormalize)
        return gates, idx, aux["mean_prob"], aux["frac_tokens"]
    t, e = logits.shape
    dev = logits.device
    gates = torch.empty((t, top_k), dtype=logits.dtype, device=dev)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    stats = torch.empty((-(-t // BLOCK_TOKENS), 2, e), dtype=torch.float32,
                        device=dev)
    launch(logits, gates, idx, stats, top_k=top_k, renormalize=renormalize)
    sums = stats.sum(0)
    return gates, idx, sums[0] / t, sums[1] / (t * top_k)


class _RouteTopk(torch.autograd.Function):
    """:func:`route_topk` on given logits, then :func:`logits_bwd`."""

    @staticmethod
    def forward(ctx, logits, top_k, renormalize, kt):
        with torch.no_grad():
            gates, idx, mean, frac = _topk_forward(logits, top_k,
                                                   renormalize, kt)
        ctx.mark_non_differentiable(idx, frac)
        ctx.save_for_backward(logits, idx, gates)
        ctx.opts = (renormalize, kt)
        return gates, idx, mean, frac

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dgates, _didx, dmean, _dfrac):
        logits, idx, gates = ctx.saved_tensors
        renormalize, kt = ctx.opts
        dl = logits_bwd(logits.float(), idx, gates, dgates, dmean,
                        renormalize=renormalize, mode=kt)
        return dl.to(logits.dtype), None, None, None


def launch_bwd(logits, idx, gates, dgates, dmean, dl, *, renormalize: bool):
    """One launch of the backward kernel into ``dl`` (t, E) float32: CUDA
    logits (t, E) float32, idx (t, k) int32, gates and dgates (t, k)
    float32, dmean (E,) float32, all contiguous. No checks:
    :func:`logits_bwd` makes them (a timing loop calls this directly)."""
    t, e = logits.shape
    fn = _bwd_fn()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    count_launch(_BWD)
    err = fn(logits.data_ptr(), idx.data_ptr(), gates.data_ptr(),
             dgates.data_ptr(), dmean.data_ptr(), dl.data_ptr(), t, e,
             idx.shape[1], int(bool(renormalize)), stream)
    BWD_VARIANTS["logits"] += 1
    if err:
        raise RuntimeError(f"moe_router_bwd kernel launch failed: CUDA error "
                           f"{err} (logits {tuple(logits.shape)}, k "
                           f"{idx.shape[1]})")


@seam(_BWD, lambda logits, idx, *_, **__: work.route_topk_bwd(
    *logits.shape, idx.shape[1]),
    lambda logits, *_, **__: logits.new_empty(logits.shape,
                                              dtype=torch.float32))
def logits_bwd(logits, idx, gates, dgates, dmean, *, renormalize=True,
               mode=None):
    """dl (t, E) float32, the gradient of the router's float32 logits
    (t, E) from the gates' gradient ``dgates`` (t, k) and ``mean_prob``'s
    ``dmean`` (E,), given the chosen ids ``idx`` and the ``gates`` of the
    forward. The kernel ``csrc/moe_router_bwd.cu`` for CUDA tensors,
    ``ref.route_tokens_bwd_ref`` for CPU tensors or ``mode="torch"``."""
    t, e = logits.shape
    if logits.dtype != torch.float32:
        raise TypeError(f"logits_bwd takes float32 logits, got "
                        f"{logits.dtype}")
    if idx.dim() != 2 or idx.shape[0] != t or gates.shape != idx.shape \
            or dgates.shape != idx.shape:
        raise ValueError(f"idx {tuple(idx.shape)}, gates "
                         f"{tuple(gates.shape)} and dgates must be (t, k) "
                         f"for logits {tuple(logits.shape)}")
    if dmean.shape != (e,):
        raise ValueError(f"dmean {tuple(dmean.shape)} is not ({e},)")
    if kernel_mode(logits, mode) is KernelType.TORCH:
        return route_tokens_bwd_ref(logits, idx, gates, dgates, dmean,
                                    renormalize=renormalize)
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_router_bwd kernel takes at most {MAX_EXPERTS} "
                         f"experts, got {e}")
    f32 = (lambda x: x.to(torch.float32).contiguous())
    dl = torch.empty((t, e), dtype=torch.float32, device=logits.device)
    launch_bwd(logits.contiguous(), idx.to(torch.int32).contiguous(),
               f32(gates), f32(dgates), f32(dmean), dl,
               renormalize=renormalize)
    return dl


def plan(x, w, *, top_k: int, group_size: int):
    """The form :func:`route_tokens` launches the fused kernel in, for
    tokens x (t, d) and router weight w (d, E): a dict with ``variant``
    "fused", ``form`` "tile" (t > 32: clusters of 2 CTAs, each tile of 64
    tokens, each CTA half of d) or "split" (t <= 32, the decode: one
    tile of 64 tokens, d split over a cluster of 2 to 16 CTAs, one per
    64 values of d), ``block_tokens``, ``cluster`` (CTAs a cluster) and
    ``clusters``. A pure function of types and shapes; raises for what
    the kernel does not take (E > 64 or not a multiple of 4, d not a
    multiple of 8, w not float32, x neither float32 nor bfloat16)."""
    _check(x, w, top_k, group_size)
    t, d = x.shape
    e = w.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"moe_router_hopper kernel takes float32 or bfloat16 "
                        f"x, got {x.dtype}")
    if e > MAX_EXPERTS or e % 4:
        raise ValueError(f"moe_router_hopper kernel takes a multiple of 4 "
                         f"experts up to {MAX_EXPERTS}, got {e}")
    if d % 8:
        raise ValueError(f"moe_router_hopper kernel takes d a multiple of 8, "
                         f"got {d}")
    if t <= SPLIT_TOKENS:
        chunks = -(-d // _CHUNK)
        cluster = 2                 # at most 32 of the tile's 64 rows a CTA
        while cluster < 16 and 2 * cluster <= chunks:
            cluster *= 2
        return {"variant": "fused", "form": "split", "block_tokens": 64,
                "cluster": cluster, "clusters": 1}
    return {"variant": "fused", "form": "tile", "block_tokens": 64,
            "cluster": 2, "clusters": -(-t // 64)}


def _check(x, w, top_k, group_size):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"route_tokens takes x (tokens, d) and w (d, "
                         f"experts), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.dtype != torch.float32:
        raise TypeError(f"route_tokens takes a float32 router weight, got "
                        f"{w.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"route_tokens takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    t, e = x.shape[0], w.shape[1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k {top_k} outside [1, {e}]")
    if t == 0:
        raise ValueError("route_tokens needs at least one token")
    if group_size < 1:
        raise ValueError(f"group_size {group_size} < 1")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


# (device, stream) -> the fused kernel's scratch: per-block tails and
# statistics, grown as needed, and its tickets (zeroed once, then kept by
# the kernel). A launch uses its stream's scratch, so stream order keeps
# two launches on it apart and launches on other streams never touch it.
_SCRATCH: dict = {}


def _scratch(device, stream, blocks):
    key = (device, stream.cuda_stream)
    sc = _SCRATCH.get(key)
    if sc is not None and sc["blocks"] >= blocks:
        return sc
    if torch.cuda.is_current_stream_capturing():
        # memory made now would belong to the graph, zeroed only when it
        # replays: the stream's scratch must exist before the capture
        raise RuntimeError("route_tokens: run it once, at this size, on the "
                           "capturing stream before capturing a CUDA graph")
    if sc is None:
        sc = _SCRATCH[key] = {
            "tickets": torch.zeros(3, dtype=torch.int32, device=device)}
    if sc.get("blocks", 0) < blocks:
        sc["tails"] = torch.zeros((blocks, 64), dtype=torch.int64,
                                  device=device)
        sc["stats"] = torch.empty((blocks, 2, 64), dtype=torch.float32,
                                  device=device)
        sc["blocks"] = blocks
    return sc


def launch_fused(x, w, gates, idx, pos, aux, *, top_k: int,
                 renormalize: bool, group_size: int, form=None, logits=None):
    """One launch of the fused kernel into given outputs: CUDA x (t, d)
    with unit stride along d and 16-byte aligned rows, w (d, E) float32
    contiguous, gates (t, k) float32, idx and pos (t, k) int32, aux (2, E)
    float32, and ``logits`` (t, E) float32 or None (not written), all
    contiguous. ``form`` is a :func:`plan` dict (default: the plan for
    these tensors). No checks beyond the plan's: the op makes them (a
    timing loop calls this directly)."""
    if form is None:
        form = plan(x, w, top_k=top_k, group_size=group_size)
    t, d = x.shape
    e = w.shape[1]
    bt, cl = form["block_tokens"], form["cluster"]
    stream = torch.cuda.current_stream(x.device)
    sc = _scratch(x.device, stream, -(-t // bt) * cl)
    fn = _fused_fn()
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), x.stride(0), w.data_ptr(),
             t, d, e, top_k, int(bool(renormalize)), group_size, bt, cl,
             gates.data_ptr(), idx.data_ptr(), pos.data_ptr(), aux.data_ptr(),
             None if logits is None else logits.data_ptr(),
             sc["tails"].data_ptr(), sc["stats"].data_ptr(),
             sc["tickets"].data_ptr(), stream.cuda_stream)
    VARIANTS["fused"] += 1
    FORMS[form["form"]] += 1
    if err:
        raise RuntimeError(f"moe_router_hopper kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x.shape)} {x.dtype}, E "
                           f"{e}, k {top_k}, form {form})")


def route_tokens(x, w, *, top_k: int, renormalize: bool = True,
                 group_size: int, mode=None):
    """x (t, d) float32 or bfloat16, w (d, E) float32. Returns (gates (t,
    k) float32, idx (t, k) int32, pos (t, k) int32, aux {"mean_prob",
    "frac_tokens"} (E,) float32), as :func:`ref.route_tokens_ref`: pos is
    each choice's count of earlier choices of its expert in its group of
    ``group_size`` tokens, and the statistics run over all t rows.
    Differentiable in x and w (module docstring)."""
    _check(x, w, top_k, group_size)
    kt = kernel_mode(x, mode)
    form = None
    if kt is KernelType.CUDA:
        form = plan(x, w, top_k=top_k, group_size=group_size)
    opts = (top_k, bool(renormalize), group_size, kt, form)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        gates, idx, pos, mean, frac = _RouteTokens.apply(x, w, opts)
    else:
        gates, idx, pos, mean, frac, _ = _tokens_forward(x, w, opts, False)
    return gates, idx, pos, {"mean_prob": mean, "frac_tokens": frac}


def _tokens_work(x, w, opts, want_logits):
    return work.moe_router(*x.shape, w.shape[1], opts[0],
                           x_itemsize=x.element_size(), logits=want_logits)


def _tokens_fake(x, w, opts, want_logits):
    t, e, k = x.shape[0], w.shape[1], opts[0]
    f32 = lambda *shape: x.new_empty(shape, dtype=torch.float32)  # noqa
    i32 = lambda *shape: x.new_empty(shape, dtype=torch.int32)  # noqa
    return (f32(t, k), i32(t, k), i32(t, k), f32(e), f32(e),
            f32(t, e) if want_logits else None)


@seam(_NAME, _tokens_work, _tokens_fake)
def _tokens_forward(x, w, opts, want_logits):
    """(gates, idx, pos, mean_prob, frac_tokens, logits or None) of
    :func:`route_tokens`; the kernel's float32 logits when
    ``want_logits`` (the plain version's backward takes its own)."""
    top_k, renormalize, group_size, kt, form = opts
    if kt is KernelType.TORCH:
        gates, idx, pos, aux = route_tokens_ref(
            x, w, top_k=top_k, renormalize=renormalize,
            group_size=group_size)
        return gates, idx, pos, aux["mean_prob"], aux["frac_tokens"], None
    if x.stride(1) != 1 or (x.stride(0) * x.element_size()) % 16 \
            or x.data_ptr() % 16:
        raise ValueError("moe_router_hopper kernel takes x with unit "
                         "stride along d and 16-byte aligned rows")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("moe_router_hopper kernel takes a contiguous, "
                         "16-byte aligned w")
    t, e = x.shape[0], w.shape[1]
    dev = x.device
    gates = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    pos = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    aux = torch.empty((2, e), dtype=torch.float32, device=dev)
    logits = (torch.empty((t, e), dtype=torch.float32, device=dev)
              if want_logits else None)
    launch_fused(x, w, gates, idx, pos, aux, top_k=top_k,
                 renormalize=renormalize, group_size=group_size, form=form,
                 logits=logits)
    return gates, idx, pos, aux[0], aux[1], logits


class _RouteTokens(torch.autograd.Function):
    """The fused routing with its logits, then :func:`tokens_bwd`."""

    @staticmethod
    def forward(ctx, x, w, opts):
        with torch.no_grad():
            gates, idx, pos, mean, frac, logits = _tokens_forward(x, w, opts,
                                                                  True)
        ctx.mark_non_differentiable(idx, pos, frac)
        ctx.save_for_backward(x, w, logits, idx, gates)
        ctx.opts = opts
        return gates, idx, pos, mean, frac

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dgates, _didx, _dpos, dmean, _dfrac):
        x, w, logits, idx, gates = ctx.saved_tensors
        _, renormalize, _, kt, _ = ctx.opts
        dx, dw = tokens_bwd(x, w, logits, idx, gates, dgates, dmean,
                            renormalize=renormalize,
                            need=tuple(ctx.needs_input_grad[:2]), mode=kt)
        return dx, dw, None


def plan_bwd(x, w, *, top_k: int):
    """The variant :func:`tokens_bwd` runs for tokens x (t, d) and router
    weight w (d, E), a pure function of types and shapes: a dict with
    ``variant`` "fused" (bfloat16 x, E a multiple of 4 up to 64, d a
    multiple of 8: ``csrc/moe_router_bwd_hopper.cu``, a grid of
    ``slices`` of SLICE_D values of d by ``ranges`` ranges of
    ``stages_per_range`` stages of 64 tokens, about one CTA an SM) or
    "logits" (``csrc/moe_router_bwd.cu``'s dl and two float32
    ``torch.matmul`` products; ``reason`` says why: float32 x, whose
    products the fused kernel does not take yet, ROADMAP.md section 2).
    Raises for what neither takes (E > 64, the types route_tokens
    refuses)."""
    _check(x, w, top_k, 1)
    t, d = x.shape
    e = w.shape[1]
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_router_bwd kernels take at most {MAX_EXPERTS} "
                         f"experts, got {e}")
    if x.dtype != torch.bfloat16:
        return {"variant": "logits", "reason": f"{x.dtype} x: the fused "
                "kernel takes bfloat16 x (ROADMAP.md section 2)"}
    if e % 4:
        return {"variant": "logits", "reason": f"E {e} not a multiple of 4"}
    if d % 8:
        return {"variant": "logits", "reason": f"d {d} not a multiple of 8"}
    slices = -(-d // SLICE_D)
    stages = -(-t // _BWD_STAGE)
    per = -(-stages // max(1, min(stages, _SMS // slices)))
    return {"variant": "fused", "slices": slices, "ranges": -(-stages // per),
            "stages_per_range": per}


# (device, stream) -> the fused backward's scratch, each grown as needed:
# the partial dw of each (range, slice), dl's three bf16 pieces (64 a row),
# and its grid barrier's count and generation (zeroed when made; the kernel
# leaves the count at 0).
_BWD_SCRATCH: dict = {}


def _bwd_scratch(device, stream, ranges, slices, rows):
    key = (device, stream.cuda_stream)
    sc = _BWD_SCRATCH.setdefault(key, {})
    sizes = {"part": ranges * slices * SLICE_D * MAX_EXPERTS,
             "dlp": 3 * rows * MAX_EXPERTS, "counters": 2}
    short = [n for n, size in sizes.items()
             if n not in sc or sc[n].numel() < size]
    if not short:
        return sc
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("route_tokens' backward: run it once, at this "
                           "size, on the capturing stream before capturing "
                           "a CUDA graph")
    make = {"part": lambda n: torch.empty(n, dtype=torch.float32,
                                          device=device),
            "dlp": lambda n: torch.empty(n, dtype=torch.bfloat16,
                                         device=device),
            "counters": lambda n: torch.zeros(n, dtype=torch.int32,
                                              device=device)}
    for name in short:
        sc[name] = make[name](sizes[name])
    return sc


def launch_bwd_fused(x, w, logits, idx, gates, dgates, dmean, dx, dw, *,
                     renormalize: bool, form=None):
    """One launch of the fused backward into ``dx`` (t, d) in x's type and
    ``dw`` (d, E) float32 (either None: not computed): CUDA x (t, d)
    bfloat16 with unit stride along d and 16-byte aligned rows, w (d, E)
    and the forward's logits (t, E) float32, idx (t, k) int32, gates and
    dgates (t, k) and dmean (E,) float32, all contiguous but x. ``form``
    is a :func:`plan_bwd` dict (default: the plan for these tensors). No
    checks: :func:`tokens_bwd` makes them (a timing loop calls this
    directly)."""
    if form is None:
        form = plan_bwd(x, w, top_k=idx.shape[1])
    t, d = x.shape
    e = w.shape[1]
    stream = torch.cuda.current_stream(x.device)
    sc = _bwd_scratch(x.device, stream, form["ranges"], form["slices"],
                      -(-t // _BWD_STAGE) * _BWD_STAGE)
    fn = _bwd_fused_fn()
    count_launch(_BWD)
    err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), logits.data_ptr(),
             idx.data_ptr(), gates.data_ptr(), dgates.data_ptr(),
             dmean.data_ptr(), None if dx is None else dx.data_ptr(),
             None if dw is None else dw.data_ptr(), sc["part"].data_ptr(),
             sc["dlp"].data_ptr(), sc["counters"].data_ptr(), t, d, e,
             idx.shape[1],
             int(bool(renormalize)), form["ranges"],
             form["stages_per_range"], stream.cuda_stream)
    BWD_VARIANTS["fused"] += 1
    if err:
        raise RuntimeError(f"moe_router_bwd_hopper kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x.shape)} {x.dtype}, E "
                           f"{e}, k {idx.shape[1]}, form {form})")


def _tokens_bwd_fake(x, w, logits, idx, gates, dgates, dmean, *,
                    need=(True, True), **_):
    return (x.new_empty(x.shape) if need[0] else None,
            w.new_empty(w.shape, dtype=torch.float32) if need[1] else None)


@seam(_BWD, lambda x, w, logits, idx, *_, **__: work.moe_router_bwd(
    *x.shape, w.shape[1], idx.shape[1], x_itemsize=x.element_size()),
    _tokens_bwd_fake)
def tokens_bwd(x, w, logits, idx, gates, dgates, dmean, *,
               renormalize=True, need=(True, True), mode=None):
    """(dx in x's type, dw float32): the gradient of :func:`route_tokens`'
    x and w, given the forward's float32 ``logits`` (t, E) (None: the
    plain version computes them), ids and gates, and the cotangents
    ``dgates`` (t, k) and ``dmean`` (E,); an output ``need`` leaves out
    is None. For CUDA tensors the variant :func:`plan_bwd` picks, which
    launches its kernel or raises; ``ref.route_tokens_full_bwd_ref`` for
    CPU tensors or ``mode="torch"``."""
    need_dx, need_dw = need
    if kernel_mode(x, mode) is KernelType.TORCH:
        _, dx, dw = route_tokens_full_bwd_ref(x, w, logits, idx, gates,
                                              dgates, dmean,
                                              renormalize=renormalize)
        return dx if need_dx else None, dw if need_dw else None
    if not (need_dx or need_dw):
        return None, None
    t, d = x.shape
    e = w.shape[1]
    form = plan_bwd(x, w, top_k=idx.shape[1])
    if form["variant"] == "logits":
        dl = logits_bwd(logits, idx, gates, dgates, dmean,
                        renormalize=renormalize)
        return ((dl @ w.T).to(x.dtype) if need_dx else None,
                x.float().T @ dl if need_dw else None)
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError("moe_router_bwd_hopper kernel takes x with unit "
                         "stride along d and 16-byte aligned rows")
    if logits is None or logits.shape != (t, e) \
            or logits.dtype != torch.float32:
        raise ValueError(f"moe_router_bwd_hopper kernel takes the forward's "
                         f"({t}, {e}) float32 logits")
    f32 = (lambda a: a.to(torch.float32).contiguous())
    w, logits = w.contiguous(), logits.contiguous()
    if w.data_ptr() % 16 or logits.data_ptr() % 16:
        raise ValueError("moe_router_bwd_hopper kernel takes 16-byte aligned "
                         "w and logits")
    dev = x.device
    dx = torch.empty((t, d), dtype=x.dtype, device=dev) if need_dx else None
    dw = torch.empty((d, e), dtype=torch.float32, device=dev) \
        if need_dw else None
    launch_bwd_fused(x, w, logits, idx.to(torch.int32).contiguous(),
                     f32(gates), f32(dgates), f32(dmean), dx, dw,
                     renormalize=renormalize, form=form)
    return dx, dw

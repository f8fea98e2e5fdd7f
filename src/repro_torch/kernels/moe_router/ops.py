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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode, refuse_grad
from repro_torch.kernels.moe_router.ref import route_ref, route_tokens_ref

__all__ = ["BLOCK_TOKENS", "FORMS", "KERNELS", "MAX_EXPERTS", "VARIANTS",
           "launch", "launch_fused", "plan", "reset_variants",
           "route_tokens", "route_topk"]

_NAME = "moe_router"
_FUSED = "moe_router_hopper"
KERNELS = (_NAME,)
MAX_EXPERTS = 64
BLOCK_TOKENS = 16          # token rows per block of the kernel (stats row)
SPLIT_TOKENS = 32          # the fused op's split form: at most this many
_CHUNK = 64                # values of d a stage of the fused kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# variant -> launches that ran it since the last reset_variants()
VARIANTS = {"fused": 0, "logits": 0}
# the fused kernel's form (plan's "form") -> launches since the last reset
FORMS = {"tile": 0, "split": 0}


def reset_variants() -> None:
    """Set every variant's and every form's count to 0."""
    for counts in (VARIANTS, FORMS):
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
               + [_P] * 8)


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
    {"mean_prob", "frac_tokens"})."""
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
    if kernel_mode(logits, mode) is KernelType.TORCH:
        gates, idx, _, aux = route_ref(logits, top_k=top_k,
                                       renormalize=renormalize)
        return gates, idx, aux
    refuse_grad("moe_router route_topk", logits)
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_router kernel takes at most {MAX_EXPERTS} "
                         f"experts, got {e}")
    if logits.stride(1) != 1:
        raise ValueError("moe_router kernel needs unit-stride experts")
    dev = logits.device
    gates = torch.empty((t, top_k), dtype=logits.dtype, device=dev)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    stats = torch.empty((-(-t // BLOCK_TOKENS), 2, e), dtype=torch.float32,
                        device=dev)
    launch(logits, gates, idx, stats, top_k=top_k, renormalize=renormalize)
    sums = stats.sum(0)
    aux = {"mean_prob": sums[0] / t, "frac_tokens": sums[1] / (t * top_k)}
    return gates, idx, aux


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
                 renormalize: bool, group_size: int, form=None):
    """One launch of the fused kernel into given outputs: CUDA x (t, d)
    with unit stride along d and 16-byte aligned rows, w (d, E) float32
    contiguous, gates (t, k) float32, idx and pos (t, k) int32, aux (2, E)
    float32, all contiguous. ``form`` is a :func:`plan` dict (default:
    the plan for these tensors). No checks beyond the plan's: the op
    makes them (a timing loop calls this directly)."""
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
    ``group_size`` tokens, and the statistics run over all t rows."""
    _check(x, w, top_k, group_size)
    if kernel_mode(x, mode) is KernelType.TORCH:
        return route_tokens_ref(x, w, top_k=top_k, renormalize=renormalize,
                                group_size=group_size)
    refuse_grad("moe_router route_tokens", x, w)
    form = plan(x, w, top_k=top_k, group_size=group_size)
    if x.stride(1) != 1 or (x.stride(0) * x.element_size()) % 16 \
            or x.data_ptr() % 16:
        raise ValueError("moe_router_hopper kernel takes x with unit stride "
                         "along d and 16-byte aligned rows")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError("moe_router_hopper kernel takes a contiguous, "
                         "16-byte aligned w")
    t, e = x.shape[0], w.shape[1]
    dev = x.device
    gates = torch.empty((t, top_k), dtype=torch.float32, device=dev)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    pos = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    aux = torch.empty((2, e), dtype=torch.float32, device=dev)
    launch_fused(x, w, gates, idx, pos, aux, top_k=top_k,
                 renormalize=renormalize, group_size=group_size, form=form)
    return gates, idx, pos, {"mean_prob": aux[0], "frac_tokens": aux[1]}

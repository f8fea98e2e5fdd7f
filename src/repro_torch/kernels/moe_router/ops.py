"""Public MoE routing op: the CUDA router kernel or its plain version.

:func:`route_topk` takes router logits (t, E), float32 or bfloat16, with
E <= 64 for the kernel, and returns the top-k gates (in the logits'
type), the expert ids (int32) and the load statistics ``mean_prob`` and
``frac_tokens``. Which implementation runs follows the tensor's device
(:func:`repro_torch.kernels.interface.kernel_mode`): the kernel
(``csrc/moe_router.cu``) for a CUDA tensor, the plain version (``ref.py``)
for a CPU tensor or an explicit ``mode="torch"``. The kernel writes
per-block partial statistics (blocks, 2, E), summed here as the
reference sums its blocks', with no float atomics. Each launch adds one
to ``LAUNCHES["moe_router"]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.interface import KernelType, count_launch, \
    kernel_mode
from repro_torch.kernels.moe_router.ref import route_ref

__all__ = ["BLOCK_TOKENS", "KERNELS", "MAX_EXPERTS", "launch", "route_topk"]

_NAME = "moe_router"
KERNELS = (_NAME,)
MAX_EXPERTS = 64
BLOCK_TOKENS = 16          # token rows per block of the kernel (stats row)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    fn = load(_NAME).moe_router
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int64] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch(logits, gates, idx, stats, *, top_k: int, renormalize: bool):
    """One launch of the kernel into given outputs: CUDA logits (t, E),
    gates (t, k) in their type, idx (t, k) int32, stats (ceil(t /
    BLOCK_TOKENS), 2, E) float32, the last three contiguous. No checks:
    :func:`route_topk` makes them (a timing loop calls this directly)."""
    t, e = logits.shape
    fn = _library()
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    count_launch(_NAME)
    err = fn(_DTYPE_CODES[logits.dtype], logits.data_ptr(), gates.data_ptr(),
             idx.data_ptr(), stats.data_ptr(), logits.stride(0), t, e, top_k,
             int(bool(renormalize)), stream)
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

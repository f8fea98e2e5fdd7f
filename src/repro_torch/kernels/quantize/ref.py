"""Plain PyTorch version of the stochastic int8 quantize kernel.

Semantics are the reference's (``repro/kernels/quantize/ref.py``), for a
batch of senders, one row each, of ONE leaf of ``p`` values, over the
leaf's 128-value rows (the last one zero-padded):

    scale = max(absmax * f32(1/127), 1e-12)        one f32 per row
    q     = clip(floor(v / scale + u), -127, 127)  u: the rounding noise
    dq    = q * scale

``floor(x + u)`` with u ~ U[0, 1) is unbiased stochastic rounding; u =
0.5 rounds to nearest. The noise is an input, so the CUDA kernel and
this version are bit-comparable: each operation is one rounding in this
order, as the kernel's ``__fdiv_rn`` / ``__fadd_rn`` / ``__fmul_rn``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segments import LANES

__all__ = ["INV127", "dequantize_int8_ref", "quantize_int8_ref", "to_rows"]

# the float32 the reference multiplies the row absmax by: f32(1/127)
INV127 = float.fromhex("0x1.020408p-7")


def to_rows(v):
    """(B, p) -> (B, rows, 128), zero-padded."""
    b, p = v.shape
    rows = -(-p // LANES)
    out = v.new_zeros((b, rows * LANES))
    out[:, :p] = v
    return out.view(b, rows, LANES)


def quantize_int8_ref(v, noise):
    """v, noise (B, p) -> (q (B, p) int8, scales (B, rows) f32, dq (B, p))."""
    p = v.shape[-1]
    v2, n2 = to_rows(v), to_rows(noise)
    absmax = v2.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax * INV127, 1e-12)
    q = torch.clamp(torch.floor(v2 / scale + n2), -127.0, 127.0)
    dq = (q * scale).flatten(1)[:, :p]
    return q.to(torch.int8).flatten(1)[:, :p], scale.squeeze(-1), dq


def dequantize_int8_ref(q, scales):
    """q (B, p) int8, scales (B, rows) f32 -> (B, p) f32: ``q * scale``."""
    p = q.shape[-1]
    return (to_rows(q.to(torch.float32)) * scales[..., None]) \
        .flatten(1)[:, :p]

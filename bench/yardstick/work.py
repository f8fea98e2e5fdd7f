"""Each measured kernel family's work and its least time on one H100.

Frozen copy of ``src/repro_torch/roofline/kernels.py``'s ``Work``,
``prox_update``, ``compress`` (its ``"ef_topk"`` op), ``attention``,
``attention_bwd`` and ``live_pairs``: functions of shapes and types only, never of the variant
that runs, so a bound reads the same whatever implements the kernel.
Bytes count each input read once and each output written once; a
bound is the larger of bytes over the memory rate and operations over
their unit's peak (:mod:`bench.yardstick.peaks`).
"""
from __future__ import annotations

from dataclasses import dataclass

from bench.yardstick.peaks import HBM_BW, PEAK_FLOPS

# float32 operations a value of the error-feedback top-k select
EF_TOPK_OPS_PER_VALUE = 5


@dataclass(frozen=True)
class Work:
    """What a kernel call must do: ``bytes`` moved and ``flops`` run on
    the ``rate`` kind of unit."""
    bytes: float
    flops: float = 0.0
    rate: str = "f32"

    @property
    def bound_s(self) -> float:
        """The least seconds the card could take: the larger term."""
        return max(self.bytes / HBM_BW, self.flops / PEAK_FLOPS[self.rate])


def prox_update(rows: int, cols: int, *, itemsize: int,
                anchor_rows: int) -> Work:
    """The eq.-4 device step over (rows, cols) theta and grad, anchored to
    (anchor_rows, cols): theta and grad read and theta' written a row,
    the anchor read once a row of it; 7 float32 operations a value."""
    return Work((3 * rows + anchor_rows) * cols * itemsize, 7 * rows * cols)


def ef_topk(senders: int, cols: int, values: int, leaves: int) -> Work:
    """The error-feedback top-k select over ``senders`` rows of ``cols``
    columns holding ``values`` values in ``leaves`` leaves: delta, ef,
    the message, the new residual and the ranks, and a threshold a
    (sender, leaf)."""
    moved = senders * cols * 4 * 5 + senders * leaves * 4
    return Work(moved, senders * values * EF_TOPK_OPS_PER_VALUE)


def live_pairs(sq: int, skv: int, *, causal: bool = True,
               q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through, a (batch, head): key
    j < skv, and causal j <= q_offset + i."""
    total = 0
    for i in range(sq):
        hi = min(skv - 1, q_offset + i) if causal else skv - 1
        total += max(0, hi + 1)
    return total


def _rate(*itemsizes) -> str:
    """Tensor cores for 2-byte operands, CUDA cores for float32."""
    return "bf16" if all(s == 2 for s in itemsizes) else "f32"


def attention(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
              causal: bool, q_itemsize: int, kv_itemsize: int,
              lse: bool = False) -> Work:
    """Attention's forward from q_offset 0, no window: q read and out
    written, k and v read up to the last position a query sees (and the
    float32 log-sum-exp written when a gradient asks for it); 4 FLOPs a
    live (query, key) pair and dim."""
    kv_rows = min(skv, sq) if causal else skv
    moved = 2 * b * sq * hq * d * q_itemsize \
        + 2 * b * kv_rows * hkv * d * kv_itemsize \
        + (b * hq * sq * 4 if lse else 0)
    flops = 4 * b * hq * d * live_pairs(sq, skv, causal=causal)
    return Work(moved, flops, _rate(q_itemsize, kv_itemsize))


def attention_bwd(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
                  causal: bool, q_itemsize: int, kv_itemsize: int) -> Work:
    """Attention's backward: q, out, dout read and dq written, k and v
    read and dk, dv written, the float32 log-sum-exp read; 2.5x the
    forward's FLOPs."""
    moved = 4 * b * sq * hq * d * q_itemsize \
        + 4 * b * skv * hkv * d * kv_itemsize + b * hq * sq * 4
    flops = 2.5 * 4 * b * hq * d * live_pairs(sq, skv, causal=causal)
    return Work(moved, flops, _rate(q_itemsize, kv_itemsize))

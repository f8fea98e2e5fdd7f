"""Each kernel family's work and its least time on one H100.

One function a kernel family, of shapes and types only -- never of the
variant that runs, so that a bound reads the same work whatever
implements the kernel. Each returns a :class:`Work`: the bytes the
function must move (each input read once, each output written once;
scratch a kernel keeps for itself, such as snapshots or per-block
partials, is not the function's), its useful floating-point operations
and the rate they run at, and its exponentials. Its bound is the larger
of the bytes over the card's memory rate and the operations over their
peak (:mod:`repro_torch.launch.mesh`).

The kernel seams (``repro_torch.kernels.*.ops``) record these under an
active :class:`repro_torch.roofline.op_analysis.OpCounter`, and
``chip_smoke.py`` prints each kernel's bound from them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.launch.mesh import (EXP_RATE, HBM_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32, PEAK_FLOPS_TF32)

__all__ = ["COMPRESS_OPS_PER_VALUE", "RATES", "RWKV_BWD_OPS_PER_ELEMENT",
           "RWKV_OPS_PER_ELEMENT", "Work", "attention", "attention_bwd",
           "compress", "live_pairs", "mamba_scan", "moe_router",
           "moe_router_bwd", "prox_update", "route_topk", "route_topk_bwd",
           "rwkv6_scan", "rwkv6_scan_bwd", "tier_update"]

# operations a second by the kind of unit that runs them
RATES = {"bf16": PEAK_FLOPS_BF16, "tf32": PEAK_FLOPS_TF32,
         "f32": PEAK_FLOPS_F32}
# float32 operations a value of each compress op (select, quantize, sign)
COMPRESS_OPS_PER_VALUE = {"ef_topk": 5, "ef_randk": 4, "ef_int8": 10,
                          "ef_sign": 5, "topk": 3, "randk": 3,
                          "quantize": 8, "sign": 3}
# the least operations per WKV state element and step: the bonus folds
# into one dot product a step, out_t = r_t.S + (sum_i r_i u_i k_i) v_t, so
# r.S is one FMA and S <- w*S + k v^T one multiply and one FMA
RWKV_OPS_PER_ELEMENT = 5
# ... of its backward: the state's recomputation (k v, one FMA: 3), the
# sums of dr, dk, dw and dv (an FMA each: 8) and dS's update (r dout: 3)
RWKV_BWD_OPS_PER_ELEMENT = 14


@dataclass(frozen=True)
class Work:
    """What a kernel call must do: ``bytes`` moved, ``flops`` run on the
    ``rate`` kind of unit (``RATES``) ``passes`` times (the fused router's
    float32 product runs as two TF32 products), ``exponentials`` on the
    special-function units."""
    bytes: float
    flops: float = 0.0
    rate: str = "f32"
    passes: int = 1
    exponentials: float = 0.0

    @property
    def bytes_s(self) -> float:
        """Seconds to move the bytes at the card's memory rate."""
        return self.bytes / HBM_BW

    @property
    def ops_s(self) -> float:
        """Seconds of its operations at their peak rates."""
        return self.passes * self.at(self.rate) \
            + self.exponentials / EXP_RATE

    def at(self, rate: str) -> float:
        """Seconds of one pass of its FLOPs on the ``rate`` units: a floor
        of the same work on other units (say, "f32": CUDA cores)."""
        return self.flops / RATES[rate]

    @property
    def bound_s(self) -> float:
        """The least seconds the card could take: the larger term."""
        return max(self.bytes_s, self.ops_s)

    @property
    def bound_ms(self) -> float:
        """:attr:`bound_s` in milliseconds."""
        return self.bound_s * 1e3

    @property
    def bound_by(self) -> str:
        """"bytes" or "operations": which term bounds it."""
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


def prox_update(rows: int, cols: int, *, itemsize: int, anchor_rows: int,
                momentum: bool = False, groups: int = 0) -> Work:
    """The eq.-4 device step over (rows, cols) theta and grad, anchored to
    (anchor_rows, cols): theta and grad read and theta' written a row, the
    anchor read once a row of it, a float32 momentum buffer read and
    written, ``groups`` per-config (alpha, lam) read; 7 float32
    operations a value (9 with momentum)."""
    moved = (3 * rows + anchor_rows) * cols * itemsize \
        + (2 * rows * cols * 4 if momentum else 0) + 2 * groups * 4
    return Work(moved, rows * cols * (9 if momentum else 7))


def tier_update(values: int, itemsize: int) -> Work:
    """PerMFL's team and server updates (eqs. 9 and 13) over a leaf of
    ``values`` values: w, x and theta read, w' and x' written, each once
    in the stored type; 8 float32 operations a value (5 scalings, 3
    adds)."""
    return Work(5 * values * itemsize, 8 * values)


def compress(op: str, senders: int, cols: int, values: int, leaves: int,
             wire_rows: int, noise_rows: int = None) -> Work:
    """A compress op (``COMPRESS_OPS_PER_VALUE``'s names) over ``senders``
    rows of ``cols`` columns holding ``values`` values in ``leaves``
    leaves of ``wire_rows`` 128-value rows: rows of ``cols`` columns,
    uniforms of ``values`` (``noise_rows`` rows of them for quantize),
    the per-leaf tables and per-row scales, each read or written once."""
    b, c, p, nseg = senders, cols, values, leaves
    noise = (b if noise_rows is None else noise_rows) * p * 4
    moved = {
        "ef_topk": b * c * 4 * 5 + b * nseg * 4,   # delta, ef, dq, ef', ranks
        "ef_randk": b * c * 4 * 5 + b * p * 4 + b * nseg * 4,   # + u
        "ef_int8": b * c * (4 * 4 + 1) + b * p * 4 + b * wire_rows * 4,
        "ef_sign": b * c * 4 * 4 + b * nseg * 4 + b * wire_rows * 16,
        "topk": b * c * 4 * 3 + b * nseg * 4,      # v, dq, ranks, thresh
        "randk": b * c * 4 * 3 + b * p * 4 + b * nseg * 4 + nseg * 4,
        "sign": b * c * 4 * 2 + b * nseg * 4 + b * wire_rows * 16,
        "quantize": b * c * (4 + 1 + 4) + noise + b * wire_rows * 4,
    }[op]
    return Work(moved, senders * values * COMPRESS_OPS_PER_VALUE[op])


def route_topk(t: int, e: int, k: int, *, itemsize: int = 4) -> Work:
    """Routing given logits (t, E): logits read; gates, ids and the two
    (E,) statistics written; softmax, k arg-max rounds and the statistics
    (5 + 2k float32 operations a logit)."""
    return Work(t * e * itemsize + 2 * t * k * 4 + 2 * e * 4,
                t * e * (5 + 2 * k))


def route_topk_bwd(t: int, e: int, k: int) -> Work:
    """The gradient of the logits from :func:`route_topk`'s: float32 logits,
    ids, gates and their cotangents, the mean_prob cotangent read; the
    float32 dl written."""
    return Work(2 * t * e * 4 + 3 * t * k * 4 + e * 4)


def moe_router(t: int, d: int, e: int, k: int, *, x_itemsize: int,
               logits: bool = False) -> Work:
    """The fused router (router product, softmax, top-k, capacity
    positions, statistics): x (t, d) and the float32 w (d, E) read, gates,
    ids and positions (t, k) and the two (E,) statistics written (and the
    float32 logits when a gradient asks for them); the float32 product
    2 t d E as two TF32 products on the tensor cores."""
    moved = t * d * x_itemsize + d * e * 4 + 3 * t * k * 4 + 2 * e * 4 \
        + (t * e * 4 if logits else 0)
    return Work(moved, 2 * t * d * e, "tf32", passes=2)


def moe_router_bwd(t: int, d: int, e: int, k: int, *,
                   x_itemsize: int = 2) -> Work:
    """The router's whole backward (dl, dx = dl w^T, dw = f32(x)^T dl): x
    read and dx written in x's type, the float32 logits read, w read and
    dw written, ids, gates and their cotangents read, the mean_prob
    cotangent read. bfloat16 x: six bf16 tensor-core products of 2 t d E
    (three a product, for float32's accuracy); float32 x: the two
    products in float32."""
    moved = 2 * t * d * x_itemsize + t * e * 4 + 2 * d * e * 4 \
        + 3 * t * k * 4 + e * 4
    if x_itemsize == 2:
        return Work(moved, 6 * 2 * t * d * e, "bf16")
    return Work(moved, 2 * 2 * t * d * e, "f32")


def live_pairs(sq: int, skv: int, *, causal: bool = True, window: int = 0,
               q_offset: int = None) -> int:
    """(query, key) pairs the attention mask lets through, a (batch,
    head): key j < skv, causal j <= q_offset + i, a window w > 0 also
    j > q_offset + i - w (``flash_attention.ref.live_pairs``, counted row
    by row without building the mask)."""
    if q_offset is None:
        q_offset = skv - sq
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv - 1, pos) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def _rate(*itemsizes) -> str:
    """Tensor cores for 2-byte operands, CUDA cores for float32."""
    return "bf16" if all(s == 2 for s in itemsizes) else "f32"


def attention(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
              causal: bool, window: int, q_offset: int, q_itemsize: int,
              kv_itemsize: int, lse: bool = False) -> Work:
    """Attention's forward: q read and out written, k and v read up to the
    last position a query sees (and the float32 log-sum-exp written when
    a gradient asks for it); 4 FLOPs a live (query, key) pair and dim."""
    kv_rows = min(skv, q_offset + sq) if causal else skv
    moved = 2 * b * sq * hq * d * q_itemsize \
        + 2 * b * kv_rows * hkv * d * kv_itemsize \
        + (b * hq * sq * 4 if lse else 0)
    flops = 4 * b * hq * d * live_pairs(sq, skv, causal=causal,
                                        window=window, q_offset=q_offset)
    return Work(moved, flops, _rate(q_itemsize, kv_itemsize))


def attention_bwd(b: int, sq: int, skv: int, hq: int, hkv: int, d: int, *,
                  causal: bool, window: int, q_offset: int, q_itemsize: int,
                  kv_itemsize: int) -> Work:
    """Attention's backward: q, out, dout read and dq written, k and v
    read and dk, dv written, the float32 log-sum-exp read; 2.5x the
    forward's FLOPs."""
    moved = 4 * b * sq * hq * d * q_itemsize \
        + 4 * b * skv * hkv * d * kv_itemsize + b * hq * sq * 4
    flops = 2.5 * 4 * b * hq * d * live_pairs(sq, skv, causal=causal,
                                              window=window,
                                              q_offset=q_offset)
    return Work(moved, flops, _rate(q_itemsize, kv_itemsize))


def rwkv6_scan(b: int, t: int, h: int, n: int, *, itemsize: int,
               state: bool, w_itemsize: int = 4) -> Work:
    """The WKV-6 scan: r, k, v read and out written in r's type, w read,
    u read, the state read (if given) and written once. Its operations
    (RWKV_OPS_PER_ELEMENT a state element and step) run on the tensor
    cores in a chunked form, so the bytes bound it; ``at("f32")`` is the
    step-by-step form's CUDA-core floor."""
    tokens = b * t * h * n
    moved = 4 * tokens * itemsize + tokens * w_itemsize + 4 * h * n \
        + (2 if state else 1) * b * h * n * n * 4
    return Work(moved, RWKV_OPS_PER_ELEMENT * b * t * h * n * n, "tf32")


def rwkv6_scan_bwd(b: int, t: int, h: int, n: int, *, itemsize: int,
                   state: bool, w_itemsize: int = 4) -> Work:
    """The WKV-6 backward: r, k, v, dout read and dr, dk, dv written in
    r's type, w read and dw written, u read and du written, the state (if
    given) and the final state's cotangent read, dstate0 written;
    RWKV_BWD_OPS_PER_ELEMENT operations a state element and step, on the
    tensor cores in the chunked form."""
    tokens = b * t * h * n
    moved = 7 * tokens * itemsize + 2 * tokens * w_itemsize + 2 * h * n * 4 \
        + (2 + bool(state)) * b * h * n * n * 4
    return Work(moved, RWKV_BWD_OPS_PER_ELEMENT * b * t * h * n * n, "tf32")


def mamba_scan(b: int, s: int, d_in: int, n: int, *, itemsize: int,
               backward: bool, state: bool, final: bool = False) -> Work:
    """Mamba's selective scan or its gradient: forward xc, dt, B, C, A,
    h0 read, y and the final state written; backward xc, dt, B, C, A, dy
    and the final state's cotangent read, dxc, ddt, dB, dC, dA, dh0
    written, and one float32 state (b, d_in, N) besides (its snapshots
    are the kernel's own). Its b s d_in N
    exponentials exp(dt A) run on the special-function units."""
    acts, bc = b * s * d_in * itemsize, b * s * n * itemsize
    states, a_bytes = b * d_in * n * 4, d_in * n * 4
    if backward:
        moved = 5 * acts + 4 * bc + 2 * a_bytes \
            + (1 + bool(state) + bool(final)) * states
    else:
        moved = 3 * acts + 2 * bc + a_bytes + (1 + bool(state)) * states
    return Work(moved, exponentials=b * s * d_in * n)

"""The DeepSeekMoE cell's yardsticks: the model's FLOPs a training pass,
and the work of the fused router's forward and backward.

:func:`moe_router` and :func:`moe_router_bwd` are frozen copies of
``src/repro_torch/roofline/kernels.py``'s (the forward with its float32
logits written, as under a gradient): functions of shapes and types
only, so a bound reads the same whatever implements the kernel. The
forward's float32 router product runs as two TF32 products on the
tensor cores: its FLOPs are counted twice at the TF32 peak.
"""
from __future__ import annotations

from bench.yardstick.work import Work, live_pairs


def moe_active_params(m: dict) -> int:
    """Parameters of products with weights that each token passes
    through: every layer's q, k, v and o; the dense lead's SwiGLU; each
    MoE layer's router, its shared experts' SwiGLU and its top-k routed
    experts' (the experts a token did not choose, the capacity's padding
    and the one-hot dispatch are not the model's); the output head (the
    embedding is a gather)."""
    d, hd = m["d_model"], m["head_dim"]
    hq, hkv = m["num_heads"], m["num_kv_heads"]
    mo = m["moe"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    lead = m["first_dense_layers"]
    moe = d * mo["num_experts"] \
        + 3 * d * mo["expert_d_ff"] * (mo["num_shared_experts"]
                                       + mo["top_k"])
    return m["num_layers"] * attn + lead * 3 * d * m["d_ff"] \
        + (m["num_layers"] - lead) * moe + d * m["vocab_size"]


def moe_pass_flops(m: dict, batch: int, seq_len: int) -> float:
    """One training pass (forward and backward) on batch x seq_len
    tokens: 6 N D for the active products with weights, and causal
    attention's QK^T and PV, forward and backward: 3 x 4 b hq hd FLOPs a
    live (query, key) pair, in every layer (``flops.lm_pass_flops``'
    count)."""
    attn = 12 * batch * m["num_heads"] * m["head_dim"] \
        * live_pairs(seq_len, seq_len, causal=True) * m["num_layers"]
    return 6.0 * moe_active_params(m) * batch * seq_len + attn


def moe_router(t: int, d: int, e: int, k: int, *, x_itemsize: int) -> Work:
    """The fused router (router product, softmax, top-k, capacity
    positions, statistics) under a gradient: x (t, d) and the float32 w
    (d, E) read; gates, ids and positions (t, k), the two (E,)
    statistics and the float32 logits (t, E) written; the float32
    product 2 t d E as two TF32 products."""
    moved = t * d * x_itemsize + d * e * 4 + 3 * t * k * 4 + 2 * e * 4 \
        + t * e * 4
    return Work(moved, 2 * (2 * t * d * e), "tf32")


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

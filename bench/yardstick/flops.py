"""The FLOPs each configuration's model needs, counted from its shapes.

A model FLOP utilization (``*_mfu``) is these FLOPs over the traced
window's time and the card's peak for the configuration's type. Counted
are the products a model needs (matrix and convolution products; 2
FLOPs a multiply-add), not what the program runs: no recomputation, no
elementwise work, no optimizer.
"""
from __future__ import annotations

from bench.yardstick.work import live_pairs


def cnn_forward_flops(cfg: dict) -> tuple:
    """(FLOPs of one sample's forward, FLOPs of its first convolution)
    for the paper CNN of ``cfg`` (``input_shape`` HWC, ``conv_channels``,
    ``hidden``, ``num_classes``): 3x3 SAME convolutions each followed by
    a 2x2 max-pool, then dense layers."""
    h, w, c = cfg["input_shape"]
    total, first = 0, None
    for cout in cfg["conv_channels"]:
        f = 2 * h * w * 9 * c * cout
        first = f if first is None else first
        total += f
        h, w, c = h // 2, w // 2, cout
    dims = [h * w * c] + list(cfg["hidden"]) + [cfg["num_classes"]]
    total += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return total, first


def permfl_round_flops(cfg: dict) -> float:
    """A PerMFL round of the paper CNN with its eval: K * L device steps
    of every device on its train samples (forward, the weights'
    gradients and every input gradient but the first convolution's),
    then the eval's forwards (PM, TM and GM accuracy on the validation
    samples, the train loss on the train samples)."""
    fwd, first = cnn_forward_flops(cfg["model"])
    fed = cfg["federation"]
    devices = fed["m_teams"] * fed["n_devices"]
    train, val = fed["train_per_device"], fed["val_per_device"]
    algo = cfg["algorithm"]
    steps = algo["k_team"] * algo["l_local"]
    return (steps * devices * train * (3 * fwd - first)
            + devices * (3 * val + train) * fwd)


def lm_matmul_params(cfg: dict) -> int:
    """Parameters of a dense decoder that enter matrix products: every
    layer's q, k, v, o and SwiGLU weights and the output head (the
    embedding is a gather)."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    mlp = 3 * d * cfg["d_ff"]
    return cfg["num_layers"] * (attn + mlp) + d * cfg["vocab_size"]


def lm_pass_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """One training pass (forward and backward) of a dense decoder on
    batch x seq_len tokens: 6 N D for the products with weights, and
    causal attention's QK^T and PV, forward and backward: 3 x 4 b hq
    hd FLOPs a live (query, key) pair, in every layer."""
    tokens = batch * seq_len
    attn = 12 * batch * cfg["num_heads"] * cfg["head_dim"] \
        * live_pairs(seq_len, seq_len, causal=True) * cfg["num_layers"]
    return 6.0 * lm_matmul_params(cfg) * tokens + attn

"""The paper's own learning models: MCLR, 2-layer CNN, 2-hidden-layer DNN.

MCLR (multinomial logistic regression with l2) is the strongly-convex
model of Theorem 1; the CNN and DNN cover Theorem 2's smooth non-convex
setting. Leaf names, shapes and layouts are those of the JAX package:
NHWC activations, HWIO convolution weights, the 3x3 SAME convolution as
im2col + matmul.

Every function is batched over a leading device axis D: parameter leaves
are (D, ...) and inputs (D, B, ...), and each device's model sees only
its own rows. So one forward and one ``torch.autograd.grad`` of the SUM
of the per-device losses gives every device its own gradient at once --
what the reference gets from ``jax.vmap(jax.vmap(jax.grad(loss)))``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import PaperModelConfig
from repro_torch.flat import tree_leaves

__all__ = ["accuracy", "apply", "init_params", "loss_fn"]


def init_params(cfg: PaperModelConfig, generator: torch.Generator = None,
                dtype=torch.float32) -> dict:
    """One (unstacked) model on the CPU, drawn from ``generator``: He
    normal weights, zero biases (MCLR is all zeros)."""
    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator)
                * math.sqrt(2.0 / fan_in)).to(dtype)

    if cfg.kind == "mclr":
        d = math.prod(cfg.input_shape)
        return {"w": torch.zeros((d, cfg.num_classes), dtype=dtype),
                "b": torch.zeros((cfg.num_classes,), dtype=dtype)}
    if cfg.kind == "dnn":
        dims = [math.prod(cfg.input_shape)] + list(cfg.hidden) \
            + [cfg.num_classes]
        return {f"layer{i}": {
            "w": normal((dims[i], dims[i + 1]), dims[i]),
            "b": torch.zeros((dims[i + 1],), dtype=dtype)}
            for i in range(len(dims) - 1)}
    if cfg.kind == "cnn":
        h, w, c_in = cfg.input_shape
        chans = [c_in] + list(cfg.conv_channels)
        p = {}
        for i in range(len(chans) - 1):
            p[f"conv{i}"] = {
                "w": normal((3, 3, chans[i], chans[i + 1]), 9 * chans[i]),
                "b": torch.zeros((chans[i + 1],), dtype=dtype)}
        # two 2x2 maxpools -> spatial /4
        dims = [(h // 4) * (w // 4) * chans[-1]] + list(cfg.hidden) \
            + [cfg.num_classes]
        for i in range(len(dims) - 1):
            p[f"dense{i}"] = {
                "w": normal((dims[i], dims[i + 1]), dims[i]),
                "b": torch.zeros((dims[i + 1],), dtype=dtype)}
        return p
    raise ValueError(cfg.kind)


def _dense(h, layer):
    """(D, B, din) @ (D, din, dout) + (D, dout)."""
    return torch.matmul(h, layer["w"]) + layer["b"][:, None, :]


def _maxpool2(x):
    """VALID 2x2 max-pool, stride 2, on (N, H, W, C). Ties split the
    gradient evenly (JAX routes it to one element); in these models every
    window follows a ReLU, and tied windows are in practice windows of
    zeros, whose gradient the ReLU zeroes in both frameworks."""
    n, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def apply(params, cfg: PaperModelConfig, x):
    """params: leaves (D, ...); x: (D, B, *input_shape) -> logits
    (D, B, num_classes)."""
    d, b = x.shape[:2]
    if cfg.kind == "mclr":
        return _dense(x.reshape(d, b, -1), params)
    if cfg.kind == "dnn":
        h = x.reshape(d, b, -1)
        n = len(params)
        for i in range(n):
            h = _dense(h, params[f"layer{i}"])
            if i < n - 1:
                h = torch.relu(h)
        return h
    if cfg.kind == "cnn":
        h = x.reshape((d * b,) + tuple(x.shape[2:]))      # (D*B, H, W, C)
        i = 0
        while f"conv{i}" in params:
            w = params[f"conv{i}"]["w"]                   # (D, 3, 3, cin, cout)
            cin, cout = w.shape[-2:]
            hh, ww = h.shape[1], h.shape[2]
            hp = F.pad(h, (0, 0, 1, 1, 1, 1))
            # im2col, (dy, dx) major and channel minor, as the reference
            patches = torch.cat([hp[:, dy:dy + hh, dx:dx + ww, :]
                                 for dy in range(3) for dx in range(3)],
                                dim=-1)
            h = torch.matmul(patches.reshape(d, b * hh * ww, 9 * cin),
                             w.reshape(d, 9 * cin, cout))
            h = torch.relu(h + params[f"conv{i}"]["b"][:, None, :])
            h = _maxpool2(h.reshape(d * b, hh, ww, cout))
            i += 1
        h = h.reshape(d, b, -1)
        j = 0
        while f"dense{j}" in params:
            h = _dense(h, params[f"dense{j}"])
            if f"dense{j + 1}" in params:
                h = torch.relu(h)
            j += 1
        return h
    raise ValueError(cfg.kind)


def loss_fn(params, cfg: PaperModelConfig, batch):
    """Per-device mean cross-entropy (+ 0.5 * l2 * ||params||^2 for the
    strongly-convex MCLR), shape (D,)."""
    logits = apply(params, cfg, batch["x"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    y = batch["y"].long()
    nll = -logp.gather(-1, y[..., None]).squeeze(-1).mean(-1)
    if cfg.l2_reg > 0.0:
        d = nll.shape[0]
        sq = sum((leaf.reshape(d, -1) ** 2).sum(-1)
                 for _, leaf in tree_leaves(params))
        nll = nll + 0.5 * cfg.l2_reg * sq
    return nll


def accuracy(params, cfg: PaperModelConfig, batch):
    """Per-device share of correct argmax predictions, shape (D,)."""
    logits = apply(params, cfg, batch["x"])
    return (logits.argmax(-1) == batch["y"].long()).float().mean(-1)

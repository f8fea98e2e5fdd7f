"""Shared neural-net building blocks of the LLM zoo (the port of
``repro/models/layers.py``).

Every "module" is a pair of functions, ``*_init(gen, ...) -> params`` and
``*_apply(params, x, ...) -> y``, with params as plain dicts of tensors
under the reference's leaf names. Inits draw from a ``torch.Generator``
on the device the parameters live on; ``lead`` prepends stacked axes
(the decoder's ``(n_blocks,)``), each slice drawn on its own so that a
large stacked leaf never needs a float32 copy of itself. Norms and
rotary embeddings compute in float32 and cast back, as the reference
does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["apply_mrope", "apply_rope", "dense_init", "embed_init",
           "gelu_mlp_apply", "gelu_mlp_init", "layernorm_apply",
           "layernorm_init", "norm_apply", "norm_init", "normal_init",
           "promoted_matmul", "rmsnorm_apply", "rmsnorm_init", "sinusoidal_positions",
           "swiglu_apply", "swiglu_init"]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(gen, shape, scale, dtype=torch.float32):
    """``normal(shape) * scale`` in float32, cast to ``dtype``, drawn on
    ``gen.device``; a leaf of more than two axes is drawn one leading
    slice at a time."""
    shape = tuple(shape)
    if len(shape) > 2:
        out = torch.empty(shape, dtype=dtype, device=gen.device)
        for i in range(shape[0]):
            out[i] = normal_init(gen, shape[1:], scale, dtype)
        return out
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's scalar arrays are."""
    return float(torch.tensor(x, dtype=torch.float32))


def dense_init(gen, d_in, d_out, dtype=torch.float32, scale=None, lead=()):
    """(``lead`` +) (d_in, d_out) weights, normal * ``scale`` (default
    1 / sqrt(d_in) in float32)."""
    scale = _f32(1.0 / math.sqrt(d_in)) if scale is None else scale
    return normal_init(gen, tuple(lead) + (d_in, d_out), scale, dtype)


def embed_init(gen, vocab, d, dtype=torch.float32, lead=()):
    """(vocab, d) embedding table, normal * 0.02."""
    return normal_init(gen, tuple(lead) + (vocab, d), 0.02, dtype)


def promoted_matmul(a, w):
    """``a @ w`` in the promoted type of the two, as ``jnp.matmul``
    promotes (``torch.matmul`` refuses mixed types): a float32 activation
    against bfloat16 weights computes in float32."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d, dtype=torch.float32, device="cpu", lead=()):
    """{"scale": ones}."""
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm_apply(params, x, eps=1e-6):
    """x * rsqrt(mean(x^2) + eps) * scale, in float32, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d, dtype=torch.float32, device="cpu", lead=()):
    """{"scale": ones, "bias": zeros}."""
    shape = tuple(lead) + (d,)
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm_apply(params, x, eps=1e-5):
    """(x - mean) * rsqrt(var + eps) * scale + bias, in float32, cast
    back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def norm_init(cfg, d=None, dtype=torch.float32, device="cpu", lead=()):
    """The config's norm (RMSNorm or LayerNorm) over ``d`` (default
    d_model)."""
    d = d or cfg.d_model
    init = rmsnorm_init if cfg.use_rmsnorm else layernorm_init
    return init(d, dtype, device, lead)


def norm_apply(cfg, params, x):
    """The config's norm with its epsilon."""
    if cfg.use_rmsnorm:
        return rmsnorm_apply(params, x, cfg.norm_eps)
    return layernorm_apply(params, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE + Qwen2-VL's M-RoPE)
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim, theta, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x, angles):
    sin = torch.sin(angles)[:, :, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta=10_000.0):
    """x: (b, s, h, d); positions: (b, s) int -> same shape as x."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)          # (d/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, theta=10_000.0, sections=(2, 1, 1)):
    """Qwen2-VL multimodal RoPE. x: (b, s, h, d); positions3: (b, s, 3)
    (temporal, height, width) position ids. The d/2 frequency slots are
    split between the three components in ratio ``sections``."""
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(d, theta, x.device)
    total = sum(sections)
    bounds = [half * sum(sections[:i + 1]) // total for i in range(3)]
    comp = torch.zeros(half, dtype=torch.long, device=x.device)
    comp[bounds[0]:bounds[1]] = 1
    comp[bounds[1]:bounds[2]] = 2
    pos = torch.gather(positions3.float(), -1,
                       comp.expand(positions3.shape[:2] + (half,)))
    return _rotate(x, pos * freqs)


def sinusoidal_positions(max_len, d, device="cpu"):
    """Whisper-style fixed sinusoidal embeddings: (max_len, d) float32."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10_000.0 ** (dim / d))
    emb = torch.zeros(max_len, d, dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(angle)
    emb[:, 1::2] = torch.cos(angle)
    return emb


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu_init(gen, d, d_ff, dtype=torch.float32, lead=()):
    """{"w_gate", "w_up"} (d, d_ff) and {"w_down"} (d_ff, d)."""
    return {"w_gate": dense_init(gen, d, d_ff, dtype, lead=lead),
            "w_up": dense_init(gen, d, d_ff, dtype, lead=lead),
            "w_down": dense_init(gen, d_ff, d, dtype, lead=lead)}


def swiglu_apply(params, x):
    """(silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    g = F.silu(x @ params["w_gate"])
    return (g * (x @ params["w_up"])) @ params["w_down"]


def gelu_mlp_init(gen, d, d_ff, dtype=torch.float32, lead=()):
    """{"w_in", "b_in", "w_out", "b_out"}, biases zero."""
    dev = gen.device
    return {"w_in": dense_init(gen, d, d_ff, dtype, lead=lead),
            "b_in": torch.zeros(tuple(lead) + (d_ff,), dtype=dtype,
                                device=dev),
            "w_out": dense_init(gen, d_ff, d, dtype, lead=lead),
            "b_out": torch.zeros(tuple(lead) + (d,), dtype=dtype,
                                 device=dev)}


def gelu_mlp_apply(params, x):
    """gelu(x @ w_in + b_in) @ w_out + b_out, the tanh approximation as
    ``jax.nn.gelu`` computes by default."""
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]

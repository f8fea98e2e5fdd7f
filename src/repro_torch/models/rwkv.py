"""RWKV-6 ("Finch") block: time mix with a data-dependent decay, and
channel mix (the port of ``repro/models/rwkv.py``).

The WKV recurrence is ``repro_torch.kernels.rwkv6_scan.wkv``: the
hand-written CUDA kernel for CUDA tensors, its plain version on the CPU
or with ``mode="torch"``; differentiable, through the backward kernel
``rwkv6_scan_bwd`` on the card (training runs without a cache, so no
state is written in place). Around it, as the reference writes it: the
token shift and its interpolations, the decay LoRA (float32, the
data-dependent w_t), the receptance/key/value/gate projections, ``ln_x``
(an RMSNorm over all of d, standing in for the per-head group norm),
the SiLU gate and the squared-ReLU channel mix. Decode carries the last
token of each mix's input and the float32 WKV state, O(1) in the
sequence length.

Dtypes follow the reference's promotion: ``decay_w0`` and ``bonus_u`` are
float32 leaves in a bfloat16 tree, and a float32 token-shift buffer (the
reference engine's default cache) promotes a bfloat16 input to float32
(JAX's ``concatenate`` and ``@`` promote; here the products cast their
operands to the promoted type explicitly).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import wkv
from repro_torch.models import layers

__all__ = ["DECAY_LORA", "channelmix_apply", "channelmix_init",
           "init_rwkv_cache", "timemix_apply", "timemix_init"]

DECAY_LORA = 64


def timemix_init(gen, cfg, dtype=torch.float32, lead=()):
    """Token-shift weights ``mu_*`` (0.5), projections ``w_r, w_k, w_v,
    w_g, w_o`` (d, d), the decay LoRA (``decay_w0`` -6.0 float32,
    ``decay_A`` (d, 64), ``decay_B`` (64, d) at scale 0.01), ``bonus_u``
    (h, n) float32 normal * 0.1 and ``ln_x``; ``lead`` prepends stacked
    axes."""
    d, h, n = cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
    if h * n != d:
        raise ValueError(f"rwkv heads {h} x head_dim {n} != d_model {d}")
    dev = gen.device
    lead = tuple(lead)

    def full(value, dt=dtype):
        return torch.full(lead + (d,), value, dtype=dt, device=dev)

    p = {f"mu_{s}": full(0.5) for s in "rkvwg"}
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = layers.dense_init(gen, d, d, dtype, lead=lead)
    p["decay_w0"] = full(-6.0, torch.float32)
    p["decay_A"] = layers.dense_init(gen, d, DECAY_LORA, dtype, lead=lead)
    p["decay_B"] = layers.dense_init(gen, DECAY_LORA, d, dtype, scale=0.01,
                                     lead=lead)
    p["bonus_u"] = layers.normal_init(gen, lead + (h, n), 0.1, torch.float32)
    p["ln_x"] = layers.rmsnorm_init(d, dtype, dev, lead)
    return p


def channelmix_init(gen, cfg, dtype=torch.float32, lead=()):
    """``mu_k``, ``mu_r`` (0.5), ``w_k`` (d, d_ff), ``w_v`` (d_ff, d),
    ``w_r`` (d, d)."""
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "mu_k": torch.full(lead + (d,), 0.5, dtype=dtype, device=gen.device),
        "mu_r": torch.full(lead + (d,), 0.5, dtype=dtype, device=gen.device),
        "w_k": layers.dense_init(gen, d, ff, dtype, lead=lead),
        "w_v": layers.dense_init(gen, ff, d, dtype, lead=lead),
        "w_r": layers.dense_init(gen, d, d, dtype, lead=lead),
    }


def init_rwkv_cache(cfg, batch, dtype=torch.float32, device="cpu", lead=()):
    """{"tm_last", "cm_last"}: zeros (``lead`` +) (batch, d) in ``dtype``
    (the token shifts of the two mixes); {"wkv"}: zeros (batch, h, n, n)
    float32."""
    d, h, n = cfg.d_model, cfg.num_heads, cfg.rwkv_head_dim
    lead = tuple(lead)
    return {
        "tm_last": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        "cm_last": torch.zeros(lead + (batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros(lead + (batch, h, n, n), dtype=torch.float32,
                           device=device),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1}, with zeros or ``last`` (b, d) at t = 0. x: (b,
    s, d). ``torch.cat`` promotes as ``jnp.concatenate`` does."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


_mm = layers.promoted_matmul


def _decay(params, xw):
    """w_t = exp(-exp(w0 + tanh(xw A) B)) in (0, 1), all in float32. The
    LoRA's products run at PyTorch's float32 matmul precision, whose
    default ("highest") uses no TF32; the port changes it nowhere, and
    the CLI (``repro_torch.serve.llm``) pins it once for its process."""
    lora = torch.tanh(xw.float() @ params["decay_A"].float()) \
        @ params["decay_B"].float()
    return torch.exp(-torch.exp(params["decay_w0"] + lora))


def timemix_apply(params, cfg, x, *, last=None, state=None, state_out=None,
                  mode=None):
    """x: (b, s, d) -> (y, (new_last, new_state)). ``last`` (b, d) is the
    previous token's input, ``state`` (b, h, n, n) the WKV state (None:
    zeros); ``state_out`` receives the new state in place (it may be
    ``state``). ``mode`` is the kernel's dispatch mode."""
    b, s, d = x.shape
    h, n = cfg.num_heads, cfg.rwkv_head_dim
    xs = _shift(x, last)
    r, k, v, g = (_mm(_lerp(x, xs, params[f"mu_{c}"]), params[f"w_{c}"])
                  for c in "rkvg")
    w = _decay(params, _lerp(x, xs, params["mu_w"]))          # (b, s, d)
    out, new_state = wkv(r.reshape(b, s, h, n), k.reshape(b, s, h, n),
                         v.reshape(b, s, h, n), w.reshape(b, s, h, n),
                         params["bonus_u"], state, out_state=state_out,
                         mode=mode)
    out = layers.rmsnorm_apply(params["ln_x"], out.reshape(b, s, d),
                               cfg.norm_eps)
    y = _mm(out * F.silu(g), params["w_o"])
    return y, (x[:, -1, :], new_state)


def channelmix_apply(params, cfg, x, *, last=None):
    """x: (b, s, d) -> (y, new_last): sigmoid(r) * (relu(k)^2 @ w_v)."""
    xs = _shift(x, last)
    k = torch.square(torch.relu(_mm(_lerp(x, xs, params["mu_k"]),
                                    params["w_k"])))
    r = torch.sigmoid(_mm(_lerp(x, xs, params["mu_r"]), params["w_r"]))
    return r * _mm(k, params["w_v"]), x[:, -1, :]

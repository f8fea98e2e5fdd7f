"""GQA attention layer with KV cache, qk-norm, QKV bias, RoPE/M-RoPE and
sliding window (the port of ``repro/models/attention.py``).

The attention itself is ``repro_torch.kernels.flash_attention.attention``:
the hand-written CUDA kernel for CUDA tensors, its plain version on the
CPU or with ``mode="torch"``. The KV cache is one preallocated
(b, max_len, hkv, hd) tensor per layer, written in place: prefill writes
slots [0, s), a decode step slot ``pos`` (the reference's
``dynamic_update_slice`` returns a new array; here the cache given is
updated and returned). An encoder-decoder's cross-attention
(:func:`cross_kv`, :func:`cross_apply`) projects the encoder's output to
K/V once and attends to it without a mask, a rotation or a bias.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import attention
from repro_torch.models import layers

__all__ = ["attn_apply", "attn_decode", "attn_init", "attn_prefill",
           "cross_apply", "cross_kv", "init_kv_cache"]


def attn_init(gen, cfg, dtype=torch.float32, lead=()):
    """wq (d, hq*hd), wk/wv (d, hkv*hd), wo (hq*hd, d); zero biases with
    ``use_qkv_bias``; q/k RMSNorm scales with ``use_qk_norm``."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": layers.dense_init(gen, d, hq * hd, dtype, lead=lead),
        "wk": layers.dense_init(gen, d, hkv * hd, dtype, lead=lead),
        "wv": layers.dense_init(gen, d, hkv * hd, dtype, lead=lead),
        "wo": layers.dense_init(gen, hq * hd, d, dtype, lead=lead),
    }
    dev = gen.device
    if cfg.use_qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(tuple(lead) + (n * hd,), dtype=dtype,
                                  device=dev)
    if cfg.use_qk_norm:
        p["q_norm"] = layers.rmsnorm_init(hd, dtype, dev, lead)
        p["k_norm"] = layers.rmsnorm_init(hd, dtype, dev, lead)
    return p


def init_kv_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu",
                  lead=()):
    """{"k", "v"}: zeros (``lead`` +) (batch, max_len, hkv, hd)."""
    shape = tuple(lead) + (batch, max_len, cfg.num_kv_heads,
                           cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project_qkv(params, cfg, x, positions, mrope_positions=None):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.use_qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.use_qk_norm:
        q = layers.rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    if cfg.use_mrope and mrope_positions is not None:
        q = layers.apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = layers.apply_mrope(k, mrope_positions, cfg.rope_theta)
    elif positions is not None:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _default_positions(cfg, x):
    if cfg.use_mrope:
        return None
    b, s, _ = x.shape
    return torch.arange(s, device=x.device)[None, :].expand(b, s)


def attn_apply(params, cfg, x, *, positions=None, mrope_positions=None,
               window=None, causal=True, mode=None):
    """Full-sequence attention (train / prefill without a cache).
    x: (b, s, d) -> (b, s, d)."""
    b, s, _ = x.shape
    if positions is None:
        positions = _default_positions(cfg, x)
    q, k, v = _project_qkv(params, cfg, x, positions, mrope_positions)
    w = cfg.sliding_window if window is None else window
    out = attention(q, k, v, causal=causal, window=w, q_offset=0, mode=mode)
    return out.reshape(b, s, -1) @ params["wo"]


def _write(cache, k, v, pos):
    """k, v (b, s, hkv, hd) into cache slots [pos, pos + s), in place."""
    s, max_len = k.shape[1], cache["k"].shape[1]
    if pos < 0 or pos + s > max_len:
        raise ValueError(f"cache slots [{pos}, {pos + s}) outside its "
                         f"{max_len} positions")
    cache["k"][:, pos:pos + s] = k
    cache["v"][:, pos:pos + s] = v


def attn_prefill(params, cfg, x, *, positions=None, mrope_positions=None,
                 window=None, cache=None, mode=None):
    """Like :func:`attn_apply` (causal), and writes K/V into the cache's
    slots [0, s) in place. Returns (y (b, s, d), cache)."""
    b, s, _ = x.shape
    if positions is None:
        positions = _default_positions(cfg, x)
    q, k, v = _project_qkv(params, cfg, x, positions, mrope_positions)
    w = cfg.sliding_window if window is None else window
    out = attention(q, k, v, causal=True, window=w, q_offset=0, mode=mode)
    if cache is not None:
        _write(cache, k, v, 0)
    return out.reshape(b, s, -1) @ params["wo"], cache


def attn_decode(params, cfg, x, cache, pos, *, mrope_positions=None,
                window=None, mode=None):
    """Single-token decode. x: (b, 1, d); pos: int, the cache length.
    Writes K/V into slot ``pos`` in place and attends to slots [0, pos]
    of the whole cache (q_offset = pos masks the unwritten slots and the
    kernel skips their tiles). Returns (y (b, 1, d), cache)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, mrope_positions)
    _write(cache, k, v, pos)
    w = cfg.sliding_window if window is None else window
    out = attention(q, cache["k"], cache["v"], causal=True, window=w,
                    q_offset=pos, mode=mode)
    return out.reshape(b, 1, -1) @ params["wo"], cache


def cross_kv(params, cfg, enc_out):
    """The cross-attention's K and V of the encoder's output (b, se, d):
    ``enc_out @ wk`` and ``enc_out @ wv``, each (b, se, hkv, hd)."""
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.num_kv_heads, cfg.resolved_head_dim)
    return ((enc_out @ params["wk"]).reshape(shape),
            (enc_out @ params["wv"]).reshape(shape))


def cross_apply(params, cfg, x, k, v, *, mode=None):
    """Cross-attention of x (b, s, d) to given k, v (b, se, hkv, hd):
    q = ``x @ wq`` (no rotation), non-causal from q_offset 0, then ``@
    wo``. Writes nothing. Returns (b, s, d)."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads,
                                   cfg.resolved_head_dim)
    out = attention(q, k, v, causal=False, q_offset=0, mode=mode)
    return out.reshape(b, s, -1) @ params["wo"]

"""Decoder stack of the LLM zoo (the port of ``repro/models/transformer.py``).

Layers are grouped into *blocks*: the smallest repeating pattern of
(mixer kind, MoE?) signatures. Per-layer params keep the reference's
tree, ``pos{i}/...`` leaves stacked over blocks on a leading axis, so a
JAX ``init_params`` tree carries across as it is
(``repro_torch.convert.params_from_numpy``). The reference's
``lax.scan`` over blocks becomes a Python loop over block indices that
reads views ``leaf[i]``; the KV cache is stacked the same way and each
block's slice is written in place.

Two mixer kinds are ported: attention, with the SwiGLU or MoE FFN, and
RWKV-6 (``"rwkv"``: time mix, then channel mix, ``models/rwkv.py``),
whose cache is the recurrent state (``tm_last``, ``cm_last`` in the cache
dtype and the float32 ``wkv`` state), also written in place. The Mamba
mixer and the encoder-decoder (Whisper) branches raise
``NotImplementedError``; they come in later slices (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import attention, layers, moe, rwkv

__all__ = ["block_pattern", "stack_apply", "stack_cache", "stack_init"]

_NOT_YET = {
    "mamba": "the Mamba mixer (models/mamba.py, Jamba) is not ported yet: "
             "ROADMAP.md queue 1 item 17",
    "encdec": "the encoder-decoder branches (Whisper) are not ported yet: "
              "ROADMAP.md queue 1 item 16",
}


def _refuse(cfg, kind):
    if kind == "mamba":
        raise NotImplementedError(_NOT_YET[kind])
    if cfg.is_encoder_decoder:
        raise NotImplementedError(_NOT_YET["encdec"])


# ---------------------------------------------------------------------------
# block pattern
# ---------------------------------------------------------------------------

def block_pattern(cfg):
    """Returns (n_blocks, [(kind, is_moe), ...] per position-in-block)."""
    kinds = cfg.layer_kinds()
    moe_mask = cfg.moe_layer_mask()
    period = 1
    if cfg.attn_period and cfg.attn_period > 1:
        period = cfg.attn_period
    if cfg.moe.num_experts and cfg.moe_layer_period > 1:
        period = math.lcm(period, cfg.moe_layer_period)
    if cfg.num_layers % period:
        period = cfg.num_layers  # fall back to one unscanned mega-block
    pattern = [(kinds[i], moe_mask[i]) for i in range(period)]
    for i in range(cfg.num_layers):
        if (kinds[i], moe_mask[i]) != pattern[i % period]:
            raise ValueError(f"layer pattern not periodic at {i}")
    return cfg.num_layers // period, pattern


# ---------------------------------------------------------------------------
# per-position init/apply
# ---------------------------------------------------------------------------

def _position_init(gen, cfg, kind, is_moe, dtype, lead):
    _refuse(cfg, kind)
    dev = gen.device
    p = {"norm1": layers.norm_init(cfg, dtype=dtype, device=dev, lead=lead),
         "norm2": layers.norm_init(cfg, dtype=dtype, device=dev, lead=lead)}
    if kind == "rwkv":
        p["tm"] = rwkv.timemix_init(gen, cfg, dtype, lead)
        p["cm"] = rwkv.channelmix_init(gen, cfg, dtype, lead)
        return p
    p["attn"] = attention.attn_init(gen, cfg, dtype, lead)
    if is_moe:
        p["moe"] = moe.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                      lead=lead)
    return p


def _apply_position(p, cfg, kind, is_moe, x, *, mode, cache=None, pos=None,
                    mrope_positions=None, kmode=None):
    """One layer. mode: 'full' | 'decode'; ``kmode`` is the kernels'
    dispatch mode (None, or "torch" for the plain versions). Returns (x,
    cache (updated in place), aux)."""
    _refuse(cfg, kind)
    if kind == "rwkv":
        return _apply_rwkv(p, cfg, x, cache=cache, kmode=kmode)
    aux = 0.0
    h = layers.norm_apply(cfg, p["norm1"], x)
    if mode == "full":
        if cache is not None:
            y, _ = attention.attn_prefill(
                p["attn"], cfg, h, mrope_positions=mrope_positions,
                cache=cache, mode=kmode)
        else:
            y = attention.attn_apply(p["attn"], cfg, h,
                                     mrope_positions=mrope_positions,
                                     mode=kmode)
    else:
        y, _ = attention.attn_decode(p["attn"], cfg, h, cache, pos,
                                     mrope_positions=mrope_positions,
                                     mode=kmode)
    x = x + y
    h2 = layers.norm_apply(cfg, p["norm2"], x)
    if is_moe:
        y2, aux = moe.moe_apply(p["moe"], cfg, h2, mode=kmode)
    else:
        y2 = layers.swiglu_apply(p["mlp"], h2)
    return x + y2, cache, aux


def _apply_rwkv(p, cfg, x, *, cache=None, kmode=None):
    """One RWKV-6 layer: time mix then channel mix, each on its normed
    input. With a cache (prefill or decode alike) the mixes start from
    its token shifts and WKV state, and the cache is written in place:
    the last normed input of each mix, cast to the cache dtype, and the
    new state (the kernel writes it straight into the cache)."""
    h = layers.norm_apply(cfg, p["norm1"], x)
    if cache is None:
        y, _ = rwkv.timemix_apply(p["tm"], cfg, h, mode=kmode)
    else:
        y, (tm_last, _) = rwkv.timemix_apply(
            p["tm"], cfg, h, last=cache["tm_last"], state=cache["wkv"],
            state_out=cache["wkv"], mode=kmode)
        cache["tm_last"].copy_(tm_last)
    x = x + y
    h2 = layers.norm_apply(cfg, p["norm2"], x)
    y2, cm_last = rwkv.channelmix_apply(
        p["cm"], cfg, h2, last=None if cache is None else cache["cm_last"])
    if cache is not None:
        cache["cm_last"].copy_(cm_last)
    return x + y2, cache, 0.0


# ---------------------------------------------------------------------------
# stack init / apply
# ---------------------------------------------------------------------------

def stack_init(gen, cfg, dtype=torch.float32):
    """{"pos{i}": layer params with leaves stacked (n_blocks, ...)}, drawn
    on ``gen.device``."""
    n_blocks, pattern = block_pattern(cfg)
    return {f"pos{i}": _position_init(gen, cfg, kind, is_moe, dtype,
                                      (n_blocks,))
            for i, (kind, is_moe) in enumerate(pattern)}


def stack_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu"):
    """{"pos{i}": cache} with leaves stacked (n_blocks, ...): {"k", "v"}
    zeros (n_blocks, batch, max_len, hkv, hd) per attention position;
    {"tm_last", "cm_last"} zeros (n_blocks, batch, d) in ``dtype`` and
    {"wkv"} zeros (n_blocks, batch, h, n, n) float32 per RWKV position
    (``max_len`` does not bound a recurrent state)."""
    n_blocks, pattern = block_pattern(cfg)
    out = {}
    for i, (kind, _) in enumerate(pattern):
        _refuse(cfg, kind)
        if kind == "rwkv":
            out[f"pos{i}"] = rwkv.init_rwkv_cache(cfg, batch, dtype, device,
                                                  lead=(n_blocks,))
        else:
            out[f"pos{i}"] = attention.init_kv_cache(
                cfg, batch, max_len, dtype, device, lead=(n_blocks,))
    return out


def _block(tree, i):
    """The views ``leaf[i]`` of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def stack_apply(params, cfg, x, *, mode="full", cache=None, pos=None,
                mrope_positions=None, kmode=None):
    """Run the block stack. mode 'full' (forward; with a cache, prefill)
    or 'decode' (one token at cache position ``pos``). The cache, if
    given, is written in place. Returns (x, cache, total aux loss)."""
    n_blocks, pattern = block_pattern(cfg)
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(n_blocks):
        blk = _block(params, b)
        blk_cache = _block(cache, b) if cache is not None else None
        for i, (kind, is_moe) in enumerate(pattern):
            c = blk_cache[f"pos{i}"] if blk_cache is not None else None
            x, _, aux = _apply_position(
                blk[f"pos{i}"], cfg, kind, is_moe, x, mode=mode, cache=c,
                pos=pos, mrope_positions=mrope_positions, kmode=kmode)
            aux_tot = aux_tot + aux
    return x, cache, aux_tot

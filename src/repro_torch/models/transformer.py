"""Decoder stack of the LLM zoo (the port of ``repro/models/transformer.py``).

Layers are grouped into *blocks*: the smallest repeating pattern of
(mixer kind, MoE?) signatures, after any leading dense layers
(``cfg.first_dense_layers``, DeepSeek's ``first_k_dense_replace``), which
are stacked apart under ``lead`` and run first. Per-layer params keep
the reference's tree, ``pos{i}/...`` leaves stacked over blocks on a
leading axis, so a JAX ``init_params`` tree carries across as it is
(``repro_torch.convert.params_from_numpy``). The reference's
``lax.scan`` over blocks becomes a Python loop over block indices that
reads views ``leaf[i]``; the KV cache is stacked the same way and each
block's slice is written in place.

The three mixer kinds are ported: attention and Mamba (``"mamba"``,
``models/mamba.py``; Jamba's hybrid blocks interleave the two), each
followed by the SwiGLU or MoE FFN, and RWKV-6 (``"rwkv"``: time mix, then
channel mix, ``models/rwkv.py``). A Mamba position's cache is its conv
window (``conv``, in the cache dtype) and its float32 SSM state
(``ssm``); an RWKV position's the recurrent state (``tm_last``,
``cm_last`` in the cache dtype and the float32 ``wkv`` state). Both are
written in place, as the KV cache is.

An encoder-decoder config (Whisper) adds, after each decoder layer's
self-attention, a cross-attention (``norm_x``, ``cross``) over the
encoder's output: the prefill computes its K/V from ``enc_out`` and
writes them into the cache's ``cross_k`` / ``cross_v``, a decode step
reads them from there. The encoder (:func:`encoder_init`,
:func:`encoder_apply`) is a stack of pre-norm layers over frame
embeddings (the audio frontend is a stub, as in the reference): sinusoidal
positions, non-causal self-attention, the GELU MLP, a final LayerNorm.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.models import attention, layers, mamba, moe, rwkv
from repro_torch.obs.spans import span

__all__ = ["block_pattern", "encoder_apply", "encoder_init", "lead_pattern",
           "stack_apply", "stack_cache", "stack_init"]


# ---------------------------------------------------------------------------
# block pattern
# ---------------------------------------------------------------------------

def lead_pattern(cfg):
    """(n_lead, kind) of the ``cfg.first_dense_layers`` leading layers
    (DeepSeek's ``first_k_dense_replace``): each a mixer of ``kind`` and
    a dense SwiGLU FFN, kept apart from the periodic blocks under the
    tree's ``lead`` entry with leaves stacked (n_lead, ...); (0, None)
    without a lead."""
    n = cfg.first_dense_layers
    if not n:
        return 0, None
    kinds = set(cfg.layer_kinds()[:n])
    if n >= cfg.num_layers or len(kinds) != 1:
        raise ValueError(f"{n} leading dense layers of {cfg.num_layers}, "
                         f"kinds {sorted(kinds)}: not one stack")
    return n, kinds.pop()


def block_pattern(cfg):
    """Returns (n_blocks, [(kind, is_moe), ...] per position-in-block) of
    the layers after the lead (:func:`lead_pattern`)."""
    lead = cfg.first_dense_layers
    kinds = cfg.layer_kinds()[lead:]
    moe_mask = cfg.moe_layer_mask()[lead:]
    n = cfg.num_layers - lead
    period = 1
    if cfg.attn_period and cfg.attn_period > 1:
        period = cfg.attn_period
    if cfg.moe.num_experts and cfg.moe_layer_period > 1:
        period = math.lcm(period, cfg.moe_layer_period)
    if n % period:
        period = n  # fall back to one unscanned mega-block
    pattern = [(kinds[i], moe_mask[i]) for i in range(period)]
    for i in range(n):
        if (kinds[i], moe_mask[i]) != pattern[i % period]:
            raise ValueError(f"layer pattern not periodic at {lead + i}")
    return n // period, pattern


# ---------------------------------------------------------------------------
# per-position init/apply
# ---------------------------------------------------------------------------

def _position_init(gen, cfg, kind, is_moe, dtype, lead):
    dev = gen.device
    p = {"norm1": layers.norm_init(cfg, dtype=dtype, device=dev, lead=lead),
         "norm2": layers.norm_init(cfg, dtype=dtype, device=dev, lead=lead)}
    if kind == "rwkv":
        p["tm"] = rwkv.timemix_init(gen, cfg, dtype, lead)
        p["cm"] = rwkv.channelmix_init(gen, cfg, dtype, lead)
        return p
    if kind == "mamba":
        p["mamba"] = mamba.mamba_init(gen, cfg, dtype, lead)
    else:
        p["attn"] = attention.attn_init(gen, cfg, dtype, lead)
    if is_moe:
        p["moe"] = moe.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                      lead=lead)
    if cfg.is_encoder_decoder:
        p["norm_x"] = layers.norm_init(cfg, dtype=dtype, device=dev,
                                       lead=lead)
        p["cross"] = attention.attn_init(gen, cfg, dtype, lead)
    return p


def _apply_position(p, cfg, kind, is_moe, x, *, mode, cache=None, pos=None,
                    mrope_positions=None, enc_out=None, kmode=None,
                    in_lead=False):
    """One layer. mode: 'full' | 'decode'; ``kmode`` is the kernels'
    dispatch mode (None, or "torch" for the plain versions); ``in_lead``:
    a leading dense layer, its SwiGLU under the ``dense_ffn`` span. Returns
    (x, cache (updated in place), aux)."""
    if kind == "rwkv":
        return _apply_rwkv(p, cfg, x, cache=cache, kmode=kmode)
    aux = 0.0
    h = layers.norm_apply(cfg, p["norm1"], x)
    if kind == "mamba":
        if mode == "full":
            y, _ = mamba.mamba_apply(p["mamba"], cfg, h, cache=cache,
                                     mode=kmode)
        else:
            y, _ = mamba.mamba_decode(p["mamba"], cfg, h, cache)
    elif mode == "full":
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
    if cfg.is_encoder_decoder:
        x = x + _cross_attention(p, cfg, x, mode=mode, cache=cache,
                                 enc_out=enc_out, kmode=kmode)
    h2 = layers.norm_apply(cfg, p["norm2"], x)
    if is_moe:
        y2, aux = moe.moe_apply(p["moe"], cfg, h2, mode=kmode)
    elif in_lead:
        with span("dense_ffn"):
            y2 = layers.swiglu_apply(p["mlp"], h2)
    else:
        y2 = layers.swiglu_apply(p["mlp"], h2)
    return x + y2, cache, aux


def _cross_attention(p, cfg, x, *, mode, cache, enc_out, kmode):
    """The decoder's cross-attention (reference ``transformer.py:140-159``).
    In 'full' mode its K/V come from ``enc_out`` and, with a cache, are
    written cast into ``cross_k`` / ``cross_v`` in place (the prefill itself
    attends to the uncast ones, as the reference does); a decode step reads
    them from the cache."""
    hx = layers.norm_apply(cfg, p["norm_x"], x)
    if mode == "full":
        ck, cv = attention.cross_kv(p["cross"], cfg, enc_out)
        if cache is not None:
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
    else:
        ck, cv = cache["cross_k"], cache["cross_v"]
    return attention.cross_apply(p["cross"], cfg, hx, ck, cv, mode=kmode)


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
    """{"pos{i}": layer params with leaves stacked (n_blocks, ...)}, and
    with a lead {"lead": its layers' params stacked (n_lead, ...)}, drawn
    on ``gen.device``, the lead first."""
    out = {}
    n_lead, kind = lead_pattern(cfg)
    if n_lead:
        out["lead"] = _position_init(gen, cfg, kind, False, dtype, (n_lead,))
    n_blocks, pattern = block_pattern(cfg)
    out.update({f"pos{i}": _position_init(gen, cfg, kind, is_moe, dtype,
                                          (n_blocks,))
                for i, (kind, is_moe) in enumerate(pattern)})
    return out


def stack_cache(cfg, batch, max_len, dtype=torch.bfloat16, device="cpu"):
    """{"pos{i}": cache} with leaves stacked (n_blocks, ...): {"k", "v"}
    zeros (n_blocks, batch, max_len, hkv, hd) per attention position, and
    for an encoder-decoder {"cross_k", "cross_v"} zeros (n_blocks, batch,
    encoder_seq_len, hkv, hd);
    {"tm_last", "cm_last"} zeros (n_blocks, batch, d) in ``dtype`` and
    {"wkv"} zeros (n_blocks, batch, h, n, n) float32 per RWKV position;
    {"conv"} zeros (n_blocks, batch, d_conv - 1, d_in) in ``dtype`` and
    {"ssm"} zeros (n_blocks, batch, d_in, d_state) float32 per Mamba
    position (``max_len`` does not bound a recurrent state); with a lead,
    {"lead": its kind's cache stacked (n_lead, ...)}."""
    out = {}
    n_lead, kind = lead_pattern(cfg)
    if n_lead:
        out["lead"] = _position_cache(cfg, kind, batch, max_len, dtype,
                                      device, n_lead)
    n_blocks, pattern = block_pattern(cfg)
    for i, (kind, _) in enumerate(pattern):
        out[f"pos{i}"] = _position_cache(cfg, kind, batch, max_len, dtype,
                                         device, n_blocks)
    return out


def _position_cache(cfg, kind, batch, max_len, dtype, device, n):
    """One position's cache (:func:`stack_cache`), leaves stacked (n, ...)."""
    if kind == "rwkv":
        return rwkv.init_rwkv_cache(cfg, batch, dtype, device, lead=(n,))
    if kind == "mamba":
        return mamba.init_mamba_cache(cfg, batch, dtype, device, lead=(n,))
    c = attention.init_kv_cache(cfg, batch, max_len, dtype, device,
                                lead=(n,))
    if cfg.is_encoder_decoder:
        cross = attention.init_kv_cache(cfg, batch, cfg.encoder_seq_len,
                                        dtype, device, lead=(n,))
        c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
    return c


def _block(tree, i):
    """The views ``leaf[i]`` of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n):
    """[block i's views of every leaf of ``tree``] for i < n, through
    ``leaf.unbind(0)``: under autograd its backward stacks the blocks'
    gradients into one tensor per leaf, where indexing ``leaf[i]`` would
    build a full-size zero gradient for every block."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return tree.unbind(0)


def stack_apply(params, cfg, x, *, mode="full", cache=None, pos=None,
                mrope_positions=None, enc_out=None, kmode=None,
                remat=False):
    """Run the block stack. mode 'full' (forward; with a cache, prefill)
    or 'decode' (one token at cache position ``pos``). ``enc_out`` (b,
    encoder_seq_len, d) is the encoder's output, which an encoder-decoder
    needs in 'full' mode. The cache, if given, is written in place.
    ``remat`` (training without a cache, grad mode on) checkpoints each
    block with ``torch.utils.checkpoint`` as the reference's
    ``jax.checkpoint`` does: its activations are recomputed in the
    backward, so its kernels launch twice; a leading dense layer
    (:func:`lead_pattern`) runs first, checkpointed alone. Returns (x,
    cache, total aux loss)."""
    kw = dict(mode=mode, pos=pos, mrope_positions=mrope_positions,
              enc_out=enc_out, kmode=kmode)
    remat = remat and cache is None and torch.is_grad_enabled()
    n_lead, lead_kind = lead_pattern(cfg)
    for i, p in enumerate(_unbind(params["lead"], n_lead) if n_lead else ()):
        c = _block(cache["lead"], i) if cache is not None else None

        def run_lead(x, p=p, c=c):
            return _apply_position(p, cfg, lead_kind, False, x, cache=c,
                                   in_lead=True, **kw)[0]

        x = torch.utils.checkpoint.checkpoint(run_lead, x,
                                              use_reentrant=False) \
            if remat else run_lead(x)
    n_blocks, pattern = block_pattern(cfg)
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    positions = [f"pos{i}" for i in range(len(pattern))]
    blocks = _unbind({k: params[k] for k in positions}, n_blocks)
    for b in range(n_blocks):
        blk = blocks[b]
        blk_cache = _block({k: cache[k] for k in positions}, b) \
            if cache is not None else None

        def run(x, blk=blk, blk_cache=blk_cache):
            aux_blk = 0.0
            for i, (kind, is_moe) in enumerate(pattern):
                c = blk_cache[f"pos{i}"] if blk_cache is not None else None
                x, _, aux = _apply_position(blk[f"pos{i}"], cfg, kind,
                                            is_moe, x, cache=c, **kw)
                aux_blk = aux_blk + aux
            return x, aux_blk

        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(run, x,
                                                       use_reentrant=False)
        else:
            x, aux = run(x)
        aux_tot = aux_tot + aux
    return x, cache, aux_tot


# ---------------------------------------------------------------------------
# whisper encoder
# ---------------------------------------------------------------------------

def encoder_init(gen, cfg, dtype=torch.float32):
    """{"layers": {norm1, attn, norm2, mlp} with leaves stacked
    (encoder_layers, ...), "final_norm"}, drawn on ``gen.device``."""
    dev, lead = gen.device, (cfg.encoder_layers,)
    return {
        "layers": {
            "norm1": layers.norm_init(cfg, dtype=dtype, device=dev,
                                      lead=lead),
            "attn": attention.attn_init(gen, cfg, dtype, lead),
            "norm2": layers.norm_init(cfg, dtype=dtype, device=dev,
                                      lead=lead),
            "mlp": layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                        lead=lead),
        },
        "final_norm": layers.norm_init(cfg, dtype=dtype, device=dev),
    }


def encoder_apply(params, cfg, frames, *, kmode=None):
    """frames: (b, encoder_seq_len, d) precomputed embeddings (the
    frontend stub) -> (b, encoder_seq_len, d). Each layer: norm,
    non-causal self-attention (``attn_apply(causal=False, positions=
    None)``, as the reference calls it), norm, GELU MLP; a final norm."""
    _, s, d = frames.shape
    pos = layers.sinusoidal_positions(s, d, device=frames.device)
    x = frames + pos.to(frames.dtype)[None]
    stacked = params["layers"]
    for i in range(cfg.encoder_layers):
        p = _block(stacked, i)
        h = layers.norm_apply(cfg, p["norm1"], x)
        x = x + attention.attn_apply(p["attn"], cfg, h, causal=False,
                                     positions=None, mode=kmode)
        h2 = layers.norm_apply(cfg, p["norm2"], x)
        x = x + layers.gelu_mlp_apply(p["mlp"], h2)
    return layers.norm_apply(cfg, params["final_norm"], x)

"""Batched LLM serving engine: prefill once, then one-token decode steps
against a preallocated cache (the port of ``repro/serve/engine.py``): a
KV cache of ``max_len`` slots for attention layers (and an
encoder-decoder's cross K/V, which the prefill fills and every decode step
reads), the recurrent state (token shifts and the float32 WKV state) for
RWKV-6 layers, the conv window and the float32 SSM state for Mamba layers
(Jamba's hybrid stack holds both kinds).

``make_prefill_step`` / ``make_decode_step`` return the step functions;
``ServeEngine`` drives them. Everything runs eagerly under
``torch.inference_mode()``; the decode position is a host int and the
cache is written in place. On the card, at every step (the prefill and
each decode step), every attention launches the ``flash_attention``
kernel once (an encoder-decoder's: each decoder layer's self- and
cross-attention, and in the prefill each encoder layer's), every MoE
layer the ``moe_router`` kernel once and every RWKV layer the
``rwkv6_scan`` kernel once; a Mamba layer launches none of them (its
selective scan is torch ops).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serve import sampler as sampler_lib

__all__ = ["ServeEngine", "make_decode_step", "make_prefill_step"]


def make_prefill_step(cfg, *, mode=None):
    """``(params, batch, cache) -> (last-token logits (b, 1, V), cache)``:
    one whole-prompt forward that fills the cache."""
    def prefill_step(params, batch, cache):
        return model_lib.prefill(params, cfg, batch, cache, last_only=True,
                                 mode=mode)
    return prefill_step


def make_decode_step(cfg, *, sample: str = "greedy", temp: float = 1.0,
                     mode=None):
    """``(params, cache, tokens (b, 1), pos, gen) -> (next tokens (b, 1)
    int32, cache)``: one new token against the cache at host position
    ``pos``, sampled greedily or by temperature from ``gen``. A VLM's
    token sits at M-RoPE position ``pos`` in all three components."""
    if sample not in ("greedy", "temp"):
        raise ValueError(f"unknown sampler {sample!r}")

    def decode_step(params, cache, tokens, pos, gen):
        batch = {"tokens": tokens}
        if cfg.family == "vlm":
            batch["mrope_positions"] = torch.full(
                (tokens.shape[0], 1, 3), int(pos), dtype=torch.int32,
                device=tokens.device)
        logits, cache = model_lib.decode_step(params, cfg, cache, batch, pos,
                                              mode=mode)
        if sample == "greedy":
            return sampler_lib.greedy(logits), cache
        return sampler_lib.temperature(logits, gen, temp), cache
    return decode_step


@dataclass
class ServeEngine:
    """Single-model autoregressive serving loop: prefill once, then
    ``max_new_tokens - 1`` one-token decode steps. The cache
    (``cache_dtype``, float32 by default as in the reference; an RWKV
    state stays float32) is allocated per ``generate`` call at ``max_len``
    positions. ``device``
    defaults to the card and raises without one; ``mode="torch"`` runs
    the kernels' plain versions."""
    cfg: object
    params: object
    max_len: int
    cache_dtype: object = torch.float32
    sample: str = "greedy"
    temp: float = 1.0
    device: object = DEFAULT_DEVICE
    mode: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._prefill = make_prefill_step(self.cfg, mode=self.mode)
        self._decode = make_decode_step(self.cfg, sample=self.sample,
                                        temp=self.temp, mode=self.mode)

    def generate(self, batch, *, max_new_tokens: int, seed: int = 0):
        """batch: prefill inputs (tensors or arrays): {"tokens": (b, s)},
        a VLM's {"embeds", "mrope_positions"}, an encoder-decoder's
        {"enc_frames", "tokens"}; the prompt's length is that of "tokens",
        else of "embeds". Returns the new tokens (b, max_new_tokens) int32 on the engine's
        device; temperature sampling draws from a generator seeded with
        ``seed``."""
        with torch.inference_mode():
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            first = next(iter(batch.values()))
            b = first.shape[0]
            prompt_len = batch["tokens"].shape[1] if "tokens" in batch \
                else batch["embeds"].shape[1]
            if prompt_len + max_new_tokens - 1 > self.max_len:
                raise ValueError(
                    f"prompt {prompt_len} + {max_new_tokens - 1} decode "
                    f"steps exceed max_len {self.max_len}")
            cache = model_lib.init_cache(self.cfg, b, self.max_len,
                                         dtype=self.cache_dtype,
                                         device=self.device)
            logits, cache = self._prefill(self.params, batch, cache)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            tok = sampler_lib.greedy(logits) if self.sample == "greedy" \
                else sampler_lib.temperature(logits, gen, self.temp)
            out = [tok]
            for i in range(max_new_tokens - 1):
                tok, cache = self._decode(self.params, cache, tok,
                                          prompt_len + i, gen)
                out.append(tok)
            return torch.cat(out, dim=1)

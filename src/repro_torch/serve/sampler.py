"""Token samplers of the LLM serving loop (the port of
``repro/serve/sampler.py``): greedy and temperature with an optional
top-k cutoff. Randomness comes from an explicit ``torch.Generator``."""
from __future__ import annotations

import torch

__all__ = ["greedy", "temperature"]


def greedy(logits, gen=None):
    """logits: (b, s, V) -> (b, s) int32, the first index of each row's
    maximum."""
    return logits.argmax(dim=-1).to(torch.int32)


def temperature(logits, gen, temp: float = 1.0, top_k: int = 0):
    """A categorical draw from softmax(logits / temp) per row, by the
    Gumbel-max trick as ``jax.random.categorical`` draws; with ``top_k``
    every logit below the k-th largest is set to -1e30 first. ``gen``:
    a ``torch.Generator`` on the logits' device. Returns (b, s) int32."""
    x = logits.float() / max(temp, 1e-6)
    if top_k:
        cutoff = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < cutoff, -1e30, x)
    u = torch.rand(x.shape, generator=gen, device=x.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (x - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)

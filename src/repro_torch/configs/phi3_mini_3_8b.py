"""Phi-3-mini 3.8B [dense] — arXiv:2404.14219.

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064 — RoPE SwiGLU GQA.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    tie_embeddings=False,
    citation="arXiv:2404.14219",
)

REDUCED = reduce_config(CONFIG)

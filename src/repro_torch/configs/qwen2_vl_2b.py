"""Qwen2-VL 2B [vlm] — arXiv:2409.12191.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 — M-RoPE, dynamic
resolution. Vision encoder (ViT) is a stub per the brief: ``input_specs``
provides precomputed patch embeddings; this config is the LM backbone that
consumes them (mixed text tokens + vision embeds).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    use_mrope=True,
    use_qkv_bias=True,
    embedding_inputs=True,   # frontend stub: patch embeddings arrive precomputed
    rope_theta=1_000_000.0,
    citation="arXiv:2409.12191",
)

REDUCED = reduce_config(CONFIG)

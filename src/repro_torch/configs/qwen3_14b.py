"""Qwen3-14B [dense] — hf:Qwen/Qwen3-8B (family card).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 — qk_norm, GQA.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151_936,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-8B",
)

REDUCED = reduce_config(CONFIG)

"""Qwen1.5-32B [dense] — hf:Qwen/Qwen1.5-0.5B (family card).

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064 — QKV bias.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    use_qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen1.5-0.5B",
)

REDUCED = reduce_config(CONFIG)

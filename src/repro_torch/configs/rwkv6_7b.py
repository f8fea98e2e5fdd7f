"""RWKV-6 (Finch) 7B [ssm] — arXiv:2404.05892.

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536 — data-dependent
decay linear attention (WKV6). num_heads below is the WKV head count
(head_dim=64 per the RWKV-6 paper).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65_536,
    rwkv_head_dim=64,
    citation="arXiv:2404.05892",
)

REDUCED = reduce_config(CONFIG).replace(num_heads=4, num_kv_heads=4,
                                        rwkv_head_dim=64, d_model=256)

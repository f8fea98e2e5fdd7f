"""Jamba-1.5-Large 398B [hybrid] — arXiv:2403.19887.

72L d_model=8192 64H (GQA kv=8) d_ff=24576, MoE 16e top-2 — Mamba+attention
1:7 interleave (attn_period=8: one attention layer per 8-layer block), MoE on
every other layer (Jamba places MoE at period 2).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_config

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65_536,
    moe=MoEConfig(num_experts=16, num_shared_experts=0, top_k=2,
                  expert_d_ff=24576, router_aux_weight=0.01),
    moe_layer_period=2,
    attn_period=8,             # 1 attention : 7 mamba
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    citation="arXiv:2403.19887",
)

REDUCED = reduce_config(CONFIG)

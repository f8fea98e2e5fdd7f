"""DeepSeek-MoE 16B [moe] — arXiv:2401.06066.

28L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=102400,
fine-grained MoE: 2 shared + 64 routed experts, top-6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_config

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,               # expert FFN width (fine-grained)
    vocab_size=102_400,
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  expert_d_ff=1408, router_aux_weight=0.01),
    moe_layer_period=1,
    citation="arXiv:2401.06066",
)

REDUCED = reduce_config(CONFIG)

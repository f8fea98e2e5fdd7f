"""DBRX 132B [moe] — hf:databricks/dbrx-base.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16 experts
top-4, fine-grained.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduce_config

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    moe=MoEConfig(num_experts=16, num_shared_experts=0, top_k=4,
                  expert_d_ff=10752, router_aux_weight=0.05),
    moe_layer_period=1,
    rope_theta=500_000.0,
    citation="hf:databricks/dbrx-base",
)

REDUCED = reduce_config(CONFIG)

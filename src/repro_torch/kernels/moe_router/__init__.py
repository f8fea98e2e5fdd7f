"""MoE routing: the fused Hopper CUDA kernel (router product, softmax,
top-k, capacity positions, load statistics), the CUDA kernel on given
logits, the backward kernel of both, and their plain PyTorch versions."""
from repro_torch.kernels.moe_router.ops import (FORMS, KERNELS,
                                                MAX_EXPERTS, VARIANTS,
                                                logits_bwd, plan,
                                                reset_variants, route_tokens,
                                                route_topk)
from repro_torch.kernels.moe_router.ref import (load_balance_loss,
                                                positions_ref, route_ref,
                                                route_tokens_bwd_ref,
                                                route_tokens_ref)

__all__ = ["FORMS", "KERNELS", "MAX_EXPERTS", "VARIANTS", "load_balance_loss",
           "logits_bwd", "plan", "positions_ref", "reset_variants",
           "route_ref", "route_tokens", "route_tokens_bwd_ref",
           "route_tokens_ref", "route_topk"]

"""MoE routing: the fused Hopper CUDA kernel (router product, softmax,
top-k, capacity positions, load statistics), the CUDA kernel on given
logits, the backward kernels (dl on given logits; the fused router's whole
backward), and their plain PyTorch versions."""
from repro_torch.kernels.moe_router.ops import (BWD_VARIANTS, FORMS, KERNELS,
                                                MAX_EXPERTS, VARIANTS,
                                                logits_bwd, plan, plan_bwd,
                                                reset_variants, route_tokens,
                                                route_topk, tokens_bwd)
from repro_torch.kernels.moe_router.ref import (full_bwd_pieces,
                                                load_balance_loss,
                                                positions_ref, route_ref,
                                                route_tokens_bwd_ref,
                                                route_tokens_full_bwd_ref,
                                                route_tokens_ref)

__all__ = ["BWD_VARIANTS", "FORMS", "KERNELS", "MAX_EXPERTS", "VARIANTS",
           "full_bwd_pieces", "load_balance_loss", "logits_bwd", "plan",
           "plan_bwd", "positions_ref", "reset_variants", "route_ref",
           "route_tokens", "route_tokens_bwd_ref", "route_tokens_full_bwd_ref",
           "route_tokens_ref", "route_topk", "tokens_bwd"]

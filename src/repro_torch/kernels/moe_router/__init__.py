"""Fused MoE routing (softmax, top-k, renormalise, load statistics): the
Hopper CUDA kernel and its plain PyTorch version."""
from repro_torch.kernels.moe_router.ops import (KERNELS, MAX_EXPERTS,
                                                route_topk)
from repro_torch.kernels.moe_router.ref import load_balance_loss, route_ref

__all__ = ["KERNELS", "MAX_EXPERTS", "load_balance_loss", "route_ref",
           "route_topk"]

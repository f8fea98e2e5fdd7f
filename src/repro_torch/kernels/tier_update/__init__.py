"""PerMFL's team and server updates (eqs. 9 and 13) at LLM scale: Hopper
CUDA kernel + plain PyTorch version."""
from repro_torch.kernels.tier_update.ops import tier_update, tier_update_tree
from repro_torch.kernels.tier_update.ref import tier_update_ref

__all__ = ["tier_update", "tier_update_ref", "tier_update_tree"]

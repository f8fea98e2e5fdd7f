"""Flash attention (causal / sliding-window / non-causal, GQA): the Hopper
CUDA kernel and its plain PyTorch version."""
from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS, KERNELS,
                                                     attention)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     live_pairs, sm_scale)

__all__ = ["HEAD_DIMS", "KERNELS", "attention", "attention_ref",
           "live_pairs", "sm_scale"]

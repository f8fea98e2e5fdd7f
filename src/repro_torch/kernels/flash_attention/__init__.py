"""Flash attention (causal / sliding-window / non-causal, GQA): the Hopper
CUDA kernels (a tensor-core prefill, a split-kv decode, a CUDA-core kernel
for the rest, and a tensor-core and a CUDA-core backward) and their plain
PyTorch versions."""
from repro_torch.kernels.flash_attention.ops import (BWD_VARIANTS,
                                                     HEAD_DIMS, KERNELS,
                                                     VARIANTS, attention,
                                                     attention_bwd, plan,
                                                     plan_bwd,
                                                     reset_variants)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_partials,
                                                     attention_ref,
                                                     combine_partials,
                                                     live_pairs, sm_scale,
                                                     visible_keys)

__all__ = ["BWD_VARIANTS", "HEAD_DIMS", "KERNELS", "VARIANTS", "attention",
           "attention_bwd", "attention_bwd_ref", "attention_lse_ref",
           "attention_partials", "attention_ref", "combine_partials",
           "live_pairs", "plan", "plan_bwd", "reset_variants", "sm_scale",
           "visible_keys"]

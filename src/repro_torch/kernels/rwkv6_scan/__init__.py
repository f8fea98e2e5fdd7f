"""RWKV-6 WKV recurrence (data-dependent decay linear attention): the
Hopper CUDA kernels (a chunked tensor-core scan, a sequential one, and a
chunked and a sequential backward) and their plain PyTorch versions."""
from repro_torch.kernels.rwkv6_scan.ops import BWD_VARIANTS, HEAD_SIZES, \
    KERNELS, VARIANTS, plan, plan_bwd, reset_variants, wkv, wkv_bwd
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref, wkv6_chunked, \
    wkv6_chunked_bwd, wkv6_ref

__all__ = ["BWD_VARIANTS", "HEAD_SIZES", "KERNELS", "VARIANTS", "plan",
           "plan_bwd", "reset_variants", "wkv", "wkv6_bwd_ref",
           "wkv6_chunked", "wkv6_chunked_bwd", "wkv6_ref", "wkv_bwd"]

"""RWKV-6 WKV recurrence (data-dependent decay linear attention): the
Hopper CUDA kernels (a chunked tensor-core scan, a sequential one and the
backward) and their plain PyTorch versions."""
from repro_torch.kernels.rwkv6_scan.ops import HEAD_SIZES, KERNELS, \
    VARIANTS, plan, reset_variants, wkv, wkv_bwd
from repro_torch.kernels.rwkv6_scan.ref import wkv6_bwd_ref, wkv6_chunked, \
    wkv6_ref

__all__ = ["HEAD_SIZES", "KERNELS", "VARIANTS", "plan", "reset_variants",
           "wkv", "wkv6_bwd_ref", "wkv6_chunked", "wkv6_ref", "wkv_bwd"]

"""RWKV-6 WKV recurrence (data-dependent decay linear attention): the
Hopper CUDA kernel and its plain PyTorch version."""
from repro_torch.kernels.rwkv6_scan.ops import HEAD_SIZES, KERNELS, wkv
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

__all__ = ["HEAD_SIZES", "KERNELS", "wkv", "wkv6_ref"]

"""Mamba's selective scan: the Hopper CUDA kernels (the forward, which
also writes the backward's snapshots, and the backward) and their plain
PyTorch versions."""
from repro_torch.kernels.mamba_scan.ops import BWD_CHANNELS, D_STATE, \
    KERNELS, SEGMENT, SNAPSHOT_EVERY, bwd_scratch, launch, launch_bwd, \
    scan, scan_bwd
from repro_torch.kernels.mamba_scan.ref import scan_bwd_ref, scan_ref

__all__ = ["BWD_CHANNELS", "D_STATE", "KERNELS", "SEGMENT",
           "SNAPSHOT_EVERY", "bwd_scratch", "launch", "launch_bwd", "scan",
           "scan_bwd", "scan_bwd_ref", "scan_ref"]

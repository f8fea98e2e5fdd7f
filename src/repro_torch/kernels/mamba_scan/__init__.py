"""Mamba's selective scan: the Hopper CUDA kernels (the forward, which
also writes the backward's snapshots, and the backward, each in two
variants, ``ring`` and ``simt``) and their plain PyTorch versions."""
from repro_torch.kernels.mamba_scan.ops import BWD_CHANNELS, BWD_VARIANTS, \
    D_STATE, KERNELS, RING_CHANNELS, SEGMENT, SNAPSHOT_EVERY, VARIANTS, \
    bwd_scratch, launch, launch_bwd, plan, plan_bwd, reset_variants, \
    scan, scan_bwd
from repro_torch.kernels.mamba_scan.ref import scan_bwd_ref, scan_ref

__all__ = ["BWD_CHANNELS", "BWD_VARIANTS", "D_STATE", "KERNELS",
           "RING_CHANNELS", "SEGMENT", "SNAPSHOT_EVERY", "VARIANTS",
           "bwd_scratch", "launch", "launch_bwd", "plan", "plan_bwd",
           "reset_variants", "scan", "scan_bwd",
           "scan_bwd_ref", "scan_ref"]

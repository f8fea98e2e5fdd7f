"""Compression of the uplinks, with error feedback and without: Hopper
CUDA kernels (top-k, rand-k, int8, sign) + plain PyTorch versions and
wire helpers."""
from repro_torch.kernels.compress.ops import (KERNELS, TILE, Segments,
                                              ef_int8, ef_randk, ef_sign,
                                              ef_topk, randk,
                                              segment_thresholds, segments,
                                              sign, sign_scales, tiles, topk,
                                              unbiased_scales)
from repro_torch.kernels.compress.ref import (kth_threshold, pack_topk,
                                              sign_unpack, unpack_topk)

__all__ = ["KERNELS", "Segments", "TILE", "ef_int8", "ef_randk", "ef_sign",
           "ef_topk", "kth_threshold", "pack_topk", "randk",
           "segment_thresholds", "segments", "sign", "sign_scales",
           "sign_unpack", "tiles", "topk", "unbiased_scales", "unpack_topk"]

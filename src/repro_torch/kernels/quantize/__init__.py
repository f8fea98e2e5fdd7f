"""Stochastic int8 quantize of flat sender rows: the Hopper CUDA kernel
and its plain PyTorch version."""
from repro_torch.kernels.quantize.ops import (KERNELS, dequantize_int8,
                                              quantize_int8, quantize_rows,
                                              row_of_column)
from repro_torch.kernels.quantize.ref import (dequantize_int8_ref,
                                              quantize_int8_ref)

__all__ = ["KERNELS", "dequantize_int8", "dequantize_int8_ref",
           "quantize_int8", "quantize_int8_ref", "quantize_rows",
           "row_of_column"]

"""The roofline of the port on one H100: each kernel family's work and
bound (:mod:`~repro_torch.roofline.kernels`), a step's counts op by op
(:mod:`~repro_torch.roofline.op_analysis`) and its three terms
(:mod:`~repro_torch.roofline.analysis`)."""
from repro_torch.roofline.analysis import (Roofline, analyze,
                                           model_flops_decode,
                                           model_flops_train)

__all__ = ["Roofline", "analyze", "model_flops_decode", "model_flops_train"]

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

Frozen copy of the constants of ``src/repro_torch/launch/mesh.py``
(``PEAK_FLOPS_BF16``, ``PEAK_FLOPS_TF32``, ``PEAK_FLOPS_F32``,
``HBM_BW``). A share of a peak is stated against these, with the card's
power limit beside it.
"""
from __future__ import annotations

# floating-point operations a second by the unit that runs them
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# bytes a second of HBM3
HBM_BW = 3.35e12

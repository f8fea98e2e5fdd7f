"""The paper models' configuration (the port's copy of
``repro.configs.base.PaperModelConfig``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class PaperModelConfig:
    name: str
    kind: str                      # "mclr" | "cnn" | "dnn"
    input_shape: tuple             # e.g. (784,) or (28, 28, 1) or (60,)
    num_classes: int = 10
    hidden: Sequence[int] = ()     # dnn hidden widths
    conv_channels: Sequence[int] = ()  # cnn channels
    l2_reg: float = 0.0            # strongly-convex regularizer for MCLR
    convex: bool = False

"""Model configurations of the port: the paper models and the LLM zoo's
architectures (``get_config``, ``get_reduced_config``), copied from the
reference field for field."""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, PAPER_IDS,
                                      InputShape, ModelConfig, MoEConfig,
                                      PaperModelConfig, active_param_count,
                                      get_config, get_reduced_config,
                                      param_count, reduce_config)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "PAPER_IDS", "InputShape", "ModelConfig",
    "MoEConfig", "PaperModelConfig", "active_param_count", "get_config",
    "get_reduced_config", "param_count", "reduce_config",
]

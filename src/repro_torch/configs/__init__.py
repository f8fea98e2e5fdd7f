"""Model configurations of the port (the paper models)."""
from repro_torch.configs.base import PaperModelConfig

__all__ = ["PaperModelConfig"]

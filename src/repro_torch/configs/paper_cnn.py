"""Paper model: two-layer CNN for image datasets (non-convex)."""
from repro_torch.configs.base import PaperModelConfig

CONFIG = PaperModelConfig(
    name="paper-cnn", kind="cnn", input_shape=(28, 28, 1), num_classes=10,
    conv_channels=(16, 32), hidden=(128,))

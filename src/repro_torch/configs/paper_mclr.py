"""Paper model: multi-class logistic regression (strongly convex w/ l2)."""
from repro_torch.configs.base import PaperModelConfig

CONFIG = PaperModelConfig(
    name="paper-mclr", kind="mclr", input_shape=(784,), num_classes=10,
    l2_reg=1e-2, convex=True)

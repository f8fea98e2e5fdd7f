"""Paper model: 2-hidden-layer DNN for the synthetic tabular dataset."""
from repro_torch.configs.base import PaperModelConfig

CONFIG = PaperModelConfig(
    name="paper-dnn", kind="dnn", input_shape=(60,), num_classes=10,
    hidden=(64, 32))

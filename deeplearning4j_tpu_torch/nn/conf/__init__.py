"""Configuration DSL of the port (see nn/conf/configuration.py)."""
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: F401
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    TrainingConfig,
)
from deeplearning4j_tpu_torch.nn.conf import inputs, preprocessors  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401

"""Pretrained-model helpers: the VGG16 architecture and its ImageNet
preprocessing (port of the configuration part of the JAX package's
`modelimport/trained_models.py`).

`vgg16` and `vgg16_preprocess` are pure configuration and numpy.
`load_vgg16` needs the Keras HDF5 import (ROADMAP queue A, item 13) and
`resnet50` a ComputationGraph (item 12b); both raise.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                OutputLayer,
                                                SubsamplingLayer)

# ImageNet channel means of VGG preprocessing
VGG_MEAN_RGB = np.array([123.68, 116.779, 103.939], dtype=np.float32)


def _conv(n_out: int, name: str) -> ConvolutionLayer:
    return ConvolutionLayer(name=name, n_out=n_out, kernel_size=(3, 3),
                            stride=(1, 1), convolution_mode="same",
                            activation="relu")


def _pool(name: str) -> SubsamplingLayer:
    return SubsamplingLayer(name=name, pooling_type="max",
                            kernel_size=(2, 2), stride=(2, 2))


def vgg16(num_classes: int = 1000, include_top: bool = True,
          height: int = 224, width: int = 224, channels: int = 3,
          learning_rate: float = 0.01, seed: int = 12345,
          dtype: str = "bfloat16") -> MultiLayerConfiguration:
    """VGG16 (Simonyan & Zisserman 2014) as a sequential configuration:
    NHWC activations, 3x3 'same' convs, bf16 by default."""
    blocks = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    layers = []
    for bi, (reps, ch) in enumerate(blocks, start=1):
        for ri in range(1, reps + 1):
            layers.append(_conv(ch, f"block{bi}_conv{ri}"))
        layers.append(_pool(f"block{bi}_pool"))
    if include_top:
        layers.append(DenseLayer(name="fc1", n_out=4096, activation="relu"))
        layers.append(DenseLayer(name="fc2", n_out=4096, activation="relu"))
        layers.append(OutputLayer(name="predictions", n_out=num_classes,
                                  activation="softmax",
                                  loss_function="mcxent"))
    conf = NeuralNetConfiguration(
        seed=seed, learning_rate=learning_rate, updater="nesterovs",
        weight_init="relu", dtype=dtype,
    ).list(*layers)
    conf.set_input_type(InputType.convolutional(height, width, channels))
    return conf


def vgg16_preprocess(images: np.ndarray) -> np.ndarray:
    """Subtract the ImageNet channel means from NHWC uint8 / float
    images."""
    return np.asarray(images, np.float32) - VGG_MEAN_RGB


def load_vgg16(h5_path: str):
    raise NotImplementedError(
        "importing Keras HDF5 weights is not ported yet (ROADMAP queue A, "
        "item 13: modelimport/keras)")


def resnet50(*args, **kwargs):
    raise NotImplementedError(
        "resnet50 is a ComputationGraph configuration, not ported yet "
        "(ROADMAP queue A, item 12b: nn/graph, zoo.resnet50)")

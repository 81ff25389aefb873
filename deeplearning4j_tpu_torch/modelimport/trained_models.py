"""Pretrained-model helpers: the VGG16 and ResNet-50 architectures,
ImageNet preprocessing and the VGG16 weights loader (port of
deeplearning4j_tpu/modelimport/trained_models.py).

`vgg16`, `resnet50` and `vgg16_preprocess` are pure configuration and
numpy. `load_vgg16` imports a local Keras HDF5 file through the Keras
import (`modelimport.keras`); nothing is downloaded.
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


def load_vgg16(h5_path: str, device=None):
    """Import VGG16 weights from a local Keras HDF5 file onto ``device``
    (the card unless ``"cpu"``; reference flow: TrainedModelHelper ->
    KerasModelImport)."""
    from deeplearning4j_tpu_torch.modelimport.keras import \
        import_keras_model_auto
    return import_keras_model_auto(h5_path, device=device)


def resnet50(num_classes: int = 1000, height: int = 224, width: int = 224,
             channels: int = 3, learning_rate: float = 0.01,
             seed: int = 12345, dtype: str = "bfloat16"):
    """ResNet-50 (He et al. 2015) as a ComputationGraph configuration:
    NHWC activations, bottleneck blocks [3,4,6,3], batch norm after every
    conv, residual adds as ElementWiseVertex, bf16 by default. No
    preprocessor is inserted anywhere (BatchNormalization and
    ActivationLayer take any family, and global pooling emits the
    feed-forward type the head takes)."""
    from deeplearning4j_tpu_torch.nn.layers.misc import (ActivationLayer,
                                                   GlobalPoolingLayer)
    from deeplearning4j_tpu_torch.nn.layers.normalization import (
        BatchNormalization)
    from deeplearning4j_tpu_torch.nn.graph.vertices import ElementWiseVertex

    b = (NeuralNetConfiguration(seed=seed, learning_rate=learning_rate,
                                updater="nesterovs", momentum=0.9,
                                weight_init="relu", dtype=dtype,
                                activation="identity")
         .graph_builder()
         .add_inputs("input")
         .set_input_types(input=InputType.convolutional(height, width,
                                                        channels)))

    def conv(name, n_out, k, stride, src):
        b.add_layer(name, ConvolutionLayer(
            n_out=n_out, kernel_size=(k, k), stride=(stride, stride),
            convolution_mode="same", activation="identity"), src)
        return name

    def bn(name, src, relu):
        b.add_layer(name, BatchNormalization(
            activation="relu" if relu else "identity"), src)
        return name

    # stem: 7x7/2 conv + BN/relu + 3x3/2 max pool
    prev = bn("bn_conv1", conv("conv1", 64, 7, 2, "input"), relu=True)
    b.add_layer("pool1", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), prev)
    prev = "pool1"

    stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
              (3, 512, 2048, 2)]
    for si, (reps, mid, out_ch, first_stride) in enumerate(stages,
                                                           start=2):
        for ri in range(reps):
            n = f"s{si}b{ri + 1}"
            stride = first_stride if ri == 0 else 1
            x = bn(f"{n}_bn1", conv(f"{n}_c1", mid, 1, stride, prev),
                   relu=True)
            x = bn(f"{n}_bn2", conv(f"{n}_c2", mid, 3, 1, x), relu=True)
            x = bn(f"{n}_bn3", conv(f"{n}_c3", out_ch, 1, 1, x),
                   relu=False)
            if ri == 0:  # projection shortcut on the stage's first block
                shortcut = bn(f"{n}_bnp",
                              conv(f"{n}_proj", out_ch, 1, stride, prev),
                              relu=False)
            else:
                shortcut = prev
            b.add_vertex(f"{n}_add", ElementWiseVertex(op="add"), x,
                         shortcut)
            b.add_layer(f"{n}_out", ActivationLayer(activation="relu"),
                        f"{n}_add")
            prev = f"{n}_out"

    b.add_layer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), prev)
    b.add_layer("fc1000", OutputLayer(n_out=num_classes,
                                      activation="softmax",
                                      loss_function="mcxent"), "avg_pool")
    b.set_outputs("fc1000")
    return b.build()

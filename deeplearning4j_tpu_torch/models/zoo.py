"""Reference model configs (port of deeplearning4j_tpu/models/zoo.py).

`lenet_mnist` (the LeNet-MNIST headline workload), `char_rnn_lstm` (the
GravesLSTM char-RNN, BASELINE config 3), `mlp_mnist` and `text_cnn`; all
pure configuration. VGG16 is `modelimport.trained_models.vgg16`.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (Convolution1DLayer,
                                                ConvolutionLayer, DenseLayer,
                                                GlobalPoolingLayer,
                                                GravesLSTM, OutputLayer,
                                                RnnOutputLayer,
                                                SubsamplingLayer)


def lenet_mnist(seed: int = 12345, learning_rate: float = 0.01,
                updater: str = "nesterovs", dtype: str = "float32"):
    """LeNet: conv5x5x20 -> maxpool -> conv5x5x50 -> maxpool -> dense500 ->
    softmax10 (the classic DL4J LenetMnistExample topology)."""
    return (NeuralNetConfiguration(seed=seed, updater=updater,
                                   learning_rate=learning_rate,
                                   momentum=0.9, weight_init="xavier",
                                   dtype=dtype)
            .list(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                   stride=(1, 1), activation="identity"),
                  SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                   pooling_type="max"),
                  ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                   stride=(1, 1), activation="identity"),
                  SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                   pooling_type="max"),
                  DenseLayer(n_out=500, activation="relu"),
                  OutputLayer(n_out=10, activation="softmax",
                              loss_function="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1)))


def char_rnn_lstm(vocab_size: int, hidden: int = 200, layers: int = 2,
                  tbptt_length: int = 50, seed: int = 12345,
                  learning_rate: float = 0.1, dtype: str = "float32"):
    """Character-level LSTM language model — the reference's GravesLSTM
    char-RNN (stacked GravesLSTMs + RnnOutputLayer, RMSProp, truncated
    BPTT)."""
    stack = [GravesLSTM(n_out=hidden, activation="tanh")
             for _ in range(layers)]
    conf = (NeuralNetConfiguration(seed=seed, updater="rmsprop",
                                   learning_rate=learning_rate,
                                   weight_init="xavier", dtype=dtype)
            .list(*stack,
                  RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(InputType.recurrent(vocab_size)))
    conf.backprop_type_tbptt(tbptt_length, tbptt_length)
    return conf


def mlp_mnist(seed: int = 12345, learning_rate: float = 0.006,
              hidden: int = 1000, dtype: str = "float32"):
    """Single-hidden-layer MLP (the reference's MLPMnistSingleLayerExample
    topology)."""
    return (NeuralNetConfiguration(seed=seed, updater="nesterovs",
                                   learning_rate=learning_rate,
                                   momentum=0.9, weight_init="xavier",
                                   dtype=dtype)
            .list(DenseLayer(n_in=784, n_out=hidden, activation="relu"),
                  OutputLayer(n_out=10, activation="softmax",
                              loss_function="negativeloglikelihood")))


def text_cnn(embedding_dim: int, num_classes: int,
             max_sentence_length: int = 64, filters: int = 100,
             kernel_size: int = 3, seed: int = 12345,
             learning_rate: float = 1e-3,
             dtype: str = "float32") -> MultiLayerConfiguration:
    """Kim-2014-style sentence classifier over word-vector inputs
    [B, T, D]: Conv1D -> global max pool -> softmax."""
    return (NeuralNetConfiguration(
        seed=seed, updater="adam", learning_rate=learning_rate,
        dtype=dtype,
    ).list(
        Convolution1DLayer(n_in=embedding_dim, n_out=filters,
                           kernel_size=kernel_size,
                           convolution_mode="same", activation="relu"),
        GlobalPoolingLayer(pooling_type="max"),
        OutputLayer(n_in=filters, n_out=num_classes,
                    activation="softmax", loss_function="mcxent"),
    ).set_input_type(InputType.recurrent(embedding_dim,
                                         max_sentence_length)))

"""Reference model configs (port of deeplearning4j_tpu/models/zoo.py).

`char_rnn_lstm` (the GravesLSTM char-RNN, BASELINE config 3) and
`mlp_mnist`; both are pure configuration. LeNet, VGG and the text CNN
wait for their layers (ROADMAP queue A9).
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.configuration import (
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import (DenseLayer, GravesLSTM,
                                                OutputLayer, RnnOutputLayer)


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

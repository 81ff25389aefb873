"""Output and loss layers (port of deeplearning4j_tpu/nn/layers/output.py).

An output layer is a dense layer + loss function; its loss is the scalar
objective of the train step and autograd gives the error signal.
`OutputLayer` and `RnnOutputLayer` are ported. `LossLayer` and
`CenterLossOutputLayer` keep their names and fields (configurations
that name them still read back) but raise NotImplementedError when
built, until a later slice (ROADMAP queue A9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
from deeplearning4j_tpu_torch.nn.lossfunctions import get_loss

Tensor = torch.Tensor

_LATER = ("{} is not ported yet (ROADMAP queue A9, nn/layers/output.py); "
          "the char-RNN slice ports OutputLayer and RnnOutputLayer")


@register
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss. Default activation softmax / loss MCXENT, matching the
    reference's defaults."""
    loss_function: str = "mcxent"

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        z = self.pre_output(params, x)
        return get_activation(self.activation or "softmax")(z), state

    def loss(self, params, x, labels, mask=None):
        z = self.pre_output(params, x)
        fn = get_loss(self.loss_function)
        return fn(labels, z, self.activation or "softmax", mask)


@register
@dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output over [B, T, F] sequences (operating on the
    trailing axis makes the reference's 2-D reshape a no-op)."""

    @property
    def family(self) -> str:
        return "rnn"

    @property
    def input_family(self) -> str:
        return "rnn"

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeRecurrent):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.recurrent(self.n_out,
                                          input_type.time_series_length)
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.recurrent(self.n_out)
        raise ValueError(f"RnnOutputLayer cannot take input {input_type}")


@register
@dataclass
class LossLayer(BaseLayer):
    """Loss without parameters — not ported yet."""
    loss_function: str = "mcxent"

    def __post_init__(self):
        raise NotImplementedError(_LATER.format("LossLayer"))


@register
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Output layer with an auxiliary center-loss term — not ported yet."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def __post_init__(self):
        raise NotImplementedError(_LATER.format("CenterLossOutputLayer"))

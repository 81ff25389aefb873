"""Output and loss layers (port of deeplearning4j_tpu/nn/layers/output.py).

An output layer is a dense layer + loss function; its loss is the scalar
objective of the train step and autograd gives the error signal.
`LossLayer` is the loss alone, on its input. `CenterLossOutputLayer`'s
per-class centers live in the layer's state tree (``{"centers": [n_out,
n_in]}``), moved toward the batch's feature means after each training
step, as in JAX.
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
    """Loss without parameters: the activation and the loss on the
    layer's input."""
    loss_function: str = "mcxent"

    def update_input_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        return get_activation(self.activation or "softmax")(x), state

    def weight_param_keys(self):
        return ()

    def loss(self, params, x, labels, mask=None):
        fn = get_loss(self.loss_function)
        return fn(labels, x, self.activation or "softmax", mask)


@register
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Output layer with an auxiliary center loss pulling features toward
    per-class centers. The centers are non-trainable state, moved with
    rate ``alpha`` toward the batch's feature means; the squared distance
    joins the loss scaled by ``lambda_ / 2``."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def init_state(self, dtype=torch.float32, device=None
                   ) -> Dict[str, Tensor]:
        return {"centers": torch.zeros((self.n_out, self.n_in),
                                       dtype=dtype, device=device)}

    def loss(self, params, x, labels, mask=None, state=None):
        base = super().loss(params, x, labels, mask)
        if state is None:
            return base
        assigned = torch.matmul(labels.to(x.dtype), state["centers"])
        center_l = ((x - assigned) ** 2).sum(-1).mean()
        return base + 0.5 * self.lambda_ * center_l

    def update_centers(self, state, x, labels):
        centers = state["centers"]
        x = x.detach()
        labels = labels.to(x.dtype)
        counts = labels.sum(0)                            # [n_out]
        means = torch.matmul(labels.T, x) / torch.clamp(counts[:, None],
                                                        min=1.0)
        new = torch.where((counts > 0)[:, None],
                          centers + self.alpha * (means - centers), centers)
        return {**state, "centers": new}

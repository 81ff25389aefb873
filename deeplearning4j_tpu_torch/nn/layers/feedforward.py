"""Feed-forward layers (port of deeplearning4j_tpu/nn/layers/feedforward.py).

`DenseLayer` (which `OutputLayer` extends) and `EmbeddingLayer`;
`AutoEncoder` comes with layerwise pretraining (ROADMAP queue A, item
12b). The dense forward is a matmul on the trailing axis, so it also
runs timestep-wise on [B, T, F] sequences.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer
from deeplearning4j_tpu_torch.nn.weights import init_weights

Tensor = torch.Tensor


@register
@dataclass
class DenseLayer(BaseLayer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        if isinstance(input_type, it.InputTypeRecurrent):
            # dense applied per-timestep
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.recurrent(self.n_out,
                                          input_type.time_series_length)
        raise ValueError(f"{type(self).__name__} cannot take input "
                         f"{input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         self.weight_init or "xavier", self.dist, dtype,
                         device)
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        z = self.pre_output(params, x)
        return get_activation(self.activation or "sigmoid")(z), state

    def pre_output(self, params, x):
        return torch.matmul(x, params["W"]) + params["b"]


@register
@dataclass
class EmbeddingLayer(BaseLayer):
    """Index -> vector lookup: integer indices [B] or [B, 1] gather rows
    of W; a one-hot float input [B, n_in] multiplies W (the same
    function)."""
    n_in: Optional[int] = None   # vocabulary size
    n_out: Optional[int] = None  # embedding dim

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        raise ValueError(f"EmbeddingLayer cannot take input {input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        return DenseLayer.init_params(self, gen, dtype, device)

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        if x.is_floating_point() and x.ndim >= 2 \
                and x.shape[-1] == self.n_in:
            z = torch.matmul(x, params["W"]) + params["b"]
        else:
            idx = x.long()
            if idx.ndim >= 2 and idx.shape[-1] == 1:
                idx = idx[..., 0]
            z = params["W"][idx] + params["b"]
        return get_activation(self.activation or "identity")(z), state

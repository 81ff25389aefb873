"""Normalization layers: BatchNormalization, LocalResponseNormalization
(port of deeplearning4j_tpu/nn/layers/normalization.py).

Batch norm's running statistics live in the layer's **state** tree
(``{"mean", "var"}``), updated as ``decay * old + (1 - decay) * batch``
over the **biased** batch variance, by hand: `F.batch_norm`'s running
update uses the unbiased variance and ``momentum = 1 - decay``. LRN is
``x / (k + alpha * sum)^beta`` with ``sum`` over a window of n channels
padded (n//2, n//2); `F.local_response_norm` divides alpha by n, so it
is not used.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, Layer

Tensor = torch.Tensor


@register
@dataclass
class BatchNormalization(BaseLayer):
    """Batch norm over the trailing (feature / channel) axis: [B, F]
    dense, [B, T, F] and [B, H, W, C] activations alike. ``decay`` is the
    moving-average decay, ``eps`` the epsilon; ``lock_gamma_beta`` fixes
    scale and shift at ``gamma`` / ``beta`` and has no parameters."""
    n_out: Optional[int] = None
    decay: float = 0.9
    eps: float = 1e-5
    gamma: float = 1.0
    beta: float = 0.0
    lock_gamma_beta: bool = False
    _family: str = "ff"

    @property
    def family(self) -> str:
        return self._family

    @property
    def input_family(self) -> str:
        # normalizes whatever family arrives: no preprocessor before it
        return "any"

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeConvolutional):
            self.n_out = input_type.channels
            self._family = "cnn"
        elif isinstance(input_type, it.InputTypeFeedForward):
            self.n_out = input_type.size
            self._family = "ff"
        elif isinstance(input_type, it.InputTypeRecurrent):
            self.n_out = input_type.size
            self._family = "rnn"
        else:
            raise ValueError(f"BatchNormalization cannot take {input_type}")
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_out,), float(self.gamma),
                                    dtype=dtype, device=device),
                "beta": torch.full((self.n_out,), float(self.beta),
                                   dtype=dtype, device=device)}

    def init_state(self, dtype=torch.float32, device=None
                   ) -> Dict[str, Tensor]:
        return {"mean": torch.zeros((self.n_out,), dtype=dtype,
                                    device=device),
                "var": torch.ones((self.n_out,), dtype=dtype,
                                  device=device)}

    def weight_param_keys(self):
        return ()

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        axes = tuple(range(x.ndim - 1))
        if train:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            d = self.decay
            new_state = {"mean": (d * state["mean"]
                                  + (1 - d) * mean).detach(),
                         "var": (d * state["var"]
                                 + (1 - d) * var).detach()}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xhat = (x - mean) / torch.sqrt(var + self.eps)
        if self.lock_gamma_beta:
            y = self.gamma * xhat + self.beta
        else:
            y = params["gamma"] * xhat + params["beta"]
        if self.activation:
            y = get_activation(self.activation)(y)
        return y, new_state


@register
@dataclass
class LocalResponseNormalization(Layer):
    """Across-channel LRN: x / (k + alpha * sum(x^2))^beta over a window
    of n channels (AlexNet's)."""
    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75

    @property
    def family(self) -> str:
        return "cnn"

    def weight_param_keys(self):
        return ()

    def update_input_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        n = int(self.n)
        half = n // 2
        sq = F.pad(x * x, (half, half))              # the channel axis
        summed = sq.unfold(-1, n, 1).sum(-1)
        denom = (self.k + self.alpha * summed) ** self.beta
        return x / denom, state

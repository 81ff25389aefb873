"""Utility layers: ActivationLayer, DropoutLayer, GlobalPoolingLayer and
the FrozenLayer wrapper (port of deeplearning4j_tpu/nn/layers/misc.py).

Dropout is the port's `apply_dropout`, keyed by the integer seed the
network folds per layer (`nn.layers.base.fold_in`): the same seed drops
the same units on the CPU and on the card, though not the units
`jax.random` drops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import Layer, apply_dropout

Tensor = torch.Tensor


def _family_of(input_type) -> str:
    if isinstance(input_type, it.InputTypeConvolutional):
        return "cnn"
    if isinstance(input_type, it.InputTypeRecurrent):
        return "rnn"
    return "ff"


@register
@dataclass
class ActivationLayer(Layer):
    activation: str = "relu"
    _family: str = "ff"

    @property
    def family(self):
        return self._family

    @property
    def input_family(self):
        # elementwise: whatever family arrives, no preprocessor
        return "any"

    def weight_param_keys(self):
        return ()

    def update_input_type(self, input_type):
        self._family = _family_of(input_type)
        return input_type

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        return get_activation(self.activation)(x), state


@register
@dataclass
class DropoutLayer(Layer):
    """Standalone dropout layer; ``rate`` is the drop probability."""
    rate: float = 0.5
    _family: str = "ff"

    @property
    def family(self):
        return self._family

    @property
    def input_family(self):
        return "any"

    def weight_param_keys(self):
        return ()

    def update_input_type(self, input_type):
        self._family = _family_of(input_type)
        return input_type

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        if train and self.rate > 0 and key is not None:
            x = apply_dropout(x, self.rate, key)
        return x, state


@register
@dataclass
class GlobalPoolingLayer(Layer):
    """Pool over time ([B, T, F] -> [B, F]) or space ([B, H, W, C] ->
    [B, C]): max | avg | sum | pnorm. A sequence mask leaves masked steps
    out of the reduction."""
    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True
    _in_family: str = "any"

    @property
    def family(self):
        return "ff"

    @property
    def input_family(self):
        return self._in_family

    def weight_param_keys(self):
        return ()

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeRecurrent):
            self._in_family = "rnn"
            return it.InputType.feed_forward(input_type.size)
        if isinstance(input_type, it.InputTypeConvolutional):
            self._in_family = "cnn"
            return it.InputType.feed_forward(input_type.channels)
        raise ValueError(f"GlobalPoolingLayer cannot take {input_type}")

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        if x.ndim == 3:
            axes = (1,)
        elif x.ndim == 4:
            axes = (1, 2)
        else:
            raise ValueError("GlobalPoolingLayer needs 3-D or 4-D input")
        ptype = self.pooling_type.lower()
        if mask is not None and x.ndim == 3:
            m = mask.to(x.dtype)[..., None]                  # [B, T, 1]
            if ptype == "max":
                neg = torch.finfo(x.dtype).min
                y = torch.where(m > 0, x, torch.full_like(x, neg)).amax(1)
            elif ptype in ("avg", "mean"):
                y = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
            elif ptype == "sum":
                y = (x * m).sum(1)
            elif ptype == "pnorm":
                p = float(self.pnorm)
                y = ((x.abs() * m) ** p).sum(1) ** (1.0 / p)
            else:
                raise ValueError(self.pooling_type)
            return y, state
        if ptype == "max":
            y = x.amax(dim=axes)
        elif ptype in ("avg", "mean"):
            y = x.mean(dim=axes)
        elif ptype == "sum":
            y = x.sum(dim=axes)
        elif ptype == "pnorm":
            p = float(self.pnorm)
            y = (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
        else:
            raise ValueError(self.pooling_type)
        return y, state


@register
@dataclass
class FrozenLayer(Layer):
    """Wrapper marking an inner layer's params as non-trainable: the
    updater's trainability mask leaves them as they are, and the inner
    layer runs in inference mode (batch-norm statistics stay put)."""
    inner: Optional[Layer] = None

    @property
    def family(self):
        return self.inner.family

    @property
    def input_family(self):
        return self.inner.input_family

    def update_input_type(self, input_type):
        return self.inner.update_input_type(input_type)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.inner.init_params(gen, dtype, device)

    def init_state(self, dtype=torch.float32, device=None):
        return self.inner.init_state(dtype, device)

    def weight_param_keys(self):
        return self.inner.weight_param_keys()

    def apply(self, params, state, x, *, train=False, key=None, mask=None):
        return self.inner.apply(params, state, x, train=False, key=key,
                                mask=mask)

"""Input preprocessors — shape adapters auto-inserted between layer families.

Port of deeplearning4j_tpu/nn/conf/preprocessors.py: the same classes,
registered under the same names, with torch reshapes.

Parity with the reference's `nn/conf/preprocessor/` (reference:
CnnToFeedForwardPreProcessor.java, FeedForwardToRnnPreProcessor.java,
RnnToCnnPreProcessor.java, etc. — 12 classes). In the reference each carries a
hand-written `preProcess` and `backprop`; here only the forward reshape is
needed (autodiff provides the backward).

Activations layouts: FF [B, F] — RNN [B, T, F] — CNN [B, H, W, C] (NHWC).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register

Array = torch.Tensor


def _require_cnn(input_type) -> None:
    if not isinstance(input_type, it.InputTypeConvolutional):
        raise ValueError(f"expected a convolutional input type, got "
                         f"{input_type}")


class InputPreProcessor:
    """Base: pre_process(x) and output_type(input_type)."""

    def pre_process(self, x: Array) -> Array:  # pragma: no cover - interface
        raise NotImplementedError

    def output_type(self, input_type):  # pragma: no cover - interface
        raise NotImplementedError


@register
@dataclass(frozen=True)
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x: Array) -> Array:
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type):
        _require_cnn(input_type)
        return it.InputType.feed_forward(input_type.flat_size)


@register
@dataclass(frozen=True)
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x: Array) -> Array:
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return it.InputType.convolutional(self.height, self.width,
                                          self.channels)


@register
@dataclass(frozen=True)
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """[B*T, F] or [B, F] -> [B, T, F]: in this framework dense layers operate
    on the trailing axis, so FF activations inside an RNN pipeline stay
    [B, T, F] and this preprocessor is an identity marker kept for config
    parity with the reference."""

    def pre_process(self, x: Array) -> Array:
        return x

    def output_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            return it.InputType.recurrent(input_type.size)
        return input_type


@register
@dataclass(frozen=True)
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """Marker inverse of FeedForwardToRnnPreProcessor (identity here)."""

    def pre_process(self, x: Array) -> Array:
        return x

    def output_type(self, input_type):
        if isinstance(input_type, it.InputTypeRecurrent):
            return it.InputType.feed_forward(input_type.size)
        return input_type


@register
@dataclass(frozen=True)
class CnnToRnnPreProcessor(InputPreProcessor):
    """[B, H, W, C] -> [B, T=H*W? no: T from caller]. The reference treats the
    conv output depth*h*w as the per-timestep feature when bridging CNN->RNN
    over video-like inputs; here we flatten spatial dims to features and add a
    length-1 time axis."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x: Array) -> Array:
        return x.reshape(x.shape[0], 1, -1)

    def output_type(self, input_type):
        _require_cnn(input_type)
        return it.InputType.recurrent(input_type.flat_size, 1)


@register
@dataclass(frozen=True)
class RnnToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x: Array) -> Array:
        b, t, f = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)

    def output_type(self, input_type):
        return it.InputType.convolutional(self.height, self.width,
                                          self.channels)


@register
@dataclass(frozen=True)
class CnnFlatToCnnPreProcessor(InputPreProcessor):
    """[B, h*w*c] (e.g. raw MNIST rows) -> [B, H, W, C]."""
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x: Array) -> Array:
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, input_type):
        return it.InputType.convolutional(self.height, self.width,
                                          self.channels)


def infer_preprocessor(from_type, to_family: str):
    """Auto-insert logic, mirroring the reference's
    `Layer.getPreProcessorForInputType` dispatch: given the producing layer's
    output InputType and the consuming layer family ('ff', 'cnn', 'rnn'),
    return a preprocessor or None."""
    if to_family == "ff":
        if isinstance(from_type, it.InputTypeConvolutional):
            return CnnToFeedForwardPreProcessor(from_type.height,
                                                from_type.width,
                                                from_type.channels)
        if isinstance(from_type, it.InputTypeConvolutionalFlat):
            return None  # already flat
        return None
    if to_family == "cnn":
        if isinstance(from_type, it.InputTypeConvolutionalFlat):
            return CnnFlatToCnnPreProcessor(from_type.height, from_type.width,
                                            from_type.channels)
        if isinstance(from_type, it.InputTypeFeedForward):
            return None  # requires explicit FeedForwardToCnnPreProcessor
        return None
    if to_family == "rnn":
        if isinstance(from_type, it.InputTypeFeedForward):
            return FeedForwardToRnnPreProcessor()
        if isinstance(from_type, it.InputTypeConvolutional):
            return CnnToRnnPreProcessor(from_type.height, from_type.width,
                                        from_type.channels)
        return None
    return None

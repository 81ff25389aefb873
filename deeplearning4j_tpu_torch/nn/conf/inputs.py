"""Input types — shape metadata propagated through a network configuration.

Parity with the reference's `InputType` (reference:
deeplearning4j-nn/.../nn/conf/inputs/InputType.java): feed-forward, recurrent,
convolutional, convolutional-flat. Used for nIn inference and automatic
preprocessor insertion. A copy of deeplearning4j_tpu/nn/conf/inputs.py
(it holds no JAX).

Convolutional activations are **NHWC** ([batch, height, width, channels]),
as in the JAX package, instead of the reference's NCHW. Keras import handles layout conversion at the border.
"""
from __future__ import annotations

from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.serde import register


class InputType:
    """Factory namespace, mirroring the reference's static methods."""

    @staticmethod
    def feed_forward(size: int) -> "InputTypeFeedForward":
        return InputTypeFeedForward(size=int(size))

    @staticmethod
    def recurrent(size: int, time_series_length: int = -1
                  ) -> "InputTypeRecurrent":
        return InputTypeRecurrent(size=int(size),
                                  time_series_length=int(time_series_length))

    @staticmethod
    def convolutional(height: int, width: int, channels: int
                      ) -> "InputTypeConvolutional":
        return InputTypeConvolutional(height=int(height), width=int(width),
                                      channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int
                           ) -> "InputTypeConvolutionalFlat":
        return InputTypeConvolutionalFlat(height=int(height),
                                          width=int(width),
                                          channels=int(channels))


@register
@dataclass(frozen=True)
class InputTypeFeedForward:
    size: int

    def array_shape(self, batch: int):
        return (batch, self.size)


@register
@dataclass(frozen=True)
class InputTypeRecurrent:
    """Sequence input. Activations are [batch, time, size] (time-major inside
    scan loops; batch-major at the API surface)."""
    size: int
    time_series_length: int = -1

    def array_shape(self, batch: int):
        t = self.time_series_length if self.time_series_length > 0 else 1
        return (batch, t, self.size)


@register
@dataclass(frozen=True)
class InputTypeConvolutional:
    """Image input, NHWC activations."""
    height: int
    width: int
    channels: int

    def array_shape(self, batch: int):
        return (batch, self.height, self.width, self.channels)

    @property
    def flat_size(self) -> int:
        return self.height * self.width * self.channels


@register
@dataclass(frozen=True)
class InputTypeConvolutionalFlat:
    """Flattened image input [batch, h*w*c] (e.g. raw MNIST rows)."""
    height: int
    width: int
    channels: int

    @property
    def flat_size(self) -> int:
        return self.height * self.width * self.channels

    def array_shape(self, batch: int):
        return (batch, self.flat_size)

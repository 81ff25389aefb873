"""Convolution and pooling layers (port of
deeplearning4j_tpu/nn/layers/convolution.py).

Activations stay NHWC ([B, H, W, C]; [B, T, C] for the 1-D layers) at
the API and in the flatten order, and kernels stay HWIO ([K, I, O] in
1-D) in the parameter tree, so a JAX network's weights carry across by
key path. At the call an NHWC tensor is viewed as NCHW (a permute, no
copy: the memory is channels-last, which cuDNN takes as it is) and the
kernel is permuted to OIHW; convolution and pooling are `F.conv2d` /
`F.conv1d` / the pooling functions, as JAX computes them in XLA.

Padding follows XLA's rules exactly. 'same' pads the total
``max((out - 1) * s + k_eff - in, 0)`` with the low side ``total // 2``
(asymmetric when the total is odd, which torch's ``padding="same"``
does not do and refuses at stride > 1); an odd total goes through an
explicit `F.pad`. Pooling pads with the reduction's identity (``-inf``
for max, 0 for the sums), then pools with no padding of its own, so avg
pooling divides every window by ``kh * kw``, padded cells included, and
pnorm pooling is ``sum(|x|^p)^(1/p)`` (not `F.lp_pool2d`, which takes no
abs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, Layer
from deeplearning4j_tpu_torch.nn.weights import init_weights

Tensor = torch.Tensor


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _one(v) -> int:
    return int(v) if isinstance(v, int) else int(v[0])


def conv_out_size(size: int, k: int, s: int, p: int, mode: str) -> int:
    """Output spatial size. 'same' keeps ceil(size/stride);
    'strict'/'truncate' use (size - k + 2p)/s + 1, and 'strict' raises
    unless that division is exact."""
    if mode == "same":
        return -(-size // s)
    if mode == "strict" and (size - k + 2 * p) % s != 0:
        raise ValueError(
            f"ConvolutionMode.Strict: (size={size} - k={k} + 2*p={p}) not "
            f"divisible by stride {s}")
    return (size - k + 2 * p) // s + 1


def same_pads(size: int, k_eff: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (low, high), low = total // 2."""
    out = -(-size // s)
    total = max((out - 1) * s + k_eff - size, 0)
    return total // 2, total - total // 2


def _pads(mode: str, sizes, ks, ss, ps):
    """Per-axis (low, high) pads for XLA's padding rule."""
    if mode == "same":
        return [same_pads(n, k, s) for n, k, s in zip(sizes, ks, ss)]
    return [(p, p) for p in ps]


def _pad_arg(pads):
    """F.pad's argument (last axis first) for [..., *spatial] tensors."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


def _conv(x_cf: Tensor, w: Tensor, b: Tensor, pads, stride, dilation,
          conv) -> Tensor:
    """``conv`` (F.conv1d / F.conv2d) of a channels-first view with XLA's
    (low, high) pads: symmetric pads go to the convolution itself, an
    asymmetric one through F.pad first."""
    if all(lo == hi for lo, hi in pads):
        return conv(x_cf, w, b, stride=stride,
                    padding=tuple(lo for lo, _ in pads), dilation=dilation)
    x_cf = F.pad(x_cf, _pad_arg(pads))
    return conv(x_cf, w, b, stride=stride, padding=0, dilation=dilation)


def _pool(x_cf: Tensor, ptype: str, ks, ss, pads, pnorm: int) -> Tensor:
    """reduce_window's max | avg | pnorm over a channels-first view,
    padded with the reduction's identity."""
    ptype = ptype.lower()
    two_d = len(ks) == 2
    pad = _pad_arg(pads)
    kn = 1
    for k in ks:
        kn *= k
    if ptype == "max":
        if any(pad):
            x_cf = F.pad(x_cf, pad, value=float("-inf"))
        pool = F.max_pool2d if two_d else F.max_pool1d
        return pool(x_cf, ks, ss)
    if ptype in ("avg", "mean", "pnorm"):
        p = float(pnorm)
        src = x_cf if ptype != "pnorm" else x_cf.abs() ** p
        if any(pad):
            src = F.pad(src, pad)
        if two_d:
            s = F.avg_pool2d(src, ks, ss, divisor_override=1)
        else:
            # avg_pool1d has no divisor override: a 2-D pool of width 1
            s = F.avg_pool2d(src[..., None], (ks[0], 1), (ss[0], 1),
                             divisor_override=1)[..., 0]
        return s / kn if ptype != "pnorm" else s ** (1.0 / p)
    raise ValueError(f"Unknown pooling type '{ptype}'")


@register
@dataclass
class ConvolutionLayer(BaseLayer):
    """2-D convolution, NHWC activations, HWIO kernel."""
    n_in: Optional[int] = None   # input channels
    n_out: Optional[int] = None  # output channels
    kernel_size: Sequence[int] = (5, 5)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = "truncate"  # 'strict' | 'truncate' | 'same'
    dilation: Sequence[int] = (1, 1)

    @property
    def family(self) -> str:
        return "cnn"

    def _effective_kernel(self) -> Tuple[int, int]:
        """k + (k - 1)(d - 1) under dilation."""
        kh, kw = _pair(self.kernel_size)
        dh, dw = _pair(self.dilation)
        return kh + (kh - 1) * (dh - 1), kw + (kw - 1) * (dw - 1)

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeConvolutional):
            raise ValueError(f"ConvolutionLayer needs convolutional input, "
                             f"got {input_type}")
        if self.n_in is None:
            self.n_in = input_type.channels
        ekh, ekw = self._effective_kernel()
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = conv_out_size(input_type.height, ekh, sh, ph,
                           self.convolution_mode)
        ow = conv_out_size(input_type.width, ekw, sw, pw,
                           self.convolution_mode)
        return it.InputType.convolutional(oh, ow, self.n_out)

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        kh, kw = _pair(self.kernel_size)
        w = init_weights(gen, (kh, kw, self.n_in, self.n_out),
                         self.n_in * kh * kw, self.n_out * kh * kw,
                         self.weight_init or "xavier", self.dist, dtype,
                         device)
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        w = params["W"].to(x.dtype).permute(3, 2, 0, 1)      # OIHW
        pads = _pads(self.convolution_mode, x.shape[1:3],
                     self._effective_kernel(), _pair(self.stride),
                     _pair(self.padding))
        z = _conv(x.permute(0, 3, 1, 2), w, params["b"].to(x.dtype), pads,
                  _pair(self.stride), _pair(self.dilation), F.conv2d)
        z = z.permute(0, 2, 3, 1)
        return get_activation(self.activation or "identity")(z), state


@register
@dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-D convolution over [B, T, C] sequences."""

    @property
    def family(self) -> str:
        return "rnn"

    @property
    def input_family(self) -> str:
        return "rnn"

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeRecurrent):
            raise ValueError("Convolution1DLayer needs recurrent input")
        if self.n_in is None:
            self.n_in = input_type.size
        t = input_type.time_series_length
        ot = conv_out_size(t, _one(self.kernel_size), _one(self.stride),
                           _one(self.padding), self.convolution_mode) \
            if t > 0 else -1
        return it.InputType.recurrent(self.n_out, ot)

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        k = _one(self.kernel_size)
        w = init_weights(gen, (k, self.n_in, self.n_out), self.n_in * k,
                         self.n_out * k, self.weight_init or "xavier",
                         self.dist, dtype, device)
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        k, s = _one(self.kernel_size), _one(self.stride)
        pads = _pads(self.convolution_mode, x.shape[1:2], (k,), (s,),
                     (_one(self.padding),))
        w = params["W"].to(x.dtype).permute(2, 1, 0)          # OIK
        z = _conv(x.transpose(1, 2), w, params["b"].to(x.dtype), pads,
                  (s,), (1,), F.conv1d)
        z = z.transpose(1, 2)
        return get_activation(self.activation or "identity")(z), state


@register
@dataclass
class SubsamplingLayer(Layer):
    """2-D pooling: max | avg | pnorm."""
    pooling_type: str = "max"
    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    @property
    def family(self) -> str:
        return "cnn"

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeConvolutional):
            raise ValueError("SubsamplingLayer needs convolutional input")
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = conv_out_size(input_type.height, kh, sh, ph,
                           self.convolution_mode)
        ow = conv_out_size(input_type.width, kw, sw, pw,
                           self.convolution_mode)
        return it.InputType.convolutional(oh, ow, input_type.channels)

    def weight_param_keys(self):
        return ()

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        ks, ss = _pair(self.kernel_size), _pair(self.stride)
        pads = _pads(self.convolution_mode, x.shape[1:3], ks, ss,
                     _pair(self.padding))
        y = _pool(x.permute(0, 3, 1, 2), self.pooling_type, ks, ss, pads,
                  self.pnorm)
        return y.permute(0, 2, 3, 1), state


@register
@dataclass
class Subsampling1DLayer(SubsamplingLayer):
    """1-D pooling over [B, T, C]."""

    @property
    def family(self) -> str:
        return "rnn"

    @property
    def input_family(self) -> str:
        return "rnn"

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeRecurrent):
            raise ValueError("Subsampling1DLayer needs recurrent input")
        t = input_type.time_series_length
        ot = conv_out_size(t, _one(self.kernel_size), _one(self.stride),
                           _one(self.padding), self.convolution_mode) \
            if t > 0 else -1
        return it.InputType.recurrent(input_type.size, ot)

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        k, s = _one(self.kernel_size), _one(self.stride)
        pads = _pads(self.convolution_mode, x.shape[1:2], (k,), (s,),
                     (_one(self.padding),))
        y = _pool(x.transpose(1, 2), self.pooling_type, (k,), (s,), pads,
                  self.pnorm)
        return y.transpose(1, 2), state


@register
@dataclass
class ZeroPaddingLayer(Layer):
    """Spatial zero padding: (ph, pw) or (top, bottom, left, right)."""
    padding: Sequence[int] = (1, 1)

    @property
    def family(self) -> str:
        return "cnn"

    def weight_param_keys(self):
        return ()

    def _pads(self):
        p = self.padding
        if len(p) == 2:
            return (p[0], p[0], p[1], p[1])
        return tuple(p)

    def update_input_type(self, input_type):
        if not isinstance(input_type, it.InputTypeConvolutional):
            raise ValueError("ZeroPaddingLayer needs convolutional input")
        t, b, l, r = self._pads()
        return it.InputType.convolutional(input_type.height + t + b,
                                          input_type.width + l + r,
                                          input_type.channels)

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b)), state

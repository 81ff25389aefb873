"""Layer base classes (port of deeplearning4j_tpu/nn/layers/base.py).

A layer is one dataclass that serializes to JSON, initializes its
parameter dict and defines the forward::

    y, new_state = layer.apply(params, state, x, train=..., key=..., mask=...)

``params`` is ``{name: tensor}``; autograd replaces a hand-written
backward. ``key`` is an integer seed (the JAX package's PRNG key): a
layer that needs random bits hashes it with each element's index
(`apply_dropout`), so a run is a function of its seeds alone, the same
on the CPU and on the card. ``mask`` is
an optional [B] or [B, T] {0,1} tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1


def fold_in(key: int, data: int) -> int:
    """A new 63-bit seed from ``key`` and ``data`` (the role of
    `jax.random.fold_in`): splitmix64 of their mix, so nearby keys and
    indices give unrelated streams."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


@dataclass
class Layer:
    """Base config for every layer type.

    Fields with ``None`` defaults inherit the global value from
    `NeuralNetConfiguration` when the layer is added to a network."""
    name: Optional[str] = None
    dropout: Optional[float] = None  # drop prob applied to layer INPUT
    l1: Optional[float] = None
    l2: Optional[float] = None
    learning_rate: Optional[float] = None  # per-layer LR override
    bias_learning_rate: Optional[float] = None

    # -- family / shape inference ------------------------------------------
    @property
    def family(self) -> str:
        """Output activation family: 'ff' | 'cnn' | 'rnn'."""
        return "ff"

    @property
    def input_family(self) -> str:
        """Expected input family (for auto preprocessor insertion)."""
        return self.family

    def update_input_type(self, input_type):
        """Resolve nIn from ``input_type`` (mutating) and return this
        layer's output InputType."""
        return input_type

    # -- params / state -----------------------------------------------------
    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Dict[str, Tensor]:
        return {}

    def init_state(self, dtype=torch.float32, device=None
                   ) -> Dict[str, Tensor]:
        return {}

    def weight_param_keys(self) -> Tuple[str, ...]:
        """Parameter names subject to l1/l2 regularization (weights, not
        biases)."""
        return ("W",)

    # -- forward ------------------------------------------------------------
    def apply(self, params: Dict[str, Tensor], state: Dict[str, Tensor],
              x: Tensor, *, train: bool = False, key: Optional[int] = None,
              mask: Optional[Tensor] = None
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
        return x, state

    def is_pretrain_layer(self) -> bool:
        return False

    def draw(self, kind: str, key: int, shape, device) -> Tensor:
        """Every random draw of layerwise pretraining (corruption, Gibbs
        samples, the VAE's eps): float32 ``"uniform"`` [0, 1) or
        ``"normal"`` values, a function of (key, shape) alone, the same
        on the CPU and on the card."""
        if kind == "uniform":
            return uniform_from_seed(shape, key, device)
        if kind == "normal":
            return normal_from_seed(shape, key, device)
        raise ValueError(f"unknown draw kind {kind!r}")


@dataclass
class BaseLayer(Layer):
    """Base for layers with weights + activation."""
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[dict] = None
    bias_init: float = 0.0


def _fmix32(h: Tensor) -> Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding 32-bit values
    (products wrap, and the mask keeps their low 32 bits)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)



def uniform_from_seed(shape, seed: int, device) -> Tensor:
    """Uniform [0, 1) float32 values, a function of (seed, element index)
    alone: a counter-based hash, so the same seed gives the same values
    on the CPU and on the card."""
    n = 1
    for d in shape:
        n *= int(d)
    s = fold_in(seed, 0)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = _fmix32(((idx * 0x9E3779B1) & _M32) ^ (s & _M32))
    h = _fmix32(h ^ ((s >> 32) & _M32))
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)


def normal_from_seed(shape, seed: int, device) -> Tensor:
    """Standard normal float32 values, a function of (seed, element
    index) alone: Box-Muller over two `uniform_from_seed` streams,
    computed in float64 and rounded once, so the CPU and the card agree
    bit for bit."""
    u1 = 1.0 - uniform_from_seed(shape, fold_in(seed, 1), device).double()
    u2 = uniform_from_seed(shape, fold_in(seed, 2), device).double()
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.to(torch.float32)


def apply_dropout(x: Tensor, rate: float, key: int) -> Tensor:
    """Inverted dropout on a layer's input; ``rate`` is the drop
    probability, ``key`` an integer seed: the units dropped are a
    function of the seed alone, the same on every device."""
    keep = 1.0 - rate
    bits = uniform_from_seed(x.shape, key, x.device) < keep
    return torch.where(bits, x / keep, torch.zeros_like(x)).to(x.dtype)

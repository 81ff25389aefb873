"""Activation functions (port of deeplearning4j_tpu/nn/activations.py).

The same names and formulas as the JAX package, each a one-line torch
function; `get_activation` resolves a name (or passes a callable through)
and raises with the list of valid names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def identity(x: Tensor) -> Tensor:
    return x


def sigmoid(x: Tensor) -> Tensor:
    return torch.sigmoid(x)


def tanh(x: Tensor) -> Tensor:
    return torch.tanh(x)


def relu(x: Tensor) -> Tensor:
    return torch.relu(x)


def leakyrelu(x: Tensor, alpha: float = 0.01) -> Tensor:
    return F.leaky_relu(x, negative_slope=alpha)


def elu(x: Tensor, alpha: float = 1.0) -> Tensor:
    return F.elu(x, alpha=alpha)


def selu(x: Tensor) -> Tensor:
    return F.selu(x)


def softplus(x: Tensor) -> Tensor:
    return F.softplus(x)


def softsign(x: Tensor) -> Tensor:
    return F.softsign(x)


def softmax(x: Tensor) -> Tensor:
    return torch.softmax(x, dim=-1)


def hardtanh(x: Tensor) -> Tensor:
    return torch.clamp(x, -1.0, 1.0)


def hardsigmoid(x: Tensor) -> Tensor:
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def cube(x: Tensor) -> Tensor:
    return x * x * x


def rationaltanh(x: Tensor) -> Tensor:
    # 1.7159 * tanh(2x/3) approximation via rational function, as in ND4J.
    a = torch.abs(2.0 * x / 3.0)
    rational = 1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a ** 4)
    return 1.7159 * torch.sign(x) * rational


def rectifiedtanh(x: Tensor) -> Tensor:
    return torch.clamp_min(torch.tanh(x), 0.0)


def gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def swish(x: Tensor) -> Tensor:
    return F.silu(x)


ACTIVATIONS = {
    "identity": identity,
    "linear": identity,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "relu": relu,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "softplus": softplus,
    "softsign": softsign,
    "softmax": softmax,
    "hardtanh": hardtanh,
    "hardsigmoid": hardsigmoid,
    "cube": cube,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "gelu": gelu,
    "swish": swish,
}


def get_activation(name):
    """Resolve an activation by name (or pass a callable through)."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation '{name}'. Available: {sorted(ACTIVATIONS)}"
        )
    return ACTIVATIONS[key]

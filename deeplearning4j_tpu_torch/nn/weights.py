"""Weight initialization schemes (port of deeplearning4j_tpu/nn/weights.py).

The same schemes and fan rules as the JAX package. Random draws come
from an explicit `torch.Generator` on the CPU, in float32, then move to
``device`` and ``dtype``: the same seed gives the same weights on the
card and on the CPU. The numbers differ from `jax.random`'s, so parity
with the JAX package goes through `models.convert`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _normal(gen, shape, std, mean=0.0):
    return mean + std * torch.randn(shape, generator=gen,
                                    dtype=torch.float32)


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return lo + (hi - lo) * u


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme: str = "xavier",
                 distribution: Optional[dict] = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Initialize a weight tensor. ``fan_in``/``fan_out`` are explicit, as
    in the reference's `WeightInitUtil.initWeights(fanIn, fanOut, ...)`."""
    scheme = str(scheme).lower()
    shape = tuple(int(s) for s in shape)
    if scheme == "zero":
        w = torch.zeros(shape)
    elif scheme == "ones":
        w = torch.ones(shape)
    elif scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-D shape")
        w = torch.eye(shape[0])
    elif scheme in ("xavier", "normal_avg"):
        w = _normal(gen, shape, math.sqrt(2.0 / (fan_in + fan_out)))
    elif scheme == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        w = _uniform(gen, shape, -a, a)
    elif scheme in ("xavier_fan_in", "normal_in"):
        w = _normal(gen, shape, math.sqrt(1.0 / fan_in))
    elif scheme == "xavier_legacy":
        w = _normal(gen, shape, math.sqrt(1.0 / (fan_in + fan_out)))
    elif scheme == "relu":
        w = _normal(gen, shape, math.sqrt(2.0 / fan_in))
    elif scheme == "relu_uniform":
        a = math.sqrt(6.0 / fan_in)
        w = _uniform(gen, shape, -a, a)
    elif scheme == "sigmoid_uniform":
        a = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        w = _uniform(gen, shape, -a, a)
    elif scheme == "uniform":
        # reference: U(-a, a) with a = 1/sqrt(fanIn)
        a = 1.0 / math.sqrt(fan_in)
        w = _uniform(gen, shape, -a, a)
    elif scheme == "normal_out":
        w = _normal(gen, shape, math.sqrt(1.0 / fan_out))
    elif scheme == "distribution":
        w = _sample_distribution(gen, shape, distribution or {})
    else:
        raise ValueError(f"Unknown weight init scheme '{scheme}'")
    return w.to(device=device, dtype=dtype)


def _sample_distribution(gen, shape, dist: dict) -> torch.Tensor:
    """Sample from a serialized distribution spec: normal/gaussian(mean,
    std), uniform(lower, upper), binomial(n, p)."""
    kind = str(dist.get("type", "normal")).lower()
    if kind in ("normal", "gaussian"):
        return _normal(gen, shape, float(dist.get("std", 1.0)),
                       float(dist.get("mean", 0.0)))
    if kind == "uniform":
        return _uniform(gen, shape, float(dist.get("lower", -1.0)),
                        float(dist.get("upper", 1.0)))
    if kind == "binomial":
        n = int(dist.get("n", 1))
        p = float(dist.get("p", 0.5))
        probs = torch.full(shape, p)
        return torch.binomial(torch.full(shape, float(n)), probs,
                              generator=gen)
    raise ValueError(f"Unknown distribution type '{kind}'")

"""Loss functions (port of deeplearning4j_tpu/nn/lossfunctions.py).

Parity with ND4J's `LossFunctions.LossFunction` enum consumed by the
reference's output layers (reference: deeplearning4j-nn/.../nn/conf/layers/
BaseOutputLayer.java `lossFunction` field). Each loss takes
``(labels, preout, activation_fn, mask)`` and returns the mean score over the
minibatch, matching the reference's per-example-then-average semantics.

All losses are written on *pre-output* + activation so that fused, numerically
stable forms (softmax-cross-entropy, sigmoid-cross-entropy) are used where the
activation/loss pair allows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation

Array = torch.Tensor

_EPS = 1e-7


def _apply_mask_and_mean(per_example: Array, mask: Optional[Array]) -> Array:
    """Average per-example scores, honoring an optional {0,1} mask.

    ``per_example`` has shape [batch] (already reduced over feature dims) or
    [batch, time] for sequence outputs; mask broadcasts against it.
    """
    if mask is None:
        return torch.mean(per_example)
    mask = mask.to(per_example.dtype)
    total = torch.sum(per_example * mask)
    count = torch.clamp_min(torch.sum(mask), 1.0)
    return total / count


def _activate(preout: Array, activation) -> Array:
    return get_activation(activation)(preout)


def mcxent(labels: Array, preout: Array, activation="softmax",
           mask: Optional[Array] = None) -> Array:
    """Multi-class cross entropy. With softmax activation uses the fused
    log-softmax form (stable); otherwise -sum(y*log(p))."""
    act = activation if isinstance(activation, str) else "custom"
    if act == "softmax":
        logp = torch.log_softmax(preout, dim=-1)
        per = -torch.sum(labels * logp, dim=-1)
    else:
        p = torch.clamp(_activate(preout, activation), _EPS, 1.0 - _EPS)
        per = -torch.sum(labels * torch.log(p), dim=-1)
    return _apply_mask_and_mean(per, mask)


def xent(labels: Array, preout: Array, activation="sigmoid",
         mask: Optional[Array] = None) -> Array:
    """Binary cross entropy (elementwise over possibly-multilabel outputs)."""
    act = activation if isinstance(activation, str) else "custom"
    if act == "sigmoid":
        # stable: max(x,0) - x*y + log(1+exp(-|x|))
        x = preout
        per = torch.sum(
            torch.clamp_min(x, 0.0) - x * labels
            + torch.log1p(torch.exp(-torch.abs(x))),
            dim=-1,
        )
    else:
        p = torch.clamp(_activate(preout, activation), _EPS, 1.0 - _EPS)
        per = -torch.sum(labels * torch.log(p)
                         + (1 - labels) * torch.log(1 - p), dim=-1)
    return _apply_mask_and_mean(per, mask)


def mse(labels: Array, preout: Array, activation="identity",
        mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.mean((labels - out) ** 2, dim=-1)
    return _apply_mask_and_mean(per, mask)


def l1(labels: Array, preout: Array, activation="identity",
       mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.sum(torch.abs(labels - out), dim=-1)
    return _apply_mask_and_mean(per, mask)


def l2(labels: Array, preout: Array, activation="identity",
       mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.sum((labels - out) ** 2, dim=-1)
    return _apply_mask_and_mean(per, mask)


def mae(labels: Array, preout: Array, activation="identity",
        mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.mean(torch.abs(labels - out), dim=-1)
    return _apply_mask_and_mean(per, mask)


def mape(labels: Array, preout: Array, activation="identity",
         mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.mean(
        100.0 * torch.abs((labels - out)
                          / torch.where(labels == 0, _EPS, labels)),
        dim=-1)
    return _apply_mask_and_mean(per, mask)


def msle(labels: Array, preout: Array, activation="identity",
         mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.mean(
        (torch.log1p(torch.clamp_min(labels, 0))
         - torch.log1p(torch.clamp_min(out, 0))) ** 2,
        dim=-1)
    return _apply_mask_and_mean(per, mask)


def kl_divergence(labels: Array, preout: Array, activation="softmax",
                  mask: Optional[Array] = None) -> Array:
    p = torch.clamp(_activate(preout, activation), _EPS, 1.0)
    y = torch.clamp(labels, _EPS, 1.0)
    per = torch.sum(y * (torch.log(y) - torch.log(p)), dim=-1)
    return _apply_mask_and_mean(per, mask)


def negativeloglikelihood(labels: Array, preout: Array, activation="softmax",
                          mask: Optional[Array] = None) -> Array:
    # In the reference NLL is MCXENT with softmax output (same math).
    return mcxent(labels, preout, activation, mask)


def poisson(labels: Array, preout: Array, activation="identity",
            mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    per = torch.sum(out - labels * torch.log(torch.clamp_min(out, _EPS)),
                    dim=-1)
    return _apply_mask_and_mean(per, mask)


def cosine_proximity(labels: Array, preout: Array, activation="identity",
                     mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    num = torch.sum(labels * out, dim=-1)
    denom = torch.linalg.norm(labels, dim=-1) * torch.linalg.norm(out, dim=-1)
    per = -num / torch.clamp_min(denom, _EPS)
    return _apply_mask_and_mean(per, mask)


def hinge(labels: Array, preout: Array, activation="identity",
          mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    y = 2.0 * labels - 1.0  # {0,1} -> {-1,1}
    per = torch.sum(torch.clamp_min(1.0 - y * out, 0.0), dim=-1)
    return _apply_mask_and_mean(per, mask)


def squared_hinge(labels: Array, preout: Array, activation="identity",
                  mask: Optional[Array] = None) -> Array:
    out = _activate(preout, activation)
    y = 2.0 * labels - 1.0
    per = torch.sum(torch.clamp_min(1.0 - y * out, 0.0) ** 2, dim=-1)
    return _apply_mask_and_mean(per, mask)


LOSS_FUNCTIONS: dict = {
    "mcxent": mcxent,
    "negativeloglikelihood": negativeloglikelihood,
    "xent": xent,
    "mse": mse,
    "squared_loss": l2,
    "l2": l2,
    "l1": l1,
    "mean_absolute_error": mae,
    "mae": mae,
    "mean_absolute_percentage_error": mape,
    "mape": mape,
    "mean_squared_logarithmic_error": msle,
    "msle": msle,
    "kl_divergence": kl_divergence,
    "reconstruction_crossentropy": xent,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
}


def get_loss(name) -> Callable:
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSS_FUNCTIONS:
        raise ValueError(f"Unknown loss '{name}'. Available: "
                         f"{sorted(LOSS_FUNCTIONS)}")
    return LOSS_FUNCTIONS[key]

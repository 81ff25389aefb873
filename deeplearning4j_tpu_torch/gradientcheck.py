"""Gradient check: central-difference numeric gradients vs autograd (port
of deeplearning4j_tpu/gradientcheck.py).

Checks that every layer's forward is correctly differentiable and the
loss / score wiring holds: ``(C(w + eps) - C(w - eps)) / 2 eps`` against
autograd's gradient of the network score with respect to the flat
parameter vector (`params_flat` order). Run a network built with
``TrainingConfig(dtype="float64")`` for eps = 1e-6 precision: a float64
network computes in float64 throughout on the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def check_gradients(net, x, y, *, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8,
                    max_params_to_check: Optional[int] = 256,
                    seed: int = 123, print_results: bool = False,
                    mask=None) -> bool:
    """True if every checked parameter passes. Checks a random subset of
    ``max_params_to_check`` parameters (None = all), chosen as JAX's is
    (numpy RandomState(seed))."""
    from deeplearning4j_tpu_torch.nn.multilayer import unravel_like
    if not net._initialized:
        net.init()
    x = net._tensor(x)
    y = net._tensor(y)
    mask = None if mask is None else net._tensor(mask)
    params, state = net.params, net.state
    flat = net.params_flat().detach()

    def score_fn(w):
        s, _ = net._loss_fn(unravel_like(params, w), state, x, y, None,
                            mask)
        return s

    w = flat.clone().requires_grad_(True)
    with torch.enable_grad():
        analytic, = torch.autograd.grad(score_fn(w), w)
    n = flat.shape[0]
    if max_params_to_check is not None and max_params_to_check < n:
        rng = np.random.RandomState(seed)
        idxs = np.sort(rng.choice(n, max_params_to_check, replace=False))
    else:
        idxs = np.arange(n)

    failures = 0
    max_rel_seen = 0.0
    with torch.no_grad():
        for i in idxs:
            orig = float(flat[i])
            plus = flat.clone()
            plus[i] = orig + epsilon
            minus = flat.clone()
            minus[i] = orig - epsilon
            numeric = (float(score_fn(plus)) - float(score_fn(minus))) \
                / (2 * epsilon)
            a = float(analytic[i])
            abs_err = abs(numeric - a)
            denom = max(abs(numeric), abs(a))
            rel = abs_err / denom if denom > 0 else 0.0
            max_rel_seen = max(max_rel_seen, rel if abs_err > min_abs_error
                               else 0.0)
            if rel > max_rel_error and abs_err > min_abs_error:
                failures += 1
                if print_results:
                    print(f"param {i}: analytic={a:.8g} "
                          f"numeric={numeric:.8g} rel={rel:.3g}")
    if print_results:
        print(f"checked {len(idxs)} params, {failures} failures, "
              f"max rel error {max_rel_seen:.3g}")
    return failures == 0

"""Updaters: per-parameter gradient transforms + LR schedules + gradient
normalization (port of deeplearning4j_tpu/train/updaters.py).

SGD, Nesterov momentum, AdaGrad, RMSProp, AdaDelta, Adam, AdaMax and
Nadam; the LearningRatePolicy schedules; the five GradientNormalization
modes. Updater state is a dict mirroring the params dict
(``{layer: {param: {slot: tensor}}}``), kept in at least float32
whatever the parameter dtype. `apply_updater` returns new params and new
state and leaves its inputs untouched, as the JAX function does; the
update math runs in at least float32 with the same operation order as
the JAX package, so float32 runs agree with it to rounding.

As in the JAX package, L1/L2 regularization enters the loss (autograd
gives the regularized gradient) and gradients are minibatch means.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.configuration import TrainingConfig

Tensor = torch.Tensor


def _f32(x: float) -> float:
    """x rounded to float32, as the JAX package's f32 scalars hold it."""
    return float(torch.tensor(x, dtype=torch.float32))


# ---------------------------------------------------------------------------
# learning-rate policies
# ---------------------------------------------------------------------------

def compute_learning_rate(tc: TrainingConfig, iteration) -> float:
    """lr(iteration) under the configured policy, rounded to float32 (the
    JAX package computes it as an f32 scalar)."""
    it = _f32(float(iteration))
    lr0 = tc.learning_rate
    policy = tc.lr_policy.lower()
    if policy in ("none", "", "score"):
        # 'score' decays on a plateau, a host-side decision
        # (apply_score_decay); inside the step it is the base LR
        return _f32(lr0)
    if policy == "exponential":
        return _f32(lr0 * math.pow(tc.lr_policy_decay_rate, it))
    if policy == "inverse":
        return _f32(lr0 / math.pow(1.0 + tc.lr_policy_decay_rate * it,
                                   tc.lr_policy_power))
    if policy in ("step", "torchstep"):
        return _f32(lr0 * math.pow(tc.lr_policy_decay_rate, math.floor(
            it / max(tc.lr_policy_steps, 1.0))))
    if policy == "poly":
        frac = min(max(it / max(float(tc.num_iterations), 1.0), 0.0), 1.0)
        return _f32(lr0 * math.pow(1.0 - frac, tc.lr_policy_power))
    if policy == "sigmoid":
        return _f32(lr0 / (1.0 + math.exp(-tc.lr_policy_decay_rate
                                          * (it - tc.lr_policy_steps))))
    if policy == "schedule":
        sched = tc.lr_schedule or {}
        # piecewise-constant: lr takes the value of the largest key <= iter
        lr = lr0
        for k in sorted(int(k) for k in sched):
            if it >= k:
                lr = sched[str(k)] if str(k) in sched else sched[k]
        return _f32(lr)
    raise ValueError(f"Unknown lr_policy '{tc.lr_policy}'")


# ---------------------------------------------------------------------------
# per-parameter updater transforms
# ---------------------------------------------------------------------------

def _state_dtype(p: Tensor) -> torch.dtype:
    return torch.promote_types(p.dtype, torch.float32)


def _init_leaf(updater: str, p: Tensor) -> Dict[str, Tensor]:
    def z():
        return torch.zeros(p.shape, dtype=_state_dtype(p), device=p.device)

    u = updater.lower()
    if u in ("sgd", "none"):
        return {}
    if u == "nesterovs":
        return {"v": z()}
    if u in ("adagrad", "rmsprop"):
        return {"h": z()}
    if u == "adadelta":
        return {"eg": z(), "ex": z()}
    if u in ("adam", "adamax", "nadam"):
        return {"m": z(), "v": z()}
    raise ValueError(f"Unknown updater '{updater}'")


def _update_leaf(updater: str, tc: TrainingConfig, g: Tensor,
                 s: Dict[str, Tensor], lr: float, t: float
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Returns (update, new_state); caller applies params -= update."""
    g = g.to(_state_dtype(g))
    u = updater.lower()
    if u == "none":
        return torch.zeros_like(g), s
    if u == "sgd":
        return lr * g, s
    if u == "nesterovs":
        # ND4J Nesterovs.getGradient: v' = mu*v - lr*g;
        # update = mu*v - (1+mu)*v'  (params -= update)
        mu = tc.momentum
        v_new = mu * s["v"] - lr * g
        upd = mu * s["v"] - (1.0 + mu) * v_new
        return upd, {"v": v_new}
    if u == "adagrad":
        h = s["h"] + g * g
        return lr * g / (torch.sqrt(h) + tc.epsilon), {"h": h}
    if u == "rmsprop":
        h = tc.rms_decay * s["h"] + (1.0 - tc.rms_decay) * g * g
        return lr * g / torch.sqrt(h + tc.epsilon), {"h": h}
    if u == "adadelta":
        rho, eps = tc.rho, tc.epsilon
        eg = rho * s["eg"] + (1 - rho) * g * g
        dx = torch.sqrt((s["ex"] + eps) / (eg + eps)) * g
        ex = rho * s["ex"] + (1 - rho) * dx * dx
        return dx, {"eg": eg, "ex": ex}
    if u in ("adam", "adamax", "nadam"):
        b1, b2, eps = tc.adam_mean_decay, tc.adam_var_decay, tc.epsilon
        c1 = _f32(1 - _f32(math.pow(_f32(b1), t)))
        m = b1 * s["m"] + (1 - b1) * g
        if u == "adamax":
            v = torch.maximum(b2 * s["v"], torch.abs(g))
            return lr * (m / c1) / (v + eps), {"m": m, "v": v}
        v = b2 * s["v"] + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / _f32(1 - _f32(math.pow(_f32(b2), t)))
        if u == "nadam":
            mbar = b1 * mhat + (1 - b1) * g / c1
            return lr * mbar / (torch.sqrt(vhat) + eps), {"m": m, "v": v}
        return lr * mhat / (torch.sqrt(vhat) + eps), {"m": m, "v": v}
    raise ValueError(f"Unknown updater '{updater}'")


# ---------------------------------------------------------------------------
# gradient normalization
# ---------------------------------------------------------------------------

def _normalize_layer_grads(mode: str, threshold: float,
                           layer_grads: Dict[str, Tensor]
                           ) -> Dict[str, Tensor]:
    mode = (mode or "none").lower()
    if mode in ("none", "") or not layer_grads:
        return layer_grads
    if mode == "renormalizel2perlayer":
        norm = torch.sqrt(sum(torch.sum(g * g)
                              for g in layer_grads.values()))
        scale = 1.0 / torch.clamp_min(norm, 1e-12)
        return {k: g * scale for k, g in layer_grads.items()}
    if mode == "renormalizel2perparamtype":
        return {k: g / torch.clamp_min(torch.sqrt(torch.sum(g * g)), 1e-12)
                for k, g in layer_grads.items()}
    if mode == "clipelementwiseabsolutevalue":
        return {k: torch.clamp(g, -threshold, threshold)
                for k, g in layer_grads.items()}
    if mode == "clipl2perlayer":
        norm = torch.sqrt(sum(torch.sum(g * g)
                              for g in layer_grads.values()))
        scale = torch.where(norm > threshold,
                            threshold / torch.clamp_min(norm, 1e-12),
                            torch.ones_like(norm))
        return {k: g * scale for k, g in layer_grads.items()}
    if mode == "clipl2perparamtype":
        out = {}
        for k, g in layer_grads.items():
            norm = torch.sqrt(torch.sum(g * g))
            scale = torch.where(norm > threshold,
                                threshold / torch.clamp_min(norm, 1e-12),
                                torch.ones_like(norm))
            out[k] = g * scale
        return out
    raise ValueError(f"Unknown gradient normalization '{mode}'")


# ---------------------------------------------------------------------------
# network-level entry points (operate on {layer_name: {param: tensor}})
# ---------------------------------------------------------------------------

def init_updater_state(tc: TrainingConfig,
                       params: Dict[str, Dict[str, Tensor]]
                       ) -> Dict[str, Any]:
    return {lname: {k: _init_leaf(tc.updater, p) for k, p in ptree.items()}
            for lname, ptree in params.items()}


@torch.no_grad()
def apply_updater(tc: TrainingConfig, params, grads, opt_state, iteration,
                  lr_multipliers: Optional[Dict[str, float]] = None,
                  trainable: Optional[Dict[str, bool]] = None):
    """One updater application over the whole network. Returns
    ``(new_params, new_opt_state)``. ``lr_multipliers`` maps layer name ->
    relative LR factor; ``trainable`` maps layer name -> bool (False =
    frozen)."""
    lr = compute_learning_rate(tc, iteration)
    t = float(iteration) + 1.0  # 1-based for bias correction
    sign = 1.0 if tc.minimize else -1.0
    new_params, new_state = {}, {}
    for lname, ptree in params.items():
        gtree = grads[lname]
        stree = opt_state.get(lname, {})
        if trainable is not None and not trainable.get(lname, True):
            new_params[lname] = ptree
            new_state[lname] = stree
            continue
        gtree = _normalize_layer_grads(tc.gradient_normalization,
                                       tc.gradient_normalization_threshold,
                                       gtree)
        mult = (lr_multipliers or {}).get(lname, 1.0)
        np_, ns_ = {}, {}
        for k, p in ptree.items():
            upd, s2 = _update_leaf(tc.updater, tc, gtree[k],
                                   stree.get(k, {}), _f32(lr * mult), t)
            np_[k] = p - (sign * upd).to(p.dtype)
            ns_[k] = s2
        new_params[lname] = np_
        new_state[lname] = ns_
    return new_params, new_state


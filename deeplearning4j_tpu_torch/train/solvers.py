"""Convex optimizers beyond the first-order updater family (port of
deeplearning4j_tpu/train/solvers.py).

The Solver dispatch of the JAX package: an `optimization_algo` of
line_gradient_descent, conjugate_gradient or lbfgs runs that algorithm
on the network's flat parameter vector (the `params_flat` order: dict
keys sorted as strings, the order of JAX's `ravel_pytree`). The score
and gradient of the whole network with respect to the flat vector are
one autograd evaluation; the outer loop (curvature history,
Polak-Ribiere beta, Armijo backtracking) is host control flow, as in
JAX. Line-search probes run the forward alone and leave batch-norm and
center-loss state untouched.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


def _vdot(a: Tensor, b: Tensor) -> float:
    return float(torch.dot(a.reshape(-1), b.reshape(-1)))


# --------------------------------------------------------------- terminations
class TerminationCondition:
    """reference: optimize/api/TerminationCondition.java"""

    def terminate(self, new_score: float, old_score: float,
                  other: Optional[Tensor] = None) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """|new - old| < eps (reference: terminations/EpsTermination.java)."""

    def __init__(self, eps: float = 1e-10, tolerance: float = 1e-5):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, new_score, old_score, other=None):
        if old_score == 0.0:
            return abs(new_score - old_score) < self.eps
        return (abs(new_score - old_score)
                / abs(old_score)) < self.tolerance

    def __repr__(self):
        return f"EpsTermination(eps={self.eps}, tol={self.tolerance})"


class Norm2Termination(TerminationCondition):
    """||grad||₂ < threshold (reference: terminations/Norm2Termination)."""

    def __init__(self, gradient_norm_threshold: float = 1e-8):
        self.threshold = gradient_norm_threshold

    def terminate(self, new_score, old_score, other=None):
        if other is None:
            return False
        return float(torch.linalg.vector_norm(other)) < self.threshold


class ZeroDirection(TerminationCondition):
    """Search direction vanished (reference: terminations/ZeroDirection)."""

    def terminate(self, new_score, old_score, other=None):
        if other is None:
            return False
        return float(other.abs().max()) == 0.0


# ---------------------------------------------------------------- line search
def backtrack_line_search(f: Callable[[Tensor], float], w: Tensor,
                          score0: float, grad: Tensor, direction: Tensor,
                          *, max_iterations: int = 16, c1: float = 1e-4,
                          initial_step: float = 1.0,
                          backoff: float = 0.5) -> Tuple[float, Tensor, float]:
    """Armijo backtracking along ``direction`` (reference:
    optimize/solvers/BackTrackLineSearch.java — sufficient-decrease
    slope c1=1e-4, geometric backoff; the reference defaults to 5
    probes, here 16 so stiff curvature like Rosenbrock still finds an
    Armijo point). Returns (step, new_w, new_score); step 0.0 means no
    improving point was found (caller restarts/steps raw gradient).
    """
    slope = _vdot(grad, direction)
    if slope >= 0.0:
        return 0.0, w, score0
    step = initial_step
    for _ in range(max_iterations):
        cand = w + step * direction
        score = float(f(cand))
        if score <= score0 + c1 * step * slope:
            return step, cand, score
        step *= backoff
    return 0.0, w, score0


# -------------------------------------------------------------------- solvers
class BaseSolver:
    """Shared optimize() driver (reference: BaseOptimizer.java:156 —
    gradientAndScore → search direction → line search/step → check
    termination conditions)."""

    def __init__(self, value_and_grad: Callable[[Tensor],
                                                Tuple[float, Tensor]],
                 *, max_iterations: int = 10,
                 terminations: Optional[Sequence[TerminationCondition]]
                 = None,
                 learning_rate: float = 1.0,
                 value_fn: Optional[Callable[[Tensor], float]] = None):
        self.value_and_grad = value_and_grad
        self.max_iterations = max_iterations
        self.terminations = list(terminations) if terminations is not None \
            else [EpsTermination(), ZeroDirection()]
        self.learning_rate = learning_rate
        # forward-only loss for line-search probes — probes don't need
        # the gradient, so don't pay for the backward pass on each one
        self.value_fn = value_fn
        self.score_history: List[float] = []

    def _value(self, w: Tensor) -> float:
        if self.value_fn is not None:
            return float(self.value_fn(w))
        s, _ = self.value_and_grad(w)
        return float(s)

    def _direction(self, grad: Tensor, state: dict) -> Tensor:
        raise NotImplementedError

    def _post_step(self, state: dict, w_old: Tensor, w_new: Tensor,
                   grad_old: Tensor, grad_new: Tensor) -> None:
        pass

    def optimize(self, w0: Tensor,
                 callback: Optional[Callable[[Tensor, float], None]] = None
                 ) -> Tuple[Tensor, float]:
        """``callback(w, score)`` fires after every accepted step
        (reference: BaseOptimizer notifies IterationListeners each
        iteration)."""
        w = w0
        score, grad = self.value_and_grad(w)
        score = float(score)
        self.score_history = [score]
        state: dict = {}
        for _ in range(self.max_iterations):
            direction = self._direction(grad, state)
            if any(isinstance(t, ZeroDirection)
                   and t.terminate(score, score, direction)
                   for t in self.terminations):
                break
            step, w_new, new_score = backtrack_line_search(
                self._value, w, score, grad, direction,
                initial_step=self.learning_rate)
            if step == 0.0:
                # no improvement along direction: fall back to raw
                # negative gradient (reference: BaseOptimizer restart)
                step, w_new, new_score = backtrack_line_search(
                    self._value, w, score, grad, -grad,
                    initial_step=self.learning_rate)
                if step == 0.0:
                    break
                state.clear()
            _, grad_new = self.value_and_grad(w_new)
            self._post_step(state, w, w_new, grad, grad_new)
            old_score, score = score, new_score
            w, grad = w_new, grad_new
            self.score_history.append(score)
            if callback is not None:
                callback(w, score)
            if any(t.terminate(score, old_score, grad)
                   for t in self.terminations):
                break
        return w, score


class LineGradientDescent(BaseSolver):
    """Steepest descent + line search (reference:
    optimize/solvers/LineGradientDescent.java)."""

    def _direction(self, grad, state):
        return -grad


class ConjugateGradient(BaseSolver):
    """Nonlinear CG, Polak-Ribière with automatic restart (reference:
    optimize/solvers/ConjugateGradient.java — beta = max(0, PR))."""

    def _direction(self, grad, state):
        prev_grad = state.get("prev_grad")
        prev_dir = state.get("prev_dir")
        if prev_grad is None or prev_dir is None:
            d = -grad
        else:
            denom = _vdot(prev_grad, prev_grad)
            beta = 0.0 if denom == 0.0 else max(
                0.0, _vdot(grad, grad - prev_grad) / denom)
            d = -grad + beta * prev_dir
        state["prev_dir"] = d
        return d

    def _post_step(self, state, w_old, w_new, grad_old, grad_new):
        state["prev_grad"] = grad_old


class LBFGS(BaseSolver):
    """Limited-memory BFGS, two-loop recursion (reference:
    optimize/solvers/LBFGS.java — default history m=4)."""

    def __init__(self, value_and_grad, *, m: int = 4, **kw):
        super().__init__(value_and_grad, **kw)
        self.m = m

    def _direction(self, grad, state):
        pairs = state.get("pairs", [])
        q = grad
        alphas = []
        for s, y, rho in reversed(pairs):
            alpha = rho * _vdot(s, q)
            q = q - alpha * y
            alphas.append(alpha)
        if pairs:
            s, y, _ = pairs[-1]
            gamma = _vdot(s, y) / max(_vdot(y, y),
                                                1e-30)
            r = gamma * q
        else:
            r = q
        for (s, y, rho), alpha in zip(pairs, reversed(alphas)):
            beta = rho * _vdot(y, r)
            r = r + s * (alpha - beta)
        return -r

    def _post_step(self, state, w_old, w_new, grad_old, grad_new):
        s = w_new - w_old
        y = grad_new - grad_old
        sy = _vdot(s, y)
        if sy > 1e-10:  # curvature condition; skip degenerate pairs
            pairs = state.setdefault("pairs", [])
            pairs.append((s, y, 1.0 / sy))
            if len(pairs) > self.m:
                pairs.pop(0)


class StochasticGradientDescent(BaseSolver):
    """Plain SGD step on the flat vector (reference:
    optimize/solvers/StochasticGradientDescent.java:54-61 — params +=
    -lr·grad via NegativeGradientStepFunction). The updater path
    in MultiLayerNetwork subsumes this; kept for Solver-API parity."""

    def optimize(self, w0, callback=None):
        w = w0
        self.score_history = []
        for _ in range(self.max_iterations):
            score, grad = self.value_and_grad(w)
            self.score_history.append(float(score))
            w = w - self.learning_rate * grad
            if callback is not None:
                callback(w, float(score))
        score = self._value(w)  # score at the returned point
        self.score_history.append(score)
        return w, score


_ALGOS = {
    "stochastic_gradient_descent": StochasticGradientDescent,
    "sgd": StochasticGradientDescent,
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """Dispatch a model + minibatch onto an optimizer: one flat
    ``value_and_grad`` of the network score, handed to the algorithm
    ``conf.training.optimization_algo`` names. Serves MultiLayerNetwork
    (arrays) and ComputationGraph (name -> array dicts of inputs, labels
    and masks), as in JAX."""

    def __init__(self, net, *, max_iterations: Optional[int] = None,
                 terminations: Optional[Sequence[TerminationCondition]]
                 = None):
        self.net = net
        tc = net.conf.training
        self.algo = tc.optimization_algo
        if self.algo not in _ALGOS:
            raise ValueError(f"Unknown optimization_algo '{self.algo}'; "
                             f"one of {sorted(_ALGOS)}")
        self.max_iterations = (max_iterations if max_iterations is not None
                               else max(1, tc.num_iterations))
        self.terminations = terminations

    def _flat_fns(self, x, y, mask):
        """(score, grad) and the forward-only score of the flat params.
        Layer state (batch-norm statistics, center-loss centers) threads
        through the gradient evaluations and is written back to the net
        on each. Line-search probes run the forward alone (``train=True``:
        batch statistics of the batch) and drop the new state, so
        exploratory points leave it as it was."""
        from deeplearning4j_tpu_torch.nn.multilayer import unravel_like
        net = self.net
        template = net.params

        def loss(w, state):
            return net._loss_fn(unravel_like(template, w), state, x, y,
                                None, mask, train=True)

        def vg(w):
            w = w.detach().requires_grad_(True)
            with torch.enable_grad():
                score, new_state = loss(w, net.state)
            grad, = torch.autograd.grad(score, w)
            net.state = new_state
            return score.detach(), grad

        def value(w):
            with torch.no_grad():
                return loss(w, net.state)[0]

        return vg, value

    def optimize(self, x, y, mask=None, iteration_callback=None) -> float:
        """One Solver.optimize() call: full-batch second-order fit of the
        net's params on (x, y). Updates net.params in place; returns the
        final score. ``iteration_callback(score)`` fires after each
        internal step with net.params already updated."""
        from deeplearning4j_tpu_torch.nn.multilayer import unravel_like
        net = self.net
        x = net._tensor(x)
        y = net._tensor(y)
        mask = None if mask is None else net._tensor(mask)
        vg, value = self._flat_fns(x, y, mask)
        template = net.params
        flat = net.params_flat().detach()
        cls = _ALGOS[self.algo]
        kw = dict(max_iterations=self.max_iterations,
                  learning_rate=(net.conf.training.learning_rate
                                 if cls is StochasticGradientDescent
                                 else 1.0),
                  value_fn=value)
        if self.terminations is not None:
            kw["terminations"] = self.terminations
        solver = cls(vg, **kw)

        def cb(w, score):
            net.params = unravel_like(template, w)
            net.score_value = score
            if iteration_callback is not None:
                iteration_callback(score)

        w, score = solver.optimize(flat, callback=cb)
        net.params = unravel_like(template, w)
        net.score_value = score
        return score

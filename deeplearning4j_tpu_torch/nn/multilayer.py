"""MultiLayerNetwork — the sequential model (port of
deeplearning4j_tpu/nn/multilayer.py).

The network holds its parameters as ``{layer_name: {param: tensor}}``
on one device (CUDA unless the caller passes ``device="cpu"``). A
minibatch step is the JAX package's jitted step run eagerly: forward,
loss (+L1/L2), autograd backward, gradient normalization, updater.
`fit_batched` is a host loop over pool x epochs with the iteration, key
and score semantics of the JAX package's scanned programs
(`_make_scan_fit` / `_make_scan_fit_tbptt`): one update per minibatch
(per TBPTT chunk), carries reset per minibatch, the iteration counter
running on across epochs, and the per-step scores returned as one
tensor. Keys are integer seeds (`nn.layers.base.fold_in`), so dropout
is a function of (seed, iteration, layer).

Adjacent unidirectional LSTM layers run as one `wavefront_scan_stack`
while `lstm_wavefront` is True (the default, as in JAX); with it False,
every LSTM layer runs `scan_sequence`, which on the card launches the
fused LSTM-scan kernel once per layer and sequence.

Around the step: listeners (`set_listeners`, called with the JAX
package's arguments), the `TrainingGuard` (`set_training_guard`: a
non-finite update is discarded before the guard judges it; SKIP keeps
the tree and still advances the iteration; ROLLBACK raises
`DivergenceError`), the Solver for the non-SGD optimization algorithms
(`train.solvers`), `fit_batched_cost` (FLOPs of the step by
`torch.utils.flop_counter`), layerwise `pretrain` of the AutoEncoder,
RBM and VariationalAutoencoder layers, and the inference and evaluation
surface.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.common import promote_score
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, apply_dropout,
                                                     fold_in)
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    wavefront_eligible_run as _wavefront_run,
    wavefront_scan_stack as _wavefront_scan)
from deeplearning4j_tpu_torch.train.updaters import (apply_updater,
                                                     init_updater_state)

Tensor = torch.Tensor

_SGD = ("stochastic_gradient_descent", "sgd")


def _dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]


def _leaves(tree) -> List[Tensor]:
    """Tensors of a nested dict in sorted-key order (jax's dict order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def value_and_grad(loss_fn, params):
    """(score, aux, grads) of ``loss_fn(params) -> (score, aux)`` by
    autograd over a ``{layer: {param: tensor}}`` tree; a parameter the
    loss does not reach gets a zero gradient."""
    leaves = _map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        score, aux = loss_fn(leaves)
    flat = _leaves(leaves)
    gs = torch.autograd.grad(score, flat, allow_unused=True) if flat \
        else ()
    gs = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, gs)])
    grads = {k: {pk: next(gs) for pk in sorted(leaves[k])}
             for k in sorted(leaves)}
    return score.detach(), aux, grads


class MultiLayerNetwork:
    """Sequential network over a MultiLayerConfiguration."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.device = resolve_device(device)
        self.conf = conf
        conf.resolve_shapes()
        self.layers: List[Layer] = conf.layers
        self.layer_names = [conf.layer_name(i)
                            for i in range(len(conf.layers))]
        self.dtype = _dtype_of(conf.training.dtype)
        self.params: Dict[str, Dict[str, Tensor]] = {}
        self.state: Dict[str, Dict[str, Tensor]] = {}
        self.updater_state: Dict[str, Any] = {}
        self.iteration_count = 0
        self.epoch_count = 0
        # cross-layer LSTM wavefront (nn/layers/recurrent.py); False runs
        # every LSTM layer through scan_sequence (the fused kernel)
        self.lstm_wavefront = True
        self.listeners: List[Any] = []
        self.training_guard: Optional[Any] = None
        self.last_grad_norm: float = float("nan")
        self.score_value: float = float("nan")
        self._rnn_carries: Optional[Dict[str, Any]] = None
        self._solver = None
        self._pretrain_counts: Dict[int, int] = {}
        self._initialized = False

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Initialize parameters: layer i draws from a CPU
        `torch.Generator` seeded with fold_in(seed, i), so the same seed
        gives the same weights on every device."""
        seed = self.conf.training.seed if seed is None else seed
        for i, layer in enumerate(self.layers):
            name = self.layer_names[i]
            act = getattr(layer, "activation", None)
            if isinstance(act, str):
                get_activation(act)      # a typo'd name fails here
            gen = torch.Generator().manual_seed(fold_in(seed, i))
            self.params[name] = layer.init_params(gen, self.dtype,
                                                  self.device)
            self.state[name] = layer.init_state(self.dtype, self.device)
        self.updater_state = init_updater_state(self.conf.training,
                                                self.params)
        self._initialized = True
        return self

    def set_params_from_numpy(self, tree) -> None:
        """Take a JAX network's ``{layer: {param: array}}`` tree (numpy
        leaves) as this network's parameters, cast to its dtype."""
        from deeplearning4j_tpu_torch.models.convert import \
            network_params_from_numpy
        if not self._initialized:
            self.init()
        self.params = network_params_from_numpy(tree, self.device,
                                                self.dtype)

    def set_updater_state_from_numpy(self, tree) -> None:
        """Take a JAX network's updater-state tree (numpy leaves)."""
        from deeplearning4j_tpu_torch.models.convert import \
            updater_state_from_numpy
        if not self._initialized:
            self.init()
        self.updater_state = updater_state_from_numpy(tree, self.device)

    def set_state_from_numpy(self, tree) -> None:
        """Take a JAX network's layer-state tree ``{layer: {name:
        array}}`` (batch-norm running statistics, center-loss centers),
        cast to this network's dtype."""
        from deeplearning4j_tpu_torch.models.convert import \
            network_params_from_numpy
        if not self._initialized:
            self.init()
        self.state = network_params_from_numpy(tree, self.device,
                                               self.dtype)

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def set_training_guard(self, guard) -> None:
        """Install (or clear, with None) a `train.guard.TrainingGuard`:
        `fit`'s SGD path switches to the guarded step (post-step score and
        global gradient norm checked, a non-finite update discarded before
        the guard sees it, skip / rollback applied)."""
        self.training_guard = guard

    def _tensor(self, x) -> Tensor:
        """An input on this network's device; float64 host arrays become
        float32, as jnp.asarray makes them in the JAX package."""
        if not isinstance(x, Tensor):
            a = np.asarray(x)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(self.device)

    def _cast_in(self, x: Tensor) -> Tensor:
        return x.to(self.dtype) if x.is_floating_point() else x

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, x, *, train: bool,
                 key: Optional[int], mask: Optional[Tensor],
                 carries: Optional[Dict[str, Any]] = None,
                 collect: bool = False):
        """Forward over all layers. Returns (activations list if collect
        else final activation, None, new_state, new_carries)."""
        acts = []
        new_state = {}
        new_carries = {}
        h = self._cast_in(x)
        i = 0
        while i < len(self.layers):
            layer = self.layers[i]
            name = self.layer_names[i]
            pp = self.conf.input_preprocessors.get(str(i))
            if pp is not None:
                h = pp.pre_process(h)
            lkey = fold_in(key, i) if key is not None else None
            if train and (layer.dropout or 0.0) > 0 and lkey is not None:
                h = apply_dropout(h, layer.dropout, lkey)
            # collect=True needs every layer's activations, so it keeps
            # the per-layer path
            run = [] if collect else _wavefront_run(
                self.layers, self.layer_names, i, train=train,
                mask=mask, carries=carries,
                preprocessors=self.conf.input_preprocessors,
                enabled=self.lstm_wavefront)
            if len(run) > 1:
                h = self._apply_wavefront(run, params, h, carries, state,
                                          new_state, new_carries,
                                          stop_grad=False)
                i = run[-1] + 1
                continue
            if carries is not None and hasattr(layer, "scan_sequence") \
                    and name in carries:
                h, carry = layer.scan_sequence(params[name], h,
                                               carry=carries[name],
                                               mask=mask)
                new_carries[name] = carry
                new_state[name] = state.get(name, {})
            else:
                h, st = layer.apply(params[name], state.get(name, {}), h,
                                    train=train, key=lkey, mask=mask)
                new_state[name] = st
            if collect:
                acts.append(h)
            i += 1
        return (acts if collect else h), None, new_state, new_carries

    def _apply_wavefront(self, run, params, h, carries, state,
                         new_state, new_carries, *, stop_grad):
        """Run one fused LSTM stack (shared by _forward and the TBPTT
        chunk). Emits per-layer final carries when the carries dict
        covers the run; ``stop_grad`` is the TBPTT chunk boundary."""
        rnames = [self.layer_names[j] for j in run]
        cl = ([carries[nm] for nm in rnames]
              if carries is not None and rnames[0] in carries else None)
        h, finals = _wavefront_scan(
            [self.layers[j] for j in run],
            [params[nm] for nm in rnames], h, carries=cl)
        for nm, fc in zip(rnames, finals):
            if cl is not None:
                new_carries[nm] = (tuple(c.detach() for c in fc)
                                   if stop_grad else fc)
            new_state[nm] = state.get(nm, {})
        return h

    def _regularization_score(self, params) -> Tensor:
        """0.5*l2*||W||^2 + l1*||W||_1 summed over layers."""
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, layer in enumerate(self.layers):
            name = self.layer_names[i]
            l1 = layer.l1 or 0.0
            l2 = layer.l2 or 0.0
            if (l1 == 0.0 and l2 == 0.0) or not params.get(name):
                continue
            for k in layer.weight_param_keys():
                if k not in params[name]:
                    continue
                w = promote_score(params[name][k])
                if l2 > 0:
                    total = total + 0.5 * l2 * torch.sum(w * w)
                if l1 > 0:
                    total = total + l1 * torch.sum(torch.abs(w))
        return total

    def _loss_fn(self, params, state, x, y, key, mask, train=True):
        out_layer = self.layers[-1]
        out_name = self.layer_names[-1]
        if not hasattr(out_layer, "loss"):
            raise ValueError("Last layer must be an output/loss layer to "
                             "compute a score")
        h = self._cast_in(x)
        new_state = {}
        n = len(self.layers)
        for i, layer in enumerate(self.layers[:-1]):
            name = self.layer_names[i]
            pp = self.conf.input_preprocessors.get(str(i))
            if pp is not None:
                h = pp.pre_process(h)
            lkey = fold_in(key, i) if key is not None else None
            if train and (layer.dropout or 0.0) > 0 and lkey is not None:
                h = apply_dropout(h, layer.dropout, lkey)
            h, st = layer.apply(params[name], state.get(name, {}), h,
                                train=train, key=lkey, mask=mask)
            new_state[name] = st
        pp = self.conf.input_preprocessors.get(str(n - 1))
        if pp is not None:
            h = pp.pre_process(h)
        okey = fold_in(key, n - 1) if key is not None else None
        if (out_layer.dropout or 0.0) > 0 and okey is not None:
            h = apply_dropout(h, out_layer.dropout, okey)
        if hasattr(out_layer, "update_centers"):          # center loss
            loss = out_layer.loss(params[out_name], h, y, mask,
                                  state.get(out_name))
            new_state[out_name] = out_layer.update_centers(
                state.get(out_name, {}), h, y)
        else:
            loss = out_layer.loss(params[out_name], h, y, mask)
            new_state[out_name] = state.get(out_name, {})
        score = promote_score(loss) + self._regularization_score(params)
        return score, new_state

    # ----------------------------------------------------------- train step
    def _lr_multipliers(self) -> Dict[str, float]:
        base = self.conf.training.learning_rate
        out = {}
        for i, layer in enumerate(self.layers):
            lr = layer.learning_rate
            # explicit 0.0 is a valid per-layer LR (freezing)
            out[self.layer_names[i]] = (lr / base) \
                if (lr is not None and base) else 1.0
        return out

    def _trainable(self) -> Dict[str, bool]:
        return {self.layer_names[i]: not isinstance(l, FrozenLayer)
                for i, l in enumerate(self.layers)}

    def _update(self, params, state, opt_state, iteration, x, y, key,
                mask):
        """One minibatch update (the JAX package's `_step_math`), with
        the gradients: (new params, new state, new opt state, score,
        grads)."""
        def loss_fn(p):
            return self._loss_fn(p, state, x, y, key, mask)
        score, new_state, grads = value_and_grad(loss_fn, params)
        new_params, new_opt = apply_updater(
            self.conf.training, params, grads, opt_state, iteration,
            lr_multipliers=self._lr_multipliers(),
            trainable=self._trainable())
        return new_params, new_state, new_opt, score, grads

    def _step(self, params, state, opt_state, iteration, x, y, key, mask):
        """One minibatch update: (params, state, opt state, score)."""
        return self._update(params, state, opt_state, iteration, x, y, key,
                            mask)[:4]

    def _guarded_step(self, params, state, opt_state, iteration, x, y, key,
                      mask):
        """`_step` that also returns the global gradient norm and keeps
        the pre-step tree (params, state, updater state) when the score
        or the norm is not finite: a poisoned batch cannot reach the tree
        even before the guard judges it. The choice is made on the
        device (`torch.where`), with no wait for the host."""
        new_params, new_state, new_opt, score, grads = self._update(
            params, state, opt_state, iteration, x, y, key, mask)
        gnorm = torch.sqrt(sum(torch.sum(promote_score(g) ** 2)
                               for g in _leaves(grads)))
        ok = torch.isfinite(score) & torch.isfinite(gnorm)

        def keep(new, old):
            if isinstance(new, dict):
                return {k: keep(v, old[k]) for k, v in new.items()}
            return torch.where(ok, new, old)

        return (keep(new_params, params), keep(new_state, state),
                keep(new_opt, opt_state), score, gnorm)

    def _tbptt_chunk(self, params, state, opt_state, iteration, xs, ys,
                     carries, key, m):
        """One forward over a time chunk with carried (detached) RNN
        state, one optimizer step (the JAX package's
        `_tbptt_chunk_math`)."""
        def loss_fn(p):
            h = xs.to(self.dtype)
            new_state = {}
            new_carries = {}
            i = 0
            while i < len(self.layers) - 1:
                layer = self.layers[i]
                name = self.layer_names[i]
                run = _wavefront_run(
                    self.layers[:-1], self.layer_names, i,
                    train=True, mask=m, carries=carries,
                    preprocessors=self.conf.input_preprocessors,
                    enabled=self.lstm_wavefront)
                if len(run) > 1:
                    h = self._apply_wavefront(
                        run, p, h, carries, state, new_state,
                        new_carries, stop_grad=True)
                    i = run[-1] + 1
                    continue
                if hasattr(layer, "scan_sequence") and name in carries:
                    h, carry = layer.scan_sequence(
                        p[name], h, carry=carries.get(name), mask=m)
                    new_carries[name] = tuple(c.detach() for c in carry)
                    new_state[name] = state.get(name, {})
                else:
                    h, st = layer.apply(p[name], state.get(name, {}), h,
                                        train=True, key=key, mask=m)
                    new_state[name] = st
                i += 1
            out_layer = self.layers[-1]
            out_name = self.layer_names[-1]
            loss = out_layer.loss(p[out_name], h, ys, m)
            new_state[out_name] = state.get(out_name, {})
            score = promote_score(loss) + self._regularization_score(p)
            return score, (new_state, new_carries)

        score, (new_state, new_carries), grads = value_and_grad(loss_fn,
                                                                params)
        new_params, new_opt = apply_updater(
            self.conf.training, params, grads, opt_state, iteration,
            lr_multipliers=self._lr_multipliers(),
            trainable=self._trainable())
        return new_params, new_state, new_opt, new_carries, score

    def _init_carries(self, batch: int) -> Dict[str, Any]:
        carries = {}
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "initial_carry") \
                    and getattr(layer, "supports_streaming", True):
                carries[self.layer_names[i]] = layer.initial_carry(
                    batch, self.dtype, self.device)
        return carries

    def _notify_iteration(self, score, x, record: bool = True) -> None:
        """Fire the listeners' per-iteration hooks and advance
        iteration_count. ``record`` gates the batch / input hooks: TBPTT
        fires iteration_done per chunk but counts a minibatch's examples
        once."""
        self.score_value = score
        for lst in self.listeners:
            if record and hasattr(lst, "record_batch"):
                lst.record_batch(int(x.shape[0]))
            if record and hasattr(lst, "record_input"):
                lst.record_input(x)
            lst.iteration_done(self, self.iteration_count, score)
        self.iteration_count += 1

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, mask=None) -> None:
        """Train. ``data`` is an iterable of (features, labels) or
        DataSet-like batches, or a raw array with ``labels``."""
        if not self._initialized:
            self.init()
        if labels is not None:
            self._fit_batch(data, labels, mask)
            return
        for lst in self.listeners:
            lst.on_epoch_start(self)
        for batch in data:
            feats, labs, fmask, lmask = _unpack_batch(batch)
            self._fit_batch(feats, labs, lmask if lmask is not None
                            else fmask)
        for lst in self.listeners:
            lst.on_epoch_end(self)
        self.epoch_count += 1
        if hasattr(data, "reset"):
            data.reset()

    def _fit_batch(self, x, y, mask=None) -> None:
        x = self._tensor(x)
        y = self._tensor(y)
        mask = None if mask is None else self._tensor(mask)
        algo = self.conf.training.optimization_algo
        if self.conf.backprop_type == "tbptt" and x.ndim == 3:
            if algo not in _SGD:
                raise ValueError(
                    "TBPTT supports first-order optimization only — "
                    f"optimization_algo={algo!r}")
            self._fit_tbptt(x, y, mask)
            return
        if algo not in _SGD:
            # the second-order path: LBFGS / CG / line gradient descent
            from deeplearning4j_tpu_torch.train.solvers import Solver
            if self._solver is None:
                self._solver = Solver(self)
            self._solver.optimize(
                x, y, mask,
                iteration_callback=lambda s: self._notify_iteration(s, x))
            return
        if self.training_guard is not None:
            self._fit_batch_guarded(x, y, mask)
            return
        for _ in range(max(1, self.conf.training.num_iterations)):
            key = fold_in(self.conf.training.seed, self.iteration_count)
            self.params, self.state, self.updater_state, score = self._step(
                self.params, self.state, self.updater_state,
                self.iteration_count, x, y, key, mask)
            self._notify_iteration(score, x)

    def _fit_batch_guarded(self, x, y, mask=None) -> None:
        """SGD minibatch step under a TrainingGuard: the guarded step
        (a non-finite update already discarded), then the guard's verdict
        on (score, grad_norm). ACCEPT commits the new tree; SKIP keeps the
        pre-step tree (the iteration counter still advances, so the
        dropout stream and LR schedule move past the bad batch); ROLLBACK
        raises DivergenceError for the caller's checkpoint policy."""
        from deeplearning4j_tpu_torch.train.guard import (DivergenceError,
                                                          TrainingGuard)
        guard = self.training_guard
        for _ in range(max(1, self.conf.training.num_iterations)):
            key = fold_in(self.conf.training.seed, self.iteration_count)
            new_p, new_s, new_o, score, gnorm = self._guarded_step(
                self.params, self.state, self.updater_state,
                self.iteration_count, x, y, key, mask)
            score_f = float(score)
            self.last_grad_norm = float(gnorm)
            action = guard.update(score_f, self.last_grad_norm)
            if action == TrainingGuard.ACCEPT:
                self.params, self.state, self.updater_state = (
                    new_p, new_s, new_o)
            elif action == TrainingGuard.ROLLBACK:
                raise DivergenceError(
                    f"training diverged at iteration "
                    f"{self.iteration_count}: {guard.max_consecutive} "
                    f"consecutive bad steps (last: {guard.last_reason}, "
                    f"score={score_f}, grad_norm={self.last_grad_norm})")
            # SKIP: the pre-step tree stays
            self._notify_iteration(score_f, x)

    def _fit_tbptt(self, x, y, mask=None) -> None:
        """Truncated BPTT: split the time axis into chunks of
        tbptt_fwd_length, carry RNN state (detached) across chunks."""
        T = x.shape[1]
        L = self.conf.tbptt_fwd_length
        carries = self._init_carries(x.shape[0])
        for c in range(math.ceil(T / L)):
            sl = slice(c * L, min((c + 1) * L, T))
            m = None if mask is None else mask[:, sl]
            key = fold_in(self.conf.training.seed, self.iteration_count)
            (self.params, self.state, self.updater_state, carries,
             score) = self._tbptt_chunk(
                self.params, self.state, self.updater_state,
                self.iteration_count, x[:, sl], y[:, sl], carries, key, m)
            # batch / input hooks once a minibatch (its first chunk);
            # score stays a device tensor: reading it would wait for the
            # card after every chunk
            self._notify_iteration(score, x, record=(c == 0))

    def fit_batched(self, xs, ys, epochs: int = 1) -> Tensor:
        """Train on a pre-staged stack of minibatches: ``xs`` [N, B, ...],
        ``ys`` [N, B, ...] -> per-step scores [N * epochs] (one tensor on
        the device). With backprop_type='tbptt' and [N, B, T, F] data,
        each minibatch walks its time chunks with carries reset per
        minibatch and one update per chunk, so scores (and iterations)
        are per CHUNK: [N * T/L * epochs]."""
        if not self._initialized:
            self.init()
        xs = self._tensor(xs)
        ys = self._tensor(ys)
        tc = self.conf.training
        if tc.optimization_algo not in _SGD:
            raise ValueError(
                "fit_batched supports first-order optimization only; "
                f"optimization_algo={tc.optimization_algo!r} dispatches "
                "to the Solver path — use fit() instead")
        if max(1, tc.num_iterations) != 1:
            raise ValueError(
                "fit_batched applies one update per minibatch; "
                f"num_iterations={tc.num_iterations} requires fit()")
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        use_tbptt = self.conf.backprop_type == "tbptt" and ys.ndim == 4
        L = self.conf.tbptt_fwd_length
        if use_tbptt:
            if xs.ndim != 4:
                raise ValueError("tbptt fit_batched needs [N, B, T, F] "
                                 f"inputs, got ndim={xs.ndim}")
            if xs.shape[2] != ys.shape[2]:
                raise ValueError(
                    f"tbptt fit_batched needs one sequence length; "
                    f"inputs T={xs.shape[2]} vs labels T={ys.shape[2]}")
            if xs.shape[2] % L:
                raise ValueError(
                    f"tbptt fit_batched needs T ({xs.shape[2]}) divisible "
                    f"by tbptt_fwd_length ({L}); use fit() for ragged "
                    "tails")
        it = self.iteration_count
        scores = []
        for _ in range(epochs):
            for n in range(xs.shape[0]):
                x, y = xs[n], ys[n]
                if not use_tbptt:
                    key = fold_in(tc.seed, it)
                    (self.params, self.state, self.updater_state,
                     score) = self._step(self.params, self.state,
                                         self.updater_state, it, x, y, key,
                                         None)
                    scores.append(score)
                    it += 1
                    continue
                carries = self._init_carries(x.shape[0])
                for c in range(x.shape[1] // L):
                    sl = slice(c * L, (c + 1) * L)
                    key = fold_in(tc.seed, it)
                    (self.params, self.state, self.updater_state, carries,
                     score) = self._tbptt_chunk(
                        self.params, self.state, self.updater_state, it,
                        x[:, sl], y[:, sl], carries, key, None)
                    scores.append(score)
                    it += 1
        scores = torch.stack(scores)
        if not self.listeners:
            # no per-step host work on the hot path
            self.iteration_count = it
            self.score_value = float(scores[-1])
            return scores
        # listeners fire after the run, as after JAX's one program: TBPTT
        # gives chunks_per_batch scores a minibatch, whose batch / input
        # hooks fire once (its first chunk)
        chunks = xs.shape[2] // L if use_tbptt else 1
        pool = int(xs.shape[0])
        for i, sc in enumerate(scores.tolist()):
            self._notify_iteration(sc, xs[(i // chunks) % pool],
                                   record=(i % chunks == 0))
        return scores

    def fit_batched_cost(self, xs, ys, epochs: int = 1,
                         lstm_wavefront: Optional[bool] = None) -> dict:
        """``{"flops": F, "steps": S}``: F the floating-point operations
        of ONE step of `fit_batched(xs, ys, epochs)` at these shapes (one
        TBPTT chunk with TBPTT), S the steps that call runs. F is what
        the JAX package's XLA cost analysis of the scanned program gives
        (it counts the scan body once); here
        `torch.utils.flop_counter.FlopCounterMode` counts a step on the
        first minibatch, run on the same tensors and discarded:
        parameters, state and counters are untouched. The counter sees
        PyTorch's own operators (matmuls, convolutions); the hand-written
        kernels' work (flash attention, lstm_scan) is not in it.
        ``lstm_wavefront`` picks the LSTM schedule counted, as in JAX."""
        from torch.utils.flop_counter import FlopCounterMode
        if not self._initialized:
            self.init()
        xs = self._tensor(xs)
        ys = self._tensor(ys)
        use_tbptt = self.conf.backprop_type == "tbptt" and ys.ndim == 4
        L = self.conf.tbptt_fwd_length
        chunks = xs.shape[2] // L if use_tbptt else 1
        prev = self.lstm_wavefront
        if lstm_wavefront is not None:
            self.lstm_wavefront = lstm_wavefront
        counter = FlopCounterMode(display=False)
        try:
            with counter:
                x, y = xs[0], ys[0]
                it0 = self.iteration_count
                key = fold_in(self.conf.training.seed, it0)
                if use_tbptt:
                    self._tbptt_chunk(self.params, self.state,
                                      self.updater_state, it0, x[:, :L],
                                      y[:, :L],
                                      self._init_carries(x.shape[0]), key,
                                      None)
                else:
                    self._step(self.params, self.state, self.updater_state,
                               it0, x, y, key, None)
        finally:
            self.lstm_wavefront = prev
        return {"flops": float(counter.get_total_flops()),
                "steps": int(xs.shape[0]) * chunks * epochs}

    # -------------------------------------------------------------- pretrain
    def pretrain(self, data) -> None:
        """Greedy layerwise unsupervised pretraining of the AutoEncoder,
        RBM and VAE layers, in order."""
        if not self._initialized:
            self.init()
        for i, layer in enumerate(self.layers):
            if not layer.is_pretrain_layer():
                continue
            self.pretrain_layer(i, data)
            if hasattr(data, "reset"):
                data.reset()

    @torch.no_grad()
    def _layer_input(self, layer_idx: int, x: Tensor) -> Tensor:
        """The (preprocessed) input of layer ``layer_idx``: the layers
        below in inference mode, no gradient."""
        h = self._cast_in(x)
        for j in range(layer_idx):
            jn = self.layer_names[j]
            pp = self.conf.input_preprocessors.get(str(j))
            if pp is not None:
                h = pp.pre_process(h)
            h, _ = self.layers[j].apply(self.params[jn],
                                        self.state.get(jn, {}), h,
                                        train=False)
        pp = self.conf.input_preprocessors.get(str(layer_idx))
        return pp.pre_process(h) if pp is not None else h

    def pretrain_layer(self, layer_idx: int, data) -> None:
        """Pretrain one layer on ``data`` (an array, or an iterable of
        batches whose features it takes); a per-layer counter keeps the
        updater's step and the draws' keys running across calls."""
        layer = self.layers[layer_idx]
        name = self.layer_names[layer_idx]
        if not layer.is_pretrain_layer():
            return
        tc = self.conf.training
        it = self._pretrain_counts.get(layer_idx, 0)
        batches = data if not hasattr(data, "__array__") else [(data, None)]
        for batch in batches:
            feats, _, _, _ = _unpack_batch(batch)
            h = self._layer_input(layer_idx, self._tensor(feats))
            (self.params[name], self.updater_state[name],
             score) = pretrain_step(tc, layer, name, self.params[name],
                                    self.updater_state[name], it, h,
                                    fold_in(tc.seed, it))
            self.score_value = score
            it += 1
        self._pretrain_counts[layer_idx] = it

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def output(self, x, train: bool = False) -> Tensor:
        """Final-layer activations."""
        h, _, _, _ = self._forward(self.params, self.state,
                                   self._tensor(x), train=train, key=None,
                                   mask=None)
        return h

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[Tensor]:
        """All layer activations."""
        acts, _, _, _ = self._forward(self.params, self.state,
                                      self._tensor(x), train=train,
                                      key=None, mask=None, collect=True)
        return acts

    @torch.no_grad()
    def score(self, x, y=None, mask=None) -> float:
        """Mean score on a dataset/batch, in inference mode."""
        if y is None:
            feats, labs, _, lm = _unpack_batch(x)
            return self.score(feats, labs, lm)
        s, _ = self._loss_fn(self.params, self.state, self._tensor(x),
                             self._tensor(y), None,
                             None if mask is None else self._tensor(mask),
                             train=False)
        return float(s)

    @torch.no_grad()
    def feed_forward_to_layer(self, layer_idx: int, x,
                              train: bool = False) -> List[Tensor]:
        """Activations of layers [0..layer_idx] only; the layers beyond
        are not run."""
        h = self._cast_in(self._tensor(x))
        acts = []
        for i, layer in enumerate(self.layers[:layer_idx + 1]):
            name = self.layer_names[i]
            pp = self.conf.input_preprocessors.get(str(i))
            if pp is not None:
                h = pp.pre_process(h)
            h, _ = layer.apply(self.params[name], self.state.get(name, {}),
                               h, train=train)
            acts.append(h)
        return acts

    def predict(self, x) -> np.ndarray:
        """Predicted class index per example."""
        return self.output(x).float().cpu().numpy().argmax(axis=-1)

    def label_probabilities(self, x) -> Tensor:
        return self.output(x)

    def num_labels(self) -> int:
        """Output dimension (a LossLayer's: the layer below's n_out)."""
        n = getattr(self.layers[-1], "n_out", None)
        if n is not None:
            return int(n)
        for layer in reversed(self.layers[:-1]):
            n = getattr(layer, "n_out", None)
            if n is not None:
                return int(n)
        raise ValueError("cannot infer label count: no layer declares "
                         "n_out")

    def f1_score(self, x, y) -> float:
        """Macro F1 on one batch."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        ev = Evaluation()
        ev.eval(y, self.output(x))
        return ev.f1()

    @torch.no_grad()
    def score_examples(self, x, y, add_regularization_terms: bool = True
                       ) -> np.ndarray:
        """Per-example scores (inference mode); the regularization term is
        in each unless ``add_regularization_terms`` is False."""
        x = self._tensor(x)
        y = self._tensor(y)
        per = [self._loss_fn(self.params, self.state, x[i:i + 1],
                             y[i:i + 1], None, None, train=False)[0]
               for i in range(x.shape[0])]
        per = torch.stack(per)
        if not add_regularization_terms:
            per = per - self._regularization_score(self.params)
        return per.cpu().numpy()

    def summary(self) -> str:
        """Printable per-layer table."""
        from deeplearning4j_tpu_torch.common import (count_params,
                                                     render_summary_table)
        rows = [("idx", "name", "type", "n_params")]
        total = 0
        for i, layer in enumerate(self.layers):
            name = self.layer_names[i]
            n = count_params(self.params.get(name, {}))
            total += n
            rows.append((str(i), name, type(layer).__name__, f"{n:,}"))
        return render_summary_table(rows, total)

    def _run_evaluation(self, iterator, ev):
        """Feed every batch's predictions into an evaluation."""
        for batch in iterator:
            feats, labs, _, lmask = _unpack_batch(batch)
            ev.eval(labs, self.output(feats), mask=lmask)
        if hasattr(iterator, "reset"):
            iterator.reset()
        return ev

    def evaluate(self, iterator):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._run_evaluation(iterator, Evaluation())

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.eval.regression import \
            RegressionEvaluation
        return self._run_evaluation(iterator, RegressionEvaluation())

    def evaluate_roc(self, iterator, threshold_steps: int = 30):
        from deeplearning4j_tpu_torch.eval.roc import ROC
        return self._run_evaluation(iterator, ROC(threshold_steps))

    def evaluate_roc_multi_class(self, iterator,
                                 threshold_steps: int = 30):
        from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
        return self._run_evaluation(iterator, ROCMultiClass(threshold_steps))

    @torch.no_grad()
    def output_batched(self, xs) -> Tensor:
        """Inference over a pre-staged pool: ``xs`` [N, B, ...] ->
        activations [N, B, ...]; only the outputs are kept."""
        if not self._initialized:
            self.init()
        xs = self._tensor(xs)
        return torch.stack([self._forward(self.params, self.state, x,
                                          train=False, key=None,
                                          mask=None)[0] for x in xs])

    def evaluate_batched(self, xs, ys):
        """Evaluation over a pre-staged pool [N, B, ...]."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        out = self.output_batched(xs)
        ys = self._tensor(ys)
        ev = Evaluation()
        ev.eval(ys.reshape(-1, ys.shape[-1]),
                out.reshape(-1, out.shape[-1]))
        return ev

    # --------------------------------------------------------- rnn inference
    def rnn_get_previous_state(self, layer_idx: int):
        """Stored streaming state of one RNN layer."""
        if self._rnn_carries is None:
            return None
        return self._rnn_carries.get(self.layer_names[layer_idx])

    def rnn_set_previous_state(self, layer_idx: int, state) -> None:
        """Set one RNN layer's streaming state; on a cleared network the
        other streaming layers start from zero carries."""
        if self._rnn_carries is None:
            self._rnn_carries = self._init_carries(int(state[0].shape[0]))
        self._rnn_carries[self.layer_names[layer_idx]] = state

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    @torch.no_grad()
    def rnn_time_step(self, x) -> Tensor:
        """Stateful single/multi-step inference: [B, F] (one step) or
        [B, T, F]; the layers' (h, c) carry over to the next call."""
        for i, layer in enumerate(self.layers):
            if not getattr(layer, "supports_streaming", True):
                raise ValueError(
                    f"rnn_time_step unsupported: layer {i} "
                    f"({type(layer).__name__}) needs the full sequence")
        x = self._tensor(x)
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, :]
        if self._rnn_carries is None:
            self._rnn_carries = self._init_carries(x.shape[0])
        h, _, _, new_carries = self._forward(
            self.params, self.state, x, train=False, key=None, mask=None,
            carries=self._rnn_carries)
        self._rnn_carries.update(new_carries)
        return h[:, 0] if squeeze else h

    # ------------------------------------------------------------ flat views
    def params_flat(self) -> Tensor:
        """Flat parameter vector, in the JAX package's ravel_pytree order
        (layers, then parameters, by sorted name)."""
        return torch.cat([p.reshape(-1) for p in _leaves(self.params)])

    def set_params_flat(self, flat: Tensor) -> None:
        self.params = unravel_like(self.params, flat)

    def num_params(self) -> int:
        return sum(p.numel() for p in _leaves(self.params))

    def clone(self) -> "MultiLayerNetwork":
        """A network of a copy of this configuration holding copies of
        the parameters, state and updater state."""
        import copy
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device)
        net.params = _map(torch.clone, self.params)
        net.state = _map(torch.clone, self.state)
        net.updater_state = _map(torch.clone, self.updater_state)
        net.iteration_count = self.iteration_count
        net.epoch_count = self.epoch_count
        net.lstm_wavefront = self.lstm_wavefront
        net._initialized = self._initialized
        return net


def pretrain_step(tc, layer, name, params, opt_state, iteration, h, key):
    """One layerwise pretraining update of ``layer`` on its input
    activation ``h`` (detached): ``layer.pretrain_loss(params, h, key)``
    by autograd, then the updater: (params, opt state, score)."""
    def loss_fn(p):
        return layer.pretrain_loss(p[name], h, key), None
    score, _, grads = value_and_grad(loss_fn, {name: params})
    new_p, new_s = apply_updater(tc, {name: params}, grads,
                                 {name: opt_state}, iteration)
    return new_p[name], new_s[name], score


def unravel_like(tree, flat: Tensor):
    """The inverse of `params_flat`: ``flat`` cut into ``tree``'s leaves,
    in sorted-key order, each with its leaf's shape and dtype."""
    out, off = {}, 0
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            n = sum(p.numel() for p in _leaves(v))
            out[k] = unravel_like(v, flat[off:off + n])
        else:
            n = v.numel()
            out[k] = flat[off:off + n].reshape(v.shape).to(v.dtype)
        off += n
    return out


def _unpack_batch(batch):
    """Accept (x, y), (x, y, fmask, lmask), or DataSet-like objects."""
    if hasattr(batch, "features"):
        fmask = getattr(batch, "features_mask", None)
        lmask = getattr(batch, "labels_mask", None)
        if fmask is None:
            fmask = getattr(batch, "features_masks", None)
        if lmask is None:
            lmask = getattr(batch, "labels_masks", None)
        return (batch.features, getattr(batch, "labels", None),
                fmask, lmask)
    if isinstance(batch, (tuple, list)):
        if len(batch) == 2:
            return batch[0], batch[1], None, None
        if len(batch) == 4:
            return tuple(batch)
    raise ValueError(f"Cannot unpack batch of type {type(batch)}")

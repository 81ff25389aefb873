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

Not ported yet (each raises NotImplementedError): the second-order
Solver path, the TrainingGuard, layerwise pretraining and
`fit_batched_cost` (ROADMAP queue A9).
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


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A9: train/solvers.py, "
        "train/guard.py, pretraining, util/flops.py)")


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
        self.score_value: float = float("nan")
        self._rnn_carries: Optional[Dict[str, Any]] = None
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

    def set_training_guard(self, guard) -> None:
        raise _later("TrainingGuard")

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
        # every ported layer trains (FrozenLayer comes with nn/layers/misc)
        return {name: True for name in self.layer_names}

    def _value_and_grad(self, loss_fn, params):
        """(score, aux, grads) of ``loss_fn(params)`` by autograd; a
        parameter the loss does not reach gets a zero gradient."""
        leaves = _map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            score, aux = loss_fn(leaves)
        flat = _leaves(leaves)
        gs = torch.autograd.grad(score, flat, allow_unused=True)
        gs = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(flat, gs)])
        grads = {k: {pk: next(gs) for pk in sorted(leaves[k])}
                 for k in sorted(leaves)}
        return score.detach(), aux, grads

    def _step(self, params, state, opt_state, iteration, x, y, key, mask):
        """One minibatch update (the JAX package's `_step_math`)."""
        def loss_fn(p):
            return self._loss_fn(p, state, x, y, key, mask)
        score, new_state, grads = self._value_and_grad(loss_fn, params)
        new_params, new_opt = apply_updater(
            self.conf.training, params, grads, opt_state, iteration,
            lr_multipliers=self._lr_multipliers(),
            trainable=self._trainable())
        return new_params, new_state, new_opt, score

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

        score, (new_state, new_carries), grads = self._value_and_grad(
            loss_fn, params)
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

    def _notify_iteration(self, score) -> None:
        """Record the step's score and advance iteration_count (listeners
        are not ported: ROADMAP queue A9, train/listeners.py)."""
        self.score_value = score
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
        for batch in data:
            feats, labs, fmask, lmask = _unpack_batch(batch)
            self._fit_batch(feats, labs, lmask if lmask is not None
                            else fmask)
        self.epoch_count += 1
        if hasattr(data, "reset"):
            data.reset()

    def _fit_batch(self, x, y, mask=None) -> None:
        x = self._tensor(x)
        y = self._tensor(y)
        mask = None if mask is None else self._tensor(mask)
        if self.conf.training.optimization_algo not in _SGD:
            raise _later(f"optimization_algo="
                         f"{self.conf.training.optimization_algo!r} (the "
                         "Solver path)")
        if self.conf.backprop_type == "tbptt" and x.ndim == 3:
            self._fit_tbptt(x, y, mask)
            return
        for _ in range(max(1, self.conf.training.num_iterations)):
            key = fold_in(self.conf.training.seed, self.iteration_count)
            self.params, self.state, self.updater_state, score = self._step(
                self.params, self.state, self.updater_state,
                self.iteration_count, x, y, key, mask)
            self._notify_iteration(score)

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
            # score stays a device tensor: reading it would wait for the
            # card after every chunk
            self._notify_iteration(score)

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
        self.iteration_count = it
        self.score_value = float(scores[-1])
        return scores

    def fit_batched_cost(self, xs, ys, epochs: int = 1,
                         lstm_wavefront: Optional[bool] = None) -> dict:
        raise _later("fit_batched_cost (XLA cost analysis; a torch "
                     "counterpart is torch.utils.flop_counter)")

    def pretrain(self, data) -> None:
        raise _later("layerwise pretraining")

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

    # --------------------------------------------------------- rnn inference
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

    def num_params(self) -> int:
        return sum(p.numel() for p in _leaves(self.params))


def _unpack_batch(batch):
    """Accept (x, y), (x, y, fmask, lmask), or DataSet-like objects."""
    if hasattr(batch, "features"):
        fmask = getattr(batch, "features_mask", None)
        lmask = getattr(batch, "labels_mask", None)
        return (batch.features, getattr(batch, "labels", None),
                fmask, lmask)
    if isinstance(batch, (tuple, list)):
        if len(batch) == 2:
            return batch[0], batch[1], None, None
        if len(batch) == 4:
            return tuple(batch)
    raise ValueError(f"Cannot unpack batch of type {type(batch)}")

"""ComputationGraph, the DAG model (port of
deeplearning4j_tpu/nn/graph/computation_graph.py).

The graph holds its parameters as ``{vertex_name: {param: tensor}}`` on
one device (CUDA unless the caller passes ``device="cpu"``); a vertex
that is not a layer holds an empty dict, as in JAX. Vertices run in the
configuration's topological order. A minibatch step is the JAX
package's jitted step run eagerly: forward, the sum of every output's
loss, L1/L2, autograd backward, the updater. `fit_batched` is a host
loop over pool x epochs with the iteration, key and score semantics of
the JAX package's scanned programs (one update per minibatch, or per
TBPTT chunk with carries reset per minibatch, the scores returned as one
tensor).

Keys are integer seeds (`nn.layers.base.fold_in`): vertex ``i`` of the
topological order draws its dropout from ``fold_in(key, i)``, so the
units dropped are a function of (seed, iteration, vertex), the same on
the CPU and on the card. A recurrent layer vertex passes its input mask
on to the vertices it feeds. The graph has no LSTM wavefront: each
GravesLSTM vertex runs its own ``apply`` or ``scan_sequence``, which on
the card launches the fused LSTM-scan kernel once a sequence (a TBPTT
chunk, an `rnn_time_step` call); MultiHeadAttention and
TransformerBlock vertices launch the flash forward and backward.

The non-SGD optimization algorithms go through `train.solvers.Solver`
with input and label dicts; layerwise `pretrain` trains the AutoEncoder,
RBM and VariationalAutoencoder vertices in topological order, each on
the output of the frozen subgraph upstream of it.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.common import promote_score
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    infer_preprocessor
# registers the vertex classes, which a configuration's from_json needs
from deeplearning4j_tpu_torch.nn.graph import vertices  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.base import (Layer, apply_dropout,
                                                     fold_in)
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import (_SGD, _dtype_of,
                                                    _leaves, _map,
                                                    _unpack_batch,
                                                    pretrain_step,
                                                    unravel_like,
                                                    value_and_grad)
from deeplearning4j_tpu_torch.train.updaters import (apply_updater,
                                                     init_updater_state)

Tensor = torch.Tensor


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.device = resolve_device(device)
        self.conf = conf
        self.topo = conf.topological_order()
        self.dtype = _dtype_of(conf.training.dtype)
        self.params: Dict[str, Dict[str, Tensor]] = {}
        self.state: Dict[str, Dict[str, Tensor]] = {}
        self.updater_state: Dict[str, Any] = {}
        self.iteration_count = 0
        self.epoch_count = 0
        self.listeners: List[Any] = []
        self.score_value = float("nan")
        self._solver = None
        self._pretrain_counts: Dict[Any, int] = {}
        self._preprocessors: Dict[str, Any] = {}
        self._rnn_carries: Optional[Dict[str, Any]] = None
        self._initialized = False
        self._resolve_shapes()

    # ---------------------------------------------------------------- shapes
    def _resolve_shapes(self) -> None:
        """Propagate InputTypes through the topological order, set each
        layer's n_in and insert a preprocessor where the activation
        family changes. With no declared input types the layers carry
        their own n_in."""
        types: Dict[str, Any] = dict(self.conf.input_types)
        if not types:
            return
        for name in self.topo:
            spec = self.conf.vertices[name]
            v = spec.vertex
            in_types = [types[i] for i in spec.inputs if i in types]
            if not in_types:
                continue
            if isinstance(v, Layer):
                t = in_types[0]
                pre = infer_preprocessor(t, v.input_family)
                if pre is not None:
                    self._preprocessors[name] = pre
                    t = pre.output_type(t)
                types[name] = v.update_input_type(t)
            else:
                types[name] = v.output_type(in_types)
        self.resolved_types = types

    # ------------------------------------------------------------------ init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Initialize parameters: the layer at topological index i draws
        from a CPU `torch.Generator` seeded with fold_in(seed, i), so
        the same seed gives the same weights on every device."""
        seed = self.conf.training.seed if seed is None else seed
        for i, name in enumerate(self.topo):
            v = self.conf.vertices[name].vertex
            if isinstance(v, Layer):
                act = getattr(v, "activation", None)
                if isinstance(act, str):
                    get_activation(act)      # a typo'd name fails here
                gen = torch.Generator().manual_seed(fold_in(seed, i))
                self.params[name] = v.init_params(gen, self.dtype,
                                                  self.device)
                self.state[name] = v.init_state(self.dtype, self.device)
            else:
                self.params[name] = {}
                self.state[name] = {}
        self.updater_state = init_updater_state(self.conf.training,
                                                self.params)
        self._initialized = True
        return self

    def set_params_from_numpy(self, tree) -> None:
        """Take a JAX graph's ``{vertex: {param: array}}`` tree (numpy
        leaves) as this graph's parameters, cast to its dtype."""
        from deeplearning4j_tpu_torch.models.convert import \
            network_params_from_numpy
        if not self._initialized:
            self.init()
        self.params = network_params_from_numpy(tree, self.device,
                                                self.dtype)

    def set_updater_state_from_numpy(self, tree) -> None:
        """Take a JAX graph's updater-state tree (numpy leaves)."""
        from deeplearning4j_tpu_torch.models.convert import \
            updater_state_from_numpy
        if not self._initialized:
            self.init()
        self.updater_state = updater_state_from_numpy(tree, self.device)

    def set_state_from_numpy(self, tree) -> None:
        """Take a JAX graph's vertex-state tree (batch-norm running
        statistics), cast to this graph's dtype."""
        from deeplearning4j_tpu_torch.models.convert import \
            network_params_from_numpy
        if not self._initialized:
            self.init()
        self.state = network_params_from_numpy(tree, self.device,
                                               self.dtype)

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def _tensor(self, x):
        """An input (or a dict of them) on this graph's device; float64
        host arrays become float32, as jnp.asarray makes them."""
        if isinstance(x, dict):
            return {k: self._tensor(v) for k, v in x.items()}
        if not isinstance(x, Tensor):
            a = np.asarray(x)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            x = torch.from_numpy(np.ascontiguousarray(a))
        return x.to(self.device)

    def _as_input_dict(self, data, names) -> Dict[str, Tensor]:
        if isinstance(data, dict):
            return {k: self._tensor(v) for k, v in data.items()}
        if isinstance(data, (list, tuple)):
            return {n: self._tensor(d) for n, d in zip(names, data)}
        return {names[0]: self._tensor(data)}

    def _cast_inputs(self, inputs: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return {k: (v.to(self.dtype) if v.is_floating_point() else v)
                for k, v in inputs.items()}

    # --------------------------------------------------------------- forward
    def _apply_layer_vertex(self, v, name, params, state, h, *, train,
                            lkey, mask, carries, new_state, new_carries):
        """Run one Layer vertex: scan_sequence from the given carry when
        streaming / TBPTT, plain apply otherwise."""
        if carries is not None and name in carries \
                and hasattr(v, "scan_sequence"):
            h, carry = v.scan_sequence(params[name], h,
                                       carry=carries[name], mask=mask)
            new_carries[name] = carry
            new_state[name] = state.get(name, {})
        else:
            h, st = v.apply(params[name], state.get(name, {}), h,
                            train=train, key=lkey, mask=mask)
            new_state[name] = st
        return h

    def _walk(self, params, state, inputs, *, train, key, masks, carries,
              record_outputs):
        """The topological walk shared by `_forward` and
        `_forward_preout`: (values, output-layer inputs, new state, new
        carries)."""
        values: Dict[str, Tensor] = self._cast_inputs(inputs)
        new_state: Dict[str, Any] = {}
        new_carries: Dict[str, Any] = {}
        out_records: Dict[str, Tuple[Tensor, Optional[Tensor]]] = {}
        outputs = set(self.conf.network_outputs) if record_outputs \
            else set()
        for i, name in enumerate(self.topo):
            spec = self.conf.vertices[name]
            v = spec.vertex
            ins = [values[n] for n in spec.inputs]
            in_masks = [masks.get(n) for n in spec.inputs]
            if isinstance(v, Layer):
                h = ins[0]
                pre = self._preprocessors.get(name)
                if pre is not None:
                    h = pre.pre_process(h)
                lkey = fold_in(key, i) if key is not None else None
                if train and (v.dropout or 0.0) > 0 and lkey is not None:
                    h = apply_dropout(h, v.dropout, lkey)
                if name in outputs and hasattr(v, "loss"):
                    out_records[name] = (h, in_masks[0])
                h = self._apply_layer_vertex(
                    v, name, params, state, h, train=train, lkey=lkey,
                    mask=in_masks[0], carries=carries,
                    new_state=new_state, new_carries=new_carries)
                values[name] = h
                if in_masks[0] is not None and v.family == "rnn":
                    masks[name] = in_masks[0]
            else:
                values[name] = v.apply(ins, masks=in_masks)
                new_state[name] = state.get(name, {})
        return values, out_records, new_state, new_carries

    def _forward(self, params, state, inputs: Dict[str, Tensor], *,
                 train: bool, key: Optional[int],
                 masks: Optional[Dict[str, Tensor]] = None,
                 carries: Optional[Dict[str, Any]] = None):
        """Every vertex's activation: (values, new_state), or (values,
        new_state, new_carries) with ``carries``."""
        masks = masks if masks is not None else {}
        values, _, new_state, new_carries = self._walk(
            params, state, inputs, train=train, key=key, masks=masks,
            carries=carries, record_outputs=False)
        if carries is not None:
            return values, new_state, new_carries
        return values, new_state

    def _forward_preout(self, params, state, inputs, *, key, masks=None,
                        train=True, carries=None):
        """Forward in train mode recording each output layer's INPUT
        (and mask) for its loss. With ``carries`` (name -> RNN carry),
        recurrent layers run `scan_sequence` from the given state and the
        new carries are returned (the TBPTT / streaming path)."""
        _, out_records, new_state, new_carries = self._walk(
            params, state, inputs, train=train, key=key,
            masks=dict(masks or {}), carries=carries, record_outputs=True)
        for name in self.conf.network_outputs:
            if name not in out_records:
                raise ValueError(f"Output '{name}' is not a loss-bearing "
                                 f"layer")
        if carries is not None:
            return out_records, new_state, new_carries
        return out_records, new_state

    def _output_losses(self, params, out_records, labels) -> Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for out_name in self.conf.network_outputs:
            layer = self.conf.vertices[out_name].vertex
            h_in, mask = out_records[out_name]
            total = total + promote_score(layer.loss(
                params[out_name], h_in, labels[out_name], mask))
        return total + self._regularization_score(params)

    def _loss_fn(self, params, state, inputs, labels: Dict[str, Tensor],
                 key, masks=None, train=True):
        """The sum of every output's loss plus regularization, and the
        new state."""
        out_records, new_state = self._forward_preout(
            params, state, inputs, key=key, masks=masks, train=train)
        return self._output_losses(params, out_records, labels), new_state

    def _regularization_score(self, params) -> Tensor:
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for name in self.topo:
            v = self.conf.vertices[name].vertex
            if not isinstance(v, Layer):
                continue
            l1 = v.l1 or 0.0
            l2 = v.l2 or 0.0
            if (l1 == 0.0 and l2 == 0.0) or not params.get(name):
                continue
            for k in v.weight_param_keys():
                if k not in params[name]:
                    continue
                w = promote_score(params[name][k])
                if l2 > 0:
                    total = total + 0.5 * l2 * torch.sum(w * w)
                if l1 > 0:
                    total = total + l1 * torch.sum(torch.abs(w))
        return total

    # ------------------------------------------------------------------- fit
    def _lr_multipliers(self) -> Dict[str, float]:
        base = self.conf.training.learning_rate
        out = {}
        for name in self.topo:
            v = self.conf.vertices[name].vertex
            lr = getattr(v, "learning_rate", None)
            # explicit 0.0 is a valid per-layer LR (freezing)
            out[name] = (lr / base) if (lr is not None and base) else 1.0
        return out

    def _trainable(self) -> Dict[str, bool]:
        return {name: not isinstance(self.conf.vertices[name].vertex,
                                     FrozenLayer)
                for name in self.topo}

    def _step(self, params, state, opt_state, iteration, inputs, labels,
              key, masks):
        """One minibatch update: (params, state, opt state, score)."""
        def loss_fn(p):
            return self._loss_fn(p, state, inputs, labels, key, masks)
        score, new_state, grads = value_and_grad(loss_fn, params)
        new_params, new_opt = apply_updater(
            self.conf.training, params, grads, opt_state, iteration,
            lr_multipliers=self._lr_multipliers(),
            trainable=self._trainable())
        return new_params, new_state, new_opt, score

    def _notify(self, score) -> None:
        self.score_value = score
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration_count, score)
        self.iteration_count += 1

    def fit_batched(self, feats, labs, epochs: int = 1) -> Tensor:
        """Train on a pre-staged stack of minibatches: ``feats`` /
        ``labs`` take the shapes fit() accepts (one array, a list per
        input / output, or a name -> array dict) with an extra leading
        [N] batches axis; returns the per-step scores [N * epochs] (one
        tensor on the device).

        With backprop_type='tbptt' and temporal labels ([N, B, T, C]
        everywhere), each minibatch walks its time chunks with carried
        RNN state and one update per chunk, so scores (and iteration
        counts) are per CHUNK: [N * T/L * epochs]. Non-temporal labels
        fall through to standard BPTT, as in fit()."""
        self._validate_fit_batched(epochs)
        inputs = self._as_input_dict(feats, self.conf.network_inputs)
        labels = self._as_input_dict(labs, self.conf.network_outputs)
        use_tbptt = (self.conf.backprop_type == "tbptt"
                     and all(v.ndim == 4 for v in labels.values()))
        L = self.conf.tbptt_fwd_length
        first = next(iter(inputs.values()))
        if use_tbptt:
            t_in = first.shape[2]
            for k, v in list(inputs.items()) + list(labels.items()):
                if v.ndim != 4:
                    raise ValueError(
                        f"tbptt fit_batched needs [N, B, T, F] arrays; "
                        f"{k!r} has ndim={v.ndim}")
                if v.shape[2] != t_in:
                    raise ValueError(
                        f"tbptt fit_batched needs one sequence length; "
                        f"{k!r} has T={v.shape[2]} vs {t_in}")
            if t_in % L:
                raise ValueError(
                    f"tbptt fit_batched needs T ({t_in}) divisible by "
                    f"tbptt_fwd_length ({L}); use fit() for ragged tails")
        seed = self.conf.training.seed
        it = self.iteration_count
        scores = []
        for _ in range(epochs):
            for n in range(first.shape[0]):
                x = {k: v[n] for k, v in inputs.items()}
                y = {k: v[n] for k, v in labels.items()}
                if not use_tbptt:
                    (self.params, self.state, self.updater_state,
                     score) = self._step(self.params, self.state,
                                         self.updater_state, it, x, y,
                                         fold_in(seed, it), None)
                    scores.append(score)
                    it += 1
                    continue
                carries = self._init_carries(first.shape[1])
                for c in range(first.shape[2] // L):
                    sl = slice(c * L, (c + 1) * L)
                    (self.params, self.state, self.updater_state, carries,
                     score) = self._tbptt_chunk(
                        self.params, self.state, self.updater_state, it,
                        _time_slice(x, sl), _time_slice(y, sl), carries,
                        fold_in(seed, it), None)
                    scores.append(score)
                    it += 1
        scores = torch.stack(scores)
        if not self.listeners:
            self.iteration_count = it
            self.score_value = float(scores[-1])
            return scores
        # listeners fire after the run, as after JAX's one program
        for sc in scores.tolist():
            self._notify(sc)
        return scores

    def _validate_fit_batched(self, epochs: int) -> None:
        if not self._initialized:
            self.init()
        tc = self.conf.training
        if tc.optimization_algo not in _SGD:
            raise ValueError(
                "fit_batched supports first-order optimization only; "
                f"optimization_algo={tc.optimization_algo!r} dispatches "
                "to the Solver path — use fit() instead")
        if epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")

    def fit(self, data, labels=None, masks=None) -> None:
        """Train on a (Multi)DataSet iterator or on arrays (one per
        input, a list, or a name -> array dict)."""
        if not self._initialized:
            self.init()
        if labels is not None:
            self._fit_batch(data, labels, masks)
            return
        for batch in data:
            feats, labs, fmask, lmask = _unpack_batch(batch)
            self._fit_batch(feats, labs, lmask)
        self.epoch_count += 1
        if hasattr(data, "reset"):
            data.reset()

    def _fit_batch(self, feats, labs, masks=None) -> None:
        inputs = self._as_input_dict(feats, self.conf.network_inputs)
        labels = self._as_input_dict(labs, self.conf.network_outputs)
        mask_dict = None
        if masks is not None:
            mask_dict = self._as_input_dict(masks, self.conf.network_inputs)
        algo = self.conf.training.optimization_algo
        first_order = algo in _SGD
        if self.conf.backprop_type == "tbptt" and all(
                v.ndim == 3 for v in inputs.values()) and all(
                v.ndim == 3 for v in labels.values()):
            # TBPTT needs temporal labels to slice; 2-D labels (through
            # LastTimeStepVertex) fall through to standard BPTT
            if not first_order:
                raise ValueError(
                    "TBPTT supports first-order optimization only — "
                    f"optimization_algo={algo!r}")
            self._fit_tbptt(inputs, labels, mask_dict)
            return
        if not first_order:
            # the second-order path: LBFGS / CG / line gradient descent
            from deeplearning4j_tpu_torch.train.solvers import Solver
            if self._solver is None:
                self._solver = Solver(self)
            self._solver.optimize(inputs, labels, mask_dict,
                                  iteration_callback=self._notify)
            return
        key = fold_in(self.conf.training.seed, self.iteration_count)
        self.params, self.state, self.updater_state, score = self._step(
            self.params, self.state, self.updater_state,
            self.iteration_count, inputs, labels, key, mask_dict)
        self._notify(score)

    # ------------------------------------------------------------- pretrain
    def pretrain(self, data) -> None:
        """Greedy layerwise unsupervised pretraining of the AutoEncoder,
        RBM and VAE vertices in topological order."""
        if not self._initialized:
            self.init()
        for name in self.topo:
            v = self.conf.vertices[name].vertex
            if isinstance(v, Layer) and v.is_pretrain_layer():
                self.pretrain_vertex(name, data)
                if hasattr(data, "reset"):
                    data.reset()

    def _vertex_input(self, name, up_params, up_state, inputs):
        """Forward through the upstream subgraph (inference mode, no
        gradient) to ``name``'s (preprocessed) input activation."""
        values = self._cast_inputs(inputs)
        for n in self.topo:
            spec = self.conf.vertices[n]
            if n == name:
                h = values[spec.inputs[0]]
                pre = self._preprocessors.get(n)
                return pre.pre_process(h) if pre is not None else h
            v = spec.vertex
            ins = [values[m] for m in spec.inputs if m in values]
            if not ins and not isinstance(v, Layer):
                continue
            if isinstance(v, Layer):
                h = ins[0]
                pre = self._preprocessors.get(n)
                if pre is not None:
                    h = pre.pre_process(h)
                h, _ = v.apply(up_params[n], up_state.get(n, {}), h,
                               train=False)
                values[n] = h
            else:
                values[n] = v.apply(ins, masks=[None] * len(ins))
        raise ValueError(f"vertex '{name}' not reached in topo order")

    def pretrain_vertex(self, name: str, data) -> None:
        layer = self.conf.vertices[name].vertex
        if not (isinstance(layer, Layer) and layer.is_pretrain_layer()):
            return
        tc = self.conf.training
        upstream = self.topo[:self.topo.index(name)]
        up_params = {n: self.params[n] for n in upstream}
        up_state = {n: self.state.get(n, {}) for n in upstream}
        it = self._pretrain_counts.get(name, 0)
        batches = data if not hasattr(data, "__array__") else [(data, None)]
        for batch in batches:
            feats, _, _, _ = _unpack_batch(batch)
            inputs = self._as_input_dict(feats, self.conf.network_inputs)
            key = fold_in(tc.seed, it)
            with torch.no_grad():
                h = self._vertex_input(name, up_params, up_state, inputs)
            (self.params[name], self.updater_state[name],
             score) = pretrain_step(tc, layer, name, self.params[name],
                                    self.updater_state[name], it, h, key)
            self.score_value = score
            it += 1
        self._pretrain_counts[name] = it

    # --------------------------------------------------------------- tbptt
    def _init_carries(self, batch: int) -> Dict[str, Any]:
        carries = {}
        for name in self.topo:
            v = self.conf.vertices[name].vertex
            if isinstance(v, Layer) and hasattr(v, "initial_carry") \
                    and getattr(v, "supports_streaming", True):
                carries[name] = v.initial_carry(batch, self.dtype,
                                                self.device)
        return carries

    def _tbptt_chunk(self, params, state, opt_state, iteration, inputs,
                     labels, carries, key, masks):
        """One forward over a time chunk from the carried (detached) RNN
        state, one optimizer step: (params, state, opt state, carries,
        score)."""
        def loss_fn(p):
            out_records, new_state, new_carries = self._forward_preout(
                p, state, inputs, key=key, masks=masks, train=True,
                carries=carries)
            new_carries = {k: tuple(c.detach() for c in v)
                           for k, v in new_carries.items()}
            return (self._output_losses(p, out_records, labels),
                    (new_state, new_carries))

        score, (new_state, new_carries), grads = value_and_grad(loss_fn,
                                                                params)
        new_params, new_opt = apply_updater(
            self.conf.training, params, grads, opt_state, iteration,
            lr_multipliers=self._lr_multipliers(),
            trainable=self._trainable())
        return new_params, new_state, new_opt, new_carries, score

    def _fit_tbptt(self, inputs: Dict[str, Tensor],
                   labels: Dict[str, Tensor], masks=None) -> None:
        """Truncated BPTT over the DAG: chunk the time axis, carry RNN
        state (detached) across chunks, one update per chunk."""
        first = next(iter(inputs.values()))
        T = first.shape[1]
        L = self.conf.tbptt_fwd_length
        carries = self._init_carries(first.shape[0])
        for c in range(math.ceil(T / L)):
            sl = slice(c * L, min((c + 1) * L, T))
            key = fold_in(self.conf.training.seed, self.iteration_count)
            (self.params, self.state, self.updater_state, carries,
             score) = self._tbptt_chunk(
                self.params, self.state, self.updater_state,
                self.iteration_count, _time_slice(inputs, sl),
                _time_slice(labels, sl), carries, key,
                None if masks is None else _time_slice(masks, sl))
            self._notify(score)

    # ----------------------------------------------------------- streaming
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    @torch.no_grad()
    def rnn_time_step(self, *data) -> List[Tensor]:
        """Stateful single / multi-step inference over the DAG: each
        input [B, F] (one step) or [B, T, F]; the recurrent vertices'
        (h, c) carry over to the next call."""
        for name in self.topo:
            v = self.conf.vertices[name].vertex
            if isinstance(v, Layer) and hasattr(v, "initial_carry") \
                    and not getattr(v, "supports_streaming", True):
                raise ValueError(
                    f"rnn_time_step unsupported: vertex '{name}' "
                    f"({type(v).__name__}) needs the full sequence")
        inputs = self._inputs_of(data)
        squeeze = next(iter(inputs.values())).ndim == 2
        if squeeze:
            inputs = {k: v[:, None, :] for k, v in inputs.items()}
        batch = next(iter(inputs.values())).shape[0]
        if self._rnn_carries is None:
            self._rnn_carries = self._init_carries(batch)
        values, _, new_carries = self._forward(
            self.params, self.state, inputs, train=False, key=None,
            carries=self._rnn_carries)
        self._rnn_carries.update(new_carries)
        outs = [values[n] for n in self.conf.network_outputs]
        return [o[:, 0] if squeeze else o for o in outs]

    # ------------------------------------------------------------- inference
    def _inputs_of(self, data) -> Dict[str, Tensor]:
        if len(data) == 1:
            return self._as_input_dict(data[0], self.conf.network_inputs)
        return self._as_input_dict(list(data), self.conf.network_inputs)

    @torch.no_grad()
    def output(self, *data, train: bool = False) -> List[Tensor]:
        """Output activations for each configured output."""
        values, _ = self._forward(self.params, self.state,
                                  self._inputs_of(data), train=train,
                                  key=None)
        return [values[n] for n in self.conf.network_outputs]

    @torch.no_grad()
    def output_batched(self, feats) -> List[Tensor]:
        """Inference over a pre-staged pool: inputs with a leading [N]
        batches axis -> per-output activations [N, B, ...]."""
        if not self._initialized:
            self.init()
        inputs = self._as_input_dict(feats, self.conf.network_inputs)
        n = next(iter(inputs.values())).shape[0]
        outs = []
        for i in range(n):
            values, _ = self._forward(self.params, self.state,
                                      {k: v[i] for k, v in inputs.items()},
                                      train=False, key=None)
            outs.append([values[o] for o in self.conf.network_outputs])
        return [torch.stack([o[j] for o in outs])
                for j in range(len(self.conf.network_outputs))]

    def evaluate_batched(self, feats, labs):
        """Evaluation over a pre-staged pool, on the FIRST output."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        out = self.output_batched(feats)[0]
        if isinstance(labs, dict):
            ys = labs[self.conf.network_outputs[0]]
        elif isinstance(labs, (list, tuple)):
            ys = labs[0]
        else:
            ys = labs
        ys = self._tensor(ys)
        ev = Evaluation()
        ev.eval(ys.reshape(-1, ys.shape[-1]),
                out.reshape(-1, out.shape[-1]))
        return ev

    @torch.no_grad()
    def feed_forward(self, data, train: bool = False) -> Dict[str, Tensor]:
        inputs = self._as_input_dict(data, self.conf.network_inputs)
        values, _ = self._forward(self.params, self.state, inputs,
                                  train=train, key=None)
        return values

    @torch.no_grad()
    def score(self, feats, labs=None, masks=None) -> float:
        if labs is None:
            f, l, fm, lm = _unpack_batch(feats)
            return self.score(f, l, lm)
        inputs = self._as_input_dict(feats, self.conf.network_inputs)
        labels = self._as_input_dict(labs, self.conf.network_outputs)
        s, _ = self._loss_fn(self.params, self.state, inputs, labels, None,
                             None if masks is None else
                             self._as_input_dict(masks,
                                                 self.conf.network_inputs),
                             train=False)
        return float(s)

    def _run_evaluation(self, iterator, ev):
        """Feed the FIRST output's predictions into an evaluation."""
        first = self.conf.network_outputs[0]
        for batch in iterator:
            feats, labs, _, lmask = _unpack_batch(batch)
            out = self.output(feats)
            labs_d = self._as_input_dict(labs, self.conf.network_outputs)
            if isinstance(lmask, (list, tuple)):
                # MultiDataSet: per-output masks; output 0's
                lmask = lmask[0]
            ev.eval(labs_d[first], out[0], mask=lmask)
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

    # ------------------------------------------------------------ flat views
    def params_flat(self) -> Tensor:
        """Flat parameter vector in the JAX package's ravel_pytree order
        (vertices, then parameters, by sorted name)."""
        return torch.cat([p.reshape(-1) for p in _leaves(self.params)])

    def set_params_flat(self, flat: Tensor) -> None:
        self.params = unravel_like(self.params, self._tensor(flat))

    def num_params(self) -> int:
        return sum(p.numel() for p in _leaves(self.params))

    def clone(self) -> "ComputationGraph":
        """A graph of a copy of this configuration holding copies of the
        parameters, state and updater state."""
        net = ComputationGraph(copy.deepcopy(self.conf), device=self.device)
        net.params = _map(torch.clone, self.params)
        net.state = _map(torch.clone, self.state)
        net.updater_state = _map(torch.clone, self.updater_state)
        net._initialized = self._initialized
        return net

    # --------------------------------------------------- classifier surface
    def predict(self, *data) -> np.ndarray:
        """Predicted class index per example on output 0."""
        return self.output(*data)[0].float().cpu().numpy().argmax(axis=-1)

    def f1_score(self, feats, labs) -> float:
        """Macro F1 on output 0 for one batch."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        labs_d = self._as_input_dict(labs, self.conf.network_outputs)
        ev = Evaluation()
        ev.eval(labs_d[self.conf.network_outputs[0]],
                self.output(feats)[0])
        return ev.f1()

    @torch.no_grad()
    def score_examples(self, feats, labs, masks=None,
                       add_regularization_terms: bool = True
                       ) -> np.ndarray:
        """Per-example scores (inference mode), summed over all outputs
        as score() sums them; masks exclude padded steps as in score()."""
        inputs = self._as_input_dict(feats, self.conf.network_inputs)
        labels = self._as_input_dict(labs, self.conf.network_outputs)
        mask_d = None if masks is None else self._as_input_dict(
            masks, self.conf.network_inputs)
        n = next(iter(inputs.values())).shape[0]

        def one(d, i):
            return None if d is None else {k: v[i:i + 1]
                                           for k, v in d.items()}
        per = torch.stack([
            self._loss_fn(self.params, self.state, one(inputs, i),
                          one(labels, i), None, one(mask_d, i),
                          train=False)[0] for i in range(n)])
        if not add_regularization_terms:
            per = per - self._regularization_score(self.params)
        return per.cpu().numpy()

    def summary(self) -> str:
        """Printable per-vertex table in topological order."""
        from deeplearning4j_tpu_torch.common import (count_params,
                                                     render_summary_table)
        rows = [("name", "type", "inputs", "n_params")]
        total = 0
        for name in self.topo:
            spec = self.conf.vertices[name]
            n = count_params(self.params.get(name, {}))
            total += n
            rows.append((name, type(spec.vertex).__name__,
                         ",".join(spec.inputs) or "-", f"{n:,}"))
        return render_summary_table(rows, total)


def _time_slice(d: Dict[str, Tensor], sl: slice) -> Dict[str, Tensor]:
    return {k: v[:, sl] for k, v in d.items()}


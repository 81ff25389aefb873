"""Transfer learning: clone and modify trained networks (port of
deeplearning4j_tpu/nn/transferlearning.py).

Freeze everything at or below a layer (`FrozenLayer`: the updater's
trainability mask skips it, and it runs in inference mode), replace
output heads with re-initialized layers (the port's own seeded init),
override training hyperparameters, and featurize-and-cache the frozen
part so only the unfrozen tail trains (`TransferLearningHelper`). The
new network lives on the source's device and holds copies of the
retained tensors.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import (MultiLayerNetwork,
                                                    _map)
from deeplearning4j_tpu_torch.train.updaters import init_updater_state


def _copy(tree):
    return _map(torch.clone, tree)

@dataclass
class FineTuneConfiguration:
    """Training-hyperparameter overrides applied to the cloned network
    (reference: FineTuneConfiguration.java — only non-None fields apply)."""
    learning_rate: Optional[float] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    seed: Optional[int] = None
    dropout: Optional[float] = None
    lr_policy: Optional[str] = None
    lr_policy_decay_rate: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None

    def apply_to(self, conf) -> None:
        tc = conf.training
        for name in ("learning_rate", "updater", "momentum", "l1", "l2",
                     "seed", "lr_policy", "lr_policy_decay_rate",
                     "gradient_normalization",
                     "gradient_normalization_threshold"):
            v = getattr(self, name)
            if v is not None:
                setattr(tc, name, v)
        if hasattr(conf, "vertices"):  # ComputationGraphConfiguration
            layers = [s.vertex for s in conf.vertices.values()
                      if isinstance(s.vertex, Layer)]
        else:
            layers = conf.layers
        for layer in layers:
            inner = layer.inner if isinstance(layer, FrozenLayer) else layer
            if self.learning_rate is not None:
                inner.learning_rate = self.learning_rate
                inner.bias_learning_rate = self.learning_rate
            if self.dropout is not None:
                inner.dropout = self.dropout
            if self.l1 is not None:
                inner.l1 = self.l1
            if self.l2 is not None:
                inner.l2 = self.l2


class TransferLearning:
    """Namespace matching the reference's outer class."""

    class Builder:
        """reference: TransferLearning.Builder."""

        def __init__(self, net: MultiLayerNetwork):
            if not net._initialized:
                raise ValueError("source network must be initialized")
            self._net = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._nout_replace: Dict[int, tuple] = {}
            self._remove_count = 0
            self._appended: List[Layer] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                    ) -> "TransferLearning.Builder":
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_idx: int
                                  ) -> "TransferLearning.Builder":
            """Freeze layers [0..layer_idx] (reference:
            setFeatureExtractor:86)."""
            self._freeze_until = layer_idx
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: str = "xavier"
                          ) -> "TransferLearning.Builder":
            """Replace layer's n_out and re-init it + the next layer's n_in
            (reference: nOutReplace:100)."""
            self._nout_replace[layer_idx] = (n_out, weight_init)
            return self

        def remove_output_layer(self) -> "TransferLearning.Builder":
            self._remove_count += 1
            return self

        def remove_layers_from_output(self, n: int
                                      ) -> "TransferLearning.Builder":
            self._remove_count += n
            return self

        def add_layer(self, layer: Layer) -> "TransferLearning.Builder":
            self._appended.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._net
            conf = copy.deepcopy(src.conf)
            params = _copy(src.params)
            state = _copy(src.state)
            n = len(conf.layers)
            if self._remove_count:
                if self._remove_count >= n:
                    raise ValueError("cannot remove every layer")
                for i in range(n - self._remove_count, n):
                    params.pop(src.layer_names[i], None)
                    state.pop(src.layer_names[i], None)
                    conf.input_preprocessors.pop(str(i), None)
                conf.layers = conf.layers[:n - self._remove_count]

            reinit: List[int] = []
            for idx, (n_out, w_init) in sorted(self._nout_replace.items()):
                if idx >= len(conf.layers):
                    raise ValueError(f"n_out_replace index {idx} out of "
                                     f"range ({len(conf.layers)} layers)")
                layer = conf.layers[idx]
                inner = layer.inner if isinstance(layer, FrozenLayer) \
                    else layer
                inner.n_out = n_out
                inner.weight_init = w_init
                reinit.append(idx)
                if idx + 1 < len(conf.layers):
                    nxt = conf.layers[idx + 1]
                    ninner = nxt.inner if isinstance(nxt, FrozenLayer) \
                        else nxt
                    if getattr(ninner, "n_in", None) is not None:
                        ninner.n_in = n_out
                    reinit.append(idx + 1)

            for layer in self._appended:
                conf.layers.append(copy.deepcopy(layer))
                reinit.append(len(conf.layers) - 1)

            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1,
                                   len(conf.layers))):
                    if not isinstance(conf.layers[i], FrozenLayer):
                        conf.layers[i] = FrozenLayer(
                            inner=conf.layers[i],
                            name=conf.layers[i].name)

            if self._fine_tune is not None:
                self._fine_tune.apply_to(conf)

            # re-run shape inference from scratch over the modified topology
            conf._shapes_resolved = False
            for i in range(len(conf.layers)):
                layer = conf.layers[i]
                inner = layer.inner if isinstance(layer, FrozenLayer) \
                    else layer
                if i in reinit and getattr(inner, "n_in", None) is not None \
                        and i > 0:
                    inner.n_in = None  # re-infer from upstream
            new_net = MultiLayerNetwork(conf, device=src.device)
            new_net.init(seed=conf.training.seed)
            # copy retained params over the fresh init (reinit'd layers and
            # appended layers keep their new random weights)
            for i in range(len(conf.layers)):
                name = new_net.layer_names[i]
                if i in reinit:
                    continue
                if name in params:
                    new_net.params[name] = params[name]
                if name in state:
                    new_net.state[name] = state[name]
            return new_net


class _GraphBuilder:
    """Transfer learning over a ComputationGraph (reference:
    TransferLearning.GraphBuilder — setFeatureExtractor(vertexName)
    freezes the named vertices and everything upstream; nOutReplace,
    removeVertexAndConnections, addLayer, setOutputs)."""

    def __init__(self, graph):
        if not graph._initialized:
            raise ValueError("source graph must be initialized")
        self._graph = graph
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_at: List[str] = []
        self._nout_replace: Dict[str, tuple] = {}
        self._removed: List[str] = []
        self._added: List[tuple] = []
        self._new_outputs: Optional[List[str]] = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration
                                ) -> "_GraphBuilder":
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, *vertex_names: str) -> "_GraphBuilder":
        self._freeze_at.extend(vertex_names)
        return self

    def n_out_replace(self, vertex_name: str, n_out: int,
                      weight_init: str = "xavier") -> "_GraphBuilder":
        self._nout_replace[vertex_name] = (n_out, weight_init)
        return self

    def remove_vertex_and_connections(self, name: str) -> "_GraphBuilder":
        self._removed.append(name)
        return self

    def add_layer(self, name: str, layer: Layer,
                  *inputs: str) -> "_GraphBuilder":
        self._added.append((name, layer, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "_GraphBuilder":
        self._new_outputs = list(names)
        return self

    def _upstream_closure(self, conf, names: List[str]) -> set:
        out = set()
        stack = list(names)
        while stack:
            n = stack.pop()
            if n in out or n not in conf.vertices:
                continue
            out.add(n)
            stack.extend(conf.vertices[n].inputs)
        return out

    def build(self):
        from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
            ComputationGraph
        src = self._graph
        conf = copy.deepcopy(src.conf)
        params = _copy(src.params)
        state = _copy(src.state)
        reinit: set = set()

        for name in self._removed:
            if name not in conf.vertices:
                raise ValueError(f"unknown vertex '{name}'")
            del conf.vertices[name]
            params.pop(name, None)
            state.pop(name, None)
            conf.network_outputs = [o for o in conf.network_outputs
                                    if o != name]
            # strip the edges too (reference: removeVertexAndConnections)
            for spec in conf.vertices.values():
                spec.inputs = [i for i in spec.inputs if i != name]

        for name, (n_out, w_init) in self._nout_replace.items():
            if name not in conf.vertices:
                raise ValueError(f"unknown vertex '{name}'")
            v = conf.vertices[name].vertex
            inner = v.inner if isinstance(v, FrozenLayer) else v
            inner.n_out = n_out
            inner.weight_init = w_init
            reinit.add(name)
            for cname, spec in conf.vertices.items():
                if name in spec.inputs and isinstance(spec.vertex, Layer):
                    cv = spec.vertex
                    cinner = cv.inner if isinstance(cv, FrozenLayer) else cv
                    if getattr(cinner, "n_in", None) is not None:
                        cinner.n_in = n_out
                    reinit.add(cname)

        for name, layer, inputs in self._added:
            from deeplearning4j_tpu_torch.nn.conf.configuration import \
                GraphVertexSpec
            conf.vertices[name] = GraphVertexSpec(
                vertex=copy.deepcopy(layer), inputs=inputs)
            conf.vertices[name].vertex.name = name
            reinit.add(name)

        if self._new_outputs is not None:
            conf.network_outputs = list(self._new_outputs)

        if self._freeze_at:
            for name in self._upstream_closure(conf, self._freeze_at):
                spec = conf.vertices.get(name)
                if spec is not None and isinstance(spec.vertex, Layer) \
                        and not isinstance(spec.vertex, FrozenLayer):
                    spec.vertex = FrozenLayer(inner=spec.vertex,
                                              name=spec.vertex.name)

        if self._fine_tune is not None:
            self._fine_tune.apply_to(conf)

        for name, spec in conf.vertices.items():
            if not spec.inputs:
                raise ValueError(
                    f"vertex '{name}' has no inputs after transfer "
                    "surgery — rewire it (add_layer/remove it) before "
                    "build()")
        conf.topological_order()  # validate the rewired DAG
        new_graph = ComputationGraph(conf, device=src.device).init(
            seed=conf.training.seed)
        for name in conf.vertices:
            if name in reinit:
                continue
            if name in params:
                new_graph.params[name] = params[name]
            if name in state:
                new_graph.state[name] = state[name]
        return new_graph


TransferLearning.GraphBuilder = _GraphBuilder


class TransferLearningHelper:
    """Featurize-and-cache workflow (reference:
    TransferLearningHelper.java): split the network at the last frozen
    layer; `featurize` runs the frozen prefix, `fit_featurized` trains only
    the unfrozen tail on cached features."""

    def __init__(self, net: MultiLayerNetwork,
                 frozen_until: Optional[int] = None):
        if frozen_until is not None:
            net = (TransferLearning.Builder(net)
                   .set_feature_extractor(frozen_until).build())
        self.net = net
        self.frozen_until = -1
        for i, layer in enumerate(net.layers):
            if isinstance(layer, FrozenLayer):
                self.frozen_until = i
        if self.frozen_until < 0:
            raise ValueError("network has no frozen layers")
        # built once: keeps the tail's updater state (Adam moments) alive
        # across fit_featurized calls
        self._tail = self._build_tail()

    def featurize(self, x):
        """Activations at the frozen/unfrozen boundary."""
        acts = self.net.feed_forward(x, train=False)
        return acts[self.frozen_until]

    def unfrozen_graph(self) -> MultiLayerNetwork:
        """The standalone network over the unfrozen tail (shares param
        arrays with the composite net until the first fit)."""
        return self._tail

    def _build_tail(self) -> MultiLayerNetwork:
        conf = copy.deepcopy(self.net.conf)
        tail_layers = conf.layers[self.frozen_until + 1:]
        conf.layers = tail_layers
        conf.input_preprocessors = {
            str(int(k) - self.frozen_until - 1): v
            for k, v in conf.input_preprocessors.items()
            if int(k) > self.frozen_until}
        conf.input_type = None
        conf._shapes_resolved = True  # shapes already resolved in the parent
        tail = MultiLayerNetwork(conf, device=self.net.device)
        tail.params = {}
        tail.state = {}
        for j, i in enumerate(range(self.frozen_until + 1,
                                    len(self.net.layers))):
            src_name = self.net.layer_names[i]
            dst_name = tail.layer_names[j]
            tail.params[dst_name] = self.net.params[src_name]
            tail.state[dst_name] = self.net.state[src_name]
        tail.updater_state = init_updater_state(conf.training, tail.params)
        tail._initialized = True
        return tail

    def fit_featurized(self, features, labels) -> None:
        """Train the tail on featurized input, then write updated tail
        params back into the composite network."""
        self._tail.fit(features, labels)
        for j, i in enumerate(range(self.frozen_until + 1,
                                    len(self.net.layers))):
            src_name = self._tail.layer_names[j]
            dst_name = self.net.layer_names[i]
            self.net.params[dst_name] = self._tail.params[src_name]
            self.net.state[dst_name] = self._tail.state[src_name]

    def output_from_featurized(self, features):
        return self._tail.output(features)

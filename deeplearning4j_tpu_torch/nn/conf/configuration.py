"""Network configuration DSL (port of nn/conf/configuration.py).

Global hyperparameters with per-layer overrides, the sequential topology,
the DAG topology (`graph_builder` -> `GraphBuilder` ->
`ComputationGraphConfiguration`), InputType-driven shape inference with
automatic preprocessor insertion, and the JSON / YAML round trip. The
classes register under the JAX package's names with the same fields, so
`to_json` writes the same document and either package reads the other's.

Pythonic builder instead of Java's nested Builder classes::

    conf = (NeuralNetConfiguration(seed=12345, updater="adam",
                                   learning_rate=1e-3, weight_init="xavier")
            .list(DenseLayer(n_out=500, activation="relu"),
                  OutputLayer(n_out=10, activation="softmax",
                              loss_function="mcxent"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1)))
    net = MultiLayerNetwork(conf)

The configuration is pure metadata; `nn.multilayer.MultiLayerNetwork`
and `nn.graph.ComputationGraph` run it.
"""
from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.preprocessors import infer_preprocessor
from deeplearning4j_tpu_torch.nn.conf.serde import (from_dict, register,
                                                    to_dict)
from deeplearning4j_tpu_torch.nn.layers.base import Layer


@register
@dataclass
class TrainingConfig:
    """Global training hyperparameters (the reference's NeuralNetConfiguration
    scalar fields + Updater enum + LearningRatePolicy,
    NeuralNetConfiguration.java:73-170)."""
    seed: int = 12345
    optimization_algo: str = "stochastic_gradient_descent"
    updater: str = "sgd"
    learning_rate: float = 1e-1  # reference default, NeuralNetConfiguration.java:500
    bias_learning_rate: Optional[float] = None
    momentum: float = 0.5
    # adam / rmsprop / adadelta hyperparams (ND4J learning-pkg defaults)
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8
    rho: float = 0.95
    rms_decay: float = 0.95
    # lr schedule (reference: LearningRatePolicy enum + schedule map :106)
    lr_policy: str = "none"  # none|exponential|inverse|poly|sigmoid|step|schedule
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_schedule: Optional[Dict[str, float]] = None  # iteration -> lr
    # regularization + gradient treatment
    l1: float = 0.0
    l2: float = 0.0
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    minimize: bool = True
    max_num_line_search_iterations: int = 5
    num_iterations: int = 1  # reference: fits each minibatch N times
    dtype: str = "float32"


class NeuralNetConfiguration:
    """Entry-point builder. Keyword args cover the reference Builder's
    methods; extra layer-default fields (activation, weight_init, dropout,
    dist) are applied to layers that leave them unset."""

    def __init__(self, *, seed: int = 12345, activation: str = "sigmoid",
                 weight_init: str = "xavier", dist: Optional[dict] = None,
                 dropout: float = 0.0, **training_kwargs):
        self.training = TrainingConfig(seed=seed, **training_kwargs)
        self.default_activation = activation
        self.default_weight_init = weight_init
        self.default_dist = dist
        self.default_dropout = dropout

    # -- defaults ----------------------------------------------------------
    def _apply_defaults(self, layer: Layer) -> Layer:
        layer = copy.deepcopy(layer)
        if getattr(layer, "activation", "__missing__") is None:
            layer.activation = self.default_activation
        if getattr(layer, "weight_init", "__missing__") is None:
            layer.weight_init = self.default_weight_init
        if getattr(layer, "dist", "__missing__") is None:
            layer.dist = self.default_dist
        if layer.dropout is None:
            layer.dropout = self.default_dropout
        if layer.l1 is None:
            layer.l1 = self.training.l1
        if layer.l2 is None:
            layer.l2 = self.training.l2
        if layer.learning_rate is None:
            layer.learning_rate = self.training.learning_rate
        if layer.bias_learning_rate is None:
            layer.bias_learning_rate = (self.training.bias_learning_rate
                                        or layer.learning_rate)
        inner = getattr(layer, "inner", None)
        if inner is not None:
            layer.inner = self._apply_defaults(inner)
        return layer

    # -- sequential --------------------------------------------------------
    def list(self, *layers: Layer) -> "MultiLayerConfiguration":
        """Build a sequential configuration (reference: Builder.list() ->
        ListBuilder, NeuralNetConfiguration.java:206)."""
        resolved = [self._apply_defaults(l) for l in layers]
        return MultiLayerConfiguration(layers=resolved,
                                       training=copy.deepcopy(self.training))

    # -- DAG ---------------------------------------------------------------
    def graph_builder(self) -> "GraphBuilder":
        return GraphBuilder(self)


@register
@dataclass
class MultiLayerConfiguration:
    """Sequential network configuration (reference:
    nn/conf/MultiLayerConfiguration.java)."""
    layers: List[Layer] = field(default_factory=list)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    input_type: Optional[Any] = None
    input_preprocessors: Dict[str, Any] = field(default_factory=dict)
    backprop_type: str = "standard"  # 'standard' | 'tbptt'
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False
    _shapes_resolved: bool = False

    # -- fluent setters ----------------------------------------------------
    def set_input_type(self, input_type) -> "MultiLayerConfiguration":
        self.input_type = input_type
        return self

    def backprop_type_tbptt(self, fwd_length: int = 20,
                            back_length: int = 20
                            ) -> "MultiLayerConfiguration":
        self.backprop_type = "tbptt"
        self.tbptt_fwd_length = fwd_length
        self.tbptt_back_length = back_length
        return self

    def set_pretrain(self, pretrain: bool) -> "MultiLayerConfiguration":
        self.pretrain = pretrain
        return self

    def set_input_preprocessor(self, layer_index: int,
                               preproc) -> "MultiLayerConfiguration":
        self.input_preprocessors[str(layer_index)] = preproc
        return self

    # -- shape inference ---------------------------------------------------
    def resolve_shapes(self) -> None:
        """Walk the layers once: auto-insert preprocessors where the
        activation family changes, set each layer's n_in (reference:
        InputType propagation in MultiLayerConfiguration.Builder /
        InputTypeUtil)."""
        if self._shapes_resolved:
            return
        if self.input_type is None:
            # Reference behavior: setInputType is optional when the user sets
            # nIn on every layer (ListBuilder only auto-wires when an
            # InputType is given). Recover the initial InputType from the
            # first layer's declared n_in so downstream layers still chain.
            first = self.layers[0] if self.layers else None
            if first is not None and getattr(first, "inner", None) is not None:
                first = first.inner  # FrozenLayer-style wrappers
            n_in = getattr(first, "n_in", None)
            if first is None or n_in is None:
                raise ValueError(
                    "input_type must be set (set_input_type) or the first "
                    "layer must specify n_in explicitly")
            if first.input_family == "rnn":
                self.input_type = it.InputType.recurrent(n_in)
            elif first.input_family == "ff":
                self.input_type = it.InputType.feed_forward(n_in)
            else:
                raise ValueError(
                    "convolutional networks need set_input_type(...) — "
                    "kernel shape inference requires height/width/channels")
        current = self.input_type
        for i, layer in enumerate(self.layers):
            key = str(i)
            if key not in self.input_preprocessors:
                pre = infer_preprocessor(current, layer.input_family)
                if pre is not None:
                    self.input_preprocessors[key] = pre
            if key in self.input_preprocessors:
                current = self.input_preprocessors[key].output_type(current)
            current = layer.update_input_type(current)
        self._shapes_resolved = True

    def layer_name(self, i: int) -> str:
        return self.layers[i].name or f"layer_{i}"

    # -- serde -------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(to_dict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        obj = from_dict(json.loads(s))
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("JSON does not encode a MultiLayerConfiguration")
        return obj

    def to_yaml(self) -> str:
        """Reference: MultiLayerConfiguration.java:79 (toYaml)."""
        from deeplearning4j_tpu_torch.nn.conf.serde import to_yaml
        return to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.serde import from_yaml
        obj = from_yaml(s)
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("YAML does not encode a MultiLayerConfiguration")
        return obj


@register
@dataclass
class GraphVertexSpec:
    """One node in the DAG: a Layer or a GraphVertex plus its input names."""
    vertex: Any = None
    inputs: List[str] = field(default_factory=list)


@register
@dataclass
class ComputationGraphConfiguration:
    """DAG configuration (reference:
    nn/conf/ComputationGraphConfiguration.java + GraphBuilder)."""
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    vertices: Dict[str, GraphVertexSpec] = field(default_factory=dict)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    input_types: Dict[str, Any] = field(default_factory=dict)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    pretrain: bool = False

    def to_json(self) -> str:
        return json.dumps(to_dict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        obj = from_dict(json.loads(s))
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError(
                "JSON does not encode a ComputationGraphConfiguration")
        return obj

    def to_yaml(self) -> str:
        """Reference: ComputationGraphConfiguration toYaml (same dual
        format contract as MultiLayerConfiguration.java:79)."""
        from deeplearning4j_tpu_torch.nn.conf.serde import to_yaml
        return to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.serde import from_yaml
        obj = from_yaml(s)
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError(
                "YAML does not encode a ComputationGraphConfiguration")
        return obj

    def topological_order(self) -> List[str]:
        """Kahn's algorithm over vertex dependencies (reference:
        ComputationGraph.topologicalSortOrder(), ComputationGraph.java:888)."""
        indeg: Dict[str, int] = {}
        dependents: Dict[str, List[str]] = {}
        for name, spec in self.vertices.items():
            indeg[name] = 0
            for inp in spec.inputs:
                if inp in self.network_inputs:
                    continue
                indeg[name] += 1
                dependents.setdefault(inp, []).append(name)
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in dependents.get(n, []):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle involving {sorted(cyc)}")
        return order


class GraphBuilder:
    """Fluent DAG builder (reference:
    ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, nn_conf: NeuralNetConfiguration):
        self._nn = nn_conf
        self._conf = ComputationGraphConfiguration(
            training=copy.deepcopy(nn_conf.training))

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, **types) -> "GraphBuilder":
        self._conf.input_types.update(types)
        return self

    def add_layer(self, name: str, layer: Layer,
                  *inputs: str) -> "GraphBuilder":
        layer = self._nn._apply_defaults(layer)
        layer.name = name
        self._conf.vertices[name] = GraphVertexSpec(vertex=layer,
                                                    inputs=list(inputs))
        return self

    def add_vertex(self, name: str, vertex,
                   *inputs: str) -> "GraphBuilder":
        self._conf.vertices[name] = GraphVertexSpec(vertex=vertex,
                                                    inputs=list(inputs))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs.extend(names)
        return self

    def backprop_type_tbptt(self, fwd_length: int = 20,
                            back_length: int = 20) -> "GraphBuilder":
        self._conf.backprop_type = "tbptt"
        self._conf.tbptt_fwd_length = fwd_length
        self._conf.tbptt_back_length = back_length
        return self

    def build(self) -> ComputationGraphConfiguration:
        if not self._conf.network_inputs:
            raise ValueError("GraphBuilder: no inputs declared")
        if not self._conf.network_outputs:
            raise ValueError("GraphBuilder: no outputs declared")
        self._conf.topological_order()  # validates acyclicity + names
        return self._conf

"""Keras model import: HDF5 / JSON -> MultiLayerNetwork or ComputationGraph
(port of deeplearning4j_tpu/modelimport/keras.py).

The reference's deeplearning4j-modelimport module: the `KerasModelImport`
entry points, `KerasModel` / `KerasSequentialModel` and the per-layer
mappers (Dense, Convolution, Pooling, GlobalPooling, BatchNormalization,
Activation, Dropout, Embedding, Flatten, Input, Loss, Lstm, Merge,
ZeroPadding), for Keras 1 (`nb_filter`, `border_mode`, `dim_ordering`,
per-gate LSTM weights) and Keras 2 (`filters`, `padding`, fused gate
blocks) files.

Activations are NHWC, as in the JAX package: TensorFlow-Keras kernels
(HWIO) copy through unchanged, Keras-1 Theano kernels (OIHW) are permuted
once at import, and a Dense layer after a channels-first flatten has its
rows permuted from (C, H, W) to (H, W, C) order. Inference inputs are
NHWC.

HDF5 files are read by the port's own reader (`modelimport.hdf5`), not
h5py. Every entry point that builds a network takes ``device``: the
network lives on the card unless the caller passes ``device="cpu"``, and
each converted weight is copied onto the network's device in its dtype.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.nn.conf.configuration import (
    ComputationGraphConfiguration, MultiLayerConfiguration,
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
    CnnToFeedForwardPreProcessor
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.feedforward import (DenseLayer,
                                                            EmbeddingLayer)
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    Convolution1DLayer, ConvolutionLayer, Subsampling1DLayer,
    SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.layers.normalization import \
    BatchNormalization
from deeplearning4j_tpu_torch.nn.layers.misc import (ActivationLayer,
                                                     DropoutLayer,
                                                     GlobalPoolingLayer)
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
from deeplearning4j_tpu_torch.nn.graph.vertices import (ElementWiseVertex,
                                                        MergeVertex)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
    ComputationGraph


class InvalidKerasConfigurationException(ValueError):
    """Reference: exceptions/InvalidKerasConfigurationException.java."""


class UnsupportedKerasConfigurationException(ValueError):
    """Reference: exceptions/UnsupportedKerasConfigurationException.java."""


# ---------------------------------------------------------------------------
# activation / loss name mapping (reference: KerasLayer.mapActivation,
# KerasLossLayer loss mapping)
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "tanh": "tanh", "softmax": "softmax", "softplus": "softplus",
    "softsign": "softsign", "elu": "elu", "selu": "selu",
    "hard_sigmoid": "hardsigmoid", "leakyrelu": "leakyrelu",
    "leaky_relu": "leakyrelu", "gelu": "gelu", "swish": "swish",
}

_LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "mean_absolute_percentage_error": "mape", "mape": "mape",
    "mean_squared_logarithmic_error": "msle", "msle": "msle",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "kullback_leibler_divergence": "kl_divergence",
    "kld": "kl_divergence",
    "poisson": "poisson", "cosine_proximity": "cosine_proximity",
}


def map_activation(name: str) -> str:
    if name not in _ACTIVATIONS:
        raise UnsupportedKerasConfigurationException(
            f"Unknown Keras activation '{name}'")
    return _ACTIVATIONS[name]


def map_loss(name: str) -> str:
    if name not in _LOSSES:
        raise UnsupportedKerasConfigurationException(
            f"Unknown Keras loss '{name}'")
    return _LOSSES[name]


# ---------------------------------------------------------------------------
# per-layer config mapping (reference: layers/Keras*.java)
# ---------------------------------------------------------------------------

def _cfg(layer: Dict) -> Dict:
    return layer.get("config", {})


def _k1(cfg: Dict, k2_name: str, k1_name: str, default=None):
    """Fetch a config field under its Keras-2 name, falling back to the
    Keras-1 name (reference: KerasLayer version dispatch)."""
    if k2_name in cfg:
        return cfg[k2_name]
    return cfg.get(k1_name, default)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return int(v[0]), int(v[1] if len(v) > 1 else v[0])
    return int(v), int(v)


def _padding_mode(cfg: Dict) -> str:
    mode = _k1(cfg, "padding", "border_mode", "valid")
    if mode == "same":
        return "same"
    if mode == "valid":
        return "truncate"
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras padding mode '{mode}'")


def _dim_ordering(cfg: Dict) -> str:
    """'tf' (channels_last / HWIO kernels) or 'th' (channels_first / OIHW)."""
    v = _k1(cfg, "data_format", "dim_ordering", "channels_last")
    if v in ("channels_last", "tf", "default"):
        return "tf"
    if v in ("channels_first", "th"):
        return "th"
    raise UnsupportedKerasConfigurationException(f"dim ordering '{v}'")


def map_keras_layer(class_name: str, layer: Dict) -> Optional[Layer]:
    """Map one Keras layer dict to a framework Layer config; returns None
    for structural layers absorbed elsewhere (Input, Flatten, Reshape —
    the reference turns Flatten into a preprocessor, KerasFlatten.java;
    here family-change shape inference inserts it automatically)."""
    cfg = _cfg(layer)
    name = cfg.get("name") or layer.get("name")

    if class_name in ("InputLayer", "Flatten", "Reshape", "Masking"):
        return None

    if class_name == "Dense":
        act = map_activation(cfg.get("activation", "linear"))
        n_out = _k1(cfg, "units", "output_dim")
        return DenseLayer(name=name, n_out=int(n_out), activation=act)

    if class_name == "Activation":
        return ActivationLayer(name=name,
                               activation=map_activation(cfg["activation"]))

    if class_name in ("Dropout", "SpatialDropout2D", "SpatialDropout1D"):
        # reference maps dropout rate p -> dropOut retain semantics
        return DropoutLayer(name=name, rate=float(_k1(cfg, "rate", "p")))

    if class_name in ("Conv2D", "Convolution2D"):
        filters = int(_k1(cfg, "filters", "nb_filter"))
        if "kernel_size" in cfg:
            kh, kw = _pair(cfg["kernel_size"])
        else:  # Keras 1
            kh, kw = int(cfg["nb_row"]), int(cfg["nb_col"])
        sh, sw = _pair(_k1(cfg, "strides", "subsample", (1, 1)))
        act = map_activation(cfg.get("activation", "linear"))
        return ConvolutionLayer(name=name, n_out=filters,
                                kernel_size=(kh, kw), stride=(sh, sw),
                                convolution_mode=_padding_mode(cfg),
                                activation=act)

    if class_name in ("Conv1D", "Convolution1D"):
        filters = int(_k1(cfg, "filters", "nb_filter"))
        k = _k1(cfg, "kernel_size", "filter_length")
        k = int(k[0] if isinstance(k, (list, tuple)) else k)
        s = _k1(cfg, "strides", "subsample_length", 1)
        s = int(s[0] if isinstance(s, (list, tuple)) else s)
        act = map_activation(cfg.get("activation", "linear"))
        return Convolution1DLayer(name=name, n_out=filters,
                                  kernel_size=(k,), stride=(s,),
                                  convolution_mode=_padding_mode(cfg),
                                  activation=act)

    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        ptype = "max" if class_name.startswith("Max") else "avg"
        kh, kw = _pair(_k1(cfg, "pool_size", "pool_size", (2, 2)))
        strides = _k1(cfg, "strides", "strides")
        sh, sw = _pair(strides) if strides is not None else (kh, kw)
        return SubsamplingLayer(name=name, pooling_type=ptype,
                                kernel_size=(kh, kw), stride=(sh, sw),
                                convolution_mode=_padding_mode(cfg))

    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        ptype = "max" if class_name.startswith("Max") else "avg"
        k = _k1(cfg, "pool_size", "pool_length", 2)
        k = int(k[0] if isinstance(k, (list, tuple)) else k)
        s = _k1(cfg, "strides", "stride")
        if s is None:
            s = k
        s = int(s[0] if isinstance(s, (list, tuple)) else s)
        return Subsampling1DLayer(name=name, pooling_type=ptype,
                                  kernel_size=(k,), stride=(s,),
                                  convolution_mode=_padding_mode(cfg))

    if class_name in ("GlobalMaxPooling1D", "GlobalAveragePooling1D",
                      "GlobalMaxPooling2D", "GlobalAveragePooling2D"):
        ptype = "max" if "Max" in class_name else "avg"
        return GlobalPoolingLayer(name=name, pooling_type=ptype)

    if class_name == "BatchNormalization":
        # activation explicitly identity: Keras BN has no fused
        # activation, and leaving it unset would inherit the config
        # DSL's DL4J-style 'sigmoid' default
        return BatchNormalization(
            name=name, activation="identity",
            decay=float(_k1(cfg, "momentum", "momentum", 0.99)),
            eps=float(cfg.get("epsilon", 1e-3)))

    if class_name == "Embedding":
        n_in = int(_k1(cfg, "input_dim", "input_dim"))
        n_out = int(_k1(cfg, "output_dim", "output_dim"))
        return EmbeddingLayer(name=name, n_in=n_in, n_out=n_out,
                              activation="identity")

    if class_name == "LSTM":
        n_out = int(_k1(cfg, "units", "output_dim"))
        act = map_activation(cfg.get("activation", "tanh"))
        gate = map_activation(_k1(cfg, "recurrent_activation",
                                  "inner_activation", "hard_sigmoid"))
        fb = 1.0 if _k1(cfg, "unit_forget_bias", "forget_bias_init",
                        True) else 0.0
        return LSTM(name=name, n_out=n_out, activation=act,
                    gate_activation=gate, forget_gate_bias_init=fb)

    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        if isinstance(pad, (list, tuple)) and pad and \
                isinstance(pad[0], (list, tuple)):
            (t, b), (l, r) = pad
            return ZeroPaddingLayer(name=name, padding=(t, b, l, r))
        ph, pw = _pair(pad)
        return ZeroPaddingLayer(name=name, padding=(ph, pw))

    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras layer type '{class_name}'")


def map_merge_vertex(class_name: str, layer: Dict):
    cfg = _cfg(layer)
    if class_name in ("Concatenate", "Merge") and \
            cfg.get("mode", "concat") in ("concat", "concatenate", None):
        return MergeVertex()
    if class_name == "Add" or (class_name == "Merge"
                               and cfg.get("mode") == "sum"):
        return ElementWiseVertex(op="add")
    if class_name == "Subtract":
        return ElementWiseVertex(op="subtract")
    if class_name == "Multiply" or (class_name == "Merge"
                                    and cfg.get("mode") == "mul"):
        return ElementWiseVertex(op="product")
    if class_name == "Average" or (class_name == "Merge"
                                   and cfg.get("mode") == "ave"):
        return ElementWiseVertex(op="average")
    if class_name == "Maximum":
        return ElementWiseVertex(op="max")
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras merge '{class_name}'")


_MERGE_CLASSES = ("Merge", "Add", "Subtract", "Multiply", "Average",
                  "Maximum", "Concatenate")


def _input_type_from_shape(shape, dim_ordering: str = "tf"):
    """batch_input_shape (None, ...) → InputType."""
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return it.InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return it.InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        if dim_ordering == "th":
            c, h, w = dims
        else:
            h, w, c = dims
        return it.InputType.convolutional(h, w, c)
    raise UnsupportedKerasConfigurationException(
        f"Cannot infer input type from shape {shape}")


# ---------------------------------------------------------------------------
# weight conversion (reference: KerasLayer.getWeightsFromHdf5 + per-layer
# setWeights; gate order & transposes)
# ---------------------------------------------------------------------------

def _short(weight_name: str) -> str:
    """'model/dense_1/kernel:0' → 'kernel'."""
    base = weight_name.split("/")[-1]
    return base.split(":")[0]


def _find(short: Dict[str, np.ndarray], *names: str):
    """Resolve a canonical weight name against both modern
    ('kernel', 'W') and Keras-1 flat ('dense_1_W') naming: exact key
    first, then '<layer>_<name>' suffix match."""
    for n in names:
        if n in short:
            return short[n]
    for n in names:
        for k, v in short.items():
            if k.endswith("_" + n):
                return v
    return None


def convert_weights(framework_layer: Layer, kweights: Dict[str, np.ndarray],
                    dim_ordering: str = "tf", keras_major: int = 2
                    ) -> Tuple[Dict[str, np.ndarray],
                               Dict[str, np.ndarray]]:
    """Map a Keras layer's weight dict onto (params, state) for the
    corresponding framework layer. Handles Keras-1 per-gate LSTM weights,
    Theano OIHW kernels, and BN running stats.

    Kernel layout depends on BOTH the ordering and the Keras era
    (reference: KerasLayer.java keras_version dispatch +
    KerasConvolution weight layout handling): Keras-1 'th' stored
    Theano OIHW kernels, but Keras-2 ``channels_first`` models still
    store HWIO — for those only the activation layout differs, and
    transposing the kernel would corrupt it."""
    short = {_short(k): v for k, v in kweights.items()}
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, np.ndarray] = {}

    if isinstance(framework_layer, BatchNormalization):
        params["gamma"] = _find(short, "gamma")
        params["beta"] = _find(short, "beta")
        state["mean"] = _find(short, "moving_mean", "running_mean")
        var = _find(short, "moving_variance")
        if var is None:
            # Keras 1 stored std for some backends; DL4J treats it as var
            var = _find(short, "running_std")
        state["var"] = var
        return ({k: v for k, v in params.items() if v is not None},
                {k: v for k, v in state.items() if v is not None})

    if isinstance(framework_layer, LSTM):
        if "kernel" in short:  # Keras 2 fused blocks, gate order i,f,c,o
            params["W"] = short["kernel"]
            params["RW"] = short["recurrent_kernel"]
            if "bias" in short:
                params["b"] = short["bias"]
        else:  # Keras 1 per-gate: W_i U_i b_i W_c U_c b_c W_f U_f b_f W_o...
            def gate(prefix):
                for k, v in short.items():
                    if k.endswith(prefix) or k == prefix:
                        return v
                raise InvalidKerasConfigurationException(
                    f"LSTM weight '{prefix}' missing; have {list(short)}")
            # our gate order: i, f, g(c), o (recurrent.py _gates)
            params["W"] = np.concatenate(
                [gate("W_i"), gate("W_f"), gate("W_c"), gate("W_o")], axis=1)
            params["RW"] = np.concatenate(
                [gate("U_i"), gate("U_f"), gate("U_c"), gate("U_o")], axis=1)
            params["b"] = np.concatenate(
                [gate("b_i"), gate("b_f"), gate("b_c"), gate("b_o")], axis=0)
        return params, state

    if isinstance(framework_layer, (ConvolutionLayer,)):
        w = _find(short, "kernel", "W")
        if w is None:
            raise InvalidKerasConfigurationException(
                f"Conv weights missing; have {list(short)}")
        if w.ndim == 4 and dim_ordering == "th" and keras_major < 2:
            w = np.transpose(w, (2, 3, 1, 0))  # OIHW → HWIO
        if isinstance(framework_layer, Convolution1DLayer) and w.ndim == 3:
            # Keras Conv1D kernel [k, in, out] → our [1, k, in, out]
            w = w[None, :, :, :]
        params["W"] = w
        b = _find(short, "bias", "b")
        if b is not None:
            params["b"] = b
        return params, state

    if isinstance(framework_layer, EmbeddingLayer):
        emb = _find(short, "embeddings", "W")
        params["W"] = emb
        params["b"] = np.zeros(emb.shape[1], emb.dtype)
        return params, state

    if isinstance(framework_layer, DenseLayer):  # includes OutputLayer
        params["W"] = _find(short, "kernel", "W")
        b = _find(short, "bias", "b")
        if b is not None:
            params["b"] = b
        return params, state

    return params, state


# ---------------------------------------------------------------------------
# model-level import (reference: KerasSequentialModel.java, KerasModel.java)
# ---------------------------------------------------------------------------

def _model_config_from_archive(archive: Hdf5Archive) -> Dict:
    cfg = archive.read_attribute_as_json("model_config")
    if cfg is None:
        raise InvalidKerasConfigurationException(
            "HDF5 file has no 'model_config' attribute (weights-only file? "
            "pass the architecture JSON separately)")
    return cfg


def _sequential_layers(model_config: Dict) -> List[Dict]:
    cfg = model_config.get("config")
    if isinstance(cfg, list):  # Keras 1 / early 2
        return cfg
    return cfg["layers"]


class KerasSequentialModel:
    """Sequential Keras JSON → MultiLayerConfiguration
    (reference: KerasSequentialModel.java)."""

    def __init__(self, model_config: Dict,
                 training_config: Optional[Dict] = None,
                 enforce_training_config: bool = False):
        if model_config.get("class_name") not in ("Sequential",):
            raise InvalidKerasConfigurationException(
                f"Not a Sequential model: {model_config.get('class_name')}")
        self.layer_configs = _sequential_layers(model_config)
        self.training_config = training_config
        if enforce_training_config and training_config is None:
            # reference: KerasModel.java enforceTrainingConfig — fail fast
            # when the file was saved without compile() information
            raise InvalidKerasConfigurationException(
                "enforce_training_config=True but the file has no "
                "'training_config' attribute (model was not compiled "
                "before saving)")
        self.layers: List[Layer] = []
        self.keras_names: List[str] = []
        self.dim_ordering = "tf"
        self.input_type = None
        # dense layers whose preceding (dropped) Flatten declared
        # channels_first: Keras-2's Flatten already transposed to HWC
        # order there, so the th dense-row permutation must NOT apply
        self.hwc_flatten_dense: set = set()
        self._build()

    def _loss(self) -> Optional[str]:
        if not self.training_config:
            return None
        loss = self.training_config.get("loss")
        if isinstance(loss, dict):
            loss = next(iter(loss.values()))
        if isinstance(loss, dict):  # keras serialized loss object
            loss = loss.get("config", {}).get("name", loss.get("class_name"))
            loss = str(loss).lower()
        return map_loss(loss) if loss else None

    def _build(self) -> None:
        # dim ordering first, from ANY layer that declares it: the input
        # shape is usually on an InputLayer that precedes the conv layer
        # carrying data_format, and NCHW shapes must not be read as NHWC
        # (reference: KerasModel resolves dimOrdering across all layers
        # before building input types)
        for lc in self.layer_configs:
            cfg = _cfg(lc)
            if "dim_ordering" in cfg or "data_format" in cfg:
                self.dim_ordering = _dim_ordering(cfg)
                break
        pending_hwc_flatten = False
        for lc in self.layer_configs:
            cname = lc["class_name"]
            cfg = _cfg(lc)
            shape = cfg.get("batch_input_shape")
            if shape is not None and self.input_type is None:
                self.input_type = _input_type_from_shape(
                    shape, self.dim_ordering)
            mapped = map_keras_layer(cname, lc)
            if mapped is None:
                if cname == "Flatten" and ("data_format" in cfg
                                           or "dim_ordering" in cfg) \
                        and _dim_ordering(cfg) == "th":
                    pending_hwc_flatten = True
                continue
            # Fallback numbering is 0-based over *mapped* layers
            # (layer_0 for the first unnamed mapped layer). Real Keras
            # files always carry names; this only affects synthetic
            # configs.
            name = (cfg.get("name") or lc.get("name")
                    or f"layer_{len(self.layers)}")
            if pending_hwc_flatten:
                if isinstance(mapped, DenseLayer):
                    self.hwc_flatten_dense.add(name)
                    pending_hwc_flatten = False
                elif isinstance(mapped, (DropoutLayer, ActivationLayer,
                                         BatchNormalization)):
                    pass  # elementwise/order-preserving: Dense may follow
                else:
                    # A layer that may reorder or reshape features between
                    # the channels_first Flatten and the Dense would make
                    # the CHW→HWC dense-row permutation silently wrong —
                    # fail loudly instead.
                    raise UnsupportedKerasConfigurationException(
                        f"layer '{name}' ({cname}) between a "
                        "channels_first Flatten and its Dense consumer; "
                        "cannot prove the flattened feature order is "
                        "preserved")
            self.layers.append(mapped)
            self.keras_names.append(name)
        loss = self._loss()
        if loss and self.layers and \
                type(self.layers[-1]) in (DenseLayer,):
            last = self.layers[-1]
            # reference: KerasLoss appends an OutputLayer when a training
            # config is present (KerasModel.java getTrainingConfig path)
            self.layers[-1] = OutputLayer(
                name=last.name, n_in=last.n_in, n_out=last.n_out,
                activation=last.activation, loss_function=loss)

    def multi_layer_configuration(self) -> MultiLayerConfiguration:
        conf = NeuralNetConfiguration(seed=12345).list(*self.layers)
        if self.input_type is not None:
            conf.set_input_type(self.input_type)
        return conf


class KerasModel:
    """Functional Keras JSON → ComputationGraphConfiguration
    (reference: KerasModel.java)."""

    def __init__(self, model_config: Dict,
                 training_config: Optional[Dict] = None,
                 enforce_training_config: bool = False):
        if model_config.get("class_name") not in ("Model", "Functional"):
            raise InvalidKerasConfigurationException(
                f"Not a functional model: {model_config.get('class_name')}")
        cfg = model_config["config"]
        self.layer_configs = cfg["layers"]
        self.input_names = [n[0] for n in cfg["input_layers"]]
        self.output_names = [n[0] for n in cfg["output_layers"]]
        self.training_config = training_config
        if enforce_training_config and training_config is None:
            raise InvalidKerasConfigurationException(
                "enforce_training_config=True but the file has no "
                "'training_config' attribute (model was not compiled "
                "before saving)")
        self.dim_ordering = "tf"
        self.builder = NeuralNetConfiguration(seed=12345).graph_builder()
        self.keras_layer_names: List[str] = []
        self._skipped: Dict[str, str] = {}  # skipped layer → its input
        self.hwc_flatten_dense: set = set()
        self._build()

    @staticmethod
    def _inbound(lc: Dict) -> List[str]:
        nodes = lc.get("inbound_nodes", [])
        if not nodes:
            return []
        node = nodes[0]
        if isinstance(node, dict):  # keras 3 style {"args": ...}
            raise UnsupportedKerasConfigurationException(
                "Keras 3 saved-model JSON not supported; re-save in "
                "Keras 2 / TF-Keras HDF5 format")
        return [inb[0] for inb in node]

    def _resolve(self, name: str) -> str:
        while name in self._skipped:
            name = self._skipped[name]
        return name

    def _build(self) -> None:
        input_types = {}
        # dim ordering first, from any layer declaring it (input shapes
        # usually precede the conv layer carrying data_format)
        for lc in self.layer_configs:
            cfg = _cfg(lc)
            if "dim_ordering" in cfg or "data_format" in cfg:
                self.dim_ordering = _dim_ordering(cfg)
                break
        hwc_flattens: set = set()
        for lc in self.layer_configs:
            cname = lc["class_name"]
            cfg = _cfg(lc)
            name = lc.get("name") or cfg.get("name")
            raw_inbound = self._inbound(lc)
            inbound = [self._resolve(n) for n in raw_inbound]
            if cname == "InputLayer":
                shape = cfg.get("batch_input_shape")
                if shape is not None:
                    input_types[name] = _input_type_from_shape(
                        shape, self.dim_ordering)
                continue
            if cname in _MERGE_CLASSES:
                if any(n in hwc_flattens for n in raw_inbound):
                    # a merge after a channels_first Flatten recombines
                    # features — the CHW→HWC dense-row permutation for
                    # any downstream Dense becomes unprovable (same
                    # contract as the layer-between guard below)
                    raise UnsupportedKerasConfigurationException(
                        f"merge '{name}' ({cname}) consumes a "
                        "channels_first Flatten output; cannot prove "
                        "the flattened feature order for downstream "
                        "Dense layers")
                self.builder.add_vertex(name, map_merge_vertex(cname, lc),
                                        *inbound)
                continue
            mapped = map_keras_layer(cname, lc)
            if mapped is None:
                # structural layer: route around it
                self._skipped[name] = inbound[0]
                if cname == "Flatten" and ("data_format" in cfg
                                           or "dim_ordering" in cfg) \
                        and _dim_ordering(cfg) == "th":
                    hwc_flattens.add(name)
                continue
            hwc_upstream = any(n in hwc_flattens for n in raw_inbound)
            if isinstance(mapped, DenseLayer) and hwc_upstream:
                self.hwc_flatten_dense.add(name)
            elif isinstance(mapped, (DropoutLayer, ActivationLayer,
                                     BatchNormalization)) \
                    and hwc_upstream:
                # elementwise/order-preserving: downstream Dense is
                # still HWC-ordered
                hwc_flattens.add(name)
            elif hwc_upstream:
                # same contract as the Sequential builder: a layer that
                # may reorder features between the channels_first
                # Flatten and its Dense consumer makes the CHW→HWC
                # dense-row permutation unprovable — fail loudly
                raise UnsupportedKerasConfigurationException(
                    f"layer '{name}' ({cname}) between a channels_first "
                    "Flatten and its Dense consumer; cannot prove the "
                    "flattened feature order is preserved")
            self.builder.add_layer(name, mapped, *inbound)
            self.keras_layer_names.append(name)
        self.builder.add_inputs(*self.input_names)
        self.builder.set_input_types(**input_types)
        outputs = [self._resolve(n) for n in self.output_names]
        self.builder.set_outputs(*outputs)
        self._apply_training_config(outputs)

    def _loss_for(self, output_name: str) -> Optional[str]:
        """Loss for one output from training_config; Keras stores either a
        single loss or a dict keyed by output layer name (reference:
        KerasModel.java getTrainingConfig loss handling)."""
        if not self.training_config:
            return None
        loss = self.training_config.get("loss")
        if isinstance(loss, dict) and not {"class_name", "config"} <= \
                set(loss):
            loss = loss.get(output_name) or next(iter(loss.values()), None)
        if isinstance(loss, dict):  # serialized loss object
            loss = loss.get("config", {}).get("name", loss.get("class_name"))
            loss = str(loss).lower()
        return map_loss(loss) if loss else None

    def _apply_training_config(self, outputs: List[str]) -> None:
        """Turn each output Dense vertex into a loss-bearing OutputLayer so
        the imported graph can fit()/score() (the sequential path does the
        same; reference: KerasLoss appended output layers)."""
        for oname in outputs:
            loss = self._loss_for(oname)
            if loss is None:
                continue
            spec = self.builder._conf.vertices.get(oname)
            if spec is None:
                continue
            v = spec.vertex
            if type(v) is DenseLayer:
                spec.vertex = OutputLayer(
                    name=v.name, n_in=v.n_in, n_out=v.n_out,
                    activation=v.activation, loss_function=loss,
                    dropout=v.dropout, l1=v.l1, l2=v.l2,
                    learning_rate=v.learning_rate,
                    bias_learning_rate=v.bias_learning_rate)

    def computation_graph_configuration(self) -> ComputationGraphConfiguration:
        return self.builder.build()


# ---------------------------------------------------------------------------
# weight copying
# ---------------------------------------------------------------------------

def _weight_root(archive: Hdf5Archive):
    if archive.has_group("model_weights"):
        return archive.root["model_weights"]
    return archive.root


def _find_layer_group(root, keras_name: str):
    if keras_name in root:
        g = root[keras_name]
        # TF-Keras nests again: model_weights/dense_1/dense_1/{kernel,bias}
        return g
    return None


def keras_major_version(archive: Hdf5Archive) -> int:
    """1 or 2 from the file's keras_version attribute (reference:
    KerasModelUtils.determineKerasMajorVersion). Keras 2 always writes
    the attribute; a file without one is Keras-1-era."""
    v = archive.read_attribute_as_string("keras_version")
    if not v:
        return 1
    try:
        return int(str(v).split(".")[0])
    except ValueError:
        return 2


def _chw_to_hwc_rows(W: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Permute Dense rows from Keras channels-first flatten order (C,H,W)
    to this framework's NHWC flatten order (H,W,C). The reference is
    NCHW-native and permutes for 'tf' models instead (its
    CnnToFeedForwardPreProcessor carries the Keras dim ordering); here
    the mirror image applies to 'th'/channels_first models."""
    hh, ww, cc = np.meshgrid(np.arange(h), np.arange(w), np.arange(c),
                             indexing="ij")
    perm = (cc * h * w + hh * w + ww).reshape(-1)
    return W[perm]


def _dense_flatten_fix(net, layer_index: int, pname: str,
                       params: Dict[str, np.ndarray]) -> None:
    """Apply the th-flatten row permutation when this Dense consumes a
    flattened conv map (detected via the auto-inserted cnn→ff
    preprocessor: index-keyed on a MultiLayerConfiguration, vertex-name-
    keyed on a ComputationGraph)."""
    pre = getattr(net.conf, "input_preprocessors", {}).get(str(layer_index))
    if pre is None:
        pre = getattr(net, "_preprocessors", {}).get(pname)
    if isinstance(pre, CnnToFeedForwardPreProcessor) and "W" in params:
        h, w, c = pre.height, pre.width, pre.channels
        if params["W"].shape[0] == h * w * c:
            params["W"] = _chw_to_hwc_rows(params["W"], h, w, c)


def copy_weights_to_network(archive: Hdf5Archive, net,
                            layers: List[Layer], keras_names: List[str],
                            dim_ordering: str = "tf",
                            hwc_flatten_dense: frozenset = frozenset()
                            ) -> None:
    """Copy HDF5 weights into an initialized network by Keras layer name
    (reference: KerasModel.copyWeightsToModel / helpers.KerasModelUtils).
    ``hwc_flatten_dense``: dense layers Keras already reordered to HWC
    via Flatten(channels_first) — exempt from the th row permutation."""
    keras_major = keras_major_version(archive)
    root = _weight_root(archive)
    for i, (layer, kname) in enumerate(zip(layers, keras_names)):
        group = _find_layer_group(root, kname)
        if group is None:
            if layer.init_params.__func__ is Layer.init_params:
                continue  # parameterless layer
            raise InvalidKerasConfigurationException(
                f"No weights for layer '{kname}' in HDF5 file")
        kweights = archive.layer_weights(group)
        if not kweights:
            continue
        params, state = convert_weights(layer, kweights, dim_ordering,
                                        keras_major)
        if dim_ordering == "th" and isinstance(layer, DenseLayer) \
                and kname not in hwc_flatten_dense:
            _dense_flatten_fix(net, i, layer.name or kname, params)
        pname = layer.name or kname
        tgt = net.params.get(pname)
        if tgt is None:
            raise InvalidKerasConfigurationException(
                f"Network has no params entry '{pname}'")
        for k, v in params.items():
            if k in tgt and tuple(tgt[k].shape) != tuple(v.shape):
                raise InvalidKerasConfigurationException(
                    f"Shape mismatch for {pname}.{k}: model "
                    f"{tuple(tgt[k].shape)} vs file {tuple(v.shape)}")
            tgt[k] = _on_device(v, net)
        if state:
            st = net.state.setdefault(pname, {})
            for k, v in state.items():
                st[k] = _on_device(v, net)


def _on_device(v: np.ndarray, net) -> torch.Tensor:
    """A converted Keras array as a tensor on the network's device, in
    its dtype."""
    t = torch.from_numpy(np.ascontiguousarray(v))
    return t.to(device=net.device, dtype=net.dtype)


# ---------------------------------------------------------------------------
# public entry points (reference: KerasModelImport.java:48-231)
# ---------------------------------------------------------------------------

def import_keras_sequential_model_and_weights(
        path: str, enforce_training_config: bool = False, device=None
        ) -> MultiLayerNetwork:
    """HDF5 with architecture + weights -> MultiLayerNetwork on ``device``
    (reference: KerasModelImport.importKerasSequentialModelAndWeights)."""
    with Hdf5Archive(path) as archive:
        mc = _model_config_from_archive(archive)
        tc = archive.read_attribute_as_json("training_config")
        km = KerasSequentialModel(mc, tc, enforce_training_config)
        conf = km.multi_layer_configuration()
        net = MultiLayerNetwork(conf, device=device).init()
        copy_weights_to_network(archive, net, net.layers, km.keras_names,
                                km.dim_ordering,
                                frozenset(km.hwc_flatten_dense))
        return net


def import_keras_model_and_weights(path: str,
                                   enforce_training_config: bool = False,
                                   device=None) -> ComputationGraph:
    """HDF5 functional model + weights -> ComputationGraph on ``device``
    (reference: KerasModelImport.importKerasModelAndWeights:101)."""
    with Hdf5Archive(path) as archive:
        mc = _model_config_from_archive(archive)
        if mc.get("class_name") == "Sequential":
            raise InvalidKerasConfigurationException(
                "File holds a Sequential model; use "
                "import_keras_sequential_model_and_weights")
        tc = archive.read_attribute_as_json("training_config")
        km = KerasModel(mc, tc, enforce_training_config)
        conf = km.computation_graph_configuration()
        net = ComputationGraph(conf, device=device).init()
        layers = [conf.vertices[n].vertex for n in km.keras_layer_names]
        copy_weights_to_network(archive, net, layers, km.keras_layer_names,
                                km.dim_ordering,
                                frozenset(km.hwc_flatten_dense))
        return net


def import_keras_model_auto(path: str,
                            enforce_training_config: bool = False,
                            device=None):
    """Dispatch on the file's model_config class: Sequential ->
    MultiLayerNetwork, functional -> ComputationGraph (the reference's
    ModelGuesser-style convenience on top of KerasModelImport)."""
    with Hdf5Archive(path) as archive:
        mc = _model_config_from_archive(archive)
    if mc.get("class_name") == "Sequential":
        return import_keras_sequential_model_and_weights(
            path, enforce_training_config, device=device)
    return import_keras_model_and_weights(path, enforce_training_config,
                                          device=device)


def import_keras_model_configuration(json_path_or_str: str):
    """Architecture-only JSON -> configuration (reference:
    KerasModelImport.importKerasModelConfiguration / Sequential variant)."""
    s = json_path_or_str
    if not s.lstrip().startswith("{"):
        with open(s) as f:
            s = f.read()
    mc = json.loads(s)
    if mc.get("class_name") == "Sequential":
        return KerasSequentialModel(mc).multi_layer_configuration()
    return KerasModel(mc).computation_graph_configuration()


def import_keras_model_and_weights_separate(json_path: str, h5_path: str,
                                            device=None):
    """JSON architecture + weights-only HDF5 -> a network on ``device``
    (reference: KerasModelImport.importKerasModelAndWeights(json, h5)
    variants)."""
    with open(json_path) as f:
        mc = json.loads(f.read())
    with Hdf5Archive(h5_path) as archive:
        if mc.get("class_name") == "Sequential":
            km = KerasSequentialModel(mc)
            net = MultiLayerNetwork(km.multi_layer_configuration(),
                                    device=device).init()
            copy_weights_to_network(archive, net, net.layers,
                                    km.keras_names, km.dim_ordering,
                                    frozenset(km.hwc_flatten_dense))
            return net
        kg = KerasModel(mc)
        conf = kg.computation_graph_configuration()
        netg = ComputationGraph(conf, device=device).init()
        layers = [conf.vertices[n].vertex for n in kg.keras_layer_names]
        copy_weights_to_network(archive, netg, layers, kg.keras_layer_names,
                                kg.dim_ordering,
                                frozenset(kg.hwc_flatten_dense))
        return netg

"""Model serialization: save / restore config + parameters + layer state
+ updater state (port of deeplearning4j_tpu/util/model_serializer.py).

The same zip container as the JAX package: ``configuration.json`` (the
DSL's JSON, whose classes both packages register under the same names),
``metadata.json``, and one ``.npz`` member per tree (coefficients, layer
state such as batch-norm statistics and centers, updater state) keyed by
``//``-joined tree paths. bfloat16 arrays are stored as their uint16
bit view with a ``__dtypes__`` sidecar naming the dtype,
as JAX writes them; the port reads them back from the bits with torch,
without `ml_dtypes`. So a MultiLayerNetwork or a ComputationGraph
written by either package is restored by the other.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

CONFIG_ENTRY = "configuration.json"
COEFFICIENTS_ENTRY = "coefficients.npz"
STATE_ENTRY = "layerState.npz"
UPDATER_ENTRY = "updaterState.npz"  # reference: UPDATER_BIN, ModelSerializer.java:40
META_ENTRY = "metadata.json"

_SEP = "//"


def _flatten(tree: Dict[str, Any], prefix: str = ""
             ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        elif v is None:
            continue
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _merge_into(skeleton: Any, loaded: Any, cast: bool = False) -> Any:
    """Overlay loaded leaves onto a freshly-initialized skeleton so empty
    dicts (e.g. SGD's stateless updater slots) survive the npz round-trip.
    With ``cast``, loaded leaves are cast to the skeleton leaf's dtype —
    used for updater state, whose canonical dtype is >=f32 even for bf16
    params (updaters._init_leaf); checkpoints written before that policy
    hold bf16 moments, and an uncast carry would flip dtype across a
    lax.scan step in fit_batched."""
    if isinstance(skeleton, dict):
        if not isinstance(loaded, dict):
            return skeleton
        return {k: (_merge_into(v, loaded[k], cast) if k in loaded else v)
                for k, v in skeleton.items()}
    if loaded is None:
        return skeleton
    if isinstance(skeleton, torch.Tensor):
        # onto the skeleton's device; updater state also to its dtype
        return loaded.to(skeleton.device,
                         skeleton.dtype if cast else loaded.dtype)
    return loaded


def write_model(model, path: str, save_updater: bool = True) -> None:
    """Save a MultiLayerNetwork or ComputationGraph (reference:
    ModelSerializer.writeModel, ModelSerializer.java:79-95)."""
    from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
        ComputationGraph
    model_type = ("ComputationGraph"
                  if isinstance(model, ComputationGraph)
                  else "MultiLayerNetwork")
    meta = {
        "model_type": model_type,
        "framework": "deeplearning4j_tpu",
        "iteration_count": int(model.iteration_count),
        "epoch_count": int(model.epoch_count),
        "dtype": str(model.conf.training.dtype),
        "has_updater_state": bool(save_updater),
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_ENTRY, model.conf.to_json())
        zf.writestr(META_ENTRY, json.dumps(meta, indent=2))
        _write_npz(zf, COEFFICIENTS_ENTRY, _flatten(model.params))
        state = getattr(model, "state", None)
        if state:
            _write_npz(zf, STATE_ENTRY, _flatten(state))
        if save_updater and model.updater_state:
            _write_npz(zf, UPDATER_ENTRY, _flatten(model.updater_state))


_DTYPES_KEY = "__dtypes__"


def _write_npz(zf: zipfile.ZipFile, entry: str, flat: Dict[str, Any]
               ) -> None:
    # numpy holds no bfloat16: such arrays go in as their uint16 bit
    # views plus a dtype sidecar, as JAX stores its ml_dtypes
    dtypes: Dict[str, str] = {}
    storable: Dict[str, np.ndarray] = {}
    for k, a in flat.items():
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            storable[k] = a.detach().cpu().contiguous().view(
                torch.int16).numpy().view(np.uint16)
        elif isinstance(a, torch.Tensor):
            storable[k] = a.detach().cpu().numpy()
        else:
            storable[k] = np.asarray(a)
    if dtypes:
        storable[_DTYPES_KEY] = np.frombuffer(
            json.dumps(dtypes).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **storable)
    zf.writestr(entry, buf.getvalue())


def _read_npz(zf: zipfile.ZipFile, entry: str
              ) -> Optional[Dict[str, torch.Tensor]]:
    """An npz member as CPU tensors; the sidecar's bit views become their
    dtypes again (from the bits, no ml_dtypes)."""
    try:
        data = zf.read(entry)
    except KeyError:
        return None
    with np.load(io.BytesIO(data)) as npz:
        out = {k: npz[k] for k in npz.files}
    dtypes = {}
    if _DTYPES_KEY in out:
        dtypes = json.loads(out.pop(_DTYPES_KEY).tobytes().decode())
    tensors = {}
    for k, a in out.items():
        a = np.ascontiguousarray(a)
        if k in dtypes:
            if dtypes[k] != "bfloat16":
                raise ValueError(f"{entry}: array {k!r} has dtype "
                                 f"{dtypes[k]}; the port reads bfloat16")
            tensors[k] = torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16)
        else:
            tensors[k] = torch.from_numpy(a)
    return tensors


def _read_meta(zf: zipfile.ZipFile) -> Dict[str, Any]:
    try:
        return json.loads(zf.read(META_ENTRY))
    except KeyError:
        return {}


def restore_multi_layer_network(path: str, load_updater: bool = True,
                                device=None):
    """reference: ModelSerializer.restoreMultiLayerNetwork. The network
    lives on ``device`` (CUDA unless ``"cpu"``)."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    with zipfile.ZipFile(path) as zf:
        conf = MultiLayerConfiguration.from_json(
            zf.read(CONFIG_ENTRY).decode())
        net = MultiLayerNetwork(conf, device=device).init()
        _restore_arrays(zf, net, load_updater)
    return net


def restore_computation_graph(path: str, load_updater: bool = True,
                              device=None):
    """reference: ModelSerializer.restoreComputationGraph. The graph
    lives on ``device`` (CUDA unless ``"cpu"``)."""
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
        ComputationGraph
    with zipfile.ZipFile(path) as zf:
        conf = ComputationGraphConfiguration.from_json(
            zf.read(CONFIG_ENTRY).decode())
        net = ComputationGraph(conf, device=device).init()
        _restore_arrays(zf, net, load_updater)
    return net


def _restore_arrays(zf: zipfile.ZipFile, net, load_updater: bool) -> None:
    meta = _read_meta(zf)
    coeff = _read_npz(zf, COEFFICIENTS_ENTRY)
    if coeff is not None:
        net.params = _merge_into(net.params, _unflatten(coeff))
    state = _read_npz(zf, STATE_ENTRY)
    if state is not None:
        net.state = _merge_into(net.state, _unflatten(state))
    if load_updater:
        upd = _read_npz(zf, UPDATER_ENTRY)
        if upd is not None:
            net.updater_state = _merge_into(net.updater_state,
                                            _unflatten(upd), cast=True)
    net.iteration_count = int(meta.get("iteration_count", 0))
    net.epoch_count = int(meta.get("epoch_count", 0))


def model_type_of(path: str) -> Optional[str]:
    """Peek at a saved model's type without restoring it."""
    try:
        with zipfile.ZipFile(path) as zf:
            meta = _read_meta(zf)
            if meta.get("model_type"):
                return meta["model_type"]
            cfg = json.loads(zf.read(CONFIG_ENTRY))
            t = cfg.get("@class", "")
            return ("ComputationGraph"
                    if "ComputationGraph" in t else "MultiLayerNetwork")
    except (zipfile.BadZipFile, KeyError, OSError):
        return None


class ModelSerializer:
    """Static facade under the reference's class name."""
    write_model = staticmethod(write_model)
    restore_multi_layer_network = staticmethod(restore_multi_layer_network)
    restore_computation_graph = staticmethod(restore_computation_graph)

"""Parameter conversion from the JAX package's layout.

`params_from_numpy` takes the reference `init_params` tree as numpy
arrays — ``{"embed", "pos", "blocks": {Wq, Wk, Wv, Wo, ln1g, ln1b, ln2g,
ln2b, W1, b1, W2, b2} stacked on [L], "lnfg", "lnfb", "Wout"}`` — and
returns the port's tree by key path. No transpose: both sides compute
``x @ W`` with W as [in, out]. `adam_state_from_numpy` carries a JAX
`AdamState` (m and v trees of the params' layout, and the step count)
across the same way. A quantized JAX tree (`quant.model.quantize_params`)
converts too: each `QuantizedTensor` leaf, whose key paths are
``.../Wq/.values`` and ``.../Wq/.scales``, arrives as an object with
``values``, ``scales`` and ``mode`` (what ``tree_map(np.asarray, ...)``
leaves of it) and becomes the port's `quant.core.QuantizedTensor` with
the same int8 / e4m3 bytes. `network_params_from_numpy` and
`updater_state_from_numpy` do the same for a `MultiLayerNetwork`'s
``{layer_name: {param: array}}`` tree and its updater state
``{layer_name: {param: {slot: array}}}``. Callers turn a JAX tree into
numpy with ``jax.tree_util.tree_map(np.asarray, tree)``; this module
never imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.parallel.optim import AdamState
from deeplearning4j_tpu_torch.quant.core import QuantizedTensor


def _from_numpy(x) -> torch.Tensor:
    """A numpy array as a tensor with the same bytes; float8_e4m3fn
    arrays (an extension dtype torch cannot read) go through uint8."""
    a = np.array(x, copy=True, order="C")
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """Same keys, every leaf a tensor on ``device`` (CUDA unless
    ``device="cpu"``). ``dtype=None`` keeps each leaf's dtype; a float
    ``dtype`` casts every other leaf to it. A quantized leaf (``values``,
    ``scales``, ``mode``) becomes a `QuantizedTensor` with its bytes as
    they are (``dtype`` does not apply to it)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if all(hasattr(x, a) for a in ("values", "scales", "mode")):
            return QuantizedTensor(_from_numpy(x.values).to(dev),
                                   _from_numpy(x.scales).to(dev), x.mode)
        t = _from_numpy(x)
        if dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def adam_state_from_numpy(m_tree: Dict[str, Any], v_tree: Dict[str, Any],
                          count, device=None) -> AdamState:
    """The port's `AdamState` from a JAX one's m and v trees (numpy
    leaves, the params' layout) and its int32 step count."""
    dev = resolve_device(device)
    return AdamState(m=params_from_numpy(m_tree, dev),
                     v=params_from_numpy(v_tree, dev),
                     count=torch.tensor(int(np.asarray(count)),
                                        dtype=torch.int32, device=dev))


def _leaf(x, dev, dtype):
    """A numpy leaf as a tensor: bfloat16 arrays (which numpy keeps as an
    extension type torch cannot read) go through float32, exactly."""
    a = np.asarray(x)
    if a.dtype.kind not in "biuf" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


def network_params_from_numpy(tree: Dict[str, Dict[str, Any]], device=None,
                              dtype: Optional[torch.dtype] = None
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX `MultiLayerNetwork.params` tree ``{layer: {param: array}}``
    as the port's (same keys, no transpose: both compute ``x @ W``),
    on ``device`` (CUDA unless ``"cpu"``), cast to ``dtype`` if given."""
    dev = resolve_device(device)
    return {lname: {k: _leaf(v, dev, dtype) for k, v in ptree.items()}
            for lname, ptree in tree.items()}


def updater_state_from_numpy(tree: Dict[str, Any], device=None
                             ) -> Dict[str, Any]:
    """A JAX `MultiLayerNetwork.updater_state` tree ``{layer: {param:
    {slot: array}}}`` as the port's; every slot keeps its dtype (float32
    or wider, as both packages keep updater state)."""
    dev = resolve_device(device)
    return {lname: {k: {slot: _leaf(v, dev, None)
                        for slot, v in slots.items()}
                    for k, slots in ptree.items()}
            for lname, ptree in tree.items()}

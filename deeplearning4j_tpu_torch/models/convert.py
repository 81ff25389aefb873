"""Parameter conversion from the JAX package's layout.

`params_from_numpy` takes the reference `init_params` tree as numpy
arrays — ``{"embed", "pos", "blocks": {Wq, Wk, Wv, Wo, ln1g, ln1b, ln2g,
ln2b, W1, b1, W2, b2} stacked on [L], "lnfg", "lnfb", "Wout"}`` — and
returns the port's tree by key path. No transpose: both sides compute
``x @ W`` with W as [in, out]. Callers turn a JAX tree into numpy with
``jax.tree_util.tree_map(np.asarray, tree)``; this module never imports
JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """Same keys, every leaf a tensor on ``device`` (CUDA unless
    ``device="cpu"``). ``dtype=None`` keeps each leaf's dtype; a float
    ``dtype`` casts every leaf to it."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True, order="C"))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)

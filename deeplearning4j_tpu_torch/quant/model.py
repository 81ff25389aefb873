"""Transformer checkpoint quantization and drafter trees.

Port of deeplearning4j_tpu/quant/model.py on one device.

`quantize_params` turns a float `models.transformer.init_params` tree
into a drop-in quantized one: the embedding (one scale per token row,
axis -1), the output projection and the block weights Wq, Wk, Wv, Wo,
W1, W2 (one scale per output channel, axis -2) become `QuantizedTensor`s;
layer norms, biases and the positional table stay float. The MoE
experts' We1 / We2 wait for the MoE MLP (ROADMAP queue A item 7).

`quantize_specs` and `shard_quantized_serving_params` have no
counterpart here: they place a quantized tree on a serving mesh, and one
card holds the whole tree.

`draft_tree` reads `EngineConfig.draft`: ``"int8"`` / ``"fp8"`` (the
weight-quantized tree; when the engine's weights are already quantized
the live tree is shared, not requantized), ``"self"`` (the target tree)
and ``"layers:N"`` (early exit: the first N blocks, then the final norm
and output head).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.quant.core import (QuantizedTensor,
                                                 dequantize, quantize,
                                                 resolve_mode)

# weight name -> quantization axis (reference :43-48)
_TOP_RULES: Dict[str, int] = {"embed": -1, "Wout": -2}
_BLOCK_RULES: Dict[str, int] = {"Wq": -2, "Wk": -2, "Wv": -2, "Wo": -2,
                                "W1": -2, "W2": -2}


def _device_of(params: Dict[str, Any]):
    return params["Wout"].device


def quantize_params(params: Dict[str, Any],
                    mode: str = "int8") -> Dict[str, Any]:
    """Quantize a float transformer tree (weights and embedding; norms,
    biases and pos untouched). ``mode`` resolves against the tree's
    device, so "fp8" lands on int8 off a capable card. A leaf that is
    already quantized raises: requantizing would compound the error."""
    m = resolve_mode(mode, _device_of(params))
    if m is None:
        raise ValueError("quantize_params needs a mode ('int8'/'fp8')")
    out = dict(params)
    for name, ax in _TOP_RULES.items():
        if name in out:
            if isinstance(out[name], QuantizedTensor):
                raise ValueError(f"param {name!r} is already quantized")
            out[name] = quantize(out[name], axis=ax, mode=m)
    blocks = dict(params["blocks"])
    for name, ax in _BLOCK_RULES.items():
        if name in blocks:
            if isinstance(blocks[name], QuantizedTensor):
                raise ValueError(f"param blocks.{name!r} is already "
                                 "quantized")
            blocks[name] = quantize(blocks[name], axis=ax, mode=m)
    out["blocks"] = blocks
    return out


def dequantize_params(params: Dict[str, Any],
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, Any]:
    """Dense float tree from a (possibly partly) quantized one."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return dequantize(x, dtype) if isinstance(x, QuantizedTensor) else x
    return conv(params)


def draft_tree(params: Dict[str, Any], draft: str, cfg,
               base_mode: Optional[str] = None
               ) -> Tuple[Dict[str, Any], Optional[str], int]:
    """The drafter of a speculative engine from its live tree (reference
    :136-185). Returns (draft_params, draft_quantized, draft_layers):
    ``"self"`` -> (params, base_mode, 0), 0 meaning every layer;
    ``"layers:N"`` -> (params, base_mode, N) for 0 < N <= n_layers;
    ``"int8"`` / ``"fp8"`` -> the tree quantized in that mode (resolved
    on the tree's device), or the live tree itself when ``base_mode``
    says it is already quantized. A malformed or unknown spec raises
    ValueError."""
    draft = str(draft)
    if draft == "self":
        return params, base_mode, 0
    if draft.startswith("layers:"):
        try:
            n = int(draft.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"malformed draft spec {draft!r}: "
                             "expected 'layers:<int>'")
        if not 0 < n <= cfg.n_layers:
            raise ValueError(f"draft layers {n} out of "
                             f"(0, {cfg.n_layers}]")
        return params, base_mode, n
    try:
        mode = resolve_mode(draft, _device_of(params))
    except ValueError:
        mode = None
    if mode is None:
        raise ValueError(f"unknown draft spec {draft!r}: expected "
                         "'int8'/'fp8', 'self', or 'layers:N'")
    if base_mode is not None:
        # the live weights are already quantized: they are the drafter
        return params, base_mode, 0
    return quantize_params(params, mode=mode), mode, 0


def param_bytes(tree) -> int:
    """At-rest bytes of a parameter tree: every tensor's bytes, a
    QuantizedTensor's values and scales."""
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return tree.nbytes
    return tree.numel() * tree.element_size()


def max_logit_divergence(cfg, params_f: Dict[str, Any],
                         params_q: Dict[str, Any], tokens) -> float:
    """max |logits_float - logits_quantized| over a token batch, both
    trees through the same `forward` (reference :200-212)."""
    from deeplearning4j_tpu_torch.models.transformer import forward
    toks = torch.as_tensor(tokens, dtype=torch.int64,
                           device=_device_of(params_f))
    with torch.no_grad():
        lf = forward(cfg, params_f, toks).to(torch.float32)
        lq = forward(cfg, params_q, toks).to(torch.float32)
    return float(torch.max(torch.abs(lf - lq)))

"""Drafter trees for self-speculative decoding (port of the part of
deeplearning4j_tpu/quant/model.py that the speculative slice needs).

`draft_tree` reads `EngineConfig.draft`. Ported drafters: ``"self"`` (the
target tree itself) and ``"layers:N"`` (early exit: the same tree run
through its first N blocks, then the final norm and output head). The
quantized drafters ``"int8"`` / ``"fp8"`` need the quantized weight tree,
which is not ported yet (ROADMAP queue A4): they raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

_QUANT_MODES = ("int8", "fp8")

_QUANT_DRAFT_TODO = ("the quantized drafter (EngineConfig.draft='int8' or "
                     "'fp8') needs the quantized weight tree, which is not "
                     "ported yet (ROADMAP queue A4)")


def draft_tree(params: Dict[str, Any], draft: str, cfg
               ) -> Tuple[Dict[str, Any], Optional[str], int]:
    """The drafter of a speculative engine from its live parameter tree
    (reference :136-185). Returns (draft_params, draft_quantized,
    draft_layers): ``"self"`` -> (params, None, 0), where 0 means every
    layer; ``"layers:N"`` -> (params, None, N) for 0 < N <= n_layers.
    A malformed or unknown spec raises ValueError."""
    draft = str(draft)
    if draft == "self":
        return params, None, 0
    if draft.startswith("layers:"):
        try:
            n = int(draft.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"malformed draft spec {draft!r}: "
                             "expected 'layers:<int>'")
        if not 0 < n <= cfg.n_layers:
            raise ValueError(f"draft layers {n} out of "
                             f"(0, {cfg.n_layers}]")
        return params, None, n
    if draft in _QUANT_MODES:
        raise NotImplementedError(_QUANT_DRAFT_TODO)
    raise ValueError(f"unknown draft spec {draft!r}: expected "
                     "'int8'/'fp8', 'self', or 'layers:N'")

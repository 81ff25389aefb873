"""Small shared helpers (port of deeplearning4j_tpu/common.py)."""
from __future__ import annotations

import torch


def promote_score(x: torch.Tensor) -> torch.Tensor:
    """Promote a loss value to at least float32 (bfloat16 training still
    accumulates scores in f32; float64 gradient-check mode stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


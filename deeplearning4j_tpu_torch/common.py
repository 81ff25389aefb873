"""Small shared helpers (port of deeplearning4j_tpu/common.py)."""
from __future__ import annotations

import torch


def promote_score(x: torch.Tensor) -> torch.Tensor:
    """Promote a loss value to at least float32 (bfloat16 training still
    accumulates scores in f32; float64 gradient-check mode stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))



def render_summary_table(rows, total_params: int) -> str:
    """A summary() table: header and rows (tuples of str) aligned, then
    the total line."""
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = ["  ".join(v.ljust(widths[c]) for c, v in enumerate(r))
             for r in rows]
    lines.append(f"Total parameters: {total_params:,}")
    return "\n".join(lines)


def count_params(tree) -> int:
    """Number of elements in a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return int(tree.numel())

"""Chip peaks for MFU and roofline reporting: the chip-peak part of
deeplearning4j_tpu/util/flops.py, keyed by the CUDA device name.

`observability.profiling.EngineProfiler` divides its achieved FLOP/s by
`chip_peak_flops` (live ``serving_mfu``) and places each serving
program against the ridge point ``chip_peak_flops /
chip_peak_bytes_per_s``. The table holds the card's data-sheet values:
dense bf16 tensor-core FLOP/s and HBM bytes/s. A card missing from it,
and the CPU, report None (MFU then reads 0, rooflines "unknown").
"""
from __future__ import annotations

from typing import Optional

import torch

# device name (torch.cuda.get_device_name) -> data-sheet peak dense bf16
# FLOP/s and HBM bytes/s
_PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}
_PEAK_HBM_BPS = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _device_name(device) -> Optional[str]:
    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev)


def _peak_lookup(table: dict, device) -> Optional[float]:
    name = _device_name(device)
    if name is None:
        return None
    # longest-prefix match, as the reference's table does
    best = None
    for k, v in table.items():
        if name.startswith(k) and (best is None or len(k) > best[0]):
            best = (len(k), v)
    return best[1] if best else None


def chip_peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card (``device``: a CUDA device,
    the current one when None), or None when unknown (the CPU, a card
    not in the table)."""
    return _peak_lookup(_PEAK_BF16, device)


def chip_peak_bytes_per_s(device=None) -> Optional[float]:
    """Peak HBM bytes/s of one card, or None when unknown: the roofline
    ridge point's denominator."""
    return _peak_lookup(_PEAK_HBM_BPS, device)

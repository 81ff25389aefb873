"""QuantizedTensor: symmetric absmax weight quantization primitives.

Port of deeplearning4j_tpu/quant/core.py. A `QuantizedTensor` holds
``values`` (int8, or ``torch.float8_e4m3fn`` where the card has fp8) and
``scales`` (float32) of the same rank as ``values``: every quantized
(reduction) axis is kept as size 1 in ``scales``, so dequantization is a
broadcast multiply. ``W [in, out]`` quantized per output channel stores
``scales [1, out]``; the stacked block weights ``[L, in, out]`` store
``[L, 1, out]``, so ``qt[layer]`` slices values and scales in lockstep.

The class stands in for a weight tensor wherever the port reads one:
``p["Wq"].to(x.dtype)`` DEQUANTIZES (the multiply in float32, then the
cast, reference :131-140), ``.to(device)`` moves values and scales
together, and indexing slices both. So `params_to`, `layer_params` and
every ``x @ W.to(x.dtype)`` of the forward, prefill and decode paths take
a quantized tree with no call site changed.

fp8 (`mode="fp8"`) maps absmax to 448, the e4m3 finite maximum, and lets
the cast round. It exists only on a CUDA device of compute capability
(8, 9) or later; `resolve_mode` turns "fp8" into "int8" everywhere else,
as the reference does off its accelerator (:57-85). Both take the device
the tensors will live on, so a CPU run resolves as the reference does on
the CPU even on a machine that has a card.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

# quantized-grid endpoints: int8 uses the symmetric [-127, 127] range
# (negation stays exact); e4m3's largest finite value is 448
INT8_QMAX = 127.0
FP8_QMAX = 448.0

_MODES = ("int8", "fp8")

Axis = Union[int, Tuple[int, ...]]


def fp8_supported(device=None) -> bool:
    """True when fp8 e4m3 is worth using on ``device`` (default: the
    current CUDA device): torch has the dtype and the device is a CUDA
    card of capability (8, 9) or later. The CPU reports False."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(dev) >= (8, 9)


def resolve_mode(mode: Optional[str], device=None) -> Optional[str]:
    """None (or "") passes through, "int8" is always available, "fp8"
    becomes "int8" where `fp8_supported(device)` is False; anything else
    raises ValueError."""
    if mode is None or mode == "":
        return None
    if mode not in _MODES:
        raise ValueError(f"unknown quantization mode {mode!r}: "
                         f"expected one of {_MODES} or None")
    if mode == "fp8" and not fp8_supported(device):
        return "int8"
    return mode


def qmax(mode: str) -> float:
    return INT8_QMAX if mode == "int8" else FP8_QMAX


def qdtype(mode: str) -> torch.dtype:
    return torch.int8 if mode == "int8" else torch.float8_e4m3fn


def raw(t: torch.Tensor) -> torch.Tensor:
    """A one-byte tensor's bytes as uint8 (a view): index writes, gathers,
    ``torch.where`` and copies move e4m3 values bit-exactly this way,
    where some of those ops have no float8 kernel."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _round_to_grid(xf: torch.Tensor, scale: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """x / scale on the mode's grid: int8 rounds half to even (as
    jnp.round) and clips to [-127, 127]; e4m3 rounds by the cast."""
    if mode == "int8":
        return torch.clamp(torch.round(xf / scale), -INT8_QMAX,
                           INT8_QMAX).to(torch.int8)
    return (xf / scale).to(torch.float8_e4m3fn)


def absmax_quantize(x: torch.Tensor, axis: Axis, mode: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, scales) of ``x`` on ``mode``'s grid with one scale per
    slice along ``axis`` (kept as size 1): scale = absmax / qmax, 1.0
    for an all-zero slice. ``mode`` is taken as given (no resolution)."""
    xf = x.to(torch.float32)
    amax = torch.amax(xf.abs(), dim=axis, keepdim=True)
    scale = torch.where(amax > 0.0, amax / qmax(mode),
                        torch.ones_like(amax))
    return _round_to_grid(xf, scale, mode), scale


class QuantizedTensor:
    """int8 / e4m3 ``values`` with broadcast-ready float32 ``scales``.

    `.shape` / `.ndim` / `.dtype` report the values; `.nbytes` counts
    values and scales (the at-rest bytes); `.to(dtype)` dequantizes,
    `.to(device)` moves; `qt[i]` slices values and scales in lockstep."""

    __slots__ = ("values", "scales", "mode")

    def __init__(self, values: torch.Tensor, scales: torch.Tensor,
                 mode: str = "int8"):
        self.values = values
        self.scales = scales
        self.mode = mode

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nbytes(self) -> int:
        return (self.values.numel() * self.values.element_size()
                + self.scales.numel() * self.scales.element_size())

    def dequantize(self, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
        """(values in float32 * scales), then the cast to ``dtype``."""
        return (self.values.to(torch.float32) * self.scales).to(dtype)

    def to(self, *args, **kwargs):
        """``.to(dtype)`` -> the dequantized tensor in ``dtype`` (the
        weight idiom); ``.to(device)`` -> a QuantizedTensor there. A call
        naming both moves first, then dequantizes."""
        dtype = kwargs.pop("dtype", None)
        device = kwargs.pop("device", None)
        if kwargs:
            raise TypeError(f"QuantizedTensor.to: unexpected arguments "
                            f"{sorted(kwargs)}")
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            else:
                device = a
        qt = self
        if device is not None:
            qt = QuantizedTensor(self.values.to(device),
                                 self.scales.to(device), self.mode)
        return qt if dtype is None else qt.dequantize(dtype)

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(self.values[idx], self.scales[idx],
                               self.mode)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(mode={self.mode!r}, "
                f"values={tuple(self.values.shape)}@{self.values.dtype}, "
                f"scales={tuple(self.scales.shape)})")


def quantize(x: torch.Tensor, axis: Axis = -2, mode: str = "int8"
             ) -> QuantizedTensor:
    """Symmetric absmax quantization of ``x`` along ``axis`` (the
    reduction axes; everything else gets its own scale): for W [in, out]
    the default ``axis=-2`` is per output channel. ``mode`` resolves
    against ``x``'s device ("fp8" -> "int8" off a capable card)."""
    mode = resolve_mode(mode, x.device)
    if mode is None:
        raise ValueError("quantize() needs a concrete mode, got None")
    values, scales = absmax_quantize(x, axis, mode)
    return QuantizedTensor(values, scales, mode)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Broadcast-multiply back to a dense tensor in ``dtype``."""
    return qt.dequantize(dtype)


def fake_quant(x: torch.Tensor, axis: Axis = -2,
               mode: str = "int8") -> torch.Tensor:
    """quantize -> dequantize at x's dtype: the error a quantized
    deployment sees, without changing the tree."""
    return dequantize(quantize(x, axis=axis, mode=mode), x.dtype)


def quantized_matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` with ``w`` a QuantizedTensor (dequantized into x's dtype
    at use) or a plain tensor (cast): the reference's
    ``jnp.matmul(x, w.astype(x.dtype))``."""
    return torch.matmul(x, w.to(x.dtype))

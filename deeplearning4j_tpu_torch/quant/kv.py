"""Quantized KV pools: int8 / e4m3 rows with one float32 scale per row.

Port of deeplearning4j_tpu/quant/kv.py at tensor-parallel 1 (one card).
The slot pool's [L, Ns, S, D] caches (and the paged pool's
[L, pages, page_size, D]) store each written K/V row quantized on write,
absmax over its D values, with its scale in a parallel float32 plane
[L, Ns, S, 1] ([L, pages, page_size, 1]); a row is written once, so its
scale is final. Unwritten rows hold value 0 and scale 1.0.

Attention never rebuilds a dequantized cache: the decode and window
kernels fold the K scale into the score (``(q.k) * kscale``) and the V
scale into the probability (``(p * vscale) . v``), reading one byte per
cache element (`ops.flash_decode`).

KV handoff (reference :167-209): `handoff_page_bucket` pads a handed-off
page chain to a power-of-two page count, so the gather and adopt
programs have log2-many geometries; `handoff_row_buffers` lays a
`serving.engine.KVHandoff`'s rows (and, quantized, its scales, which
travel with their rows) out at that bucket, page by page, for one
all-layer scatter; `handoff_bytes` is the analytic size of a handoff.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.quant.core import (absmax_quantize, qdtype,
                                                 raw, resolve_mode)


def kv_cache_dtype(kv_mode: str) -> torch.dtype:
    """The pool's value dtype: int8, or float8_e4m3fn for "fp8"."""
    return qdtype(kv_mode)


def quantize_rows(x: torch.Tensor, kv_mode: str = "int8"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [..., D]`` quantized row-wise (absmax over the last axis):
    (values [..., D] int8 / e4m3, scales [...] float32). Zero rows get
    scale 1.0. ``kv_mode`` is taken as given, as the reference's
    (:57-71) is: callers resolve it first."""
    q, scale = absmax_quantize(x, -1, kv_mode)
    return q, scale[..., 0]


def _quant_state(shape, num_slots: int, kv_mode: str, device, what: str):
    kv_mode = resolve_mode(kv_mode, device)
    if kv_mode is None:
        raise ValueError(f"{what} needs kv_mode ('int8'/'fp8')")
    qdt = kv_cache_dtype(kv_mode)
    sshape = tuple(shape[:3]) + (1,)
    ck = torch.zeros(shape, dtype=qdt, device=device)
    cv = torch.zeros(shape, dtype=qdt, device=device)
    ksc = torch.ones(sshape, dtype=torch.float32, device=device)
    vsc = torch.ones(sshape, dtype=torch.float32, device=device)
    pos = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    tok = torch.zeros((num_slots,), dtype=torch.int32, device=device)
    return ck, cv, ksc, vsc, pos, tok


def init_quant_slot_state(cfg, num_slots: int, kv_mode: str = "int8",
                          device=None):
    """The quantized slot pool on ``device``: (ck, cv) int8 / e4m3
    [L, Ns, S, D] zeros, (kscale, vscale) float32 [L, Ns, S, 1] ones,
    pos and tok int32 [Ns] zeros — the 6-tuple the ``kv_mode`` programs
    of `parallel.serving` consume (reference :74-105)."""
    from deeplearning4j_tpu_torch.models.transformer import slot_cache_shape
    return _quant_state(slot_cache_shape(cfg, num_slots), num_slots,
                        kv_mode, device, "init_quant_slot_state")


def init_paged_quant_state(cfg, num_slots: int, page_size: int,
                           num_pages: int, kv_mode: str = "int8",
                           device=None):
    """The quantized paged pool: (kp, vp) int8 / e4m3
    [L, num_pages, page_size, D], (kscale, vscale) float32
    [L, num_pages, page_size, 1], pos and tok int32 [Ns] (reference
    :108-139). A page's rows carry their scales through every block-table
    remap, share and copy-on-write."""
    from deeplearning4j_tpu_torch.models.transformer import page_pool_shape
    return _quant_state(page_pool_shape(cfg, num_pages, page_size),
                        num_slots, kv_mode, device, "init_paged_quant_state")


def _item_and_scales(cfg, rows: int, kv_mode: Optional[str], tp: int,
                     cache_dtype) -> Tuple[int, int]:
    if kv_mode is not None:
        return (torch.tensor([], dtype=kv_cache_dtype(kv_mode))
                .element_size(), 2 * cfg.n_layers * rows * tp * 4)
    dt = cache_dtype if cache_dtype is not None else cfg.cache_torch_dtype()
    return torch.tensor([], dtype=dt).element_size(), 0


def slot_pool_bytes(cfg, num_slots: int, kv_mode: Optional[str] = None,
                    tp: int = 1, cache_dtype=None) -> int:
    """Analytic at-rest bytes of one slot pool: caches, scales and the
    per-slot pos / tok vectors (reference `slot_pool_bytes`)."""
    rows = num_slots * cfg.max_len
    item, scales = _item_and_scales(cfg, rows, kv_mode, tp, cache_dtype)
    return (2 * cfg.n_layers * rows * cfg.d_model * item + scales
            + 2 * num_slots * 4)


def paged_pool_bytes(cfg, num_slots: int, page_size: int, num_pages: int,
                     max_pages: int, kv_mode: Optional[str] = None,
                     tp: int = 1, cache_dtype=None) -> int:
    """Analytic at-rest bytes of one paged pool: page caches, scales,
    block tables and the per-slot vectors (reference
    `paged_pool_bytes`)."""
    rows = num_pages * page_size
    item, scales = _item_and_scales(cfg, rows, kv_mode, tp, cache_dtype)
    return (2 * cfg.n_layers * rows * cfg.d_model * item + scales
            + num_slots * max_pages * 4 + 2 * num_slots * 4)


def handoff_page_bucket(npages: int, max_pages: int) -> int:
    """The power-of-two page count (at most ``max_pages``) that covers
    ``npages``: the row buffers and index vectors of one handoff's gather
    or adopt are padded to it (reference :167)."""
    b = 1
    while b < max(1, int(npages)):
        b *= 2
    return min(b, int(max_pages))


def handoff_row_buffers(kv, n_layers: int, npages: int, page_size: int,
                        value_dtype) -> list:
    """A handoff's rows padded to [L, npages * page_size, X] and viewed
    as [L, npages, page_size, X] host tensors: K and V at
    ``value_dtype``, zero past ``kv.pos``, then for a quantized handoff
    the K and V scales, 1.0 past ``kv.pos`` (the never-written row's
    scale), each row's scale beside it (reference :181). One-byte values
    are copied as their bytes."""
    cap = npages * page_size
    if kv.pos > cap:
        raise ValueError(f"handoff bucket too small: {kv.pos} rows > "
                         f"{npages} pages x {page_size}")
    rows = []
    for src in (kv.k, kv.v):
        buf = torch.zeros((n_layers, cap, src.shape[-1]), dtype=value_dtype)
        src = src.to(value_dtype) if src.dtype != value_dtype else src
        raw(buf)[:, :kv.pos] = raw(src)
        rows.append(buf.view(n_layers, npages, page_size, -1))
    if kv.kv_mode:
        for src in (kv.k_scale, kv.v_scale):
            buf = torch.ones((n_layers, cap, src.shape[-1]),
                             dtype=torch.float32)
            buf[:, :kv.pos] = src
            rows.append(buf.view(n_layers, npages, page_size, -1))
    return rows


def handoff_bytes(cfg, tokens: int, kv_mode: Optional[str] = None,
                  tp: int = 1, cache_dtype=None) -> int:
    """Analytic bytes one KV handoff of ``tokens`` committed rows moves:
    K and V at the pool dtype, plus the float32 row scales of a quantized
    pool (reference :199)."""
    item, scales = _item_and_scales(cfg, tokens, kv_mode, tp, cache_dtype)
    return 2 * cfg.n_layers * tokens * cfg.d_model * item + scales

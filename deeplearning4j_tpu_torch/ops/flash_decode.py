"""Decode attention: the hand-written Hopper kernel and its plain twin.

Port of deeplearning4j_tpu/ops/flash_decode.py's `_decode_kernel` path.
The Pallas kernel becomes `csrc/decode_attention.cu` (see its header for
the design and what bounds it on the card): one query row per
(batch row, head) over a flattened-head cache [B, S, D=H*Dh] or the
stacked [L, B, S, D] with a layer index, `pos` a scalar or a [B] vector.

Routing: `decode_attention` launches the kernel for CUDA tensors (or
raises for what it does not take) and runs `reference_decode_attention`
for CPU tensors only. The quantized-KV form (`k_scale`/`v_scale`,
ROADMAP queue A4) is not ported and raises NotImplementedError.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from deeplearning4j_tpu_torch.ops import _build

NEG_INF = -1e30

_QUANT_TODO = ("quantized-KV decode attention (k_scale/v_scale) is not "
               "ported yet (ROADMAP queue A4)")

PosLike = Union[int, torch.Tensor]


def reference_decode_attention(q, k_cache, v_cache, pos: PosLike,
                               n_heads: int,
                               scale: Optional[float] = None,
                               k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain reference: q [B, H, Dh] at position ``pos`` attends cache
    rows 0..pos (inclusive) of k/v [B, S, D=H*Dh]; returns [B, H, Dh].
    ``pos`` is a scalar (every row at one prefix) or a [B] vector (each
    row masked to its own prefix). Float caches only (reference :93)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(_QUANT_TODO)
    b, s, d = k_cache.shape
    h = n_heads
    dh = d // h
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    # scores keep their float32 sum, as the decode kernel takes it (the
    # TPU kernel's jnp.sum(..., dtype=float32)): a bf16 einsum would
    # round them to bf16 first
    st = torch.promote_types(ct, torch.float32)
    kh = k_cache.reshape(b, s, h, dh).to(st)
    vh = v_cache.reshape(b, s, h, dh).to(ct)
    sc = torch.einsum("bhd,bshd->bhs", q.to(st), kh).to(torch.float32) \
        * scale
    pos_t = torch.as_tensor(pos, device=q.device)
    bound = pos_t[:, None, None] if pos_t.ndim else pos_t
    keep = torch.arange(s, device=q.device)[None, None, :] <= bound
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(ct), vh).to(q.dtype)


def decode_attention_cuda(q, k_cache, v_cache, pos: PosLike, n_heads: int,
                          scale: Optional[float] = None,
                          layer: int = 0) -> torch.Tensor:
    """Launch csrc/decode_attention.cu. The stacked cache's layer plane
    is passed as a pointer offset into the buffer, never copied. Counts
    its launches."""
    if q.ndim != 3 or k_cache.ndim not in (3, 4):
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)}")
    if not (k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError("decode_attention: q and caches must share one "
                         "device")
    if k_cache.shape != v_cache.shape or k_cache.dtype != v_cache.dtype:
        raise ValueError("decode_attention: k and v caches differ")
    if q.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention kernel needs q and cache of one "
                        f"dtype, got {q.dtype} and {k_cache.dtype}")
    code = _build.dtype_code(q.dtype)
    b, h, dh = q.shape
    if h != n_heads:
        raise ValueError(f"q has {h} heads, n_heads={n_heads}")
    if dh not in (32, 64, 128):
        raise ValueError(f"decode_attention kernel takes head dim 32, 64 "
                         f"or 128, got {dh}")
    s, d = k_cache.shape[-2], k_cache.shape[-1]
    if d != h * dh or k_cache.shape[-3] != b:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention kernel needs contiguous caches")
    plane = b * s * d * k_cache.element_size()
    if k_cache.ndim == 4:
        if not 0 <= layer < k_cache.shape[0]:
            raise IndexError(f"layer {layer} out of range "
                             f"[0, {k_cache.shape[0]})")
        off = layer * plane
    else:
        off = 0
    q = q.contiguous()
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("decode_attention kernel reads 16-byte vectors: "
                         "q and caches must be 16-byte aligned")
    if isinstance(pos, torch.Tensor):
        if pos.numel() == 1:
            pos = pos.reshape(1).expand(b)
        if pos.shape != (b,):
            raise ValueError(f"pos must be a scalar or [B]={b}, got "
                             f"{tuple(pos.shape)}")
        pos_t = pos.to(device=q.device, dtype=torch.int32).contiguous()
        pos_ptr, pos_scalar = pos_t.data_ptr(), 0
    else:
        pos_t, pos_ptr, pos_scalar = None, None, int(pos)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    o = torch.empty_like(q)
    fn = _build.load("decode_attention")
    err = fn(q.data_ptr(), k_cache.data_ptr() + off,
             v_cache.data_ptr() + off, o.data_ptr(), pos_ptr, pos_scalar,
             b, h, dh, s, code, float(scale), _build.stream_ptr(q.device))
    _build.check(err, "decode_attention")
    decode_attention_cuda.launches += 1
    return o


decode_attention_cuda.launches = 0


def decode_attention(q, k_cache, v_cache, pos: PosLike, n_heads: int,
                     scale: Optional[float] = None, layer: int = 0,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """q [B, H, Dh] at position ``pos`` (cache row ``pos`` already
    written) attends rows 0..pos of the flattened-head caches [B, S, D]
    or stacked [L, B, S, D] (``layer`` picks the plane). Returns
    [B, H, Dh] in q's dtype: the kernel for CUDA tensors, the plain
    reference for CPU tensors."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(_QUANT_TODO)
    if q.is_cuda:
        return decode_attention_cuda(q, k_cache, v_cache, pos, n_heads,
                                     scale, layer)
    if k_cache.ndim == 4:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    return reference_decode_attention(q, k_cache, v_cache, pos, n_heads,
                                      scale)

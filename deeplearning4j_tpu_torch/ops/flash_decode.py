"""Decode and verify-window attention: the Hopper kernels and their twins.

Port of deeplearning4j_tpu/ops/flash_decode.py's `_decode_kernel` and
`_window_kernel` paths. The Pallas kernels become
`csrc/decode_attention.cu` (one query row per (batch row, head)) and
`csrc/decode_window.cu` (the K+1 rows of a speculative verify window per
(batch row, head), one cache read for all of them); both run the row loop
of `csrc/decode_core.cuh`, so a window row equals the decode kernel at its
own position bit for bit. See the sources' headers for the design and what
bounds them on the card. Caches are flattened-head [B, S, D=H*Dh] or the
stacked [L, B, S, D] with a layer index, `pos` a scalar or a [B] vector.

Routing: `decode_attention` / `decode_window_attention` launch the kernel
for CUDA tensors (or raise for what it does not take) and run
`reference_decode_attention` / `reference_window_attention` for CPU
tensors only. The quantized-KV form (`k_scale`/`v_scale`,
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


def _kernel_args(what: str, q, k_cache, v_cache, pos: PosLike, b: int,
                 h: int, dh: int, n_heads: int, layer: int):
    """The checks the decode and window kernels share. Returns (q made
    contiguous, k and v plane pointers, pos pointer or None, scalar pos,
    the int32 pos tensor, S, dtype code). The caller holds that tensor
    until the launch: freed earlier, its block could be handed to the
    output allocated next."""
    if k_cache.ndim not in (3, 4):
        raise ValueError(f"{what}: bad cache shape {tuple(k_cache.shape)}")
    if not (k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError(f"{what}: q and caches must share one device")
    if k_cache.shape != v_cache.shape or k_cache.dtype != v_cache.dtype:
        raise ValueError(f"{what}: k and v caches differ")
    if q.dtype != k_cache.dtype:
        raise TypeError(f"{what} kernel needs q and cache of one dtype, got "
                        f"{q.dtype} and {k_cache.dtype}")
    code = _build.dtype_code(q.dtype)
    if h != n_heads:
        raise ValueError(f"q has {h} heads, n_heads={n_heads}")
    if dh not in (32, 64, 128):
        raise ValueError(f"{what} kernel takes head dim 32, 64 or 128, got "
                         f"{dh}")
    s, d = k_cache.shape[-2], k_cache.shape[-1]
    if d != h * dh or k_cache.shape[-3] != b:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous caches")
    off = 0
    if k_cache.ndim == 4:
        if not 0 <= layer < k_cache.shape[0]:
            raise IndexError(f"layer {layer} out of range "
                             f"[0, {k_cache.shape[0]})")
        off = layer * b * s * d * k_cache.element_size()
    q = q.contiguous()
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError(f"{what} kernel reads 16-byte vectors: q and "
                         f"caches must be 16-byte aligned")
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
    return (q, k_cache.data_ptr() + off, v_cache.data_ptr() + off, pos_ptr,
            pos_scalar, pos_t, s, code)


def decode_attention_cuda(q, k_cache, v_cache, pos: PosLike, n_heads: int,
                          scale: Optional[float] = None,
                          layer: int = 0) -> torch.Tensor:
    """Launch csrc/decode_attention.cu. The stacked cache's layer plane
    is passed as a pointer offset into the buffer, never copied. Counts
    its launches."""
    if q.ndim != 3:
        raise ValueError(f"decode_attention: bad q shape {tuple(q.shape)}")
    b, h, dh = q.shape
    q, kp, vp, pos_ptr, pos_scalar, pos_keep, s, code = _kernel_args(
        "decode_attention", q, k_cache, v_cache, pos, b, h, dh, n_heads,
        layer)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    o = torch.empty_like(q)
    fn = _build.load("decode_attention")
    err = fn(q.data_ptr(), kp, vp, o.data_ptr(), pos_ptr, pos_scalar, b, h,
             dh, s, code, float(scale), _build.stream_ptr(q.device))
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


def reference_window_attention(q, k_cache, v_cache, pos: PosLike,
                               n_heads: int, scale: Optional[float] = None,
                               k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain reference for the speculative-verify window (reference
    :139-184): q [B, T, H, Dh] holds T = K+1 query rows per batch row;
    row t sits at position ``pos[b] + t`` and attends cache rows
    0..clip(pos[b]+t, 0, S-1) of k/v [B, S, D=H*Dh]. Returns
    [B, T, H, Dh]. Scores keep their float32 sum, as
    `reference_decode_attention` and the kernels take it; then the scale,
    the NEG_INF mask, a float32 softmax, and the probabilities rounded to
    the value dtype before the PV product. Float caches only."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(_QUANT_TODO)
    b, t, h, dh = q.shape
    s = k_cache.shape[-2]
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    st = torch.promote_types(ct, torch.float32)
    kh = k_cache.reshape(b, s, h, dh).to(st)
    vh = v_cache.reshape(b, s, h, dh).to(ct)
    sc = torch.einsum("bthd,bshd->bhts", q.to(st), kh).to(torch.float32) \
        * scale
    pos_t = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    wp = torch.clamp(pos_t + torch.arange(t, device=q.device)[None, :], 0,
                     s - 1)                                 # [B or 1, T]
    keep = torch.arange(s, device=q.device)[None, None, None, :] \
        <= wp[:, None, :, None]
    sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(ct), vh).to(q.dtype)


def decode_window_attention_cuda(q, k_cache, v_cache, pos: PosLike,
                                 n_heads: int, scale: Optional[float] = None,
                                 layer: int = 0) -> torch.Tensor:
    """Launch csrc/decode_window.cu on q [B, T, H, Dh]: one read of the
    cache (or of the stacked cache's layer plane, passed as a pointer
    offset) for every window row of up to 8. Counts its launches."""
    if q.ndim != 4:
        raise ValueError(f"decode_window_attention: bad q shape "
                         f"{tuple(q.shape)}")
    b, t, h, dh = q.shape
    q, kp, vp, pos_ptr, pos_scalar, pos_keep, s, code = _kernel_args(
        "decode_window_attention", q, k_cache, v_cache, pos, b, h, dh,
        n_heads, layer)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    o = torch.empty_like(q)
    fn = _build.load("decode_window")
    err = fn(q.data_ptr(), kp, vp, o.data_ptr(), pos_ptr, pos_scalar, b, t,
             h, dh, s, code, float(scale), _build.stream_ptr(q.device))
    _build.check(err, "decode_window_attention")
    decode_window_attention_cuda.launches += 1
    return o


decode_window_attention_cuda.launches = 0


def decode_window_attention(q, k_cache, v_cache, pos: PosLike, n_heads: int,
                            scale: Optional[float] = None, layer: int = 0,
                            k_scale=None, v_scale=None) -> torch.Tensor:
    """K+1-window attention of the speculative verify pass: q
    [B, T, H, Dh], window row t of batch row b at position ``pos[b] + t``
    (its cache row already written) attends rows 0..pos[b]+t of the
    flattened-head caches [B, S, D] or stacked [L, B, S, D] (``layer``
    picks the plane). Returns [B, T, H, Dh] in q's dtype: the kernel for
    CUDA tensors, the plain reference for CPU tensors. The TPU kernel's
    block sizing (VMEM budget, DL4JTPU_DECODE_BS and
    DL4JTPU_DECODE_BLOCK_BYTES) has no counterpart here: the CUDA kernel
    walks rows, not blocks."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(_QUANT_TODO)
    if q.is_cuda:
        return decode_window_attention_cuda(q, k_cache, v_cache, pos,
                                            n_heads, scale, layer)
    if k_cache.ndim == 4:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    return reference_window_attention(q, k_cache, v_cache, pos, n_heads,
                                      scale)


# ---------------------------------------------------------------------------
# the decode kernel at swept launch geometries (benchmarks/decode_kernel_sweep)
# ---------------------------------------------------------------------------

SWEEP_WARPS = (4, 8)                     # warps per CTA the kernel takes
PRODUCTION_WARPS = 4                     # decode_core.cuh's WARPS


def reference_split_decode_attention(q, k_cache, v_cache, pos: PosLike,
                                     n_heads: int, bs: int,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain twin of csrc/decode_sweep.cu: the function of
    `reference_decode_attention` (q [B, H, Dh] at ``pos`` attends rows
    0..pos of k/v [B, S, D=H*Dh]; scalar or [B] pos), computed as the
    kernel splits it. Each run of ``bs`` cache rows gives a float32
    partial: its max score m, l = sum exp(s - m) and acc = sum of
    exp(s - m) rounded to the value dtype times v. The partials of the
    splits that start at or before pos merge by their weights
    exp(m - max m); splits wholly past pos take no part."""
    b, s, d = k_cache.shape
    h = n_heads
    dh = d // h
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    ct = torch.promote_types(q.dtype, k_cache.dtype)
    st = torch.promote_types(ct, torch.float32)
    ns = -(-s // bs)
    pad = ns * bs - s
    kh = k_cache.reshape(b, s, h, dh).to(st)
    vh = torch.nn.functional.pad(v_cache.reshape(b, s, h, dh).to(st),
                                 (0, 0, 0, 0, 0, pad))
    sc = torch.einsum("bhd,bshd->bhs", q.to(st), kh).to(torch.float32) \
        * scale
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(q.device).clamp(0, s - 1)
        bound = pos_t[:, None, None] if pos_t.ndim else pos_t
    else:   # a Python int stays on the host (no copy: CUDA-graph safe)
        bound = min(max(int(pos), 0), s - 1)
    rows = torch.arange(ns * bs, device=q.device)[None, None, :]
    sc = torch.nn.functional.pad(sc, (0, pad))
    sc = torch.where(rows <= bound, sc, torch.full_like(sc, NEG_INF))
    sc = sc.reshape(b, h, ns, bs)
    m = sc.amax(dim=-1)                                   # [B, H, ns]
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    pr = p.to(ct).to(st)
    acc = torch.einsum("bhns,bnshd->bhnd", pr,
                       vh.reshape(b, ns, bs, h, dh)).to(torch.float32)
    starts = torch.arange(ns, device=q.device)[None, None, :] * bs
    live = starts <= bound
    mt = torch.where(live, m, torch.full_like(m, float("-inf"))).amax(
        dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mt), torch.zeros_like(m))
    lt = (w * l).sum(dim=-1)
    at = (w[..., None] * acc).sum(dim=-2)
    return (at / lt[..., None]).to(q.dtype)


def decode_sweep_cuda(q, k_cache, v_cache, pos: PosLike, n_heads: int,
                      bs: int, warps: int = PRODUCTION_WARPS,
                      scale: Optional[float] = None,
                      layer: int = 0) -> torch.Tensor:
    """Launch csrc/decode_sweep.cu: ceil(S/bs) CTAs of ``warps`` warps
    along S for each (b, h), then the merge of their partials. Same
    checks and cache forms as `decode_attention_cuda` (the stacked
    cache's layer plane is a pointer offset, never copied). One call
    launches the split kernel and the merge and counts one launch."""
    if q.ndim != 3:
        raise ValueError(f"decode_sweep: bad q shape {tuple(q.shape)}")
    if warps not in SWEEP_WARPS:
        raise ValueError(f"decode_sweep kernel takes {SWEEP_WARPS} warps, "
                         f"got {warps}")
    if bs < 1:
        raise ValueError(f"decode_sweep: bs must be >= 1, got {bs}")
    b, h, dh = q.shape
    q, kp, vp, pos_ptr, pos_scalar, pos_keep, s, code = _kernel_args(
        "decode_sweep", q, k_cache, v_cache, pos, b, h, dh, n_heads, layer)
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    ns = -(-s // bs)
    o = torch.empty_like(q)
    part = torch.empty((2, b, h, ns), dtype=torch.float32, device=q.device)
    acc = torch.empty((b, h, ns, dh), dtype=torch.float32, device=q.device)
    fn = _build.load("decode_sweep")
    err = fn(q.data_ptr(), kp, vp, o.data_ptr(), part[0].data_ptr(),
             part[1].data_ptr(), acc.data_ptr(), pos_ptr, pos_scalar, b, h,
             dh, s, int(bs), int(warps), code, float(scale),
             _build.stream_ptr(q.device))
    _build.check(err, "decode_sweep")
    decode_sweep_cuda.launches += 1
    return o


decode_sweep_cuda.launches = 0


def is_production_geometry(bs: int, warps: int, s: int) -> bool:
    """One CTA over the whole cache with decode_core.cuh's 4 warps: the
    production decode kernel's own launch."""
    return bs >= s and warps == PRODUCTION_WARPS


def decode_sweep(q, k_cache, v_cache, pos: PosLike, n_heads: int, bs: int,
                 warps: int = PRODUCTION_WARPS, scale: Optional[float] = None,
                 layer: int = 0) -> torch.Tensor:
    """Decode attention at launch geometry (bs cache rows per CTA, warps
    per CTA), for the decode-kernel sweep. CUDA tensors: the production
    geometry goes to the production kernel (`decode_attention_cuda`),
    every other one to `decode_sweep_cuda`. CPU tensors: the plain twin
    `reference_split_decode_attention` at the same bs."""
    if q.is_cuda:
        if is_production_geometry(bs, warps, k_cache.shape[-2]):
            return decode_attention_cuda(q, k_cache, v_cache, pos, n_heads,
                                         scale, layer)
        return decode_sweep_cuda(q, k_cache, v_cache, pos, n_heads, bs,
                                 warps, scale, layer)
    if k_cache.ndim == 4:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    return reference_split_decode_attention(q, k_cache, v_cache, pos,
                                            n_heads, bs, scale)

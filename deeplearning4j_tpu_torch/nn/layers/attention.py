"""Attention core and layer norm (port of nn/layers/attention.py:36,88).

`dot_product_attention` follows the reference's routing: a key mask or
a float64 input takes the plain math below (as it does in JAX, where
the kernel computes in float32 and takes no mask); every other call goes
through `ops.flash_attention`, i.e. the CUDA kernel for CUDA tensors and
its plain twin for CPU tensors. The serving path never passes a mask.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          q_offset: int = 0, kv_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention.

    q: [B, T, H, Dh]; k, v: [B, S, H, Dh] -> [B, T, H, Dh].
    ``mask``: optional [B, S] {0,1} key-validity mask.
    ``q_offset``/``kv_offset``: global positions of q[0] / k[0] — causal
    masking compares global positions. Scores and softmax accumulate in
    at least float32 (float64 inputs keep float64); masked scores are the
    finite NEG_INF, so fully-masked rows average uniformly as in JAX."""
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else scale
    if mask is None and q.dtype != torch.float64:
        from deeplearning4j_tpu_torch.ops.flash_attention import \
            flash_attention
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_offset=kv_offset, scale=float(scale))
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc)) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        cm = qpos[:, None] >= kpos[None, :]
        scores = torch.where(cm[None, None], scores,
                             torch.full_like(scores, NEG_INF))
    if mask is not None:
        keep = mask[:, None, None, :].to(torch.bool)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", weights.to(v.dtype), v)


def layer_norm(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis in at least float32, returned in
    x's dtype. The variance is the population variance (jnp.var)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)

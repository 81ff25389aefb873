"""Flash-attention forward: the hand-written Hopper kernel and its plain twin.

Port of deeplearning4j_tpu/ops/flash_attention.py (forward only). The
Pallas kernel `_flash_fwd_kernel` becomes `csrc/flash_fwd.cu` (see its
header for the design and what bounds it on the card). The TPU-only
workarounds of the reference — `_FWD_Q_CHUNK`, `_bh_chunks`, the
`_MAX_2D_GRID_*` caps and the VMEM budget notes — have no counterpart:
they bounded a compile helper and a 16 MB VMEM budget, not the math.

Routing: `flash_forward` launches the CUDA kernel for CUDA tensors (or
raises for what it does not take) and runs `flash_forward_reference`
for CPU tensors only. There is no switch that sends CUDA tensors to the
plain path. The backward (ROADMAP queue B #2) is not ported: asking for
a gradient raises NotImplementedError.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build

NEG_INF = -1e30
BLOCK_K = 64          # the kernel's k tile; the plain twin uses the same

_BACKWARD_TODO = ("flash-attention backward is not ported yet (ROADMAP "
                  "queue B #2, the train-step slice)")


def _reference_attention(q, k, v, scale: float, causal: bool,
                         q_offset: int, kv_offset: int):
    """Plain reference on [B*H, T, D]: f32 softmax, probabilities cast to
    the query dtype before the PV product (reference :80)."""
    s = torch.einsum("btd,bsd->bts", q, k).to(torch.float32) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :] + kv_offset
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p.to(q.dtype), v)


def flash_forward_reference(q3, k3, v3, scale: float, causal: bool,
                            q_offset: int = 0, kv_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch twin of the kernel: (o, m, logl) for [BH, T, Dh]
    inputs, m and logl float32 [BH, T, 1].

    Follows `_flash_fwd_kernel`'s math (reference :138-197): online
    softmax over k tiles with float32 statistics, probabilities rounded
    to the value dtype before the PV product, masked scores at the finite
    NEG_INF, and m and log l kept SEPARATE (reference :186-194: their sum
    would lose a fully-masked row's log l to float32 rounding). Every k
    tile is visited; the kernel's causal skip only drops tiles whose
    contribution is exactly zero."""
    bh, tq, dh = q3.shape
    sk = k3.shape[1]
    qf = q3.to(torch.float32)
    qpos = torch.arange(tq, device=q3.device)[:, None] + q_offset
    m = torch.full((bh, tq, 1), float("-inf"), dtype=torch.float32,
                   device=q3.device)
    l = torch.zeros((bh, tq, 1), dtype=torch.float32, device=q3.device)
    acc = torch.zeros((bh, tq, dh), dtype=torch.float32, device=q3.device)
    for k0 in range(0, sk, BLOCK_K):
        kj = k3[:, k0:k0 + BLOCK_K].to(torch.float32)
        vj = v3[:, k0:k0 + BLOCK_K].to(torch.float32)
        s = torch.matmul(qf, kj.transpose(1, 2)) * scale
        if causal:
            kpos = torch.arange(k0, k0 + kj.shape[1],
                                device=q3.device)[None, :] + kv_offset
            s = s.masked_fill(qpos < kpos, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pr = p.to(v3.dtype).to(torch.float32)
        acc = acc * corr + torch.matmul(pr, vj)
        m = m_new
    return (acc / l).to(q3.dtype), m, torch.log(l)


def _check_cuda_inputs(q3, k3, v3) -> None:
    if not (k3.is_cuda and v3.is_cuda):
        raise ValueError("flash_forward: q, k, v must share one device")
    if q3.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise TypeError(f"flash_forward kernel takes float32, float16 or "
                        f"bfloat16, got {q3.dtype}")
    if k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError("flash_forward kernel needs q, k, v of one dtype")
    if q3.ndim != 3 or k3.shape != v3.shape or k3.shape[0] != q3.shape[0] \
            or k3.shape[2] != q3.shape[2]:
        raise ValueError(f"flash_forward: bad shapes q{tuple(q3.shape)} "
                         f"k{tuple(k3.shape)} v{tuple(v3.shape)}")
    if q3.shape[2] not in (32, 64, 128):
        raise ValueError(f"flash_forward kernel takes head dim 32, 64 or "
                         f"128, got {q3.shape[2]}")


def flash_forward_cuda(q3, k3, v3, scale: float, causal: bool,
                       q_offset: int = 0, kv_offset: int = 0):
    """Launch csrc/flash_fwd.cu on CUDA tensors [BH, T, Dh]; returns
    (o, m, logl) like the plain twin. Counts its launches."""
    _check_cuda_inputs(q3, k3, v3)
    q3, k3, v3 = q3.contiguous(), k3.contiguous(), v3.contiguous()
    bh, tq, dh = q3.shape
    sk = k3.shape[1]
    o = torch.empty_like(q3)
    m = torch.empty((bh, tq, 1), dtype=torch.float32, device=q3.device)
    logl = torch.empty_like(m)
    fn = _build.load("flash_fwd")
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
             m.data_ptr(), logl.data_ptr(), bh, tq, sk, dh,
             _build.dtype_code(q3.dtype), float(scale), int(bool(causal)),
             int(q_offset), int(kv_offset), _build.stream_ptr(q3.device))
    _build.check(err, "flash_fwd")
    flash_forward_cuda.launches += 1
    return o, m, logl


flash_forward_cuda.launches = 0


def flash_forward(q3, k3, v3, scale: float, causal: bool,
                  q_offset: int = 0, kv_offset: int = 0):
    """(o, m, logl) on [BH, T, Dh]: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    if any(t.requires_grad for t in (q3, k3, v3)) \
            and torch.is_grad_enabled():
        raise NotImplementedError(_BACKWARD_TODO)
    if q3.is_cuda:
        return flash_forward_cuda(q3, k3, v3, scale, causal, q_offset,
                                  kv_offset)
    return flash_forward_reference(q3, k3, v3, scale, causal, q_offset,
                                   kv_offset)


def flash_attention(q, k, v, *, causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, T, H, Dh] attention through the flash forward. Same contract
    as nn.layers.attention.dot_product_attention (which dispatches
    here)."""
    b, tq, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def to3(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    out3, _, _ = flash_forward(to3(q), to3(k), to3(v), float(scale),
                               bool(causal), int(q_offset), int(kv_offset))
    return out3.reshape(b, h, tq, d).permute(0, 2, 1, 3)

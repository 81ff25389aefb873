"""Flash attention: the hand-written Hopper kernels and their plain twins.

Port of deeplearning4j_tpu/ops/flash_attention.py. The Pallas kernels
`_flash_fwd_kernel` and `_flash_dqkv_kernel` become `csrc/flash_fwd.cu`
and `csrc/flash_bwd.cu` (see their headers for the designs and what
bounds them on the card), and the reference's `_flash_attention3`
custom_vjp becomes the `FlashAttention` autograd.Function. The TPU-only
workarounds of the reference have no counterpart: `_FWD_Q_CHUNK`,
`_BWD_Q_CHUNK`, the `_BWD_K_CHUNK` / `_BWD_LONG_TILE` host tiling of
long backward passes, `_bh_chunks` and the `_MAX_2D_GRID_*` caps bounded
a compile helper and a 16 MB VMEM budget, not the math. Nor does the
reference's jnp-recompute backward for kv lengths that do not tile: the
kernels mask the ragged tail, so they take any length.

Routing: `flash_forward` / `flash_backward` launch the CUDA kernels for
CUDA tensors (or raise for what they do not take) and run
`flash_forward_reference` / `flash_backward_reference` for CPU tensors
only. There is no switch that sends CUDA tensors to the plain path.

On the card the bf16 and f16 inputs take the kernels' tensor-core tile
(`csrc/mma_tile.cuh`: `mma.sync` with float32 accumulators, P and dS
rounded to the input dtype as they become the next product's operand,
which is where the twins round them too), and float32 inputs take the
earlier SIMT kernels, exact to 1e-5 against the twins. The tiles are
staged with 16-byte `cp.async` copies, so for those dtypes the wrappers
raise on a q, k, v or dO that is not 16-byte aligned.

The head-packing experiment's backward
(benchmarks/headpack_experiment.py `_packed2_kernel`: two batch-heads per
program, dQ, dK and dV in one pass) is `csrc/flash_bwd_packed2.cu` with
the twin `packed2_backward_reference`, routed the same way by
`packed2_backward`, which q-chunks at 512 rows as the experiment does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build

NEG_INF = -1e30
BLOCK_K = 64          # the kernel's k tile; the plain twins use the same


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


def flash_backward_reference(q3, k3, v3, do3, m, logl, delta, scale: float,
                             causal: bool, q_offset: int = 0,
                             kv_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch twin of the backward kernel: (dq, dk, dv) in the
    input dtype from q, k, v, dO [BH, *, Dh] and the forward's float32
    m, log l and delta = rowsum(dO * O), each [BH, T, 1].

    Follows `_flash_dqkv_kernel` (reference :202-293) over k tiles:
    probabilities recomputed from the masked scores and the saved
    statistics, as exp(s - (m + log l)) when causal and kv_offset <=
    q_offset and exp((s - m) - log l) otherwise (:258-259; the separate
    form keeps a fully-masked row at its uniform p = 1/S); dV += P^T dO
    with P rounded to dO's dtype; dS = P * (dO V^T - delta), zeroed at
    masked positions and rounded to q's dtype; dK += dS^T Q, dQ += dS K;
    dK and dQ scaled by ``scale`` at the end. Accumulation in float32."""
    bh, tq, dh = q3.shape
    sk = k3.shape[1]
    dev = q3.device
    skip_safe = causal and kv_offset <= q_offset
    qf, dof = q3.to(torch.float32), do3.to(torch.float32)
    qpos = torch.arange(tq, device=dev)[:, None] + q_offset
    dq = torch.zeros((bh, tq, dh), dtype=torch.float32, device=dev)
    dk = torch.empty((bh, sk, dh), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    for k0 in range(0, sk, BLOCK_K):
        kj = k3[:, k0:k0 + BLOCK_K].to(torch.float32)
        vj = v3[:, k0:k0 + BLOCK_K].to(torch.float32)
        s = torch.matmul(qf, kj.transpose(1, 2)) * scale
        masked = None
        if causal:
            kpos = torch.arange(k0, k0 + kj.shape[1],
                                device=dev)[None, :] + kv_offset
            masked = qpos < kpos
            s = s.masked_fill(masked, NEG_INF)
        p = torch.exp(s - (m + logl)) if skip_safe \
            else torch.exp((s - m) - logl)
        pr = p.to(do3.dtype).to(torch.float32)
        dv[:, k0:k0 + BLOCK_K] = torch.matmul(pr.transpose(1, 2), dof)
        ds = p * (torch.matmul(dof, vj.transpose(1, 2)) - delta)
        if masked is not None:
            ds = ds.masked_fill(masked, 0.0)
        dsq = ds.to(q3.dtype).to(torch.float32)
        dk[:, k0:k0 + BLOCK_K] = torch.matmul(dsq.transpose(1, 2), qf)
        dq += torch.matmul(dsq, kj)
    return ((dq * scale).to(q3.dtype), (dk * scale).to(k3.dtype),
            dv.to(v3.dtype))


def _check_cuda_inputs(q3, k3, v3, what: str = "flash_forward") -> None:
    if not (k3.is_cuda and v3.is_cuda):
        raise ValueError(f"{what}: q, k, v must share one device")
    if q3.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32, float16 or "
                        f"bfloat16, got {q3.dtype}")
    if k3.dtype != q3.dtype or v3.dtype != q3.dtype:
        raise TypeError(f"{what} kernel needs q, k, v of one dtype")
    if q3.ndim != 3 or k3.shape != v3.shape or k3.shape[0] != q3.shape[0] \
            or k3.shape[2] != q3.shape[2]:
        raise ValueError(f"{what}: bad shapes q{tuple(q3.shape)} "
                         f"k{tuple(k3.shape)} v{tuple(v3.shape)}")
    if q3.shape[2] not in (32, 64, 128):
        raise ValueError(f"{what} kernel takes head dim 32, 64 or "
                         f"128, got {q3.shape[2]}")


def _check_backward_inputs(q3, k3, v3, do3, m, logl, delta,
                           what: str) -> None:
    _check_cuda_inputs(q3, k3, v3, what)
    bh, tq, _ = q3.shape
    if not do3.is_cuda or do3.dtype != q3.dtype or do3.shape != q3.shape:
        raise ValueError(f"{what}: dO must be a CUDA tensor like q "
                         f"{tuple(q3.shape)} {q3.dtype}, got "
                         f"{tuple(do3.shape)} {do3.dtype}")
    for name, t in (("m", m), ("logl", logl), ("delta", delta)):
        if not t.is_cuda or t.dtype != torch.float32 \
                or t.shape != (bh, tq, 1):
            raise ValueError(f"{what}: {name} must be a float32 CUDA "
                             f"tensor of shape {(bh, tq, 1)}")


def _check_aligned(what: str, *tensors) -> None:
    """The bf16 / f16 kernels stage q, k, v and dO with 16-byte cp.async
    copies: those pointers must be 16-byte aligned (fresh allocations
    are; a view at an odd storage offset is not). The float32 kernels and
    the statistics' 4-byte loads take any element-aligned pointer."""
    if tensors[0].dtype == torch.float32:
        return
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: CUDA tensor at {t.data_ptr():#x} is "
                             f"not 16-byte aligned (cp.async needs it)")


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
    _check_aligned("flash_fwd", q3, k3, v3)
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
    plain twin for CPU tensors. Like the reference's `_flash_forward` it
    records no autograd graph on either device; gradients flow through
    `flash_attention` (the `FlashAttention` autograd.Function)."""
    with torch.no_grad():
        if q3.is_cuda:
            return flash_forward_cuda(q3, k3, v3, scale, causal, q_offset,
                                      kv_offset)
        return flash_forward_reference(q3, k3, v3, scale, causal, q_offset,
                                       kv_offset)


def flash_backward_cuda(q3, k3, v3, do3, m, logl, delta, scale: float,
                        causal: bool, q_offset: int = 0, kv_offset: int = 0):
    """Launch csrc/flash_bwd.cu on CUDA tensors; returns (dq, dk, dv)
    like the plain twin. One call launches its two kernels (dK/dV, then
    dQ) and counts one launch."""
    _check_backward_inputs(q3, k3, v3, do3, m, logl, delta,
                           "flash_backward")
    bh, tq, dh = q3.shape
    q3, k3, v3, do3, m, logl, delta = (
        t.contiguous() for t in (q3, k3, v3, do3, m, logl, delta))
    sk = k3.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    _check_aligned("flash_bwd", q3, k3, v3, do3)
    fn = _build.load("flash_bwd")
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
             m.data_ptr(), logl.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), bh, tq, sk, dh,
             _build.dtype_code(q3.dtype), float(scale), int(bool(causal)),
             int(q_offset), int(kv_offset), _build.stream_ptr(q3.device))
    _build.check(err, "flash_bwd")
    flash_backward_cuda.launches += 1
    return dq, dk, dv


flash_backward_cuda.launches = 0


def flash_backward(q3, k3, v3, do3, m, logl, delta, scale: float,
                   causal: bool, q_offset: int = 0, kv_offset: int = 0):
    """(dq, dk, dv): the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors."""
    fn = flash_backward_cuda if q3.is_cuda else flash_backward_reference
    return fn(q3, k3, v3, do3, m, logl, delta, scale, causal, q_offset,
              kv_offset)


def _inner_block(n: int, cap: int = 512) -> int:
    """The JAX package's score-tile edge (its ops/flash_attention.py:65):
    the largest power of two <= cap dividing n, or n itself when it fits
    in one tile or nothing divides it. A copy, so the port imports
    nothing of that package."""
    if n <= cap:
        return n
    b = cap
    while n % b and b > 8:
        b //= 2
    return b if n % b == 0 else n


def _check_pairs(q3) -> None:
    if q3.shape[0] % 2:
        raise ValueError(f"packed2_backward packs two batch-heads per "
                         f"program: bh must be even, got {q3.shape[0]}")


def packed2_backward_reference(q3, k3, v3, do3, m, logl, delta,
                               scale: float, causal: bool, q_offset: int = 0,
                               kv_offset: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain twin of the two-heads-per-program backward
    (benchmarks/headpack_experiment.py:62 `_packed2_kernel`): the same
    (dq, dk, dv) as `flash_backward_reference`, summed in that kernel's
    order. Batch-heads pair up as (2i, 2i+1); the pairs are independent
    programs, so they run as one batch dimension. For each k tile (edge
    `_inner_block(sk, 256)`), slot 0 then slot 1 walk the q tiles (edge
    `_inner_block(tq)`) from the first one that reaches the tile (causal
    skip only when kv_offset <= q_offset), the causal mask applied on the
    tiles that straddle the diagonal; dK and dV of the tile sum in
    float32 over the q tiles and dQ sums in a float32 accumulator over
    the k tiles, scaled at the end."""
    _check_pairs(q3)
    bh, tq, dh = q3.shape
    sk = k3.shape[1]
    dev = q3.device
    bq, bk = _inner_block(tq), _inner_block(sk, 256)
    nqb = tq // bq
    skip_safe = causal and kv_offset <= q_offset

    def pairs(t):
        return t.to(torch.float32).reshape(bh // 2, 2, *t.shape[1:])

    q, k, v, do, mm, ll, dd = (pairs(t) for t in (q3, k3, v3, do3, m, logl,
                                                  delta))
    dq_acc = torch.zeros_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, sk, bk):
        ki0 = k0 + kv_offset
        start = max(0, -(-(ki0 - q_offset - (bq - 1)) // bq)) \
            if skip_safe else 0
        full_start = min(max(-(-(ki0 + bk - 1 - q_offset) // bq), start),
                         nqb) if causal else start
        for slot in range(2):
            kj, vj = k[:, slot, k0:k0 + bk], v[:, slot, k0:k0 + bk]
            dka = torch.zeros_like(kj)
            dva = torch.zeros_like(vj)
            for i in range(start, nqb):
                rows = slice(i * bq, (i + 1) * bq)
                qi, doi = q[:, slot, rows], do[:, slot, rows]
                mi, li, di = (t[:, slot, rows] for t in (mm, ll, dd))
                s = torch.matmul(qi, kj.transpose(1, 2)) * scale
                valid = None
                if causal and i < full_start:
                    qpos = torch.arange(i * bq, (i + 1) * bq,
                                        device=dev)[:, None] + q_offset
                    kpos = torch.arange(bk, device=dev)[None, :] + ki0
                    valid = qpos >= kpos
                    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
                p = torch.exp(s - (mi + li)) if skip_safe \
                    else torch.exp((s - mi) - li)
                pr = p.to(do3.dtype).to(torch.float32)
                dva += torch.matmul(pr.transpose(1, 2), doi)
                ds = p * (torch.matmul(doi, vj.transpose(1, 2)) - di)
                if valid is not None:
                    ds = torch.where(valid, ds, torch.zeros_like(ds))
                dsq = ds.to(q3.dtype).to(torch.float32)
                dka += torch.matmul(dsq.transpose(1, 2), qi)
                dq_acc[:, slot, rows] += torch.matmul(dsq, kj)
            dk[:, slot, k0:k0 + bk] = dka * scale
            dv[:, slot, k0:k0 + bk] = dva
    return ((dq_acc * scale).to(q3.dtype).reshape(bh, tq, dh),
            dk.to(k3.dtype).reshape(bh, sk, dh),
            dv.to(v3.dtype).reshape(bh, sk, dh))


def packed2_backward_cuda(q3, k3, v3, do3, m, logl, delta, scale: float,
                          causal: bool, q_offset: int = 0,
                          kv_offset: int = 0):
    """Launch csrc/flash_bwd_packed2.cu on CUDA tensors: ONE launch for
    dq, dk and dv, one CTA per pair of batch-heads. Takes head dims 32
    and 64 (the experiment's Dh=64 heads; two slots' tiles of Dh=128 do
    not fit a CTA's shared memory). Counts its launches."""
    _check_backward_inputs(q3, k3, v3, do3, m, logl, delta,
                           "packed2_backward")
    _check_pairs(q3)
    bh, tq, dh = q3.shape
    if dh not in (32, 64):
        raise ValueError(f"packed2_backward kernel takes head dim 32 or 64, "
                         f"got {dh}")
    q3, k3, v3, do3, m, logl, delta = (
        t.contiguous() for t in (q3, k3, v3, do3, m, logl, delta))
    sk = k3.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    # dQ's float32 accumulator: [2, tq, Dh] per CTA is 256 KB at tq=512,
    # more than a CTA's shared memory, so it lives in device memory (L2)
    ws = torch.empty((bh, tq, dh), dtype=torch.float32, device=q3.device)
    _check_aligned("flash_bwd_packed2", q3, k3, v3, do3)
    fn = _build.load("flash_bwd_packed2")
    err = fn(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
             m.data_ptr(), logl.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), bh, tq, sk, dh,
             _build.dtype_code(q3.dtype), float(scale), int(bool(causal)),
             int(q_offset), int(kv_offset), _build.stream_ptr(q3.device))
    _build.check(err, "flash_bwd_packed2")
    packed2_backward_cuda.launches += 1
    return dq, dk, dv


packed2_backward_cuda.launches = 0

PACKED2_Q_CHUNK = 512


def q_chunked(fn, q3, k3, v3, do3, m, logl, delta, scale: float,
              causal: bool, q_offset: int = 0, kv_offset: int = 0):
    """A backward ``fn`` over q chunks of PACKED2_Q_CHUNK rows when tq is
    a larger multiple of it (headpack_experiment.py:148-173): each chunk at
    q_offset + lo against the whole k/v, dq concatenated, dk and dv summed
    in float32 over the chunks and cast back. Otherwise one call."""
    tq, chunk = q3.shape[1], PACKED2_Q_CHUNK
    if not (tq > chunk and tq % chunk == 0):
        return fn(q3, k3, v3, do3, m, logl, delta, scale, causal, q_offset,
                  kv_offset)
    dqs, dk, dv = [], None, None
    for lo in range(0, tq, chunk):
        sl = slice(lo, lo + chunk)
        dq_c, dk_c, dv_c = fn(q3[:, sl], k3, v3, do3[:, sl], m[:, sl],
                              logl[:, sl], delta[:, sl], scale, causal,
                              q_offset + lo, kv_offset)
        dqs.append(dq_c)
        dk = dk_c.to(torch.float32) if dk is None \
            else dk + dk_c.to(torch.float32)
        dv = dv_c.to(torch.float32) if dv is None \
            else dv + dv_c.to(torch.float32)
    return torch.cat(dqs, dim=1), dk.to(k3.dtype), dv.to(v3.dtype)


def packed2_backward(q3, k3, v3, do3, m, logl, delta, scale: float,
                     causal: bool, q_offset: int = 0, kv_offset: int = 0):
    """(dq, dk, dv) of the head-packing experiment, q-chunked at 512 rows
    as the JAX experiment's `packed2_backward` is: the packed kernel
    (one launch a chunk) for CUDA tensors, its plain twin for CPU
    tensors."""
    fn = packed2_backward_cuda if q3.is_cuda else packed2_backward_reference
    return q_chunked(fn, q3, k3, v3, do3, m, logl, delta, scale, causal,
                     q_offset, kv_offset)


class FlashAttention(torch.autograd.Function):
    """[BH, T, Dh] flash attention with the flash backward as its
    gradient: the counterpart of the reference's `_flash_attention3`
    custom_vjp (:471-482, :614). The forward saves (q, k, v, o, m, log l);
    the backward computes delta = rowsum(dO * O) in float32 (:438-439)
    and calls `flash_backward`. Under remat the checkpointed block re-runs
    the forward, so the forward kernel launches again in backward."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale, causal, q_offset, kv_offset):
        o, m, logl = flash_forward(q3, k3, v3, scale, causal, q_offset,
                                   kv_offset)
        ctx.save_for_backward(q3, k3, v3, o, m, logl)
        ctx.statics = (scale, causal, q_offset, kv_offset)
        return o

    @staticmethod
    def backward(ctx, do3):
        q3, k3, v3, o, m, logl = ctx.saved_tensors
        delta = (do3.to(torch.float32) * o.to(torch.float32)).sum(
            -1, keepdim=True)
        dq, dk, dv = flash_backward(q3, k3, v3, do3.to(q3.dtype), m, logl,
                                    delta, *ctx.statics)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """[B, T, H, Dh] attention through `FlashAttention` (forward kernel,
    and the backward kernel for gradients). Same contract as
    nn.layers.attention.dot_product_attention (which dispatches here)."""
    b, tq, h, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def to3(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)

    out3 = FlashAttention.apply(to3(q), to3(k), to3(v), float(scale),
                                bool(causal), int(q_offset), int(kv_offset))
    return out3.reshape(b, h, tq, d).permute(0, 2, 1, 3)

"""Ring attention — sequence/context parallelism (port of
deeplearning4j_tpu/parallel/ring.py).

The sequence axis is sharded over the mesh's 'seq' ranks; K/V blocks
travel round the ring (rank i sends to i + 1) while each rank accumulates
its queries' attention with an online (flash-style) softmax in float32.
Causality is applied on GLOBAL positions (block offsets from the rank's
index in the group), so the math is single-device causal attention's.

The reference computes the block math with jnp einsums and no Pallas
kernel, so this module stays plain PyTorch: there is no TPU kernel to
port. The rotation is `collectives.RingShift`, whose gradient sends the
K/V cotangents back round the ring; autograd differentiates the rest.
The reference rotates after every block, the last one included; the
port skips that last, unused rotation.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives as C

NEG_INF = -1e30


def ring_attention(q, k, v, group=None, causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention over the ranks of ``group`` (the mesh's
    'seq' group; None is a ring of one).

    q, k, v: LOCAL blocks [B, Tl, H, Dh]; the global sequence length is
    Tl * group size and this rank holds block `group_rank`. Returns the
    local output block [B, Tl, H, Dh] in q's dtype."""
    s = C.group_size(group)
    idx = C.group_rank(group)
    b, tl, h, dh = q.shape
    scale = (1.0 / dh ** 0.5) if scale is None else scale
    dev = q.device
    q32 = q.to(torch.float32)
    qpos = idx * tl + torch.arange(tl, device=dev)
    if s > 1:
        nxt = C.global_rank_of(group, (idx + 1) % s)
        prv = C.global_rank_of(group, (idx - 1) % s)
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tl, dh), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for sidx in range(s):
        kv_idx = (idx - sidx) % s
        kpos = kv_idx * tl + torch.arange(tl, device=dev)
        scores = torch.einsum("bthd,bshd->bhts", q32,
                              kb.to(torch.float32)) * scale
        if causal:
            cm = qpos[:, None] >= kpos[None, :]
            scores = torch.where(cm[None, None], scores,
                                 torch.full_like(scores, NEG_INF))
        new_m = torch.maximum(m, scores.amax(dim=-1))
        # rows with no valid key yet keep exp(NEG_INF - NEG_INF) = 1 out
        # of l: p is zero wherever the score is masked
        p = torch.exp(scores - new_m[..., None])
        p = torch.where(scores <= NEG_INF / 2, torch.zeros_like(p), p)
        corr = torch.exp(m - new_m)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, vb.to(torch.float32))
        m = new_m
        if sidx < s - 1:
            kb = C.RingShift.apply(kb, nxt, prv)
            vb = C.RingShift.apply(vb, nxt, prv)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)

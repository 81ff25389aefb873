"""Ulysses-style all-to-all sequence/context parallelism (port of
deeplearning4j_tpu/parallel/ulysses.py).

Two all-to-alls re-shard the activations from sequence-sharded to
head-sharded and back, so each rank runs ordinary attention over the
FULL sequence for a subset of heads. The inner attention is the port's
single-device `nn.layers.attention.dot_product_attention`: on CUDA
tensors the flash forward kernel (csrc/flash_fwd.cu) and, for
gradients, the flash backward kernel (csrc/flash_bwd.cu); its plain twin
on CPU tensors. Requires n_local_heads % group size == 0.

The all-to-alls are `collectives.AllToAll`, whose gradient is the
inverse exchange.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.layers.attention import \
    dot_product_attention
from deeplearning4j_tpu_torch.parallel import collectives as C


def ulysses_attention(q, k, v, group=None, causal: bool = True,
                      scale: Optional[float] = None,
                      axis_name: str = "seq") -> torch.Tensor:
    """All-to-all sequence-parallel attention over the ranks of
    ``group`` (the mesh's 'seq' group; None is one rank).

    q, k, v: LOCAL sequence blocks [B, Tl, H, Dh]; the global sequence
    length is Tl * group size. Returns the local output block
    [B, Tl, H, Dh].

    The first all-to-all splits the head axis across the ranks and
    concatenates the sequence blocks (rank order == sequence order), so
    each rank holds [B, T, H/s, Dh] with the full sequence; the inverse
    all-to-all restores [B, Tl, H, Dh] afterwards."""
    s = C.group_size(group)
    if q.shape[2] % s != 0:
        raise ValueError(
            f"ulysses_attention: local head count {q.shape[2]} not "
            f"divisible by '{axis_name}' axis size {s}")

    def seq_to_heads(x):
        # [B, Tl, H, Dh] -> [B, Tl*s, H/s, Dh]
        return C.AllToAll.apply(x, group, 2, 1)

    def heads_to_seq(x):
        # [B, T, H/s, Dh] -> [B, T/s, H, Dh]
        return C.AllToAll.apply(x, group, 1, 2)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = dot_product_attention(qg, kg, vg, causal=causal, scale=scale)
    return heads_to_seq(out)

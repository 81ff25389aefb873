"""The collectives of the parallel runtime, and the one place that routes
them.

The reference's collectives are XLA's (`psum`, `all_gather`,
`all_to_all`, `ppermute`), placed by the compiler inside one program. The
port's parallel modules (`parallel/{ring,ulysses,megatron,fsdp,
wrapper}.py`) call the functions of this module instead, each on a
`torch.distributed` process group, and never `torch.distributed`
directly.

**Routing.** NCCL takes CUDA tensors for every collective. Gloo, the
backend of CPU ranks and of ranks that share one card
(`multihost.choose_backend`), takes CPU tensors for every collective and
CUDA tensors for some. Which ones is a fact of the installed PyTorch,
probed once on the card (`benchmarks/gloo_probe.py`) and written into
`HOST_STAGED`, a fixed (backend, op) table. `_route` reads it: a CUDA
tensor whose (backend, op) is staged is copied into a pinned host buffer,
the collective runs on the host copy, and the result is copied back.
Nothing is caught and nothing is retried: an op the backend refuses
raises. Every byte copied either way is counted in `STATS.host_bytes`.

**Counters.** `STATS` counts each op's calls, the bytes of its payload
on this rank (the input it contributes), the host-staged bytes, and the
host seconds the call took (`STATS.seconds`). Those seconds include
waiting for the device work queued before the call; with
``STATS.sync = True`` (off by default) the device is synchronised
before and after each call, so they are the collective's own.

A group of one rank (or ``None``) makes every function here the
identity, with no call and no count.

The differentiable forms (`AllReduceGrad`, `AllReduceForward`,
`AllToAll`, `RingShift`, `GatherShard`) are `torch.autograd.Function`s
over the same calls.
"""
from __future__ import annotations

import time
import warnings
from collections import defaultdict
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

# the names PyTorch 2.13 deprecates in favour of *_single; the card's
# PyTorch has only these
warnings.filterwarnings(
    "ignore", message=r".*is deprecated\. Please use .*_single",
    category=FutureWarning)

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "send_recv")

# (backend, op) -> True where the backend refuses CUDA tensors for the
# op, so they go through pinned host buffers. From the card's probe
# (benchmarks/gloo_probe.py, torch 2.11.0+cu128 on an H100): gloo takes
# CUDA tensors for all_reduce, all_gather, reduce_scatter and
# all_to_all, and aborts the process on a point-to-point send of one
# ("writev ... Bad address"). NCCL takes all five.
HOST_STAGED = {("nccl", op): False for op in OPS}
HOST_STAGED.update({("gloo", op): op == "send_recv" for op in OPS})


class CommStats:
    """Per-op counters of this process's collectives."""

    def __init__(self):
        self.sync = False
        self.reset()

    def reset(self) -> None:
        self.calls = defaultdict(int)
        self.bytes = defaultdict(int)
        self.host_bytes = defaultdict(int)
        self.seconds = defaultdict(float)

    def snapshot(self) -> dict:
        ops = sorted(set(self.calls) | set(self.host_bytes))
        return {
            "calls": {o: self.calls[o] for o in ops},
            "bytes": {o: self.bytes[o] for o in ops},
            "host_bytes": {o: self.host_bytes[o] for o in ops},
            "seconds": {o: self.seconds[o] for o in ops},
            "total_bytes": sum(self.bytes.values()),
            "total_host_bytes": sum(self.host_bytes.values()),
            "total_seconds": sum(self.seconds.values()),
        }


STATS = CommStats()


def table() -> List[dict]:
    """The routing table as rows (backend, op, route)."""
    return [{"backend": b, "op": o, "route": "host" if s else "direct"}
            for (b, o), s in sorted(HOST_STAGED.items())]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _staged(op: str, group, tensors: Sequence[torch.Tensor]) -> bool:
    if not any(t.is_cuda for t in tensors):
        return False
    return HOST_STAGED[(dist.get_backend(group), op)]


def _to_host(t: torch.Tensor, op: str) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    STATS.host_bytes[op] += _nbytes(t)
    return h


def _from_host(h: torch.Tensor, like: torch.Tensor, op: str) -> torch.Tensor:
    STATS.host_bytes[op] += _nbytes(h)
    return h.to(like.device)


def _route(op: str, group, inputs: Sequence[torch.Tensor], outputs,
           call) -> list:
    """Run ``call(inputs, outputs)`` (which writes ``outputs``) on the
    route `HOST_STAGED` names; returns the outputs on the inputs'
    device."""
    staged = _staged(op, group, list(inputs) + list(outputs))
    STATS.calls[op] += 1
    STATS.bytes[op] += sum(_nbytes(t) for t in inputs)
    if STATS.sync and any(t.is_cuda for t in inputs):
        torch.cuda.synchronize(inputs[0].device)
    t0 = time.perf_counter()
    if staged:
        h_in = [_to_host(t, op) for t in inputs]
        h_out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in outputs]
        call(h_in, h_out)
        res = [_from_host(h, t, op) for h, t in zip(h_out, outputs)]
    else:
        call(list(inputs), list(outputs))
        res = list(outputs)
    if STATS.sync and any(t.is_cuda for t in inputs):
        torch.cuda.synchronize(inputs[0].device)
    STATS.seconds[op] += time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group (a new tensor; ``x`` is unchanged)."""
    if group_size(group) == 1:
        return x
    x = x.contiguous()

    def call(i, o):
        o[0].copy_(i[0])
        dist.all_reduce(o[0], group=group)
    return _route("all_reduce", group, [x], [torch.empty_like(x)], call)[0]


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank
    order (tiled, as `lax.all_gather(..., tiled=True)`)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)

    def call(i, o):
        dist.all_gather_into_tensor(o[0], i[0].reshape(-1), group=group)
    flat = _route("all_gather", group, [x], [out], call)[0]
    parts = flat.view(n, *x.shape)
    return torch.cat(parts.unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of the group's ``x``, cut into group-size blocks along
    ``dim``; this rank keeps block `group_rank` (`lax.psum_scatter(...,
    tiled=True)`)."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of size "
                         f"{x.shape[dim]} does not divide by {n}")
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)

    def call(i, o):
        dist.reduce_scatter_tensor(o[0], i[0], group=group)
    res = _route("reduce_scatter", group, [xm], [out], call)[0]
    return res.movedim(0, dim)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """`lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`: ``x`` cut into group-size blocks along ``split_dim``,
    block j sent to group rank j, the received blocks concatenated along
    ``concat_dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not divide by {n}")
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)

    def call(i, o):
        dist.all_to_all_single(o[0], i[0], group=group)
    res = _route("all_to_all", group, [inp], [out], call)[0]
    return torch.cat(res.unbind(0), dim=concat_dim)


def send_recv(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[torch.Tensor, int]],
              group=None) -> List[torch.Tensor]:
    """Point-to-point exchange (`batch_isend_irecv`, waited for): each
    ``(tensor, peer)`` of ``sends`` goes to the global rank ``peer``;
    each ``(template, peer)`` of ``recvs`` names a buffer shape / dtype /
    device to receive from ``peer``. Returns the received tensors."""
    sends = [(t.contiguous(), p) for t, p in sends]
    ins = [t for t, _ in sends]
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t, _ in recvs]
    if not ins and not outs:
        return []

    def call(i, o):
        ops = [dist.P2POp(dist.isend, t, p, group=group)
               for t, (_, p) in zip(i, sends)]
        ops += [dist.P2POp(dist.irecv, t, p, group=group)
                for t, (_, p) in zip(o, recvs)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    grp = group if group is not None else dist.group.WORLD
    return _route("send_recv", grp, ins, outs, call)


# ---------------------------------------------------------------------------
# differentiable forms
# ---------------------------------------------------------------------------

def _fresh(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A Function's output: a view where a group of one returned ``x``."""
    return x.view_as(x) if out is x else out


class AllReduceGrad(torch.autograd.Function):
    """Identity forward, sum over the group backward (megatron's 'f';
    also the gradient of a replicated leaf read by every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class AllReduceForward(torch.autograd.Function):
    """Sum over the group forward, identity backward (megatron's 'g')."""

    @staticmethod
    def forward(ctx, x, group):
        return _fresh(all_reduce(x, group), x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class AllToAll(torch.autograd.Function):
    """`all_to_all` whose gradient is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _fresh(all_to_all(x, group, split_dim, concat_dim), x)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return all_to_all(g, group, concat_dim, split_dim), None, None, None


class RingShift(torch.autograd.Function):
    """``x`` sent to global rank ``nxt``, the tensor of global rank
    ``prv`` returned (`lax.ppermute` one step round a ring); the
    gradient travels the other way."""

    @staticmethod
    def forward(ctx, x, nxt, prv):
        ctx.peers = (nxt, prv)
        return send_recv([(x, nxt)], [(x, prv)])[0]

    @staticmethod
    def backward(ctx, g):
        nxt, prv = ctx.peers
        return send_recv([(g, prv)], [(g, nxt)])[0], None, None


class GatherShard(torch.autograd.Function):
    """`all_gather` of a shard along ``dim`` whose gradient is the
    `reduce_scatter` (sum) of the full gradient: the FSDP weight."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.args = (group, dim)
        return _fresh(all_gather(shard, group, dim), shard)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return reduce_scatter(g, group, dim), None, None


def global_rank_of(group, index: int) -> int:
    """The global rank of the group's rank ``index``."""
    return dist.get_global_rank(group, index)


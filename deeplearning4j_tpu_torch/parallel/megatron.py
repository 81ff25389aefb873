"""Composite-parallel transformer training: DP x TP x PP x SP x EP on the
ranks of a mesh (port of deeplearning4j_tpu/parallel/megatron.py).

The reference writes every strategy as a sharding of one traced program
(`shard_map` over the named mesh). The port runs one process a rank;
each holds its shards of the parameters and of the Adam state and runs
the same step on its block of the batch, with the collectives written
out:

- data ('data'): batch rows sharded; gradients summed over 'data'.
- tensor ('model'): megatron-style — attention heads and the MLP hidden
  dim sharded; the forward sum ("g", `_g_sync`) is paired with an
  identity-forward / sum-backward "f" (`_f_sync`) at each parallel
  region's entry, both `torch.autograd.Function`s, so residual-stream
  gradients stay exact.
- pipeline ('pipe'): the [L] blocks split into S stages of L/S; stages
  exchange activations forward and cotangents backward by send / recv.
  Two microbatch schedules (``pipeline_schedule``): 'gpipe' (every
  forward, then every backward; M microbatches' activations live) and
  '1f1b' (PipeDream-flush: S - 1 - i warm-up forwards on stage i, then
  one forward and one backward a slot; at most S microbatches live).
- sequence ('seq'): time sharded; cfg.seq_impl picks ring
  (`parallel/ring.py`) or Ulysses (`parallel/ulysses.py`).
- expert (over 'data', Switch/GShard-style): experts sharded over
  'data', tokens exchanged by two all-to-alls. n_experts % data == 0.

Gradient synchronization rule: a leaf's gradient is summed over exactly
the mesh axes it is replicated across among ('pipe', 'data', 'seq');
'model' is excluded because the f/g pairing already delivers full
gradients on every model rank. Leaves with the same axes are summed as
one flat buffer an axis. The loss is the same value on every rank: one
sum over the mesh of the last stage's model-rank-0 partial sums.

Attention outside sequence parallelism, and Ulysses' inner attention, is
the port's `dot_product_attention`: the flash forward and backward
kernels on CUDA tensors (csrc/flash_fwd.cu, csrc/flash_bwd.cu).

Differences from the reference that change no value: the per-microbatch
1F1B of a rank is the schedule itself, not SPMD rounds with validity
masks (each rank has its own control flow), and the backward keeps the
forward's graph instead of re-running the stage (remat stays per block,
as ``cfg.remat`` asks).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, chunked_cross_entropy, moe_route)
from deeplearning4j_tpu_torch.nn.layers.attention import (
    dot_product_attention, layer_norm)
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, P, shard_of, \
    spec_axes
from deeplearning4j_tpu_torch.parallel.optim import (AdamState,  # noqa: F401
                                                     adam_update_tree,
                                                     init_adam_state,
                                                     tree_leaves, tree_map)
from deeplearning4j_tpu_torch.parallel.ring import ring_attention
from deeplearning4j_tpu_torch.parallel.ulysses import ulysses_attention


# ---------------------------------------------------------------------------
# megatron f and g
# ---------------------------------------------------------------------------

def _f_sync(group):
    """Megatron 'f': identity forward, sum backward — placed at a
    tensor-parallel region's ENTRY so the residual stream's cotangent is
    reassembled from the per-rank partial paths
    (`collectives.AllReduceGrad`)."""
    if group is None:
        return lambda x: x
    return lambda x: C.AllReduceGrad.apply(x, group)


def _g_sync(group):
    """Megatron 'g': sum forward, IDENTITY backward
    (`collectives.AllReduceForward`). A raw all-reduce that autograd
    transposed into another all-reduce would double-count the
    already-full cotangent on every rank."""
    if group is None:
        return lambda x: x
    return lambda x: C.AllReduceForward.apply(x, group)


# ---------------------------------------------------------------------------
# parameter partition specs
# ---------------------------------------------------------------------------

def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """PartitionSpec tree matching models/transformer.init_params."""
    blocks: Dict[str, P] = {
        "Wq": P("pipe", None, "model"), "Wk": P("pipe", None, "model"),
        "Wv": P("pipe", None, "model"), "Wo": P("pipe", "model", None),
        "ln1g": P("pipe", None), "ln1b": P("pipe", None),
        "ln2g": P("pipe", None), "ln2b": P("pipe", None),
    }
    if cfg.n_experts > 0:
        blocks["router"] = P("pipe", None, None)
        blocks["We1"] = P("pipe", "data", None, None)
        blocks["We2"] = P("pipe", "data", None, None)
    else:
        blocks["W1"] = P("pipe", None, "model")
        blocks["b1"] = P("pipe", "model")
        blocks["W2"] = P("pipe", "model", None)
        blocks["b2"] = P("pipe", None)
    return {"embed": P(), "pos": P(), "blocks": blocks,
            "lnfg": P(), "lnfb": P(), "Wout": P()}


def _grad_psum_axes(spec, mesh: Mesh) -> Tuple[str, ...]:
    used = set(spec_axes(spec))
    return tuple(a for a in ("pipe", "data", "seq")
                 if a not in used and mesh.shape[a] > 1)


# ---------------------------------------------------------------------------
# sharded block forward (on LOCAL shards)
# ---------------------------------------------------------------------------

def _block_fwd_sharded(h, p: Dict[str, torch.Tensor],
                       cfg: TransformerConfig, mesh: Mesh) -> torch.Tensor:
    tp = mesh.shape["model"]
    sp = mesh.shape["seq"]
    h_loc = cfg.n_heads // tp
    f_model = _f_sync(mesh.group("model"))
    g_model = _g_sync(mesh.group("model"))

    x = layer_norm(h, p["ln1g"], p["ln1b"], cfg.eps)
    x = f_model(x)

    def heads(y):
        return y.reshape(y.shape[0], y.shape[1], h_loc, cfg.d_head)

    q = heads(torch.matmul(x, p["Wq"].to(x.dtype)))
    k = heads(torch.matmul(x, p["Wk"].to(x.dtype)))
    v = heads(torch.matmul(x, p["Wv"].to(x.dtype)))
    if sp > 1:
        # seq_impl validated upfront by make_parallel_train_step
        if cfg.seq_impl == "ulysses":
            a = ulysses_attention(q, k, v, mesh.group("seq"), causal=True)
        else:
            a = ring_attention(q, k, v, mesh.group("seq"), causal=True)
    else:
        a = dot_product_attention(q, k, v, causal=True)
    a = a.reshape(a.shape[0], a.shape[1], h_loc * cfg.d_head)
    attn_out = torch.matmul(a, p["Wo"].to(a.dtype))
    attn_out = g_model(attn_out)
    h = h + attn_out

    x = layer_norm(h, p["ln2g"], p["ln2b"], cfg.eps)
    if cfg.n_experts > 0:
        h = h + _moe_sharded(x, p, cfg, mesh)
    else:
        x = f_model(x)
        z = F.gelu(torch.matmul(x, p["W1"].to(x.dtype))
                   + p["b1"].to(x.dtype), approximate="tanh")
        m = torch.matmul(z, p["W2"].to(z.dtype))
        m = g_model(m)
        h = h + m + p["b2"].to(h.dtype)
    return h


def _moe_sharded(x, p: Dict[str, torch.Tensor], cfg: TransformerConfig,
                 mesh: Mesh) -> torch.Tensor:
    """Expert-parallel top-1 MoE: experts sharded over 'data', tokens
    exchanged by all-to-all (Switch-style). Local x: [b, t, D].

    The reference's capacity and dispatch: cap = max(1,
    int(capacity_factor * n / E)) for the rank's n = b * t tokens, a
    token's place its rank among the earlier local tokens of its expert,
    kept iff place < cap. Its dense [n, E, C] one-hot einsums become the
    index form of `models.transformer.moe_mlp` (each kept token's row
    copied to row expert * cap + place of [E, cap, D], read back times
    its gate); every einsum sums one non-zero term, so the values are
    the same."""
    b, t, d = x.shape
    e = cfg.n_experts
    dp = mesh.shape["data"]
    group = mesh.group("data")
    xt, expert, prob, place, keep, cap = moe_route(x, p, cfg)
    dest = torch.where(keep, expert * cap + place,
                       torch.full_like(expert, e * cap))
    buf = torch.index_copy(xt.new_zeros(e * cap + 1, d), 0, dest, xt)
    xin = buf[:e * cap].view(e, cap, d)
    if dp > 1:
        # [E, C, D] -> [E/dp, dp*C, D]: each data rank keeps its experts'
        # tokens from every peer
        xin = C.AllToAll.apply(xin, group, 0, 1)
    z = F.gelu(torch.bmm(xin, p["We1"].to(torch.float32)),
               approximate="tanh")
    out = torch.bmm(z, p["We2"].to(torch.float32))
    if dp > 1:
        out = C.AllToAll.apply(out, group, 1, 0)                # [E,C,D]
    out = torch.cat([out.reshape(e * cap, d), out.new_zeros(1, d)])
    y = out.index_select(0, dest) * (prob * keep)[:, None]
    return y.to(x.dtype).reshape(b, t, d)


# ---------------------------------------------------------------------------
# stages, embedding and loss head
# ---------------------------------------------------------------------------

def _stage_fn(x, blocks_local, cfg: TransformerConfig, mesh: Mesh):
    """This rank's L/S blocks in order; each checkpointed under remat
    (the reference's `jax.checkpoint` around the scanned block)."""
    h = x
    for layer in range(blocks_local["Wq"].shape[0]):
        p = {k: v[layer] for k, v in blocks_local.items()}
        if getattr(cfg, "remat", False):
            h = checkpoint(_block_fwd_sharded, h, p, cfg, mesh,
                           use_reentrant=False)
        else:
            h = _block_fwd_sharded(h, p, cfg, mesh)
    return h


def _embed(params, toks, cfg: TransformerConfig, seq_idx: int):
    dt = cfg.activation_dtype()
    tl = toks.shape[-1]
    pos = params["pos"][seq_idx * tl:(seq_idx + 1) * tl]
    return params["embed"].to(dt)[toks.long()] + pos.to(dt)[None]


def _head_loss_sum(params, y, tgt, cfg: TransformerConfig):
    """Summed NLL of the local tokens (float32 scalar)."""
    hf = layer_norm(y, params["lnfg"], params["lnfb"], cfg.eps)
    if cfg.xent_chunk > 0 and cfg.vocab_size > cfg.xent_chunk:
        # streaming vocab-panel loss on the LOCAL tokens (Wout is
        # replicated; each rank scans its own panels)
        return chunked_cross_entropy(hf, params["Wout"], tgt,
                                     cfg.xent_chunk) * tgt.numel()
    logits = torch.matmul(hf, params["Wout"].to(hf.dtype))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, tgt.long()[..., None]).sum()


# ---------------------------------------------------------------------------
# pipeline schedules
# ---------------------------------------------------------------------------

def pipeline_bubble_fraction(schedule: str, n_stages: int,
                             n_microbatches: int) -> float:
    """Analytic pipeline-bubble fraction (the reference's, for its
    slot-synchronous schedules): gpipe (S-1)/(M+S-1); 1f1b
    2(S-1)/(M+2(S-1)), the reference's rounds of one forward and one
    backward slot each. The 1f1b schedule trades a larger bubble at
    EQUAL M for activation memory independent of M, so M can grow."""
    if n_stages <= 1:
        return 0.0
    s, m = n_stages, n_microbatches
    if schedule == "gpipe":
        return (s - 1) / (m + s - 1)
    if schedule == "1f1b":
        return 2 * (s - 1) / (m + 2 * (s - 1))
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


class _Stage:
    """One rank's pipeline stage: its microbatch forward and backward and
    the send / recv to its neighbours (global ranks ``prev`` / ``nxt``,
    None at the ends)."""

    def __init__(self, live, toks_mb, tgts_mb, cfg, mesh, count):
        self.live, self.cfg, self.mesh = live, cfg, mesh
        self.toks_mb, self.tgts_mb, self.count = toks_mb, tgts_mb, count
        s, i = mesh.shape["pipe"], mesh.coords["pipe"]
        self.first, self.last = i == 0, i == s - 1
        self.prev = None if self.first else mesh.peer("pipe", i - 1)
        self.nxt = None if self.last else mesh.peer("pipe", i + 1)
        mb, tl = toks_mb.shape[1:]
        self.act = torch.empty((mb, tl, cfg.d_model),
                               dtype=cfg.activation_dtype(),
                               device=mesh.device)
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=mesh.device)

    def input(self, j, received=None):
        """Microbatch j's stage input: the embedding on stage 0, else the
        received activation as a leaf that collects its gradient."""
        if self.first:
            return _embed(self.live, self.toks_mb[j], self.cfg,
                          self.mesh.coords["seq"])
        return received.requires_grad_()

    def forward(self, j, x):
        y = _stage_fn(x, self.live["blocks"], self.cfg, self.mesh)
        loss = None
        if self.last:
            loss = _head_loss_sum(self.live, y, self.tgts_mb[j], self.cfg)
            self.loss_sum = self.loss_sum + loss.detach()
        return x, y, loss

    def backward(self, rec, dy):
        """Backward of one microbatch; its input's cotangent (None on
        stage 0). The loss head is scaled 1/count so the summed
        microbatch cotangents give the global mean loss's gradient."""
        x, y, loss = rec
        if self.last:
            (loss / self.count).backward()
        else:
            torch.autograd.backward(y, dy)
        return None if self.first else x.grad

    def exchange(self, send_next=None, send_prev=None, recv_next=False,
                 recv_prev=False):
        """One batched send / recv with the neighbours; the received
        tensors (next's, prev's), None where nothing was asked."""
        sends, recvs, want = [], [], []
        if send_next is not None and self.nxt is not None:
            sends.append((send_next.detach(), self.nxt))
        if send_prev is not None and self.prev is not None:
            sends.append((send_prev.detach(), self.prev))
        if recv_next and self.nxt is not None:
            recvs.append((self.act, self.nxt))
            want.append("next")
        if recv_prev and self.prev is not None:
            recvs.append((self.act, self.prev))
            want.append("prev")
        got = dict(zip(want, C.send_recv(sends, recvs)))
        return got.get("next"), got.get("prev")


def _run_gpipe(stage: _Stage, m_: int) -> None:
    """Every forward, then every backward (last microbatch first)."""
    recs = []
    for j in range(m_):
        recv = None if stage.first else stage.exchange(recv_prev=True)[1]
        rec = stage.forward(j, stage.input(j, recv))
        stage.exchange(send_next=rec[1])
        recs.append(rec)
    for j in reversed(range(m_)):
        dy = None if stage.last else stage.exchange(recv_next=True)[0]
        dx = stage.backward(recs[j], dy)
        stage.exchange(send_prev=dx)


def _run_1f1b(stage: _Stage, m_: int) -> None:
    """PipeDream-flush 1F1B: stage i runs min(S-1-i, M) warm-up
    forwards, then alternates one forward and one backward, then drains
    the remaining backwards. Neighbouring stages' exchanges pair up (a
    forward send with a backward receive), so each is one batched
    send / recv."""
    s, i = stage.mesh.shape["pipe"], stage.mesh.coords["pipe"]
    warm = min(s - 1 - i, m_)
    rem = m_ - warm
    live = deque()
    j_f = 0
    for _ in range(warm):
        recv = None if stage.first else stage.exchange(recv_prev=True)[1]
        rec = stage.forward(j_f, stage.input(j_f, recv))
        j_f += 1
        stage.exchange(send_next=rec[1])
        live.append(rec)
    recv = None
    if rem > 0 and not stage.first:
        recv = stage.exchange(recv_prev=True)[1]
    for k in range(rem):
        rec = stage.forward(j_f, stage.input(j_f, recv))
        j_f += 1
        live.append(rec)
        dy = stage.exchange(send_next=rec[1], recv_next=True)[0]
        dx = stage.backward(live.popleft(), dy)
        if k == rem - 1:
            stage.exchange(send_prev=dx)
        else:
            recv = stage.exchange(send_prev=dx, recv_prev=True)[1]
    for _ in range(warm):
        dy = stage.exchange(recv_next=True)[0]
        dx = stage.backward(live.popleft(), dy)
        stage.exchange(send_prev=dx)


# ---------------------------------------------------------------------------
# the train step factory
# ---------------------------------------------------------------------------

def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _sync_grads(grads, specs, mesh: Mesh) -> None:
    """Sum each gradient leaf, in place, over the axes it is replicated
    across (`_grad_psum_axes`): leaves with the same axes as one flat
    float32 buffer, one all-reduce an axis."""
    buckets: Dict[Tuple[str, ...], list] = {}
    for path, g in _paths(grads):
        axes = _grad_psum_axes(_get(specs, path), mesh)
        if axes:
            buckets.setdefault(axes, []).append(g)
    for axes, gs in buckets.items():
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in gs])
        for a in axes:
            flat = C.all_reduce(flat, mesh.group(a))
        off = 0
        for g in gs:
            n = g.numel()
            g.copy_(flat[off:off + n].view_as(g))
            off += n


def make_parallel_train_step(cfg: TransformerConfig, mesh: Mesh, *,
                             learning_rate: float = 1e-3,
                             n_microbatches: Optional[int] = None,
                             b1: float = 0.9, b2: float = 0.999,
                             eps: float = 1e-8,
                             pipeline_schedule: str = "gpipe"):
    """Build the composite-parallel train step for this rank.

    Returns ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)``: ``params`` / ``opt_state`` are this rank's shards
    (`shard_params`, `init_adam_state`), updated IN PLACE (the reference
    donated them); ``tokens`` / ``targets`` are the GLOBAL [B, T] int
    arrays, the same on every rank, each rank reading its block (rows
    by 'data', columns by 'seq'). ``loss`` is the float32 global mean
    loss of the params given, the same on every rank.
    ``pipeline_schedule``: 'gpipe' or '1f1b' (see the module
    docstring); identical losses and grads either way."""
    s = mesh.shape["pipe"]
    dp = mesh.shape["data"]
    sp = mesh.shape["seq"]
    tp = mesh.shape["model"]
    if mesh.shape.get("expert", 1) != 1:
        raise ValueError("expert parallelism rides the 'data' axis; use "
                         "expert=1 in the mesh (Switch-style EP)")
    if cfg.n_layers % s:
        raise ValueError("n_layers must divide by pipe size")
    if cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError("n_heads and d_ff must divide by model size")
    if cfg.n_experts and cfg.n_experts % dp:
        raise ValueError("n_experts must divide by data size")
    if cfg.seq_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown seq_impl {cfg.seq_impl!r}: expected "
                         "'ring' or 'ulysses'")
    if cfg.seq_impl == "ulysses" and sp > 1 and (cfg.n_heads // tp) % sp:
        raise ValueError(
            f"seq_impl='ulysses' needs local heads (n_heads/tp = "
            f"{cfg.n_heads // tp}) divisible by seq size {sp}; use "
            "seq_impl='ring' (any head count) or change the mesh")
    if pipeline_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline_schedule "
                         f"{pipeline_schedule!r}: expected 'gpipe' or "
                         "'1f1b'")
    if not mesh.member:
        raise ValueError(f"this process (rank {mesh.rank}) is not in "
                         f"{mesh}")
    m_ = n_microbatches or s
    specs = param_specs(cfg)
    use_1f1b = pipeline_schedule == "1f1b" and s > 1
    dev = mesh.device

    def step(params, opt_state: AdamState, tokens, targets):
        tokens = torch.as_tensor(tokens).to(dev)
        targets = torch.as_tensor(targets).to(dev)
        toks_loc = shard_of(tokens, P("data", "seq"), mesh)
        tgts_loc = shard_of(targets, P("data", "seq"), mesh)
        b_loc, tl = toks_loc.shape
        if b_loc % m_:
            raise ValueError(f"local batch {b_loc} not divisible by "
                             f"{m_} microbatches")
        count = b_loc * tl * dp * sp
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            if s == 1:
                y = _stage_fn(_embed(live, toks_loc, cfg,
                                     mesh.coords["seq"]),
                              live["blocks"], cfg, mesh)
                local = _head_loss_sum(live, y, tgts_loc, cfg)
                (local / count).backward()
                local = local.detach()
            else:
                mb = b_loc // m_
                stage = _Stage(live, toks_loc.reshape(m_, mb, tl),
                               tgts_loc.reshape(m_, mb, tl), cfg, mesh,
                               count)
                (_run_1f1b if use_1f1b else _run_gpipe)(stage, m_)
                local = stage.loss_sum
        grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                         else p.grad, live)
        with torch.no_grad():
            _sync_grads(grads, specs, mesh)
            # the loss: the last stage's model-rank-0 sums over the mesh
            keep = (mesh.coords["pipe"] == s - 1
                    and mesh.coords["model"] == 0)
            total = C.all_reduce(local if keep else torch.zeros_like(local),
                                 mesh.world)
            loss = total / count
            opt_state.count.add_(1)
            new = adam_update_tree(params, grads, opt_state.m, opt_state.v,
                                   opt_state.count.to(torch.float32),
                                   learning_rate=learning_rate, b1=b1,
                                   b2=b2, eps=eps)
            for tree, upd in zip((params, opt_state.m, opt_state.v), new):
                for dst, src in zip(tree_leaves(tree), tree_leaves(upd)):
                    dst.copy_(src)
        return params, opt_state, loss

    return step


def shard_params(params, cfg: TransformerConfig, mesh: Mesh, specs=None):
    """This rank's shards of a full parameter tree (the reference's
    layout, e.g. from `models.convert.params_from_numpy`) under
    `param_specs` (or caller-supplied ``specs``), as fresh tensors on
    the mesh's device."""
    if specs is None:
        specs = param_specs(cfg)
    return tree_map(lambda p, sp_: torch.as_tensor(shard_of(p, sp_, mesh))
                    .to(mesh.device).clone(), params, specs)

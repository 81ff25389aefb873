"""Fully-sharded data parallelism (ZeRO-3/FSDP-style) and the single-device
Adam step (port of deeplearning4j_tpu/parallel/fsdp.py).

The reference shards parameters, gradients AND Adam state over the
mesh's 'data' axis and lets GSPMD place the collectives: `all_gather` of
the weights in the forward and backward, `reduce_scatter` of the
gradients into the shards. The port writes them out on the ranks of a
mesh, by hand (not `torch.distributed.fsdp`, so the shards follow the
reference's leaf rules and the tests can compare them shard by shard):

- each rank holds, at rest, only its `fsdp_leaf_spec` block of every
  parameter, of m and of v (`shard_params_fsdp`,
  `init_fsdp_adam_state`): 1/N of each sharded leaf;
- the step gathers every weight through `collectives.GatherShard`, whose
  backward reduce-scatters (sums) the gradient into the shard; a
  replicated leaf goes through `collectives.AllReduceGrad` (identity
  forward, summed gradient);
- each rank runs `models.transformer.loss_fn` on its rows of the batch,
  scaled by 1/N so the summed gradients are those of the global mean;
- Adam runs on the shards.

The whole tree is gathered at the start of the step and dropped after
its backward: at rest the memory is 1/N, during the step it is a full
copy of the weights (the reference's GSPMD gathers layer by layer).

With ``mesh=None`` `make_fsdp_train_step` is the single-device step (the
reference's step body on a one-device mesh, :142-149).

`zero1_partition`, `flatten_tree` and `unflatten_tree` are the ZeRO-1
helpers of the elastic coordinator, leaves in sorted-key order as
`jax.tree_util` flattens a dict.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         loss_fn)
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, P, shard_of
from deeplearning4j_tpu_torch.parallel.optim import (AdamState,
                                                     adam_update_tree,
                                                     init_adam_state,
                                                     tree_leaves, tree_map)


def fsdp_leaf_spec(shape: Tuple[int, ...], axis_size: int,
                   axis_name: str = "data") -> P:
    """Shard the largest axis divisible by the mesh axis; scalars and
    leaves with no divisible axis stay replicated (their memory is
    negligible — norms/biases)."""
    if not shape or axis_size <= 1:
        return P()
    for i in sorted(range(len(shape)), key=lambda j: -shape[j]):
        if shape[i] >= axis_size and shape[i] % axis_size == 0:
            spec: list = [None] * len(shape)
            spec[i] = axis_name
            return P(*spec)
    return P()


def fsdp_shardings(params, mesh: Mesh, axis_name: str = "data"):
    """The `fsdp_leaf_spec` tree of a full param (or same-shaped
    opt-state) tree."""
    size = mesh.shape[axis_name]
    return tree_map(lambda p: fsdp_leaf_spec(
        p if isinstance(p, tuple) else tuple(np.shape(p)), size,
        axis_name), params)


def shard_params_fsdp(params, mesh: Mesh, axis_name: str = "data"):
    """This rank's FSDP shards of a full param tree, as fresh tensors on
    the mesh's device."""
    specs = fsdp_shardings(params, mesh, axis_name)
    return tree_map(lambda p, sp: torch.as_tensor(shard_of(p, sp, mesh))
                    .to(mesh.device).clone(), params, specs)


def init_fsdp_adam_state(params) -> AdamState:
    """Zeros shaped like the (sharded) params: the optimizer state is
    born sharded (the ZeRO-1 half of the memory win)."""
    return init_adam_state(params)


def zero1_partition(n_params: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous ZeRO-1 shard boundaries over a flattened parameter
    vector: ``n_shards`` half-open ``(lo, hi)`` ranges covering
    ``[0, n_params)``, remainder spread over the FIRST shards (the
    np.array_split convention). Deterministic in its inputs."""
    if n_params < 0:
        raise ValueError(f"n_params must be >= 0, got {n_params}")
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    base, extra = divmod(int(n_params), int(n_shards))
    bounds: List[Tuple[int, int]] = []
    lo = 0
    for i in range(int(n_shards)):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _sorted_leaves(tree) -> list:
    """Leaves in `jax.tree_util`'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _sorted_leaves(v)]
    return [tree]


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def flatten_tree(tree) -> np.ndarray:
    """Flatten a float tree (tensors or arrays) into ONE contiguous
    float32 vector in canonical leaf order (dict keys sorted) — the
    byte layout the ZeRO-1 shards slice."""
    leaves = _sorted_leaves(tree)
    if not leaves:
        return np.zeros((0,), dtype=np.float32)
    return np.concatenate([_as_numpy(leaf).ravel() for leaf in leaves])


def unflatten_tree(vec: np.ndarray, template):
    """Inverse of `flatten_tree` given a same-structure ``template``
    tree (shapes read from its leaves): the flat vector split back into
    a tree of float32 numpy arrays."""
    vec = np.asarray(vec, dtype=np.float32)
    leaves = _sorted_leaves(template)
    total = sum(int(np.prod(np.shape(leaf))) for leaf in leaves)
    if vec.size != total:
        raise ValueError(f"flat vector has {vec.size} elements; "
                         f"template needs {total}")
    off = [0]

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        shape = tuple(np.shape(t))
        n = int(np.prod(shape)) if shape else 1
        out = vec[off[0]:off[0] + n].reshape(shape)
        off[0] += n
        return out

    return rebuild(template)


def param_shapes(cfg: TransformerConfig):
    """The shape tree of `models.transformer.init_params` (the
    reference's `jax.eval_shape` of it), as tuples."""
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    blocks = {"Wq": (L, d, d), "Wk": (L, d, d), "Wv": (L, d, d),
              "Wo": (L, d, d), "ln1g": (L, d), "ln1b": (L, d),
              "ln2g": (L, d), "ln2b": (L, d)}
    if cfg.n_experts > 0:
        e = cfg.n_experts
        blocks.update(router=(L, d, e), We1=(L, e, d, f), We2=(L, e, f, d))
    else:
        blocks.update(W1=(L, d, f), b1=(L, f), W2=(L, f, d), b2=(L, d))
    return {"embed": (v, d), "pos": (cfg.max_len, d), "blocks": blocks,
            "lnfg": (d,), "lnfb": (d,), "Wout": (d, v)}


def _gather(shard, spec, group):
    """The full weight of a shard, differentiably (FSDP's gather; a
    replicated leaf sums its gradient instead)."""
    if group is None:
        return shard
    if not spec:
        return C.AllReduceGrad.apply(shard, group)
    dim = next(i for i, part in enumerate(spec) if part is not None)
    return C.GatherShard.apply(shard, group, dim)


def make_fsdp_train_step(cfg: TransformerConfig, mesh: Optional[Mesh] = None,
                         *, device=None, learning_rate: float = 1e-3,
                         betas: Tuple[float, float] = (0.9, 0.999),
                         eps: float = 1e-8):
    """``step(params, opt, tokens, targets) -> (params, opt, loss)``.

    ``mesh=None``: one device, ``device`` (CUDA unless ``"cpu"``); params
    and the `AdamState` are whole trees there. With a mesh: params and
    opt are this rank's `shard_params_fsdp` shards on the mesh's device,
    ``tokens`` / ``targets`` the GLOBAL [B, T] batch (each rank reads its
    rows by 'data'; the mesh's other axes replicate the work, as GSPMD
    would). Either way the step updates params, m, v and count IN PLACE
    (the reference donated them) and returns the same objects with the
    float32 global mean loss of the params it was given."""
    b1, b2 = betas
    if mesh is None:
        dev = resolve_device(device)
        n, group = 1, None
    else:
        dev = mesh.device
        n, group = mesh.shape["data"], mesh.group("data")
        specs = fsdp_shardings(param_shapes(cfg), mesh)

    def step(params, opt: AdamState, tokens, targets):
        tokens = torch.as_tensor(tokens).to(dev)
        targets = torch.as_tensor(targets).to(dev)
        if mesh is not None:
            tokens = shard_of(tokens, P("data"), mesh)
            targets = shard_of(targets, P("data"), mesh)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            full = live if mesh is None else tree_map(
                lambda p, sp: _gather(p, sp, group), live, specs)
            loss = loss_fn(cfg, full, tokens, targets)
            flat = torch.autograd.grad(loss / n, tree_leaves(live))
        it = iter(flat)
        grads = tree_map(lambda _: next(it), live)
        with torch.no_grad():
            loss = C.all_reduce(loss.detach(), group) / n
            opt.count.add_(1)
            new = adam_update_tree(params, grads, opt.m, opt.v,
                                   opt.count.to(torch.float32),
                                   learning_rate=learning_rate, b1=b1,
                                   b2=b2, eps=eps)
            for tree, upd in zip((params, opt.m, opt.v), new):
                for dst, src in zip(tree_leaves(tree), tree_leaves(upd)):
                    dst.copy_(src)
        return params, opt, loss

    return step

"""ParallelWrapper — data-parallel training facade (port of
deeplearning4j_tpu/parallel/wrapper.py).

The reference compiles the network's own train step with the batch
sharded over the mesh's 'data' axis and lets GSPMD insert the gradient
all-reduce: synchronous averaging every step. The port runs the same
step on each rank of a 'data' mesh, on that rank's block of the batch
rows, with the network's ``grad_sync`` hook set for the call: the score,
every gradient and every float state leaf are averaged over the ranks
(`collectives.all_reduce` / ranks) before the updater runs, so the
update is that of one large batch and every replica stays bit-equal.

On one rank with no process group the wrapper is the plain network.
Limits of the port: a state leaf averaged over the ranks (batch norm's
running statistics) is exact for the running mean and approximate for
the running variance (the ranks' variances, not the batch's); dropout
draws from the rank's rows, so a dropout network's masks differ from one
large batch's.
"""
from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh


class ParallelWrapper:
    """Data-parallel trainer around a MultiLayerNetwork / ComputationGraph.

    Usage (reference: ParallelWrapper.Builder)::

        pw = ParallelWrapper(net, workers=4)   # or mesh=<Mesh with 'data'>
        pw.fit(iterator)

    Every rank of the mesh builds the same network (same seed) and calls
    the same methods with the same GLOBAL batches; each trains on its
    rows. ``averaging_frequency`` / ``prefetch_buffer`` are accepted for
    API parity; gradients are averaged every step, and prefetch is the
    iterator's job (AsyncDataSetIterator)."""

    def __init__(self, model, workers: Optional[int] = None,
                 mesh: Optional[Mesh] = None,
                 averaging_frequency: int = 1,
                 prefetch_buffer: int = 2,
                 report_score_after_averaging: bool = True):
        self.model = model
        self.mesh = mesh if mesh is not None else data_parallel_mesh(
            workers, device=model.device)
        if "data" not in self.mesh.axis_names:
            raise ValueError("mesh must have a 'data' axis")
        self.workers = int(self.mesh.shape["data"])
        self.averaging_frequency = averaging_frequency  # parity only
        self.prefetch_buffer = prefetch_buffer          # parity only
        self._group = self.mesh.group("data")
        self._rank = self.mesh.coords["data"]

    # ------------------------------------------------------------------
    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        return C.all_reduce(x, self._group) / self.workers

    def _sync(self, score, grads, state):
        """The network's grad_sync: the rank means of the score, of every
        gradient (one flat buffer) and of every float state leaf."""
        leaves = [g for layer in sorted(grads)
                  for _, g in sorted(grads[layer].items())]
        floats = [v for layer in sorted(state)
                  for _, v in sorted(state[layer].items())
                  if torch.is_tensor(v) and v.is_floating_point()]
        dt = (torch.float64 if score.dtype == torch.float64
              else torch.float32)
        parts = [score.reshape(1).to(dt)]
        parts += [t.reshape(-1).to(dt) for t in leaves + floats]
        flat = self._mean(torch.cat(parts))
        out, off = [], 1
        for t in leaves + floats:
            out.append(flat[off:off + t.numel()].view_as(t).to(t.dtype))
            off += t.numel()
        it = iter(out)
        grads = {layer: {k: next(it) for k, _ in sorted(grads[layer].items())}
                 for layer in sorted(grads)}
        state = {layer: {k: (next(it) if torch.is_tensor(v)
                             and v.is_floating_point() else v)
                         for k, v in sorted(state[layer].items())}
                 for layer in sorted(state)}
        return flat[0].to(score.dtype), grads, state

    def _rows(self, x, dim: int = 0):
        """This rank's block of ``x`` (or of each value of a dict) along
        ``dim``."""
        if isinstance(x, dict):
            return {k: self._rows(v, dim) for k, v in x.items()}
        if self.workers == 1:
            return x
        n = x.shape[dim] // self.workers
        return x.narrow(dim, self._rank * n, n)

    def _synced(self, fn, *args):
        m = self.model
        m.grad_sync = self._sync if self.workers > 1 else None
        try:
            return fn(*args)
        finally:
            m.grad_sync = None

    # ------------------------------------------------------------------
    def fit(self, data, labels=None, mask=None) -> None:
        """Train data-parallel. Accepts the same inputs as model.fit."""
        m = self.model
        if not m._initialized:
            m.init()
        if labels is not None:
            self._fit_batch(data, labels, mask)
            return
        from deeplearning4j_tpu_torch.nn.multilayer import _unpack_batch
        for lst in m.listeners:
            lst.on_epoch_start(m)
        for batch in data:
            feats, labs, fmask, lmask = _unpack_batch(batch)
            self._fit_batch(feats, labs,
                            lmask if lmask is not None else fmask)
        for lst in m.listeners:
            lst.on_epoch_end(m)
        m.epoch_count += 1
        if hasattr(data, "reset"):
            data.reset()

    def fit_batched(self, xs, ys, epochs: int = 1):
        """Data-parallel training on a staged pool [N, B, ...]: each rank
        trains on its rows of the batch dim (the network's fit_batched
        with the gradients averaged every step); returns the per-step
        scores (the ranks' mean, the same on every rank)."""
        m = self.model
        if not m._initialized:
            m.init()
        if hasattr(m, "_as_input_dict"):        # ComputationGraph
            xs = m._as_input_dict(xs, m.conf.network_inputs)
            ys = m._as_input_dict(ys, m.conf.network_outputs)
            leaves = list(xs.values()) + list(ys.values())
        else:                                   # MultiLayerNetwork
            xs = m._tensor(xs)
            ys = m._tensor(ys)
            leaves = [xs, ys]
        for leaf in leaves:
            if leaf.shape[1] % self.workers:
                raise ValueError(
                    f"batch dim {leaf.shape[1]} must divide by workers "
                    f"{self.workers} (GSPMD even sharding)")
        return self._synced(m.fit_batched, self._rows(xs, 1),
                            self._rows(ys, 1), epochs)

    def output_batched(self, xs):
        """Data-parallel inference over a staged pool [N, B, ...]: each
        rank runs its rows, the blocks are gathered back in rank order.
        MultiLayerNetwork pools only (the DAG runtime has its own
        output_batched)."""
        m = self.model
        if hasattr(m, "_as_input_dict"):
            raise ValueError(
                "ParallelWrapper.output_batched supports "
                "MultiLayerNetwork pools; use "
                "ComputationGraph.output_batched for the DAG runtime")
        if not m._initialized:
            m.init()
        xs = m._tensor(xs)
        if xs.shape[1] % self.workers:
            raise ValueError(
                f"batch dim {xs.shape[1]} must divide by workers "
                f"{self.workers} (GSPMD even sharding)")
        out = m.output_batched(self._rows(xs, 1))
        return C.all_gather(out, self._group, dim=1)

    def _fit_batch(self, x, y, mask=None) -> None:
        from deeplearning4j_tpu_torch.nn.layers.base import fold_in
        m = self.model
        if hasattr(m, "_as_input_dict"):        # ComputationGraph
            x = m._as_input_dict(x, m.conf.network_inputs)
            y = m._as_input_dict(y, m.conf.network_outputs)
            if mask is not None:
                mask = m._as_input_dict(mask, m.conf.network_inputs)
        else:                                   # MultiLayerNetwork
            x, y = m._tensor(x), m._tensor(y)
            mask = None if mask is None else m._tensor(mask)
        n = (next(iter(x.values())) if isinstance(x, dict) else x).shape[0]
        keep = n - (n % self.workers)
        if keep == 0:
            # an even split needs a divisible batch; drop the remainder
            # like the reference drops the last partial round-robin
            # minibatch
            return
        x, y, mask = (None if t is None else self._rows(_head(t, keep))
                      for t in (x, y, mask))
        key = fold_in(m.conf.training.seed, m.iteration_count)
        m.params, m.state, m.updater_state, score = self._synced(
            m._step, m.params, m.state, m.updater_state, m.iteration_count,
            x, y, key, mask)
        m.score_value = score
        for lst in m.listeners:
            if hasattr(lst, "record_batch"):
                lst.record_batch(int(keep))
            lst.iteration_done(m, m.iteration_count, m.score_value)
        m.iteration_count += 1

    # reference API aliases -------------------------------------------------
    def shutdown(self) -> None:  # no worker threads to tear down
        pass


def _head(x, keep: int):
    if isinstance(x, dict):
        return {k: v[:keep] for k, v in x.items()}
    return x[:keep]

"""Elastic training worker: one ZeRO-1 shard owner behind a JSON pipe.

Port of deeplearning4j_tpu/train/elastic_worker.py. `train/elastic.py`'s
`ElasticCoordinator` spawns this module (``python -m
deeplearning4j_tpu_torch.train.elastic_worker``) to put a REAL process
boundary under the elastic membership scenarios — the training analog
of `serving/fleet_worker.py`. Protocol (the reference's, key for key):

- stdin, line 1: the worker spec — ``{"cfg": {TransformerConfig
  kwargs}, "worker_id", "seq_len", "microbatch_size", "data_seed",
  "learning_rate", "b1", "b2", "eps"}``, plus the port's ``"device"``
  (``"cpu"`` or ``"cuda[:i]"``; absent means the card, and without one
  the worker exits with its error: there is no CPU fallback). Batches
  are re-derived from the deterministic data cursor
  (`elastic.data_batch`), so only the param vector crosses the pipe.
- stdout, line 1: ``{"ev": "hello", "pid": ..., "worker": ...}``, plus
  the port's ``"device"``, ``"jax_loaded"`` (whether ``jax`` is in this
  process's ``sys.modules``: it never is), ``"kernels"`` (this
  process's nvcc runs and where each kernel library came from,
  `ops._build.nvcc_runs` / `origin`: a card worker loads what the
  coordinator built and runs no nvcc) and ``"startup_s"`` (seconds of
  its imports and of its device set-up and warm-up call).
- stdin thereafter, one JSON command per line (``epoch`` echoed back
  verbatim on every response so the coordinator can drop stale-epoch
  answers after a resize):

  - ``grads {step, mbs, params}``: compute this step's assigned
    microbatch gradients from the broadcast flat params (base64
    float32) -> ``{"ev": "grads", step, mbs, g: [b64...],
    loss: [float...]}`` in microbatch order.
  - ``adopt_shard {lo, hi, p, m, v}``: become the owner of shard
    ``[lo, hi)``, held on this worker's device -> ``{"ev": "adopted",
    lo, hi, state_bytes}`` — state_bytes is the 3×float32 shard
    footprint the 1/N updater-memory assertion measures.
  - ``export_shard``: ship the shard back for a resize gather /
    checkpoint -> ``{"ev": "shard", lo, hi, p, m, v}``.
  - ``update {step, t, grad}``: one Adam step on the owned shard
    (`elastic.apply_adam_slice` — elementwise, so slice-wise is
    bit-identical to full-vector) -> ``{"ev": "updated", step, lo,
    hi, p}``. Updates apply STRICTLY in arrival order: a loose-sync
    straggler's queued backlog replays the exact sequential chain.
  - ``slow {seconds}``: injected per-command stall before every
    grads/update (the `ElasticFaultInjector.slow_at` knob; 0 clears)
    -> ``{"ev": "slowed", seconds}``.
  - ``ping`` -> ``{"ev": "pong", state_bytes}``, plus the port's
    ``"launches"`` (the flash forward and backward wrappers' counts in
    this process), ``"grad_calls"`` (gradient calls, the warm-up
    included) and ``"peak_bytes"`` (the device's peak allocated bytes);
    ``stop`` -> bye.

The process computes with deterministic algorithms on
(`elastic.set_deterministic`); the coordinator starts it with
``CUBLAS_WORKSPACE_CONFIG`` set. Lines cross the pipes as UTF-8 bytes
of the reference's JSON. A SIGKILL at any point leaves the coordinator holding the last published
checkpoint, which is exactly what the resize barrier reshards from.
"""
from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    t_start = time.perf_counter()
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    spec = json.loads(stdin.readline())

    import numpy as np
    import torch

    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_backward_cuda, flash_forward_cuda)
    from deeplearning4j_tpu_torch.parallel.fsdp import (_sorted_leaves,
                                                        flatten_tree,
                                                        unflatten_tree)
    from deeplearning4j_tpu_torch.train.elastic import (apply_adam_slice,
                                                        data_batch,
                                                        dec_array,
                                                        enc_array,
                                                        make_grad_fn,
                                                        param_template,
                                                        set_deterministic)

    set_deterministic(True)
    t_imported = time.perf_counter()
    cfg = TransformerConfig(**spec["cfg"])
    dev = resolve_device(spec.get("device"))
    wid = int(spec.get("worker_id", 0))
    seq_len = int(spec["seq_len"])
    mb_size = int(spec["microbatch_size"])
    data_seed = int(spec.get("data_seed", 0))
    hyper = {"learning_rate": float(spec.get("learning_rate", 1e-3)),
             "b1": float(spec.get("b1", 0.9)),
             "b2": float(spec.get("b2", 0.999)),
             "eps": float(spec.get("eps", 1e-8))}
    vg = make_grad_fn(cfg, dev)
    template = param_template(cfg)
    grad_calls = [0]

    def grad(params, tok, tgt):
        grad_calls[0] += 1
        return vg(params, tok, tgt)

    # warm up BEFORE hello: the first call sets up the device and its
    # libraries; the coordinator's startup timeout absorbs it, its step
    # barrier must not (a warming worker would look like a straggler)
    n = sum(leaf.numel() for leaf in _sorted_leaves(template))
    _tok, _tgt = data_batch(cfg.vocab_size, seq_len, mb_size, 0, 0,
                            data_seed)
    float(grad(unflatten_tree(np.zeros(n, dtype=np.float32), template),
               _tok, _tgt)[0])
    t_warm = time.perf_counter()

    def emit(obj: dict) -> None:
        stdout.write((json.dumps(obj) + "\n").encode())
        stdout.flush()

    emit({"ev": "hello", "pid": os.getpid(), "worker": wid,
          "device": str(dev), "jax_loaded": "jax" in sys.modules,
          "kernels": {"nvcc_runs": dict(_build.nvcc_runs),
                      "origin": dict(_build.origin)},
          "startup_s": {"imports": t_imported - t_start,
                        "warmup": t_warm - t_imported}})

    shard = None     # {"lo", "hi", "p", "m", "v"} — this worker's
    #                  authoritative slice of params + Adam moments,
    #                  as float32 tensors on its device
    slow_s = 0.0

    def state_bytes() -> int:
        if shard is None:
            return 0
        return int(sum(shard[k].numel() * shard[k].element_size()
                       for k in ("p", "m", "v")))

    def to_dev(s) -> "torch.Tensor":
        return torch.from_numpy(dec_array(s)).to(dev)

    def to_host(t) -> np.ndarray:
        return t.to("cpu").numpy()

    for line in stdin:
        try:
            cmd = json.loads(line)
        except ValueError:
            continue
        op = cmd.get("op")
        epoch = cmd.get("epoch")
        if op in ("grads", "update") and slow_s > 0:
            time.sleep(slow_s)
        if op == "grads":
            step = int(cmd["step"])
            params = unflatten_tree(dec_array(cmd["params"]), template)
            gs, losses = [], []
            for mb in cmd["mbs"]:
                tok, tgt = data_batch(cfg.vocab_size, seq_len, mb_size,
                                      step, int(mb), data_seed)
                loss, gtree = grad(params, tok, tgt)
                gs.append(enc_array(flatten_tree(gtree)))
                losses.append(float(loss))
            emit({"ev": "grads", "epoch": epoch, "step": step,
                  "mbs": list(cmd["mbs"]), "g": gs, "loss": losses})
        elif op == "update":
            if shard is None:
                emit({"ev": "error", "epoch": epoch,
                      "msg": "update before adopt_shard"})
                continue
            step = int(cmd["step"])
            g = to_dev(cmd["grad"])
            shard["p"], shard["m"], shard["v"] = apply_adam_slice(
                shard["p"], g, shard["m"], shard["v"],
                int(cmd["t"]), **hyper)
            emit({"ev": "updated", "epoch": epoch, "step": step,
                  "lo": shard["lo"], "hi": shard["hi"],
                  "p": enc_array(to_host(shard["p"]))})
        elif op == "adopt_shard":
            shard = {"lo": int(cmd["lo"]), "hi": int(cmd["hi"]),
                     "p": to_dev(cmd["p"]), "m": to_dev(cmd["m"]),
                     "v": to_dev(cmd["v"])}
            # run the Adam update once on throwaway inputs of THIS
            # shard's shape inside the resize barrier, so the first real
            # update pays no set-up against the step deadline (the
            # adopted state is untouched)
            z = torch.zeros_like(shard["p"])
            apply_adam_slice(z, z, z, z, 1, **hyper)
            emit({"ev": "adopted", "epoch": epoch, "lo": shard["lo"],
                  "hi": shard["hi"], "state_bytes": state_bytes()})
        elif op == "export_shard":
            if shard is None:
                emit({"ev": "error", "epoch": epoch,
                      "msg": "export before adopt_shard"})
                continue
            emit({"ev": "shard", "epoch": epoch, "lo": shard["lo"],
                  "hi": shard["hi"], "p": enc_array(to_host(shard["p"])),
                  "m": enc_array(to_host(shard["m"])),
                  "v": enc_array(to_host(shard["v"]))})
        elif op == "slow":
            slow_s = float(cmd.get("seconds", 0.0))
            emit({"ev": "slowed", "epoch": epoch, "seconds": slow_s})
        elif op == "ping":
            emit({"ev": "pong", "epoch": epoch,
                  "state_bytes": state_bytes(),
                  "launches": {"flash_fwd": flash_forward_cuda.launches,
                               "flash_bwd": flash_backward_cuda.launches},
                  "grad_calls": grad_calls[0],
                  "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)})
        elif op == "stop":
            break
    emit({"ev": "bye"})
    return 0


if __name__ == "__main__":
    sys.exit(main())

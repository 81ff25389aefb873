"""Tokens per second of the serving engine's two tick loops at full width.

The plain arm of chip_smoke.py's phase 3e as a measurement of its own:
phase 3's bf16 model (12 layers, d_model 512, 8 heads, vocab 256,
max_len 2048, random weights from seed 0) on a 64-slot engine with
decode chunk 8 serves phase 3's 128 requests (prompts of 16-1024 tokens
drawn from seed 0, 64 new tokens each), once on a synchronous engine and
once on a pipelined one. Each engine takes a warm pass (its kernels load
and its CUDA graphs are captured), then ``--rounds`` rounds of timed
passes in the order sync, pipelined, pipelined, sync. Every timed pass
must give the warm synchronous pass's tokens. Prints one JSON line: the
tokens/s of each pass by loop, their medians, the wall ms per decode
step, and the card's name and power limit.

``--root DIR`` imports the engine from another checkout of the
repository (the ``deeplearning4j_tpu_torch`` package under DIR; its
kernels build under DIR/build), so two commits are compared on one card
by running this script for each in turn, alternating which goes first::

    python3 deeplearning4j_tpu_torch/benchmarks/serving_loops.py --root .
    python3 deeplearning4j_tpu_torch/benchmarks/serving_loops.py \\
        --root ../parent_checkout

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def traffic(np, n_req: int = 128):
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, size=n_req)
    return [rng.integers(0, 256, size=int(n)).astype(np.int32)
            for n in lens]


def serve(torch, eng, prompts):
    """One pass: the prompts submitted and served to the end; (tokens
    per request, wall s, decode chunks)."""
    chunks0 = eng.counts["decode_chunks"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p) for p in prompts]
    eng.run_pending()
    out = [h.result() for h in hs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ([o.tolist() for o in out], wall,
            eng.counts["decode_chunks"] - chunks0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout whose deeplearning4j_tpu_torch is measured")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds of timed passes (sync, pipelined, "
                         "pipelined, sync)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serving_loops: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import deeplearning4j_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"serving_loops: imported {pkg.__file__}, not from {root}",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    new, chunk = 64, 8
    params = tf.TransformerLM(cfg, seed=0, device=dev).params
    prompts = traffic(np)
    engs = {p: InferenceEngine(cfg, params, EngineConfig(
        num_slots=64, decode_chunk=chunk, max_new_tokens=new,
        max_queue=256, degrade_queue_depth=1024, pipeline=p), device=dev)
        for p in (False, True)}
    want = serve(torch, engs[False], prompts)[0]
    if serve(torch, engs[True], prompts)[0] != want:
        print("serving_loops: the pipelined loop's tokens differ from the "
              "synchronous loop's", file=sys.stderr)
        return 1
    tps = {False: [], True: []}
    ms = {False: [], True: []}
    for _ in range(args.rounds):
        for p in (False, True, True, False):
            out, wall, chunks = serve(torch, engs[p], prompts)
            if out != want:
                print(f"serving_loops: a timed pass (pipeline={p}) gave "
                      "other tokens", file=sys.stderr)
                return 1
            tps[p].append(len(prompts) * new / wall)
            ms[p].append(wall / (chunk * chunks) * 1e3)
    print(json.dumps(dict(
        run="serving_loops", root=root, card=card(), build_s=build_s,
        requests=len(prompts), new_tokens=new, rounds=args.rounds,
        order="S P P S", sync_tokens_per_s=tps[False],
        pipelined_tokens_per_s=tps[True],
        sync_median=statistics.median(tps[False]),
        pipelined_median=statistics.median(tps[True]),
        sync_wall_ms_per_decode_step=ms[False],
        pipelined_wall_ms_per_decode_step=ms[True])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

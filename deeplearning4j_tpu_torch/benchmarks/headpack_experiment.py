"""Head-packing experiment for the Dh=64 flash backward, on one GPU.

    python -m deeplearning4j_tpu_torch.benchmarks.headpack_experiment \
        [--device cpu] [--small]

Port of the JAX package's benchmarks/headpack_experiment.py (VERDICT r3
#3): does a backward that packs two Dh=64 batch-heads per program and
produces dQ, dK and dV in ONE pass beat the production backward? On the
card the packed arm is csrc/flash_bwd_packed2.cu (one CTA per pair of
heads, one launch per call) and production is csrc/flash_bwd.cu (two
launches: dK/dV, then dQ). At the flagship attention shape (16 x 8 heads,
T = 2048, Dh = 64, bf16, causal, inputs from seed 0; the forward's o, m
and log l from the port's flash forward) it times three arms:

- ``production``: `flash_backward` over the whole T;
- ``packed2_q512``: `packed2_backward`, q-chunked at 512 rows as the JAX
  experiment is (4 launches a call);
- ``production_q512``: the production backward q-chunked the same way,
  the control that separates "chunking helps" from "packing helps".

Before timing, the packed arm's gradients are held against production's
at rtol = atol = 2e-2 (the JAX experiment's check); a mismatch fails the
run. Prints one JSON line: ms per call of each arm (best of 3 replays
of a CUDA graph of 10 calls, as the JAX experiment times a scan of 10;
`_timing.time_ms`), the two speedups, the device, the card with its
power limit, and the kernel launches the run made (counted as the calls
are captured; a replay adds none). ``--small`` (bh 4, T 1024, Dh 16,
one timing of one call) exists for the CPU tests, where the plain twins
run and the times are the host's.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.benchmarks import _timing
from deeplearning4j_tpu_torch.ops import flash_attention as fa

# headpack_experiment.py:206 and its timing (:250, n=10, reps=3)
FLAGSHIP = dict(bh=16 * 8, t=2048, dh=64, n=10, reps=3)
SMALL = dict(bh=4, t=1024, dh=16, n=1, reps=1)
TOL = dict(rtol=2e-2, atol=2e-2)             # headpack_experiment.py:248


def make_inputs(bh: int, t: int, dh: int, device: torch.device,
                dtype=torch.bfloat16, seed: int = 0):
    """q, k, v, dO [bh, t, dh] from a seeded normal draw, in ``dtype``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (bh, t, dh), dtype=np.float32)).to(device, dtype) for _ in range(4))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain twins)")
    ap.add_argument("--small", action="store_true",
                    help="bh 4, T 1024, Dh 16: a CPU smoke size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape = SMALL if args.small else FLAGSHIP
    bh, t, dh, n, reps = (shape[x] for x in ("bh", "t", "dh", "n", "reps"))
    scale = dh ** -0.5

    q, k, v, do = make_inputs(bh, t, dh, dev)
    o, m, logl = fa.flash_forward(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    grads_in = (q, k, v, do, m, logl, delta)
    calls = {"packed2_q512": 0}

    def prod():
        return fa.flash_backward(*grads_in, scale, True)

    def pack():
        calls["packed2_q512"] += 1
        return fa.packed2_backward(*grads_in, scale, True)

    def chunk_ctl():
        return fa.q_chunked(fa.flash_backward, *grads_in, scale, True)

    before = (fa.packed2_backward_cuda.launches,
              fa.flash_backward_cuda.launches)
    want, got = prod(), pack()
    for a, b, name in zip(want, got, ("dq", "dk", "dv")):
        if not torch.allclose(a.float(), b.float(), **TOL):
            err = float((a.float() - b.float()).abs().max())
            raise AssertionError(f"packed2 {name} differs from production "
                                 f"by up to {err} (rtol = atol = 2e-2)")
    del want, got
    ms = {name: _timing.time_ms(fn, dev, n, reps)
          for name, fn in (("production", prod), ("packed2_q512", pack),
                           ("production_q512", chunk_ctl))}
    rec = dict(experiment="headpack2_fused_backward",
               shape=f"bh{bh}_T{t}_Dh{dh}", dtype="bfloat16", causal=True,
               production_ms=ms["production"],
               packed2_q512_ms=ms["packed2_q512"],
               production_q512_ms=ms["production_q512"],
               speedup_vs_production=ms["production"] / ms["packed2_q512"],
               speedup_vs_chunked_control=(ms["production_q512"]
                                           / ms["packed2_q512"]),
               n=n, reps=reps, timer=_timing.timer_name(dev),
               device=dev.type, card=_timing.card(dev),
               packed2_q512_calls=calls["packed2_q512"],
               launches=dict(
                   flash_bwd_packed2=(fa.packed2_backward_cuda.launches
                                      - before[0]),
                   flash_bwd=fa.flash_backward_cuda.launches - before[1]))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()

"""Decode-kernel geometry sweep and copy-bandwidth probe, on one GPU.

    python -m deeplearning4j_tpu_torch.benchmarks.decode_kernel_sweep \
        [--bandwidth] [--device cpu] [--small]

Port of the JAX package's benchmarks/decode_kernel_sweep.py: where does
the decode kernel's time go? It times decode attention at the serving
decode shape (B = 64, H = 8, Dh = 64, S = 2048, bf16, inputs from seed 0)
over launch geometries, at scalar pos 100 and 2000. The TPU sweep varied
cache rows per block (bs) and batch rows per program (bb); here the axes
are the cache rows one CTA covers (bs in 128 .. 2048, so S / bs CTAs
along S for each (b, h), merged by a second launch) and the warps per CTA
(4 or 8): csrc/decode_sweep.cu through `ops.flash_decode.decode_sweep`.
The point bs = S, 4 warps is the production kernel itself
(csrc/decode_attention.cu).

The JAX script's own call passes `_decode_kernel` one prefetched scalar
and no `bb=`; the kernel now takes two prefetched refs (per-row pos and
per-batch-block bound) and `bb`, so that script cannot run as it stands.
This port follows the current kernel's semantics (per-row pos, a
per-batch-block prefix bound), not the stale call.

Prints one JSON line per (bs, warps, pos): the grid, ms per call (best of
3 replays of a CUDA graph of 128 calls, `_timing.time_ms`: device time,
no host time in the window), the byte bound at the
data-sheet 3.35 TB/s (each filled K/V row read once, q read, o written),
and the error against the plain twin at the same bs (bf16 held per row to
2^-7 of the twin row's largest entry plus 1e-5; beyond it the run fails).
A geometry that fails to launch raises.

``--bandwidth`` instead runs the copy probe: 32 in-place multiplies by
1.0001 over a 1 GiB bf16 tensor, best of 3; prints ``gb_per_s`` (bytes
read and written), the rate the card sustains beside its data-sheet one.
The probe is plain PyTorch, as it was plain XLA in JAX. ``--small`` is a
CPU smoke size for the tests.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.benchmarks import _timing
from deeplearning4j_tpu_torch.ops import flash_decode as fd

SWEEP_BS = (128, 256, 512, 1024, 2048)   # cache rows per CTA
FULL = dict(b=64, h=8, dh=64, s=2048, bs=SWEEP_BS, pos=(100, 2000),
            n=128, copy_bytes=1 << 30)
SMALL = dict(b=4, h=2, dh=16, s=64, bs=(4, 8, 16, 32, 64), pos=(3, 62),
             n=2, copy_bytes=1 << 20)
BF16_ROW_RTOL = 2.0 ** -7
BF16_ATOL = 1e-5


def row_rel_err(got, want) -> float:
    """Worst |got - want| in units of 2^-7 * max |want row| + 1e-5 (one
    bf16 rounding in the row's own scale); right when <= 1."""
    g, w = got.float(), want.float()
    row = w.abs().amax(dim=-1, keepdim=True)
    return float(((g - w).abs() / (row * BF16_ROW_RTOL + BF16_ATOL)).max())


def sweep(dev: torch.device, cfg: dict, reps: int = 3) -> List[dict]:
    b, h, dh, s = cfg["b"], cfg["h"], cfg["dh"], cfg["s"]
    d = h * dh
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(dev, torch.bfloat16)
               for shape in ((b, h, dh), (b, s, d), (b, s, d)))
    esz = q.element_size()
    card = _timing.card(dev)
    out = []
    for bs in cfg["bs"]:
        for warps in fd.SWEEP_WARPS:
            for pos in cfg["pos"]:
                before = (fd.decode_sweep_cuda.launches,
                          fd.decode_attention_cuda.launches)
                got = fd.decode_sweep(q, k, v, pos, h, bs, warps)
                want = fd.reference_split_decode_attention(q, k, v, pos, h,
                                                           bs)
                err, rel = float((got.float() - want.float()).abs().max()), \
                    row_rel_err(got, want)
                if not rel <= 1.0:
                    raise AssertionError(
                        f"decode sweep bs={bs} warps={warps} pos={pos}: max "
                        f"err {err}, {rel} x its bf16 row limit")
                ms = _timing.time_ms(
                    lambda: fd.decode_sweep(q, k, v, pos, h, bs, warps), dev,
                    cfg["n"], reps)
                nbytes = 2 * b * (pos + 1) * d * esz + 2 * b * d * esz
                rec = dict(
                    bs=bs, warps=warps, pos=pos,
                    grid=[-(-s // bs), h, b], threads=32 * warps,
                    production=fd.is_production_geometry(bs, warps, s),
                    ms_per_call=ms, bound_bytes=nbytes,
                    bound_ms=nbytes / _timing.DATASHEET_BYTES_PER_S * 1e3,
                    max_abs_err=err, row_rel_err=rel,
                    launches=dict(
                        decode_sweep=(fd.decode_sweep_cuda.launches
                                      - before[0]),
                        decode_attention=(fd.decode_attention_cuda.launches
                                          - before[1])),
                    shape=[b, s, d], dtype="bfloat16", n=cfg["n"],
                    reps=reps, timer=_timing.timer_name(dev),
                    device=dev.type, card=card)
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


def bandwidth_probe(dev: torch.device, nbytes: int, reps: int = 3) -> dict:
    """Sustained copy rate: 32 in-place multiplies of an ``nbytes`` bf16
    tensor, each reading and writing it once."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.empty(nbytes // 2, dtype=torch.bfloat16, device=dev)
    x.normal_(generator=g)

    def run():
        for _ in range(32):
            x.mul_(1.0001)

    ms = _timing.time_ms(run, dev, 1, reps)
    rec = dict(probe="hbm_copy_bandwidth",
               gb_per_s=32 * 2 * x.nbytes / (ms / 1e3) / 1e9,
               datasheet_gb_per_s=_timing.DATASHEET_BYTES_PER_S / 1e9,
               bytes=x.nbytes, ms_per_32_multiplies=ms, reps=reps,
               timer=_timing.timer_name(dev), device=dev.type,
               card=_timing.card(dev))
    print(json.dumps(rec), flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bandwidth", action="store_true",
                    help="run the copy-bandwidth probe instead of the sweep")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain twin)")
    ap.add_argument("--small", action="store_true",
                    help="a CPU smoke size (B 4, H 2, Dh 16, S 64)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SMALL if args.small else FULL
    if args.bandwidth:
        return bandwidth_probe(dev, cfg["copy_bytes"])
    return sweep(dev, cfg)


if __name__ == "__main__":
    main()

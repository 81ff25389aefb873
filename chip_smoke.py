#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (plain and speculative), its train step,
the GravesLSTM char-RNN's training through MultiLayerNetwork and the two
kernel experiments on the card and fails (non-zero exit, no result line)
if anything is wrong:

0. Build: every csrc/*.cu at once; then one line per flash library
   (flash_fwd, flash_bwd, flash_bwd_packed2) with each kernel
   instance's ptxas registers, stack and spills and its HMMA count in
   the SASS (cuobjdump); fails if a bf16 tensor-core instance has no
   HMMA or a half-precision Dh-64 instance (the main path's) spills.
1. Kernel vs plain, on the card: the flash-forward kernel at the main
   path's bf16 prefill shapes (64 slots x 8 heads, Dh=64, causal, T=1024
   as the engine's bucket in phase 3, T=64 as generate's prompt, T=512)
   plus small odd float32 shapes, and the decode kernel at the serving
   decode shape (B=64, S=2048, D=512, H=8, stacked cache; float32 with
   L=2, and bf16 with L=12, layer 5; vector pos including 0 and 2047,
   and a scalar pos). bf16 results are held per row to 2^-7 of the
   plain row's largest entry, float32 results to 1e-5. Each comparison
   prints one JSON line: its errors and tolerance, the kernel's and the
   plain version's times, the time of one PyTorch library call for the
   same function (`scaled_dot_product_attention`, a yardstick the port
   never calls), the least time the card could take (bound) and the
   shape. The summary reports each kernel at the engine's shape. The
   forward's bf16 and f16 paths (the tensor-core tile) are held over the
   float32 odd shapes (ODD_SHAPES: ragged tail, fully-masked rows, q
   after kv with the skip, non-causal S != T) at Dh 32, 64 and 128, to
   the same limits.
1b. The flash-backward kernel vs its plain twin at the training shape
   (16 x 8 heads, T=S=2048, Dh=64, bf16, causal; the forward kernel is
   checked there too), gradients held per row to 2^-6 of the plain
   row's largest entry (see BF16_BWD_ROW_RTOL), and at small odd float32
   shapes (ragged T=100, fully-masked rows, q after kv, non-causal
   S != T) to 1e-5 + 1e-5 |plain|, then bf16 and f16 over ODD_SHAPES at
   Dh 32, 64 and 128 to 2^-6. Its library yardstick is the backward of
   `scaled_dot_product_attention(..., is_causal=True)`; the forward's
   there is SDPA's forward at the training shape. The forward and the
   backward must give equal bits on two calls.
1c. The verify-window kernel vs its plain twin at the spec path's shapes
   (64 slots, windows T=5 and 8, H=8, Dh=64, S=2048; bf16 on the stacked
   L=12 cache at layer 5, float32 on L=2; pos 0, 2047, 2044, 1024 and
   random, so rows clamp at S-1), to phase 1's tolerances; every window
   row must be torch.equal to the decode kernel at pos + t. Yardstick:
   `scaled_dot_product_attention` with the equivalent boolean mask.
1d. The head-packing experiment's backward kernel (two batch-heads per
   CTA, dQ, dK and dV in one launch) vs its plain twin at the
   experiment's shape (16 x 8 heads, T=S=2048, Dh=64, bf16, causal,
   q-chunked at 512: 4 launches), and vs the production backward kernel
   on the same inputs, per row to 2^-6; small odd float32 shapes (ragged
   T=100, fully-masked rows with q before kv, a q_offset chunk,
   non-causal S != T) to 1e-5 + 1e-5 |plain|, and bf16 and f16 over
   ODD_SHAPES at Dh 32 and 64 to 2^-6. Two q512 calls must give equal
   bits. Kernel, twin and SDPA-backward times.
1e. The decode sweep kernel at every geometry (cache rows per CTA bs in
   128..2048 x 4 or 8 warps) vs its twin at the sweep's shape (B=64,
   H=8, Dh=64, S=2048; pos 100, 2000 and a vector with 0 and 2047):
   bf16 rows to 2^-7, float32 to 1e-5; the production point
   (bs=2048, 4 warps) and the sweep kernel forced there must both be
   torch.equal to decode_attention_cuda. ms and bound per bf16 point.
2. float32 end to end, card vs CPU: a 2-layer model at the full width
   (512d / 8 heads) serves 8 greedy requests x 16 new tokens through
   `InferenceEngine` on cuda and on cpu; tokens must match exactly and
   the prefill / first-step logits within 1e-3.
2b. float32 speculative decoding on the same model: spec_k 4 with the
   drafters "self" and "layers:1" (greedy), then "layers:1" sampled
   (temperature 0.9, top-k 16); the spec tokens on cuda must equal the
   plain engine's on cuda and the spec engine's on cpu.
3. Full width: the 12L / 512d / 8H / V=256 / max_len 2048 bf16 engine with
   64 slots and decode_chunk 8 answers 128 requests (prompt lengths 16..1024
   from seed 0, 64 new tokens), then `TransformerLM.generate` runs B=64,
   prompt 64, 128 new greedy tokens. Every launch counter is reset just
   before each run and read just after: each kernel must have run, the
   flash kernel n_layers times per prefill call and the decode kernel
   n_layers x chunk times per decode chunk. One more engine tick (64
   admissions + one decode chunk) runs under torch.profiler and prints
   the device time by kernel and the device's idle share of the tick.
3b. Full-width speculative decoding: phase 3's config and 128 requests on
   the aligned tree (blocks 1..11 with Wo, W2, b2 zeroed, so the
   "layers:1" drafter agrees with the model), spec_k 7, against the plain
   engine (decode_chunk 8) on the same tree. Every request's tokens must
   equal the plain engine's; per spec round the window kernel must run
   n_layers times and the decode kernel K times (one draft layer); K must
   stay 7. Tokens/s, ms per round and per chunk, acceptance and launches
   per round are printed; a probe compares a batched [Ns*(K+1), D]
   product with decode's per-row [Ns, D] products bitwise; one spec round
   and one plain chunk (8 tokens each, no admissions) run under
   torch.profiler.
4a. float32 training, card vs CPU: 2 layers at 512d / 8 heads, V=256,
   B=2, T=256, remat 'full', three Adam steps of `make_fsdp_train_step`
   from the same params on cuda and on cpu; losses within 1e-4, and the
   parameters by the Adam rule of `adam_close` (all but 1e-3 of each
   leaf within 1e-4, every element within 2 * lr * steps).
4b. Full-width training: the flagship training config (12L / 512d / 8H,
   V=256, T=2048, bf16, remat 'full', Adam lr 1e-3) at B=16 takes one
   warm step and 5 timed steps on one seeded batch: ms per step,
   tokens/s, model FLOPs per token (benchmarks/flagship.py's formula) and
   the bf16-peak share they imply; the loss must be finite and fall.
   Launch counters are reset before the timed steps: flash forward must
   run 2 x n_layers times a step (forward and remat recompute), flash
   backward n_layers times. One more step runs under torch.profiler.
5a. The fused LSTM-scan kernel vs its plain twin: the char-RNN's shapes
   (B=1024, T=64, H=200; xw from layer 1's one-hot V=80 input and from
   layer 2's H=200 input) in bf16 and float32, reversed sequences, B=5,
   T=7, H=37 and B=1, T=1, every case with random peepholes and carries;
   hs, cs and gates within 1e-5 + 1e-5 |plain| (see LSTM_TOL). Times the
   kernel, the twin and torch.nn.LSTM (cuDNN; the yardstick, never
   called by the port; it does x.W too, timed alone beside it).
5b. float32 char-RNN card vs CPU: V=80, H=200, 2 layers, B=32, T=64,
   TBPTT 32, lstm_wavefront off, one set of weights; three fit calls
   (scores within 1e-4, parameters by `rmsprop_close`), then 32
   rnn_time_step outputs within 1e-4; lstm_scan launches exactly 2 per
   chunk and 2 per step.
5c. Full width: BASELINE config 3 (bf16, RMSProp lr 0.1) at B=1024, T=64:
   fit_batched over 4 seeded minibatches x 3 epochs after one warm pass,
   lstm_wavefront off: chars/s, ms per minibatch, model FLOPs per char
   (benchmarks/flagship.py:214), the bf16-peak share, peak memory; the
   score finite and falling; lstm_scan exactly 2 launches a minibatch.
   One more minibatch runs under torch.profiler. The same pool with
   lstm_wavefront on (its chars/s; the kernel must not launch), then 200
   characters sampled by rnn_time_step at B=1 (2 launches a step).
6. The two kernel experiments' main() at full shape
   (`deeplearning4j_tpu_torch.benchmarks.headpack_experiment`: production
   vs packed q512 vs production q512; `decode_kernel_sweep --bandwidth`,
   then its 20-point sweep), with launch counters reset before and read
   after: 4 packed launches per q512 call, the sweep kernel at every
   non-production geometry. The sweep's bounds stay on the data-sheet
   3.35 TB/s; the measured copy rate's bound is printed beside them.
7. Summary: one `kernels` JSON line, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The kernels build from deeplearning4j_tpu_torch/csrc/ at the start (one
nvcc per source, started together). Weights are random, from fixed seeds.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (the bound of every kernel line)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def line(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 1: kernels vs their plain versions
# ---------------------------------------------------------------------------

# a bfloat16 result is right to one rounding of its row's magnitude: the
# kernel and its plain twin sum in float32 in other orders and may round
# an element to neighbouring bf16 values, one ulp apart, and one ulp of
# any entry is at most 2**-7 of the row's largest entry; a fault in the
# online-softmax merge moves outputs by their own size
BF16_ROW_RTOL = 2.0 ** -7
BF16_ATOL = 1e-5
BF16_TOL = f"|err| <= 2^-7 * max|plain row| + {BF16_ATOL}"


def row_rel_err(got, want, rtol: float = BF16_ROW_RTOL) -> float:
    """Worst |got - want| in units of the bf16 limit of its row (the last
    axis): rtol * max|want_row| + BF16_ATOL. Right when <= 1."""
    g, w = got.float(), want.float()
    row = w.abs().amax(dim=-1, keepdim=True)
    return float(((g - w).abs() / (row * rtol + BF16_ATOL)).max())


# The odd shapes of the float32 gates, run in bf16 and f16 too (the
# tensor-core path): (causal, tq, sk, q_offset, kv_offset)
ODD_SHAPES = ((True, 100, 100, 0, 0),    # a ragged tail
              (True, 64, 96, 0, 32),     # kv_offset > q_offset: masked rows
              (True, 77, 200, 123, 0),   # q after kv, with the causal skip
              (False, 77, 150, 0, 0))    # non-causal, S != T
ODD_SHAPES_NOTE = ("ragged T=100; kv_offset 32 > q_offset 0 (fully-masked "
                   "rows); q_offset 123 after kv (skip); non-causal S=150 "
                   "!= T=77; bh 6")


def half_odd_shape_gates(torch, dev, phase, kernel: str, dhs, seed: int):
    """The bf16 and f16 (tensor-core) path of ``kernel`` against its plain
    twin over ODD_SHAPES at each head dim in ``dhs``: outputs per row to
    2^-7 (the forward, with m and log l to 1e-4) or gradients to 2^-6.
    One line per (dtype, Dh); fails on any case past its limit."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    backward = {"flash_bwd": (fa.flash_backward_cuda,
                              fa.flash_backward_reference),
                "flash_bwd_packed2": (fa.packed2_backward_cuda,
                                      fa.packed2_backward_reference)}
    for name in ("bfloat16", "float16"):
        dtype = getattr(torch, name)
        for dh in dhs:
            scale = dh ** -0.5
            rels, stats = [], []
            for causal, tq, sk, qo, ko in ODD_SHAPES:
                q = rnd((6, tq, dh), dtype)
                k, v = rnd((6, sk, dh), dtype), rnd((6, sk, dh), dtype)
                got_f = fa.flash_forward_cuda(q, k, v, scale, causal, qo, ko)
                if kernel == "flash_fwd":
                    want = fa.flash_forward_reference(q, k, v, scale, causal,
                                                      qo, ko)
                    rels.append(row_rel_err(got_f[0], want[0]))
                    stats.append(max(max_err(got_f[1], want[1]),
                                     max_err(got_f[2], want[2])))
                    continue
                do = rnd((6, tq, dh), dtype)
                o, m, logl = got_f
                args = (q, k, v, do, m, logl,
                        (do.float() * o.float()).sum(-1, keepdim=True))
                cuda_fn, plain = backward[kernel]
                got = cuda_fn(*args, scale, causal, qo, ko)
                want = plain(*args, scale, causal, qo, ko)
                rels.append(max(row_rel_err(a, b, BF16_BWD_ROW_RTOL)
                                for a, b in zip(got, want)))
            rec = dict(phase=phase, kernel=kernel, dtype=name, dh=dh,
                       shapes=ODD_SHAPES_NOTE, row_rel_err=rels,
                       tol=BF16_TOL if kernel == "flash_fwd"
                       else BF16_BWD_TOL)
            if stats:
                rec.update(stats_err=max(stats), stats_tol=1e-4)
            line(rec)
            if max(rels) > 1.0 or (stats and max(stats) > 1e-4):
                fail(f"{kernel} {name} Dh {dh} odd shapes: row-relative "
                     f"{rels} (limit 1), stats {stats}")


def same_bits(torch, fn, what: str) -> bool:
    """Two calls on the same inputs must give equal bits (the kernels use
    no atomics)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"{what}: two calls on the same inputs differ")
    return True


# the tensor-core kernels, whose bf16 instances must run HMMA
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "flash_bwd_packed2_tc_kernel")


def build_report(name: str):
    """One line for a redesigned library: each kernel instance's ptxas
    registers and spills and its HMMA / HGMMA count in the SASS. Fails if
    a bf16 instance of a tensor-core kernel has no HMMA, or if a
    half-precision Dh-64 instance (the main path's) spills."""
    import re
    from deeplearning4j_tpu_torch.ops import _build
    regs = _build.ptxas_report(name)
    mma = _build.sass_mma_counts(name)
    rows = []
    for fn, st in regs.items():
        if "kernel" not in fn:
            continue
        short = re.search(r"(\w+<[^>]*>)", fn)
        short = short.group(1) if short else fn
        tc_kernel = any(k in fn for k in TC_KERNELS)
        half = "__nv_bfloat16" in fn or "__half" in fn
        dh = re.search(r"(?:, |Li)(32|64|128)(?:,|E|>)", fn)
        spills = st.get("spill_stores", 0) + st.get("spill_loads", 0)
        rows.append(dict(instance=short, registers=st.get("registers"),
                         stack_frame=st.get("stack_frame"),
                         spill_stores=st.get("spill_stores"),
                         spill_loads=st.get("spill_loads"),
                         mma=mma.get(fn, 0)))
        if tc_kernel and "__nv_bfloat16" in fn and not mma.get(fn, 0):
            fail(f"{name}: bf16 instance {short} has no HMMA instruction")
        if tc_kernel and half and dh and dh.group(1) == "64" and spills:
            fail(f"{name}: Dh-64 instance {short} spills ({st})")
    if not any("__nv_bfloat16" in r["instance"] and
               any(k in r["instance"] for k in TC_KERNELS) for r in rows):
        fail(f"{name}: no bf16 tensor-core instance in the ptxas report")
    line(dict(phase=0, library=name, instances=rows))


def phase_kernels(torch, dev):
    """Each kernel against its plain twin, on the card, at the shapes the
    main path gives it; times at the engine's shapes for the summary."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(0)
    results = {}

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    # -- flash forward at the main path's bf16 prefill shapes ------------
    # 64 slots (or generate's 64 rows) x 8 heads, Dh 64, causal; T=1024 is
    # the engine's prefill bucket in phase 3 (its prompts reach 1024),
    # T=64 generate's prompt, T=512 a half-full bucket
    bh, dh = 64 * 8, 64
    scale = dh ** -0.5
    bf = torch.bfloat16
    for t in (1024, 64, 512):
        q3, k3, v3 = (rnd((bh, t, dh), bf) for _ in range(3))
        o, m, logl = fa.flash_forward_cuda(q3, k3, v3, scale, True)
        ro, rm, rl = fa.flash_forward_reference(q3, k3, v3, scale, True)
        err = max_err(o, ro)
        rel = row_rel_err(o, ro)
        err_stats = max(max_err(m, rm), max_err(logl, rl))
        if not (rel <= 1.0 and err_stats <= 1e-4):
            fail(f"flash forward bf16 T={t}: max err {err}, row-relative "
                 f"{rel} (limit 1), stats {err_stats}")
        k_ms = time_ms(lambda: fa.flash_forward_cuda(q3, k3, v3, scale,
                                                     True))
        p_ms = time_ms(lambda: fa.flash_forward_reference(
            q3, k3, v3, scale, True), iters=3)
        q4, k4, v4 = (x.view(64, 8, t, dh) for x in (q3, k3, v3))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale))
        nbytes = 4 * bh * t * dh * 2 + 2 * bh * t * 4
        flops = 4 * bh * dh * (t * (t + 1) // 2)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        rec = dict(phase=1, kernel="flash_fwd", dtype="bfloat16",
                   causal=True, shape=[bh, t, dh], max_abs_err=err,
                   row_rel_err=rel,
                   tol=BF16_TOL,
                   stats_err=err_stats, stats_tol=1e-4, kernel_ms=k_ms,
                   plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        line(rec)
        if t == 1024:
            results["flash_fwd"] = rec
        del q3, k3, v3, o, ro, q4, k4, v4

    # -- flash forward, small odd float32 shapes -------------------------
    for tq, sk, qo, ko in ((100, 100, 0, 0), (64, 96, 0, 32),
                           (77, 200, 123, 0)):
        qs = rnd((6, tq, dh), torch.float32)
        ks, vs = rnd((6, sk, dh), torch.float32), rnd((6, sk, dh),
                                                      torch.float32)
        got = fa.flash_forward_cuda(qs, ks, vs, scale, True, qo, ko)
        want = fa.flash_forward_reference(qs, ks, vs, scale, True, qo, ko)
        errs = [max_err(x, y) for x, y in zip(got, want)]
        line(dict(phase=1, kernel="flash_fwd", dtype="float32",
                  shape=[6, tq, sk, dh], q_offset=qo, kv_offset=ko,
                  max_abs_err=max(errs), tol=1e-5))
        if not max(errs) <= 1e-5:
            fail(f"flash forward f32 {tq}x{sk} offsets {qo},{ko}: {errs}")
    half_odd_shape_gates(torch, dev, 1, "flash_fwd", (32, 64, 128), 10)

    # -- decode at the serving decode shape ------------------------------
    L, B, S, D, H = 12, 64, 2048, 512, 8
    Dh = D // H
    layer = 5
    pos_v = torch.from_numpy(np.random.default_rng(0).integers(
        0, S, size=B).astype(np.int32))
    pos_v[0], pos_v[1] = 0, S - 1
    pos_v = pos_v.to(dev)

    # float32 at the serving shape (stacked 2-layer pool, as phase 2)
    ck, cv = rnd((2, B, S, D), torch.float32), rnd((2, B, S, D),
                                                   torch.float32)
    qd = rnd((B, H, Dh), torch.float32)
    got = fd.decode_attention_cuda(qd, ck, cv, pos_v, H, layer=1)
    want = fd.reference_decode_attention(qd, ck[1], cv[1], pos_v, H)
    err32 = max_err(got, want)
    line(dict(phase=1, kernel="decode_attention", dtype="float32",
              shape=[2, B, S, D], layer=1, pos="vector [0..2047]",
              max_abs_err=err32, tol=1e-5))
    if not err32 <= 1e-5:
        fail(f"decode float32 vector pos: max err {err32}")
    del ck, cv, qd

    ck, cv = rnd((L, B, S, D), bf), rnd((L, B, S, D), bf)
    qd = rnd((B, H, Dh), bf)
    got = fd.decode_attention_cuda(qd, ck, cv, pos_v, H, layer=layer)
    want = fd.reference_decode_attention(qd, ck[layer], cv[layer], pos_v, H)
    err_v = max_err(got, want)
    rel_v = row_rel_err(got, want)
    if not rel_v <= 1.0:
        fail(f"decode vector pos: max err {err_v}, row-relative {rel_v}")
    rows = int((pos_v.long() + 1).sum())
    nb_v = 2 * rows * Dh * H * 2 + 2 * B * D * 2 + B * 4
    bv_ms, bv_by = bound(nb_v, 4 * rows * D, "bfloat16")
    kv_ms = time_ms(lambda: fd.decode_attention_cuda(qd, ck, cv, pos_v, H,
                                                     layer=layer))
    line(dict(phase=1, kernel="decode_attention", dtype="bfloat16",
              shape=[L, B, S, D], layer=layer, pos="vector [0..2047]",
              max_abs_err=err_v, row_rel_err=rel_v,
              tol=BF16_TOL, kernel_ms=kv_ms,
              bound_ms=bv_ms, bound_by=bv_by))

    pos_s = S - 1                                   # a full cache
    got = fd.decode_attention_cuda(qd, ck, cv, pos_s, H, layer=layer)
    want = fd.reference_decode_attention(qd, ck[layer], cv[layer], pos_s, H)
    err_s = max_err(got, want)
    rel_s = row_rel_err(got, want)
    if not rel_s <= 1.0:
        fail(f"decode scalar pos: max err {err_s}, row-relative {rel_s}")
    k_ms = time_ms(lambda: fd.decode_attention_cuda(qd, ck, cv, pos_s, H,
                                                    layer=layer))
    p_ms = time_ms(lambda: fd.reference_decode_attention(
        qd, ck[layer], cv[layer], pos_s, H), iters=5)
    kl = ck[layer].view(B, S, H, Dh).transpose(1, 2)
    vl = cv[layer].view(B, S, H, Dh).transpose(1, 2)
    ql = qd.view(B, H, 1, Dh)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl))
    nbytes = 2 * B * S * D * 2 + 2 * B * D * 2
    b_ms, b_by = bound(nbytes, 4 * B * S * D, "bfloat16")
    rec = dict(phase=1, kernel="decode_attention", dtype="bfloat16",
               shape=[L, B, S, D], layer=layer, pos=pos_s,
               max_abs_err=max(err_s, err_v), row_rel_err=rel_s,
               tol=BF16_TOL, kernel_ms=k_ms,
               plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    line(rec)
    results["decode_attention"] = rec
    del ck, cv
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 1c: the verify-window kernel vs its plain twin and the decode kernel
# ---------------------------------------------------------------------------

def phase_window_kernel(torch, dev):
    """The window kernel at the spec path's shapes (B=64 slots, T=K+1 of 5
    and 8, H=8, Dh=64, S=2048): bf16 on the stacked L=12 cache (layer 5)
    and float32 on L=2, pos covering 0, mid values and rows that clamp
    at S-1. Gates: the phase-1 tolerances against the plain twin, and
    every window row torch.equal to the decode kernel at pos + t."""
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(4)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    B, S, D, H = 64, 2048, 512, 8
    Dh = D // H
    pos = torch.from_numpy(np.random.default_rng(4).integers(
        0, S, size=B).astype(np.int32))
    pos[0], pos[1], pos[2], pos[3] = 0, S - 1, S - 4, S // 2
    pos = pos.to(dev)
    rec = None
    for dtype, L, layer in ((torch.float32, 2, 1), (torch.bfloat16, 12, 5)):
        name = str(dtype).split(".")[-1]
        ck, cv = rnd((L, B, S, D), dtype), rnd((L, B, S, D), dtype)
        for t in (5, 8):
            q = rnd((B, t, H, Dh), dtype)
            got = fd.decode_window_attention_cuda(q, ck, cv, pos, H,
                                                  layer=layer)
            want = fd.reference_window_attention(q, ck[layer], cv[layer],
                                                 pos, H)
            err = max_err(got, want)
            if dtype == torch.float32:
                ok, rel, tol = err <= 1e-5, None, 1e-5
            else:
                rel = row_rel_err(got, want)
                ok, tol = rel <= 1.0, BF16_TOL
            if not ok:
                fail(f"window {name} T={t}: max err {err}, row-relative "
                     f"{rel}")
            for ti in range(t):
                row = fd.decode_attention_cuda(q[:, ti].contiguous(), ck, cv,
                                               pos + ti, H, layer=layer)
                if not torch.equal(got[:, ti], row):
                    fail(f"window {name} T={t}: row {ti} differs from the "
                         f"decode kernel at pos+{ti} by "
                         f"{max_err(got[:, ti], row)}")
            k_ms = time_ms(lambda: fd.decode_window_attention_cuda(
                q, ck, cv, pos, H, layer=layer))
            p_ms = time_ms(lambda: fd.reference_window_attention(
                q, ck[layer], cv[layer], pos, H), iters=3)
            # SDPA with the equivalent boolean mask: window row t of slot
            # b keeps keys 0..clip(pos_b + t, 0, S-1)
            wp = torch.clamp(pos[:, None] + torch.arange(t, device=dev), 0,
                             S - 1)
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= wp[:, :, None])[:, None]          # [B, 1, T, S]
            kl = ck[layer].view(B, S, H, Dh).transpose(1, 2)
            vl = cv[layer].view(B, S, H, Dh).transpose(1, 2)
            ql = q.transpose(1, 2)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask))
            # bytes: each cache row the window reaches, K and V, read
            # once; q read and o written once; pos read
            rows = int((wp[:, -1].long() + 1).sum())
            esz = ck.element_size()
            nbytes = 2 * rows * D * esz + 2 * B * t * D * esz + B * 4
            flops = 4 * D * int((wp.long() + 1).sum())
            b_ms, b_by = bound(nbytes, flops, name)
            r = dict(phase="1c", kernel="decode_window", dtype=name,
                     shape=[L, B, S, D], window=t, layer=layer,
                     pos="vector: 0, 2047, 2044, 1024, random",
                     max_abs_err=err, row_rel_err=rel, tol=tol,
                     rows_equal_decode_kernel=True, kernel_ms=k_ms,
                     plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                     bound_by=b_by, bound_bytes=nbytes)
            line(r)
            if dtype == torch.bfloat16 and t == 8:
                rec = r
            del q, got, want, mask
        del ck, cv
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 2: float32 end to end, card vs CPU
# ---------------------------------------------------------------------------

def phase_f32_card_vs_cpu(torch, dev):
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    outs, logits = {}, {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else torch.device("cpu")
        params = tf.init_params(cfg, seed=1, device=d)
        eng = InferenceEngine(cfg, params, EngineConfig(
            num_slots=8, decode_chunk=8, max_new_tokens=16), device=d)
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        outs[name] = [h.result() for h in hs]
        batch = torch.from_numpy(np.stack([p[:8] for p in prompts])).to(d)
        with torch.no_grad():
            last, caches = tf.prefill(cfg, params, batch)
            step, _ = tf.decode_step(cfg, params, last.argmax(-1), caches, 8)
        logits[name] = (last.cpu(), step.cpu())
    same = all(np.array_equal(a, b) for a, b in zip(outs["cuda"],
                                                   outs["cpu"]))
    lerr = max(float((a - b).abs().max())
               for a, b in zip(logits["cuda"], logits["cpu"]))
    line(dict(phase=2, requests=len(prompts), new_tokens=16,
              tokens_equal=same, logits_max_abs_err=lerr, tol=1e-3))
    if not same:
        fail("float32 engine tokens differ between card and CPU")
    if not lerr <= 1e-3:
        fail(f"float32 logits differ between card and CPU by {lerr}")


# ---------------------------------------------------------------------------
# phase 2b: float32 speculative decoding, card vs CPU
# ---------------------------------------------------------------------------

def phase_spec_f32_card_vs_cpu(torch, dev):
    """Phase 2's 2-layer 512d model and 8 requests: the spec engine (K=4;
    drafters "self" and "layers:1" greedy, then "layers:1" sampled at
    temperature 0.9, top-k 16) must give the card's plain-engine tokens
    on the card and the same tokens on the CPU."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    params = {d: tf.init_params(cfg, seed=1, device=d)
              for d in (dev, torch.device("cpu"))}

    def serve(d, **kw):
        eng = InferenceEngine(cfg, params[d], EngineConfig(
            num_slots=8, decode_chunk=8, max_new_tokens=16, **kw), device=d)
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        return eng, [h.result() for h in hs]

    for draft, samp in (("self", {}), ("layers:1", {}),
                        ("layers:1", dict(temperature=0.9, top_k=16))):
        _, plain = serve(dev, **samp)
        fd.decode_window_attention_cuda.launches = 0
        eng, spec = serve(dev, spec_decode=True, spec_k=4, draft=draft,
                          **samp)
        n_win = fd.decode_window_attention_cuda.launches
        _, spec_cpu = serve(torch.device("cpu"), spec_decode=True, spec_k=4,
                            draft=draft, **samp)
        same_plain = all(np.array_equal(a, b) for a, b in zip(spec, plain))
        same_cpu = all(np.array_equal(a, b) for a, b in zip(spec, spec_cpu))
        c = eng.counts
        line(dict(phase="2b", draft=draft, spec_k=4, **samp,
                  requests=len(prompts), new_tokens=16,
                  spec_equals_plain_cuda=same_plain,
                  spec_cuda_equals_spec_cpu=same_cpu,
                  spec_rounds=c["spec_rounds"], decode_chunks=c[
                      "decode_chunks"], drafted=c["spec_drafted"],
                  accepted=c["spec_accepted"], window_launches=n_win))
        if not (same_plain and same_cpu):
            fail(f"float32 spec ({draft}, {samp}): tokens differ, spec vs "
                 f"plain on the card {same_plain}, card vs CPU {same_cpu}")
        if n_win != cfg.n_layers * c["spec_rounds"] or not n_win:
            fail(f"float32 spec ({draft}): {n_win} window launches for "
                 f"{c['spec_rounds']} rounds of {cfg.n_layers} layers")


# ---------------------------------------------------------------------------
# phase 3: the full-width serving path, with launch counts
# ---------------------------------------------------------------------------

def phase_full_width(torch, dev):
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L = cfg.n_layers
    n_req, new = 128, 64
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, size=n_req)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens]
    lm = tf.TransformerLM(cfg, seed=0, device=dev)
    eng = InferenceEngine(cfg, lm.params, EngineConfig(
        num_slots=64, decode_chunk=8, max_new_tokens=new, max_queue=256,
        degrade_queue_depth=1024), device=dev)

    fa.flash_forward_cuda.launches = 0
    fd.decode_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p) for p in prompts]
    eng.run_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_flash, n_dec = (fa.flash_forward_cuda.launches,
                      fd.decode_attention_cuda.launches)
    for h, p in zip(hs, prompts):
        out = h.result()
        if out.shape != (p.shape[0] + new,) or \
                not np.array_equal(out[:p.shape[0]], p) or \
                out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"request {h.rid}: bad result of shape {out.shape}")
    c = eng.counts
    if n_flash != L * c["prefill_calls"] or \
            n_dec != L * eng.decode_chunk * c["decode_chunks"]:
        fail(f"engine launch counts flash={n_flash} decode={n_dec} vs "
             f"{c} with L={L}, chunk={eng.decode_chunk}")
    steps = eng.decode_chunk * c["decode_chunks"]
    line(dict(phase=3, run="engine", requests=n_req, answered=len(hs),
              new_tokens=new, prompt_len_min=int(lens.min()),
              prompt_len_max=int(lens.max()), wall_s=wall,
              tokens_per_s=n_req * new / wall,
              prefill_calls=c["prefill_calls"],
              prefill_s=eng.seconds["prefill"],
              decode_chunks=c["decode_chunks"],
              decode_s=eng.seconds["decode"],
              ms_per_decode_step=eng.seconds["decode"] / steps * 1e3,
              flash_launches=n_flash, decode_launches=n_dec))

    gb, gt, gnew = 64, 64, 128
    prompt = torch.from_numpy(rng.integers(0, 256, size=(gb, gt)).astype(
        np.int32)).to(dev)
    fa.flash_forward_cuda.launches = 0
    fd.decode_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.generate(prompt, gnew, temperature=0.0)
    torch.cuda.synchronize()
    gwall = time.perf_counter() - t0
    g_flash, g_dec = (fa.flash_forward_cuda.launches,
                      fd.decode_attention_cuda.launches)
    if tuple(out.shape) != (gb, gt + gnew) or \
            not torch.equal(out[:, :gt], prompt):
        fail(f"generate returned shape {tuple(out.shape)}")
    if g_flash != L or g_dec != L * (gnew - 1):
        fail(f"generate launch counts flash={g_flash} decode={g_dec}")
    # generate is one call: its wall time per new token includes the
    # B=64 prompt prefill
    line(dict(phase=3, run="generate", batch=gb, prompt=gt, new_tokens=gnew,
              wall_s=gwall, tokens_per_s=gb * gnew / gwall,
              wall_ms_per_new_token=gwall / gnew * 1e3,
              flash_launches=g_flash, decode_launches=g_dec))
    phase_profile(torch, eng, rng)
    return {"flash_fwd": n_flash + g_flash,
            "decode_attention": n_dec + g_dec}


# ---------------------------------------------------------------------------
# phase 3b: full-width speculative decoding against the plain engine
# ---------------------------------------------------------------------------

def aligned_params(tf, cfg, dev):
    """Phase 3's random tree with blocks 1..L-1's Wo, W2 and b2 zeroed
    (benchmarks/flagship.py:1123-1126): the deep layers add nothing to the
    residual stream, so the "layers:1" drafter's logits are the full
    model's and greedy acceptance is 1.0 when verify equals decode."""
    params = tf.init_params(cfg, seed=0, device=dev)
    for name in ("Wo", "W2", "b2"):
        params["blocks"][name][1:] = 0
    return params


def probe_batched_products(torch, dev, ns=64, t=8, d=512):
    """Why the verify pass runs decode's per-row products: a [Ns*(K+1), D]
    bf16 product (and layer norm) against K+1 products of decode's own
    [Ns, D] shape on the same rows, bitwise, with both times."""
    from deeplearning4j_tpu_torch.nn.layers.attention import layer_norm
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn((t, ns, d), generator=g).to(dev, torch.bfloat16)
    out = {}
    for name, n in (("Wq", d), ("W1", 4 * d)):
        w = (torch.randn((d, n), generator=g) / d ** 0.5).to(
            dev, torch.bfloat16)
        batched = torch.matmul(x.reshape(t * ns, d), w).reshape(t, ns, n)
        rows = torch.stack([torch.matmul(x[i], w) for i in range(t)])
        out[f"{name}_bitwise_equal"] = bool(torch.equal(batched, rows))
        out[f"{name}_max_abs_diff"] = max_err(batched, rows)
        out[f"{name}_batched_ms"] = time_ms(
            lambda: torch.matmul(x.reshape(t * ns, d), w))
        out[f"{name}_per_row_ms"] = time_ms(
            lambda: [torch.matmul(x[i], w) for i in range(t)])
    one = torch.ones(d, device=dev)
    zero = torch.zeros(d, device=dev)
    ln_b = layer_norm(x[:, :, None], one, zero)
    ln_r = torch.stack([layer_norm(x[i][:, None], one, zero)
                        for i in range(t)])
    out["layer_norm_bitwise_equal"] = bool(torch.equal(ln_b, ln_r))
    return out


def phase_spec_full_width(torch, dev):
    """The flagship decode config of phase 3 on the aligned tree, 64 slots,
    the same 128 requests: spec_k=7 with the "layers:1" drafter against
    the plain engine (decode_chunk 8). Gates: every request's tokens
    equal; the window kernel L times per spec round; the decode kernel
    draft_layers x K times per round; K stays 7 (acceptance holds)."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L, K, nd = cfg.n_layers, 7, 1
    n_req, new = 128, 64
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, size=n_req)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens]
    params = aligned_params(tf, cfg, dev)
    counters = (fa.flash_forward_cuda, fd.decode_attention_cuda,
                fd.decode_window_attention_cuda)
    arms, launches = {}, {}
    for arm, kw in (("plain", dict(decode_chunk=8)),
                    ("spec", dict(spec_decode=True, spec_k=K,
                                  draft=f"layers:{nd}"))):
        eng = InferenceEngine(cfg, params, EngineConfig(
            num_slots=64, max_new_tokens=new, max_queue=256,
            degrade_queue_depth=1024, **kw), device=dev)
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_flash, n_dec, n_win = (c.launches for c in counters)
        arms[arm] = (eng, [h.result() for h in hs], wall)
        launches[arm] = {"flash_fwd": n_flash, "decode_attention": n_dec,
                         "decode_window": n_win}
        c = eng.counts
        rec = dict(phase="3b", arm=arm, requests=n_req, new_tokens=new,
                   wall_s=wall, tokens_per_s=n_req * new / wall,
                   prefill_calls=c["prefill_calls"],
                   prefill_s=eng.seconds["prefill"],
                   flash_launches=n_flash, decode_launches=n_dec,
                   window_launches=n_win)
        if arm == "plain":
            rec.update(decode_chunks=c["decode_chunks"],
                       ms_per_decode_chunk=eng.seconds["decode"]
                       / c["decode_chunks"] * 1e3,
                       decode_launches_per_chunk=n_dec / c["decode_chunks"])
        else:
            rounds = c["spec_rounds"]
            rec.update(spec_k=K, draft=f"layers:{nd}", spec_rounds=rounds,
                       decode_chunks=c["decode_chunks"],
                       ms_per_spec_round=eng.seconds["spec"] / rounds * 1e3,
                       drafted=c["spec_drafted"],
                       accepted=c["spec_accepted"],
                       acceptance=c["spec_accepted"] / c["spec_drafted"],
                       spec_k_final=eng.spec_k_current,
                       window_launches_per_round=n_win / rounds,
                       decode_launches_per_round=n_dec / rounds)
        line(rec)
    eng, spec, _ = arms["spec"]
    plain = arms["plain"][1]
    bad = [i for i, (a, b) in enumerate(zip(spec, plain))
           if not np.array_equal(a, b)]
    if bad:
        fail(f"full-width spec tokens differ from the plain engine in "
             f"requests {bad[:8]} ({len(bad)} of {n_req})")
    rounds = eng.counts["spec_rounds"]
    if eng.counts["decode_chunks"] or eng.spec_k_current != K:
        fail(f"aligned spec run left K={K}: {eng.counts}, K now "
             f"{eng.spec_k_current}")
    if launches["spec"]["decode_window"] != L * rounds or \
            launches["spec"]["decode_attention"] != nd * K * rounds or \
            launches["spec"]["flash_fwd"] != L * eng.counts["prefill_calls"]:
        fail(f"spec launch counts {launches['spec']} for {rounds} rounds, "
             f"L={L}, K={K}, draft layers {nd}")
    line(dict(phase="3b", run="probe_batched_products",
              **probe_batched_products(torch, dev)))
    for arm, (e, _, _) in arms.items():
        profile_decode_tick(torch, e, rng, arm)
    del arms, eng, params
    torch.cuda.empty_cache()
    total = {}
    for arm in launches.values():
        for name, n in arm.items():
            total[name] = total.get(name, 0) + n
    return total


def profile_decode_tick(torch, eng, rng, arm):
    """One decode phase with no admissions in its tick (a spec round of
    K+1 = 8 tokens, or a plain chunk of 8) under torch.profiler: device
    time and launches by kernel, and the device's idle share."""
    kind = "spec_rounds" if arm == "spec" else "decode_chunks"
    prompts = [rng.integers(0, 256, size=64).astype(np.int32)
               for _ in range(eng.num_slots)]
    # 17 tokens: the prefill's first, then two rounds (or chunks) of 8
    warm = [eng.submit(p, max_new_tokens=17) for p in prompts]
    eng.run_pending()
    hs = [eng.submit(p, max_new_tokens=17) for p in prompts]
    eng.tick()                              # admissions + the first 8
    n = eng.counts[kind]
    wall, rows = profiled(torch, eng.tick)  # the second 8 alone
    if eng.counts[kind] != n + 1:
        fail(f"the profiled {arm} tick ran no {kind[:-1]}")
    eng.run_pending()
    if not all(h.done() for h in hs + warm):
        fail(f"profiled {arm} tick left requests unanswered")
    profile_line(wall, rows, phase="3b", run=f"profiled_{arm}_tick")


def device_rows(prof):
    """(name, device us, count) of the device-side events of a
    torch.profiler run, largest first: the host ops that launched them
    report the same device time again, so they are left out."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profiled(torch, fn):
    """Run fn() once under torch.profiler; returns (wall s, device rows)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_rows(prof)


def profile_line(wall, rows, **rec):
    busy = sum(us for _, us, _ in rows) / 1e6
    rec.update(wall_s=wall,
               device_busy_s=busy if rows else "not measured",
               device_launches=sum(n for _, _, n in rows) if rows
               else "not measured",
               device_idle_share=(1 - busy / wall) if rows
               else "not measured",
               top_kernels=[dict(name=k[:80], ms=us / 1e3, count=n)
                            for k, us, n in rows[:8]])
    line(rec)


def phase_profile(torch, eng, rng):
    """One engine tick (64 admissions of 64 tokens + one decode chunk of
    8) under torch.profiler: device time by kernel and the device's idle
    share of the tick's wall time."""
    prompts = [rng.integers(0, 256, size=64).astype(np.int32)
               for _ in range(eng.num_slots)]
    warm = [eng.submit(p, max_new_tokens=9) for p in prompts]
    eng.run_pending()
    hs = [eng.submit(p, max_new_tokens=9) for p in prompts]
    wall, rows = profiled(torch, eng.tick)
    eng.run_pending()
    if not all(h.done() for h in hs + warm):
        fail("profiled tick left requests unanswered")
    profile_line(wall, rows, phase=3, run="profiled_tick")


# ---------------------------------------------------------------------------
# phase 1b: the flash backward kernel vs its plain twin
# ---------------------------------------------------------------------------

# A bf16 gradient is right to two roundings of its row's magnitude
# (2^-6 of the plain row's largest entry, plus 1e-5): one for the bf16
# rounding of the output, as in phase 1; one for the bf16 roundings of P
# and dS inside the sums. Kernel and twin compute P and dS in float32 in
# other orders, so some of them round to neighbouring bf16 values; each
# such flip moves a term by 2^-8 of itself, and the sum of the few flips
# along a row is far below one ulp of the row's largest entry. A fault
# (a wrong mask, scale or statistic) moves gradients by their own size.
BF16_BWD_ROW_RTOL = 2.0 ** -6
BF16_BWD_TOL = f"|err| <= 2^-6 * max|plain row| + {BF16_ATOL}"
F32_BWD_TOL = "|err| <= 1e-5 + 1e-5 * |plain|"


def f32_rel_err(got, want) -> float:
    """Worst |got - want| in units of 1e-5 + 1e-5 |want|; right when
    <= 1."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (1e-5 + 1e-5 * w.abs())).max())


def phase_backward_kernel(torch, dev):
    """The backward kernel against its twin at the training shape and at
    small odd float32 shapes; kernel, twin and SDPA-backward times."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(2)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    def inputs(bh, tq, sk, dh, dtype, causal, qo, ko):
        q, do = rnd((bh, tq, dh), dtype), rnd((bh, tq, dh), dtype)
        k, v = rnd((bh, sk, dh), dtype), rnd((bh, sk, dh), dtype)
        o, m, logl = fa.flash_forward_cuda(q, k, v, dh ** -0.5, causal, qo,
                                           ko)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        return (q, k, v, do, m, logl, delta), o

    # -- the training shape: 16 x 8 heads, T = S = 2048, Dh 64, causal ---
    bh, t, dh = 16 * 8, 2048, 64
    scale = dh ** -0.5
    args, o = inputs(bh, t, t, dh, torch.bfloat16, True, 0, 0)
    q, k, v, do, m, logl, delta = args
    ro, rm, rl = fa.flash_forward_reference(q, k, v, scale, True)
    f_rel = row_rel_err(o, ro)
    f_stats = max(max_err(m, rm), max_err(logl, rl))
    if not (f_rel <= 1.0 and f_stats <= 1e-4):
        fail(f"flash forward bf16 at the training shape: row-relative "
             f"{f_rel} (limit 1), stats {f_stats}")
    f_ms = time_ms(lambda: fa.flash_forward_cuda(q, k, v, scale, True),
                   iters=5)
    f_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *(x.view(16, 8, t, dh) for x in (q, k, v)), is_causal=True,
        scale=scale), iters=5)
    f_det = same_bits(torch, lambda: fa.flash_forward_cuda(q, k, v, scale,
                                                           True),
                      "flash forward at the training shape")
    del ro, rm, rl
    got = fa.flash_backward_cuda(*args, scale, True)
    want = fa.flash_backward_reference(*args, scale, True)
    errs = [max_err(a, b) for a, b in zip(got, want)]
    rels = [row_rel_err(a, b, BF16_BWD_ROW_RTOL)
            for a, b in zip(got, want)]
    if not max(rels) <= 1.0:
        fail(f"flash backward bf16 at the training shape: max err {errs}, "
             f"row-relative {rels} (limit 1 of {BF16_BWD_TOL})")
    del got, want
    b_det = same_bits(torch, lambda: fa.flash_backward_cuda(*args, scale,
                                                            True),
                      "flash backward at the training shape")
    k_ms = time_ms(lambda: fa.flash_backward_cuda(*args, scale, True),
                   iters=5)
    p_ms = time_ms(lambda: fa.flash_backward_reference(*args, scale, True),
                   iters=3, warmup=1)
    q4, k4, v4 = (x.view(16, 8, t, dh).detach().requires_grad_()
                  for x in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(16, 8, t, dh)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), iters=5)
    pairs = bh * (t * (t + 1) // 2)
    # the function's inputs q, k, v, dO (bf16) and m, log l, delta (f32)
    # read once, dq, dk, dv written once; five products over the causal
    # half of the score matrix
    nbytes = 7 * bh * t * dh * 2 + 3 * bh * t * 4
    b_ms, b_by = bound(nbytes, 10 * dh * pairs, "bfloat16")
    fb_ms, fb_by = bound(4 * bh * t * dh * 2 + 2 * bh * t * 4,
                         4 * dh * pairs, "bfloat16")
    line(dict(phase="1b", kernel="flash_fwd", dtype="bfloat16",
              causal=True, shape=[bh, t, dh], row_rel_err=f_rel,
              tol=BF16_TOL, stats_err=f_stats, stats_tol=1e-4,
              kernel_ms=f_ms, library_ms=f_lib_ms, bound_ms=fb_ms,
              bound_by=fb_by, deterministic=f_det))
    rec = dict(phase="1b", kernel="flash_bwd", dtype="bfloat16",
               causal=True, shape=[bh, t, dh], max_abs_err=max(errs),
               max_abs_err_dq_dk_dv=errs, row_rel_err_dq_dk_dv=rels,
               tol=BF16_BWD_TOL, kernel_ms=k_ms, plain_ms=p_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               deterministic=b_det)
    line(rec)
    del args, o, q, k, v, do, m, logl, delta, q4, k4, v4, out4, do4

    # -- small odd float32 shapes ----------------------------------------
    for causal, tq, sk, qo, ko in ((True, 100, 100, 0, 0),
                                   (True, 64, 96, 0, 32),
                                   (True, 77, 200, 123, 0),
                                   (False, 77, 150, 0, 0)):
        args, _ = inputs(6, tq, sk, dh, torch.float32, causal, qo, ko)
        got = fa.flash_backward_cuda(*args, scale, causal, qo, ko)
        want = fa.flash_backward_reference(*args, scale, causal, qo, ko)
        rel = max(f32_rel_err(a, b) for a, b in zip(got, want))
        line(dict(phase="1b", kernel="flash_bwd", dtype="float32",
                  causal=causal, shape=[6, tq, sk, dh], q_offset=qo,
                  kv_offset=ko, max_abs_err=max(
                      max_err(a, b) for a, b in zip(got, want)),
                  rel_err=rel, tol=F32_BWD_TOL))
        if not rel <= 1.0:
            fail(f"flash backward f32 {tq}x{sk} offsets {qo},{ko} causal "
                 f"{causal}: {rel} x its limit")
    half_odd_shape_gates(torch, dev, "1b", "flash_bwd", (32, 64, 128), 11)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 1d: the packed two-head backward vs its plain twin and production
# ---------------------------------------------------------------------------

def phase_packed_backward_kernel(torch, dev):
    """The head-packing experiment's kernel (flash_bwd_packed2.cu) at the
    experiment's shape (16 x 8 heads, T = S = 2048, Dh 64, bf16, causal,
    q-chunked at 512: 4 launches, chunks at q_offset 0, 512, 1024, 1536)
    against its chunked twin and against the production backward kernel
    on the same inputs, both per row to 2^-6 (phase 1b's limit); then at
    small odd float32 shapes to 1e-5 + 1e-5 |plain|. Times one q512 call
    (the kernel: replays of a CUDA graph of 3 calls, as phase 6 times
    it), the chunked twin and the SDPA backward (library; these two by
    `time_ms`, their calls tens of ms and one ms long)."""
    from deeplearning4j_tpu_torch.benchmarks import _timing
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(7)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g).to(dev, dtype)

    def inputs(bh, tq, sk, dh, dtype, causal, qo, ko):
        q, do = rnd((bh, tq, dh), dtype), rnd((bh, tq, dh), dtype)
        k, v = rnd((bh, sk, dh), dtype), rnd((bh, sk, dh), dtype)
        o, m, logl = fa.flash_forward_cuda(q, k, v, dh ** -0.5, causal, qo,
                                           ko)
        return q, k, v, do, m, logl, (do.float() * o.float()).sum(
            -1, keepdim=True)

    bh, t, dh = 16 * 8, 2048, 64
    scale = dh ** -0.5
    args = inputs(bh, t, t, dh, torch.bfloat16, True, 0, 0)
    before = fa.packed2_backward_cuda.launches
    got = fa.packed2_backward(*args, scale, True)
    n_launch = fa.packed2_backward_cuda.launches - before
    twin = fa.q_chunked(fa.packed2_backward_reference, *args, scale, True)
    prod = fa.flash_backward_cuda(*args, scale, True)
    errs = [max_err(a, b) for a, b in zip(got, twin)]
    rels = [row_rel_err(a, b, BF16_BWD_ROW_RTOL) for a, b in zip(got, twin)]
    rels_prod = [row_rel_err(a, b, BF16_BWD_ROW_RTOL)
                 for a, b in zip(got, prod)]
    if n_launch != t // fa.PACKED2_Q_CHUNK:
        fail(f"packed backward: {n_launch} launches for one q512 call")
    if not (max(rels) <= 1.0 and max(rels_prod) <= 1.0):
        fail(f"packed backward bf16 at the experiment's shape: max err "
             f"{errs}, row-relative vs twin {rels}, vs the production "
             f"kernel {rels_prod} (limit 1 of {BF16_BWD_TOL})")
    del got, twin, prod
    det = same_bits(torch, lambda: fa.packed2_backward(*args, scale, True),
                    "packed backward at the experiment's shape")
    k_ms = _timing.time_ms(lambda: fa.packed2_backward(*args, scale, True),
                           dev, 3, 2)
    p_ms = time_ms(lambda: fa.q_chunked(fa.packed2_backward_reference,
                                        *args, scale, True),
                   iters=2, warmup=1)
    q, k, v, do = args[:4]
    q4, k4, v4 = (x.view(16, 8, t, dh).detach().requires_grad_()
                  for x in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(16, 8, t, dh)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), iters=5)
    # the function is phase 1b's (one whole backward): its inputs read
    # once and dq, dk, dv written once; five products over the causal half
    pairs = bh * (t * (t + 1) // 2)
    nbytes = 7 * bh * t * dh * 2 + 3 * bh * t * 4
    b_ms, b_by = bound(nbytes, 10 * dh * pairs, "bfloat16")
    rec = dict(phase="1d", kernel="flash_bwd_packed2", dtype="bfloat16",
               causal=True, shape=[bh, t, dh], q_chunk=fa.PACKED2_Q_CHUNK,
               launches_per_call=n_launch, max_abs_err=max(errs),
               max_abs_err_dq_dk_dv=errs, row_rel_err_dq_dk_dv=rels,
               row_rel_err_vs_flash_bwd=rels_prod, tol=BF16_BWD_TOL,
               kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by, deterministic=det)
    line(rec)
    del args, q, k, v, do, q4, k4, v4, out4, do4

    for causal, tq, sk, qo, ko in ((True, 100, 100, 0, 0),
                                   (True, 64, 96, 0, 32),
                                   (True, 77, 200, 123, 0),
                                   (False, 77, 150, 0, 0)):
        args = inputs(6, tq, sk, dh, torch.float32, causal, qo, ko)
        got = fa.packed2_backward_cuda(*args, scale, causal, qo, ko)
        want = fa.packed2_backward_reference(*args, scale, causal, qo, ko)
        rel = max(f32_rel_err(a, b) for a, b in zip(got, want))
        line(dict(phase="1d", kernel="flash_bwd_packed2", dtype="float32",
                  causal=causal, shape=[6, tq, sk, dh], q_offset=qo,
                  kv_offset=ko, max_abs_err=max(
                      max_err(a, b) for a, b in zip(got, want)),
                  rel_err=rel, tol=F32_BWD_TOL))
        if not rel <= 1.0:
            fail(f"packed backward f32 {tq}x{sk} offsets {qo},{ko} causal "
                 f"{causal}: {rel} x its limit")
    half_odd_shape_gates(torch, dev, "1d", "flash_bwd_packed2", (32, 64), 12)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 1e: the decode sweep kernel at every geometry vs its plain twin
# ---------------------------------------------------------------------------

def phase_decode_sweep_kernel(torch, dev):
    """The decode sweep (decode_sweep.cu, and the production kernel at its
    own geometry) at the sweep's shape (B=64, H=8, Dh=64, S=2048, layer 1
    of a stacked L=2 cache) for every (bs, warps) of the grid, at scalar
    pos 100 and 2000 and a vector pos holding 0 and 2047: bf16 per row to
    2^-7 and float32 to 1e-5 against the twin at the same bs. At the
    production geometry the dispatcher's result, and the sweep kernel's
    own (forced there), must be torch.equal to decode_attention_cuda.
    Prints ms and bound per bf16 point; the summary keeps bs 256, 4 warps,
    pos 2000. Every time here is a call of microseconds, so each is read
    from replays of a CUDA graph of the calls (`_timing.time_ms`): device
    time, without the wrappers' host time."""
    from deeplearning4j_tpu_torch.benchmarks import _timing
    from deeplearning4j_tpu_torch.benchmarks.decode_kernel_sweep import \
        SWEEP_BS
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(8)
    B, S, D, H = 64, 2048, 512, 8
    Dh = D // H
    pos_v = torch.from_numpy(np.random.default_rng(8).integers(
        0, S, size=B).astype(np.int32))
    pos_v[0], pos_v[1] = 0, S - 1
    pos_v = pos_v.to(dev)
    rec = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        ck = torch.randn((2, B, S, D), generator=g).to(dev, dtype)
        cv = torch.randn((2, B, S, D), generator=g).to(dev, dtype)
        qd = torch.randn((B, H, Dh), generator=g).to(dev, dtype)
        esz = ck.element_size()
        for pos in (100, 2000, pos_v):
            pname = pos if isinstance(pos, int) else "vector [0..2047]"
            prod = fd.decode_attention_cuda(qd, ck, cv, pos, H, layer=1)
            own = fd.decode_sweep_cuda(qd, ck, cv, pos, H, S, 4, layer=1)
            if not torch.equal(own, prod):
                fail(f"decode sweep kernel at the production geometry "
                     f"({name}, pos {pname}) differs from decode_attention "
                     f"by {max_err(own, prod)}")
            rows = int((torch.as_tensor(pos).clamp(0, S - 1).long() + 1)
                       .expand(B).sum())
            nbytes = 2 * rows * D * esz + 2 * B * D * esz
            b_ms, b_by = bound(nbytes, 4 * rows * D, name)
            for bs in SWEEP_BS:
                for warps in fd.SWEEP_WARPS:
                    got = fd.decode_sweep(qd, ck, cv, pos, H, bs, warps,
                                          layer=1)
                    want = fd.reference_split_decode_attention(
                        qd, ck[1], cv[1], pos, H, bs)
                    err = max_err(got, want)
                    prod_point = fd.is_production_geometry(bs, warps, S)
                    if prod_point and not torch.equal(got, prod):
                        fail("decode sweep production point is not the "
                             "production kernel")
                    if dtype == torch.float32:
                        ok, rel, tol = err <= 1e-5, None, 1e-5
                    else:
                        rel = row_rel_err(got, want)
                        ok, tol = rel <= 1.0, BF16_TOL
                    if not ok:
                        fail(f"decode sweep {name} bs={bs} warps={warps} "
                             f"pos {pname}: max err {err}, row-relative "
                             f"{rel}")
                    r = dict(phase="1e", kernel="decode_sweep", dtype=name,
                             shape=[2, B, S, D], layer=1, pos=pname, bs=bs,
                             warps=warps, production=prod_point,
                             max_abs_err=err, row_rel_err=rel, tol=tol)
                    if dtype == torch.bfloat16:
                        r.update(kernel_ms=_timing.time_ms(
                            lambda: fd.decode_sweep(qd, ck, cv, pos, H, bs,
                                                    warps, layer=1),
                            dev, 20, 3), bound_ms=b_ms, bound_by=b_by)
                    if dtype == torch.bfloat16 and pname == 2000 and \
                            bs == 256 and warps == 4:
                        # the summary point: its plain twin, and SDPA
                        # over the filled rows 0..pos of the same plane
                        kl = ck[1].view(B, S, H, Dh).transpose(1, 2)
                        vl = cv[1].view(B, S, H, Dh).transpose(1, 2)
                        ql = qd.view(B, H, 1, Dh)
                        r.update(
                            plain_ms=_timing.time_ms(
                                lambda: fd.reference_split_decode_attention(
                                    qd, ck[1], cv[1], pos, H, bs), dev, 5,
                                3),
                            library_ms=_timing.time_ms(
                                lambda: F.scaled_dot_product_attention(
                                    ql, kl[:, :, :pos + 1],
                                    vl[:, :, :pos + 1]), dev, 20, 3))
                        rec = r
                    line(r)
        del ck, cv
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 6: the two kernel experiments at full shape
# ---------------------------------------------------------------------------

def phase_experiments(torch, dev):
    """The experiments' main() as a user runs them: the head-packing
    experiment (three arms at bh 128, T 2048, Dh 64, bf16; 10 calls x 3
    timings each), the copy-bandwidth probe and the decode sweep (20
    points). Launch counters are reset before and read after: the packed
    kernel must launch 4 times per q512 call, the sweep kernel at every
    non-production geometry and the production kernel at its own. The
    sweep's bounds stay on the data-sheet 3.35 TB/s; the bound at the
    measured copy rate is printed beside each."""
    from deeplearning4j_tpu_torch.benchmarks import (decode_kernel_sweep,
                                                     headpack_experiment)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd

    fa.packed2_backward_cuda.launches = 0
    head = headpack_experiment.main([])
    n_packed = fa.packed2_backward_cuda.launches
    if n_packed != 4 * head["packed2_q512_calls"] or not n_packed:
        fail(f"headpack experiment: {n_packed} packed launches for "
             f"{head['packed2_q512_calls']} q512 calls")

    probe = decode_kernel_sweep.main(["--bandwidth"])
    fd.decode_sweep_cuda.launches = 0
    fd.decode_attention_cuda.launches = 0
    points = decode_kernel_sweep.main([])
    n_sweep = fd.decode_sweep_cuda.launches
    measured = probe["gb_per_s"] * 1e9
    for p in points:
        n = p["launches"]
        ok = (n["decode_attention"] >= 1 and not n["decode_sweep"]) \
            if p["production"] else n["decode_sweep"] >= 1
        if not ok:
            fail(f"decode sweep point bs={p['bs']} warps={p['warps']}: "
                 f"launches {n}")
    line(dict(phase=6, run="decode_sweep_vs_bounds",
              copy_gb_per_s=probe["gb_per_s"],
              datasheet_gb_per_s=PEAK_BYTES_PER_S / 1e9,
              points=[dict(bs=p["bs"], warps=p["warps"], pos=p["pos"],
                           ms=p["ms_per_call"], bound_ms=p["bound_ms"],
                           bound_ms_at_copy_rate=(p["bound_bytes"] / measured
                                                  * 1e3))
                      for p in points]))
    line(dict(phase=6, run="headpack_summary",
              production_ms=head["production_ms"],
              packed2_q512_ms=head["packed2_q512_ms"],
              production_q512_ms=head["production_q512_ms"],
              packed2_launches=n_packed,
              packed2_q512_calls=head["packed2_q512_calls"],
              decode_sweep_launches=n_sweep))
    return {"flash_bwd_packed2": n_packed, "decode_sweep": n_sweep}


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------

def adam_close(got, want, lr: float, steps: int, atol: float):
    """(max |diff|, share of elements beyond atol) of two parameter
    tensors after `steps` Adam steps, or fail. Adam divides each step by
    the gradient's own size, so an element whose gradient lies within
    float32 noise of zero can step with the other sign on the two
    devices (at most 2 * lr a step); every other element agrees to the
    noise times lr / |g|. So all but 1e-3 of the elements must agree
    within atol, and every element within 2 * lr * steps."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    worst, share = float(diff.max()), float((diff > atol).float().mean())
    return worst, share, worst <= 2 * lr * steps and share <= 1e-3


def phase_train_f32_card_vs_cpu(torch, dev):
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from deeplearning4j_tpu_torch.parallel.optim import (init_adam_state,
                                                         tree_leaves)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=256, dtype="float32",
                               remat=True, remat_policy="full")
    lr, steps = 1e-3, 3
    toks = np.random.default_rng(3).integers(0, 256, size=(2, 256))
    tgts = np.roll(toks, -1, axis=1)
    runs = {}
    for name in ("cuda", "cpu"):
        d = dev if name == "cuda" else torch.device("cpu")
        params = tf.init_params(cfg, seed=2, device=d)
        opt = init_adam_state(params)
        step = make_fsdp_train_step(cfg, device=d, learning_rate=lr)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, toks, tgts)
            losses.append(float(loss))
        runs[name] = (losses, tree_leaves(params))
    loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                              runs["cpu"][0]))
    checks = [adam_close(a, b, lr, steps, 1e-4)
              for a, b in zip(runs["cuda"][1], runs["cpu"][1])]
    line(dict(phase="4a", layers=2, d_model=512, batch=2, seq=256,
              steps=steps, losses_cuda=runs["cuda"][0],
              losses_cpu=runs["cpu"][0], loss_max_abs_err=loss_err,
              loss_tol=1e-4, param_max_abs_err=max(c[0] for c in checks),
              param_share_beyond_tol=max(c[1] for c in checks),
              param_tol="all but 1e-3 of each leaf within 1e-4, every "
                        "element within 2 * lr * steps"))
    if not loss_err <= 1e-4:
        fail(f"float32 training losses differ card vs CPU by {loss_err}")
    if not all(c[2] for c in checks):
        fail(f"float32 training params differ card vs CPU: {checks}")


def phase_train_full_width(torch, dev, timed_steps: int = 5):
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from deeplearning4j_tpu_torch.parallel.optim import init_adam_state
    # benchmarks/flagship.py:70-80, the transformer_lm_12L512d_T2048 row
    B, T, L, D, H, V = 16, 2048, 12, 512, 8, 256
    cfg = tf.TransformerConfig(vocab_size=V, d_model=D, n_heads=H,
                               n_layers=L, max_len=T, dtype="bfloat16",
                               remat=True, remat_policy="full")
    params = tf.init_params(cfg, seed=0, device=dev)
    opt = init_adam_state(params)
    step = make_fsdp_train_step(cfg, device=dev, learning_rate=1e-3)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, (B, T))).to(dev)
    tgts = torch.roll(toks, -1, dims=1)
    _, _, warm_loss = step(params, opt, toks, tgts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_forward_cuda.launches = 0
    fa.flash_backward_cuda.launches = 0
    fd.decode_attention_cuda.launches = 0
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        _, _, loss = step(params, opt, toks, tgts)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_fwd, n_bwd, n_dec = (fa.flash_forward_cuda.launches,
                           fa.flash_backward_cuda.launches,
                           fd.decode_attention_cuda.launches)
    losses = [float(x) for x in losses]
    ms = wall / timed_steps * 1e3
    tok_s = B * T * timed_steps / wall
    # benchmarks/flagship.py:109-113: train = 3x forward, causal attention
    p_mat = L * 12 * D * D + D * V
    flops_tok = 3 * (2 * p_mat + 2 * L * T * D)
    rec = dict(phase="4b", config="transformer_lm_12L512d_T2048",
               batch=B, seq=T, remat="full", timed_steps=timed_steps,
               ms_per_step=ms, tokens_per_s=tok_s,
               model_flops_per_token=flops_tok,
               bf16_peak_share=tok_s * flops_tok / PEAK_FLOPS["bfloat16"],
               warm_loss=float(warm_loss), losses=losses,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               flash_fwd_launches=n_fwd, flash_bwd_launches=n_bwd,
               decode_launches=n_dec,
               flash_fwd_per_step=n_fwd / timed_steps,
               flash_bwd_per_step=n_bwd / timed_steps)
    line(rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training losses {losses}: not finite or not falling")
    if n_fwd != 2 * L * timed_steps or n_bwd != L * timed_steps or n_dec:
        fail(f"train launch counts flash_fwd={n_fwd} flash_bwd={n_bwd} "
             f"decode={n_dec} over {timed_steps} steps, L={L}")
    wall, rows = profiled(torch, lambda: step(params, opt, toks, tgts))
    profile_line(wall, rows, phase="4b", run="profiled_train_step")
    del params, opt
    torch.cuda.empty_cache()
    return {"flash_fwd": n_fwd, "flash_bwd": n_bwd}


# ---------------------------------------------------------------------------
# phase 5: the GravesLSTM char-RNN through MultiLayerNetwork
# ---------------------------------------------------------------------------

# Kernel and twin cast the same inputs to float32 at the same points
# (xw, carries, RW, bias and peepholes) and differ only in the order in
# which the recurrent product h.RW is summed, so bf16 inputs are held like
# float32 ones: |err| <= 1e-5 + 1e-5 |plain| on hs, cs and gates.
LSTM_TOL = "|err| <= 1e-5 + 1e-5 * |plain| (hs, cs, gates; f32 and bf16)"
# BASELINE config 3 (benchmarks/flagship.py:176-214 bench_lstm)
CHAR_V, CHAR_H, CHAR_B, CHAR_T = 80, 200, 1024, 64


def lstm_flops_per_char(v=CHAR_V, h=CHAR_H):
    """benchmarks/flagship.py:214: model FLOPs per character of a train
    step (3x the forward's matmuls) of the 2-layer char-RNN."""
    return 3 * (8 * h * (v + h) + 8 * h * (h + h) + 2 * h * v)


def lstm_bound(t, b, h, x_esz, w_esz):
    """Least time of one lstm_scan: bytes (xw, h0, c0, RW, b, peepholes
    read once; hs, cs and gates written once, float32) and the f32
    operations of the recurrent product, 2*B*H*4H*T, at the CUDA cores'
    67 TF/s (the TPU kernel forms it in f32)."""
    nbytes = (t * b * 4 * h * x_esz + 2 * b * h * x_esz + 4 * h * h * w_esz
              + 7 * h * w_esz + 2 * t * b * h * 4 + t * b * 4 * h * 4)
    return bound(nbytes, 2 * b * h * 4 * h * t, "float32") + (nbytes,)


def phase_lstm_kernel(torch, dev):
    """5a. The lstm_scan kernel vs its plain twin on the card: the
    char-RNN's full-width shapes (B=1024, T=64, H=200; layer 1's xw from a
    one-hot V=80 input, layer 2's from an H=200 one) in bf16 and f32, the
    reversed sequence, small odd f32 shapes and B=1, T=1, every case with
    non-zero peepholes. Times the kernel, the twin and torch.nn.LSTM
    (cuDNN where it takes the dtype; zero peepholes, x.W inside)."""
    from deeplearning4j_tpu_torch.ops import lstm as tl

    g = torch.Generator(device="cpu").manual_seed(7)

    def rnd(shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    def case(t, b, h, f, dtype, layer, reverse=False, timed=False):
        if layer == 1:                       # one-hot characters
            ids = torch.randint(0, f, (b, t), generator=g)
            x = torch.nn.functional.one_hot(ids, f).float()
        else:                                # a layer-1 output
            x = torch.tanh(rnd((b, t, f)))
        w = rnd((f, 4 * h), (2.0 / (f + h)) ** 0.5)
        rw = rnd((h, 4 * h), (1.0 / h) ** 0.5)
        bias = rnd((4 * h,), 0.3)
        peep = [rnd((h,), 0.3) for _ in range(3)]
        x, w, rw, bias = (a.to(dev, dtype) for a in (x, w, rw, bias))
        peep = [p.to(dev, dtype) for p in peep]
        h0, c0 = (rnd((b, h), 0.5).to(dev, dtype) for _ in range(2))
        xw_t = torch.matmul(x, w).transpose(0, 1)
        if reverse:
            xw_t = xw_t.flip(0)
        xw_t = xw_t.contiguous()
        args = (xw_t, h0, c0, rw, bias, *peep)
        got = tl.lstm_scan_cuda(*args)
        want = tl.lstm_scan_reference(*args)
        rel = max(f32_rel_err(a, b) for a, b in zip(got, want))
        err = max(max_err(a, b) for a, b in zip(got, want))
        name = str(dtype).split(".")[-1]
        rec = dict(phase="5a", kernel="lstm_scan", dtype=name,
                   shape=dict(T=t, B=b, H=h, F=f), layer=layer,
                   reverse=reverse, peepholes="random, std 0.3",
                   max_abs_err=err, rel_err=rel, tol=LSTM_TOL)
        if not rel <= 1.0:
            line(rec)
            fail(f"lstm_scan {name} T={t} B={b} H={h} layer {layer} "
                 f"reverse={reverse}: {rel} x its limit (max err {err})")
        if timed:
            esz = x.element_size()
            b_ms, b_by, nbytes = lstm_bound(t, b, h, esz, esz)
            k_ms = time_ms(lambda: tl.lstm_scan_cuda(*args))
            p_ms = time_ms(lambda: tl.lstm_scan_reference(*args), iters=3)
            xw_ms = time_ms(lambda: torch.matmul(x, w))
            lstm = torch.nn.LSTM(f, h).to(dev, dtype)
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(w.t())
                lstm.weight_hh_l0.copy_(rw.t())
                lstm.bias_ih_l0.copy_(bias)
                lstm.bias_hh_l0.zero_()
            x_t = x.transpose(0, 1).contiguous()
            hc = (h0[None], c0[None])
            with torch.no_grad():
                lib_ms = time_ms(lambda: lstm(x_t, hc))
            rec.update(kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                       library="torch.nn.LSTM (x.W inside, no reserve, "
                               "zero peepholes)",
                       library_cudnn=bool(torch.backends.cudnn.is_acceptable(
                           x_t)),
                       xw_matmul_ms=xw_ms,
                       library_minus_xw_ms=lib_ms - xw_ms,
                       bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                       bound_flops=2 * b * h * 4 * h * t)
        line(rec)
        return rec

    full = CHAR_T, CHAR_B, CHAR_H
    summary = None
    for dtype in (torch.bfloat16, torch.float32):
        for layer, f in ((1, CHAR_V), (2, CHAR_H)):
            r = case(*full, f, dtype, layer, timed=(layer == 1))
            if dtype == torch.bfloat16 and layer == 1:
                summary = r
    case(*full, CHAR_V, torch.float32, 1, reverse=True)
    case(*full, CHAR_H, torch.bfloat16, 2, reverse=True)
    case(7, 5, 37, 11, torch.float32, 2)
    case(7, 5, 37, 11, torch.float32, 1, reverse=True)
    case(1, 1, CHAR_H, CHAR_V, torch.float32, 1)
    case(1, 1, CHAR_H, CHAR_V, torch.bfloat16, 1)
    torch.cuda.empty_cache()
    return summary


def rmsprop_close(got, want, lr, decay, steps, atol):
    """(max |diff|, share beyond atol, ok) of two parameter tensors after
    `steps` RMSProp steps. A step moves an element by at most
    lr / sqrt(1 - decay) (|g| / sqrt((1 - decay) g^2)), whatever its
    gradient, and by lr * delta / sqrt(h + eps) for float32 noise delta in
    g, which is large only where the gradient's mean square h is near 0.
    So all but 1e-3 of the elements must agree within atol, and every
    element within 2 * steps * lr / sqrt(1 - decay)."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    worst, share = float(diff.max()), float((diff > atol).float().mean())
    cap = 2 * steps * lr / (1 - decay) ** 0.5
    return worst, share, worst <= cap and share <= 1e-3


def phase_lstm_f32_card_vs_cpu(torch, dev):
    """5b. The char-RNN at full width (V=80, H=200, 2 layers) in float32,
    B=32, T=64, TBPTT 32 (carries cross a chunk boundary), lstm_wavefront
    off: one set of weights on the card and on the CPU, three fit calls
    (scores within 1e-4, parameters by rmsprop_close), then 32
    rnn_time_step outputs within 1e-4. lr 0.01: at the configuration's
    0.1 this net's float32 training is chaotic (tests/
    test_torch_multilayer.py), so the comparison would measure the chaos,
    not the kernel."""
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lstm as tl
    b, t, lr = 32, 64, 0.01
    nets = {}
    for name in ("cpu", "cuda"):
        d = torch.device("cpu") if name == "cpu" else dev
        nets[name] = MultiLayerNetwork(char_rnn_lstm(
            CHAR_V, hidden=CHAR_H, layers=2, tbptt_length=32,
            learning_rate=lr), device=d)
        nets[name].lstm_wavefront = False
    nets["cpu"].init()
    nets["cuda"].set_params_from_numpy(
        {k: {n: p.numpy() for n, p in v.items()}
         for k, v in nets["cpu"].params.items()})
    rng = np.random.default_rng(8)
    eye = np.eye(CHAR_V, dtype=np.float32)
    scores = {"cpu": [], "cuda": []}
    tl.lstm_scan_cuda.launches = 0
    for s in range(3):
        ids = rng.integers(0, CHAR_V, (b, t))
        x, y = eye[ids], eye[np.roll(ids, -1, axis=1)]
        for name, net in nets.items():
            net.fit(x, y)
            scores[name].append(float(net.score_value))
    fit_launches = tl.lstm_scan_cuda.launches
    s_err = max(abs(a - c) for a, c in zip(scores["cpu"], scores["cuda"]))
    checks = [rmsprop_close(nets["cuda"].params[k][n],
                            nets["cpu"].params[k][n], lr, 0.95, 6, 1e-4)
              for k in nets["cpu"].params for n in nets["cpu"].params[k]]
    steps = [eye[rng.integers(0, CHAR_V, b)] for _ in range(32)]
    outs = {}
    for name, net in nets.items():
        net.rnn_clear_previous_state()
        outs[name] = [net.rnn_time_step(x).cpu() for x in steps]
    step_launches = tl.lstm_scan_cuda.launches - fit_launches
    o_err = max(max_err(a, c) for a, c in zip(outs["cpu"], outs["cuda"]))
    line(dict(phase="5b", config="char_rnn_lstm V=80 H=200 2 layers f32",
              batch=b, seq=t, tbptt=32, lr=lr, fits=3,
              scores_cuda=scores["cuda"], scores_cpu=scores["cpu"],
              score_max_abs_err=s_err, score_tol=1e-4,
              param_max_abs_err=max(c[0] for c in checks),
              param_share_beyond_atol=max(c[1] for c in checks),
              param_tol="all but 1e-3 of each leaf within 1e-4, every "
                        "element within 2 * steps * lr / sqrt(1 - decay)",
              rnn_time_step_max_abs_err=o_err, rnn_time_step_tol=1e-4,
              lstm_scan_launches_fit=fit_launches,
              lstm_scan_launches_rnn_time_step=step_launches))
    if not s_err <= 1e-4:
        fail(f"float32 char-RNN scores differ card vs CPU by {s_err}")
    if not all(c[2] for c in checks):
        fail(f"float32 char-RNN params differ card vs CPU: {checks}")
    if not o_err <= 1e-4:
        fail(f"float32 rnn_time_step differs card vs CPU by {o_err}")
    if fit_launches != 2 * 3 * 2 or step_launches != 2 * 32:
        fail(f"char-RNN launches: {fit_launches} in 3 fits of 2 chunks, "
             f"{step_launches} in 32 steps (2 layers)")


def phase_lstm_full_width(torch, dev, epochs=3):
    """5c. BASELINE config 3 (char_rnn_lstm V=80, H=200, 2 layers, TBPTT
    64, bf16, RMSProp lr 0.1) at B=1024, T=64: fit_batched over a pool of
    4 seeded minibatches x `epochs` after one warm pass, lstm_wavefront
    off. Then one minibatch under torch.profiler, the same pool with the
    wavefront on, and 200 sampled characters by rnn_time_step at B=1."""
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lstm as tl
    pool = 4
    conf = char_rnn_lstm(vocab_size=CHAR_V, hidden=CHAR_H, layers=2,
                         tbptt_length=CHAR_T, dtype="bfloat16")
    net = MultiLayerNetwork(conf, device=dev).init()
    net.lstm_wavefront = False
    rng = np.random.default_rng(0)               # flagship.py:189-192
    ids = torch.from_numpy(rng.integers(0, CHAR_V, (pool, CHAR_B, CHAR_T)))
    eye = torch.eye(CHAR_V, device=dev)
    ids = ids.to(dev)
    xs, ys = eye[ids], eye[torch.roll(ids, -1, dims=2)]
    warm = net.fit_batched(xs, ys, epochs=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tl.lstm_scan_cuda.launches = 0
    t0 = time.perf_counter()
    scores = net.fit_batched(xs, ys, epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_lstm = tl.lstm_scan_cuda.launches
    steps = pool * epochs
    chars = CHAR_B * CHAR_T * steps
    fpc = lstm_flops_per_char()
    sc = [float(v) for v in scores]
    rec = dict(phase="5c", config="graves_lstm_charrnn_2x200_T64",
               dtype="bfloat16", batch=CHAR_B, seq=CHAR_T, pool=pool,
               epochs=epochs, lstm_wavefront=False, wall_s=wall,
               chars_per_s=chars / wall, ms_per_minibatch=wall / steps * 1e3,
               model_flops_per_char=fpc,
               bf16_peak_share=chars / wall * fpc / PEAK_FLOPS["bfloat16"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               warm_scores=[float(v) for v in warm], scores=sc,
               lstm_scan_launches=n_lstm,
               lstm_scan_per_minibatch=n_lstm / steps)
    line(rec)
    if not (np.all(np.isfinite(sc)) and sc[-1] < sc[0]):
        fail(f"char-RNN scores {sc}: not finite or not falling")
    if n_lstm != 2 * steps:
        fail(f"char-RNN: {n_lstm} lstm_scan launches for {steps} "
             "minibatches of 2 layers")
    wall_p, rows = profiled(torch, lambda: net.fit_batched(xs[:1], ys[:1]))
    profile_line(wall_p, rows, phase="5c", run="profiled_minibatch")

    net.lstm_wavefront = True
    net.fit_batched(xs, ys, epochs=1)
    torch.cuda.synchronize()
    tl.lstm_scan_cuda.launches = 0
    t0 = time.perf_counter()
    wscores = net.fit_batched(xs, ys, epochs=epochs)
    torch.cuda.synchronize()
    wwall = time.perf_counter() - t0
    line(dict(phase="5c", run="wavefront_arm", lstm_wavefront=True,
              wall_s=wwall, chars_per_s=chars / wwall,
              ms_per_minibatch=wwall / steps * 1e3,
              scores=[float(v) for v in wscores],
              lstm_scan_launches=tl.lstm_scan_cuda.launches))
    if tl.lstm_scan_cuda.launches:
        fail("the wavefront arm launched the lstm_scan kernel")

    net.lstm_wavefront = False
    net.rnn_clear_previous_state()
    tl.lstm_scan_cuda.launches = 0
    srng = np.random.default_rng(1)
    cur, text = int(ids[0, 0, 0]), []
    t0 = time.perf_counter()
    for _ in range(200):
        probs = net.rnn_time_step(eye[cur][None])[0].float().cpu().numpy()
        if probs.shape != (CHAR_V,) or not np.all(np.isfinite(probs)):
            fail(f"rnn_time_step gave {probs.shape} / non-finite values")
        cur = int(srng.choice(CHAR_V, p=probs / probs.sum()))
        text.append(cur)
    swall = time.perf_counter() - t0
    n_sample = tl.lstm_scan_cuda.launches
    line(dict(phase="5c", run="sample", chars=len(text), batch=1,
              wall_s=swall, ms_per_char=swall / len(text) * 1e3,
              first_ids=text[:16], lstm_scan_launches=n_sample))
    if n_sample != 2 * len(text):
        fail(f"sampling launched lstm_scan {n_sample} times for "
             f"{len(text)} steps of 2 layers")
    del net, xs, ys
    torch.cuda.empty_cache()
    return {"lstm_scan": n_lstm + n_sample}


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "deeplearning4j_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(deeplearning4j_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    print(card, flush=True)

    import deeplearning4j_tpu_torch  # noqa: F401  (sets allow_tf32=False)
    from deeplearning4j_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    line(dict(phase=0, build_s=time.perf_counter() - t0,
              torch=torch.__version__, cuda=torch.version.cuda))
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_packed2"):
        build_report(name)

    measured = phase_kernels(torch, dev)
    measured["flash_bwd"] = phase_backward_kernel(torch, dev)
    measured["decode_window"] = phase_window_kernel(torch, dev)
    measured["flash_bwd_packed2"] = phase_packed_backward_kernel(torch, dev)
    measured["decode_sweep"] = phase_decode_sweep_kernel(torch, dev)
    phase_f32_card_vs_cpu(torch, dev)
    phase_spec_f32_card_vs_cpu(torch, dev)
    measured["lstm_scan"] = phase_lstm_kernel(torch, dev)
    launches = phase_full_width(torch, dev)
    for name, n in phase_spec_full_width(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    phase_train_f32_card_vs_cpu(torch, dev)
    for name, n in phase_train_full_width(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    phase_lstm_f32_card_vs_cpu(torch, dev)
    launches.update(phase_lstm_full_width(torch, dev))
    launches.update(phase_experiments(torch, dev))

    sources = {
        "flash_fwd": ("deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                      "deeplearning4j_tpu/ops/flash_attention.py:138"),
        "flash_bwd": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                      "deeplearning4j_tpu/ops/flash_attention.py:202"),
        "decode_attention": (
            "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
            "deeplearning4j_tpu/ops/flash_decode.py:187"),
        "decode_window": ("deeplearning4j_tpu_torch/csrc/decode_window.cu",
                          "deeplearning4j_tpu/ops/flash_decode.py:395"),
        "lstm_scan": ("deeplearning4j_tpu_torch/csrc/lstm_scan.cu",
                      "deeplearning4j_tpu/ops/lstm.py:43"),
        "flash_bwd_packed2": (
            "deeplearning4j_tpu_torch/csrc/flash_bwd_packed2.cu",
            "benchmarks/headpack_experiment.py:62"),
        "decode_sweep": ("deeplearning4j_tpu_torch/csrc/decode_sweep.cu",
                         "benchmarks/decode_kernel_sweep.py:84"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        r = measured[name]
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the main path")
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    print(card, flush=True)
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (plain, speculative, paged with the
prefix cache, chunked prefill, grammar-constrained, mixture of experts),
its train step (dense and MoE), the GravesLSTM char-RNN's
training through MultiLayerNetwork and the two kernel experiments on the
card and fails (non-zero exit, no result line) if anything is wrong:

0. Build: every csrc/*.cu at once; then one line per tensor-core
   library (flash_fwd, flash_bwd, flash_bwd_packed2, decode_attention,
   decode_window, lstm_scan) with each kernel instance's ptxas
   registers, stack and spills and its HMMA count in the SASS
   (cuobjdump); fails if a bf16 tensor-core instance has no HMMA, or a
   half-precision Dh-64 instance (the main path's), a bf16
   lstm_scan_tc_kernel instance or a Dh-64 quantized-cache decode /
   window instance (`*_q_kernel`, the main path's) spills.
1. Kernel vs plain, on the card: the flash-forward kernel at the main
   path's bf16 prefill shapes (64 slots x 8 heads, Dh=64, causal, T=1024
   as the engine's bucket in phase 3, T=64 as generate's prompt, T=512)
   plus small odd float32 shapes, and the decode kernel at the serving
   decode shape (B=64, S=2048, D=512, H=8, stacked cache; float32 with
   L=2 at a vector pos; bf16 with L=12, layer 5, at three points: the
   engine's mixed prefixes (a vector pos with 0 and 2047), a full cache
   (pos 2047) and a short one (pos 100), each held to the plain twin and
   to the chunked twin of the split-S core, with its SDPA yardstick and,
   beside the event timings, the device time of CUDA-graph replays, also
   of the SIMT row loop that served bf16 decode before).
   bf16 results are held per row to 2^-7 of the
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
   (bs=2048, 4 warps) must be decode_attention_cuda's result, and the
   sweep kernel forced there must be torch.equal to it in float32 (the
   same SIMT loop) and, in bf16, where production is the tensor-core
   split-S core, within 2^-7 per row of it and of its own twin. ms and
   bound per bf16 point.
1q. The quantized entries of the decode and window kernels (int8 and
   e4m3 caches with float32 row scales, decode_core.cuh's row loop) vs
   their scaled plain twins at the serving decode shape (B=64, S=2048,
   D=512, H=8, Dh 64, the stacked L=12 cache and [L, B, S, 1] scales at
   layer 5): bf16 and float32 q at phase 1's vector, pos 2047 and pos
   100 (bf16 rows within 2^-7, float32 within 1e-5, two calls bit-equal);
   the window at T=5 and 8, every row torch.equal to the decode entry at
   pos + t. Kernel, twin and graph-replay times beside the byte bound
   (one byte a cache element plus 8 bytes of scales a row), and SDPA's
   time over the dequantized bf16 cache, a different function that reads
   twice the bytes (no single PyTorch call computes scaled int8
   attention, so the rows' library_ms is null).
2. float32 end to end, card vs CPU: a 2-layer model at the full width
   (512d / 8 heads) serves 8 greedy requests x 16 new tokens through
   `InferenceEngine` on cuda and on cpu; tokens must match exactly and
   the prefill / first-step logits within 1e-3.
2b. float32 speculative decoding on the same model: spec_k 4 with the
   drafters "self" and "layers:1" (greedy), then "layers:1" sampled
   (temperature 0.9, top-k 16); the spec tokens on cuda must equal the
   plain engine's on cuda and the spec engine's on cpu; launches exact
   (as phase 3 counts them).
2c. float32 paged KV on the same model: 12 greedy requests (8 open with
   one 64-token system prompt; 8-192 tokens; 16 new) and then 4 of them
   again (full-prefix hits: copy-on-write) through the paged engine
   (page_size 16, 160 pages, prefix cache) on cuda and on cpu, the
   contiguous engine, prefill_chunk 32 paged and contiguous, and paged
   spec (K=4, "layers:1"); all token-exact against the paged engine on
   cuda, the second wave against the first; prefix hits and copies in
   the second wave; no page leaked (pages in use = the prefix cache's).
2d. float32 quantized serving on phase 2's model and requests: the int8
   engine (quantize and kv_quantize "int8") card ≡ CPU; spec (K=4, the
   default "int8" drafter on the float tree, int8 KV) ≡ plain int8 KV;
   paged int8 (prefix cache off) ≡ contiguous int8; chunked int8 (chunk
   32) ≡ one-shot int8; on the card the quantized kernels run and the
   float decode / window kernels and the plain twins never.
2e. float32 grammar-constrained serving on phase 2's model and prompts
   (the pipelined loop, `serving.constrain` grammars over the byte
   vocabulary): every prompt under ``[ab]{1,5}`` (16 new; terminal at 5),
   under the flagship bench's JSON schema (64 new), the same two with
   spec (K=4, "self"), and a mix of the two, ``[ab]+`` and none on the
   contiguous, paged (page 16, 160 pages) and chunked (32) pools and the
   synchronous loop. Gates: card ≡ CPU on every arm; every committed
   token legal under a host replay of the grammar, a request shorter
   than its budget ends in a terminal state; every schema output parses
   with its keys among the schema's; spec ≡ plain, paged ≡ chunked ≡
   contiguous ≡ the synchronous loop (terminating grammars, float32);
   launches exact.
2f. float32 mixture of experts, card vs CPU: phase 2's model with 4
   experts at capacity 0.5 (every call kind drops tokens) and its 8
   prompts on the contiguous (both loops), paged (prefix cache, the
   prompts twice), chunked (32) and constrained (``[ab]+`` on half)
   engines, and `generate`: the card's greedy tokens equal the CPU's;
   the CPU runs count the dropped share per call kind (`RouteDrops`,
   from the routing itself; some must drop); two Adam steps of phase
   4a's model with these experts, card vs CPU (`adam_close`).
3. Full width: the 12L / 512d / 8H / V=256 / max_len 2048 bf16 engine with
   64 slots and decode_chunk 8 (phases 3-3d on the synchronous loop,
   `pipeline=False`, their per-tick programs replayed as CUDA graphs as
   in every card engine) answers 128 requests (prompt lengths 16..1024
   from seed 0, 64 new tokens), then `TransformerLM.generate` runs B=64,
   prompt 64, 128 new greedy tokens. Every launch counter is reset just
   before each run and read just after. A wrapper counts where it
   launches: the flash kernel n_layers times per prefill call (eager);
   a slot program's kernels at the first call of its (kind, size) key,
   eagerly, and once more at its capture (the decode kernel n_layers x
   chunk each), and every later decode chunk must be a graph replay,
   which calls no wrapper (`expected_launches`, `check_launches`; the
   replays are counted on their own). What a replay runs is read from
   the device's trace: one more engine tick (64 admissions + one decode
   chunk) runs under torch.profiler, must be one prefill and one graph
   replay, and its trace must hold the flash kernel n_layers times and
   the decode kernel n_layers x chunk times (`device_launch_gate`); it
   prints the device time by kernel and the device's idle share.
3b. Full-width speculative decoding: phase 3's config and 128 requests on
   the aligned tree (blocks 1..11 with Wo, W2, b2 zeroed, so the
   "layers:1" drafter agrees with the model), spec_k 7, against the plain
   engine (decode_chunk 8) on the same tree. Every request's tokens must
   equal the plain engine's; launches exact (phase 3's accounting: a
   spec round program n_layers window and K draft decode launches at
   its first call and its capture, every later round a replay); K must
   stay 7. Tokens/s, ms per round and per chunk, acceptance, launches
   and graph replays are printed; a probe compares a batched [Ns*(K+1), D]
   product with decode's per-row [Ns, D] products bitwise; one spec round
   and one plain chunk (8 tokens each, no admissions) run under
   torch.profiler, each one graph replay whose device trace holds the
   ported kernels it must run (the round: the bf16 window and draft
   decode, which share one device function, n_layers + K times).
3c. Full-width paged serving: phase 3's config and slots on the paged pool
   (page_size 16, 3072 pages + the scratch page, prefix cache): 128
   requests of 64 new tokens (96 open with one 512-token system prompt
   and a page-aligned suffix of 16-512 tokens, 32 unshared of 16-1024),
   then 32 of them again; the first wave on the contiguous pool; the
   same 32 cold (prefix cache off); the first wave with prefill_chunk
   256 and the default budget; paged spec (K=7, "layers:1") against
   paged plain on 3b's aligned tree, token-exact. Every request answered
   and well formed; launches exact (phase 3's accounting; flash_fwd
   none on the paged and chunked arms: their prefill is plain
   attention); hits and copies in the second wave; no page leaked.
   Prints each arm's tokens/s, ms per decode step and prefill seconds,
   the first wave's ms per decode step paged and contiguous (and phase
   3's), the cold and prefix-hit prefill seconds, and one profiled paged
   decode chunk (gated on its device trace) with the device time of its
   page gathers.
3d. Full-width quantized serving: phase 3's config and 128 requests, (a)
   int8 weights and KV, (b) fp8 both (e4m3 on the card), (c) spec from
   K=7 at the default adaptive K with the default "int8" drafter on the
   float tree (≡ phase 3's bf16 plain engine; acceptance printed; the
   adaptive K may capture a round program per K it visits), (d)
   spec on the int8 engine, whose drafter shares the tree (≡ (a); every
   draft the budgets allow accepted; K stays 7), (e) the paged int8 pool
   on phase 3c's traffic (hits and copies in the second wave, no page
   leaked). Launches exact (phase 3's accounting, with the quantized
   decode and window entries on a quantized pool; no float decode or
   window launch and no plain-twin call there). Prints tokens/s and ms
   a decode step beside phase 3's, param and pool bytes against the
   bf16 engine's, and one profiled int8 decode chunk and one profiled
   spec round of (d), each gated on its device trace (the quantized
   decode entry n_layers x 8, and n_layers x K beside the quantized
   window's n_layers).
3e. The pipelined tick loop, the engine's default, on the traffic of
   phases 3-3d, beside the synchronous loop run here on the same
   traffic: plain (phase 3; a warm pass per loop, then timed passes
   sync, pipelined, pipelined, sync, each printing tokens/s and ms a
   decode step), spec (3b's tree, K 7, "layers:1"), paged (3c's two
   waves), chunked (3c's chunk-256 arm) and int8 (3d's int8 weights and
   KV); each pass also prints how many requests differ from the earlier
   phase's results. Gates: every arm token-exact against the
   synchronous loop; without spec the same
   calls; at most one blocking wait a pipelined tick; launches exact
   (phase 3's accounting: in a warm pass none, every call a replay); no
   capture in a pass after the warm one; nothing in
   flight and no page leaked after a drain; the paged engine's graph
   pool under L gathered views; a decode-chunk and a spec-round replay
   ≡ the eager program bit for bit. Prints waits a tick, captures,
   replays, graph-pool bytes and one profiled pipelined decode tick
   (idle share, device kernels, host launch calls; gated on its device
   trace).
3f. Full-width grammar-constrained serving, phase 3's config, traffic and
   pipelined loop: (a) unconstrained against ``[ab]+`` (never terminal)
   on every request, a warm pass each, then timed U C C U: tokens/s, ms
   a decode step and C/U beside the reference bench's 0.9 bar (printed,
   not gated); (b) the flagship schema on every request on (a)'s warm
   constrained engine (a new grammar: no capture), every output parsed,
   terminal completions counted; (c) half ``[ab]+``, half none: the
   unconstrained requests ≡ (a)'s unconstrained pass; (d) 3b's aligned
   tree, spec (K 7, "layers:1") ≡ plain, constrained by ``[ab]+`` and by
   the schema, on the synchronous loop; (e) 3c's paged traffic with
   ``[ab]+``, the chunk-256 pool on the first 48 requests of its first
   wave and the int8-KV paged pool on phase 3's, each pipelined ≡ its
   synchronous loop; paged and chunked ≡ the contiguous one-shot engine
   (another prefill path, equal on this traffic); int8 paged against
   int8 contiguous printed (its rows quantize after another prefill
   path's rounding); (f) temperature 0.8, top-k
   40: legal, pipelined ≡ sync; (g) the synchronous loop on (a)'s
   constrained traffic ≡ pipelined, the same calls. Every arm: every
   token legal (the engine's own walk refuses none, the host replay
   agrees), launches exact, no capture in a warm pass, on the int8 pool
   no float kernel and no plain twin. One constrained pipelined decode
   tick and one constrained bf16 spec round are profiled: one graph
   launch each, the unconstrained device launch counts (L x 8 decode, L
   + K), and the mask's own kernels and device ms beside an
   unconstrained tick's; the table's bytes (cap x V x 5).
3f'. The reference bench's constrained floor config
   (benchmarks/flagship.py:1423, constrained_decode_4L192d_Ns8: 4L /
   192d / 8H, 8 slots, max_len 256, 24 requests at 2 ms Poisson
   interarrival, prompts 8-48, 33 new, 64 for the schema): unconstrained,
   ``[ab]+`` and the schema arms replayed in real time, a cold replay
   each and then 3 interleaved warm ones on one engine per arm; its
   in-bench asserts (legal, full budget, schema valid, no capture once
   warm); tokens/s per arm and constrained / unconstrained, printed.
3g. Full-width mixture of experts: phase 3's config with 8 experts at
   capacity 1.25 (`MOE_FLAGSHIP`, Switch-style top-1) beside the dense
   engine on phase 3's traffic, both loops, timed in turns (S P P S);
   3c's paged waves, its chunk-256 arm on 48 requests, the int8 arm,
   each synchronous then pipelined; full-width `generate`; eager passes
   under `RouteDrops` for the dropped share per call kind; a profiled
   decode tick and admission tick of each model. Gates: pipelined ≡
   sync everywhere, the eager engine ≡ the graph one, replay ≡ eager,
   the MoE MLP bit-equal twice, launches exact with no plain attention
   twin and no SDPA (`CountTwins`), no capture once warm, no page
   leaked; paged and chunked against contiguous printed.
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
4c. Phase 4b's flagship train step with 8 experts (N = 32768 tokens a
   call, 5120 places an expert): 5 timed steps, ms a step, tokens/s and
   the bf16-peak share of the active FLOPs (4b's formula plus the
   router's 2 D E a layer); losses finite and falling, 2 x L flash
   forward and L backward launches a step, nothing plain; two forward
   and backward calls of the MoE MLP at this shape bit-equal.
5a. The fused LSTM-scan kernel vs its plain twin: the char-RNN's shapes
   (B=1024, T=64, H=200; xw from layer 1's one-hot V=80 input and from
   layer 2's H=200 input) in bf16 and float32, reversed sequences, B=5,
   T=7, H=37 and B=1, T=1, every case with random peepholes and carries;
   hs, cs and gates within 1e-5 + 1e-5 |plain| (see LSTM_TOL); every
   bf16 full-width case on the tensor-core ("tc") kernel. Times the
   kernel, the twin and torch.nn.LSTM (cuDNN; the yardstick, never
   called by the port; it does x.W too, timed alone beside it); in bf16
   the tc and SIMT kernels in turns on the same inputs (SIMT, TC, TC,
   SIMT), beside the byte bound and the CUDA-core bound of the product.
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
7. Summary: the MoE phases' launches by kernel (`moe_launches`); one
   line of the graph replays of every gated run and of the serving
   device functions' launches in the profiled ticks' traces; the run's
   wall time, the MoE phases' and the rest's (`wall`);
   one `kernels` JSON line (decode_attention_q and decode_window_q among
   them; `launches` the wrappers' counts, `device_launches_profiled`
   the traces' count of the device function the kernel runs), the
   card's name and power limit, then the last line
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


# the tensor-core kernels, whose bf16 instances must run HMMA (the
# decode and window libraries' bf16 / f16 paths are
# decode_rows_tc_kernel; lstm_scan's bf16-RW path lstm_scan_tc_kernel)
TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
              "flash_bwd_dq_tc_kernel", "flash_bwd_packed2_tc_kernel",
              "decode_rows_tc_kernel", "lstm_scan_tc_kernel")


def build_report(name: str):
    """One line for a redesigned library: each kernel instance's ptxas
    registers and spills and its HMMA / HGMMA count in the SASS. Fails if
    a bf16 instance of a tensor-core kernel has no HMMA, or if a
    half-precision Dh-64 instance (the main path's) or a bf16
    lstm_scan_tc_kernel instance or a Dh-64 quantized-cache instance
    spills."""
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
        if "lstm_scan_tc_kernel<__nv_bfloat16" in fn and spills:
            fail(f"{name}: bf16 instance {short} spills ({st})")
        if "_q_kernel<" in fn and dh and dh.group(1) == "64" and spills:
            fail(f"{name}: quantized-cache Dh-64 instance {short} spills "
                 f"({st})")
    if not any("__nv_bfloat16" in r["instance"] and
               any(k in r["instance"] for k in TC_KERNELS) for r in rows):
        fail(f"{name}: no bf16 tensor-core instance in the ptxas report")
    line(dict(phase=0, library=name, instances=rows))


def phase_kernels(torch, dev):
    """Each kernel against its plain twin, on the card, at the shapes the
    main path gives it; times at the engine's shapes for the summary."""
    from deeplearning4j_tpu_torch.benchmarks import _timing
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
    flash_poison_probe(torch, fa, rnd, bh, 1024, dh, scale)

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
    kl = ck[layer].view(B, S, H, Dh).transpose(1, 2)
    vl = cv[layer].view(B, S, H, Dh).transpose(1, 2)
    ql = qd.view(B, H, 1, Dh)
    keys = torch.arange(S, device=dev)
    rec = None
    # the engine's mixed prefixes (the vector), a full cache, a short one
    for pos, pname in ((pos_v, "vector [0..2047]"), (S - 1, S - 1),
                       (100, 100)):
        got = fd.decode_attention_cuda(qd, ck, cv, pos, H, layer=layer)
        want = fd.reference_decode_attention(qd, ck[layer], cv[layer], pos,
                                             H)
        chunked = fd.reference_chunked_decode_attention(qd, ck, cv, pos, H,
                                                        layer=layer)
        err = max_err(got, want)
        rel = max(row_rel_err(got, want), row_rel_err(got, chunked))
        if not rel <= 1.0:
            fail(f"decode pos {pname}: max err {err}, row-relative {rel} "
                 f"(plain and chunked twins)")
        k_ms = time_ms(lambda: fd.decode_attention_cuda(qd, ck, cv, pos, H,
                                                        layer=layer))
        p_ms = time_ms(lambda: fd.reference_decode_attention(
            qd, ck[layer], cv[layer], pos, H), iters=5)
        if isinstance(pos, int):   # SDPA over the filled rows 0..pos
            sdpa = (lambda p=pos: F.scaled_dot_product_attention(
                ql, kl[:, :, :p + 1], vl[:, :, :p + 1]))
        else:                      # SDPA with each slot's prefix mask
            mask = (keys[None, :] <= pos[:, None].long())[:, None, None]
            sdpa = (lambda m=mask: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=m))
        lib_ms = time_ms(sdpa)
        rows = int((torch.as_tensor(pos).clamp(0, S - 1).long() + 1)
                   .expand(B).sum())
        nbytes = 2 * rows * Dh * H * 2 + 2 * B * D * 2 + \
            (0 if isinstance(pos, int) else B * 4)
        b_ms, b_by = bound(nbytes, 4 * rows * D, "bfloat16")
        r = dict(phase=1, kernel="decode_attention", dtype="bfloat16",
                 shape=[L, B, S, D], layer=layer, pos=pname,
                 max_abs_err=err, row_rel_err=rel, tol=BF16_TOL,
                 kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                 bound_ms=b_ms, bound_by=b_by,
                 # device time alone: replays of a CUDA graph of 20 calls
                 kernel_graph_ms=_timing.time_ms(
                     lambda: fd.decode_attention_cuda(qd, ck, cv, pos, H,
                                                      layer=layer),
                     dev, 20, 3),
                 # the SIMT row loop that served bf16 decode before the
                 # split-S core (decode_core.cuh, one CTA of 4 warps a
                 # (b, h)): the sweep kernel at one split, with its merge
                 simt_graph_ms=_timing.time_ms(
                     lambda: fd.decode_sweep_cuda(qd, ck, cv, pos, H, S, 4,
                                                  layer=layer),
                     dev, 20, 3))
        if isinstance(pos, int):
            r.update(library_graph_ms=_timing.time_ms(sdpa, dev, 20, 3))
        line(r)
        if pname == S - 1:
            rec = r
    results["decode_attention"] = rec
    del ck, cv, kl, vl
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 1c: the verify-window kernel vs its plain twin and the decode kernel
# ---------------------------------------------------------------------------

def flash_poison_probe(torch, fa, rnd, bh, t, dh, scale, calls=4):
    """The bf16 flash forward at phase 1's T=1024 point, each call's
    outputs allocated where NaN-filled blocks of their sizes were just
    freed (the caching allocator hands the same blocks back; printed):
    an output element the kernel leaves unwritten then reads NaN on
    every call, where fresh memory would hide it. Gates: every output
    finite, every call bit-equal to the first (ROADMAP queue C: one NaN
    on a first call, PR 11 run 2)."""
    bf = torch.bfloat16
    q3, k3, v3 = (rnd((bh, t, dh), bf) for _ in range(3))
    nan = float("nan")
    first, reused, nonfinite, same = None, [], [], []
    for _ in range(calls):
        bait = [torch.full((bh, t, dh), nan, dtype=bf, device=q3.device),
                torch.full((bh, t, 1), nan, device=q3.device),
                torch.full((bh, t, 1), nan, device=q3.device)]
        ptrs = [b.data_ptr() for b in bait]
        del bait
        out = fa.flash_forward_cuda(q3, k3, v3, scale, True)
        reused.append([x.data_ptr() for x in out] == ptrs)
        nonfinite.append(sum(int((~torch.isfinite(x)).sum()) for x in out))
        if first is None:
            first = [x.clone() for x in out]
        same.append(all(torch.equal(a, b) for a, b in zip(out, first)))
        del out
    line(dict(phase=1, kernel="flash_fwd", run="poisoned_outputs",
              shape=[bh, t, dh], calls=calls, outputs_on_nan_blocks=reused,
              nonfinite=nonfinite, equal_to_first=same))
    if any(nonfinite) or not all(same):
        fail(f"flash forward on NaN-filled output blocks: non-finite "
             f"{nonfinite}, equal to the first call {same}")


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
        zero_launches()
        eng, spec = serve(dev, spec_decode=True, spec_k=4, draft=draft,
                          **samp)
        got = read_launches()
        n_win = got["decode_window"]
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
                  accepted=c["spec_accepted"], window_launches=n_win,
                  graph_replays=c["graph_replays"]))
        if not (same_plain and same_cpu):
            fail(f"float32 spec ({draft}, {samp}): tokens differ, spec vs "
                 f"plain on the card {same_plain}, card vs CPU {same_cpu}")
        if not n_win:
            fail(f"float32 spec ({draft}): no window launch")
        check_launches(eng, c, cfg.n_layers, got, f"2b {draft} {samp}")


# ---------------------------------------------------------------------------
# phase 2c: float32 paged KV, prefix cache and chunked prefill, card vs CPU
# ---------------------------------------------------------------------------

def paged_traffic(rng, n_shared, n_plain, shared_len, suffix, plain):
    """Prompts in random order: n_shared open with one shared_len-token
    system prompt and a suffix whose length is a multiple of 16 in
    ``suffix`` (so their resubmissions are full-prefix hits,
    copy-on-write), n_plain are unshared, of random length in
    ``plain``."""
    sys_prompt = rng.integers(0, 256, size=shared_len).astype(np.int32)
    out = [np.concatenate([sys_prompt, rng.integers(
        0, 256, size=16 * int(n)).astype(np.int32)])
        for n in rng.integers(suffix[0] // 16, suffix[1] // 16 + 1,
                              size=n_shared)]
    out += [rng.integers(0, 256, size=int(n)).astype(np.int32)
            for n in rng.integers(plain[0], plain[1] + 1, size=n_plain)]
    # interleaved, so refills of the first wave hit the system prompt
    return [out[i] for i in rng.permutation(len(out))]


def serve_waves(eng, waves):
    """Each wave submitted and drained in turn: (results per wave, each
    wave's share of the engine's counts and prefill / decode seconds)."""
    results, deltas = [], []
    before = dict(eng.counts, prefill_s=eng.seconds["prefill"],
                  decode_s=eng.seconds["decode"])
    for prompts in waves:
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        results.append([h.result() for h in hs])
        after = dict(eng.counts, prefill_s=eng.seconds["prefill"],
                     decode_s=eng.seconds["decode"])
        deltas.append({k: after[k] - before[k] for k in after})
        before = after
    return results, deltas


def phase_paged_f32_card_vs_cpu(torch, dev):
    """Phase 2's 2-layer 512d float32 model: 12 greedy requests (8 share a
    64-token prefix; 8-192 tokens; 16 new), then 4 of them again, through
    the paged engine (page_size 16, 160 pages, prefix cache) on the card
    and on the CPU; the contiguous engine, prefill_chunk 32 (paged and
    contiguous) and paged spec (K=4, "layers:1") on the card. Gates, all
    token-exact: card ≡ CPU, paged ≡ contiguous, the second wave ≡ the
    first, chunked ≡ one-shot, spec ≡ plain; hits and copies > 0; no
    page leaked."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(1)
    first = paged_traffic(rng, 8, 4, 64, (16, 128), (8, 192))
    again = [p for p in first if p.shape[0] % 16 == 0][:4]
    waves = [first, again]
    base = dict(num_slots=8, decode_chunk=8, max_new_tokens=16)
    paged = dict(paged=True, page_size=16, kv_pages=160)
    params = {d: tf.init_params(cfg, seed=1, device=d)
              for d in (dev, torch.device("cpu"))}

    def run(d, **kw):
        eng = InferenceEngine(cfg, params[d], EngineConfig(**base, **kw),
                              device=d)
        out, counts = serve_waves(eng, waves)
        return eng, out, counts

    eng, got, counts = run(dev, **paged)
    arms = {"paged_cpu": run(torch.device("cpu"), **paged)[1],
            "contiguous": run(dev)[1],
            "paged_chunked": run(dev, prefill_chunk=32, **paged)[1],
            "contiguous_chunked": run(dev, prefill_chunk=32)[1],
            "paged_spec": run(dev, spec_decode=True, spec_k=4,
                              draft="layers:1", **paged)[1]}
    want = got[0] + [next(r for p, r in zip(first, got[0]) if p is q)
                     for q in again]
    same = {arm: all(np.array_equal(a, b) for a, b in
                     zip(out[0] + out[1], got[0] + got[1]))
            for arm, out in arms.items()}
    same["second_wave_equals_first"] = all(
        np.array_equal(a, b) for a, b in zip(got[0] + got[1], want))
    hits2, cow2 = counts[1]["prefix_hits"], counts[1]["cow_copies"]
    c = eng.counts
    line(dict(phase="2c", requests=len(first), resubmitted=len(again),
              new_tokens=16, page_size=16, kv_pages=160,
              tokens_equal=same, prefix_hits=c["prefix_hits"],
              prefix_misses=c["prefix_misses"],
              prefix_shared_tokens=c["prefix_shared_tokens"],
              second_wave_hits=hits2, cow_copies=c["cow_copies"],
              pages_used=c["pages_used"],
              prefix_cache_pages=eng.prefix_cache_pages))
    bad = [k for k, v in same.items() if not v]
    if bad:
        fail(f"float32 paged serving: tokens differ in {bad}")
    if not (hits2 > 0 and cow2 > 0):
        fail(f"float32 paged second wave: {hits2} hits, {cow2} copies")
    if c["pages_used"] != eng.prefix_cache_pages:
        fail(f"float32 paged engine leaked pages: {c['pages_used']} used, "
             f"{eng.prefix_cache_pages} held by the prefix cache")



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
        degrade_queue_depth=1024, pipeline=False), device=dev)

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p) for p in prompts]
    eng.run_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    n_flash, n_dec = got["flash_fwd"], got["decode_attention"]
    for h, p in zip(hs, prompts):
        out = h.result()
        if out.shape != (p.shape[0] + new,) or \
                not np.array_equal(out[:p.shape[0]], p) or \
                out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"request {h.rid}: bad result of shape {out.shape}")
    c = eng.counts
    check_launches(eng, c, L, got, "3 engine")
    steps = eng.decode_chunk * c["decode_chunks"]
    ms_per_step = eng.seconds["decode"] / steps * 1e3
    line(dict(phase=3, run="engine", requests=n_req, answered=len(hs),
              new_tokens=new, prompt_len_min=int(lens.min()),
              prompt_len_max=int(lens.max()), wall_s=wall,
              tokens_per_s=n_req * new / wall,
              prefill_calls=c["prefill_calls"],
              prefill_s=eng.seconds["prefill"],
              decode_chunks=c["decode_chunks"],
              decode_s=eng.seconds["decode"],
              ms_per_decode_step=ms_per_step,
              flash_launches=n_flash, decode_launches=n_dec,
              graph_captures=c["graph_captures"],
              graph_replays=c["graph_replays"]))

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
    return ({"flash_fwd": n_flash + g_flash,
             "decode_attention": n_dec + g_dec}, ms_per_step,
            ([prompts], [[h.result() for h in hs]]))


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
    arms, launches = {}, {}
    for arm, kw in (("plain", dict(decode_chunk=8)),
                    ("spec", dict(spec_decode=True, spec_k=K,
                                  draft=f"layers:{nd}"))):
        eng = InferenceEngine(cfg, params, EngineConfig(
            num_slots=64, max_new_tokens=new, max_queue=256,
            degrade_queue_depth=1024, pipeline=False, **kw), device=dev)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        arms[arm] = (eng, [h.result() for h in hs], wall)
        launches[arm] = {k: got[k] for k in ("flash_fwd", "decode_attention",
                                             "decode_window")}
        c = eng.counts
        check_launches(eng, c, L, got, f"3b {arm}")
        rec = dict(phase="3b", arm=arm, requests=n_req, new_tokens=new,
                   wall_s=wall, tokens_per_s=n_req * new / wall,
                   prefill_calls=c["prefill_calls"],
                   prefill_s=eng.seconds["prefill"],
                   flash_launches=got["flash_fwd"],
                   decode_launches=got["decode_attention"],
                   window_launches=got["decode_window"],
                   graph_captures=c["graph_captures"],
                   graph_replays=c["graph_replays"])
        if arm == "plain":
            rec.update(decode_chunks=c["decode_chunks"],
                       ms_per_decode_chunk=eng.seconds["decode"]
                       / c["decode_chunks"] * 1e3)
        else:
            rounds = c["spec_rounds"]
            rec.update(spec_k=K, draft=f"layers:{nd}", spec_rounds=rounds,
                       decode_chunks=c["decode_chunks"],
                       ms_per_spec_round=eng.seconds["spec"] / rounds * 1e3,
                       drafted=c["spec_drafted"],
                       accepted=c["spec_accepted"],
                       acceptance=c["spec_accepted"] / c["spec_drafted"],
                       spec_k_final=eng.spec_k_current)
        line(rec)
    eng, spec, _ = arms["spec"]
    plain = arms["plain"][1]
    bad = [i for i, (a, b) in enumerate(zip(spec, plain))
           if not np.array_equal(a, b)]
    if bad:
        fail(f"full-width spec tokens differ from the plain engine in "
             f"requests {bad[:8]} ({len(bad)} of {n_req})")
    if eng.counts["decode_chunks"] or eng.spec_k_current != K or \
            eng._graphs.keys() != [("spec", K)]:
        fail(f"aligned spec run left K={K}: {eng.counts}, K now "
             f"{eng.spec_k_current}, graphs {eng._graphs.keys()}")
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
    return total, ([prompts], [spec])


# ---------------------------------------------------------------------------
# phase 3c: full-width paged serving, prefix cache and chunked prefill
# ---------------------------------------------------------------------------

def phase_paged_full_width(torch, dev, contiguous_ms_per_step):
    """Phase 3's bf16 flagship decode config, 64 slots, decode_chunk 8, on
    the paged pool (page_size 16, 3072 pages + scratch, prefix cache): 128
    greedy requests of 64 new tokens (96 open with one 512-token system
    prompt and a page-aligned suffix of 16-512 tokens, 32 unshared of
    16-1024), then 32 of them again (prefix hits, copy-on-write); the
    first wave on the contiguous pool; the same 32 cold (prefix cache
    off); the first wave with prefill_chunk 256 and the default budget;
    then paged spec (K=7, "layers:1") against paged plain on phase 3b's
    aligned tree, token-exact. Gates: every request answered and well
    formed; launches exact (decode L x chunk per decode chunk, window L
    and draft decode K per spec round, flash_fwd L per prefill call on
    the contiguous arm and none on the others); hits and copies in the
    second wave; no page leaked. Prints each arm's tokens/s, ms per
    decode step and prefill seconds, the first wave's ms per decode step
    paged and contiguous beside phase 3's, and one profiled paged decode
    tick. Returns the launches by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L, chunk, new, K = cfg.n_layers, 8, 64, 7
    rng = np.random.default_rng(0)
    first = paged_traffic(rng, 96, 32, 512, (16, 512), (16, 1024))
    again = [first[i] for i in rng.choice(len(first), size=32,
                                          replace=False)]
    base = dict(num_slots=64, decode_chunk=chunk, max_new_tokens=new,
                max_queue=256, degrade_queue_depth=1024, paged=True,
                page_size=16, kv_pages=3072 + 1, pipeline=False)
    params = tf.init_params(cfg, seed=0, device=dev)
    aligned = aligned_params(tf, cfg, dev)
    launches = {"flash_fwd": 0, "decode_attention": 0, "decode_window": 0}

    def arm(name, tree, waves, **kw):
        eng = InferenceEngine(cfg, tree, EngineConfig(**{**base, **kw}),
                              device=dev)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts = serve_waves(eng, waves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        n_flash, n_dec, n_win = (got[k] for k in launches)
        for k in launches:
            launches[k] += got[k]
        for prompts, res in zip(waves, out):
            for p, r in zip(prompts, res):
                if r.shape != (p.shape[0] + new,) or \
                        not np.array_equal(r[:p.shape[0]], p) or \
                        r.min() < 0 or r.max() >= cfg.vocab_size:
                    fail(f"3c {name}: bad result of shape {r.shape}")
        c = eng.counts
        rounds, chunks = c["spec_rounds"], c["decode_chunks"]
        # paged and chunked prefill is plain attention, never flash
        check_launches(eng, c, L, got, f"3c {name}")
        if c["pages_used"] != eng.prefix_cache_pages:
            fail(f"3c {name}: {c['pages_used']} pages used, "
                 f"{eng.prefix_cache_pages} held by the prefix cache")
        n_tok = sum(len(w) for w in waves) * new
        rec = dict(phase="3c", arm=name, requests=sum(len(w) for w in waves),
                   new_tokens=new, wall_s=wall, tokens_per_s=n_tok / wall,
                   prefill_calls=c["prefill_calls"],
                   prefill_s=eng.seconds["prefill"],
                   prefill_chunks=c["prefill_chunks"], decode_chunks=chunks,
                   decode_s=eng.seconds["decode"],
                   flash_launches=n_flash, decode_launches=n_dec,
                   window_launches=n_win,
                   graph_captures=c["graph_captures"],
                   graph_replays=c["graph_replays"],
                   prefix_hits=c["prefix_hits"],
                   prefix_misses=c["prefix_misses"],
                   prefix_shared_tokens=c["prefix_shared_tokens"],
                   prefix_evictions=c["prefix_evictions"],
                   cow_copies=c["cow_copies"], pages_used=c["pages_used"],
                   pages_free=c["pages_free"],
                   shed_overload=c["shed_overload"])
        if chunks:
            rec["ms_per_decode_step"] = (eng.seconds["decode"]
                                         / (chunk * chunks) * 1e3)
        if rounds:
            rec.update(spec_rounds=rounds,
                       ms_per_spec_round=eng.seconds["spec"] / rounds * 1e3,
                       acceptance=c["spec_accepted"] / c["spec_drafted"],
                       spec_k_final=eng.spec_k_current)
        if len(waves) > 1:
            rec["waves"] = [dict(requests=len(w), **{
                k: d[k] for k in ("prefill_calls", "prefill_s", "decode_s",
                                  "decode_chunks", "prefix_hits",
                                  "cow_copies")})
                for w, d in zip(waves, counts)]
        line(rec)
        return eng, out, counts

    eng, paged_out, counts = arm("paged", params, [first, again])
    if not (counts[1]["prefix_hits"] > 0 and counts[1]["cow_copies"] > 0):
        fail(f"3c second wave: {counts[1]['prefix_hits']} prefix hits, "
             f"{counts[1]['cow_copies']} copies")
    contiguous, _, _ = arm("contiguous", params, [first], paged=False)
    _, _, cold = arm("cold", params, [again], prefix_cache=False)
    # the first wave's decode on the paged pool and the contiguous one
    line(dict(phase="3c", run="paged_vs_contiguous", requests=len(first),
              paged_ms_per_decode_step=counts[0]["decode_s"]
              / (chunk * counts[0]["decode_chunks"]) * 1e3,
              contiguous_ms_per_decode_step=contiguous.seconds["decode"]
              / (chunk * contiguous.counts["decode_chunks"]) * 1e3,
              phase3_contiguous_ms_per_decode_step=contiguous_ms_per_step,
              resubmitted=len(again), cold_prefill_s=cold[0]["prefill_s"],
              hit_prefill_s=counts[1]["prefill_s"],
              saved_s=cold[0]["prefill_s"] - counts[1]["prefill_s"]))
    del contiguous
    _, chunked_out, _ = arm("chunked", params, [first], prefill_chunk=256)
    _, plain, _ = arm("paged_aligned_plain", aligned, [first])
    spec, got, _ = arm("paged_aligned_spec", aligned, [first],
                       spec_decode=True, spec_k=K, draft="layers:1")
    bad = [i for i, (a, b) in enumerate(zip(got[0], plain[0]))
           if not np.array_equal(a, b)]
    if bad:
        fail(f"3c paged spec tokens differ from paged plain in requests "
             f"{bad[:8]} ({len(bad)} of {len(first)})")
    if spec.counts["decode_chunks"] or spec.spec_k_current != K:
        fail(f"3c aligned paged spec left K={K}: {spec.counts}")
    del spec, plain, got, aligned
    profile_decode_tick(torch, eng, rng, "paged", phase="3c")
    del eng, params
    torch.cuda.empty_cache()
    return launches, {"paged": ([first, again], paged_out),
                      "chunked": ([first], chunked_out)}


def profile_decode_tick(torch, eng, rng, arm, phase="3b", constrain=None):
    """One decode phase with no admissions in its tick (a spec round of
    K+1 = 8 tokens, or a plain chunk of 8) under torch.profiler, every
    request under ``constrain``: device time and launches by kernel, and
    the device's idle share (a paged engine's also the device time of
    its page gathers). Gates: the tick's program is one graph replay,
    and the device's trace holds the ported kernels it must run
    (`device_launch_gate`). Returns (wall s, device rows)."""
    spec = eng.spec_k_current > 0
    kind = "spec_rounds" if spec else "decode_chunks"
    L = eng.cfg.n_layers
    prompts = [rng.integers(0, 256, size=64).astype(np.int32)
               for _ in range(eng.num_slots)]
    # 17 tokens: the prefill's first, then two rounds (or chunks) of 8
    warm = [eng.submit(p, max_new_tokens=17, constrain=constrain)
            for p in prompts]
    eng.run_pending()
    hs = [eng.submit(p, max_new_tokens=17, constrain=constrain)
          for p in prompts]
    eng.tick()                              # admissions + the first 8
    n = eng.counts[kind]
    want = replay_want(eng, spec, L)
    c0 = dict(eng.counts)
    wall, rows, host = profiled(torch, eng.tick)  # the second 8 alone
    if eng.counts[kind] != n + 1:
        fail(f"the profiled {arm} tick ran no {kind[:-1]}")
    if eng.counts["graph_replays"] != c0["graph_replays"] + 1 or \
            eng.counts["graph_captures"] != c0["graph_captures"]:
        fail(f"the profiled {arm} tick was no single graph replay "
             f"({eng.counts})")
    measured = device_launch_gate(rows, want, f"{phase} profiled {arm} tick")
    eng.run_pending()
    if not all(h.done() for h in hs + warm):
        fail(f"profiled {arm} tick left requests unanswered")
    rec = {}
    if eng.config.paged:
        # the page gathers (`plane[bt]`, 2 a layer a step) run torch's
        # gather kernel, as do the 2 embedding lookups a step; the row
        # writes run its index_put kernel
        gather = [(k, us, n) for k, us, n in rows if "gather" in k.lower()]
        busy = sum(us for _, us, _ in rows)
        rec = dict(gather_ms=sum(us for _, us, _ in gather) / 1e3,
                   gather_launches=sum(n for _, _, n in gather),
                   gather_share=(sum(us for _, us, _ in gather) / busy
                                 if busy else "not measured"),
                   gather_and_index_kernels=[
                       dict(name=k[:120], ms=us / 1e3, count=n)
                       for k, us, n in rows
                       if "gather" in k.lower() or "index" in k.lower()])
    profile_line(wall, rows, host, phase=phase, run=f"profiled_{arm}_tick",
                 graph_replays=1, device_launches_of_ported=measured, **rec)
    return wall, rows


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


def host_launch_calls(prof):
    """{runtime call: count} of the host's kernel and graph launches in a
    torch.profiler run (cudaLaunchKernel, cudaLaunchKernelExC,
    cudaGraphLaunch, and the driver API's cuLaunchKernel*)."""
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("cudaLaunch", "cuLaunch",
                                 "cudaGraphLaunch"))}


def profiled(torch, fn):
    """Run fn() once under torch.profiler; returns (wall s, device rows,
    host launch calls)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_rows(prof), host_launch_calls(prof)


def profile_line(wall, rows, host, **rec):
    busy = sum(us for _, us, _ in rows) / 1e6
    rec.update(host_launch_calls=sum(host.values()),
               host_launch_calls_by_name=host)
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
    share of the tick's wall time. Gates: the decode chunk is one graph
    replay, and the device's trace holds the prefill's L flash launches
    and the chunk's L x 8 decode launches."""
    prompts = [rng.integers(0, 256, size=64).astype(np.int32)
               for _ in range(eng.num_slots)]
    warm = [eng.submit(p, max_new_tokens=9) for p in prompts]
    eng.run_pending()
    hs = [eng.submit(p, max_new_tokens=9) for p in prompts]
    c0 = dict(eng.counts)
    wall, rows, host = profiled(torch, eng.tick)
    c = {k: eng.counts[k] - c0[k] for k in c0}
    if (c["prefill_calls"], c["decode_chunks"], c["graph_replays"],
            c["graph_captures"]) != (1, 1, 1, 0):
        fail(f"the profiled tick was not one prefill and one decode "
             f"replay ({c})")
    L = eng.cfg.n_layers
    measured = device_launch_gate(
        rows, {"flash_fwd": L, **replay_want(eng, False, L)},
        "3 profiled tick")
    eng.run_pending()
    if not all(h.done() for h in hs + warm):
        fail("profiled tick left requests unanswered")
    profile_line(wall, rows, host, phase=3, run="profiled_tick",
                 device_launches_of_ported=measured)


# ---------------------------------------------------------------------------
# phase 3e: the pipelined tick loop (the engine's default) at full width
# ---------------------------------------------------------------------------

# the device functions the serving wrappers launch, as the device's
# trace names them: the bf16 decode and window entries share the
# tensor-core core (decode is the window at T = 1), so a profiled spec
# round counts its window and draft decode launches together
DEVICE_FNS = {"flash_fwd": ("flash_fwd_kernel", "flash_fwd_tc_kernel"),
              "decode_rows": ("decode_rows_tc_kernel", "decode_kernel",
                              "window_kernel"),
              "decode_q": ("decode_q_kernel",),
              "window_q": ("window_q_kernel",)}
# what the profiled ticks' device traces held, by DEVICE_FNS label, and
# the graph replays of each gated run: printed before the kernels line
DEVICE_LAUNCHES = {k: 0 for k in DEVICE_FNS}
GRAPH_REPLAYS = {}


def device_launch_gate(rows, want, where):
    """Gate one profiled tick on the device's own trace (CUPTI, through
    torch.profiler): each serving device function of DEVICE_FNS ran
    exactly ``want[label]`` times (0 where absent). This is what shows
    that a graph replay ran the ported kernels. Returns the counts."""
    if not rows:
        fail(f"{where}: the profiler recorded no device kernel")
    got = {label: sum(n for k, _, n in rows if any(f in k for f in fns))
           for label, fns in DEVICE_FNS.items()}
    want = {label: want.get(label, 0) for label in DEVICE_FNS}
    if got != want:
        fail(f"{where}: device launches {got}, want {want}")
    for label, n in got.items():
        DEVICE_LAUNCHES[label] += n
    return got


def replay_want(eng, spec: bool, n_layers: int):
    """The serving device functions one replayed decode chunk (or spec
    round at the engine's current K) runs."""
    q = eng._kv_mode is not None
    if spec:
        nd = eng._draft_layers or n_layers
        dec, win = nd * eng.spec_k_current, n_layers
    else:
        dec, win = n_layers * eng.decode_chunk, 0
    if q:
        return {"decode_q": dec, "window_q": win}
    return {"decode_rows": dec + win}


def launch_counters():
    """The serving kernels' wrappers by kernel name."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    return {"flash_fwd": fa.flash_forward_cuda,
            "decode_attention": fd.decode_attention_cuda,
            "decode_window": fd.decode_window_attention_cuda,
            "decode_attention_q": fd.decode_attention_q_cuda,
            "decode_window_q": fd.decode_window_attention_q_cuda}


def expected_launches(eng, c, n_layers, keys0=()):
    """The launches by kernel the wrappers count in a drained run on a
    card engine with counts delta ``c`` (``keys0``: the graph keys the
    engine had captured before the run). A slot program's kernels launch
    from Python only at the first call of its (kind, size) key, eagerly,
    and once more at the capture right after it: a decode chunk L x
    chunk, a spec round L window and draft depth x K decode (the
    quantized entries on a quantized pool). Every later call of the key
    is a graph replay, which calls no wrapper: what a replay runs is
    read from the device's own trace (`device_launch_gate`). Flash L per
    one-shot contiguous prefill call (eager)."""
    nd = (eng._draft_layers or n_layers) if eng._spec else 0
    dec = win = 0
    for kind, size in eng._graphs.keys():
        if (kind, size) in keys0:
            continue
        if kind.removesuffix("_c").endswith("spec"):
            dec += 2 * nd * size
            win += 2 * n_layers
        else:
            dec += 2 * n_layers * size
    q = eng._kv_mode is not None
    one_shot = not (eng.config.paged or eng.config.prefill_chunk)
    return {"flash_fwd": n_layers * c["prefill_calls"] if one_shot else 0,
            "decode_attention": 0 if q else dec,
            "decode_window": 0 if q else win,
            "decode_attention_q": dec if q else 0,
            "decode_window_q": win if q else 0}


def check_launches(eng, c, n_layers, got, where, keys0=()):
    """Gate a drained card run (counts delta ``c``, wrapper launches
    ``got`` by kernel name): the launches `expected_launches` gives, and
    every decode chunk and spec round but the first of each key a graph
    replay (no slot program ran eagerly past its capture)."""
    want = expected_launches(eng, c, n_layers, keys0)
    new = len(eng._graphs.keys()) - len(keys0)
    replays = c["decode_chunks"] + c["spec_rounds"] - new
    got = {k: got.get(k, 0) for k in want}
    if got != want or c["graph_replays"] != replays:
        fail(f"{where}: launches {got}, want {want}; graph replays "
             f"{c['graph_replays']}, want {replays} ({c})")
    GRAPH_REPLAYS[where] = GRAPH_REPLAYS.get(where, 0) + replays


def read_launches():
    """The serving wrappers' launch counters by kernel name."""
    return {k: w.launches for k, w in launch_counters().items()}


def zero_launches():
    for w in launch_counters().values():
        w.launches = 0


def serve_pass(torch, eng, waves, specs=None):
    """Each wave submitted (``specs``: each wave's constraints, per
    request) and drained tick by tick, with the launch counters reset
    before: (results per wave, wall s, counts delta, seconds delta,
    launches by kernel, most blocking waits in a tick, the graph keys
    captured before the pass)."""
    zero_launches()
    keys0 = eng._graphs.keys()
    c0, s0 = dict(eng.counts), dict(eng.seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, worst = [], 0
    for w, prompts in enumerate(waves):
        hs = [eng.submit(p, constrain=None if specs is None else specs[w][i])
              for i, p in enumerate(prompts)]
        while True:
            n = eng.counts["syncs"]
            busy = eng.tick()
            worst = max(worst, eng.counts["syncs"] - n)
            if not busy:
                break
        out.append([h.result() for h in hs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, {k: eng.counts[k] - c0[k] for k in c0},
            {k: eng.seconds[k] - s0[k] for k in s0}, read_launches(), worst,
            keys0)


def replay_equals_eager(torch, eng, kind, size):
    """The engine's captured (kind, size) program called once by replay
    and once eagerly from the same pool (every slot active, 8 tokens of
    budget): whether outputs and pool are torch.equal. The pool and the
    launch counters are left as they were."""
    g = eng._graphs._graphs[(kind, size)]
    fn = eng._program(kind, size)
    state = [x for x in g.fixed if isinstance(x, torch.Tensor)]
    saved = [x.clone() for x in state]
    counted = read_launches()
    ns, dev = eng.num_slots, state[0].device
    dyn = (torch.ones(ns, dtype=torch.bool, device=dev),
           torch.full((ns,), 8, dtype=torch.int32, device=dev))
    if kind.startswith("paged"):
        dyn = (torch.from_numpy(eng._bt.copy()).to(dev),) + dyn
    if kind.removesuffix("_c").endswith("spec"):
        dyn += (torch.zeros(ns, dtype=torch.bool, device=dev),)
    if kind.endswith("_c"):     # no seeds: every slot carries its state
        dyn += (torch.zeros(ns, dtype=torch.bool, device=dev),
                torch.zeros(ns, dtype=torch.int32, device=dev))
    seed = int(eng.config.seed)
    got = [t.clone() for t in eng._graphs.call((kind, size), fn, g.fixed,
                                                dyn, seed)[len(state):]]
    replayed = [x.clone() for x in state]
    for x, s in zip(state, saved):
        x.copy_(s)
    want = fn(*g.fixed, *dyn, seed)[len(state):]
    ok = (all(torch.equal(a, b) for a, b in zip(got, want))
          and all(torch.equal(a, b) for a, b in zip(replayed, state)))
    for x, s in zip(state, saved):
        x.copy_(s)
    for k, w in launch_counters().items():
        w.launches = counted[k]
    torch.cuda.synchronize()
    return ok


def phase_pipeline_full_width(torch, dev, sync):
    """Phase 3's config on the pipelined loop, every per-tick program a
    CUDA graph replay, against the synchronous loop on the traffic of
    phases 3-3d (``sync``: arm -> (waves, that phase's results per
    wave)). Arms: plain (phase 3's traffic; a warm pass per loop, then
    timed passes sync, pipelined, pipelined, sync), spec (3b's aligned
    tree, K 7, "layers:1"), paged (3c's two waves), chunked (3c's paged
    chunk-256 arm) and int8 (3d's int8 weights and KV); each arm's
    synchronous passes run here first, beside its pipelined passes, and
    each pass prints how many requests differ from the earlier phase's
    results. Gates: token-exact against this phase's synchronous pass on
    every arm; without spec the same calls (the
    same schedule); at most one blocking wait in a pipelined tick;
    launches exact under replay; no capture in a pass after the warm one;
    no page leaked; the paged engine's graph pool far under its 2 x L
    gathered views; replay ≡ eager for the decode chunk and the spec
    round. Prints tokens/s and ms a step of both loops, waits a tick,
    captures, replays, graph-pool bytes, and one profiled pipelined
    decode tick (idle share, device kernels, host launch calls).
    Returns the launches by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L, chunk, new, K = cfg.n_layers, 8, 64, 7
    params = tf.TransformerLM(cfg, seed=0, device=dev).params
    base = dict(num_slots=64, decode_chunk=chunk, max_new_tokens=new,
                max_queue=256, degrade_queue_depth=1024)
    paged = dict(paged=True, page_size=16, kv_pages=3072 + 1)
    totals = {k: 0 for k in launch_counters()}

    def differ(out, want):
        return [(w, i) for w, (got_w, want_w) in enumerate(zip(out, want))
                for i, (a, b) in enumerate(zip(got_w, want_w))
                if not np.array_equal(a, b)]

    def run(name, eng, waves, want, warm):
        """One pass; ``want`` the synchronous loop's results in this
        phase (None: this pass is that reference)."""
        out, wall, c, sec, n, worst, keys0 = serve_pass(torch, eng, waves)
        for k in totals:
            totals[k] += n[k]
        bad = differ(out, want) if want is not None else []
        if bad:
            fail(f"3e {name} (pipeline={eng.config.pipeline}): tokens "
                 f"differ from the synchronous loop in (wave, request) "
                 f"{bad[:8]} ({len(bad)})")
        check_launches(eng, c, L, n,
                       f"3e {name} pipeline={eng.config.pipeline}", keys0)
        if eng.config.pipeline and worst > 1:
            fail(f"3e {name}: {worst} blocking waits in one pipelined tick")
        if not warm and c["graph_captures"]:
            fail(f"3e {name}: {c['graph_captures']} captures after warm-up")
        if not eng.drained() or (eng.config.paged and
                                 eng.counts["pages_used"]
                                 != eng.prefix_cache_pages):
            fail(f"3e {name}: not drained or pages leaked ({eng.counts})")
        steps = chunk * c["decode_chunks"]
        rec = dict(phase="3e", arm=name, pipeline=eng.config.pipeline,
                   warm_pass=warm, requests=sum(len(w) for w in waves),
                   # phases 3-3d ran the same synchronous engine earlier
                   # in this process: printed, not a gate
                   requests_differing_from_earlier_phase=len(
                       differ(out, sync[name][1])),
                   new_tokens=new, wall_s=wall,
                   tokens_per_s=sum(len(w) for w in waves) * new / wall,
                   syncs=c["syncs"], max_syncs_per_tick=worst,
                   pipelined_ticks=c["pipelined_ticks"],
                   prefill_calls=c["prefill_calls"],
                   prefill_chunks=c["prefill_chunks"],
                   decode_chunks=c["decode_chunks"],
                   spec_rounds=c["spec_rounds"],
                   graph_captures=c["graph_captures"],
                   graph_replays=c["graph_replays"],
                   graph_pool_bytes=eng.counts["graph_pool_bytes"],
                   launches=n, seconds=sec)
        if steps:
            rec["wall_ms_per_decode_step"] = wall / steps * 1e3
            if not eng.config.pipeline:
                rec["ms_per_decode_step"] = sec["decode"] / steps * 1e3
        if c["spec_rounds"]:
            rec.update(spec_k_final=eng.spec_k_current,
                       acceptance=c["spec_accepted"] / c["spec_drafted"],
                       spec_reserved=c["spec_reserved"],
                       spec_released=c["spec_released"],
                       spec_committed=c["spec_committed"])
        line(rec)
        return rec, c, out

    # (a) plain, both loops, timed in turns on warm engines
    engs = {p: InferenceEngine(cfg, params, EngineConfig(**base, pipeline=p),
                               device=dev) for p in (False, True)}
    waves = sync["plain"][0]
    want = run("plain", engs[False], waves, None, warm=True)[2]
    run("plain", engs[True], waves, want, warm=True)
    timed = {False: [], True: []}
    for p in (False, True, True, False):
        timed[p].append(run("plain", engs[p], waves, want, warm=False)[:2])
    for k in ("prefill_calls", "decode_chunks"):
        if {r[1][k] for rs in timed.values() for r in rs} != \
                {timed[False][0][1][k]}:
            fail(f"3e plain: the loops made other calls ({k}): "
                 f"{[r[1][k] for rs in timed.values() for r in rs]}")
    tps = {p: [r[0]["tokens_per_s"] for r in rs] for p, rs in timed.items()}
    ms = {p: [r[0]["wall_ms_per_decode_step"] for r in rs]
          for p, rs in timed.items()}
    line(dict(phase="3e", run="sync_vs_pipelined", order="S P P S",
              sync_tokens_per_s=tps[False], pipelined_tokens_per_s=tps[True],
              pipelined_over_sync=sum(tps[True]) / sum(tps[False]),
              sync_wall_ms_per_decode_step=ms[False],
              pipelined_wall_ms_per_decode_step=ms[True],
              sync_ms_per_decode_step=[r[0]["ms_per_decode_step"]
                                       for r in timed[False]],
              graph_pool_bytes={"sync": engs[False].counts[
                  "graph_pool_bytes"], "pipelined": engs[True].counts[
                  "graph_pool_bytes"]}))
    replay_ok = {"decode": replay_equals_eager(torch, engs[True], "decode",
                                               chunk)}
    profile_decode_tick(torch, engs[True], np.random.default_rng(5),
                        "pipelined", phase="3e")
    del engs
    torch.cuda.empty_cache()

    # (b)-(e): spec, paged, chunked, int8 on the pipelined loop
    aligned = aligned_params(tf, cfg, dev)
    q8 = dict(quantize="int8", kv_quantize="int8")
    arms = [("spec", aligned, dict(spec_decode=True, spec_k=K,
                                   draft="layers:1"), 2),
            ("paged", params, paged, 2),
            ("chunked", params, dict(paged, prefill_chunk=256), 1),
            ("int8", params, q8, 2)]
    pool_bytes = {}
    for name, tree, kw, passes in arms:
        waves = sync[name][0]
        # pass i of each loop against pass i of the other: a paged
        # engine's second pass meets the first's prefix cache
        ref = InferenceEngine(cfg, tree, EngineConfig(**base, **kw,
                                                      pipeline=False),
                              device=dev)
        want = [run(name, ref, waves, None, warm=i == 0)[2]
                for i in range(passes)]
        del ref
        eng = InferenceEngine(cfg, tree, EngineConfig(**base, **kw),
                              device=dev)
        for i in range(passes):
            _, c, _ = run(name, eng, waves, want[i], warm=i == 0)
        pool_bytes[name] = eng.counts["graph_pool_bytes"]
        if name == "spec":
            if eng.spec_k_current != K or c["decode_chunks"]:
                fail(f"3e spec left K={K}: {eng.counts}")
            replay_ok["spec"] = replay_equals_eager(torch, eng, "spec", K)
        if passes == 1 and c["graph_captures"] != len(eng._graphs.keys()):
            fail(f"3e {name}: {c['graph_captures']} captures for "
                 f"{len(eng._graphs.keys())} programs")
        del eng
        torch.cuda.empty_cache()
    del aligned, params
    torch.cuda.empty_cache()
    # a paged decode gathers 2 x L page views of 128 MiB; the capture's
    # pool reuses a layer's once it is freed
    view = 64 * 2048 * 512 * 2
    line(dict(phase="3e", run="graphs", replay_equals_eager=replay_ok,
              graph_pool_bytes=pool_bytes, gathered_view_bytes=view))
    if not all(replay_ok.values()):
        fail(f"3e graph replay differs from the eager program: {replay_ok}")
    if pool_bytes["paged"] >= L * view:
        fail(f"3e paged graph pool {pool_bytes['paged']} bytes: the "
             f"capture kept the gathered views ({view} bytes each)")
    return {k: n for k, n in totals.items() if n}


# ---------------------------------------------------------------------------
# phases 2e, 3f and 3f': grammar-constrained serving
# ---------------------------------------------------------------------------

RX5, RXP = "[ab]{1,5}", "[ab]+"
# the reference bench's schema (benchmarks/flagship.py:1479-1482)
SCHEMA = {"type": "json_schema", "schema": {
    "type": "object",
    "properties": {"status": {"enum": ["ok", "retry", "dead"]},
                   "attempts": {"type": "integer"},
                   "fatal": {"type": "boolean"}}}}


def check_constrained(where, reqs, outs, eng=None):
    """Gate one arm's results: ``reqs`` [(prompt, spec, max_new)],
    ``outs`` the full sequences. Every generated token of a constrained
    request is legal under a host replay of the port's grammar; a request
    shorter than its budget ends terminal; a schema output parses with
    its keys among the schema's; ``eng``'s own walk refused nothing.
    Returns (terminal completions, generated tokens)."""
    from deeplearning4j_tpu_torch.serving.constrain import compile_grammar
    terminal = n_tok = 0
    for k, ((p, spec, new), out) in enumerate(zip(reqs, outs)):
        gen = out[p.shape[0]:]
        n_tok += gen.shape[0]
        if not np.array_equal(out[:p.shape[0]], p) or gen.shape[0] > new:
            fail(f"{where}: request {k} returned shape {out.shape}")
        if spec is None:
            if gen.shape[0] != new:
                fail(f"{where}: unconstrained request {k} stopped early")
            continue
        g = compile_grammar(spec, 256)
        st = 0
        for t in gen.tolist():
            if not g.legal(st, t):
                fail(f"{where}: request {k} token {t} illegal in state {st}")
            st = g.advance(st, t)
        if g.is_terminal(st):
            terminal += 1
        elif gen.shape[0] < new:
            fail(f"{where}: request {k} stopped at {gen.shape[0]} tokens "
                 "short of a terminal state")
        if spec is SCHEMA:
            doc = json.loads(bytes(gen.tolist()).decode())
            if not (g.is_terminal(st) and isinstance(doc, dict) and
                    set(doc) <= set(SCHEMA["schema"]["properties"])):
                fail(f"{where}: request {k} schema output {doc!r}")
    if eng is not None and eng.counts["constrained_illegal"]:
        fail(f"{where}: the engine refused {eng.counts['constrained_illegal']}"
             " committed tokens")
    return terminal, n_tok


def phase_constrained_f32_card_vs_cpu(torch, dev):
    """Phase 2's 2-layer 512d float32 model and 8 prompts under grammar
    constraints (see the module docstring, 2e)."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    params = {d: tf.init_params(cfg, seed=1, device=d)
              for d in (dev, torch.device("cpu"))}
    base = dict(num_slots=8, decode_chunk=8, max_new_tokens=64)
    spec = dict(spec_decode=True, spec_k=4, draft="self")
    rx = [(p, RX5, 16) for p in prompts]
    sc = [(p, SCHEMA, 64) for p in prompts]
    mix = [(p, (RX5, SCHEMA, RXP, None)[i % 4], 64)
           for i, p in enumerate(prompts)]
    arms = {"rx": (rx, {}), "schema": (sc, {}), "rx_spec": (rx, spec),
            "schema_spec": (sc, spec), "mix": (mix, {}),
            "mix_paged": (mix, dict(paged=True, page_size=16, kv_pages=160)),
            "mix_chunked": (mix, dict(prefill_chunk=32)),
            "mix_sync": (mix, dict(pipeline=False))}
    out = {}
    for name, (reqs, kw) in arms.items():
        res = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            eng = InferenceEngine(cfg, params[d], EngineConfig(**base, **kw),
                                  device=d)
            zero_launches()
            hs = [eng.submit(p, max_new_tokens=n, constrain=c)
                  for p, c, n in reqs]
            eng.run_pending()
            res[where] = [h.result() for h in hs]
            if where == "card":
                check_launches(eng, eng.counts, cfg.n_layers, read_launches(),
                               f"2e {name}")
                terminal, n_tok = check_constrained(f"2e {name}", reqs,
                                                    res["card"], eng)
                counts = {k: v for k, v in eng.counts.items()
                          if k.startswith(("constrained_", "spec_acc",
                                           "spec_draft"))
                          and "rejected" not in k}
        same = all(np.array_equal(a, b) for a, b in zip(res["card"],
                                                        res["cpu"]))
        out[name] = res["card"]
        line(dict(phase="2e", arm=name, requests=len(reqs),
                  card_equals_cpu=same, terminal=terminal, tokens=n_tok,
                  **counts))
        if not same:
            fail(f"2e {name}: constrained tokens differ, card vs CPU")
    pairs = [("rx_spec", "rx"), ("schema_spec", "schema"),
             ("mix_paged", "mix"), ("mix_chunked", "mix"),
             ("mix_sync", "mix")]
    same = {f"{a}={b}": all(np.array_equal(x, y)
                            for x, y in zip(out[a], out[b]))
            for a, b in pairs}
    line(dict(phase="2e", run="arms_equal", **same))
    if not all(same.values()):
        fail(f"2e: constrained arms differ: {same}")


def mask_kernels(rows_c, rows_u):
    """The constrained tick's device kernels beyond the unconstrained
    tick's (by name: extra launches and device ms), and the difference
    of their device busy times in ms."""
    u = {k: (us, n) for k, us, n in rows_u}
    extra = []
    for k, us, n in rows_c:
        uus, un = u.get(k, (0, 0))
        if n > un:
            extra.append(dict(name=k[:100], launches=n - un,
                              ms=(us - uus) / 1e3))
    busy = (sum(us for _, us, _ in rows_c)
            - sum(us for _, us, _ in rows_u)) / 1e3
    return extra, busy


def phase_constrained_full_width(torch, dev, sync):
    """Phase 3's config with grammar constraints (the module docstring,
    3f); ``sync``: phase 3's and 3c's traffic (arm -> (waves, results)).
    Returns the launches by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L, chunk, new, K = cfg.n_layers, 8, 64, 7
    params = tf.TransformerLM(cfg, seed=0, device=dev).params
    base = dict(num_slots=64, decode_chunk=chunk, max_new_tokens=new,
                max_queue=256, degrade_queue_depth=1024)
    paged = dict(paged=True, page_size=16, kv_pages=3072 + 1)
    prompts = sync["plain"][0][0]                   # phase 3's traffic
    totals = {k: 0 for k in launch_counters()}

    def differ(out, want):
        return [(w, i) for w, (got_w, want_w) in enumerate(zip(out, want))
                for i, (a, b) in enumerate(zip(got_w, want_w))
                if not np.array_equal(a, b)]

    def run(name, eng, waves, spec, want=None, warm=False, new_grammar=False):
        """One pass of ``waves``, every request under ``spec`` (a list:
        one per request of each wave), gated; ``want`` a reference's
        results (None: none)."""
        specs = [[spec] * len(w) for w in waves] if not isinstance(
            spec, list) else [spec]
        out, wall, c, sec, n, worst, keys0 = serve_pass(torch, eng, waves,
                                                        specs)
        for k in totals:
            totals[k] += n[k]
        reqs = [(p, s, new) for w, sw in zip(waves, specs)
                for p, s in zip(w, sw)]
        terminal, n_tok = check_constrained(f"3f {name}", reqs,
                                            [r for w in out for r in w], eng)
        check_launches(eng, c, L, n, f"3f {name} pipeline="
                       f"{eng.config.pipeline}", keys0)
        bad = differ(out, want) if want is not None else []
        if bad:
            fail(f"3f {name} (pipeline={eng.config.pipeline}): tokens differ "
                 f"from the reference in (wave, request) {bad[:8]} "
                 f"({len(bad)})")
        if (not warm and c["graph_captures"]) or (
                eng.config.pipeline and worst > 1):
            fail(f"3f {name}: {c['graph_captures']} captures in a warm pass, "
                 f"{worst} waits in a tick")
        if not eng.drained() or (eng.config.paged and
                                 eng.counts["pages_used"]
                                 != eng.prefix_cache_pages):
            fail(f"3f {name}: not drained or pages leaked ({eng.counts})")
        steps = chunk * c["decode_chunks"]
        rec = dict(phase="3f", arm=name, pipeline=eng.config.pipeline,
                   warm_pass=warm, new_grammar_warm=new_grammar,
                   requests=len(reqs), tokens=n_tok, wall_s=wall,
                   tokens_per_s=n_tok / wall, terminal=terminal,
                   syncs=c["syncs"], prefill_calls=c["prefill_calls"],
                   decode_chunks=c["decode_chunks"],
                   spec_rounds=c["spec_rounds"],
                   graph_captures=c["graph_captures"],
                   graph_replays=c["graph_replays"], launches=n,
                   **{k: c[k] for k in c if k.startswith("constrained_")
                      and not k.startswith("constrained_rejected")})
        if steps:
            rec["wall_ms_per_decode_step"] = wall / steps * 1e3
        if c["spec_rounds"]:
            rec.update(acceptance=c["spec_accepted"] / c["spec_drafted"],
                       spec_k_final=eng.spec_k_current)
        line(rec)
        return rec, c, out

    def engine(tree=params, **kw):
        return InferenceEngine(cfg, tree, EngineConfig(**{**base, **kw}),
                               device=dev)

    # (a) unconstrained against [ab]+, a warm pass each, then U C C U
    waves = [prompts]
    engs = {"U": engine(), "C": engine()}
    spec_of = {"U": None, "C": RXP}
    want_u = run("unconstrained", engs["U"], waves, None, warm=True)[2]
    want_c = run("ab_plus", engs["C"], waves, RXP, warm=True)[2]
    timed = {"U": [], "C": []}
    for arm in ("U", "C", "C", "U"):
        rec, c, out = run("unconstrained" if arm == "U" else "ab_plus",
                          engs[arm], waves, spec_of[arm],
                          want_u if arm == "U" else want_c)
        timed[arm].append(rec)
    tps = {a: [r["tokens_per_s"] for r in rs] for a, rs in timed.items()}
    ms = {a: [r["wall_ms_per_decode_step"] for r in rs]
          for a, rs in timed.items()}
    line(dict(phase="3f", run="constrained_vs_unconstrained",
              order="U C C U", unconstrained_tokens_per_s=tps["U"],
              constrained_tokens_per_s=tps["C"],
              constrained_over_unconstrained=sum(tps["C"]) / sum(tps["U"]),
              reference_bench_bar=0.9,
              unconstrained_wall_ms_per_decode_step=ms["U"],
              constrained_wall_ms_per_decode_step=ms["C"],
              table_bytes=engs["C"]._ctab.bound_bytes(),
              table_rows_used=engs["C"]._ctab.rows_used))
    if engs["C"]._ctab.bound_bytes() != 512 * 256 * 5:
        fail(f"3f table bytes {engs['C']._ctab.bound_bytes()}")
    # (g) the synchronous loop on the same constrained traffic
    sync_c = engine(pipeline=False)
    _, cs, _ = run("ab_plus", sync_c, waves, RXP, want_c, warm=True)
    if (cs["prefill_calls"], cs["decode_chunks"]) != (
            timed["C"][0]["prefill_calls"], timed["C"][0]["decode_chunks"]):
        fail(f"3f (g): the loops made other calls ({cs})")
    del sync_c
    # (b) the schema on (a)'s warm constrained engine: a new grammar
    run("schema", engs["C"], waves, SCHEMA, new_grammar=True)
    # (c) half [ab]+, half none: the unconstrained ones are (a)'s
    mixed = [RXP if i % 2 else None for i in range(len(prompts))]
    _, _, out = run("mixed", engs["C"], waves, mixed)
    bad = [i for i, (a, b, s) in enumerate(zip(out[0], want_u[0], mixed))
           if s is None and not np.array_equal(a, b)]
    if bad:
        fail(f"3f (c): unconstrained requests {bad[:8]} differ from the "
             "unconstrained engine's")
    # the profiled constrained and unconstrained pipelined decode ticks
    prof = {a: profile_decode_tick(torch, engs[a], np.random.default_rng(5),
                                   f"{a}_pipelined", phase="3f",
                                   constrain=spec_of[a])
            for a in ("U", "C")}
    extra, busy = mask_kernels(prof["C"][1], prof["U"][1])
    line(dict(phase="3f", run="mask_cost_decode_chunk", mask_kernels=extra,
              mask_device_ms_per_chunk=busy,
              constrained_tick_wall_s=prof["C"][0],
              unconstrained_tick_wall_s=prof["U"][0]))
    replay_ok = {"decode_c": replay_equals_eager(torch, engs["C"], "decode_c",
                                                 chunk)}
    del engs
    torch.cuda.empty_cache()

    # (d) spec on the aligned tree, constrained, against constrained plain
    aligned = aligned_params(tf, cfg, dev)
    ref = engine(aligned, pipeline=False)
    spec_eng = engine(aligned, pipeline=False, spec_decode=True, spec_k=K,
                      draft="layers:1")
    for g, name in ((RXP, "ab_plus"), (SCHEMA, "schema")):
        want = run(f"aligned_plain_{name}", ref, waves, g,
                   warm=name == "ab_plus")[2]
        run(f"aligned_spec_{name}", spec_eng, waves, g, want,
            warm=name == "ab_plus")
    if spec_eng.counts["decode_chunks"] or spec_eng.spec_k_current != K:
        fail(f"3f (d): the aligned spec engine left K={K}: {spec_eng.counts}")
    replay_ok["spec_c"] = replay_equals_eager(torch, spec_eng, "spec_c", K)
    prof_s = profile_decode_tick(torch, spec_eng, np.random.default_rng(6),
                                 "spec_constrained", phase="3f",
                                 constrain=RXP)
    del ref
    uspec = engine(aligned, pipeline=False, spec_decode=True, spec_k=K,
                   draft="layers:1")
    prof_u = profile_decode_tick(torch, uspec, np.random.default_rng(6),
                                 "spec_unconstrained", phase="3f")
    extra, busy = mask_kernels(prof_s[1], prof_u[1])
    line(dict(phase="3f", run="mask_cost_spec_round", mask_kernels=extra,
              mask_device_ms_per_round=busy))
    del spec_eng, uspec, aligned
    torch.cuda.empty_cache()

    # (e) the paged, chunked and int8-KV paged pools, each pipelined ≡ its
    # synchronous loop; how many requests differ from contiguous one-shot
    # 3c's paged waves; its first wave's first 48 requests on the
    # chunk-256 pool (a pass of the whole wave takes 14 s there)
    first, again = sync["paged"][0]
    contiguous = engine()
    one_shot = [run("paged_contiguous", contiguous, [w], RXP, warm=True)[2][0]
                for w in (first, again)]
    del contiguous
    for name, waves_e, kw, ref_out in (
            ("paged", [first, again], paged, one_shot),
            ("chunked", [first[:48]], dict(paged, prefill_chunk=256),
             [one_shot[0][:48]]),
            ("int8_paged", [prompts], dict(paged, kv_quantize="int8"), None)):
        if ref_out is None:
            ref_out = run("int8_contiguous", engine(kv_quantize="int8",
                                                    pipeline=False),
                          waves_e, RXP, warm=True)[2]
        with CountTwins() as twins:
            want = run(name, engine(pipeline=False, **kw), waves_e, RXP,
                       warm=True)[2]
            _, _, got = run(name, engine(**kw), waves_e, RXP, want,
                            warm=True)
        if twins.calls:
            fail(f"3f (e) {name}: {twins.calls} plain twin calls")
        bad = differ(got, ref_out)
        line(dict(phase="3f", run=f"{name}_vs_contiguous",
                  requests_differing=len(bad),
                  requests=sum(len(w) for w in waves_e)))
        # the float pools under [ab]+ equal the contiguous one-shot engine
        # on this traffic; the int8 pools' prefill paths quantize other
        # rows (printed)
        if bad and name != "int8_paged":
            fail(f"3f (e) {name}: {len(bad)} requests differ from the "
                 f"contiguous one-shot engine: {bad[:8]}")
        torch.cuda.empty_cache()

    # (f) sampled under the mask
    samp = dict(temperature=0.8, top_k=40)
    want = run("sampled", engine(pipeline=False, **samp), waves, RXP,
               warm=True)[2]
    run("sampled", engine(**samp), waves, RXP, want, warm=True)
    del params
    torch.cuda.empty_cache()
    line(dict(phase="3f", run="graphs", replay_equals_eager=replay_ok))
    if not all(replay_ok.values()):
        fail(f"3f masked replay differs from the eager program: {replay_ok}")
    return {k: n for k, n in totals.items() if n}


def phase_constrained_bench(torch, dev):
    """The reference bench's constrained floor config and trace (the
    module docstring, 3f'): printed, with its in-bench asserts."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    # the bench's 8 heads of 24 are a head dim no attention kernel of the
    # port takes (32, 64, 128): 6 heads of 32 keep d_model 192
    cfg = tf.TransformerConfig(vocab_size=256, d_model=192, n_heads=6,
                               n_layers=4, max_len=256)
    params = tf.init_params(cfg, seed=0, device=dev)
    n_req, slots, new, schema_new = 24, 8, 33, 64
    r = np.random.default_rng(1)                 # make_trace(seed + 1)
    events, t = [], 0.0
    for _ in range(n_req):
        t += float(r.exponential(0.002))
        events.append((t, r.integers(0, 256, int(r.integers(8, 49))).astype(
            np.int32)))

    def replay(eng, constrain, max_new):
        recs, pending, i = [], [], 0
        t0 = time.perf_counter()
        while i < len(events) or pending:
            now = time.perf_counter() - t0
            while i < len(events) and events[i][0] <= now:
                pending.append(eng.submit(events[i][1], max_new_tokens=max_new,
                                          constrain=constrain))
                i += 1
            worked = eng.tick()
            recs += [h for h in pending if h.done()]
            pending = [h for h in pending if not h.done()]
            if not worked and i < len(events):
                time.sleep(max(0.0, min(0.002, events[i][0]
                                        - (time.perf_counter() - t0))))
        elapsed = time.perf_counter() - t0
        return sum(h.generated.shape[0] for h in recs) / elapsed, recs

    arms = (("unconstrained", None, new), ("constrained_regex", RXP, new),
            ("constrained_schema", SCHEMA, schema_new))
    engs = {a: InferenceEngine(cfg, params, EngineConfig(
        max_batch_size=slots, max_queue=4 * n_req, max_new_tokens=schema_new,
        degrade_queue_depth=10 ** 6, decode_chunk=8), device=dev)
        for a, _, _ in arms}
    for a, c, n in arms:                          # cold: every capture
        replay(engs[a], c, n)
    captures = {a: e.counts["graph_captures"] for a, e in engs.items()}
    best = {a: (0.0, None) for a, _, _ in arms}
    for rep in range(3):
        for k in range(len(arms)):
            a, c, n = arms[(rep + k) % len(arms)]
            tps, recs = replay(engs[a], c, n)
            if tps > best[a][0]:
                best[a] = (tps, recs)
    for a, e in engs.items():
        if e.counts["graph_captures"] != captures[a]:
            fail(f"3f' {a}: a warm replay captured a graph")
    for h in best["constrained_regex"][1]:
        if h.generated.shape[0] != new or not set(
                h.generated.tolist()) <= {97, 98}:
            fail("3f' regex-constrained tokens illegal or short")
    for h in best["constrained_schema"][1]:
        doc = json.loads(bytes(h.generated.tolist()).decode())
        if not set(doc) <= set(SCHEMA["schema"]["properties"]):
            fail(f"3f' schema output {doc!r}")
    if len(best["constrained_schema"][1]) != n_req:
        fail("3f' schema-valid outputs below 100%")
    tps = {a: b[0] for a, b in best.items()}
    line(dict(phase="3f'", config="constrained_decode_4L192d_Ns8",
              dtype=cfg.dtype, n_heads=cfg.n_heads, reference_n_heads=8,
              requests=n_req, slots=slots,
              tokens_per_sec=tps,
              tokens_per_sec_constrained=tps["constrained_regex"],
              overhead_ratio=tps["constrained_regex"] / tps["unconstrained"],
              reference_bench_bar=0.9, schema_valid_pct=100.0,
              captures=captures))
    del engs, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 1q: the quantized decode and window entries vs their plain twins
# ---------------------------------------------------------------------------

def quant_stacked_cache(torch, dev, g, L, B, S, D, layer, kv_mode):
    """A stacked [L, B, S, D] int8 / e4m3 cache and its [L, B, S, 1]
    float32 row scales, layer ``layer`` quantized from random rows (the
    other layers as an unwritten pool: values 0, scales 1.0)."""
    from deeplearning4j_tpu_torch.quant.kv import (kv_cache_dtype,
                                                   quantize_rows)
    c = torch.zeros((L, B, S, D), dtype=kv_cache_dtype(kv_mode), device=dev)
    sc = torch.ones((L, B, S, 1), dtype=torch.float32, device=dev)
    vals, scales = quantize_rows(
        torch.randn((B, S, D), generator=g).to(dev), kv_mode)
    c[layer].view(torch.uint8).copy_(vals.view(torch.uint8))
    sc[layer, ..., 0] = scales
    return c, sc


def quant_bound(rows: int, B: int, D: int, q_esz: int, t: int = 1,
                vec_pos: bool = True):
    """Least time of a quantized decode / window call: one byte a cache
    element (K and V) and one float32 scale a cache row each, read once;
    q read and o written once; pos read; the products on the CUDA cores
    in float32 (4 operations a cache element a query row)."""
    nbytes = 2 * rows * D + 2 * rows * 4 + 2 * B * t * D * q_esz + \
        (B * 4 if vec_pos else 0)
    return nbytes, bound(nbytes, 4 * rows * D * t, "float32")


def phase_quant_kernels(torch, dev):
    """The quantized decode entry at the serving decode shape (B=64,
    S=2048, D=512, H=8, Dh 64) on the stacked L=12 cache at layer 5,
    int8 and e4m3 caches under bf16 and float32 q, at phase 1's mixed
    vector, pos 2047 and pos 100; then the quantized window entry at
    T=5 and 8 with every row torch.equal to the decode entry at pos + t.
    Gates: bf16 rows within 2^-7 of the plain twin's row maximum, float32
    within 1e-5, two calls bit-equal. Prints the kernel's, the twin's and
    SDPA's time over the dequantized bf16 cache (another function, which
    reads twice the bytes) beside the bound."""
    from deeplearning4j_tpu_torch.benchmarks import _timing
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(11)
    L, B, S, D, H, layer = 12, 64, 2048, 512, 8, 5
    Dh = D // H
    pos_v = torch.from_numpy(np.random.default_rng(0).integers(
        0, S, size=B).astype(np.int32))
    pos_v[0], pos_v[1] = 0, S - 1
    pos_v = pos_v.to(dev)
    keys = torch.arange(S, device=dev)
    out = {}
    for kv_mode in ("int8", "fp8"):
        ck, ksc = quant_stacked_cache(torch, dev, g, L, B, S, D, layer,
                                      kv_mode)
        cv, vsc = quant_stacked_cache(torch, dev, g, L, B, S, D, layer,
                                      kv_mode)
        kw = dict(k_scale=ksc[layer, ..., 0], v_scale=vsc[layer, ..., 0])
        # the dequantized bf16 cache SDPA reads (twice the bytes)
        kl = (ck[layer].float() * ksc[layer]).to(torch.bfloat16).view(
            B, S, H, Dh).transpose(1, 2)
        vl = (cv[layer].float() * vsc[layer]).to(torch.bfloat16).view(
            B, S, H, Dh).transpose(1, 2)
        for qdt in (torch.bfloat16, torch.float32):
            qname = str(qdt).split(".")[-1]
            qd = torch.randn((B, H, Dh), generator=g).to(dev, qdt)
            for pos, pname in ((pos_v, "vector [0..2047]"), (S - 1, S - 1),
                               (100, 100)):
                def call():
                    return fd.decode_attention_q_cuda(
                        qd, ck, cv, pos, H, ksc, vsc, layer=layer)
                got = call()
                want = fd.reference_decode_attention(
                    qd, ck[layer], cv[layer], pos, H, **kw)
                err = max_err(got, want)
                if qdt == torch.float32:
                    rel, ok, tol = None, err <= 1e-5, 1e-5
                else:
                    rel = row_rel_err(got, want)
                    ok, tol = rel <= 1.0, BF16_TOL
                if not ok:
                    fail(f"quantized decode {kv_mode} q {qname} pos {pname}: "
                         f"max err {err}, row-relative {rel}")
                if not torch.equal(got, call()):
                    fail(f"quantized decode {kv_mode} q {qname} pos {pname}:"
                         " two calls differ")
                rows = int((torch.as_tensor(pos).clamp(0, S - 1).long() + 1)
                           .expand(B).sum())
                nbytes, (b_ms, b_by) = quant_bound(
                    rows, B, D, qd.element_size(),
                    vec_pos=not isinstance(pos, int))
                rec = dict(phase="1q", kernel="decode_attention_q",
                           cache=kv_mode, q_dtype=qname, shape=[L, B, S, D],
                           layer=layer, pos=pname, max_abs_err=err,
                           row_rel_err=rel, tol=tol, two_calls_equal=True,
                           kernel_ms=time_ms(call),
                           kernel_graph_ms=_timing.time_ms(call, dev, 20, 3),
                           plain_ms=time_ms(
                               lambda: fd.reference_decode_attention(
                                   qd, ck[layer], cv[layer], pos, H, **kw),
                               iters=3),
                           bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                           library_ms=None)
                if qdt == torch.bfloat16:
                    ql = qd.view(B, H, 1, Dh)
                    if isinstance(pos, int):
                        sdpa = (lambda p=pos: F.scaled_dot_product_attention(
                            ql, kl[:, :, :p + 1], vl[:, :, :p + 1]))
                    else:
                        mask = (keys[None, :] <= pos[:, None].long())[
                            :, None, None]
                        sdpa = (lambda m=mask: F.scaled_dot_product_attention(
                            ql, kl, vl, attn_mask=m))
                    # another function: SDPA over the dequantized bf16
                    # cache, which reads two bytes a cache element
                    rec["sdpa_on_dequantized_bf16_ms"] = time_ms(sdpa)
                line(rec)
                if pname == S - 1 and qname == "bfloat16":
                    out[f"decode_attention_q/{kv_mode}"] = rec
        # the window entry, each row against the decode entry
        for qdt in (torch.bfloat16, torch.float32):
            qname = str(qdt).split(".")[-1]
            for t in (5, 8):
                q = torch.randn((B, t, H, Dh), generator=g).to(dev, qdt)

                def wcall():
                    return fd.decode_window_attention_q_cuda(
                        q, ck, cv, pos_v, H, ksc, vsc, layer=layer)
                got = wcall()
                want = fd.reference_window_attention(
                    q, ck[layer], cv[layer], pos_v, H, **kw)
                err = max_err(got, want)
                if qdt == torch.float32:
                    rel, ok, tol = None, err <= 1e-5, 1e-5
                else:
                    rel = row_rel_err(got, want)
                    ok, tol = rel <= 1.0, BF16_TOL
                if not ok or not torch.equal(got, wcall()):
                    fail(f"quantized window {kv_mode} q {qname} T={t}: max "
                         f"err {err}, row-relative {rel} (or two calls "
                         f"differ)")
                for ti in range(t):
                    row = fd.decode_attention_q_cuda(
                        q[:, ti].contiguous(), ck, cv, pos_v + ti, H, ksc,
                        vsc, layer=layer)
                    if not torch.equal(got[:, ti], row):
                        fail(f"quantized window {kv_mode} q {qname} T={t}: "
                             f"row {ti} differs from the decode entry at "
                             f"pos+{ti} by {max_err(got[:, ti], row)}")
                wp = torch.clamp(pos_v[:, None] + torch.arange(t, device=dev),
                                 0, S - 1)
                rows = int((wp[:, -1].long() + 1).sum())
                nbytes, (b_ms, b_by) = quant_bound(rows, B, D,
                                                   q.element_size(), t)
                rec = dict(phase="1q", kernel="decode_window_q",
                           cache=kv_mode, q_dtype=qname, shape=[L, B, S, D],
                           window=t, layer=layer, pos="phase 1's vector",
                           max_abs_err=err, row_rel_err=rel, tol=tol,
                           rows_equal_decode_entry=True,
                           two_calls_equal=True, kernel_ms=time_ms(wcall),
                           plain_ms=time_ms(
                               lambda: fd.reference_window_attention(
                                   q, ck[layer], cv[layer], pos_v, H, **kw),
                               iters=3),
                           bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                           cta_groups=-(-t // fd.DECODE_Q_WINDOW_GROUP),
                           library_ms=None)
                line(rec)
                if t == 8 and qname == "bfloat16":
                    out[f"decode_window_q/{kv_mode}"] = rec
        del ck, cv, ksc, vsc, kl, vl
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 2d and 3d: quantized serving
# ---------------------------------------------------------------------------

class CountTwins:
    """Counts, while entered, the calls of every plain attention path a
    card run must not take: the decode and window twins, the flash
    forward and backward twins, and torch's scaled_dot_product_attention
    (the port calls it nowhere; phases time it as a yardstick outside
    this). The port sends only CPU tensors to the twins."""

    def __init__(self):
        import torch.nn.functional as F
        from deeplearning4j_tpu_torch.ops import flash_attention as fa
        from deeplearning4j_tpu_torch.ops import flash_decode as fd
        self.sites = [(fd, "reference_decode_attention"),
                      (fd, "reference_window_attention"),
                      (fa, "flash_forward_reference"),
                      (fa, "flash_backward_reference"),
                      (F, "scaled_dot_product_attention")]
        self.calls = 0

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.sites]
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, self._counted(fn))
        return self

    def _counted(self, fn):
        def counted(*a, **k):
            self.calls += 1
            return fn(*a, **k)
        return counted

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.sites, self.saved):
            setattr(m, n, fn)
        return False


QUANT_COUNTERS = ("decode_attention_q_cuda", "decode_window_attention_q_cuda",
                  "decode_attention_cuda", "decode_window_attention_cuda")


def phase_quant_f32_card_vs_cpu(torch, dev):
    """Phase 2's 2-layer 512d float32 model and 8 greedy requests (16 new):
    the int8 engine (quantize and kv_quantize "int8") card ≡ CPU; spec
    (K=4, the "int8" drafter on the float tree, int8 KV) ≡ plain int8 KV
    on the card; paged int8 (page 16, prefix cache off) ≡ contiguous
    int8; chunked int8 (prefill_chunk 32) ≡ one-shot int8. Every card arm
    runs the quantized kernels only: the float decode and window kernels
    and the plain twins never."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    params = {d: tf.init_params(cfg, seed=1, device=d)
              for d in (dev, torch.device("cpu"))}
    q8 = dict(quantize="int8", kv_quantize="int8")

    def serve(d, **kw):
        eng = InferenceEngine(cfg, params[d], EngineConfig(
            num_slots=8, decode_chunk=8, max_new_tokens=16, **kw), device=d)
        for name in QUANT_COUNTERS:
            getattr(fd, name).launches = 0
        with CountTwins() as twins:
            hs = [eng.submit(p) for p in prompts]
            eng.run_pending()
        n = {name: getattr(fd, name).launches for name in QUANT_COUNTERS}
        if d.type == "cuda" and (twins.calls or n["decode_attention_cuda"]
                                 or n["decode_window_attention_cuda"]
                                 or not n["decode_attention_q_cuda"]):
            fail(f"2d {kw}: launches {n}, plain twin calls {twins.calls}")
        return eng, [h.result() for h in hs], n

    arms = {"int8_cuda": serve(dev, **q8),
            "int8_cpu": serve(torch.device("cpu"), **q8),
            "kv8_plain": serve(dev, kv_quantize="int8"),
            "kv8_spec_int8_drafter": serve(dev, kv_quantize="int8",
                                           spec_decode=True, spec_k=4),
            "int8_paged": serve(dev, paged=True, page_size=16,
                                prefix_cache=False, **q8),
            "int8_chunked": serve(dev, prefill_chunk=32, **q8)}

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(arms[a][1],
                                                        arms[b][1]))
    gates = {"card_equals_cpu": same("int8_cuda", "int8_cpu"),
             "spec_equals_plain": same("kv8_spec_int8_drafter", "kv8_plain"),
             "paged_equals_contiguous": same("int8_paged", "int8_cuda"),
             "chunked_equals_one_shot": same("int8_chunked", "int8_cuda")}
    spec = arms["kv8_spec_int8_drafter"][0]
    line(dict(phase="2d", requests=len(prompts), new_tokens=16, gates=gates,
              spec_rounds=spec.counts["spec_rounds"],
              acceptance=spec.counts["spec_accepted"]
              / max(1, spec.counts["spec_drafted"]),
              launches={a: v[2] for a, v in arms.items() if "cpu" not in a}))
    bad = [k for k, v in gates.items() if not v]
    if bad:
        fail(f"2d quantized float32 serving: {bad} failed")


def phase_quant_full_width(torch, dev, plain_out, plain_ms_per_step):
    """Phase 3's config and 128 requests (64 new) on the quantized engine:
    (a) int8 weights and KV, (b) fp8 both (resolving to e4m3 on the card),
    (c) spec K=7 with the default "int8" drafter on the float tree and
    the default adaptive K, (d) spec on the int8 engine (the drafter
    shares its tree), (e) the paged int8 pool on phase 3c's traffic
    (prefix hits, copy-on-write). Gates: every result well formed; (c) ≡
    phase 3's bf16 plain engine, (d) ≡ (a); (d) accepts every draft its
    budgets allow, K stays 7; exact launches (the quantized decode entry
    n_layers x chunk per decode chunk and n_layers x the round's K per
    spec round, the quantized window n_layers per round; the float
    decode and window kernels and the plain twins never on a quantized
    pool); (e) hits and copies in the second wave, no page leaked.
    Prints tokens/s and ms a decode step beside phase 3's, param and
    pool bytes against the bf16 engine's, and one profiled quantized
    decode chunk. Returns the launches by kernel summary name."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L, chunk, new, K = cfg.n_layers, 8, 64, 7
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, size=128)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens]
    params = tf.TransformerLM(cfg, seed=0, device=dev).params
    base = dict(num_slots=64, decode_chunk=chunk, max_new_tokens=new,
                max_queue=256, degrade_queue_depth=1024, pipeline=False)
    q8 = dict(quantize="int8", kv_quantize="int8")
    launches = {"decode_attention_q": 0, "decode_window_q": 0}
    results = {}

    def arm(name, waves, **kw):
        eng = InferenceEngine(cfg, params, EngineConfig(**{**base, **kw}),
                              device=dev)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CountTwins() as twins:
            out, _ = serve_waves(eng, waves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        n = {k: got[k] for k in ("decode_attention_q", "decode_window_q",
                                 "decode_attention", "decode_window")}
        n_flash = got["flash_fwd"]
        for prompts_w, res in zip(waves, out):
            for p, r in zip(prompts_w, res):
                if r.shape != (p.shape[0] + new,) or \
                        not np.array_equal(r[:p.shape[0]], p) or \
                        r.min() < 0 or r.max() >= cfg.vocab_size:
                    fail(f"3d {name}: bad result of shape {r.shape}")
        c = eng.counts
        chunks, rounds = c["decode_chunks"], c["spec_rounds"]
        if twins.calls:
            fail(f"3d {name}: {twins.calls} plain twin calls")
        check_launches(eng, c, L, got, f"3d {name}")
        launches["decode_attention_q"] += n["decode_attention_q"]
        launches["decode_window_q"] += n["decode_window_q"]
        n_tok = sum(len(w) for w in waves) * new
        rec = dict(phase="3d", arm=name, quantize=eng._qmode,
                   kv_quantize=eng._kv_mode,
                   pool_dtype=str(eng._slot_state[0].dtype),
                   requests=sum(len(w) for w in waves), new_tokens=new,
                   wall_s=wall, tokens_per_s=n_tok / wall,
                   prefill_calls=c["prefill_calls"],
                   prefill_s=eng.seconds["prefill"], decode_chunks=chunks,
                   decode_s=eng.seconds["decode"],
                   param_bytes=c["param_bytes"],
                   kv_pool_bytes=c["kv_pool_bytes"], launches=n,
                   flash_launches=n_flash, plain_twin_calls=twins.calls,
                   graph_captures=c["graph_captures"],
                   graph_replays=c["graph_replays"])
        if chunks:
            rec["ms_per_decode_step"] = (eng.seconds["decode"]
                                         / (chunk * chunks) * 1e3)
        if rounds:
            rec.update(spec_rounds=rounds, spec_k=K,
                       spec_draft_steps=c["spec_draft_steps"],
                       ms_per_spec_round=eng.seconds["spec"] / rounds * 1e3,
                       drafted=c["spec_drafted"], accepted=c["spec_accepted"],
                       acceptance=c["spec_accepted"] / c["spec_drafted"],
                       spec_k_final=eng.spec_k_current)
        if eng.config.paged:
            rec.update(prefix_hits=c["prefix_hits"],
                       prefix_shared_tokens=c["prefix_shared_tokens"],
                       cow_copies=c["cow_copies"],
                       pages_used=c["pages_used"],
                       prefix_cache_pages=eng.prefix_cache_pages)
        line(rec)
        results[name] = out
        return eng, rec

    eng_a, rec_a = arm("int8", [prompts], **q8)
    _, rec_b = arm("fp8", [prompts], quantize="fp8", kv_quantize="fp8")
    if (rec_b["quantize"], rec_b["kv_quantize"], rec_b["pool_dtype"]) != \
            ("fp8", "fp8", "torch.float8_e4m3fn"):
        fail(f"3d fp8 arm did not resolve to e4m3 on the card: {rec_b}")
    _, rec_c = arm("spec_int8_drafter", [prompts], spec_decode=True,
                   spec_k=K)
    eng_d, rec_d = arm("spec_int8_engine", [prompts], spec_decode=True,
                       spec_k=K, **q8)
    bad_c = [i for i, (a, b) in enumerate(zip(results["spec_int8_drafter"][0],
                                               plain_out)) if
             not np.array_equal(a, b)]
    bad_d = [i for i, (a, b) in enumerate(zip(results["spec_int8_engine"][0],
                                               results["int8"][0])) if
             not np.array_equal(a, b)]
    # every draft accepted where the budget lets it: a request's 63
    # tokens after its first take ceil(63 / 8) rounds, each accepting
    # all but the token it commits past its drafts
    n_rounds = -(-(new - 1) // (K + 1))
    want_acc = len(prompts) * ((new - 1) - n_rounds)
    line(dict(phase="3d", run="spec_gates", spec_int8_drafter_vs_plain_bf16=
              f"{len(plain_out) - len(bad_c)}/{len(plain_out)} equal",
              spec_int8_engine_vs_int8_plain=
              f"{len(prompts) - len(bad_d)}/{len(prompts)} equal",
              int8_engine_accepted=rec_d["accepted"],
              accepted_if_every_draft_matches=want_acc,
              int8_engine_spec_k_final=rec_d["spec_k_final"]))
    if bad_c:
        fail(f"3d spec with the int8 drafter differs from the bf16 plain "
             f"engine in requests {bad_c[:8]} ({len(bad_c)})")
    if bad_d or rec_d["accepted"] != want_acc or rec_d["spec_k_final"] != K:
        fail(f"3d spec on the int8 engine: {len(bad_d)} requests differ "
             f"from plain int8, accepted {rec_d['accepted']} of {want_acc}, "
             f"K {rec_d['spec_k_final']}")
    first = paged_traffic(rng, 96, 32, 512, (16, 512), (16, 1024))
    again = [first[i] for i in rng.choice(len(first), size=32,
                                          replace=False)]
    eng_e, rec_e = arm("paged_int8", [first, again], paged=True, page_size=16,
                       kv_pages=3072 + 1, **q8)
    if not (rec_e["prefix_hits"] > 0 and rec_e["cow_copies"] > 0):
        fail(f"3d paged int8: {rec_e['prefix_hits']} hits, "
             f"{rec_e['cow_copies']} copies")
    if rec_e["pages_used"] != rec_e["prefix_cache_pages"]:
        fail(f"3d paged int8 leaked pages: {rec_e['pages_used']} used, "
             f"{rec_e['prefix_cache_pages']} held by the prefix cache")
    bf16 = InferenceEngine(cfg, params, EngineConfig(**base), device=dev)
    bf16_paged = InferenceEngine(cfg, params, EngineConfig(
        **base, paged=True, page_size=16, kv_pages=3072 + 1), device=dev)
    line(dict(phase="3d", run="bytes",
              param_bytes={"bf16": bf16.counts["param_bytes"],
                           "int8": rec_a["param_bytes"],
                           "fp8": rec_b["param_bytes"]},
              kv_pool_bytes={"bf16": bf16.counts["kv_pool_bytes"],
                             "int8": rec_a["kv_pool_bytes"],
                             "fp8": rec_b["kv_pool_bytes"],
                             "bf16_paged": bf16_paged.counts["kv_pool_bytes"],
                             "int8_paged": rec_e["kv_pool_bytes"]},
              ms_per_decode_step={"phase3_bf16": plain_ms_per_step,
                                  "int8": rec_a.get("ms_per_decode_step"),
                                  "fp8": rec_b.get("ms_per_decode_step"),
                                  "paged_int8": rec_e.get(
                                      "ms_per_decode_step")},
              tokens_per_s={a: r["tokens_per_s"] for a, r in (
                  ("int8", rec_a), ("fp8", rec_b),
                  ("spec_int8_drafter", rec_c),
                  ("spec_int8_engine", rec_d), ("paged_int8", rec_e))}))
    del bf16, bf16_paged, eng_e
    profile_decode_tick(torch, eng_a, rng, "int8", phase="3d")
    del eng_a
    # a spec round on the int8 pool: the quantized window and draft decode
    profile_decode_tick(torch, eng_d, rng, "int8_spec", phase="3d")
    del eng_d, params
    torch.cuda.empty_cache()
    return launches, ([prompts], results["int8"])


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
            # float32: the same SIMT loop, bit for bit; bf16: production
            # is the tensor-core split-S core (another design), so the
            # forced point is held to it and to its twin per row
            if dtype == torch.float32:
                ok = torch.equal(own, prod)
            else:
                ok = max(row_rel_err(own, prod), row_rel_err(
                    own, fd.reference_split_decode_attention(
                        qd, ck[1], cv[1], pos, H, S))) <= 1.0
            if not ok:
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


# B, T, L, D, H, V of the flagship train step (4b, 4c)
FLAGSHIP_TRAIN = (16, 2048, 12, 512, 8, 256)


def phase_train_full_width(torch, dev, timed_steps: int = 5,
                           n_experts: int = 0):
    """4b, and with ``n_experts`` 4c (the flagship step with that many
    experts at capacity 1.25; see the module docstring). Returns the
    launches by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import flash_decode as fd
    from deeplearning4j_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from deeplearning4j_tpu_torch.parallel.optim import init_adam_state
    phase = "4c" if n_experts else "4b"
    # benchmarks/flagship.py:70-80, the transformer_lm_12L512d_T2048 row
    B, T, L, D, H, V, E = (*FLAGSHIP_TRAIN, n_experts)
    cfg = tf.TransformerConfig(vocab_size=V, d_model=D, n_heads=H,
                               n_layers=L, max_len=T, dtype="bfloat16",
                               remat=True, remat_policy="full",
                               n_experts=E)
    params = tf.init_params(cfg, seed=0, device=dev)
    rec = dict(phase=phase, config="transformer_lm_12L512d_T2048"
               + (f", {E} experts" if E else ""))
    if E:
        # two forward and backward calls of the MoE MLP at this shape
        p0 = {k: v[0] for k, v in params["blocks"].items()}
        rec.update(capacity_factor=cfg.capacity_factor,
                   moe_mlp_bit_equal=moe_mlp_bit_equal(
                       torch, tf, p0, cfg, (B, T, D), dev, backward=True))
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
    with CountTwins() as twins:
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
    # benchmarks/flagship.py:109-113: train = 3x forward, causal attention;
    # top-1 sends each token through one expert (the dense MLP's FLOPs),
    # plus the router's 2 D E a layer
    p_mat = L * 12 * D * D + D * V
    flops_tok = 3 * (2 * p_mat + 2 * L * T * D + 2 * L * D * E)
    rec.update(batch=B, seq=T, remat="full", timed_steps=timed_steps,
               ms_per_step=ms, tokens_per_s=tok_s,
               model_flops_per_token=flops_tok,
               bf16_peak_share=tok_s * flops_tok / PEAK_FLOPS["bfloat16"],
               warm_loss=float(warm_loss), losses=losses,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               flash_fwd_launches=n_fwd, flash_bwd_launches=n_bwd,
               decode_launches=n_dec,
               flash_fwd_per_step=n_fwd / timed_steps,
               flash_bwd_per_step=n_bwd / timed_steps,
               plain_attention_calls=twins.calls)
    line(rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{phase} training losses {losses}: not finite or not falling")
    if n_fwd != 2 * L * timed_steps or n_bwd != L * timed_steps or n_dec \
            or twins.calls:
        fail(f"{phase} train launch counts flash_fwd={n_fwd} "
             f"flash_bwd={n_bwd} decode={n_dec} plain={twins.calls} over "
             f"{timed_steps} steps, L={L}")
    if not rec.get("moe_mlp_bit_equal", True):
        fail("4c: two calls of the MoE MLP's forward and backward differ")
    wall, rows, host = profiled(torch,
                                lambda: step(params, opt, toks, tgts))
    profile_line(wall, rows, host, phase=phase, run="profiled_train_step")
    del params, opt
    torch.cuda.empty_cache()
    return {"flash_fwd": n_fwd, "flash_bwd": n_bwd}


# ---------------------------------------------------------------------------
# phases 2f, 3g and 4c: the mixture-of-experts TransformerLM
# ---------------------------------------------------------------------------

class RouteDrops:
    """The tokens every MoE call routes and the ones its capacity drops,
    by call kind, while entered: each call's routing recomputed from its
    inputs by `models.transformer.moe_route`. A call on one position a
    row (h [B, 1, D]) is "decode", any other ``prefill`` (set by the
    caller to name the prefill path). The MLP is wrapped where the model
    and the slot programs look it up; a CUDA graph replay runs no Python,
    so an engine measured here runs eagerly (``eng._graphs = None``)."""

    def __init__(self, prefill: str = "prefill"):
        self.prefill = prefill
        self.n = {}

    def __enter__(self):
        from deeplearning4j_tpu_torch.models import transformer as tf
        from deeplearning4j_tpu_torch.parallel import serving as sv
        self.mods, self.saved = (tf, sv), tf.moe_mlp

        def counted(h, p, cfg, valid=None):
            place, keep = tf.moe_route(h, p, cfg, valid)[3:5]
            kind = "decode" if h.shape[1] == 1 else self.prefill
            acc = self.n.setdefault(kind, [0, 0])
            acc[0] = acc[0] + (place >= 0).sum()
            acc[1] = acc[1] + (place >= 0).sum() - keep.sum()
            return self.saved(h, p, cfg, valid=valid)

        for m in self.mods:
            m.moe_mlp = counted
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.moe_mlp = self.saved
        return False

    def shares(self):
        """{kind: routed, dropped and the dropped share}."""
        out = {}
        for kind, (routed, dropped) in self.n.items():
            r, d = int(routed), int(dropped)
            out[kind] = dict(routed=r, dropped=d,
                             dropped_share=d / r if r else 0.0)
        return out


# phase 2's float32 model with 4 experts at capacity 0.5: a decode step of
# 8 slots gives each expert max(1, int(0.5 * 8 / 4)) = 1 place
MOE_F32 = dict(vocab_size=256, d_model=512, n_heads=8, n_layers=2,
               max_len=2048, dtype="float32", n_experts=4,
               capacity_factor=0.5)


def phase_moe_f32_card_vs_cpu(torch, dev):
    """2f. Phase 2's 2-layer 512d float32 model with 4 experts at capacity
    0.5 (drops at every call kind) and its 8 prompts, 16 new tokens, one
    tree on the card and on the CPU. Arms: contiguous (synchronous and
    pipelined), paged (page 16, prefix cache, the 8 prompts twice),
    chunked (prefill_chunk 32) and constrained (half the requests under
    ``[ab]+``): the card's greedy tokens equal the CPU's in every arm;
    `generate` (B=8, T0=8, 16 new) the same. The CPU runs count the
    drops per call kind (`RouteDrops`): some must drop. Then two Adam
    steps of phase 4a's model with these experts, card vs CPU: losses
    within 1e-4, parameters by `adam_close`."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from deeplearning4j_tpu_torch.parallel.optim import (init_adam_state,
                                                         tree_leaves)
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(**MOE_F32)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    sides = (("card", dev), ("cpu", cpu))
    params = {k: tf.init_params(cfg, seed=1, device=d) for k, d in sides}
    base = dict(num_slots=8, decode_chunk=8, max_new_tokens=16)
    arms = {"contiguous": ({}, [prompts], None),
            "pipelined": (dict(pipeline=True), [prompts], None),
            "paged": (dict(paged=True, page_size=16, kv_pages=160),
                      [prompts, prompts], None),
            "chunked": (dict(prefill_chunk=32), [prompts], "prefill_chunk"),
            "constrained": ({}, [prompts], None)}
    same, drops = {}, {}
    for name, (kw, waves, kind) in arms.items():
        outs = {}
        for side, d in sides:
            eng = InferenceEngine(cfg, params[side], EngineConfig(
                **{"pipeline": False, **base, **kw}), device=d)
            spec = [RXP if i % 2 else None for i in range(len(prompts))] \
                if name == "constrained" else [None] * len(prompts)
            with RouteDrops(kind or f"{name}_prefill") as rd:
                res = []
                for w in waves:
                    hs = [eng.submit(p, constrain=s) for p, s in zip(w, spec)]
                    eng.run_pending()
                    res += [h.result() for h in hs]
            outs[side] = res
            if side == "cpu":
                drops[name] = rd.shares()
        if name == "constrained":
            check_constrained("2f constrained", [
                (p, s, 16) for p, s in zip(prompts, spec)], outs["card"])
        same[name] = all(np.array_equal(a, b) for a, b in
                         zip(outs["card"], outs["cpu"]))
    batch = np.stack([p[:8] for p in prompts])
    gen = {}
    for side, d in sides:
        with RouteDrops("generate_prefill") as rd:
            gen[side] = tf.generate(cfg, params[side], torch.from_numpy(
                batch).to(d), 16, temperature=0.0).cpu()
        if side == "cpu":
            drops["generate"] = rd.shares()
    same["generate"] = torch.equal(gen["card"], gen["cpu"])

    # two Adam steps (phase 4a's model and batch, these experts)
    tcfg = tf.TransformerConfig(**{**MOE_F32, "max_len": 256, "remat": True,
                                   "remat_policy": "full"})
    lr, steps = 1e-3, 2
    toks = np.random.default_rng(3).integers(0, 256, size=(2, 256))
    tgts = np.roll(toks, -1, axis=1)
    runs = {}
    for side, d in sides:
        p = tf.init_params(tcfg, seed=2, device=d)
        opt = init_adam_state(p)
        step = make_fsdp_train_step(tcfg, device=d, learning_rate=lr)
        losses = []
        for _ in range(steps):
            p, opt, loss = step(p, opt, toks, tgts)
            losses.append(float(loss))
        runs[side] = (losses, tree_leaves(p))
    loss_err = max(abs(a - b) for a, b in zip(runs["card"][0],
                                              runs["cpu"][0]))
    checks = [adam_close(a, b, lr, steps, 1e-4)
              for a, b in zip(runs["card"][1], runs["cpu"][1])]
    routed_drops = {a: {k: v["dropped"] for k, v in s.items()}
                    for a, s in drops.items()}
    line(dict(phase="2f", config="phase 2's f32 model, 4 experts, "
              "capacity 0.5", requests=len(prompts), new_tokens=16,
              tokens_equal=same, drops_cpu=drops,
              train_steps=steps, losses_cuda=runs["card"][0],
              losses_cpu=runs["cpu"][0], loss_max_abs_err=loss_err,
              loss_tol=1e-4, param_max_abs_err=max(c[0] for c in checks),
              param_share_beyond_tol=max(c[1] for c in checks)))
    bad = [k for k, v in same.items() if not v]
    if bad:
        fail(f"2f float32 MoE: card tokens differ from the CPU's in {bad}")
    if not all(any(v > 0 for v in s.values())
               for s in routed_drops.values()):
        fail(f"2f float32 MoE: an arm dropped no token: {routed_drops}")
    if not loss_err <= 1e-4 or not all(c[2] for c in checks):
        fail(f"2f float32 MoE training differs card vs CPU: losses "
             f"{loss_err}, params {checks}")


# phase 3's flagship decode config with 8 experts at JAX's default
# capacity (Switch-style top-1)
MOE_FLAGSHIP = dict(vocab_size=256, d_model=512, n_heads=8, n_layers=12,
                    max_len=2048, dtype="bfloat16", n_experts=8,
                    capacity_factor=1.25)


def moe_mlp_bit_equal(torch, tf, p, cfg, shape, dev, backward=False):
    """Two calls of `moe_mlp` (and, with ``backward``, of its backward)
    on one seeded bf16 input of ``shape`` and layer weights ``p``:
    whether outputs (and gradients) are torch.equal."""
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(shape[-1], generator=g).to(dev, torch.bfloat16)
    runs = []
    for _ in range(2):
        xi = x.clone().requires_grad_(backward)
        pi = {k: v.detach().clone().requires_grad_(backward)
              for k, v in p.items() if k in ("router", "We1", "We2")}
        with torch.set_grad_enabled(backward):
            y = tf.moe_mlp(xi, pi, cfg)
            out = [y.detach()]
            if backward:
                (y.float() * w.float()).sum().backward()
                out += [xi.grad] + [pi[k].grad for k in sorted(pi)]
        runs.append(out)
    return all(torch.equal(a, b) for a, b in zip(*runs))


def phase_moe_full_width(torch, dev, sync):
    """3g. Phase 3's config with 8 experts at capacity 1.25 (MOE_FLAGSHIP;
    ``sync``: phase 3's and 3c's traffic, arm -> (waves, results)), 64
    slots, chunk 8. (a) Phase 3's 128 requests on the MoE and the dense
    engine, both loops, a warm pass each, then timed passes in turns S P
    P S (dense then MoE in each turn): tokens/s and ms a step; (b) 3c's
    paged waves, (c) its chunk-256 paged arm on the first 48 requests of
    its first wave (3f's cut), (d) int8 weights and KV on phase 3's
    traffic, each synchronous then pipelined; (e) the share of routed
    tokens dropped per call kind, from eager passes of (a)-(c) and of
    `generate` (B=64, T0=64, 128 new) under `RouteDrops`; (f) one
    profiled pipelined decode tick of each model: device ms, idle share,
    host launch calls. Gates: pipelined ≡ sync token-exact in every arm;
    the eager contiguous pass ≡ the graph one; replay ≡ eager for the
    MoE decode chunk; two calls of the MoE MLP bit-equal at the decode
    and prefill shapes; launches exact (flash L per one-shot prefill;
    decode L x 8 a chunk on each profiled trace; generate L flash and
    L x 127 decode) and no plain twin nor SDPA called; no capture after
    a warm pass; no page leaked. Paged and chunked against contiguous:
    printed (prefix hits and chunking rebind the capacity). Returns the
    launches by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = tf.TransformerConfig(**MOE_FLAGSHIP)
    dense_cfg = tf.TransformerConfig(**{
        k: v for k, v in MOE_FLAGSHIP.items()
        if k not in ("n_experts", "capacity_factor")})
    L, chunk, new = cfg.n_layers, 8, 64
    base = dict(num_slots=64, decode_chunk=chunk, max_new_tokens=new,
                max_queue=256, degrade_queue_depth=1024)
    paged = dict(paged=True, page_size=16, kv_pages=3072 + 1)
    trees = {"moe": tf.init_params(cfg, seed=0, device=dev),
             "dense": tf.TransformerLM(dense_cfg, seed=0, device=dev).params}
    cfgs = {"moe": cfg, "dense": dense_cfg}
    prompts = sync["plain"][0][0]                   # phase 3's traffic
    first, again = sync["paged"][0]                 # 3c's waves
    totals = {k: 0 for k in launch_counters()}

    def engine(model="moe", **kw):
        return InferenceEngine(cfgs[model], trees[model],
                               EngineConfig(**{**base, **kw}), device=dev)

    def differ(out, want):
        return [(w, i) for w, (got_w, want_w) in enumerate(zip(out, want))
                for i, (a, b) in enumerate(zip(got_w, want_w))
                if not np.array_equal(a, b)]

    def run(name, eng, waves, want=None, warm=False):
        with CountTwins() as plain:
            out, wall, c, sec, n, worst, keys0 = serve_pass(torch, eng,
                                                            waves)
        for k in totals:
            totals[k] += n[k]
        where = f"3g {name} pipeline={eng.config.pipeline}"
        for prompts_w, res in zip(waves, out):
            for p, r in zip(prompts_w, res):
                if r.shape != (p.shape[0] + new,) or \
                        not np.array_equal(r[:p.shape[0]], p) or \
                        r.min() < 0 or r.max() >= cfg.vocab_size:
                    fail(f"{where}: bad result of shape {r.shape}")
        check_launches(eng, c, L, n, where, keys0)
        bad = differ(out, want) if want is not None else []
        if plain.calls or bad:
            fail(f"{where}: {plain.calls} plain attention calls; tokens "
                 f"differ from the synchronous loop in {bad[:8]} "
                 f"({len(bad)})")
        if (not warm and c["graph_captures"]) or (
                eng.config.pipeline and worst > 1):
            fail(f"{where}: {c['graph_captures']} captures after warm-up, "
                 f"{worst} waits in a tick")
        if not eng.drained() or (eng.config.paged and
                                 eng.counts["pages_used"]
                                 != eng.prefix_cache_pages):
            fail(f"{where}: not drained or pages leaked ({eng.counts})")
        steps = chunk * c["decode_chunks"]
        n_req = sum(len(w) for w in waves)
        rec = dict(phase="3g", arm=name, pipeline=eng.config.pipeline,
                   warm_pass=warm, requests=n_req, new_tokens=new,
                   wall_s=wall, tokens_per_s=n_req * new / wall,
                   syncs=c["syncs"], max_syncs_per_tick=worst,
                   prefill_calls=c["prefill_calls"],
                   prefill_chunks=c["prefill_chunks"],
                   decode_chunks=c["decode_chunks"],
                   graph_captures=c["graph_captures"],
                   graph_replays=c["graph_replays"],
                   prefix_hits=c["prefix_hits"], cow_copies=c["cow_copies"],
                   launches=n, seconds=sec)
        if steps:
            rec["wall_ms_per_decode_step"] = wall / steps * 1e3
            if not eng.config.pipeline:
                rec["ms_per_decode_step"] = sec["decode"] / steps * 1e3
        line(rec)
        return rec, out

    # (a) phase 3's traffic, MoE and dense, both loops, in turns
    engs = {(m, p): engine(m, pipeline=p)
            for m in ("dense", "moe") for p in (False, True)}
    want = {}
    for m in ("dense", "moe"):
        want[m] = run(m, engs[(m, False)], [prompts], warm=True)[1]
        run(m, engs[(m, True)], [prompts], want[m], warm=True)
    timed = {}
    for p in (False, True, True, False):
        for m in ("dense", "moe"):
            timed.setdefault((m, p), []).append(
                run(m, engs[(m, p)], [prompts], want[m])[0])

    def col(m, p, k):
        return [r[k] for r in timed[(m, p)]]

    line(dict(phase="3g", run="moe_vs_dense_in_turns", order="S P P S",
              moe_sync_tokens_per_s=col("moe", False, "tokens_per_s"),
              moe_pipelined_tokens_per_s=col("moe", True, "tokens_per_s"),
              dense_sync_tokens_per_s=col("dense", False, "tokens_per_s"),
              dense_pipelined_tokens_per_s=col("dense", True,
                                               "tokens_per_s"),
              moe_sync_ms_per_decode_step=col("moe", False,
                                              "ms_per_decode_step"),
              dense_sync_ms_per_decode_step=col("dense", False,
                                                "ms_per_decode_step"),
              moe_pipelined_wall_ms_per_decode_step=col(
                  "moe", True, "wall_ms_per_decode_step"),
              dense_pipelined_wall_ms_per_decode_step=col(
                  "dense", True, "wall_ms_per_decode_step"),
              moe_over_dense_sync_tokens_per_s=(
                  sum(col("moe", False, "tokens_per_s"))
                  / sum(col("dense", False, "tokens_per_s"))),
              moe_over_dense_pipelined_tokens_per_s=(
                  sum(col("moe", True, "tokens_per_s"))
                  / sum(col("dense", True, "tokens_per_s")))))
    replay_ok = replay_equals_eager(torch, engs[("moe", True)], "decode",
                                    chunk)
    p0 = {k: v[0] for k, v in trees["moe"]["blocks"].items()}
    bit_equal = {"decode": moe_mlp_bit_equal(torch, tf, p0, cfg,
                                             (64, 1, cfg.d_model), dev),
                 "prefill": moe_mlp_bit_equal(torch, tf, p0, cfg,
                                              (64, 1024, cfg.d_model), dev)}
    ticks = {}
    for m in ("dense", "moe"):
        ticks[m] = profile_decode_tick(torch, engs[(m, True)],
                                       np.random.default_rng(5), m,
                                       phase="3g")
        # an admission tick of the synchronous engine: the one-shot
        # prefill of phase 3's first 64 prompts (the 1024 bucket) and
        # one decode chunk
        eng = engs[(m, False)]
        hs = [eng.submit(p, max_new_tokens=9) for p in prompts[:64]]
        c0 = dict(eng.counts)
        wall, rows, host = profiled(torch, eng.tick)
        if (eng.counts["prefill_calls"] - c0["prefill_calls"],
                eng.counts["decode_chunks"] - c0["decode_chunks"]) != (1, 1):
            fail(f"3g profiled {m} admission tick: {eng.counts}")
        eng.run_pending()
        if not all(h.done() for h in hs):
            fail(f"3g profiled {m} admission tick left requests unanswered")
        profile_line(wall, rows, host, phase="3g",
                     run=f"profiled_{m}_admission_tick")
    busy = {m: sum(us for _, us, _ in rows) / 1e3
            for m, (_, rows) in ticks.items()}
    line(dict(phase="3g", run="graphs_and_mlp",
              replay_equals_eager=replay_ok, moe_mlp_bit_equal=bit_equal,
              device_ms_a_decode_chunk=busy,
              moe_minus_dense_device_ms=busy["moe"] - busy["dense"]))
    if not replay_ok or not all(bit_equal.values()):
        fail(f"3g: replay ≡ eager {replay_ok}, MoE MLP bit-equal "
             f"{bit_equal}")
    del engs
    torch.cuda.empty_cache()

    # (b)-(d): paged, chunked, int8, each pipelined ≡ synchronous
    contiguous_first = run("contiguous_first_wave", engine(pipeline=False),
                           [first], warm=True)[1][0]
    arms = {"paged": ([first, again], paged),
            "chunked": ([first[:48]], dict(paged, prefill_chunk=256)),
            "int8": ([prompts], dict(quantize="int8", kv_quantize="int8"))}
    results = {}
    for name, (waves, kw) in arms.items():
        ref = run(name, engine(pipeline=False, **kw), waves, warm=True)[1]
        results[name] = run(name, engine(**kw), waves, ref, warm=True)[1]
        torch.cuda.empty_cache()
    line(dict(phase="3g", run="paged_and_chunked_vs_contiguous",
              paged_first_wave_requests_differing=len(differ(
                  [results["paged"][0]], [contiguous_first])),
              chunked_requests_differing=len(differ(
                  results["chunked"], [contiguous_first[:48]])),
              requests=[len(first), 48]))

    # (e) drops per call kind, from eager passes; generate at full width
    drops = {}
    eager = engine(pipeline=False)
    eager._graphs = None
    with RouteDrops("prefill") as rd:
        got = serve_waves(eager, [prompts])[0]
    drops["contiguous"] = rd.shares()
    if differ(got, want["moe"]):
        fail("3g: the eager MoE engine's tokens differ from the graph "
             "engine's")
    for name, prefill in (("paged", "paged_prefill"),
                          ("chunked", "prefill_chunk")):
        waves, kw = arms[name]
        eager = engine(pipeline=False, **kw)
        eager._graphs = None
        with RouteDrops(prefill) as rd:
            serve_waves(eager, waves[:1])
        drops[name] = rd.shares()
    del eager
    gb, gt, gnew = 64, 64, 128
    gprompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(gb, gt)).astype(np.int32)).to(dev)
    zero_launches()
    with RouteDrops("generate_prefill") as rd, CountTwins() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tf.generate(cfg, trees["moe"], gprompt, gnew, temperature=0.0)
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
    got = read_launches()
    drops["generate"] = rd.shares()
    for k in totals:
        totals[k] += got[k]
    if tuple(out.shape) != (gb, gt + gnew) or plain.calls or \
            got["flash_fwd"] != L or got["decode_attention"] != L * (gnew - 1):
        fail(f"3g generate: shape {tuple(out.shape)}, launches {got}, "
             f"{plain.calls} plain calls")
    line(dict(phase="3g", run="generate", batch=gb, prompt=gt,
              new_tokens=gnew, wall_s=gwall, tokens_per_s=gb * gnew / gwall,
              flash_launches=got["flash_fwd"],
              decode_launches=got["decode_attention"]))
    line(dict(phase="3g", run="dropped_share_by_call_kind", drops=drops))
    del trees
    torch.cuda.empty_cache()
    return {k: n for k, n in totals.items() if n}


# ---------------------------------------------------------------------------
# phase 5: the GravesLSTM char-RNN through MultiLayerNetwork
# ---------------------------------------------------------------------------

# Kernel and twin cast the same inputs to float32 at the same points
# (xw, carries, RW, bias and peepholes) and differ only in the order in
# which the recurrent product h.RW is summed (the bf16-RW "tc" kernel
# forms it from three exact bf16 parts of h), so bf16 inputs are held like
# float32 ones: |err| <= 1e-5 + 1e-5 |plain| on hs, cs and gates.
LSTM_TOL = "|err| <= 1e-5 + 1e-5 * |plain| (hs, cs, gates; f32 and bf16)"
# BASELINE config 3 (benchmarks/flagship.py:176-214 bench_lstm)
CHAR_V, CHAR_H, CHAR_B, CHAR_T = 80, 200, 1024, 64


def lstm_flops_per_char(v=CHAR_V, h=CHAR_H):
    """benchmarks/flagship.py:214: model FLOPs per character of a train
    step (3x the forward's matmuls) of the 2-layer char-RNN."""
    return 3 * (8 * h * (v + h) + 8 * h * (h + h) + 2 * h * v)


def lstm_bound(t, b, h, x_esz, w_esz):
    """Least time of one lstm_scan: (ms, bound_by, bytes, flops,
    ms on the CUDA cores). Bytes: xw, h0, c0, RW, b, peepholes read once;
    hs, cs and gates written once, float32. Operations: the recurrent
    product, 2*B*H*4H*T in float32; with a bf16 RW it runs exactly on the
    tensor cores as three bf16 products (h split in three bf16 parts), 3x
    the FLOP at 989 TF/s; with a float32 RW on the CUDA cores at 67 TF/s
    (the TPU kernel forms it in f32). The CUDA-core figure is returned
    beside the bound either way."""
    nbytes = (t * b * 4 * h * x_esz + 2 * b * h * x_esz + 4 * h * h * w_esz
              + 7 * h * w_esz + 2 * t * b * h * 4 + t * b * 4 * h * 4)
    flops = 2 * b * h * 4 * h * t
    cores_ms = bound(nbytes, flops, "float32")[0]
    if w_esz == 2:
        ms, by = bound(nbytes, 3 * flops, "bfloat16")
        return ms, by, nbytes, 3 * flops, cores_ms
    ms, by = bound(nbytes, flops, "float32")
    return ms, by, nbytes, flops, cores_ms


def phase_lstm_kernel(torch, dev):
    """5a. The lstm_scan kernel vs its plain twin on the card: the
    char-RNN's full-width shapes (B=1024, T=64, H=200; layer 1's xw from a
    one-hot V=80 input, layer 2's from an H=200 one) in bf16 and f32, the
    reversed sequence, small odd f32 shapes and B=1, T=1, every case with
    non-zero peepholes. Every bf16 case at full width must launch the
    tensor-core ("tc") kernel. Times the kernel, the twin and
    torch.nn.LSTM (cuDNN where it takes the dtype; zero peepholes, x.W
    inside); in bf16 also the SIMT kernel on the same inputs, in turns
    (SIMT, TC, TC, SIMT)."""
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
        tc0 = tl.lstm_scan_cuda.launches_tc
        got = tl.lstm_scan_cuda(*args)
        variant = "tc" if tl.lstm_scan_cuda.launches_tc > tc0 else "simt"
        want = tl.lstm_scan_reference(*args)
        rel = max(f32_rel_err(a, b) for a, b in zip(got, want))
        err = max(max_err(a, b) for a, b in zip(got, want))
        name = str(dtype).split(".")[-1]
        rec = dict(phase="5a", kernel="lstm_scan", dtype=name,
                   shape=dict(T=t, B=b, H=h, F=f), layer=layer,
                   reverse=reverse, peepholes="random, std 0.3",
                   variant=variant, max_abs_err=err, rel_err=rel,
                   tol=LSTM_TOL)
        if dtype == torch.bfloat16 and (t, b, h) == full and \
                variant != "tc":
            line(rec)
            fail(f"lstm_scan bf16 T={t} B={b} H={h}: the SIMT kernel ran, "
                 "not the tensor-core one")
        if not rel <= 1.0:
            line(rec)
            fail(f"lstm_scan {name} T={t} B={b} H={h} layer {layer} "
                 f"reverse={reverse}: {rel} x its limit (max err {err})")
        if timed:
            esz = x.element_size()
            b_ms, b_by, nbytes, bflops, cores_ms = lstm_bound(t, b, h, esz,
                                                              esz)
            if variant == "tc":
                turns = {"simt": [], "tc": []}
                for v in ("simt", "tc", "tc", "simt"):
                    turns[v].append(time_ms(
                        lambda: tl.lstm_scan_cuda(*args, variant=v)))
                k_ms = sum(turns["tc"]) / 2
                rec.update(simt_ms=sum(turns["simt"]) / 2,
                           turns_ms=turns)
            else:
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
                       bound_flops=bflops, bound_fp32_cores_ms=cores_ms,
                       bound_share=b_ms / k_ms)
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
    wall_p, rows, host = profiled(torch,
                                  lambda: net.fit_batched(xs[:1], ys[:1]))
    profile_line(wall_p, rows, host, phase="5c", run="profiled_minibatch")

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
    t_run = time.perf_counter()
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
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_packed2",
                 "decode_attention", "decode_window", "lstm_scan"):
        build_report(name)

    measured = phase_kernels(torch, dev)
    measured["flash_bwd"] = phase_backward_kernel(torch, dev)
    measured["decode_window"] = phase_window_kernel(torch, dev)
    measured["flash_bwd_packed2"] = phase_packed_backward_kernel(torch, dev)
    measured["decode_sweep"] = phase_decode_sweep_kernel(torch, dev)
    quant = phase_quant_kernels(torch, dev)
    measured["decode_attention_q"] = quant["decode_attention_q/int8"]
    measured["decode_window_q"] = quant["decode_window_q/int8"]
    phase_f32_card_vs_cpu(torch, dev)
    phase_spec_f32_card_vs_cpu(torch, dev)
    phase_paged_f32_card_vs_cpu(torch, dev)
    phase_quant_f32_card_vs_cpu(torch, dev)
    phase_constrained_f32_card_vs_cpu(torch, dev)
    new_phases = {}
    t_new = time.perf_counter()
    phase_moe_f32_card_vs_cpu(torch, dev)
    new_phases["2f"] = time.perf_counter() - t_new
    measured["lstm_scan"] = phase_lstm_kernel(torch, dev)
    # phases 3-3d run the synchronous loop; 3e the pipelined one (the
    # default) on their traffic, against their results
    launches, contiguous_ms_per_step, sync_plain = phase_full_width(torch,
                                                                    dev)
    quant_launches, sync_int8 = phase_quant_full_width(
        torch, dev, sync_plain[1][0], contiguous_ms_per_step)
    launches.update(quant_launches)
    spec_launches, sync_spec = phase_spec_full_width(torch, dev)
    paged_launches, sync_paged = phase_paged_full_width(
        torch, dev, contiguous_ms_per_step)
    pipe_launches = phase_pipeline_full_width(
        torch, dev, {"plain": sync_plain, "spec": sync_spec,
                     "int8": sync_int8, **sync_paged})
    c_launches = phase_constrained_full_width(
        torch, dev, {"plain": sync_plain, **sync_paged})
    phase_constrained_bench(torch, dev)
    t_new = time.perf_counter()
    moe_launches = phase_moe_full_width(
        torch, dev, {"plain": sync_plain, **sync_paged})
    new_phases["3g"] = time.perf_counter() - t_new
    for part in (spec_launches, paged_launches, pipe_launches, c_launches,
                 moe_launches):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    phase_train_f32_card_vs_cpu(torch, dev)
    for name, n in phase_train_full_width(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_new = time.perf_counter()
    moe_train = phase_train_full_width(torch, dev, n_experts=8)
    new_phases["4c"] = time.perf_counter() - t_new
    for name, n in moe_train.items():
        launches[name] = launches.get(name, 0) + n
    line(dict(run="moe_launches", serving=moe_launches, training=moe_train))
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
        # the quantized entries: the port's kernel for the reference's
        # scaled jnp path (its TPU kernel reads float caches only)
        "decode_attention_q": (
            "deeplearning4j_tpu_torch/csrc/decode_attention.cu",
            "deeplearning4j_tpu/ops/flash_decode.py:308"),
        "decode_window_q": ("deeplearning4j_tpu_torch/csrc/decode_window.cu",
                            "deeplearning4j_tpu/ops/flash_decode.py:513"),
    }
    # the device functions each serving kernel runs (DEVICE_FNS), whose
    # launches the profiled ticks' device traces counted
    device_fn = {"flash_fwd": "flash_fwd", "decode_attention": "decode_rows",
                 "decode_window": "decode_rows",
                 "decode_attention_q": "decode_q",
                 "decode_window_q": "window_q"}
    # launches: the wrappers' counts (eager calls and graph captures);
    # what the replays ran is on this line, measured on the device
    line(dict(run="graph_replays", graph_replays=GRAPH_REPLAYS,
              total=sum(GRAPH_REPLAYS.values()),
              device_launches_in_profiled_ticks=DEVICE_LAUNCHES,
              device_functions=DEVICE_FNS))
    kernels = []
    for name, (src, rep) in sources.items():
        r = measured[name]
        if launches.get(name, 0) <= 0:
            fail(f"kernel {name} was never launched on the main path")
        label = device_fn.get(name)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["kernel_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            device_launches_profiled=(DEVICE_LAUNCHES[label] if label
                                      else None)))
    wall = time.perf_counter() - t_run
    line(dict(run="wall", wall_s=wall, moe_phases_s=new_phases,
              without_moe_phases_s=wall - sum(new_phases.values())))
    print(card, flush=True)
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

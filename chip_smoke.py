#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (plain, speculative, paged with the
prefix cache, chunked prefill, grammar-constrained, mixture of experts),
its train step (dense and MoE), its training parallelism and elastic
training over worker processes, the GravesLSTM char-RNN's
training through MultiLayerNetwork, the DSL's CNN training path (LeNet,
VGG16-CIFAR, a DSL transformer, the training tools), the DAG runtime
(ComputationGraph: ResNet-50, the char-RNN and attention as graphs,
pretraining, the training fault tools), Keras import (the tf_keras
fixtures, the gateway server, tf_keras's ResNet-50 at full width) and the
two kernel experiments on the card and fails (non-zero exit, no result line) if anything is wrong:

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
   same 32 cold (prefix cache off); the first wave's first 32 with
   prefill_chunk 256 and the default budget; paged spec (K=7,
   "layers:1") against paged plain on 3b's aligned tree, token-exact.
   Every request answered and well formed; launches exact (phase 3's accounting; flash_fwd
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
   ``[ab]+``, the chunk-256 pool on the first 24 requests of its first
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
   engine on phase 3's traffic, both loops, timed in turns (S P);
   3c's paged waves, its chunk-256 arm on 24 requests, the int8 arm,
   each synchronous then pipelined; full-width `generate`; eager passes
   under `RouteDrops` for the dropped share per call kind; a profiled
   decode tick and admission tick of each model. Gates: pipelined ≡
   sync everywhere, the eager engine ≡ the graph one, replay ≡ eager,
   the MoE MLP bit-equal twice, launches exact with no plain attention
   twin and no SDPA (`CountTwins`), no capture once warm, no page
   leaked; paged and chunked against contiguous printed.
3h. Serving observability at full width (`phase_observability_full_width`;
   phase 3's config, its 128 requests and 3c's waves drawn again):
   (a) the default registry against NULL_REGISTRY, pipelined, in turns
   N O O N twice after a warm pass each: tokens/s, the median of paired
   ratios; tokens equal, and a profiled steady tick of each launches the
   same serving device functions with the same blocking waits (<= 1).
   (b) One engine an arm (plain, spec K 7 "layers:1", paged with prefix
   hits, chunk-256 paged, int8, `[ab]+`, MoE 8 experts; counts cut to 32
   requests, paged 48 + 16) scraped over MetricsServer(port=0): the
   naming lint (`lint_exposition`, tests/test_metrics_naming.py's rules),
   every counts key equal to the series that stands for it
   (`COUNT_SERIES`), pages used + free = the pool with none leaked, the
   requests' bills summing to the tenant counters. (c) profile_report of
   the plain and paged engines (FLOPs and bytes a call, intensity,
   roofline class against 989 TF/s and 3.35 TB/s, serving_mfu, achieved
   rates, the idle gauge beside the profiled tick's trace idle share):
   every share in [0, 1.05], the programs' device seconds equal to the
   busy total. (d) /profilez: 200 during traffic with a trace naming the
   decode and flash-forward device functions; 503 on a second request,
   without profile_dir and under another torch.profiler session, whose
   trace stays whole. (e) slo_report, the last timed pass's SLO, and the
   timeline as Chrome-trace JSON with a queue and a slot span a request.
   `--only 3h` runs the build and this phase alone.
3i. Serving fault tolerance at full width (`phase_faults_full_width`;
   phase 3's config on its first 12 requests, 24 new tokens; each arm
   served with and without its `ServingFaultInjector`): (a) transient
   faults (`fail_at` x3 and `prefill_fail_at` on the plain engine, both
   loops; `prefill_chunk_fail_at` on a chunk-256 arm): tokens equal the
   fault-free run of the same loop, retries = failures = the injected
   count, the breaker closed. (b) One request poisoned after two ticks
   on the plain pipelined, paged (a 512-token shared prefix, hits),
   int8-KV, `[ab]+` and MoE (8 experts) pools: it alone is quarantined,
   every request's tokens up to its isolation point equal the fault-free
   run's, survivors complete, no page leaks, the scratch pool dropped;
   the survivors' token-equal share, the snapshot and scratch-pool bytes
   printed (bf16: a solo re-run re-prefills prompt + generated in one
   flash call, whose rows round differently from the decode steps').
   (c) The pipelined commit's wait fails once: all complete, preempted >
   0, nothing pending. (d) `corrupt_page_at` on a paged writer sharing a
   prefix with two readers: the readers' tokens equal their clean run,
   the writer's change. (e) Spec (K=7, "layers:1", aligned tree) with
   `draft_poison_at`: one committed token that round, K drops to 1,
   tokens equal the plain engine's. (f) Phase 2's float32 model: poison
   and a failed wait; survivors equal the fault-free run, card = CPU.
   (g) The worker thread serves a wave, `drain()` flips `ready()` while
   residents run, a deadline and a cancel shed on an injected clock,
   `stop()`. Launches exact per served arm, the solo re-runs' eager
   prefills and chunks counted (`check_launches(solo=)`). `--only 3i`
   runs the build and this phase alone. With every engine of (a)-(e)
   dropped and torch's per-stream cuBLAS workspaces cleared, less than
   64 MiB may stay allocated over the phase's start (an engine is freed
   by its last reference, with no cyclic collection). Every other phase's engines run under the zero-failure
   gate (`install_zero_fault_gate`): a failed program call or an
   isolation on an engine without an injector fails the run, after the
   tick on the main thread, or, for the worker's ticks, once the worker
   has stopped and at the end of the run. The gate wraps the engine's
   `_record_failure` and `_isolate_slots`, so it also holds on a
   NULL_REGISTRY engine, whose counters read 0.
3j. Engine control at full width (`phase_engine_control_full_width`;
   phase 3's bf16 config and tree, phase 2's float32 model where a gate
   needs token-exactness): (a) batch mode: 48 requests, 16 each at
   prompt lengths 128, 512 and 1024, 64 new tokens, max_batch_size 16,
   decode_chunk 16 (`pipeline` falls back, reason "batch"): one batch a
   length group, every request complete, greedy tokens equal to the
   same `make_parallel_generate` calls made directly (the 16-row batches,
   and six requests through a batch engine of one request at a time at
   B=1; the B=1 streams' agreement with the B=16 ones is printed: a
   GEMM over 16 rows may round otherwise than over one), exactly L flash
   and 15 x L decode launches a generate call; the batch latencies (the
   listener protocol) and tokens/s; a transient
   fault retried token-exact, and a poisoned request quarantined while
   its 15 batch peers complete alone. (b) Fair-share prefill on the
   chunked (chunk 256, budget 512) and the paged chunked pool under
   `hostile_tenant_storm` (3 hostile tenants at weight 1 sending 8 x
   1024-token prompts, a victim at weight 3 sending 8 x 128, 32 new
   tokens, all submitted at once to 64 slots): over the backlogged ticks
   (every tenant's prefill demand at least its weighted share of the
   tick's budget) the victim's share of the granted tokens within 15% of
   3/6; no backlogged tenant unserved for more than ceil(1 / its weight
   share) ticks running; all complete, no page leaks, launches exact;
   the victim's TTFT on each pool. (c) 64
   class-0 residents, 6 class-5 arrivals, preemption_budget 2: at most 2
   evictions a tick, nothing lost, every preempted request complete; on
   the float32 model every preempted stream equals its uninterrupted
   run; `qos_control(spec_off=True, decode_chunk=2)` then 0 on the spec
   engine (K=7, "layers:1", aligned tree) leaves the committed tokens as
   an untouched run's, with a ("decode", 2) graph. (d) Hot reload from
   the port's `CheckpointManager` (a torn newest step): mid-stream in
   the pipelined loop with a tick pending it falls back to the zeroed
   step, requeues the residents with their committed tokens, later
   admissions equal a fresh engine on the zeroed tree, and the reload
   back serves the first wave again token for token; paged: the prefix
   cache flushed and no page leaked; int8: quantized again, equal to an
   int8 engine built from the same float tree; spec: equal to plain on
   the aligned tree, with window launches; float32 with a tick pending:
   token-exact. Launches gated after the reload (the graphs are dropped
   and captured again). `--only 3j` runs the build and this phase alone.
3k. The compile cache, warm-up and KV handoff at full width
   (`phase_cache_handoff_full_width`; phase 3's bf16 flagship, 64 slots).
   (a) Four fresh processes (`phase_3k_child`, this script with
   ``--3k-child``), each on its own copy of deeplearning4j_tpu_torch/ in
   a temp directory, so its build directory starts empty, sharing one
   ``compile_cache_dir``: ``warmup_on_init=True`` and 8 requests of 16
   tokens. Cold (empty cache): nvcc runs once for each serving source
   (flash_fwd, decode_attention) and nothing else, every warm-up program
   ``jit``. Warm: zero nvcc runs, every library from the cache, every
   warm-up program ``aot_cache``, the cold run's tokens. Then one program
   entry truncated: exactly one ``jit`` resolution, tokens unchanged.
   Then decode_attention's library entry torn in half: its CRC refuses
   it (one corrupt entry), nvcc runs for it alone, the entry is
   published again and loads checked as an ELF library, tokens
   unchanged. Each child carries the zero-failure gate on its own
   engine class, and every handle must complete.
   Prints restart-to-first-token (the parent's spawn to the child's
   first token), nvcc seconds and the cache's bytes. (b) `warmup()`,
   then 8 waves of 4 requests, one a prefill bucket (16 .. 2048): no
   capture, no resolution, no program-cache entry, launches exact. (c) The spec
   engine (K=7, "layers:1", adaptive K off) driven through K = 7, 3, 1
   and plain decode in turns under ``program_cache_size=2`` and an
   unbounded cache, in the synchronous and the pipelined loop: equal
   tokens, evictions counted, a capture for every resolution of a
   graphed key (more than the 4 of the unbounded engine). (d) Handoffs
   of 8 requests through kvwire frames (4 tokens, then 28 on the
   adopter): paged bf16 (a pipelined exporter, its pending tick flushed
   by the export; one frame through a `WireServer` on localhost), paged
   int8, and float32 contiguous -> paged (16 slots); each adopter
   token-equal to one engine of its kind with the same slot count, 16
   ok adoptions, no prefill, pages back to their start, launches exact.
   bf16 contiguous -> paged agreement is printed, not gated (the two
   prefills round differently). Frame bytes beside `handoff_bytes`;
   ms a request of the export with its encoding (host wall) and of the
   adopt call (synchronised). `--only 3k` runs the build and this
   phase alone.
3l. The fleet at full width (`phase_fleet_full_width`; phase 3's bf16
   flagship and traffic, weights from seed 0). (a) A `serving.fleet.
   Router` over two in-process 64-slot replicas, 64 requests of 64
   tokens: tokens equal a single 64-slot engine's, launches exact over
   both engines; fleet and single tokens/s in turns (S F) and the
   router's host ms a tick; the same fleet driven by `Router.start()`'s
   thread with HTTP probes while this thread polls every replica's
   /healthz and /debugz (launches still exact: the handlers launch
   nothing); a spec pair (K 7, "layers:1", the aligned tree) equal to
   plain; `kill_at` mid-decode under the 64 prompts twice: all 128
   complete, failovers, one
   restart, `torch.cuda.memory_allocated` after the restart within one
   KV pool of its level before the kill (the dead engine is dropped
   once its device work ended), the bf16 token-equal share and the
   recovery seconds printed; `hang_at` detected and failed over; a slow
   replica under hedging, every hedge's loser cancelled, tokens equal;
   `fail_probe` rotation, `drain` (readiness flips at once) and
   `rolling_reload` from a `util/checkpointing.py` npz step, nothing
   dropped. (b) Phase 2's float32 model behind a Router with a kill and
   a `serving.disagg.TieredRouter` with a decode-tier kill, a failed
   export and a corrupted kvwire frame, each on the card and on the
   CPU under one injected clock: tokens card == CPU == one
   uninterrupted card engine, stats card == CPU. (c) Tiers on phase
   3c's shared-prefix traffic, one prefill replica and two paged decode
   replicas, every handoff ok with its bytes equal to
   `quant.kv.handoff_bytes`, launches exact, export and adopt ms a
   request: a chunked (256) prefill tier beside one chunked paged
   engine on the first 32 requests (bf16 tokens round by their calls, and this tier batches its
   chunks and evicts cached prefixes unlike the single engine, whose
   budget also carries decode: the token-equal and first-token shares
   are printed, TTFT beside a prefill-only engine); a one-shot paged
   prefill tier whose pool evicts nothing, which admits the single
   paged engine's waves and so makes its calls: token-equal, gated,
   bf16 on 128 requests and int8 KV on 32 (the quantized entries
   launch, the float ones do not); an 8-slot decode tier autoscaled up
   and down and the prefill tier to zero, then a cold start, nothing
   lost. (d) Four `SubprocessReplica` workers on the card started at
   once (each hello: no jax, a CUDA device, no nvcc run; the plain pair
   warms up first and loads its libraries from the build directory):
   two serve phase 3's first 32 requests over the pipes, probed over
   HTTP, equal to the in-process engine; one is SIGKILLed mid-decode,
   all complete and it stays dead under ``max_restarts=0``; a one-shot
   paged prefill worker hands 8 shared-prefix requests to a decode
   worker as kvwire frames through the pipes, token-equal to (c)'s
   single paged engine, with frame bytes and export / wire / adopt ms a
   request; a SIGSTOPped worker is detected and failed over. `--only
   3l` runs the build and this phase alone.
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
4d. Training parallelism on torch.distributed (`phase_parallel_training`;
   `--only 4d` runs the build and this phase alone): four ranks share
   the card, started once by `parallel.multihost.MultiHostLauncher` on
   the backend its rule prints (gloo: NCCL refuses two ranks on one
   device), with the routing table of `parallel.collectives` (gloo's
   point-to-point sends through pinned host buffers); the ranks load
   the libraries built above and run no nvcc. (a) float32 at narrow
   width (vocab 50, d 128, 4 heads: head dim 32, the narrowest the flash
   kernels take; 4 layers, T 32, B 8; seeded params and tokens), two
   Adam steps (lr 1e-2) on {model=2}, {pipe=2} gpipe, {pipe=2, model=2}
   1f1b, {seq=2, model=2} ring and Ulysses, {data=4} with 4 experts
   (2 layers, capacity 8) and the FSDP step on {data=4}: every mesh's
   loss within 1e-4 of the single-rank `make_fsdp_train_step` on the
   card, every rank's shards within 5e-3 of its params, the loss the
   same on every rank, data replicas bit-equal, flash launched on every
   rank but ring's. (b) Phase 4b's flagship step (12L / 512d / 8H,
   V=256, T=2048, global B=16, bf16, remat 'full', the same seeded
   params and tokens) on {data=2, model=2} and on {seq=2, model=2} with
   Ulysses: one warm step, 2 timed, one with the collectives
   synchronised for their own seconds; the first loss within 2^-7
   relative of 4b's, the same on every rank, data replicas bit-equal
   (digests), 2 L flash forward and L backward launches a rank a step.
   Prints ms a step, global tokens/s, the bf16-peak share of one card,
   collective and host-staged bytes and seconds a rank a step, peak
   memory a rank. Four ranks on one card measure the communication
   layer; no speed is claimed. (c) In the same start of the ranks:
   `scaleout.SparkDl4jMultiLayer` over a
   `ParameterAveragingTrainingMaster` of the four ranks (8 rows a rank
   of each global batch of 32, phase stats on) fits tests/
   test_scaleout.py's float32 MLP (8 -> 16 tanh -> 3 softmax, SGD 0.1)
   on the card over 64 seeded rows: every rank's params within 1e-5 of
   one process's plain `fit` on the same global batches, the wrapper on
   4 workers, the stats' `fit` phase counted once a global batch.
4e. Elastic ZeRO-1 training over worker processes
   (`phase_elastic_training`; `--only 4e` runs the build and this phase
   alone): `train.elastic.ElasticCoordinator` in this process, its
   workers (`python -m deeplearning4j_tpu_torch.train.elastic_worker`)
   on the card beside it, JSON lines and base64 float32 on the pipes,
   deterministic algorithms on (``CUBLAS_WORKSPACE_CONFIG`` is set
   before the first GEMM of this process and of every worker). Every
   hello: no jax, a CUDA device, no nvcc run (the coordinator built the
   flash libraries); every live worker's pong: its shard's bytes are
   3 * 4 * (hi - lo) of `zero1_partition`, and its flash launches are
   exactly the per-call count times its gradient calls (the warm-up
   among them). Worker starts dominate the phase (each imports torch and
   sets up the card, and starts at once slow each other), so the
   narrow fleets start together, the narrow steady arm's whole fit and
   the oracles beside them; the flagship fleet starts beside (a)'s churn
   arm; then (a)'s loose arm and (b) run alone.
   (a) float32 at 4d (a)'s width, 2 layers (vocab 50, d 128, 4 heads,
   T 32), 3 workers, 6 microbatches of 4 rows, checkpoint every 2
   steps: `ElasticTrainingMaster.fit` over 16 steps (steady); one
   coordinator over 16 steps through worker 2 leaving at step 2
   (`remove_worker`), worker 1 killed at 3, worker 3 joining at 5
   (`add_worker`: the kill's replacement and the grow) and worker 0
   SIGSTOPped at 12, loose at its first missed 4 s barrier and evicted
   past a stale bound of 2; both bit-equal (losses and final flat
   params) to `reference_run` on the card, zero lost steps, the churn
   replaying from two checkpoints (evictions "leave" then
   "stale_bound", 1 worker left); the steady losses within 1e-4
   of `reference_run` on the CPU over 8 steps. Then 8 steps with a 1.2
   s step barrier (a narrow step of three workers takes 0.3-0.4 s) and
   worker 1 slowed for step 2 by 0.5 / 0.15 of it (JAX's ratio): loose
   sync entered, then a resync, no step lost, 3 workers. (b) The
   flagship of 4b (512d / 8H, V=256, T=2048, bf16, remat 'full', Adam
   lr 1e-3) cut to `E4_FULL_LAYERS` layers (printed; the JSON wire of
   the reference moves ~1.9 GB a step at 12 layers, 36 s a step on
   this host), three workers, 4 microbatches of 4 rows (global batch
   16), checkpoint every 2 steps, barriers of 120 s: steady (one step
   untimed, 4 timed, nothing else running), then on the same fleet the
   kill arm (worker 1 at step 7, a replacement at step 8, 5 steps),
   bit-equal to one `reference_run` of 10 steps on the card (steady:
   its first 5 losses; kill: its losses and final params), losses
   finite and falling, 2 L flash forward and L backward launches a gradient call
   in every worker. Prints fleet tokens/s and ms a step with the
   bf16-peak share of 4b's formula, the coordinator's wire bytes and
   seconds a step (JSON, base64, pipe writes), checkpoint seconds, the
   resize barrier (kill detected -> resharded, flight-recorder
   timestamps), the kill arm's recovery overhead against steady,
   per-worker updater bytes beside replicated, and every process's
   peak device memory. One card: the numbers measure the host path; no
   speed is claimed. Every 4e line
   carries the card's name and power limit.
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
5d. The DSL's CNN training path through MultiLayerNetwork (`--only 5d`
   runs the build and this phase alone). (a) float32 card vs CPU from one
   set of weights: a narrow LeNet (4 / 8 filters, dense 32) and a narrow
   CNN with BN, LRN and dropout (dropout's units are a function of its
   seed, the same on both devices), 3 fit steps each on synthetic MNIST
   (scores, params and BN state within 1e-4), and 3 LBFGS iterations on
   mlp_mnist (scores within 1e-4 relative, params within 1e-3). (b)
   lenet_mnist bf16 at bench.py's shapes (B=4096, a pool of 15 synthetic
   MNIST minibatches): fit_batched 2 epochs after a warm pass (examples/s,
   ms a step, fit_batched_cost's FLOPs a step and their share of the bf16
   peak, peak memory; scores finite and falling), then one epoch of
   fit(MnistDataSetIterator) with ScoreIterationListener and
   PerformanceListener and evaluate on the synthetic test set (accuracy >
   0.5). (c) VGG16-CIFAR as benchmarks/flagship.py:131-158 builds it
   (B=512, a pool of 4, bf16): fit_batched 2 epochs after a warm pass,
   the same figures. (d) two causal TransformerBlocks and an
   RnnOutputLayer (d 512, 8 heads, T=1024, B=16, bf16), 3 fit steps: the
   flash forward and backward wrappers launch exactly once a block a
   step. (e) A NaN batch under a TrainingGuard (SKIP, params bit-equal),
   a model-serializer round trip (bit-equal), EarlyStoppingTrainer with a
   LocalFileModelSaver on the narrow LeNet (the restored best model's
   output bit-equal to the saved one's), and early stopping over phase
   5b's float32 char-RNN with lstm_wavefront off (exactly 2 lstm_scan
   launches a chunk). Every 5d line carries the card's name and power
   limit.
5e. The DAG runtime (ComputationGraph) and the training tools (`--only
   5e` runs the build and this phase alone). (a) float32 card vs CPU
   from one set of weights: a narrow residual graph (two bottleneck
   blocks, BN after every conv, ElementWiseVertex adds), a two-input
   graph with a MergeVertex and input dropout, a GravesLSTM graph
   through TBPTT fit and 20 steps of rnn_time_step, and 3 pretraining
   steps of a VAE vertex and an RBM layer (scores, params, BN state and
   outputs within 1e-4; the pretraining draws bit-equal). (b) ResNet-50
   as trained_models.resnet50() builds it (224 x 224 x 3, 1000 classes,
   bf16, Nesterov 0.9, lr 0.01) at B=128 on a pool of 4 synthetic
   minibatches: fit_batched 2 epochs after a warm pass (examples/s, ms a
   step, FlopCounterMode's FLOPs of one step and their share of the
   bf16 peak, peak memory; scores finite, no preprocessor), one profiled
   step, then a TransferLearning build (frozen up to avg_pool, fc1000
   replaced with 10 classes): after 3 steps the frozen params are
   bit-equal and the head moved. (c) phase 5c's BASELINE config 3 (B=1024,
   T=64, bf16) as a graph: fit_batched launches lstm_scan exactly once a
   GravesLSTM vertex a chunk, 200 rnn_time_step calls at B=1 once a vertex
   a step, and its scores equal the MultiLayerNetwork's over the same
   layers and weights with lstm_wavefront off (bit-equal, else within
   2^-7 relative). (d) two TransformerBlock vertices (d 512, 8 heads,
   T=1024, B=16, bf16), 3 fit steps: the flash forward and backward once
   a block a step. (e) In float32 with TF32 off and cuDNN's deterministic
   algorithms (set here): FaultTolerantTrainer over the narrow LeNet with
   async checkpoints (a NaN batch skipped; a run preempted at iteration 4
   and a run whose step-4 write crashes each resume to params bit-equal
   to an uninterrupted run's), a StepWatchdog over a step that sleeps
   past its deadline, the ComputationGraph serializer's round trip
   (bit-equal) and EarlyStoppingGraphTrainer (the best model's output
   bit-equal to the saved one's). Every 5e line carries the card's name
   and power limit.
5f. Keras import on the port's own HDF5 reader (`--only 5f` runs the
   build and this phase alone; f32, TF32 off). A line records whether
   h5py and tf_keras exist on the machine (find_spec, no import). (a)
   The eight tf_keras fixtures (tests/fixtures/real_*.h5) through the
   entry points a user calls (import_keras_sequential_model_and_weights,
   import_keras_model_and_weights, import_keras_model_auto, load_vgg16)
   onto the card: each output against its Keras golden at the JAX tests'
   tolerances (1e-4 / 1e-5; LSTM 1e-4 / 1e-4; VGG16 1e-3 / 1e-4, argmax
   equal, accuracy >= 0.8) and against the port on the CPU within 1e-5 of
   the largest output; real_lstm with lstm_wavefront off launches
   lstm_scan exactly twice an output call (two Keras LSTM layers), two
   calls bit-equal. (b) A KerasServer on the card: /health, /predict on
   real_cnn.h5 and real_lstm.h5 equal to the direct output, a 2-epoch
   /fit on real_mlp.h5 with scores within 1e-5 of the CPU port's. (c)
   tf_keras's ResNet-50 at full width (224 x 224 x 3, 1000 classes; no
   weights file exists on the card, so from its checked-in Keras JSON,
   tests/fixtures/torch_keras_resnet50_224.json, through
   import_keras_model_configuration) filled with seeded Keras-layout
   arrays through convert_weights and the HDF5 path's weight copy: card
   vs CPU at B=2 (argmax equal, within 1e-4 of the largest output), then
   inference at B=128 (CUDA events over 10 calls after 2 warm-up calls:
   ms a batch, examples/s, FlopCounterMode's FLOPs a batch and their
   share of the f32 peak, peak memory). Every 5f line carries the card's
   name and power limit.
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
   wall time, the MoE phases', the rest's, phase 3h's, 3i's, 3j's, 3k's,
   3l's, 4d's, 4e's, 5d's, 5e's and 5f's (`wall`, `fleet_phase_s`,
   `parallel_phase_s`, `elastic_phase_s`, `dsl_cnn_phase_s`,
   `dag_phase_s`, `keras_import_phase_s`), and the seconds from the
   start at each block's end (`block_ends_s`: build, 1-2f, 3-3g, 3h-3l,
   4a-4e, 5a-5c, 5d-5f, 6) with the threads then alive beside the main
   one (`threads_at_block_ends`); every phase's and run's line carries
   `t_s`, the seconds since the script started. Between phases the
   script collects and freezes what survives (`settle`), so a later
   collection (each graph capture starts with one) scans only the new
   phase's objects;
   one `kernels` JSON line (decode_attention_q and decode_window_q among
   them; `launches` the wrappers' counts, 3j's included, flash_fwd's and
   flash_bwd's with 4e's live workers' (from their pongs),
   `device_launches_profiled`
   the traces' count of the device function the kernel runs), the
   card's name and power limit, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The kernels build from deeplearning4j_tpu_torch/csrc/ at the start (one
nvcc per source, started together). Weights are random, from fixed seeds.
"""
import gc
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (the bound of every kernel line)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def line(obj) -> None:
    """One JSON line; a phase's or a run's carries ``t_s``, the seconds
    since the script started."""
    if "phase" in obj or "run" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj), flush=True)


def settle() -> None:
    """Between phases: collect, then freeze what survives, so that later
    collections (each CUDA graph capture starts with one) scan only what
    the next phases make."""
    gc.collect()
    gc.freeze()


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


# the metrics-naming lint of tests/test_metrics_naming.py, whose rules a
# scrape of every serving engine must pass: snake_case names and labels,
# `_total` on counters and only on counters, a unit on histograms, no
# gauge named like a histogram sample, every sample under a TYPE line
_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? \S+$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="')
_HIST_UNITS = ("_seconds", "_bytes")
_UNITLESS_HISTOGRAMS = {"serving_batch_size"}


def lint_exposition(text: str) -> list:
    """The naming lint's violations in a Prometheus text scrape (an
    empty list when it passes)."""
    types, errs = {}, []
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            types[name] = kind
    for name, kind in types.items():
        if not _SNAKE.match(name):
            errs.append(f"{name}: not snake_case")
        if (kind == "counter") != name.endswith("_total"):
            errs.append(f"{name}: _total is for counters, and every "
                        "counter has it")
        if kind == "histogram" and not (name.endswith(_HIST_UNITS) or
                                        name in _UNITLESS_HISTOGRAMS):
            errs.append(f"{name}: histogram without a unit suffix")
        if kind == "gauge" and name.endswith(("_bucket", "_sum", "_count")):
            errs.append(f"{name}: gauge named like a histogram sample")
        if kind not in ("counter", "gauge", "histogram"):
            errs.append(f"{name}: kind {kind}")
    hist = {f"{n}{s}" for n, k in types.items() if k == "histogram"
            for s in ("_bucket", "_sum", "_count")}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = _SAMPLE.match(ln)
        if not m:
            errs.append(f"unparseable line {ln!r}")
            continue
        if m.group(1) not in types and m.group(1) not in hist:
            errs.append(f"{m.group(1)}: sample without a TYPE line")
        errs += [f"label {lab!r} not snake_case"
                 for lab in _LABEL.findall(m.group(3) or "")
                 if not _SNAKE.match(lab)]
    return errs


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


def build_report(name: str, mma: dict):
    """One line for a redesigned library: each kernel instance's ptxas
    registers and spills and its HMMA / HGMMA count in the SASS (``mma``,
    `_build.sass_mma_counts`). Fails if
    a bf16 instance of a tensor-core kernel has no HMMA, or if a
    half-precision Dh-64 instance (the main path's) or a bf16
    lstm_scan_tc_kernel instance or a Dh-64 quantized-cache instance
    spills."""
    import re
    from deeplearning4j_tpu_torch.ops import _build
    regs = _build.ptxas_report(name)
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
    off); the first wave's first 32 with prefill_chunk 256 and the
    default budget;
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
    # the chunked arm on the first quarter (chunk-256 prefill is
    # host-bound)
    chunked_first = first[:32]
    _, chunked_out, _ = arm("chunked", params, [chunked_first],
                            prefill_chunk=256)
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
                      "chunked": ([chunked_first], chunked_out)}


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


def host_launch_calls(prof, marks=0):
    """{runtime call: count} of the host's kernel and graph launches in a
    torch.profiler run (cudaLaunchKernel, cudaLaunchKernelExC,
    cudaGraphLaunch, and the driver API's cuLaunchKernel*), less the
    ``marks`` spin kernels `profile_session` launched."""
    host = {e.key: e.count for e in prof.key_averages()
            if e.key.startswith(("cudaLaunch", "cuLaunch",
                                 "cudaGraphLaunch"))}
    if marks and host.get("cudaLaunchKernel", 0) >= marks:
        host["cudaLaunchKernel"] -= marks
        if not host["cudaLaunchKernel"]:
            del host["cudaLaunchKernel"]
    return host


# spin kernels (torch.cuda._sleep's device function) launched and waited
# on at the start of every profiled session, before the work it times: a
# tracer that starts recording late loses these first. Each session's
# count of them in its trace goes to TRACER_MARKS_SEEN and into the
# `wall` line; their rows are left out of what the session returns.
TRACER_MARKS = 4
TRACER_MARK_FN = "spin_kernel"
TRACER_MARKS_SEEN = []


def profile_session(torch, fn, marks=TRACER_MARKS):
    """Run fn() once under torch.profiler (CPU and CUDA activities) after
    ``marks`` spin kernels, waited on; returns (wall s of fn, the
    profiler, its device rows without the marks)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(marks):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    if marks:
        TRACER_MARKS_SEEN.append(sum(n for k, _, n in rows
                                     if TRACER_MARK_FN in k))
    return wall, prof, [r for r in rows if TRACER_MARK_FN not in r[0]]


def profiled(torch, fn):
    """Run fn() once in a `profile_session`; returns (wall s, device
    rows, host launch calls)."""
    wall, prof, rows = profile_session(torch, fn)
    return wall, rows, host_launch_calls(prof, TRACER_MARKS)


def profile_line(wall, rows, host, **rec):
    busy = sum(us for _, us, _ in rows) / 1e6
    rec.update(tracer_marks_traced=TRACER_MARKS_SEEN[-1]
               if TRACER_MARKS_SEEN else None)
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


def expected_launches(eng, c, n_layers, keys0=(), solo=(0, 0)):
    """The launches by kernel the wrappers count in a drained run on a
    card engine with counts delta ``c`` (``keys0``: the graph keys the
    engine had captured before the run). A slot program's kernels launch
    from Python only at the first call of its (kind, size) key, eagerly,
    and once more at the capture right after it: a decode chunk L x
    chunk, a spec round L window and draft depth x K decode (the
    quantized entries on a quantized pool). Every later call of the key
    is a graph replay, which calls no wrapper: what a replay runs is
    read from the device's own trace (`device_launch_gate`). Flash L per
    one-shot contiguous prefill call (eager). ``solo``: the (prefill
    calls, decode chunks) of solo re-runs on the scratch pool (phase 3i),
    always eager and contiguous: L flash launches a prefill (counted in
    ``prefill_calls`` already on a one-shot engine), L x chunk decode
    launches a chunk."""
    nd = (eng._draft_layers or n_layers) if eng._spec else 0
    dec = n_layers * eng.decode_chunk * solo[1]
    win = 0
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
    return {"flash_fwd": n_layers * (c["prefill_calls"] if one_shot
                                     else solo[0]),
            "decode_attention": 0 if q else dec,
            "decode_window": 0 if q else win,
            "decode_attention_q": dec if q else 0,
            "decode_window_q": win if q else 0}


def check_launches(eng, c, n_layers, got, where, keys0=(), solo=(0, 0)):
    """Gate a drained card run (counts delta ``c``, wrapper launches
    ``got`` by kernel name): the launches `expected_launches` gives, and
    every decode chunk and spec round but the first of each key and the
    solo re-runs' eager chunks (``solo``) a graph replay (no slot program
    of the live pool ran eagerly past its capture)."""
    want = expected_launches(eng, c, n_layers, keys0, solo)
    new = len(eng._graphs.keys()) - len(keys0)
    replays = c["decode_chunks"] - solo[1] + c["spec_rounds"] - new
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
    # 3c's paged waves; its first wave's first 24 requests on the
    # chunk-256 pool (a pass of the whole wave takes 14 s there)
    first, again = sync["paged"][0]
    contiguous = engine()
    one_shot = [run("paged_contiguous", contiguous, [w], RXP, warm=True)[2][0]
                for w in (first, again)]
    del contiguous
    for name, waves_e, kw, ref_out in (
            ("paged", [first, again], paged, one_shot),
            ("chunked", [first[:24]], dict(paged, prefill_chunk=256),
             [one_shot[0][:24]]),
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
# phase 3h: serving observability at full width
# ---------------------------------------------------------------------------

# counts keys -> the series of the scrape that stands for each ("count"
# of a histogram, else a counter or gauge sample), where registered
COUNT_SERIES = {
    "prefill_calls": "serving_prefill_seconds_count",
    "decode_chunks": "serving_decode_chunks_total",
    "spec_rounds": "serving_spec_rounds_total",
    "spec_draft_steps": "serving_spec_draft_steps_total",
    "spec_reserved": "serving_spec_reserved_tokens_total",
    "spec_committed": "serving_spec_committed_tokens_total",
    "spec_drafted": "serving_spec_drafted_tokens_total",
    "spec_accepted": "serving_spec_accepted_tokens_total",
    "spec_released": "serving_spec_schedule_waste_tokens_total",
    "prefill_chunks": "serving_prefill_chunks_total",
    "prefix_hits": "serving_prefix_cache_hits_total",
    "prefix_misses": "serving_prefix_cache_misses_total",
    "prefix_shared_tokens": "serving_prefix_shared_tokens_total",
    "prefix_evictions": "serving_prefix_cache_evictions_total",
    "cow_copies": "serving_kv_cow_copies_total",
    "pages_used": "serving_kv_pages_used",
    "pages_free": "serving_kv_pages_free",
    "shed_overload": 'serving_requests_shed_total{reason="overload"}',
    "syncs": "serving_device_syncs_total",
    "pipelined_ticks": "serving_pipelined_ticks_total",
    "constrained_requests": "serving_constrained_requests_total",
    "constrained_grammar_compiles":
        "serving_constrained_grammar_compiles_total",
    "constrained_terminal": "serving_constrained_terminal_completions_total",
    "constrained_illegal": "serving_constrained_illegal_tokens_total",
    "constrained_table_rows": "serving_constrained_states",
    "graph_captures": "serving_graph_captures_total",
    "graph_replays": "serving_graph_replays_total",
    "graph_pool_bytes": "serving_graph_pool_bytes",
    "param_bytes": "serving_param_bytes",
    "kv_pool_bytes": "serving_kv_pool_bytes",
}


def scrape_samples(text: str) -> dict:
    """{series with its labels: value} of a Prometheus text scrape."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            out[name] = float(value)
    return out


def http_get(url: str):
    """(status, body) of a GET on the exporter (localhost)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serve_handles(eng, waves, specs=None):
    """Each wave submitted and drained tick by tick: (handles, wall s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = []
    for w, prompts in enumerate(waves):
        hs += [eng.submit(p, constrain=None if specs is None else specs[w])
               for p in prompts]
        while eng.tick():
            pass
    torch.cuda.synchronize()
    return hs, time.perf_counter() - t0


def scrape_gates(eng, hs, where, launches=None):
    """Scrape ``eng`` over MetricsServer(port=0) /metrics and gate it: the
    naming lint; every counts key equal to the series that stands for it
    (an exposition check: `counts` reads the same registry); pages used
    + free = the pool's pages with none leaked; the requests' bills
    summing to the tenant counters. Then the series against facts
    counted elsewhere: completions and TTFT observations against the
    handles ``hs`` (every request the engine served), prefill tokens
    plus prefix-shared tokens against their prompts, and, given the
    wrappers' ``launches`` over the engine's whole life, the kernel
    launches and graph replays `check_launches` derives from the
    scraped prefill calls, decode chunks, spec rounds and replays.
    Returns (the samples, the bills)."""
    from deeplearning4j_tpu_torch.observability import MetricsServer
    srv = MetricsServer(eng.registry, port=0, health=eng.health,
                        ready=eng.ready, debug=eng.debugz,
                        slo=eng.slo_report, timeline=eng.timeline,
                        profilez=eng.profilez)
    try:
        code, text = http_get(srv.url + "/metrics")
        codes = {p: http_get(srv.url + p)[0] for p in (
            "/metrics.json", "/healthz", "/readyz", "/debugz", "/slo",
            "/timeline.json")}
    finally:
        srv.stop()
    if code != 200 or set(codes.values()) != {200}:
        fail(f"3h {where}: /metrics {code}, {codes}")
    errs = lint_exposition(text)
    if errs:
        fail(f"3h {where}: naming lint: {errs[:6]}")
    got = scrape_samples(text)
    c = dict(eng.counts)
    bad = {k: (c[k], got.get(s)) for k, s in COUNT_SERIES.items()
           if s in got and got[s] != c[k]}
    missing = [k for k in ("prefill_calls", "decode_chunks", "syncs",
                           "param_bytes", "kv_pool_bytes")
               + (("graph_replays",) if eng._graphs is not None else ())
               if COUNT_SERIES[k] not in got]
    if bad or missing:
        fail(f"3h {where}: scrape vs counts {bad}, missing {missing}")
    if eng.config.paged:
        used, free = got["serving_kv_pages_used"], got["serving_kv_pages_free"]
        if used + free != eng._allocator.usable_pages or \
                used != eng.prefix_cache_pages:
            fail(f"3h {where}: pages used {used} + free {free} vs "
                 f"{eng._allocator.usable_pages}, cached "
                 f"{eng.prefix_cache_pages}")
    bills = {}
    for what in ("flops", "bytes"):
        total = sum(v for k, v in got.items()
                    if k.startswith(f"serving_request_cost_{what}_total"))
        mine = sum(getattr(h, f"cost_{what}") for h in hs)
        if total <= 0 or abs(mine - total) > 1e-9 * total:
            fail(f"3h {where}: {what} bills {mine} vs counter {total}")
        bills[what] = total
    facts = handle_facts(got, hs)
    if any(a != b for a, b in facts.values()):
        fail(f"3h {where}: series vs handles (series, handles) {facts}")
    if launches is not None:
        c = {k: int(got.get(COUNT_SERIES[k], 0)) for k in (
            "prefill_calls", "decode_chunks", "spec_rounds",
            "graph_replays")}
        check_launches(eng, c, eng.cfg.n_layers, launches, f"3h {where}")
    return got, bills


def handle_facts(got, hs):
    """{what: (series value, the handles' count)} for what the scrape
    ``got`` must agree with on the handles ``hs`` of every request the
    engine served: completions, TTFT observations (one a request that
    produced a token), and prefill plus prefix-shared tokens against
    the prompts' tokens."""
    done = [h for h in hs if h.status == "completed"]
    return {
        "completed": (got.get("serving_requests_completed_total", 0),
                      len(done)),
        "ttft_observations": (got.get("serving_ttft_seconds_count", 0),
                              sum(1 for h in hs if h.result().shape[0]
                                  > h.prompt.shape[0])),
        "prompt_tokens": (got.get("serving_prefill_tokens_total", 0)
                          + got.get("serving_prefix_shared_tokens_total", 0),
                          sum(int(h.prompt.shape[0]) for h in hs))}


def program_totals(eng):
    """{series with its labels: value} of the engine's analytic FLOP
    and byte counters (serving_program_flops / _bytes), read on the
    host."""
    from deeplearning4j_tpu_torch.observability import prometheus_text
    return {k: v for k, v in scrape_samples(
        prometheus_text(eng.registry)).items()
        if k.startswith(("serving_program_flops_total",
                         "serving_program_bytes_total"))}


def profile_pipelined_tick(torch, eng, rng, where):
    """One steady pipelined decode tick (a decode chunk's dispatch and the
    previous tick's commit, no admission) in a `profile_session`, gated
    on the device's and the host's trace only (an engine on
    NULL_REGISTRY counts nothing): the serving device functions launched
    and the blocking waits (cudaEventSynchronize /
    cudaStreamSynchronize). On a live registry the engine's syncs over
    the tick must equal those waits. Returns a dict: launches, waits,
    syncs (None on NULL_REGISTRY), the trace's device busy s and idle
    share, wall s, the idle gauge right after the tick, the chunk's
    analytic FLOPs and bytes (program_cost, billed at its dispatch; None
    on NULL_REGISTRY) with the rates they give over the trace's device
    time, the top kernels by device time, and the handles."""
    L = eng.cfg.n_layers
    prompts = [rng.integers(0, 256, size=64).astype(np.int32)
               for _ in range(eng.num_slots)]
    hs = [eng.submit(p, max_new_tokens=33) for p in prompts]
    for _ in range(3):           # admissions, then two decode ticks
        eng.tick()
    syncs0 = eng.counts["syncs"]
    cost0 = program_totals(eng)
    wall, prof, rows = profile_session(torch, eng.tick)
    live = eng.profiler.enabled
    gauge = eng.registry.get("serving_device_idle_fraction")
    gauge = None if gauge is None else gauge.value
    waits = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaEventSynchronize", "cudaStreamSynchronize"))
    got = device_launch_gate(rows, replay_want(eng, False, L), where)
    syncs = eng.counts["syncs"] - syncs0 if live else None
    if live and syncs != waits:
        fail(f"{where}: the engine counted {syncs} syncs, the trace "
             f"{waits} blocking waits")
    busy = sum(us for _, us, _ in rows) / 1e6
    cost = {k: v - cost0.get(k, 0) for k, v in program_totals(eng).items()}
    flops = sum(v for k, v in cost.items() if "flops" in k) if live else None
    nbytes = sum(v for k, v in cost.items() if "bytes" in k) if live else None
    eng.run_pending()
    if not all(h.done() for h in hs):
        fail(f"{where}: requests left unanswered")
    return dict(
        launches=got, tracer_marks_traced=TRACER_MARKS_SEEN[-1],
        waits=waits, syncs=syncs, device_busy_s=busy,
        trace_idle=1 - busy / wall, wall_s=wall, idle_gauge=gauge,
        chunk_flops=flops, chunk_bytes=nbytes,
        trace_flops_share=(flops / busy / PEAK_FLOPS["bfloat16"]
                           if live else None),
        trace_bytes_share=(nbytes / busy / PEAK_BYTES_PER_S
                           if live else None),
        top_kernels=[dict(name=k[:80], ms=us / 1e3, count=n)
                     for k, us, n in rows[:8]], hs=hs)


def tracer_probe(torch, eng, rng, pairs=4):
    """Steady pipelined decode ticks, each profiled in a session of its
    own, in pairs without the spin marks and with them (a fresh batch of
    64-token prompts a pair, past its admission and two decode ticks):
    the decode launches each session traced (want L x chunk) and the
    marks each traced. A session that begins recording late loses its
    first launches: without marks those are the chunk's. No gate.
    Returns (the counts, the handles)."""
    want = eng.cfg.n_layers * eng.decode_chunk
    out = {"want": want, "without_marks": [], "with_marks": [],
           "marks_traced": []}
    hs = []
    for _ in range(pairs):
        prompts = [rng.integers(0, 256, size=64).astype(np.int32)
                   for _ in range(eng.num_slots)]
        hs += [eng.submit(p, max_new_tokens=6 * eng.decode_chunk + 1)
               for p in prompts]
        for _ in range(3):
            eng.tick()
        for marks in (0, TRACER_MARKS):
            seen = len(TRACER_MARKS_SEEN)
            _, _, rows = profile_session(torch, eng.tick, marks)
            n = sum(c for k, _, c in rows
                    if any(f in k for f in DEVICE_FNS["decode_rows"]))
            out["with_marks" if marks else "without_marks"].append(n)
            if marks:
                out["marks_traced"] += TRACER_MARKS_SEEN[seen:]
        eng.run_pending()
    if not all(h.done() for h in hs):
        fail("3h tracer probe: requests left unanswered")
    return out, hs


def phase_observability_full_width(torch, dev):
    """Phase 3's config (12L, d 512, 8 heads, vocab 256, max_len 2048,
    bf16, 64 slots, chunk 8) under the observability stack, on phase 3's
    128 requests and phase 3c's paged waves (drawn again from their
    generators, so the phase also runs alone: ``--only 3h``). (a) Two
    pipelined engines on phase 3's 128 requests (64 new tokens), one
    with the default registry (O) and one on NULL_REGISTRY (N), timed
    in turns N O O N twice after a warm pass each: tokens equal in every
    pass; a profiled steady pipelined decode tick of each launches the
    same serving device functions and makes the same blocking waits (at
    most one), and O's syncs over it equal its trace's waits. Then the
    tracer probe (`tracer_probe`, printed only). (b) One engine per
    serving arm scraped over MetricsServer(port=0) after its traffic
    (`scrape_gates`): plain (O), spec (3b's aligned tree, K 7,
    "layers:1"), paged with prefix hits (3c's waves, cut, and a profiled
    tick), chunked 256 on the paged pool, int8 weights and KV,
    constrained ``[ab]+`` and MoE with 8 experts at 1.25; every arm but
    O (whose wrapper counts N shares) also held to its wrappers' kernel
    launches and graph replays (`check_launches`). (c) The plain and
    paged engines' profile_report: per program FLOPs and bytes a call,
    intensity and roofline class against 989 TF/s and 3.35 TB/s, and
    the host-estimate rates (analytic work over the busy estimate);
    serving_mfu; the idle gauge beside the profiled tick's trace idle
    share; the profiled chunk's analytic FLOPs and bytes over its
    kernels' device time in the trace. Gates: every host-estimate share
    in [0, 1.05]; and an exposition check, the programs' device seconds
    summing to the busy total within 1e-6 s a tick (the attribution
    conserves it by construction). (d) /profilez: 200 during traffic
    with its trace naming the decode and flash-forward device functions,
    503 on a second request during the capture, without profile_dir, and
    under another torch.profiler session, whose trace stays whole. (e)
    The plain engine's slo_report, and its timeline as Chrome-trace JSON
    with a queue span and a slot span for each request of the last pass.
    Returns the wrappers' launches by kernel over the phase."""
    import json as _json
    import tempfile
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.observability import (NULL_REGISTRY,
                                                        MetricsServer)
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    zero_launches()
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    base = dict(num_slots=64, decode_chunk=8, max_new_tokens=64,
                max_queue=256, degrade_queue_depth=1024)
    paged = dict(paged=True, page_size=16, kv_pages=3072 + 1)
    params = tf.TransformerLM(cfg, seed=0, device=dev).params
    rng = np.random.default_rng(0)                 # phase 3's traffic
    lens = rng.integers(16, 1025, size=128)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens]
    rng = np.random.default_rng(0)                 # phase 3c's waves
    first = paged_traffic(rng, 96, 32, 512, (16, 512), (16, 1024))
    again = [first[i] for i in rng.choice(len(first), size=32,
                                          replace=False)]

    # (a) default vs NULL, in turns
    engs = {"O": InferenceEngine(cfg, params, EngineConfig(**base),
                                 device=dev),
            "N": InferenceEngine(cfg, params, EngineConfig(**base),
                                 device=dev, registry=NULL_REGISTRY)}
    if engs["N"].recorder.enabled or engs["N"].profiler.enabled:
        fail("3h: a NULL_REGISTRY engine kept its recorder or profiler")
    plain_hs = []
    want = None
    tps = {"O": [], "N": []}
    for arm in ["O", "N"] + ["N", "O", "O", "N"] * 2:
        hs, wall = serve_handles(engs[arm], [prompts])
        out = [h.result() for h in hs]
        if want is None:
            want = out
        elif any(not np.array_equal(a, b) for a, b in zip(out, want)):
            fail(f"3h: the {arm} arm's tokens differ")
        if arm == "O":
            plain_hs += hs
            last_o = hs
        tps[arm].append(len(prompts) * base["max_new_tokens"] / wall)
    # the first pass of each engine was its warm pass (graph captures)
    tps = {a: v[1:] for a, v in tps.items()}
    turns = ["N", "O", "O", "N"] * 2
    idx = {"O": 0, "N": 0}
    seq = []
    for a in turns:
        seq.append((a, tps[a][idx[a]]))
        idx[a] += 1
    ratios = []
    for b in range(0, len(seq), 4):
        n1, o1, o2, n2 = (v for _, v in seq[b:b + 4])
        ratios += [o1 / n1, o2 / n2]
    line(dict(phase="3h", run="default_vs_null", order="N O O N x2",
              requests=len(prompts), new_tokens=base["max_new_tokens"],
              default_tokens_per_s=tps["O"], null_tokens_per_s=tps["N"],
              paired_default_over_null=ratios,
              median_default_over_null=float(np.median(ratios)),
              tokens_equal=True))
    ticks = {}
    for arm in ("O", "N"):
        ticks[arm] = profile_pipelined_tick(
            torch, engs[arm], np.random.default_rng(11),
            f"3h profiled {arm} tick")
    if ticks["O"]["launches"] != ticks["N"]["launches"] or \
            ticks["O"]["waits"] != ticks["N"]["waits"] or \
            ticks["O"]["waits"] > 1:
        fail(f"3h: profiled ticks differ or wait more than once: "
             f"default {ticks['O']['launches']} {ticks['O']['waits']}, "
             f"null {ticks['N']['launches']} {ticks['N']['waits']}")
    eng = engs["O"]
    plain_hs += ticks["O"].pop("hs")
    ticks["N"].pop("hs")
    line(dict(phase="3h", run="profiled_ticks", engine="plain",
              **{a: t for a, t in ticks.items()}))
    # on N: its requests stay out of O's recorder window and bills
    probe, _ = tracer_probe(torch, engs["N"], np.random.default_rng(12))
    line(dict(phase="3h", run="tracer_probe", engine="plain, NULL_REGISTRY",
              **probe))
    del engs["N"]
    plain_samples, _ = scrape_gates(eng, plain_hs, "plain")
    reports = {"plain": (eng, plain_samples, ticks["O"])}

    # (e) SLO and timeline of the plain engine (its last pass)
    slo = eng.slo_report()
    tl = _json.loads(_json.dumps(eng.timeline(n=eng.recorder.capacity)))
    last = {h.rid for h in last_o}
    spans = {}
    for e in tl["traceEvents"]:
        if e.get("ph") == "X" and e["args"]["rid"] in last:
            spans.setdefault(e["args"]["rid"], []).append(
                (e["tid"] == 0, e["name"]))
    lanes = {e["args"]["name"] for e in tl["traceEvents"]
             if e["name"] == "thread_name"}
    if set(spans) != last or any(
            sorted(q for q, _ in s) != [False, True]
            for s in spans.values()) or len(lanes) != 1 + eng.num_slots:
        fail(f"3h: timeline has {len(spans)} of {len(last)} requests "
             f"with a queue and a slot span, {len(lanes)} lanes")
    # the engine's window holds its warm pass and the profiled tick's
    # requests too: the last timed pass alone, through its own tracker
    from deeplearning4j_tpu_torch.observability import (MetricsRegistry,
                                                        SLOTracker)
    last_slo = SLOTracker(MetricsRegistry(), window=len(last_o))
    for h in last_o:
        last_slo.finished(h.trace)
    keys = ("window", "goodput", "ttft_p50_ms", "ttft_p99_ms",
            "tpot_p50_ms", "tpot_p99_ms", "e2e_p50_ms", "e2e_p99_ms",
            "queue_age_p50_ms", "queue_age_p99_ms")
    line(dict(phase="3h", run="slo", slo_report={k: slo[k] for k in keys},
              last_timed_pass={k: last_slo.report()[k] for k in keys},
              timeline_events=len(tl["traceEvents"]),
              timeline_requests=len(spans)))

    # (d) /profilez on a plain engine with profile_dir
    with tempfile.TemporaryDirectory() as tmp:
        peng = InferenceEngine(cfg, params, EngineConfig(
            **base, profile_dir=tmp), device=dev)
        serve_handles(peng, [prompts[:64]])          # warm: captures
        srv = MetricsServer(peng.registry, port=0, profilez=peng.profilez)
        nsrv = MetricsServer(eng.registry, port=0, profilez=eng.profilez)
        try:
            c1, b1 = http_get(srv.url + "/profilez?seconds=1")
            c2, b2 = http_get(srv.url + "/profilez?seconds=1")
            serve_handles(peng, [prompts[:64]])
            c3, _ = http_get(nsrv.url + "/profilez?seconds=1")
            t0 = time.perf_counter()
            while peng._capture.active:
                if time.perf_counter() - t0 > 120:
                    fail("3h: /profilez capture never finished")
                time.sleep(0.05)
            files = [f for f in os.listdir(tmp) if f.endswith(".json")]
            names = set()
            for f in files:
                with open(os.path.join(tmp, f)) as fh:
                    names |= {e.get("name", "") for e in
                              _json.load(fh).get("traceEvents", [])}
            has = {label: any(any(fn in n for fn in DEVICE_FNS[label])
                              for n in names)
                   for label in ("decode_rows", "flash_fwd")}
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as outer:
                c4, b4 = http_get(srv.url + "/profilez?seconds=1")
                serve_handles(peng, [prompts[:8]])
            outer_rows = device_rows(outer)
            outer_ok = any(any(fn in k for fn in DEVICE_FNS["decode_rows"])
                           for k, _, _ in outer_rows)
        finally:
            srv.stop()
            nsrv.stop()
        line(dict(phase="3h", run="profilez", during_traffic=c1,
                  second_during_capture=c2, second_error=_json.loads(b2),
                  without_profile_dir=c3, under_other_profiler=c4,
                  other_error=_json.loads(b4), trace_files=len(files),
                  trace_names_kernels=has, other_trace_whole=outer_ok))
        if (c1, c2, c3, c4) != (200, 503, 503, 503) or len(files) != 1 \
                or not all(has.values()) or not outer_ok:
            fail(f"3h /profilez: codes {(c1, c2, c3, c4)}, files {files}, "
                 f"kernels {has}, other session whole {outer_ok}")
        del peng
    del eng, engs
    torch.cuda.empty_cache()

    # (b) the other arms, scraped after their traffic
    aligned = aligned_params(tf, cfg, dev)
    moe_cfg = tf.TransformerConfig(**{**cfg.__dict__, "n_experts": 8,
                                      "capacity_factor": 1.25})
    arms = [("spec", cfg, aligned, dict(spec_decode=True, spec_k=7,
                                        draft="layers:1"),
             [prompts[:32]], None),
            ("paged", cfg, params, paged, [first[:48], again[:16]], None),
            ("chunked", cfg, params, dict(paged, prefill_chunk=256),
             [first[:32]], None),
            ("int8", cfg, params, dict(quantize="int8", kv_quantize="int8"),
             [prompts[:32]], None),
            ("constrained", cfg, params, {}, [prompts[:32]],
             ["[ab]+"]),
            ("moe", moe_cfg, None, {}, [prompts[:32]], None)]
    for name, acfg, tree, kw, waves, specs in arms:
        if tree is None:
            tree = tf.TransformerLM(acfg, seed=0, device=dev).params
        l0 = read_launches()
        aeng = InferenceEngine(acfg, tree, EngineConfig(**base, **kw),
                               device=dev)
        hs, wall = serve_handles(aeng, waves, specs)
        for h in hs:
            h.result()
        tick = None
        if name == "paged":
            tick = profile_pipelined_tick(
                torch, aeng, np.random.default_rng(11),
                "3h profiled paged tick")
            hs = hs + tick.pop("hs")
            line(dict(phase="3h", run="profiled_ticks", engine="paged",
                      O=tick))
        l1 = read_launches()
        got, bills = scrape_gates(aeng, hs, name,
                                  {k: l1[k] - l0[k] for k in l1})
        c = aeng.counts
        line(dict(phase="3h", run="scrape", arm=name,
                  requests=len(hs), wall_s=wall, lint="pass",
                  series=sum(1 for k in got if not k.startswith("#")),
                  bills_flops=bills["flops"], bills_bytes=bills["bytes"],
                  prefix_hits=c["prefix_hits"], cow_copies=c["cow_copies"],
                  spec_accepted=c["spec_accepted"],
                  constrained_requests=c["constrained_requests"]))
        if name == "paged":
            reports["paged"] = (aeng, got, tick)
        else:
            del aeng
        torch.cuda.empty_cache()

    # (c) the profiler's reports
    for name, (reng, got, tick) in reports.items():
        rep = reng.profile_report()
        mfu = got["serving_mfu"]
        idle = got["serving_device_idle_fraction"]
        # the gated shares are host estimates: analytic work over the
        # busy estimate's time. The kernel rates are the profiled chunk's
        # analytic work over its kernels' time in the CUPTI trace, printed
        # only: program_cost counts the bytes a kernel asks for, and
        # reads the cache serves (a paged gather's scratch page) count
        shares = {"serving_mfu": mfu,
                  "achieved_bytes_share": got[
                      "serving_achieved_bytes_per_second"] / PEAK_BYTES_PER_S,
                  "serving_device_idle_fraction": idle}
        table = {}
        for lab, row in rep["programs"].items():
            table[lab] = dict(
                invocations=row["invocations"],
                flops_per_call=row["flops_per_invocation"],
                bytes_per_call=row["bytes_per_invocation"],
                intensity=row["intensity_flops_per_byte"],
                bound=row["bound"], device_s=row["device_seconds"],
                host_est_flops_per_s=row["achieved_flops_per_s"],
                host_est_bytes_per_s=row["achieved_bytes_per_s"])
            if row["achieved_flops_per_s"]:
                shares[f"{lab}_host_est_flops"] = (
                    row["achieved_flops_per_s"] / PEAK_FLOPS["bfloat16"])
                shares[f"{lab}_host_est_bytes"] = (
                    row["achieved_bytes_per_s"] / PEAK_BYTES_PER_S)
        ticks_n = reng.counts["pipelined_ticks"]
        dev_s = sum(r["device_seconds"] for r in rep["programs"].values())
        line(dict(phase="3h", run="profile_report", engine=name,
                  peak_flops=rep["peak_flops"],
                  peak_bytes_per_s=rep["peak_bytes_per_s"],
                  ridge=rep["ridge_flops_per_byte"], mfu=mfu,
                  achieved_flops_per_s=got[
                      "serving_achieved_flops_per_second"],
                  achieved_bytes_per_s=got[
                      "serving_achieved_bytes_per_second"],
                  idle_gauge=idle,
                  trace_idle_share_profiled_tick=tick["trace_idle"],
                  idle_gauge_profiled_tick=tick["idle_gauge"],
                  trace_chunk_flops_share=tick["trace_flops_share"],
                  trace_chunk_bytes_share=tick["trace_bytes_share"],
                  device_seconds_sum=dev_s, busy_total_s=reng._busy_total_s,
                  ticks=ticks_n, programs=table, shares=shares))
        if rep["peak_flops"] != PEAK_FLOPS["bfloat16"] or \
                rep["peak_bytes_per_s"] != PEAK_BYTES_PER_S:
            fail(f"3h: profiler peaks {rep['peak_flops']}, "
                 f"{rep['peak_bytes_per_s']} on {torch.cuda.get_device_name(0)}")
        bad = {k: v for k, v in shares.items() if not 0 <= v <= 1.05}
        if bad:
            fail(f"3h {name}: impossible shares {bad}")
        # an exposition check: tick_end splits each tick's busy interval
        # across its programs, so this holds unless the export loses one
        if abs(dev_s - reng._busy_total_s) > 1e-6 * max(1, ticks_n):
            fail(f"3h {name}: program device seconds {dev_s} vs busy "
                 f"{reng._busy_total_s}")
    del reports, aligned, params
    torch.cuda.empty_cache()
    got = read_launches()
    if not got["flash_fwd"] or not got["decode_attention"]:
        fail(f"3h: the serving kernels did not launch ({got})")
    return {k: n for k, n in got.items() if n}


# ---------------------------------------------------------------------------
# phase 3i: serving fault tolerance at full width
# ---------------------------------------------------------------------------

# faults seen on engines without an injector (`install_zero_fault_gate`)
ZERO_FAULT_SEEN: list = []


def install_zero_fault_gate(cls=None):
    """The gate every arm run without a fault injector passes. The
    engine's guard retries a RuntimeError and then quarantines, so
    without it a kernel fault on the card could end as a silent retry.
    It wraps the two methods every fault passes through, on ``cls``
    (default the engine class): ``_record_failure`` (each failed program
    call, before any retry) and ``_isolate_slots`` (each preemption, and
    so each quarantine, a failed pipelined wait included). These are
    facts, not the registry's counters, which read 0 on a NULL_REGISTRY
    engine. A fault on an engine without an injector is recorded in
    ZERO_FAULT_SEEN; a tick on the main thread that saw one fails the
    run at once, and a worker thread's (where `fail` would end only the
    thread) fails it when the phase has stopped its engine and at the
    end of the run (`check_zero_fault_gate`). Engines given an injector
    (phase 3i's, even an empty one) are exempt."""
    if cls is None:
        from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
        cls = InferenceEngine
    if "_zero_fault_gate" in vars(cls):
        return
    record_failure, isolate, tick = (cls._record_failure,
                                     cls._isolate_slots, cls.tick)

    def gated_record_failure(self, err):
        if self._injector is None:
            ZERO_FAULT_SEEN.append(f"a program call failed "
                                   f"({type(err).__name__}: {err})")
        return record_failure(self, err)

    def gated_isolate(self, requests, err):
        if self._injector is None:
            ZERO_FAULT_SEEN.append(f"{len(requests)} requests isolated "
                                   f"({err})")
        return isolate(self, requests, err)

    def gated_tick(self):
        busy = tick(self)
        if threading.current_thread() is threading.main_thread():
            check_zero_fault_gate("after a tick")
        return busy

    cls._record_failure = gated_record_failure
    cls._isolate_slots = gated_isolate
    cls.tick = gated_tick
    cls._zero_fault_gate = True


def check_zero_fault_gate(where: str) -> None:
    if ZERO_FAULT_SEEN:
        fail(f"zero-failure gate ({where}): an engine without a fault "
             f"injector: {ZERO_FAULT_SEEN[:4]} ({len(ZERO_FAULT_SEEN)} "
             f"in all)")


def committed_before_isolation(h):
    """Tokens ``h`` had committed when it was preempted (all of them when
    it never was)."""
    n = 0
    for e in h.trace.events:
        if e.kind == "preempted":
            return n
        if e.kind in ("prefill_done", "decode_chunk"):
            n += int(e.data["tokens"])
    return n


def solo_calls(hs):
    """(prefill calls, decode chunks) the handles' solo re-runs made on the
    scratch pool (the calls that committed; an attempt the injector
    refused launched nothing)."""
    ev = [e for h in hs for e in h.trace.events if e.data.get("scratch")]
    return (sum(e.kind == "prefill_done" for e in ev),
            sum(e.kind == "decode_chunk" for e in ev))


def phase_faults_full_width(torch, dev):
    """Phase 3's bf16 config (12L / 512d / 8 heads, max_len 2048, 64
    slots, chunk 8) on a cut of its traffic (the first 12 of its 128
    requests, 24 new tokens), each arm served with and without its
    injector (see the module docstring, 3i). Returns the wrappers'
    launches by kernel over the phase."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel.failure import \
        ServingFaultInjector
    from deeplearning4j_tpu_torch.serving.engine import (
        EngineConfig, EngineDraining, InferenceEngine, RequestStatus)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L, chunk, n_req, new = cfg.n_layers, 8, 12, 24
    rng = np.random.default_rng(0)                 # phase 3's traffic
    lens = rng.integers(16, 1025, size=128)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens][:n_req]
    trees = {"dense": tf.TransformerLM(cfg, seed=0, device=dev).params}
    # the baseline of the dropped-engines gate below: what earlier phases
    # left for the cyclic collector is collected here, not counted there
    gc.collect()
    alloc0 = torch.cuda.memory_allocated(dev)
    base = dict(num_slots=64, decode_chunk=chunk, max_new_tokens=new,
                max_queue=256, degrade_queue_depth=1024)
    totals = {k: 0 for k in launch_counters()}
    shares, snaps = {}, {}

    def serve(name, inj=None, reqs=None, specs=None, tree="dense",
              mcfg=cfg, before=None, ticks_before_fault=0, fault=None,
              **kw):
        """One engine over ``reqs`` (default the cut): submitted, ticked
        ``ticks_before_fault`` times, ``fault(eng, hs)`` applied, then
        drained; launches gated (the solo re-runs' eager calls counted)
        and summed. Returns (engine, handles)."""
        eng = InferenceEngine(mcfg, trees[tree], EngineConfig(**{
            **base, **kw}), device=dev, fault_injector=inj)
        if before is not None:
            hs0 = [eng.submit(p) for p in before]
            eng.run_pending()
            if not all(h.status == RequestStatus.COMPLETED for h in hs0):
                fail(f"3i {name}: the seeding wave did not complete")
        zero_launches()
        keys0 = eng._graphs.keys()
        c0 = dict(eng.counts)
        reqs = prompts if reqs is None else reqs
        hs = [eng.submit(p, constrain=None if specs is None else specs[k])
              for k, p in enumerate(reqs)]
        for _ in range(ticks_before_fault):
            eng.tick()
        if fault is not None:
            fault(eng, hs)
        eng.run_pending()
        torch.cuda.synchronize()
        got = read_launches()
        for k in totals:
            totals[k] += got[k]
        c = {k: eng.counts[k] - c0[k] for k in c0}
        check_launches(eng, c, mcfg.n_layers, got, f"3i {name}", keys0,
                       solo=solo_calls(hs))
        if not eng.drained() or eng._pending or eng._scratch is not None:
            fail(f"3i {name}: not drained, a tick pending or the scratch "
                 "pool kept")
        if eng.config.paged and (eng.counts["pages_used"]
                                 != eng.prefix_cache_pages):
            fail(f"3i {name}: pages leaked ({eng.counts['pages_used']} "
                 f"used, {eng.prefix_cache_pages} cached)")
        return eng, hs

    def gen(hs):
        return [h.generated.tolist() for h in hs]

    def same_counts(name, eng, n):
        s = eng.stats
        if not (s["retries"] == s["step_failures"] == n
                and eng.health()["breaker"] == "closed"
                and s["quarantined"] == s["preempted"] == 0):
            fail(f"3i {name}: retries {s['retries']}, failures "
                 f"{s['step_failures']} (injected {n}), breaker "
                 f"{eng.health()['breaker']}, {s}")

    # (a) transient faults, plain in both loops, and a chunked arm
    rec_a, cleans = {}, {}
    for name, kw, inj_kw in (
            ("plain_sync", dict(pipeline=False),
             dict(fail_at=[1, 2, 3], prefill_fail_at=[0])),
            ("plain_pipelined", {},
             dict(fail_at=[1, 2, 3], prefill_fail_at=[0])),
            ("chunked_pipelined", dict(prefill_chunk=256),
             dict(fail_at=[6, 9], prefill_chunk_fail_at=[0]))):
        _, clean = serve(f"{name}_clean", **kw)
        cleans[name] = clean
        inj = ServingFaultInjector(**inj_kw)
        eng, hs = serve(name, inj, **kw)
        if gen(hs) != gen(clean) or inj.injected != 4 - (
                name.startswith("chunked")):
            fail(f"3i (a) {name}: tokens differ from the fault-free run "
                 f"or {inj.injected} faults injected")
        same_counts(f"(a) {name}", eng, inj.injected)
        rec_a[name] = dict(injected=inj.injected,
                           retries=eng.stats["retries"])
    line(dict(phase="3i", arm="transient", requests=n_req, new_tokens=new,
              tokens_equal_fault_free=True, **rec_a))

    # (b) one poisoned request, mid-stream, on five pools
    trees["moe"] = tf.init_params(tf.TransformerConfig(**MOE_FLAGSHIP),
                                  seed=0, device=dev)
    prng = np.random.default_rng(7)
    paged_reqs = paged_traffic(prng, 8, 4, 512, (16, 64), (16, 256))
    sys_prompt = paged_reqs[[p.shape[0] > 512 for p in paged_reqs].index(
        True)][:512]
    ab = ["[ab]+" if k % 2 == 0 else None for k in range(n_req)]
    arms_b = (
        ("plain_pipelined", {}, {}),
        ("paged_shared_prefix", dict(paged=True, page_size=16,
                                     kv_pages=3072 + 1),
         dict(reqs=paged_reqs, before=[sys_prompt])),
        ("int8_kv", dict(kv_quantize="int8"), {}),
        ("constrained", {}, dict(specs=ab)),
        ("moe", {}, dict(tree="moe",
                         mcfg=tf.TransformerConfig(**MOE_FLAGSHIP))))
    for name, kw, arm_kw in arms_b:
        # (a)'s fault-free plain pipelined run is this arm's too
        clean = (cleans["plain_pipelined"] if name == "plain_pipelined"
                 else serve(f"{name}_clean", **kw, **arm_kw)[1])
        inj = ServingFaultInjector()

        def poison(eng, hs):
            inj.poison_requests.add(hs[3].rid)

        eng, hs = serve(name, inj, ticks_before_fault=2, fault=poison,
                        **kw, **arm_kw)
        bad = [k for k, h in enumerate(hs)
               if h.status == RequestStatus.QUARANTINED]
        cut = [committed_before_isolation(h) for h in hs]
        prefix_ok = all(a.generated.tolist()[:n] == b.generated.tolist()[:n]
                        for a, b, n in zip(hs, clean, cut))
        survivors = [k for k in range(len(hs)) if k != 3]
        full = all(hs[k].status == RequestStatus.COMPLETED and
                   hs[k].generated.shape[0] == new for k in survivors
                   if (arm_kw.get("specs") or [None] * 99)[k] is None)
        equal = sum(hs[k].generated.tolist() == clean[k].generated.tolist()
                    for k in survivors)
        s = eng.stats
        if (bad != [3] or s["quarantined"] != 1 or not prefix_ok or not full
                or s["preempted"] < 2 or min(cut) < 1):
            fail(f"3i (b) {name}: quarantined {bad}, prefixes kept "
                 f"{prefix_ok}, survivors full {full}, committed {cut}, {s}")
        if name == "constrained":
            check_constrained("3i (b) constrained", [
                (p, sp, new) for k, (p, sp) in enumerate(zip(prompts, ab))
                if k != 3], [hs[k].result() for k in survivors], eng)
        shares[name] = equal / len(survivors)
        snaps[name] = (eng.fault_snapshot_bytes, eng.scratch_pool_bytes)
        line(dict(phase="3i", arm="poisoned", pool=name, requests=len(hs),
                  quarantined=bad, preempted=s["preempted"],
                  retries=s["retries"], step_failures=s["step_failures"],
                  committed_at_isolation=cut,
                  survivors_token_equal_share=shares[name],
                  snapshot_bytes=snaps[name][0],
                  scratch_pool_bytes=snaps[name][1],
                  kv_pool_bytes=eng.kv_pool_bytes()))

    del trees["moe"]
    # (c) a pipelined tick that fails at its wait
    _, clean = serve("sync_failure_clean")
    fired = []

    def fail_wait(eng, hs):
        def flaky(done):
            fired.append(eng.counts["pipelined_ticks"])
            del eng._wait          # once: the engine's own wait again
            raise RuntimeError("injected sync-time device failure")
        eng._wait = flaky

    eng, hs = serve("sync_failure", ServingFaultInjector(),
                    ticks_before_fault=2, fault=fail_wait)
    s = eng.stats
    cut = [committed_before_isolation(h) for h in hs]
    if not (fired and all(h.status == RequestStatus.COMPLETED
                          and h.generated.shape[0] == new for h in hs)
            and s["preempted"] > 0 and not eng._pending
            and all(a.generated.tolist()[:n] == b.generated.tolist()[:n]
                    for a, b, n in zip(hs, clean, cut))):
        fail(f"3i (c): fired {fired}, {s}, pending {len(eng._pending)}")
    shares["sync_failure"] = sum(
        a.generated.tolist() == b.generated.tolist()
        for a, b in zip(hs, clean)) / len(hs)
    line(dict(phase="3i", arm="sync_time_failure", fired_at_tick=fired[0],
              preempted=s["preempted"], committed_at_isolation=cut,
              survivors_token_equal_share=shares["sync_failure"]))

    # (d) page corruption on a writer sharing a prefix with a reader
    pkw = dict(paged=True, page_size=16, kv_pages=3072 + 1, pipeline=False)
    # a 560-token prompt: after one tick (the prefill and a chunk of 8)
    # the writer's next write is row 568, so the page it lands in (rows
    # 560-575) also holds 8 committed rows that its next calls read
    p = np.concatenate([sys_prompt, np.arange(48, dtype=np.int32)])

    def corrupt(inj):
        def go(eng, hs):
            inj.corrupt_page_at[eng._step_counter] = hs[1].rid
        return go

    runs = {}
    for arm_name, inj in (("clean", None),
                          ("corrupt", ServingFaultInjector())):
        runs[arm_name] = serve(
            f"corrupt_page_{arm_name}", inj, reqs=[p, p, p], before=[p],
            ticks_before_fault=1,
            fault=None if inj is None else corrupt(inj), **pkw)
    (_, hc), (ec, hx) = runs["clean"], runs["corrupt"]
    reader_ok = gen([hx[0], hx[2]]) == gen([hc[0], hc[2]])
    writer_changed = hx[1].generated.tolist() != hc[1].generated.tolist()
    if not (ec._injector.pages_corrupted == 1 and reader_ok
            and writer_changed):
        fail(f"3i (d): pages corrupted {ec._injector.pages_corrupted}, "
             f"readers equal {reader_ok}, writer changed {writer_changed}")
    line(dict(phase="3i", arm="corrupt_page", pages_corrupted=1,
              readers_equal_clean=reader_ok, writer_changed=writer_changed))

    # (e) a poisoned draft round: K falls to 1, spec still equals plain
    trees["aligned"] = aligned_params(tf, cfg, dev)
    _, plain = serve("spec_plain", tree="aligned", pipeline=False)
    inj = ServingFaultInjector(draft_poison_at={1: 3})     # hs[2]
    k_after = []

    def after_first(eng, hs):
        k_after.append(eng.spec_k_current)

    eng, hs = serve("spec_poisoned", inj, tree="aligned",
                    ticks_before_fault=1, fault=after_first,
                    spec_decode=True, spec_k=7, draft="layers:1",
                    pipeline=False)
    ev = hs[2].trace.events
    j = [k for k, e in enumerate(ev) if e.kind == "draft_rejected"]
    nxt = [e for e in ev[j[0]:] if e.kind == "decode_chunk"] if j else []
    if not (inj.drafts_poisoned == 1 and len(j) == 1
            and ev[j[0]].data["poisoned"] and nxt
            and nxt[0].data["tokens"] == 1 and k_after == [1]
            and gen(hs) == gen(plain)):
        fail(f"3i (e): poisoned {inj.drafts_poisoned}, rejected events "
             f"{j}, K after the round {k_after}, spec == plain "
             f"{gen(hs) == gen(plain)}")
    line(dict(phase="3i", arm="draft_poison", spec_k=7,
              k_after_poisoned_round=k_after[0],
              committed_that_round=nxt[0].data["tokens"],
              spec_equals_plain=True, spec_rounds=eng.counts["spec_rounds"]))

    # (f) float32 (phase 2's model): poison and a sync-time failure, card
    # against the fault-free card run and the CPU engine
    fcfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                                n_layers=2, max_len=2048, dtype="float32")
    frng = np.random.default_rng(1)
    fprompts = [frng.integers(0, 256, size=int(n)).astype(np.int32)
                for n in frng.integers(8, 65, size=8)]
    fkw = dict(num_slots=8, decode_chunk=8, max_new_tokens=32,
               backoff_base_s=0.0)
    f32 = {}
    # every engine of (a)-(e) dropped: none may hold its pool or its
    # graphs (an engine is freed by its last reference, with no cyclic
    # collection). torch keeps a 32 MiB cuBLAS workspace for each stream
    # a GEMM ran on, and each engine's graphs capture on a stream of
    # their own: those are cleared before the gate reads what is left.
    del eng, hs, plain, runs, hc, hx, ec, clean, _, trees["aligned"]
    held = torch.cuda.memory_allocated(dev) - alloc0
    torch._C._cuda_clearCublasWorkspaces()
    left = torch.cuda.memory_allocated(dev) - alloc0
    line(dict(phase="3i", run="engines_dropped", bytes_held=held,
              bytes_held_without_cublas_workspaces=left,
              pool_bytes=snaps["plain_pipelined"][1]))
    if left >= 64 << 20:
        fail(f"3i: {left} bytes still allocated with every engine "
             "dropped (cuBLAS workspaces cleared)")
    zero_launches()
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        ftree = tf.init_params(fcfg, seed=1, device=d)
        for arm_name in ("clean", "poison", "sync_failure"):
            inj = None if arm_name == "clean" else ServingFaultInjector()
            e = InferenceEngine(fcfg, ftree, EngineConfig(**fkw), device=d,
                                fault_injector=inj)
            hs = [e.submit(q) for q in fprompts]
            e.tick()
            e.tick()
            if arm_name == "poison":
                inj.poison_requests.add(hs[3].rid)
            elif arm_name == "sync_failure":
                def flaky(done, e=e):
                    del e._wait
                    raise RuntimeError("injected sync-time failure")
                e._wait = flaky
            e.run_pending()
            f32[(where, arm_name)] = ([h.status for h in hs], gen(hs),
                                      e.stats["preempted"])
    (st_p, g_p, n_p), (st_s, g_s, n_s) = (f32[("cuda", "poison")],
                                          f32[("cuda", "sync_failure")])
    g_clean = f32[("cuda", "clean")][1]
    f_ok = (f32[("cuda", "poison")] == f32[("cpu", "poison")]
            and f32[("cuda", "sync_failure")] == f32[("cpu", "sync_failure")]
            and g_clean == f32[("cpu", "clean")][1]
            and st_p.count(RequestStatus.QUARANTINED) == 1
            and st_p[3] == RequestStatus.QUARANTINED
            and all(g_p[k] == g_clean[k] for k in range(8) if k != 3)
            and g_s == g_clean and n_p > 0 and n_s > 0)
    if not f_ok:
        fail(f"3i (f) float32: {f32}")
    for k, n in read_launches().items():
        totals[k] += n
    line(dict(phase="3i", arm="float32", requests=8, new_tokens=32,
              poison_survivors_equal_clean=True,
              sync_failure_equal_clean=True, card_equals_cpu=True,
              preempted={"poison": n_p, "sync_failure": n_s}))

    # (g) the lifecycle: worker, drain, deadline and cancel, stop
    zero_launches()
    eng = InferenceEngine(cfg, trees["dense"], EngineConfig(**base),
                          device=dev).start()
    hs = [eng.submit(q) for q in prompts]
    while not any(h.done() for h in hs[:1]) and not eng._pending:
        time.sleep(0.001)
    eng.drain(wait=False)
    flipped = (not eng.ready()) and not all(h.done() for h in hs)
    try:
        eng.submit(prompts[0])
        refused = False
    except EngineDraining:
        refused = True
    eng.drain(wait=True, timeout=300)
    done_ok = all(h.status == RequestStatus.COMPLETED
                  and h.generated.shape[0] == new for h in hs)
    eng.resume()
    eng.stop()
    # the worker's ticks ran off the main thread: their faults are read
    # here, with the worker stopped
    check_zero_fault_gate("3i (g), the worker's ticks")
    stopped = eng._thread is None and not eng.ready()
    t = {"now": 0.0}
    eng2 = InferenceEngine(cfg, trees["dense"], EngineConfig(**base),
                           device=dev, clock=lambda: t["now"])
    h_dead = eng2.submit(prompts[0], deadline_s=1.0)
    h_live = eng2.submit(prompts[1])
    h_cancel = eng2.submit(prompts[2])
    eng2.tick()
    eng2.tick()
    t["now"] = 5.0
    eng2.cancel(h_cancel)
    eng2.run_pending()
    shed = (h_dead.status, h_cancel.status, h_live.status)
    if not (flipped and refused and done_ok and stopped
            and shed == ("shed", "shed", "completed")
            and eng2.stats["shed_deadline"] == 1):
        fail(f"3i (g): ready flipped before the last resident {flipped}, "
             f"submit refused {refused}, all completed {done_ok}, stopped "
             f"{stopped}, shed {shed}")
    for k, n in read_launches().items():
        totals[k] += n
    line(dict(phase="3i", arm="lifecycle", worker_wave=len(hs),
              ready_flipped_while_resident=flipped, draining_refused=refused,
              deadline_and_cancel_shed=True, stopped=stopped))
    line(dict(phase="3i", run="summary", survivors_token_equal_share=shares,
              snapshot_and_scratch_bytes=snaps, launches=totals))
    return totals


# ---------------------------------------------------------------------------
# phase 3j: engine control at full width (batch mode, tenant QoS, reload)
# ---------------------------------------------------------------------------

class BatchListener:
    """A listener of the engine's protocol: the sizes `record_batch` saw
    and the (index, latency) pairs of `iteration_done`."""

    def __init__(self):
        self.sizes, self.done = [], []

    def record_batch(self, n):
        self.sizes.append(int(n))

    def iteration_done(self, engine, idx, latency):
        self.done.append((int(idx), float(latency)))


def first_token_s(h):
    """Host seconds from a request's submit to its first committed token
    (the recorder's clock)."""
    ts = {e.kind: e.ts for e in reversed(h.trace.events)}
    return ts["prefill_done"] - ts["submit"]


def zeroed_tree(tree):
    return {k: (zeroed_tree(v) if isinstance(v, dict) else v * 0)
            for k, v in tree.items()}


def phase_engine_control_full_width(torch, dev):
    """Phase 3's bf16 flagship (12L / 512d / 8 heads, max_len 2048) and
    phase 2's float32 model under the engine's control surface (module
    docstring, 3j): (a) batch mode, (b) fair-share prefill, (c) priority
    preemption and `qos_control`, (d) hot reload. Returns the wrappers'
    launches by kernel over the phase."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel import serving as ps
    from deeplearning4j_tpu_torch.parallel.failure import (
        FaultInjector, ServingFaultInjector, hostile_tenant_storm,
        storm_prompt)
    from deeplearning4j_tpu_torch.quant.core import QuantizedTensor
    from deeplearning4j_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine, RequestStatus)
    from deeplearning4j_tpu_torch.util.checkpointing import \
        CheckpointManager
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=12, max_len=2048, dtype="bfloat16")
    L = cfg.n_layers
    tree = tf.TransformerLM(cfg, seed=0, device=dev).params
    base = dict(max_queue=256, degrade_queue_depth=1024)
    totals = {k: 0 for k in launch_counters()}
    done_ok = RequestStatus.COMPLETED

    def add(got):
        for k in totals:
            totals[k] += got[k]

    def gen(hs):
        return [h.generated.tolist() for h in hs]

    def complete(hs, n):
        return all(h.status == done_ok and h.generated.shape[0] == n
                   for h in hs)

    # (a) batch mode: 48 requests, 16 at each of three prompt lengths
    rng = np.random.default_rng(16)
    groups, new, bchunk = (128, 512, 1024), 64, 16
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for _ in range(16) for n in groups]
    bkw = dict(base, mode="batch", max_batch_size=16, decode_chunk=bchunk,
               max_new_tokens=new)
    eng = InferenceEngine(cfg, tree, EngineConfig(**bkw), device=dev)
    lst = BatchListener()
    eng.set_listeners(lst)
    formed = []
    process = eng._process_batch

    def watched_batch(batch):
        formed.append((sorted({r.prompt.shape[0] for r in batch}),
                       len(batch)))
        process(batch)
    eng._process_batch = watched_batch
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p) for p in prompts]
    n_batches = eng.run_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    add(got)
    calls = len(groups) * (new // bchunk)
    want = dict(flash_fwd=L * calls, decode_attention=L * (bchunk - 1)
                * calls, decode_window=0)
    sizes = [e.data["batch_size"] for h in hs for e in h.trace.events
             if e.kind == "admitted"]
    if not (n_batches == 3 and eng.stats["batches"] == 3
            and lst.sizes == [16, 16, 16] and set(sizes) == {16}
            and formed == [([n], 16) for n in groups]
            and complete(hs, new) and eng.stats["in_flight"] == 0
            and {k: got[k] for k in want} == want
            and eng.debugz()["tick_pipeline"]["fallback_reason"] == "batch"):
        fail(f"3j (a): {n_batches} batches, sizes {lst.sizes}, launches "
             f"{got} (want {want}), {eng.stats}")
    def direct(batch):
        """``batch``'s tokens from `make_parallel_generate` called as the
        engine calls it: prompt + generated re-prefilled every
        ``bchunk`` tokens, keyed by (seed 0, its length)."""
        toks = torch.from_numpy(np.stack(batch)).to(dev)
        t0_ = toks.shape[1]
        while toks.shape[1] - t0_ < new:
            n = min(bchunk, new - (toks.shape[1] - t0_))
            toks = ps.make_parallel_generate(cfg, n)(
                tree, toks, ps.batch_key(0, toks.shape[1]))
        return toks[:, t0_:].cpu().numpy().tolist()

    # the engine's tokens are the same calls made directly, at B=16 and
    # (a batch engine of one request at a time) at B=1
    same16 = all(direct([h.prompt for h in hs if h.prompt.shape[0] == n])
                 == [h.generated.tolist() for h in hs
                     if h.prompt.shape[0] == n] for n in groups)
    ref_idx = [k for k in range(len(prompts)) if k % 16 < 2]
    one = InferenceEngine(cfg, tree, EngineConfig(**{**bkw,
                                                     "max_batch_size": 1}),
                          device=dev)
    h1 = [one.submit(prompts[k]) for k in ref_idx]
    one.run_pending()
    same1 = all(direct([h.prompt]) == [h.generated.tolist()] for h in h1)
    add(read_launches())
    b1_equal = sum(a.generated.tolist() == hs[k].generated.tolist()
                   for a, k in zip(h1, ref_idx))
    line(dict(phase="3j", arm="batch", requests=len(hs), groups=groups,
              new_tokens=new, decode_chunk=bchunk, batches=n_batches,
              wall_s=wall, tokens_per_s=len(hs) * new / wall,
              batch_latency_s=[lat for _, lat in lst.done],
              generate_calls=calls, flash_launches=got["flash_fwd"],
              decode_launches=got["decode_attention"],
              flash_per_call=got["flash_fwd"] / calls,
              decode_per_call=got["decode_attention"] / calls,
              equals_direct_calls_b16=same16, equals_direct_calls_b1=same1,
              b1_requests=len(ref_idx),
              b1_token_equal_to_b16=b1_equal))
    if not (same16 and same1):
        fail(f"3j (a): the engine's tokens differ from the same generate "
             f"calls made directly (B=16 {same16}, B=1 {same1})")
    g128 = [p for p in prompts if p.shape[0] == 128]
    clean = [h for h in hs if h.prompt.shape[0] == 128]
    del eng, one
    inj = ServingFaultInjector(fail_at=[1])
    eng = InferenceEngine(cfg, tree, EngineConfig(**bkw), device=dev,
                          fault_injector=inj)
    zero_launches()
    hf = [eng.submit(p) for p in g128]
    eng.run_pending()
    got = read_launches()
    add(got)
    if not (gen(hf) == gen(clean) and inj.injected == 1
            and eng.stats["retries"] == eng.stats["step_failures"] == 1
            and got["flash_fwd"] == L * eng._step_counter):
        fail(f"3j (a) transient: injected {inj.injected}, {eng.stats}, "
             f"launches {got}, tokens equal {gen(hf) == gen(clean)}")
    inj = ServingFaultInjector()
    eng = InferenceEngine(cfg, tree, EngineConfig(**{**bkw,
                                                     "max_retries": 1}),
                          device=dev, fault_injector=inj)
    zero_launches()
    hq = [eng.submit(p) for p in g128]
    inj.poison_requests.add(hq[5].rid)
    eng.run_pending()
    got = read_launches()
    add(got)
    bad = [k for k, h in enumerate(hq) if h.status != done_ok]
    peers = [h for k, h in enumerate(hq) if k != 5]
    if not (bad == [5] and hq[5].status == RequestStatus.QUARANTINED
            and complete(peers, new) and eng.stats["quarantined"] == 1
            and got["flash_fwd"] == L * eng._step_counter
            and got["decode_attention"] == L * (bchunk - 1)
            * eng._step_counter):
        fail(f"3j (a) isolation: not completed {bad}, {eng.stats}, "
             f"launches {got}")
    line(dict(phase="3j", arm="batch_faults", transient_tokens_equal=True,
              quarantined=bad, peers_completed=len(peers),
              solo_calls=eng._step_counter,
              peers_token_equal_clean=sum(
                  a.generated.tolist() == b.generated.tolist()
                  for a, b in zip(peers, clean[:5] + clean[6:]))))
    del eng

    # (b) fair-share prefill under the hostile storm
    arrivals, _ = hostile_tenant_storm(
        ticks=8, hostiles=3, flood_per_tick=1, victim_every=1,
        victim_prompt=128, victim_new=32, hostile_prompt=1024,
        hostile_new=32)
    weights = {"victim": 3.0, "hostile0": 1.0, "hostile1": 1.0,
               "hostile2": 1.0}
    wsum = sum(weights.values())
    # 64 slots: 7 of the 8 victims seat with the first wave, so their
    # TTFT measures the prefill schedule, not the wait for a slot
    fkw = dict(base, num_slots=64, decode_chunk=8, max_new_tokens=32,
               prefill_chunk=256, tick_token_budget=512)
    storm = {}
    for name, kw in (("chunked", dict(tenant_weights=weights)),
                     ("paged_chunked", dict(tenant_weights=weights,
                                            paged=True, page_size=16))):
        eng = InferenceEngine(cfg, tree, EngineConfig(**fkw, **kw),
                              device=dev)
        recs = []
        if "tenant_weights" in kw:
            credit = eng._qos_credit

            def watched(budget, eng=eng, credit=credit, recs=recs):
                demand = {}
                for _, r in eng._occupied():
                    if eng._is_prefilling(r) and not r.done():
                        t = r.tenant or "default"
                        demand[t] = demand.get(t, 0) + (r._prefill_target
                                                        - r._prefill_pos)
                recs.append([budget, demand, {}])
                credit(budget)
            eng._qos_credit = watched
        zero_launches()
        keys0 = eng._graphs.keys()
        c0 = dict(eng.counts)
        t0 = time.perf_counter()
        hs = [(a, eng.submit(storm_prompt(a, cfg.vocab_size),
                             max_new_tokens=a.max_new_tokens,
                             tenant=a.tenant, priority=a.priority))
              for a in arrivals]
        ticks = 0
        qos = eng._m_qos_prefill_tokens
        while True:
            before = ({t: qos.labels(t).value for t in weights}
                      if qos is not None else {})
            n0 = len(recs)
            busy = eng.tick()
            ticks += 1
            if before and len(recs) > n0:
                recs[-1][2] = {t: qos.labels(t).value - before[t]
                               for t in weights}
            if not busy:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        add(got)
        c = {k: eng.counts[k] - c0[k] for k in c0}
        check_launches(eng, c, L, got, f"3j (b) {name}", keys0)
        if not complete([h for _, h in hs], 32):
            fail(f"3j (b) {name}: not every request completed")
        if eng.config.paged and (eng.counts["pages_used"]
                                 != eng.prefix_cache_pages):
            fail(f"3j (b) {name}: pages leaked")
        ttft = [first_token_s(h) for a, h in hs if a.tenant == "victim"]
        rec = dict(phase="3j", arm="fair_share", pool=name,
                   requests=len(hs), ticks=ticks, wall_s=wall,
                   victim_ttft_s_mean=float(np.mean(ttft)),
                   victim_ttft_s_max=float(np.max(ttft)),
                   prefill_chunks=c["prefill_chunks"])
        if recs:
            # the backlogged ticks: every tenant's prefill demand at least
            # its weighted share of the tick's prefill budget
            full = [r for r in recs if r[0] > 0 and all(
                r[1].get(t, 0) >= r[0] * w / wsum
                for t, w in weights.items())]
            granted = sum(sum(r[2].values()) for r in full)
            share = (sum(r[2].get("victim", 0) for r in full) / granted
                     if granted else None)
            waits = {}
            for t, w in weights.items():
                run = worst = 0
                for r in recs:
                    if r[0] <= 0 or r[1].get(t, 0) <= 0:
                        continue
                    run = run + 1 if r[2].get(t, 0) == 0 else 0
                    worst = max(worst, run)
                waits[t] = (worst, int(np.ceil(wsum / w)))
            rec.update(backlogged_ticks=len(full), victim_share=share,
                       victim_weight_share=weights["victim"] / wsum,
                       longest_unserved_ticks=waits,
                       granted={t: qos.labels(t).value for t in weights})
            if not full or share is None or abs(
                    share - weights["victim"] / wsum) > 0.15 * (
                    weights["victim"] / wsum):
                fail(f"3j (b) {name}: victim share {share} over "
                     f"{len(full)} backlogged ticks")
            if any(a > b for a, b in waits.values()):
                fail(f"3j (b) {name}: a backlogged tenant waited past "
                     f"its bound: {waits}")
        storm[name] = rec
        line(rec)
        del eng, hs
    line(dict(phase="3j", run="fair_share_ttft",
              victim_ttft_s_mean_qos=storm["chunked"]["victim_ttft_s_mean"],
              victim_ttft_s_mean_paged_qos=storm["paged_chunked"][
                  "victim_ttft_s_mean"]))

    # (c) priority preemption on 64 residents, then qos_control
    prng = np.random.default_rng(0)                # phase 3's traffic
    lens = prng.integers(16, 1025, size=128)
    p3 = [prng.integers(0, 256, size=int(n)).astype(np.int32)
          for n in lens]
    highs = [prng.integers(0, 256, size=int(n)).astype(np.int32)
             for n in (64, 96, 128, 160, 192, 256)]
    pkw = dict(base, num_slots=64, decode_chunk=8, max_new_tokens=32,
               preemption_budget=2)
    eng = InferenceEngine(cfg, tree, EngineConfig(**pkw), device=dev)
    zero_launches()
    keys0 = eng._graphs.keys()
    c0 = dict(eng.counts)
    hl = [eng.submit(p, tenant="batch") for p in p3[:64]]
    eng.tick()
    eng.tick()
    resident = sum(r is not None for r in eng._slots)
    hh = [eng.submit(p, tenant="urgent", priority=5) for p in highs]
    per_tick = []
    while True:
        p0 = eng._m_qos_preemptions.labels("batch").value
        busy = eng.tick()
        per_tick.append(int(eng._m_qos_preemptions.labels("batch").value
                            - p0))
        if not busy:
            break
    got = read_launches()
    add(got)
    c = {k: eng.counts[k] - c0[k] for k in c0}
    check_launches(eng, c, L, got, "3j (c) preemption", keys0)
    pre = sum(e.kind == "preempted" for h in hl for e in h.trace.events)
    if not (resident == 64 and max(per_tick) <= 2 and sum(per_tick) >= 1
            and complete(hh, 32) and complete(hl, 32)
            and pre == sum(per_tick) == eng.stats["preempted"]):
        fail(f"3j (c): {resident} resident, evictions a tick {per_tick}, "
             f"preempted {pre}, highs complete {complete(hh, 32)}")
    line(dict(phase="3j", arm="preemption", residents=resident,
              high_priority=len(hh), preemption_budget=2,
              evictions_per_tick=per_tick, preempted=pre,
              high_lost=0, flash_launches=got["flash_fwd"],
              prefill_calls=c["prefill_calls"]))
    del eng
    # float32: a preempted stream equals its uninterrupted run
    fcfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                                n_layers=2, max_len=2048, dtype="float32")
    ftree = tf.init_params(fcfg, seed=1, device=dev)
    frng = np.random.default_rng(1)
    flows = [frng.integers(0, 256, size=int(n)).astype(np.int32)
             for n in frng.integers(8, 65, size=8)]
    fhigh = [frng.integers(0, 256, size=int(n)).astype(np.int32)
             for n in (24, 40, 56)]
    f32kw = dict(num_slots=8, decode_chunk=8, max_new_tokens=32)
    ref = InferenceEngine(fcfg, ftree, EngineConfig(**f32kw), device=dev)
    href = [ref.submit(p) for p in flows + fhigh]
    ref.run_pending()
    eng = InferenceEngine(fcfg, ftree, EngineConfig(
        **f32kw, preemption_budget=2), device=dev)
    fl = [eng.submit(p) for p in flows]
    eng.tick()
    eng.tick()
    fh = [eng.submit(p, priority=3) for p in fhigh]
    eng.run_pending()
    add(read_launches())
    fpre = sum(any(e.kind == "preempted" for e in h.trace.events)
               for h in fl)
    if not (fpre >= 1 and gen(fl + fh) == gen(href)):
        fail(f"3j (c) float32: {fpre} preempted, tokens equal the "
             f"uninterrupted run {gen(fl + fh) == gen(href)}")
    del eng, ref
    # qos_control on the spec engine (K=7, "layers:1", aligned tree)
    aligned = aligned_params(tf, cfg, dev)
    skw = dict(base, num_slots=16, decode_chunk=8, max_new_tokens=32,
               spec_decode=True, spec_k=7, draft="layers:1")
    runs = {}
    for name in ("untouched", "controlled"):
        eng = InferenceEngine(cfg, aligned, EngineConfig(**skw), device=dev)
        hs = [eng.submit(p) for p in p3[:16]]
        eng.tick()
        eng.tick()
        paused = None
        if name == "controlled":
            eng.qos_control(spec_off=True, decode_chunk=2)
            r0 = eng.counts["spec_rounds"]
            for _ in range(3):
                eng.tick()
            paused = eng.counts["spec_rounds"] == r0
            eng.qos_control(decode_chunk=0)
            eng.qos_control(spec_off=False)
        eng.run_pending()
        add(read_launches())
        runs[name] = (gen(hs), paused, eng._graphs.keys())
        del eng
    keys = runs["controlled"][2]
    if not (runs["controlled"][0] == runs["untouched"][0]
            and runs["controlled"][1] and ("decode", 2) in keys
            and ("spec", 7) in keys):
        fail(f"3j (c) qos_control: tokens equal "
             f"{runs['controlled'][0] == runs['untouched'][0]}, spec "
             f"paused {runs['controlled'][1]}, graphs {keys}")
    line(dict(phase="3j", arm="qos_control", float32_preempted=int(fpre),
              float32_token_exact=True, spec_off_and_chunk_2_then_0=True,
              committed_tokens_unchanged=True, graph_keys=keys))

    # (d) hot reload from the port's checkpoints
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3j_")
    try:
        inj = FaultInjector(torn_write_at=[3])
        mgr = CheckpointManager(os.path.join(tmp, "w"), fault_injector=inj)
        zt = zeroed_tree(tree)
        t0 = time.perf_counter()
        mgr.save_tree(tree, 1)
        mgr.save_tree(zt, 2)
        mgr.save_tree(tree, 3)               # torn after publication
        save_s = (time.perf_counter() - t0) / 3
        dkw = dict(base, num_slots=16, decode_chunk=8, max_new_tokens=32)
        wa, wb, wc = p3[:16], p3[16:32], p3[32:48]
        eng = InferenceEngine(cfg, tree, EngineConfig(**dkw), device=dev)
        ha = [eng.submit(p) for p in wa]
        eng.run_pending()
        first = gen(ha)
        hb = [eng.submit(p) for p in wb]
        eng.tick()
        eng.tick()
        held = [h.generated.copy() for h in hb]
        pend = len(eng._pending)
        t0 = time.perf_counter()
        step = eng.reload_weights(mgr)
        reload_s = time.perf_counter() - t0
        queued = all(h.status == RequestStatus.QUEUED for h in hb)
        add(read_launches())
        zero_launches()
        c0 = dict(eng.counts)
        hc = [eng.submit(p) for p in wc]
        eng.run_pending()
        got = read_launches()
        add(got)
        c = {k: eng.counts[k] - c0[k] for k in c0}
        check_launches(eng, c, L, got, "3j (d) after reload")
        fresh = InferenceEngine(cfg, zt, EngineConfig(**dkw), device=dev)
        hz = [fresh.submit(p) for p in wc]
        fresh.run_pending()
        add(read_launches())
        del fresh
        kept = all(h.generated[:k.shape[0]].tolist() == k.tolist()
                   for h, k in zip(hb, held))
        step_back = eng.reload_weights(mgr, step=1)
        ha2 = [eng.submit(p) for p in wa]
        eng.run_pending()
        add(read_launches())
        if not (step == 2 and inj.writes_torn == 1 and pend == 1 and queued
                and kept and complete(hb + hc, 32) and gen(hc) == gen(hz)
                and step_back == 1 and gen(ha2) == first
                and eng.stats["reloads"] == 2
                and eng.health()["weights_step"] == 1
                and got["flash_fwd"] > 0 and got["decode_attention"] > 0):
            fail(f"3j (d) reload: step {step} (torn {inj.writes_torn}), "
                 f"pending {pend}, requeued {queued}, committed kept {kept},"
                 f" zeroed == fresh {gen(hc) == gen(hz)}, back {step_back},"
                 f" first wave again {gen(ha2) == first}, {eng.stats}")
        line(dict(phase="3j", arm="reload", torn_step_fell_back_to=step,
                  tick_pending_at_reload=pend, requeued=len(hb),
                  committed_prefix_kept=kept, zeroed_equals_fresh=True,
                  reload_back_equals_first_wave=True,
                  save_s_per_step=save_s, reload_s=reload_s,
                  launches_after_reload=got,
                  graph_captures_after_reload=c["graph_captures"]))
        del eng
        # paged: the prefix cache is flushed and no page leaks
        prng2 = np.random.default_rng(7)
        preqs = paged_traffic(prng2, 8, 4, 512, (16, 64), (16, 256))
        sysp = preqs[[p.shape[0] > 512 for p in preqs].index(True)][:512]
        eng = InferenceEngine(cfg, tree, EngineConfig(
            **dkw, paged=True, page_size=16, kv_pages=3072 + 1),
            device=dev)
        eng.submit(sysp)
        eng.run_pending()
        cached = eng.prefix_cache_pages
        hp = [eng.submit(p) for p in preqs]
        eng.tick()
        eng.tick()
        eng.reload_weights(mgr, step=1)
        flushed = (eng.prefix_cache_pages == 0
                   and eng.counts["pages_used"] == 0)
        eng.run_pending()
        add(read_launches())
        if not (cached > 0 and flushed and complete(hp, 32)
                and eng.counts["pages_used"] == eng.prefix_cache_pages):
            fail(f"3j (d) paged: cached {cached}, flushed {flushed}, "
                 f"pages {eng.counts['pages_used']} used, "
                 f"{eng.prefix_cache_pages} cached")
        del eng
        # int8 and spec: another tree, and the aligned one
        mgr2 = CheckpointManager(os.path.join(tmp, "w2"))
        tree_b = tf.init_params(cfg, seed=1, device=dev)
        mgr2.save_tree(tree_b, 1)
        mgr2.save_tree(aligned, 2)
        q = {}
        for name, t in (("reloaded", tree), ("built", tree_b)):
            e = InferenceEngine(cfg, t, EngineConfig(**dkw, quantize="int8"),
                                device=dev)
            if name == "reloaded":
                e.reload_weights(mgr2, step=1)
                requant = isinstance(e._params["Wout"], QuantizedTensor)
            hs = [e.submit(p) for p in wa]
            e.run_pending()
            add(read_launches())
            q[name] = gen(hs)
            del e
        s = {}
        for name, t, kw in (
                ("spec_reloaded", tree, dict(spec_decode=True, spec_k=7,
                                             draft="layers:1")),
                ("plain_aligned", aligned, {})):
            e = InferenceEngine(cfg, t, EngineConfig(**dkw, **kw),
                                device=dev)
            if name == "spec_reloaded":
                e.reload_weights(mgr2, step=2)
            zero_launches()
            keys0 = e._graphs.keys()
            c0 = dict(e.counts)
            hs = [e.submit(p) for p in wa]
            e.run_pending()
            got = read_launches()
            add(got)
            check_launches(e, {k: e.counts[k] - c0[k] for k in c0}, L, got,
                           f"3j (d) {name}", keys0)
            s[name] = (gen(hs), got)
            del e
        if not (requant and q["reloaded"] == q["built"]
                and s["spec_reloaded"][0] == s["plain_aligned"][0]
                and s["spec_reloaded"][1]["decode_window"] > 0):
            fail(f"3j (d) int8 requantized {requant}, int8 == built "
                 f"{q['reloaded'] == q['built']}, spec == plain "
                 f"{s['spec_reloaded'][0] == s['plain_aligned'][0]}, "
                 f"launches {s['spec_reloaded'][1]}")
        # float32: a reload to the same weights with a tick pending
        mgr3 = CheckpointManager(os.path.join(tmp, "w3"))
        mgr3.save_tree(ftree, 1)
        fkw32 = dict(num_slots=8, decode_chunk=8, max_new_tokens=32)
        ref = InferenceEngine(fcfg, ftree, EngineConfig(**fkw32), device=dev)
        href = [ref.submit(p) for p in flows]
        ref.run_pending()
        e = InferenceEngine(fcfg, ftree, EngineConfig(**fkw32), device=dev)
        hs = [e.submit(p) for p in flows]
        e.tick()
        e.tick()
        fpend = len(e._pending)
        e.reload_weights(mgr3)
        e.run_pending()
        add(read_launches())
        if not (fpend == 1 and e.stats["preempted"] > 0
                and gen(hs) == gen(href)):
            fail(f"3j (d) float32: pending {fpend}, {e.stats}, tokens equal "
                 f"{gen(hs) == gen(href)}")
        line(dict(phase="3j", arm="reload_pools", paged_cache_flushed=True,
                  paged_pages_leaked=0, int8_requantized=requant,
                  int8_equals_built=True, spec_equals_plain=True,
                  spec_window_launches=s["spec_reloaded"][1]["decode_window"],
                  float32_pending_tick_token_exact=True,
                  float32_preempted=e.stats["preempted"]))
        del e, ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line(dict(phase="3j", run="summary", launches=totals))
    return totals


# ---------------------------------------------------------------------------
# phase 3k: the compile cache, warm-up and KV handoff at full width
# ---------------------------------------------------------------------------

K3_CHILD = "--3k-child"
K3_REQUESTS, K3_NEW = 8, 16


def k3_config(tf, dtype="bfloat16"):
    return tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                                n_layers=12, max_len=2048, dtype=dtype)


def k3_prompts(seed, n=K3_REQUESTS, lo=16, hi=1025):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(t)).astype(np.int32)
            for t in rng.integers(lo, hi, size=n)]


def phase_3k_child(root: str, cache_dir: str) -> int:
    """One fresh process of phase 3k (a), importing the port from the copy
    at ``root`` (so its build directory, ``root/build/torch_kernels``,
    starts empty): phase 3's bf16 engine with ``compile_cache_dir`` and
    ``warmup_on_init``, 8 requests, ticked until the first token, then
    drained. The zero-failure gate (`install_zero_fault_gate`) is put on
    this process's own engine class, which is not the parent's: a
    failed program call or an isolation ends the child at once, and
    every handle must complete. Prints one JSON line: the wall-clock
    moment of the first token, the warm-up report, nvcc's runs and
    seconds, where each library came from, the cache's bytes, the
    faults seen (0), the handles' statuses and the tokens."""
    started_at = time.time()
    sys.path.insert(0, root)
    import torch
    import deeplearning4j_tpu_torch
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    if not deeplearning4j_tpu_torch.__file__.startswith(root):
        fail(f"3k child imported the port from "
             f"{deeplearning4j_tpu_torch.__file__}, not from {root}")
    install_zero_fault_gate(InferenceEngine)
    dev = torch.device("cuda")
    cfg = k3_config(tf)
    tree = tf.TransformerLM(cfg, seed=0, device=dev).params
    engine_at = time.time()
    eng = InferenceEngine(cfg, tree, EngineConfig(
        num_slots=64, decode_chunk=8, max_new_tokens=K3_NEW, max_queue=256,
        degrade_queue_depth=1024, compile_cache_dir=cache_dir,
        warmup_on_init=True), device=dev)
    hs = [eng.submit(p) for p in k3_prompts(18)]
    while not any(h.generated.shape[0] for h in hs):
        eng.tick()
    first_token_at = time.time()
    eng.run_pending()
    torch.cuda.synchronize()
    check_zero_fault_gate("3k child")
    statuses = sorted({str(h.status) for h in hs})
    if statuses != ["completed"]:
        fail(f"3k child: handles ended {statuses}")
    print(json.dumps(dict(
        started_at=started_at, engine_at=engine_at,
        first_token_at=first_token_at, warmup=eng.last_warmup,
        nvcc_runs=_build.nvcc_runs, build_seconds=_build.build_seconds,
        origin=_build.origin, build_dir=str(_build.BUILD_DIR),
        cache_bytes=eng._aot.nbytes(), cache_entries=eng._aot.entries(),
        compiles=eng._compiles_by_source(),
        faults=len(ZERO_FAULT_SEEN), statuses=statuses,
        tokens=[h.generated.tolist() for h in hs],
        kind=torch.cuda.get_device_name(0))), flush=True)
    return 0


def k3_restart(cache_dir: str, tag: str) -> dict:
    """Phase 3k (a): one child process (`phase_3k_child`) on a fresh copy
    of the package; its record with ``restart_to_first_token_s``, from
    the parent's spawn to the child's first token."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix=f"dl4j-3k-{tag}-")
    try:
        shutil.copytree(os.path.join(ROOT, "deeplearning4j_tpu_torch"),
                        os.path.join(root, "deeplearning4j_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        spawned_at = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), K3_CHILD, root,
             cache_dir], capture_output=True, text=True, timeout=600)
        wall = time.time() - spawned_at
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if proc.returncode != 0:
        fail(f"3k (a) {tag} process exited {proc.returncode}: "
             f"{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if not rec["build_dir"].startswith(root):
        fail(f"3k (a) {tag}: build directory {rec['build_dir']}")
    rec.update(tag=tag, process_wall_s=wall,
               restart_to_first_token_s=rec["first_token_at"] - spawned_at,
               process_start_to_engine_s=rec["engine_at"] - spawned_at)
    return rec


def k3_handoff(torch, cfg, tree, dev, exp_kw, adp_kw, prompts, head, tail,
               where, gate=True, ref_tokens=None, server=False):
    """Phase 3k (d), one arm: the reference engine (the adopter's kind,
    ``adp_kw``) serves ``prompts`` for head + tail tokens; the exporter
    (``exp_kw``, ``hold_kv=True``) serves head tokens, a pipelined one
    stopped with its last tokens' tick pending, and exports each request
    as a kvwire frame; the adopter adopts the frames and decodes tail
    more. Gates (``gate``): adopter tokens equal to the reference's; 16
    ok adoptions and no prefill; pages back to their start on both;
    launches exact on the adopter; a pipelined exporter's flush billed.
    Returns (adopter tokens, record, launches by kernel)."""
    from deeplearning4j_tpu_torch.quant.kv import handoff_bytes
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    from deeplearning4j_tpu_torch.serving.kvwire import (
        WireServer, decode_handoff, encode_handoff, wire_call)
    L = cfg.n_layers
    base = dict(decode_chunk=8, max_queue=256, degrade_queue_depth=1024)
    launches = {k: 0 for k in launch_counters()}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    zero_launches()
    if ref_tokens is None:
        ref = InferenceEngine(cfg, tree, EngineConfig(
            **base, **adp_kw, max_new_tokens=head + tail), device=dev)
        rh = [ref.submit(p) for p in prompts]
        ref.run_pending()
        ref_tokens = [h.generated.tolist() for h in rh]
        del ref, rh
    ex = InferenceEngine(cfg, tree, EngineConfig(
        **base, **exp_kw, max_new_tokens=head), device=dev)
    held = [ex.submit(p, hold_kv=True) for p in prompts]
    pipelined = ex.config.pipeline
    if pipelined:
        while not all(h.generated.shape[0] + h._pending_n >= head
                      for h in held):
            ex.tick()
        pending = len(ex._pending)
    else:
        ex.run_pending()
        pending = 0
    add(read_launches())
    frames, export_s = [], []
    torch.cuda.synchronize()
    for h in held:
        t0 = time.perf_counter()
        frames.append(encode_handoff(ex.export_slot_kv(h)))
        export_s.append(time.perf_counter() - t0)
    kv_bytes = sum(handoff_bytes(cfg, p.shape[0] + head - 1,
                                 kv_mode=ex._kv_mode) for p in prompts)
    ex_pages_ok = (not ex._paged
                   or ex.counts["pages_used"] == ex.prefix_cache_pages)
    flush = ex._last_flush
    echoed = None
    if server:
        srv = WireServer(lambda f: f)
        try:
            echoed = wire_call(srv.address, frames[0])
        finally:
            srv.stop()
        frames[0] = echoed
    ad = InferenceEngine(cfg, tree, EngineConfig(
        **base, **adp_kw, max_new_tokens=head + tail), device=dev)
    adopt_s = []
    adopt_rows = ad._adopt_rows

    def timed_adopt(pages, kv, slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adopt_rows(pages, kv, slot)
        torch.cuda.synchronize()
        adopt_s.append(time.perf_counter() - t0)
    ad._adopt_rows = timed_adopt
    zero_launches()
    keys0 = ad._graphs.keys()
    c0 = dict(ad.counts)
    hs = [ad.submit(h.result(), max_new_tokens=tail,
                    kv=decode_handoff(f)) for h, f in zip(held, frames)]
    ad.run_pending()
    torch.cuda.synchronize()
    got = read_launches()
    add(got)
    c = {k: ad.counts[k] - c0[k] for k in c0}
    tokens = [h0.generated.tolist() + h.generated.tolist()
              for h0, h in zip(held, hs)]
    equal = sum(a == b for a, b in zip(tokens, ref_tokens))
    adoptions = int(ad._m_adoptions.labels("ok").value)
    rec = dict(phase="3k", arm="handoff", where=where,
               requests=len(prompts), head=head, tail=tail,
               exporter={k: v for k, v in exp_kw.items()
                         if k != "tick_token_budget"},
               adopter={k: v for k, v in adp_kw.items()
                        if k != "tick_token_budget"},
               dtype=cfg.dtype, token_equal=equal, gated=gate,
               adoptions_ok=adoptions, adopter_prefill_calls=c[
                   "prefill_calls"],
               frame_bytes=sum(len(f) for f in frames),
               handoff_bytes=kv_bytes,
               frame_overhead_bytes=sum(len(f) for f in frames) - kv_bytes,
               export_encode_ms_per_request=1e3 * sum(export_s) / len(held),
               adopt_ms_per_request=1e3 * sum(adopt_s) / max(1,
                                                            len(adopt_s)),
               exporter_pending_ticks_at_export=pending, flush=flush,
               wire_server_round_trip=(echoed is not None))
    line(rec)
    if gate:
        if ad._paged:
            check_launches(ad, c, L, got, f"3k (d) {where}", keys0)
        if not (equal == len(prompts) and adoptions == len(prompts)
                and c["prefill_calls"] == 0 and ex_pages_ok
                and ad.counts["pages_used"] == ad.prefix_cache_pages
                and (not pipelined or (pending and flush
                                       and flush["reason"]
                                       == "export_slot_kv"))
                and (not server or echoed is not None)):
            fail(f"3k (d) {where}: {equal}/{len(prompts)} token-equal, "
                 f"{adoptions} adoptions, {c}, pages exporter {ex_pages_ok} "
                 f"adopter {ad.counts['pages_used']} vs cache "
                 f"{ad.prefix_cache_pages}, pending {pending}, flush "
                 f"{flush}")
    return tokens, rec, launches


def phase_cache_handoff_full_width(torch, dev):
    """Phase 3k (module docstring): (a) restart-to-first-token cold and
    warm in fresh processes, (b) warm-up then mixed traffic, (c) a
    2-entry program cache on the spec engine, (d) KV handoff through
    kvwire frames. Returns the wrappers' launches by kernel."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.serving import engine as se
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    cfg = k3_config(tf)
    L = cfg.n_layers
    base = dict(max_queue=256, degrade_queue_depth=1024)
    totals = {k: 0 for k in launch_counters()}

    def add(got):
        for k in totals:
            totals[k] += got[k]

    # (a) cold, warm, one-corrupt-program-entry and one-torn-library
    # restarts in fresh processes
    from deeplearning4j_tpu_torch.serving.compile_cache import (
        KIND_LIBRARY, CompileCache)
    torn_lib = "decode_attention"
    cache_dir = tempfile.mkdtemp(prefix="dl4j-3k-cache-")
    try:
        cold = k3_restart(cache_dir, "cold")
        warm = k3_restart(cache_dir, "warm")
        programs = [p for p in sorted(os.listdir(cache_dir))
                    if p.endswith(".bin") and not p.startswith("lib-")]
        victim = os.path.join(cache_dir, programs[0])
        with open(victim, "r+b") as f:
            f.truncate(20)
        corrupt = k3_restart(cache_dir, "corrupt")
        # a torn library entry: caught by its CRC before it reaches the
        # build directory or dlopen, rebuilt by nvcc and published again
        lib_entry = next(p for p in sorted(os.listdir(cache_dir))
                         if p.startswith(f"lib-{torn_lib}-"))
        lib_victim = os.path.join(cache_dir, lib_entry)
        torn_size = os.path.getsize(lib_victim) // 2
        with open(lib_victim, "r+b") as f:
            f.truncate(torn_size)
        torn = k3_restart(cache_dir, "torn_library")
        republished = CompileCache(cache_dir, device=dev).load(
            lib_entry[:-len(".bin")], KIND_LIBRARY)
        libs = sorted(p for p in os.listdir(cache_dir)
                      if p.startswith("lib-"))
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    n_prog = cold["warmup"]["programs"]
    serving_libs = {"flash_fwd", "decode_attention"}
    for r in (cold, warm, corrupt, torn):
        line(dict(phase="3k", arm="restart", tag=r["tag"],
                  restart_to_first_token_s=r["restart_to_first_token_s"],
                  process_start_to_engine_s=r["process_start_to_engine_s"],
                  process_wall_s=r["process_wall_s"],
                  warmup=r["warmup"], nvcc_runs=r["nvcc_runs"],
                  nvcc_seconds=r["build_seconds"], library_origin=r[
                      "origin"], cache_bytes=r["cache_bytes"],
                  cache_entries=len(r["cache_entries"]),
                  compiles=r["compiles"], faults=r["faults"],
                  statuses=r["statuses"], tokens_equal_cold=(
                      r["tokens"] == cold["tokens"])))
    runs = (cold, warm, corrupt, torn)
    if not (all(r["faults"] == 0 and r["statuses"] == ["completed"]
                for r in runs)
            and torn["nvcc_runs"] == {torn_lib: 1}
            and torn["origin"] == {torn_lib: "nvcc", **{
                n: "cache" for n in serving_libs - {torn_lib}}}
            and torn["warmup"]["aot"]["corrupt"] == 1
            and torn["warmup"]["aot"]["stores"] == 1
            and torn["warmup"]["jit"] >= 1
            and torn["warmup"]["jit"] + torn["warmup"]["aot_cache"]
            == n_prog
            and republished is not None
            and republished[:4] == b"\x7fELF"
            and torn["tokens"] == cold["tokens"]):
        fail(f"3k (a) torn library entry: faults "
             f"{[r['faults'] for r in runs]}, statuses "
             f"{[r['statuses'] for r in runs]}, nvcc {torn['nvcc_runs']}, "
             f"origin {torn['origin']}, warm-up {torn['warmup']}, "
             f"republished {republished is not None and republished[:4]}, "
             f"tokens {torn['tokens'] == cold['tokens']}")
    if not (set(cold["nvcc_runs"]) == serving_libs
            and all(n == 1 for n in cold["nvcc_runs"].values())
            and cold["warmup"]["jit"] == n_prog
            and cold["warmup"]["aot_cache"] == 0
            and warm["nvcc_runs"] == {} and corrupt["nvcc_runs"] == {}
            and warm["warmup"]["aot_cache"] == n_prog
            and warm["warmup"]["jit"] == 0
            and set(warm["origin"].values()) == {"cache"}
            and corrupt["warmup"]["jit"] == 1
            and corrupt["warmup"]["aot_cache"] == n_prog - 1
            and corrupt["warmup"]["aot"]["corrupt"] == 1
            and len(libs) == len(serving_libs)
            and warm["tokens"] == cold["tokens"]
            and corrupt["tokens"] == cold["tokens"]):
        fail(f"3k (a): cold {cold['nvcc_runs']} {cold['warmup']}, warm "
             f"{warm['nvcc_runs']} {warm['warmup']} {warm['origin']}, "
             f"corrupt {corrupt['nvcc_runs']} {corrupt['warmup']}, "
             f"libraries {libs}, tokens warm "
             f"{warm['tokens'] == cold['tokens']} corrupt "
             f"{corrupt['tokens'] == cold['tokens']}")

    # (b) warm-up, then mixed traffic: no capture, no resolution
    tree = tf.TransformerLM(cfg, seed=0, device=dev).params
    eng = InferenceEngine(cfg, tree, EngineConfig(
        **base, num_slots=64, decode_chunk=8, max_new_tokens=K3_NEW),
        device=dev)
    zero_launches()
    rep = eng.warmup()
    add(read_launches())
    warm_captures = eng.counts["graph_captures"]
    comp0, size0 = eng._compiles_by_source(), se.program_cache_info()
    # one wave a prefill bucket (16 .. 2048), 4 requests each, drained
    rng = np.random.default_rng(19)
    waves = [[rng.integers(0, 256, size=int(t)).astype(np.int32)
              for t in rng.integers(max(1, b // 2 + 1),
                                    min(b, 2048 - K3_NEW) + 1, size=4)]
             for b in (16, 32, 64, 128, 256, 512, 1024, 2048)]
    mixed = [p for w in waves for p in w]
    out, wall, c, _, got, _, keys0 = serve_pass(torch, eng, waves)
    add(got)
    check_launches(eng, c, L, got, "3k (b) warm traffic", keys0)
    line(dict(phase="3k", arm="warmup", warmup=rep,
              warmup_captures=warm_captures, requests=len(mixed),
              prompt_len_min=min(p.shape[0] for p in mixed),
              prompt_len_max=max(p.shape[0] for p in mixed),
              buckets=sorted({eng._bucket_len(p.shape[0]) for p in mixed}),
              wall_s=wall, tokens_per_s=len(mixed) * K3_NEW / wall,
              traffic_captures=c["graph_captures"],
              traffic_compiles=eng._compiles_by_source() != comp0,
              prefill_calls=c["prefill_calls"],
              decode_chunks=c["decode_chunks"]))
    if not (c["graph_captures"] == 0 and eng._compiles_by_source() == comp0
            and se.program_cache_info().currsize == size0.currsize
            and rep["programs"] == 9 and rep["jit"] == 9
            and c["prefill_calls"] == len(waves)):
        fail(f"3k (b): after warm-up {c['graph_captures']} captures, "
             f"compiles {comp0} -> {eng._compiles_by_source()}, cache "
             f"{size0} -> {se.program_cache_info()}, warm-up {rep}")
    del eng

    # (c) the spec engine (K = 7, 3, 1 and plain decode) under a 2-entry
    # program cache, against an unbounded one, in both loops
    prompts = k3_prompts(20, lo=64, hi=513)
    plan = [(7, 0), (3, 0), (1, 0), (1, 1)]
    spec = dict(base, num_slots=64, decode_chunk=8, max_new_tokens=40,
                spec_decode=True, spec_k=7, draft="layers:1",
                spec_adaptive=False)

    def run_spec(pipeline, size):
        e = InferenceEngine(cfg, tree, EngineConfig(
            **spec, pipeline=pipeline, program_cache_size=size), device=dev)
        zero_launches()
        hs = [e.submit(p) for p in prompts]
        n = 0
        while True:
            e._spec_cur_k, e._spec_plain = plan[n % len(plan)]
            n += 1
            if not e.tick():
                break
        add(read_launches())
        comp = {lab[0]: int(ch.value) for lab, ch in e._m_compiles.collect()}
        rec = dict(captures=e.counts["graph_captures"],
                   replays=e.counts["graph_replays"],
                   evictions=int(e._m_prog_evictions.value),
                   graphed_resolutions=comp.get("decode", 0)
                   + comp.get("spec_decode", 0),
                   ticks=n, spec_rounds=e.counts["spec_rounds"],
                   decode_chunks=e.counts["decode_chunks"])
        return [h.generated.tolist() for h in hs], rec

    results = {}
    for pipeline in (False, True):
        results[("unbounded", pipeline)] = run_spec(pipeline, 64)
    for pipeline in (False, True):
        results[("bounded", pipeline)] = run_spec(pipeline, 2)
    se.set_program_cache_size(se.DEFAULT_PROGRAM_CACHE_SIZE)
    for pipeline in (False, True):
        (ut, ur), (bt, br) = (results[("unbounded", pipeline)],
                              results[("bounded", pipeline)])
        line(dict(phase="3k", arm="program_cache_2",
                  loop="pipelined" if pipeline else "sync",
                  k_plan=plan, requests=len(prompts), unbounded=ur,
                  bounded=br, token_equal=ut == bt))
        if not (ut == bt and br["evictions"] > 0
                and br["captures"] == br["graphed_resolutions"]
                > ur["captures"] == 4 and ur["evictions"] == 0):
            fail(f"3k (c) {'pipelined' if pipeline else 'sync'}: tokens "
                 f"equal {ut == bt}, bounded {br}, unbounded {ur}")

    # (d) KV handoff through kvwire frames
    paged = dict(paged=True, page_size=16, prefill_chunk=256,
                 tick_token_budget=16384, num_slots=64)
    hprompts = k3_prompts(21)
    head, tail = 4, 28
    bf16, rec, got = k3_handoff(torch, cfg, tree, dev, paged, paged,
                                hprompts, head, tail, "bf16 paged->paged",
                                server=True)
    add(got)
    int8 = dict(paged, kv_quantize="int8")
    _, _, got = k3_handoff(torch, cfg, tree, dev, int8, int8, hprompts,
                           head, tail, "int8 paged->paged")
    add(got)
    cfg32 = k3_config(tf, "float32")
    tree32 = tf.TransformerLM(cfg32, seed=0, device=dev).params
    _, _, got = k3_handoff(torch, cfg32, tree32, dev,
                           dict(num_slots=16, pipeline=False),
                           dict(paged, num_slots=16), hprompts, head, tail,
                           "f32 contiguous->paged")
    add(got)
    del tree32
    _, rec, got = k3_handoff(torch, cfg, tree, dev, dict(num_slots=64),
                             paged, hprompts, head, tail,
                             "bf16 contiguous->paged", gate=False,
                             ref_tokens=bf16)
    add(got)
    line(dict(phase="3k", run="summary", launches=totals,
              bf16_contiguous_to_paged_token_equal=rec["token_equal"]))
    return totals


# ---------------------------------------------------------------------------
# phase 3l: the fleet router, its subprocess workers and the tiers
# ---------------------------------------------------------------------------

L3_CFG = dict(vocab_size=256, d_model=512, n_heads=8, n_layers=12,
              max_len=2048, dtype="bfloat16")
L3_ENGINE = dict(num_slots=64, decode_chunk=8, max_new_tokens=64,
                 max_queue=256, degrade_queue_depth=1024, pipeline=False)
L3_PAGED = dict(L3_ENGINE, paged=True, page_size=16, kv_pages=3072 + 1)
L3_PREFILL = dict(L3_PAGED, prefill_chunk=256)
# a decode replica adopts every handoff into pages of its own: room for
# every slot at max_len
L3_DECODE = dict(L3_PAGED, kv_pages=64 * 128 + 1)
L3_WAIT_S = 300.0        # the bound of every wait in the phase


class L3Clock:
    """An injected clock, advanced by the drive loop: the same schedule on the
    card and on the CPU."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def l3_drive(r, where, clock=None, before_tick=None, step_s=0.05):
    """Tick a router until nothing is pending (bounded). With ``clock``
    the injected clock advances ``step_s`` a tick. Returns (ticks, wall s
    in ticks)."""
    deadline = time.monotonic() + L3_WAIT_S
    n, spent = 0, 0.0
    while r.pending():
        if time.monotonic() > deadline:
            fail(f"3l {where}: the fleet did not drain in {L3_WAIT_S} s")
        if before_tick is not None:
            before_tick(r)
        t0 = time.perf_counter()
        moved = r.tick()
        spent += time.perf_counter() - t0
        n += 1
        if clock is not None:
            clock.t += step_s
        elif not moved:
            time.sleep(0.0005)
    return n, spent


def l3_outcome(hs, want, where, gate_equal):
    """Every handle completed (zero lost); the share whose tokens equal
    ``want`` (gated to 1.0 with ``gate_equal``)."""
    bad = [h.rid for h in hs if h.status != "completed"]
    if bad:
        fail(f"3l {where}: requests {bad[:8]} not completed "
             f"({len(bad)} of {len(hs)})")
    equal = sum(np.array_equal(h.result(), w) for h, w in zip(hs, want))
    if gate_equal and equal != len(hs):
        fail(f"3l {where}: {equal} of {len(hs)} token-equal")
    return equal / len(hs)


def l3_fleet_launches(engines, got, L, where):
    """Exact wrapper launches of a fleet's fresh engines: each engine
    resolves and captures its own keys (`expected_launches` per engine,
    summed), and every later decode chunk and spec round is a replay."""
    want = {k: 0 for k in launch_counters()}
    replays = 0
    for eng in engines:
        c = eng.counts
        for k, v in expected_launches(eng, c, L).items():
            want[k] += v
        r = c["decode_chunks"] + c["spec_rounds"] - len(eng._graphs.keys())
        if c["graph_replays"] != r:
            fail(f"{where}: graph replays {c['graph_replays']}, want {r}")
        replays += r
    got = {k: got.get(k, 0) for k in want}
    if got != want:
        fail(f"{where}: launches {got}, want {want}")
    GRAPH_REPLAYS[where] = GRAPH_REPLAYS.get(where, 0) + replays
    return got


def l3_single(torch, cfg, tree, dev, ec, prompts, max_new=None):
    """One engine serving ``prompts``: (results, wall s, launches)."""
    from deeplearning4j_tpu_torch.serving.engine import (EngineConfig,
                                                         InferenceEngine)
    eng = InferenceEngine(cfg, tree, EngineConfig(**ec), device=dev)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_launches()
    check_launches(eng, eng.counts, cfg.n_layers, got, "3l single")
    out = [h.result() for h in hs]
    info = dict(slo=eng.slo_report(),
                prefix=l3_prefix_counts(eng))
    del eng, hs
    return out, wall, got, info


def l3_prefix_counts(eng):
    c = eng.counts
    return {k: c[k] for k in ("prefix_hits", "prefix_misses",
                              "prefix_shared_tokens", "prefix_evictions")
            if k in c}


def l3_hops_step_time(r):
    """Wrap each in-process replica's step to sum the engine ticks' wall
    time (the rest of a router tick is the router's host work)."""
    spent = [0.0]
    for ctl in r._ctls:
        rep = ctl.replica
        inner = rep.step

        def step(inner=inner):
            t0 = time.perf_counter()
            try:
                return inner()
            finally:
                spent[0] += time.perf_counter() - t0
        rep.step = step
    return spent


def l3_cancelled(engines):
    return sum(int(e.registry.get("serving_requests_shed")
                   .labels("cancelled").value) for e in engines)


def l3_flat_fleet(torch, dev, cfg, params, prompts, want, add):
    """3l (a): the flat fleet at full width."""
    import shutil
    import tempfile
    import urllib.request
    from deeplearning4j_tpu_torch.parallel.failure import FleetFaultInjector
    from deeplearning4j_tpu_torch.serving import (EngineConfig,
                                                  EngineDraining,
                                                  FleetConfig, Router)
    from deeplearning4j_tpu_torch.util.checkpointing import \
        CheckpointManager
    L = cfg.n_layers
    ec = EngineConfig(**L3_ENGINE)

    def fleet(tree=params, ec=ec, **kw):
        kw.setdefault("config", FleetConfig(hang_min_s=30.0))
        return Router(cfg=cfg, params=tree, device=dev, num_replicas=2,
                      engine_config=ec, **kw)

    # fleet beside the single engine, in turns (S F), sync loop
    runs = {"single": [], "fleet": []}
    for arm in ("single", "fleet"):
        if arm == "single":
            out, wall, got, _ = l3_single(torch, cfg, params, dev,
                                          L3_ENGINE, prompts)
            add(got)
            if not all(np.array_equal(a, b) for a, b in zip(out, want)):
                fail("3l (a) single engine differs from its first run")
            runs["single"].append(len(prompts) * 64 / wall)
            continue
        r = fleet()
        engines = [c.replica.engine for c in r._ctls]
        step_s = l3_hops_step_time(r)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [r.submit(p) for p in prompts]
        ticks, tick_s = l3_drive(r, "(a) fleet")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        add(l3_fleet_launches(engines, got, L, "3l (a) fleet"))
        l3_outcome(hs, want, "(a) fleet", gate_equal=True)
        runs["fleet"].append(len(prompts) * 64 / wall)
        line(dict(phase="3l", arm="fleet", replicas=2, slots_each=64,
                  requests=len(prompts), new_tokens=64, wall_s=wall,
                  tokens_per_s=runs["fleet"][-1], router_ticks=ticks,
                  host_ms_per_router_tick=(tick_s - step_s[0]) / ticks
                  * 1e3, engine_ms_per_router_tick=step_s[0] / ticks * 1e3,
                  dispatches=r.stats["dispatches"],
                  per_replica_requests=[e.counts["prefill_calls"]
                                        for e in engines]))
        r.close()
        del r, engines, hs
    line(dict(phase="3l", run="fleet_vs_single", order="S F",
              single_tokens_per_s=runs["single"],
              fleet_tokens_per_s=runs["fleet"],
              fleet_over_single=sum(runs["fleet"]) / sum(runs["single"])))

    # the same fleet driven by Router.start()'s thread, with HTTP probes
    # on every replica's MetricsServer, while this thread polls the
    # replicas' /healthz and /debugz: the launches stay exact (the
    # handlers launch nothing) and the tokens equal
    r = fleet(http_probes=True)
    engines = [c.replica.engine for c in r._ctls]
    zero_launches()
    r.start()
    try:
        hs = [r.submit(p) for p in prompts]
        polls = 0
        deadline = time.monotonic() + L3_WAIT_S
        while not all(h.done() for h in hs):
            if time.monotonic() > deadline:
                fail("3l (a) threaded fleet did not finish")
            for c in r._ctls:
                for path in ("/healthz", "/debugz"):
                    with urllib.request.urlopen(
                            c.replica.probe_url + path, timeout=10) as f:
                        f.read()
                    polls += 1
        torch.cuda.synchronize()
        got = read_launches()
        add(l3_fleet_launches(engines, got, L, "3l (a) threaded"))
        l3_outcome(hs, want, "(a) threaded", gate_equal=True)
    finally:
        r.stop(drain=False)
    check_zero_fault_gate("3l (a) threaded")
    line(dict(phase="3l", arm="threaded_http", requests=len(hs),
              http_polls=polls, launches_exact=True))
    del r, engines, hs

    # a spec replica pair (K 7, "layers:1") on the aligned tree == plain
    from deeplearning4j_tpu_torch.models import transformer as tf
    aligned = aligned_params(tf, cfg, dev)
    sp = prompts[:32]
    plain_a, _, got, _ = l3_single(torch, cfg, aligned, dev, L3_ENGINE, sp)
    add(got)
    r = fleet(tree=aligned, ec=EngineConfig(**L3_ENGINE, spec_decode=True,
                                            spec_k=7, draft="layers:1"))
    engines = [c.replica.engine for c in r._ctls]
    zero_launches()
    hs = [r.submit(p) for p in sp]
    l3_drive(r, "(a) spec")
    torch.cuda.synchronize()
    add(l3_fleet_launches(engines, read_launches(), L, "3l (a) spec"))
    l3_outcome(hs, plain_a, "(a) spec pair", gate_equal=True)
    rounds = sum(e.counts["spec_rounds"] for e in engines)
    if not rounds:
        fail("3l (a) spec pair ran no spec round")
    line(dict(phase="3l", arm="spec_pair", requests=len(sp), spec_k=7,
              draft="layers:1", spec_rounds=rounds, token_equal=len(sp)))
    r.close()
    del r, engines, hs, aligned, plain_a

    # kill mid-decode: zero lost, failovers, memory back after restart
    kill_tick = 4
    inj = FleetFaultInjector(kill_at={kill_tick: 0})
    r = fleet(fault_injector=inj,
              config=FleetConfig(hang_min_s=30.0,
                                 restart_backoff_base_s=0.05))
    mem = {}

    def before_tick(rr):
        if rr._ticks == kill_tick:
            torch.cuda.synchronize()
            mem["before"] = torch.cuda.memory_allocated()
            mem["pool"] = rr._ctls[0].replica.engine.counts[
                "kv_pool_bytes"]
            mem["t_kill"] = time.perf_counter()
    zero_launches()
    # the 64 prompts twice: the restarted replica still takes work (and
    # holds its pool) when the fleet drains
    hs = [r.submit(p) for p in prompts + prompts]
    l3_drive(r, "(a) kill", before_tick=before_tick)
    torch.cuda.synchronize()
    t_done = time.perf_counter()
    add(read_launches())
    mem["after"] = torch.cuda.memory_allocated()
    share = l3_outcome(hs, want + want, "(a) kill", gate_equal=False)
    st = r.stats
    rec_h = r.registry.get("serving_fleet_recovery_seconds").labels()
    _, rec_sum, rec_n = rec_h.snapshot()
    if not (inj.kills_injected == 1 and st["failovers"] >= 1
            and st["restarts"] == 1 and "before" in mem):
        fail(f"3l (a) kill: {st}, kills {inj.kills_injected}")
    drift = mem["after"] - mem["before"]
    if abs(drift) > mem["pool"]:
        fail(f"3l (a) kill: memory {mem['before']} before the kill, "
             f"{mem['after']} after the restart (one pool "
             f"{mem['pool']})")
    line(dict(phase="3l", arm="kill", requests=len(hs), kill_tick=kill_tick,
              completed=st["completed"], failovers=st["failovers"],
              restarts=st["restarts"], bf16_token_equal_share=share,
              recovery_s=rec_sum / max(1, rec_n),
              restart_cold_start_s=r._ctls[0].replica.cold_start_s,
              kill_to_all_done_s=t_done - mem["t_kill"],
              memory_before_kill=mem["before"],
              memory_after_restart=mem["after"],
              memory_drift_bytes=drift, pool_bytes=mem["pool"]))
    r.close()
    del r, hs

    # a hang: detected by the no-progress detector and failed over
    hp = prompts[:16]
    inj = FleetFaultInjector(hang_at={2: 1})
    r = fleet(fault_injector=inj,
              config=FleetConfig(hang_ticks=4, hang_min_s=0.5,
                                 restart_backoff_base_s=0.05))
    zero_launches()
    hs = [r.submit(p) for p in hp]
    t0 = time.perf_counter()
    l3_drive(r, "(a) hang")
    add(read_launches())
    share = l3_outcome(hs, want, "(a) hang", gate_equal=False)
    st = r.stats
    if not (inj.hangs_injected == 1 and st["failovers"] >= 1):
        fail(f"3l (a) hang: not detected ({st})")
    line(dict(phase="3l", arm="hang", requests=len(hs),
              failovers=st["failovers"], restarts=st["restarts"],
              bf16_token_equal_share=share,
              wall_s=time.perf_counter() - t0))
    r.close()
    del r, hs

    # a slow replica with hedging: the loser of every hedge is cancelled
    inj = FleetFaultInjector(slow_at={1: (0, 0.01)})
    r = fleet(fault_injector=inj,
              config=FleetConfig(hedge=True, hedge_age_s=0.0,
                                 hang_min_s=30.0))
    engines = [c.replica.engine for c in r._ctls]
    zero_launches()
    hs = [r.submit(p) for p in hp]
    l3_drive(r, "(a) slow+hedge")
    add(read_launches())
    l3_outcome(hs, want, "(a) slow+hedge", gate_equal=True)
    st = r.stats
    hedges = st["hedges_primary_won"] + st["hedges_hedge_won"]
    cancelled = l3_cancelled(engines)
    if not (hedges >= 1 and cancelled >= 1):
        fail(f"3l (a) slow+hedge: hedges {hedges}, cancelled {cancelled}")
    line(dict(phase="3l", arm="slow_hedge", requests=len(hs),
              hedges_primary_won=st["hedges_primary_won"],
              hedges_hedge_won=st["hedges_hedge_won"],
              losers_cancelled=cancelled))
    r.close()
    del r, engines, hs

    # probe failures, drain and a rolling reload on one fleet
    tmp = tempfile.mkdtemp(prefix="dl4j-3l-")
    try:
        mgr = CheckpointManager(os.path.join(tmp, "w"))
        mgr.save_tree(params, 7)
        inj = FleetFaultInjector(fail_probe={0: 3})
        r = fleet(fault_injector=inj,
                  config=FleetConfig(probe_failure_threshold=1,
                                     hang_min_s=30.0))
        zero_launches()
        hs = [r.submit(p) for p in prompts[:8]]
        r.tick()
        state0 = r._ctls[0].state()
        l3_drive(r, "(a) probes")
        for _ in range(5):
            r.tick()
        back = r._ctls[0].state()
        if not (state0 == "unhealthy" and back == "ready"
                and r.stats["probe_failures"] >= 1):
            fail(f"3l (a) probes: {state0} then {back}, {r.stats}")
        hs += [r.submit(p) for p in prompts[8:16]]
        r.tick()
        r.drain(wait=False)
        ready_after_drain = r.ready()
        try:
            r.submit(prompts[0])
            fail("3l (a) drain: a submit was admitted")
        except EngineDraining:
            pass
        l3_drive(r, "(a) drain")
        r.resume()
        hs += [r.submit(p) for p in prompts[16:24]]
        r.tick()
        loaded = r.rolling_reload(mgr, timeout=L3_WAIT_S)
        l3_drive(r, "(a) rolling reload")
        add(read_launches())
        l3_outcome(hs, want, "(a) probes/drain/reload", gate_equal=False)
        st = r.stats
        dropped = st["shed_overload"] + st["shed_deadline"] + \
            st["shed_outage"]
        if ready_after_drain or loaded != [7, 7] or dropped:
            fail(f"3l (a) drain/reload: ready {ready_after_drain}, "
                 f"loaded {loaded}, {st}")
        line(dict(phase="3l", arm="probes_drain_reload",
                  requests=len(hs), probe_failures=st["probe_failures"],
                  state_after_probe_failure=state0, state_after=back,
                  ready_at_drain=ready_after_drain, reloaded_steps=loaded,
                  dropped=dropped))
        r.close()
        del r, hs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def l3_f32(torch, dev):
    """3l (b): phase 2's float32 model behind a Router with a kill and a
    TieredRouter with a decode-tier kill, a failed export and a corrupted
    frame: card == CPU == one uninterrupted engine, token for token, and
    the routers' counters equal on the card and the CPU."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel.failure import FleetFaultInjector
    from deeplearning4j_tpu_torch.serving import (EngineConfig, FleetConfig,
                                                  InferenceEngine, Router,
                                                  TieredRouter)
    cfg = tf.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                               n_layers=2, max_len=2048, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in rng.integers(8, 65, size=8)]
    flat = dict(num_slots=4, decode_chunk=2, max_new_tokens=16,
                backoff_base_s=0.0, pipeline=False)
    paged = dict(flat, paged=True, page_size=16, kv_pages=4 * 128 + 1)
    arms = {
        "router_kill": (flat, dict(kill_at={2: 0})),
        "tiered_faults": (paged, dict(kill_at={6: 2}, handoff_fail_at=[1],
                                      corrupt_frame_at=[3])),
    }
    recs = {}
    for name, (ec, inj_kw) in arms.items():
        single = InferenceEngine(cfg, tf.init_params(cfg, seed=1,
                                                     device=dev),
                                 EngineConfig(**ec), device=dev)
        want = []
        for p in prompts:
            h = single.submit(p)
            single.run_pending()
            want.append(h.result())
        del single
        got = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else "cpu"
            tree = tf.init_params(cfg, seed=1, device=d)
            clock = L3Clock()
            inj = FleetFaultInjector(**inj_kw)
            fc = FleetConfig(restart_backoff_base_s=0.01)
            if name == "router_kill":
                r = Router(cfg=cfg, params=tree, device=d, num_replicas=2,
                           engine_config=EngineConfig(**ec),
                           fault_injector=inj, config=fc, clock=clock)
            else:
                r = TieredRouter(cfg=cfg, params=tree, device=d,
                                 prefill_replicas=1, decode_replicas=2,
                                 prefill_engine_config=EngineConfig(**ec),
                                 decode_engine_config=EngineConfig(**ec),
                                 fault_injector=inj, config=fc,
                                 clock=clock)
            hs = [r.submit(p) for p in prompts]
            l3_drive(r, f"(b) {name} {where}", clock=clock)
            got[where] = ([h.result().tolist() for h in hs], r.stats,
                          [h.status for h in hs])
            r.close()
        toks_equal = (got["cuda"][0] == got["cpu"][0]
                      == [w.tolist() for w in want])
        st = got["cuda"][1]
        ok = (toks_equal and got["cuda"][1] == got["cpu"][1]
              and got["cuda"][2] == ["completed"] * len(prompts)
              and st["failovers"] >= 1)
        if name == "tiered_faults":
            ok = ok and st["handoffs_failed"] == 2
        recs[name] = dict(token_exact=toks_equal,
                          stats_equal=got["cuda"][1] == got["cpu"][1],
                          failovers=st["failovers"],
                          handoffs_failed=st.get("handoffs_failed"),
                          handoffs_ok=st.get("handoffs_ok"))
        if not ok:
            fail(f"3l (b) {name}: card {got['cuda'][1]} vs cpu "
                 f"{got['cpu'][1]}, tokens card == cpu == single "
                 f"{toks_equal}")
    line(dict(phase="3l", arm="f32_card_cpu", requests=len(prompts),
              **recs))


def l3_tiers(torch, dev, cfg, params, add):
    """3l (c): paged prefill and decode tiers on phase 3c's shared-prefix
    traffic. bf16 tokens round by the calls that made them: a chunked
    prefill tier batches its chunks with other partners than a single
    chunked engine (whose budget also carries decode), so that arm gates
    every request completed, every handoff ok and its bytes, and prints
    the token-equal share; a one-shot paged prefill tier admits the same
    waves as a single paged engine and makes the same calls, and is
    gated token-equal, in bf16 and on int8 pools. Returns (the traffic,
    the single one-shot paged engine's results)."""
    from deeplearning4j_tpu_torch.quant.kv import handoff_bytes
    from deeplearning4j_tpu_torch.serving import (AutoscalePolicy,
                                                  EngineConfig, FleetConfig,
                                                  TieredRouter)
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    first = paged_traffic(rng, 96, 32, 512, (16, 512), (16, 1024))
    # the chunked arms on the first quarter (chunk-256 prefill is
    # host-bound); the same-calls arms on all of it
    half = first[:32]
    want, wall_single, got, info0 = l3_single(torch, cfg, params, dev,
                                              L3_PREFILL, half)
    add(got)
    _, _, got, info = l3_single(torch, cfg, params, dev,
                                dict(L3_PREFILL, max_new_tokens=1), half)
    slo_prefill = info["slo"]
    add(got)
    # the same-calls arms' pools hold every prompt's chain: no eviction,
    # so the prefill tier and the single engine hit the same prefixes
    big = dict(L3_PAGED, kv_pages=64 * 128 + 1)
    want1, _, got, info1 = l3_single(torch, cfg, params, dev, big, first)
    add(got)

    def tiered(pc, dc, n_decode=2, **kw):
        return TieredRouter(cfg=cfg, params=params, device=dev,
                            prefill_replicas=1, decode_replicas=n_decode,
                            prefill_engine_config=EngineConfig(**pc),
                            decode_engine_config=EngineConfig(**dc),
                            config=FleetConfig(hang_min_s=30.0), **kw)

    def timed_adopts(r):
        adopt_s = []
        for c in r._ctls:
            if c.tier != "decode":
                continue
            eng = c.replica.engine
            rows = eng._adopt_rows

            def timed(pages, kv, slot, rows=rows):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows(pages, kv, slot)
                torch.cuda.synchronize()
                adopt_s.append(time.perf_counter() - t0)
            eng._adopt_rows = timed
        return adopt_s

    def run(pc, dc, prompts, ref, where, gate_equal, kv_mode=None,
            ref_prefix=None):
        r = tiered(pc, dc)
        engines = [c.replica.engine for c in r._ctls]
        adopt_s = timed_adopts(r)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [r.submit(p) for p in prompts]
        l3_drive(r, f"(c) {where}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = add(l3_fleet_launches(engines, read_launches(), L,
                                    f"3l (c) {where}"))
        share = l3_outcome(hs, ref, f"(c) {where}", False)
        differ = [i for i, (h, w) in enumerate(zip(hs, ref))
                  if not np.array_equal(h.result(), w)]
        first_tok = sum(int(h.result()[p.shape[0]] == w[p.shape[0]])
                        for h, p, w in zip(hs, prompts, ref)) / len(hs)
        st = r.stats
        kv_bytes = sum(handoff_bytes(cfg, p.shape[0], kv_mode=kv_mode)
                       for p in prompts)
        moved = int(r._m_handoff_bytes.value)
        _, exp_sum, exp_n = r._m_handoff_seconds.labels().snapshot()
        slo = r.slo_report()
        if not (st["handoffs_ok"] == len(prompts)
                and st["handoffs_failed"] == 0 and moved == kv_bytes):
            fail(f"3l (c) {where}: {st}, bytes {moved} vs {kv_bytes}")
        rec = dict(phase="3l", arm=f"tiers_{where}", requests=len(prompts),
                   prefill=({k: pc[k] for k in ("prefill_chunk",
                                                "kv_quantize") if k in pc}),
                   decode_replicas=2, gated_equal=gate_equal,
                   token_equal_share=share, first_token_equal_share=first_tok,
                   handoffs_ok=st["handoffs_ok"], handoff_bytes=moved,
                   handoff_bytes_analytic=kv_bytes,
                   export_ms_per_request=1e3 * exp_sum / max(1, exp_n),
                   adopt_ms_per_request=1e3 * sum(adopt_s)
                   / max(1, len(adopt_s)), adoptions_timed=len(adopt_s),
                   wall_s=wall, tokens_per_s=len(prompts) * 64 / wall,
                   ttft_p50_ms=slo.get("ttft_p50_ms"),
                   ttft_p99_ms=slo.get("ttft_p99_ms"),
                   span_latency=r.tier_latency(), launches=got,
                   differ=differ[:16],
                   differ_prompt_tokens=[int(prompts[i].shape[0])
                                         for i in differ[:16]],
                   prefill_tier_prefix=l3_prefix_counts(engines[0]),
                   single_prefix=ref_prefix)
        r.close()
        if gate_equal and differ:
            line(rec)
            fail(f"3l (c) {where}: {len(prompts) - len(differ)} of "
                 f"{len(prompts)} token-equal")
        return rec

    # a chunked (256) prefill tier
    rec = run(L3_PREFILL, L3_DECODE, half, want, "chunked", False,
              ref_prefix=info0["prefix"])
    rec.update(single_chunked_tokens_per_s=len(half) * 64 / wall_single,
               prefill_only_ttft_p50_ms=slo_prefill.get("ttft_p50_ms"),
               prefill_only_ttft_p99_ms=slo_prefill.get("ttft_p99_ms"))
    line(rec)
    # the same calls: a one-shot paged prefill tier, bf16 and int8
    line(run(big, L3_DECODE, first, want1, "one_shot", True,
             ref_prefix=info1["prefix"]))
    q = first[:32]
    qwant, _, got, qinfo = l3_single(torch, cfg, params, dev,
                                     dict(big, kv_quantize="int8"), q)
    add(got)
    rec = run(dict(big, kv_quantize="int8"),
              dict(L3_DECODE, kv_quantize="int8"), q, qwant, "int8", True,
              kv_mode="int8", ref_prefix=qinfo["prefix"])
    if rec["launches"]["decode_attention_q"] <= 0 or \
            rec["launches"]["decode_attention"]:
        fail(f"3l (c) int8 tiers: launches {rec['launches']}")
    line(rec)

    # autoscale: an 8-slot decode tier scales up under 32 requests and
    # back down; the prefill tier scales to zero, then cold-starts (the
    # burst's last request again: the chunked references hold 32)
    a = first[:32]
    r = tiered(L3_PREFILL, dict(L3_DECODE, num_slots=8,
                                kv_pages=8 * 128 + 1), n_decode=1,
               decode_autoscale=AutoscalePolicy(min_replicas=1,
                                                max_replicas=2, window=2,
                                                cooldown_s=0.1),
               prefill_autoscale=AutoscalePolicy(min_replicas=0,
                                                 max_replicas=1, window=2,
                                                 cooldown_s=0.1))
    zero_launches()
    hs = [r.submit(p) for p in a]
    l3_drive(r, "(c) autoscale burst")
    deadline = time.monotonic() + 60
    while not (len(r._active_ctls("prefill")) == 0
               and len(r._active_ctls("decode")) == 1):
        if time.monotonic() > deadline:
            fail(f"3l (c) autoscale: no scale-down ({r.autoscale_log})")
        r.tick()
        time.sleep(0.02)
    zero_state = [c.state() for c in r._tier_ctls("prefill")]
    t0 = time.perf_counter()
    cold = r.submit(first[31])
    l3_drive(r, "(c) cold start")
    cold_wall = time.perf_counter() - t0
    add(read_launches())
    share = l3_outcome(hs, want[:32], "(c) autoscale", gate_equal=False)
    l3_outcome([cold], [want[31]], "(c) cold start", gate_equal=False)
    log = r.autoscale_log
    dirs = [(e["tier"], e["direction"]) for e in log]
    if not (("decode", "up") in dirs and ("decode", "down") in dirs
            and zero_state == ["stopped"] and ("prefill", "up") in dirs):
        fail(f"3l (c) autoscale: {dirs}, prefill {zero_state}")
    line(dict(phase="3l", arm="autoscale", requests=len(a) + 1,
              log=log, prefill_at_zero=zero_state,
              token_equal_share=share,
              cold_start_s=[e.get("cold_start_s") for e in log
                            if e["tier"] == "prefill"
                            and e["direction"] == "up"],
              cold_request_wall_s=cold_wall,
              lost=r.stats["shed_outage"] + r.stats["shed_overload"]))
    r.close()
    del r, hs
    return first, want1


def l3_spawn(specs):
    """SubprocessReplicas, all started at once (each start is a process,
    a torch import and a CUDA context): (replicas, seconds)."""
    from deeplearning4j_tpu_torch.serving import SubprocessReplica
    out, errs = [None] * len(specs), []

    def start(i, spec):
        try:
            out[i] = SubprocessReplica(i, spec,
                                       startup_timeout_s=L3_WAIT_S / 2)
        except Exception as e:
            errs.append(f"replica {i}: {type(e).__name__}: {e}")
    t0 = time.perf_counter()
    ts = [threading.Thread(target=start, args=(i, s))
          for i, s in enumerate(specs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(L3_WAIT_S)
    return out, errs, time.perf_counter() - t0


def l3_subprocess(torch, prompts, want, shared, shared_want):
    """3l (d): SubprocessReplicas on the card. Every child is killed on
    every way out of this function. A router over subprocess replicas
    has no engine to read the default budget from (the reference's
    fallback is 32 tokens), so every submit names its 64."""
    from deeplearning4j_tpu_torch.serving import (FleetConfig, Router,
                                                  TieredRouter)
    base = {"cfg": L3_CFG, "params_seed": 0, "device": "cuda",
            "progress_interval_s": 0.02}
    # the tier workers admit what the pipe delivered within a 50 ms
    # window, so the prefill worker seats the 8 requests as one wave, as
    # the single one-shot paged engine of the reference does
    # the plain pair warms up before its hello (flash_fwd and
    # decode_attention loaded, from the build directory); a paged
    # engine's warm-up ladder runs the 64-slot prefill at every bucket
    # (a 6 GiB score block at 2048), which four workers on one card do
    # not have room for at once, so the tier workers load at first use
    specs = [dict(base, engine=L3_ENGINE, warmup=True),
             dict(base, engine=L3_ENGINE, warmup=True),
             dict(base, engine=dict(L3_PAGED, kv_pages=64 * 128 + 1,
                                    batch_timeout_s=0.05)),
             dict(base, engine=dict(L3_DECODE, batch_timeout_s=0.05))]
    reps = []
    try:
        reps, errs, spawn_s = l3_spawn(specs)
        if errs or any(r is None for r in reps):
            fail(f"3l (d) workers did not start: {errs}")
        for rep in reps:
            h = rep.hello
            if h.get("jax_loaded") is not False or \
                    not str(h.get("device")).startswith("cuda") or \
                    h["kernels"]["nvcc_runs"]:
                fail(f"3l (d) worker {rep.id} hello: {h}")
        line(dict(phase="3l", arm="workers", workers=len(reps),
                  spawn_all_s=spawn_s, parent_memory_reserved=int(
                      torch.cuda.memory_reserved()),
                  cold_start_s=[r.cold_start_s for r in reps],
                  library_origin=reps[0].hello["kernels"]["origin"],
                  warmup_programs=[(r.last_warmup or {}).get("programs")
                                   for r in reps]))
        sp = prompts[:32]
        # served over the pipes, probed over HTTP: equal to in-process
        r = Router(replicas=reps[:2],
                   config=FleetConfig(max_restarts=0, hang_min_s=30.0))
        hs = [r.submit(p, max_new_tokens=64) for p in sp]
        t0 = time.perf_counter()
        l3_drive(r, "(d) subprocess fleet")
        wall = time.perf_counter() - t0
        l3_outcome(hs, want, "(d) subprocess fleet", gate_equal=True)
        body = reps[0].probe()
        if not (body.get("ready")
                and body.get("num_slots") == L3_ENGINE["num_slots"]):
            fail(f"3l (d) probe body {body}")
        line(dict(phase="3l", arm="subprocess_fleet", requests=len(sp),
                  token_equal=len(sp), wall_s=wall,
                  tokens_per_s=len(sp) * 64 / wall,
                  probe_url=reps[0].probe_url))
        # SIGKILL one mid-decode: all complete, it stays dead
        r = Router(replicas=reps[:2],
                   config=FleetConfig(max_restarts=0, hang_min_s=30.0))
        hs = [r.submit(p, max_new_tokens=64) for p in sp]
        deadline = time.monotonic() + L3_WAIT_S
        while not (r._ctls[0].outstanding and any(
                len(h.inner.generated) > 0
                for hops in r._ctls[0].outstanding.values()
                for h in hops)):
            if time.monotonic() > deadline:
                fail("3l (d) sigkill: replica 0 never held work")
            r.tick()
            time.sleep(0.001)
        reps[0].kill()
        t0 = time.perf_counter()
        l3_drive(r, "(d) sigkill")
        share = l3_outcome(hs, want, "(d) sigkill", gate_equal=False)
        for _ in range(5):
            r.tick()
        if r._ctls[0].state() != "dead" or r.stats["failovers"] < 1:
            fail(f"3l (d) sigkill: {r._ctls[0].state()}, {r.stats}")
        line(dict(phase="3l", arm="subprocess_sigkill", requests=len(sp),
                  failovers=r.stats["failovers"],
                  bf16_token_equal_share=share,
                  kill_to_all_done_s=time.perf_counter() - t0,
                  dead_stays_dead=True))
        # a subprocess prefill tier -> a subprocess decode tier: KV as
        # kvwire frames through the pipes
        tp = shared[:8]
        r = TieredRouter(replicas=reps[2:], tiers=["prefill", "decode"],
                         config=FleetConfig(hang_min_s=30.0))
        hs = [r.submit(p, max_new_tokens=64) for p in tp]
        t0 = time.perf_counter()
        l3_drive(r, "(d) cross-process tiers")
        wall = time.perf_counter() - t0
        l3_outcome(hs, shared_want, "(d) cross-process tiers",
                   gate_equal=True)
        ev = [[e.data for e in h.trace.events if e.kind == "kvwire"]
              for h in hs]
        dirs = [[(d.get("direction"), d.get("outcome")) for d in x]
                for x in ev]
        m = r._kvwire_metrics()
        if not (r.stats["handoffs_ok"] == len(tp)
                and all(x == [("export", "ok"), ("adopt", "ok")]
                        for x in dirs)):
            fail(f"3l (d) cross-process tiers: {r.stats}, {dirs[:4]}")
        hand = [[e.data["seconds"] for e in h.trace.events
                 if e.kind == "handoff"][0] for h in hs]
        line(dict(phase="3l", arm="cross_process_tiers", requests=len(tp),
                  token_equal=len(tp), frame_bytes=int(m["bytes"].value),
                  frame_bytes_per_request=int(m["bytes"].value) / len(tp)
                  / 2,
                  export_wire_ms_per_request=1e3 * sum(
                      x[0]["seconds"] for x in ev) / len(tp),
                  adopt_encode_ms_per_request=1e3 * sum(
                      x[1]["seconds"] for x in ev) / len(tp),
                  handoff_ms_per_request=1e3 * sum(hand) / len(tp),
                  wall_s=wall))
        # SIGSTOP one (a hang): detected, SIGKILLed, failed over
        r = Router(replicas=reps[2:],
                   config=FleetConfig(max_restarts=0, hang_ticks=2,
                                      hang_min_s=3.0))
        hs = [r.submit(p, max_new_tokens=64) for p in sp[:8]]
        deadline = time.monotonic() + L3_WAIT_S
        while not r._ctls[1].outstanding:
            if time.monotonic() > deadline:
                fail("3l (d) sigstop: replica 3 never held work")
            r.tick()
        reps[3].set_hung(True)
        t0 = time.perf_counter()
        l3_drive(r, "(d) sigstop")
        share = l3_outcome(hs, want, "(d) sigstop", gate_equal=False)
        if r._ctls[1].state() != "dead" or r.stats["failovers"] < 1:
            fail(f"3l (d) sigstop: {r._ctls[1].state()}, {r.stats}")
        line(dict(phase="3l", arm="subprocess_sigstop", requests=len(hs),
                  failovers=r.stats["failovers"],
                  detect_and_finish_s=time.perf_counter() - t0,
                  bf16_token_equal_share=share))
    finally:
        for rep in reps:
            if rep is None:
                continue
            try:
                rep.kill()
            finally:
                rep.close()


def phase_fleet_full_width(torch, dev):
    """Phase 3l (module docstring): (a) the flat fleet, (b) float32
    exactness under fleet faults, (c) the tiers, (d) subprocess workers.
    Returns the wrappers' launches by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    cfg = tf.TransformerConfig(**L3_CFG)
    rng = np.random.default_rng(0)      # phase 3's traffic, first half
    lens = rng.integers(16, 1025, size=128)
    prompts = [rng.integers(0, 256, size=int(n)).astype(np.int32)
               for n in lens][:64]
    params = tf.init_params(cfg, seed=0, device=dev)
    totals = {k: 0 for k in launch_counters()}

    def add(got):
        for k in totals:
            totals[k] += got.get(k, 0)
        return got

    want, _, got, _ = l3_single(torch, cfg, params, dev, L3_ENGINE, prompts)
    add(got)
    l3_flat_fleet(torch, dev, cfg, params, prompts, want, add)
    torch.cuda.empty_cache()
    l3_f32(torch, dev)
    shared, shared_want = l3_tiers(torch, dev, cfg, params, add)
    torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    l3_subprocess(torch, prompts, want, shared, shared_want)
    line(dict(phase="3l", run="summary", launches=totals))
    return totals


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
    if not n_experts:
        global FLAGSHIP_WARM_LOSS
        FLAGSHIP_WARM_LOSS = float(warm_loss)
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
# phase 4d: training parallelism, four ranks on one card
# ---------------------------------------------------------------------------

# phase 4b's first-step loss (the single-rank reference of 4d (b))
FLAGSHIP_WARM_LOSS = None
D4_RANKS = 4
# 4d (a): tests/test_megatron.py's CFG at the narrowest width the flash
# kernels take (head dim 32: d 128 over 4 heads; the tests' d 32 gives a
# head dim of 8, which csrc/flash_fwd.cu does not take), T 32, B 8
D4_NARROW = dict(vocab_size=50, d_model=128, n_heads=4, n_layers=4,
                 max_len=32, dtype="float32")
D4_MOE = dict(D4_NARROW, n_layers=2, n_experts=4, capacity_factor=8.0)
D4_CASES = [  # name, kind, config, mesh axes, options
    ("tp", "megatron", D4_NARROW, dict(model=2), {}),
    ("pp-gpipe", "megatron", D4_NARROW, dict(pipe=2), {}),
    ("pp-tp-1f1b", "megatron", D4_NARROW, dict(pipe=2, model=2),
     {"pipeline_schedule": "1f1b"}),
    ("sp-tp-ring", "megatron", D4_NARROW, dict(seq=2, model=2), {}),
    ("sp-tp-ulysses", "megatron", dict(D4_NARROW, seq_impl="ulysses"),
     dict(seq=2, model=2), {}),
    ("ep", "megatron", D4_MOE, dict(data=4), {}),
    ("fsdp", "fsdp", D4_NARROW, dict(data=4), {}),
]


def d4_tree_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(d4_tree_np(v, prefix + k + "/"))
        else:
            out[prefix + k] = v.detach().float().cpu().numpy()
    return out


def d4_flash_counts():
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    return fa.flash_forward_cuda.launches, fa.flash_backward_cuda.launches


def d4_sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def d4_narrow_rank(params_np, toks, tgts, steps=2, lr=1e-2):
    """4d (a) on one rank: every case's Adam steps on its mesh (the
    first prod(axes) ranks; the others skip it)."""
    import torch
    from deeplearning4j_tpu_torch.models.convert import params_from_numpy
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel import fsdp, megatron
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    out = {}
    for name, kind, fields, axes, opts in D4_CASES:
        cfg = TransformerConfig(**fields)
        spec = MeshSpec(**axes)
        mesh = make_mesh(spec, devices=list(range(spec.n_devices)))
        if not mesh.member:
            continue
        full = params_from_numpy(params_np["moe" if cfg.n_experts
                                           else "dense"], device="cpu")
        if kind == "fsdp":
            ps = fsdp.shard_params_fsdp(full, mesh)
            step = fsdp.make_fsdp_train_step(cfg, mesh, learning_rate=lr)
        else:
            ps = megatron.shard_params(full, cfg, mesh)
            step = megatron.make_parallel_train_step(
                cfg, mesh, learning_rate=lr, **opts)
        opt = megatron.init_adam_state(ps)
        f0 = d4_flash_counts()
        C.STATS.reset()
        losses = []
        for _ in range(steps):
            ps, opt, loss = step(ps, opt, toks, tgts)
            losses.append(float(loss))
        f1 = d4_flash_counts()
        comm = C.STATS.snapshot()
        out[name] = dict(losses=losses, coords=dict(mesh.coords),
                         params=d4_tree_np(ps),
                         flash=(f1[0] - f0[0], f1[1] - f0[1]),
                         comm_bytes=comm["total_bytes"],
                         host_bytes=comm["total_host_bytes"])
    d4_sync(torch)
    return dict(cases=out, nvcc_runs=dict(_build.nvcc_runs))


def d4_full_rank(axes, seq_impl, shape, timed_steps=3):
    """4d (b) on one rank: the flagship train step on a mesh of the four
    ranks, one warm step and ``timed_steps`` timed steps, then one step
    with the collectives synchronised for their own seconds."""
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel import megatron
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    B, T, L, D, H, V = shape
    cfg = tf.TransformerConfig(vocab_size=V, d_model=D, n_heads=H,
                               n_layers=L, max_len=T, dtype="bfloat16",
                               remat=True, remat_policy="full",
                               seq_impl=seq_impl)
    mesh = make_mesh(MeshSpec(**axes))
    dev = mesh.device
    full = tf.init_params(cfg, seed=0, device="cpu")
    ps = megatron.shard_params(full, cfg, mesh)
    del full
    opt = megatron.init_adam_state(ps)
    step = megatron.make_parallel_train_step(cfg, mesh, learning_rate=1e-3)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, (B, T))).to(dev)
    tgts = torch.roll(toks, -1, dims=1)
    _, _, first = step(ps, opt, toks, tgts)
    first = float(first)
    d4_sync(torch)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    C.STATS.reset()
    f0 = d4_flash_counts()
    dist.barrier()
    t0 = time.perf_counter()
    losses = []
    for _ in range(timed_steps):
        _, _, loss = step(ps, opt, toks, tgts)
        losses.append(loss)
    d4_sync(torch)
    dist.barrier()
    wall = time.perf_counter() - t0
    f1 = d4_flash_counts()
    timed = C.STATS.snapshot()
    C.STATS.reset()
    C.STATS.sync = True
    step(ps, opt, toks, tgts)
    C.STATS.sync = False
    synced = C.STATS.snapshot()
    d4_sync(torch)
    return dict(coords=dict(mesh.coords), first_loss=first,
                losses=[float(x) for x in losses], wall_s=wall,
                flash_fwd=f1[0] - f0[0], flash_bwd=f1[1] - f0[1],
                comm_timed=timed, comm_synced_step=synced,
                peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                             if torch.cuda.is_available() else None),
                params={k: hashlib.sha256(v.tobytes()).hexdigest()
                        for k, v in d4_tree_np(ps).items()},
                nvcc_runs=dict(_build.nvcc_runs))


D4_FULL = (("dp-tp", dict(data=2, model=2), "ring"),
           ("sp-tp-ulysses", dict(seq=2, model=2), "ulysses"))
# 4d (c): the scaleout facade's narrow MLP (tests/test_scaleout.py's
# `_make_net`), float32, over 64 rows in global batches of 32
D4_MLP_ROWS, D4_MLP_BATCH = 64, 32


def d4_mlp():
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = NeuralNetConfiguration(
        seed=7, updater="sgd", learning_rate=0.1, dropout=0.0).list(
        DenseLayer(n_in=8, n_out=16, activation="tanh"),
        OutputLayer(n_out=3, activation="softmax", loss_function="mcxent"))
    return MultiLayerNetwork(conf).init()


def d4_scaleout_rank(x, y):
    """4d (c) on one rank: `SparkDl4jMultiLayer` over a
    `ParameterAveragingTrainingMaster` of the four ranks (8 rows a rank
    of each global batch of 32), with its phase stats."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.scaleout import (
        ParameterAveragingTrainingMaster, SparkDl4jMultiLayer)
    net = d4_mlp()
    tm = (ParameterAveragingTrainingMaster.Builder(
        batch_size_per_worker=D4_MLP_BATCH // dist.get_world_size())
        .workers(dist.get_world_size()).collect_training_stats(True)
        .build())
    sp = SparkDl4jMultiLayer(net, tm)
    t0 = time.perf_counter()
    sp.fit(x, y)
    return dict(params=net.params_flat().float().cpu().numpy(),
                stats=sp.stats.as_dict(), workers=sp.pw.workers,
                device=str(net.device), fit_s=time.perf_counter() - t0,
                iterations=net.iteration_count)


def d4_rank(params_np, toks, tgts, shape, timed_steps, mlp_xy):
    """Phase 4d on one rank, in one start of the four ranks: (a), (c),
    then (b) on each mesh of D4_FULL."""
    import torch
    narrow = d4_narrow_rank(params_np, toks, tgts)
    scaleout = d4_scaleout_rank(*mlp_xy)
    full = {}
    for name, axes, impl in D4_FULL:
        t0 = time.perf_counter()
        full[name] = d4_full_rank(axes, impl, shape, timed_steps)
        full[name]["rank_s"] = time.perf_counter() - t0
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return dict(narrow=narrow, full=full, scaleout=scaleout)


def d4_replicas_equal(ranks, specs):
    """Every pair of ranks that differ only along 'data' holds bit-equal
    shards of every leaf whose spec does not name 'data'."""
    from deeplearning4j_tpu_torch.parallel.mesh import spec_axes

    def flat(t, pre=""):
        o = {}
        for k, v in t.items():
            o.update(flat(v, pre + k + "/") if isinstance(v, dict)
                     else {pre + k: v})
        return o
    fs = flat(specs)
    pairs, equal = 0, True
    recs = [r for r in ranks if r is not None]
    if not recs:
        return 0, True
    eq = (lambda a, b: a == b) if isinstance(
        next(iter(recs[0]["params"].values())), str) else np.array_equal
    for a in recs:
        for b in recs:
            ca = {k: v for k, v in a["coords"].items() if k != "data"}
            cb = {k: v for k, v in b["coords"].items() if k != "data"}
            if a is b or ca != cb or a["coords"]["data"] >= \
                    b["coords"]["data"]:
                continue
            for k, v in a["params"].items():
                if "data" in spec_axes(fs[k]):
                    continue
                pairs += 1
                # (b)'s ranks send digests of their shards
                equal &= bool(eq(v, b["params"][k]))
    return pairs, equal


def phase_parallel_training(torch, dev):
    """4d (see the module docstring). Returns the flash launches of every
    rank's main-path steps (b), by kernel."""
    from deeplearning4j_tpu_torch.models import transformer as tf
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel.fsdp import (fsdp_shardings,
                                                        make_fsdp_train_step)
    from deeplearning4j_tpu_torch.parallel.megatron import param_specs
    from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, shard_of
    from deeplearning4j_tpu_torch.parallel.multihost import (
        MultiHostLauncher, backend_rule)
    from deeplearning4j_tpu_torch.parallel.optim import init_adam_state
    t_phase = time.perf_counter()
    launcher = MultiHostLauncher(D4_RANKS, device="cuda")
    line(dict(phase="4d", run="backend", ranks=D4_RANKS, card=CARD,
              rule=backend_rule("cuda", D4_RANKS),
              backend=launcher.backend, table=C.table()))
    # (a) f32 at narrow width against the single-rank card step
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 50, (8, 32)).astype(np.int64)
    tgts = np.roll(toks, -1, 1)
    params_np, base = {}, {}
    for key, fields in (("dense", D4_NARROW), ("moe", D4_MOE)):
        cfg = tf.TransformerConfig(**fields)
        p = tf.init_params(cfg, seed=0, device="cpu")
        params_np[key] = {k: ({n: a.numpy().copy() for n, a in v.items()}
                              if isinstance(v, dict) else v.numpy().copy())
                          for k, v in p.items()}
        pc = tf.params_to(p, dev)
        opt = init_adam_state(pc)
        step = make_fsdp_train_step(cfg, device=dev, learning_rate=1e-2)
        for _ in range(2):
            pc, opt, loss = step(pc, opt, toks, tgts)
        base[key] = (float(loss), d4_tree_np(pc))
    # the single-rank first loss of (b): phase 4b's, or one step here
    B, T, L, D, H, V = FLAGSHIP_TRAIN
    ref = FLAGSHIP_WARM_LOSS
    if ref is None:
        cfg = tf.TransformerConfig(vocab_size=V, d_model=D, n_heads=H,
                                   n_layers=L, max_len=T, dtype="bfloat16",
                                   remat=True, remat_policy="full")
        p = tf.init_params(cfg, seed=0, device=dev)
        toks_b = torch.from_numpy(np.random.default_rng(0).integers(
            0, V, (B, T))).to(dev)
        _, _, ref = make_fsdp_train_step(cfg, device=dev,
                                         learning_rate=1e-3)(
            p, init_adam_state(p), toks_b, torch.roll(toks_b, -1, dims=1))
        ref = float(ref)
        del p
        torch.cuda.empty_cache()
    # (c)'s data and one rank's plain fit on the same global batches
    mrng = np.random.default_rng(0)
    mx = mrng.normal(size=(D4_MLP_ROWS, 8)).astype(np.float32)
    my = np.eye(3, dtype=np.float32)[mrng.integers(0, 3, D4_MLP_ROWS)]
    single = d4_mlp()
    for i in range(0, D4_MLP_ROWS, D4_MLP_BATCH):
        single.fit(mx[i:i + D4_MLP_BATCH], my[i:i + D4_MLP_BATCH])
    single = single.params_flat().float().cpu().numpy()
    timed_steps = 2
    t0 = time.perf_counter()
    out = launcher.run(d4_rank, timeout=400,
                       args=(params_np, toks, tgts, FLAGSHIP_TRAIN,
                             timed_steps, (mx, my)))
    launch_s = time.perf_counter() - t0
    res = [r["narrow"] for r in out]
    if any(r["nvcc_runs"] for r in res):
        fail(f"4d: a rank ran nvcc: {[r['nvcc_runs'] for r in res]}")

    class At:                       # a rank's place, for shard_of
        def __init__(self, shape, coords):
            self.shape, self.coords = shape, coords
    for name, kind, fields, axes, opts in D4_CASES:
        cfg = tf.TransformerConfig(**fields)
        sizes = MeshSpec(**axes).axis_sizes()
        key = "moe" if cfg.n_experts else "dense"
        want_loss, want = base[key]
        specs = (param_specs(cfg) if kind == "megatron" else
                 fsdp_shardings(params_np[key], At(sizes, {})))
        ranks = [r["cases"].get(name) for r in res]
        loss_err = max(abs(r["losses"][-1] - want_loss)
                       for r in ranks if r)
        same_loss = len({r["losses"][-1] for r in ranks if r}) == 1
        flat_specs = {}

        def walk(t, pre=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, pre + k + "/")
                else:
                    flat_specs[pre + k] = v
        walk(specs)
        worst = max(float(np.abs(shard_of(want[k], flat_specs[k],
                                          At(sizes, r["coords"])) - v).max())
                    for r in ranks if r for k, v in r["params"].items())
        pairs, equal = d4_replicas_equal(ranks, specs)
        flash = [r["flash"] for r in ranks if r]
        comm = [(r["comm_bytes"], r["host_bytes"]) for r in ranks if r]
        line(dict(phase="4d", part="a", mesh=name, axes=axes,
                  loss=ranks[0]["losses"], single_rank_loss=want_loss,
                  loss_max_abs_err=loss_err, loss_tol=1e-4,
                  same_loss_every_rank=same_loss,
                  param_max_abs_err=worst, param_tol=5e-3,
                  replica_pairs=pairs, replicas_bit_equal=equal,
                  flash_launches_by_rank=flash,
                  comm_and_host_bytes_by_rank=comm))
        if not (loss_err <= 1e-4 and worst <= 5e-3 and equal
                and same_loss):
            fail(f"4d (a) {name}: loss err {loss_err}, param err {worst}, "
                 f"replicas equal {equal}, same loss {same_loss}")
        if cfg.seq_impl != "ring" or axes.get("seq", 1) == 1:
            if not all(f[0] > 0 and f[1] > 0 for f in flash):
                fail(f"4d (a) {name}: flash not launched on every rank "
                     f"{flash}")
    # (c) the scaleout facade on the four ranks against one rank's fit
    sc = [r["scaleout"] for r in out]
    sc_err = max(float(np.abs(r["params"] - single).max()) for r in sc)
    line(dict(phase="4d", part="c", card=CARD,
              facade="SparkDl4jMultiLayer(ParameterAveragingTrainingMaster"
              f"(workers={D4_RANKS}))", rows=D4_MLP_ROWS,
              global_batch=D4_MLP_BATCH, devices=[r["device"] for r in sc],
              workers=[r["workers"] for r in sc],
              iterations=[r["iterations"] for r in sc],
              param_max_abs_err=sc_err, param_tol=1e-5,
              stats=sc[0]["stats"], fit_s=[r["fit_s"] for r in sc]))
    if not (sc_err <= 1e-5 and all(r["workers"] == D4_RANKS for r in sc)
            and all(r["stats"].get("fit", {}).get("count", 0)
                    == D4_MLP_ROWS // D4_MLP_BATCH for r in sc)
            and all(r["device"].startswith("cuda") for r in sc)):
        fail(f"4d (c): params {sc_err} from one rank's fit, workers "
             f"{[r['workers'] for r in sc]}, stats {sc[0]['stats']}")
    # (b) full width: the flagship step on {data=2, model=2} and on
    # {seq=2, model=2} with Ulysses
    launches = {"flash_fwd": 0, "flash_bwd": 0}
    p_mat = L * 12 * D * D + D * V
    flops_tok = 3 * (2 * p_mat + 2 * L * T * D)
    for name, axes, impl in D4_FULL:
        ranks = [r["full"][name] for r in out]
        if any(r["nvcc_runs"] for r in ranks):
            fail(f"4d (b) {name}: a rank ran nvcc")
        firsts = [r["first_loss"] for r in ranks]
        rel = abs(firsts[0] - ref) / abs(ref)
        same = len(set(firsts)) == 1 and len(
            {tuple(r["losses"]) for r in ranks}) == 1
        ms = max(r["wall_s"] for r in ranks) / timed_steps * 1e3
        tok_s = B * T / (ms / 1e3)
        fwd = [r["flash_fwd"] for r in ranks]
        bwd = [r["flash_bwd"] for r in ranks]
        comm = [dict(bytes_per_step=r["comm_timed"]["total_bytes"]
                     / timed_steps,
                     host_bytes_per_step=r["comm_timed"]["total_host_bytes"]
                     / timed_steps,
                     by_op=r["comm_timed"]["bytes"],
                     host_by_op=r["comm_timed"]["host_bytes"],
                     calls_by_op=r["comm_timed"]["calls"],
                     seconds_synced_step=r["comm_synced_step"]
                     ["total_seconds"],
                     seconds_by_op=r["comm_synced_step"]["seconds"])
                for r in ranks]
        pairs, equal = (d4_replicas_equal(ranks, param_specs(
            tf.TransformerConfig(vocab_size=V, d_model=D, n_heads=H,
                                 n_layers=L, max_len=T)))
            if axes.get("data", 1) > 1 else (0, True))
        line(dict(phase="4d", part="b", mesh=name, axes=axes, seq_impl=impl,
                  card=CARD, batch=B, seq=T, layers=L, remat="full",
                  dtype="bfloat16", ranks_on_one_card=D4_RANKS,
                  timed_steps=timed_steps, ms_per_step=ms,
                  global_tokens_per_s=tok_s, model_flops_per_token=flops_tok,
                  bf16_peak_share_one_card=tok_s * flops_tok
                  / PEAK_FLOPS["bfloat16"],
                  first_loss=firsts[0], single_rank_first_loss=ref,
                  first_loss_rel_err=rel, first_loss_tol=2 ** -7,
                  losses=ranks[0]["losses"], same_loss_every_rank=same,
                  flash_fwd_by_rank=fwd, flash_bwd_by_rank=bwd,
                  comm_by_rank=comm, replica_pairs=pairs,
                  replicas_bit_equal=equal,
                  peak_mem_gb_by_rank=[r["peak_mem_gb"] for r in ranks],
                  rank_s=[r["rank_s"] for r in ranks]))
        if not (rel <= 2 ** -7 and same and equal):
            fail(f"4d (b) {name}: first loss {firsts} vs {ref} (rel {rel}),"
                 f" same on every rank {same}, replicas equal {equal}")
        if any(f != 2 * L * timed_steps for f in fwd) or \
                any(b != L * timed_steps for b in bwd):
            fail(f"4d (b) {name}: flash launches fwd {fwd} bwd {bwd}, want "
                 f"{2 * L * timed_steps} / {L * timed_steps} a rank")
        launches["flash_fwd"] += sum(fwd)
        launches["flash_bwd"] += sum(bwd)
    line(dict(phase="4d", run="summary", launch_s=launch_s,
              phase_s=time.perf_counter() - t_phase, launches=launches))
    return launches


# ---------------------------------------------------------------------------
# phase 4e: elastic ZeRO-1 training over worker processes
# ---------------------------------------------------------------------------

# 4e (a): 4d (a)'s narrow width (head dim 32) at 2 layers, float32
E4_NARROW = dict(vocab_size=50, d_model=128, n_heads=4, n_layers=2,
                 max_len=32, dtype="float32")
# 4e (b): the flagship of 4b; its depth is the one knob the budget may cut
E4_FULL_LAYERS = 1
# 4e (a)'s loose arm: JAX's slowdown against its step barrier (0.5 s
# against 0.15 s) scaled to the card, where a narrow step of three
# workers takes 0.3-0.4 s (one H100, workers sharing it)
E4_LOOSE_BARRIER_S = 1.2
E4_LOOSE_SLOW_S = E4_LOOSE_BARRIER_S * 0.5 / 0.15
# 4e (a)'s trajectory through kill, shrink, grow and hang, and the step
# barrier that times its hung worker out
E4_CHURN_STEPS, E4_CHURN_BARRIER_S = 16, 4.0
# 4e (b): microbatches a step, rows a microbatch, steps a run
E4_FULL_MB, E4_FULL_ROWS, E4_FULL_STEPS = 4, 4, 5
E4_WIRE_KEYS = ("sent_bytes", "recv_bytes", "encode_s", "decode_s",
                "send_s", "write_s", "parse_s")


def e4_line(**rec):
    line(dict(phase="4e", card=CARD, **rec))


def e4_pongs(co, timeout_s=120.0):
    """Every live worker's pong (its launch counts, grad calls, shard
    bytes and peak device memory)."""
    for w in co.workers.values():
        w.send({"op": "ping"})
    out = {}
    deadline = time.perf_counter() + timeout_s
    while len(out) < len(co.workers):
        for wid, w in co.workers.items():
            m = w.take(lambda x: x.get("ev") == "pong")
            if m is not None:
                out[wid] = m
        if time.perf_counter() > deadline:
            fail(f"4e: pongs from {sorted(out)} of {sorted(co.workers)}")
        time.sleep(0.005)
    return out


def e4_acts(rec):
    return [e.data.get("action") for e in rec.recent(kind="elastic")]


def e4_snapshot(co):
    """The live workers' hellos and shard bounds (a closed coordinator
    holds no workers)."""
    return {"hellos": {wid: w.hello for wid, w in co.workers.items()},
            "shards": {wid: (lo, hi) for wid, lo, hi in co.shards}}


def e4_worker_gates(where, snap, out, pongs, fwd_per_call, bwd_per_call):
    """Each live worker: a hello with no jax, a CUDA device and no nvcc
    run; its shard bytes 3 * 4 * (hi - lo); its flash launches exactly
    the per-call counts times its gradient calls (the warm-up among
    them). Returns the workers' launches by kernel."""
    from deeplearning4j_tpu_torch.parallel.fsdp import zero1_partition
    bounds = snap["shards"]
    want_state = sorted(3 * 4 * (hi - lo) for lo, hi in zero1_partition(
        out["n_params"], len(bounds)))
    got = {"flash_fwd": 0, "flash_bwd": 0}
    bad = []
    if sorted(bounds) != sorted(pongs):
        bad.append(f"pongs from {sorted(pongs)}, shards {bounds}")
    for wid, h in sorted(snap["hellos"].items()):
        p = pongs[wid]
        lo, hi = bounds[wid]
        calls = p["grad_calls"]
        if h.get("jax_loaded") is not False or \
                not str(h.get("device", "")).startswith("cuda") or \
                any(h["kernels"]["nvcc_runs"].values()):
            bad.append(f"worker {wid} hello {h}")
        if p["state_bytes"] != 3 * 4 * (hi - lo) or \
                out["worker_state_bytes"][wid] != p["state_bytes"]:
            bad.append(f"worker {wid} state bytes {p['state_bytes']}")
        if p["launches"] != {"flash_fwd": fwd_per_call * calls,
                             "flash_bwd": bwd_per_call * calls}:
            bad.append(f"worker {wid} launches {p['launches']} over "
                       f"{calls} grad calls")
        for k in got:
            got[k] += p["launches"][k]
    if sorted(out["worker_state_bytes"].values()) != want_state:
        bad.append(f"state bytes {out['worker_state_bytes']} vs {want_state}")
    if bad:
        fail(f"4e {where}: " + "; ".join(bad))
    return got


def e4_exact(where, out, ref, steps, params=True):
    """Bit-equality with the oracle's first ``steps`` losses and, with
    ``params`` (the oracle ran ``steps`` steps), its final params."""
    if len(out["losses"]) != steps:
        fail(f"4e {where}: {len(out['losses'])} of {steps} steps")
    if out["losses"] != ref["losses"][:steps] or (
            params and not np.array_equal(out["params"], ref["params"])):
        dl = max(abs(a - b) for a, b in zip(out["losses"], ref["losses"]))
        dp = (float(np.abs(out["params"] - ref["params"]).max())
              if params else None)
        fail(f"4e {where}: not bit-equal to reference_run on the card "
             f"(losses {dl}, params {dp})")


def e4_wire(co):
    return {k: co.wire[k] for k in E4_WIRE_KEYS}


def e4_ckpt(reg):
    """(seconds, count) of the checkpoint writes in ``reg``."""
    _, s, c = reg.get("checkpoint_write_seconds")._unlabeled().snapshot()
    return s, c


def e4_start(cos):
    """Start coordinators in the background (each start spawns its
    workers and waits for their hellos); `e4_started` waits for them."""
    errors = []

    def start(name, co):
        try:
            co.start()
        except Exception as e:   # reported by e4_started
            errors.append(f"{name}: {type(e).__name__}: {e}")
    threads = [threading.Thread(target=start, args=(n, co), daemon=True)
               for n, co in cos.items()]
    for t in threads:
        t.start()
    return cos, threads, errors, time.perf_counter()


def e4_started(started):
    """Wait for `e4_start`'s coordinators; returns the seconds from
    their start and every worker's spawn-to-hello seconds."""
    cos, threads, errors, t0 = started
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        for co in cos.values():
            co.kill()
        fail(f"4e: fleets did not start: {errors}")
    return time.perf_counter() - t0, {
        n: [w.hello_s for w in co.workers.values()]
        for n, co in cos.items()}


def e4_thread(fn):
    """``fn`` on a thread; the box gets its result ("out"), its seconds
    ("s") or its error ("error")."""
    box = {}

    def run():
        try:
            t0 = time.perf_counter()
            box["out"] = fn()
            box["s"] = time.perf_counter() - t0
        except Exception as e:
            box["error"] = f"{type(e).__name__}: {e}"
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def e4_full_config(tmp):
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.train.elastic import ElasticConfig
    B, T, _, D, H, V = FLAGSHIP_TRAIN
    cfg = TransformerConfig(vocab_size=V, d_model=D, n_heads=H,
                            n_layers=E4_FULL_LAYERS, max_len=T,
                            dtype="bfloat16", remat=True,
                            remat_policy="full")

    def ecfg(arm):
        # the reference's barrier defaults are for a CPU model of a few
        # thousand parameters; a line of tens of MB a broadcast needs more
        return ElasticConfig(
            checkpoint_dir=os.path.join(tmp, "full_" + arm), num_workers=3,
            microbatches_per_step=E4_FULL_MB, microbatch_size=E4_FULL_ROWS,
            seq_len=T, learning_rate=1e-3, checkpoint_every=2,
            step_timeout_s=120.0, barrier_timeout_s=120.0,
            startup_timeout_s=300.0, drain_timeout_s=120.0)
    return cfg, ecfg


def e4_full(torch, co, reg, rec, ref, ref_s, coord_peak):
    """4e (b) on a fleet already started: the steady arm (one warm step,
    then the timed steps), then the kill arm on the same fleet (module
    docstring), against one oracle ``ref`` of both arms' steps: the
    steady arm's losses are its first ones, the kill arm's losses and
    final params all of it. Returns the live workers' launches by
    kernel."""
    cfg = co.cfg
    L, D, V, T = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.max_len
    MB, ROWS, steps = E4_FULL_MB, E4_FULL_ROWS, E4_FULL_STEPS
    co.run(1)
    w0, c0 = e4_wire(co), e4_ckpt(reg)
    t0 = time.perf_counter()
    steady = co.run(steps)
    steady_s = time.perf_counter() - t0
    w1, c1 = e4_wire(co), e4_ckpt(reg)
    pongs = e4_pongs(co)
    snap = e4_snapshot(co)
    launches = e4_worker_gates("(b) steady", snap, steady, pongs, 2 * L, L)
    e4_exact("(b) steady", steady, ref, steps, params=False)
    timed = steps - 1
    ms = steady_s / timed * 1e3
    tok_s = MB * ROWS * T * timed / steady_s
    p_mat = L * 12 * D * D + D * V
    flops_tok = 3 * (2 * p_mat + 2 * L * T * D)
    n = steady["n_params"]
    e4_line(part="b", arm="steady", config=dict(
        vocab_size=V, d_model=D, n_heads=cfg.n_heads, n_layers=L, seq=T,
        dtype="bfloat16", remat="full"), n_layers=L,
        n_layers_flagship=FLAGSHIP_TRAIN[2], n_params=n, workers=3,
        microbatches=MB, microbatch_rows=ROWS, global_batch=MB * ROWS,
        timed_steps=timed, ms_per_step=ms, fleet_tokens_per_s=tok_s,
        model_flops_per_token=flops_tok,
        bf16_peak_share=tok_s * flops_tok / PEAK_FLOPS["bfloat16"],
        wire_per_step={k: (w1[k] - w0[k]) / timed for k in E4_WIRE_KEYS},
        checkpoint_s=(c1[0] - c0[0]) / max(1, c1[1] - c0[1]),
        checkpoints_timed=c1[1] - c0[1], losses=steady["losses"],
        bit_equal_reference=True,
        worker_state_bytes=steady["worker_state_bytes"],
        replicated_state_bytes=3 * 4 * n,
        worker_peak_bytes={w: p["peak_bytes"] for w, p in pongs.items()},
        coordinator_peak_bytes=coord_peak, reference_s=ref_s,
        worker_hello_s={w: h["startup_s"] for w, h in
                        snap["hellos"].items()},
        worker_launches=launches)
    if not (np.all(np.isfinite(steady["losses"]))
            and steady["losses"][-1] < steady["losses"][0]):
        fail(f"4e (b): losses {steady['losses']} not finite and falling")
    # kill, on the same fleet: worker 1 SIGKILLed two steps into the
    # arm, a replacement joins the step after, five steps
    t0 = time.perf_counter()
    kill = co.run(2 * steps)
    kill_s = time.perf_counter() - t0
    pongs = e4_pongs(co)
    got = e4_worker_gates("(b) kill", e4_snapshot(co), kill, pongs, 2 * L,
                          L)
    e4_exact("(b) steady, kill", kill, ref, 2 * steps)
    # the workers' counts are cumulative: the kill arm's gate stands for
    # both arms of the live workers
    launches = got
    acts = e4_acts(rec)
    resize_ms, t_kill = None, None
    for e in rec.recent(kind="elastic"):
        act = e.data.get("action")
        if act == "kill_detected" and t_kill is None:
            t_kill = e.ts
        elif act == "resize" and t_kill is not None:
            resize_ms = (e.ts - t_kill) * 1e3
            break
    if kill["replayed_steps"] < 1 or "kill_detected" not in acts:
        fail(f"4e (b) kill: replayed {kill['replayed_steps']}, {acts}")
    s, c = e4_ckpt(reg)
    s, c = s - c1[0], c - c1[1]
    e4_line(part="b", arm="kill", steps=steps, n_layers=L, run_s=kill_s,
            recovery_overhead_s=kill_s - steps * steady_s / timed,
            resize_barrier_ms=resize_ms,
            replayed_steps=kill["replayed_steps"], resizes=kill["resizes"],
            actions=acts, losses=kill["losses"], bit_equal_reference=True,
            worker_state_bytes=kill["worker_state_bytes"],
            worker_peak_bytes={w: p["peak_bytes"] for w, p in pongs.items()},
            worker_launches=got, checkpoint_s_mean=s / max(1, c),
            checkpoints=c)
    return launches


def e4_narrow(torch, churn_co, loose_co, recs, ref, cpu, ref_s,
              before_loose):
    """4e (a) on fleets already started: the kill / shrink-grow / hang
    trajectory; then the steady arm's (result, seconds) from
    ``before_loose()`` (a whole `ElasticTrainingMaster.fit`, run while
    the fleets started); then the loose arm (module docstring). Returns
    the live workers' launches by kernel."""
    from deeplearning4j_tpu_torch.parallel.fsdp import zero1_partition
    L, steps = churn_co.cfg.n_layers, E4_CHURN_STEPS
    launches = {"flash_fwd": 0, "flash_bwd": 0}

    def report(name, out, rec, snap, pongs, arm_s, n, **extra):
        acts = e4_acts(rec)
        if len(out["losses"]) != n or not np.all(np.isfinite(
                out["losses"])):
            fail(f"4e (a) {name}: losses {out['losses']}")
        worker = None
        if snap is not None:
            worker = e4_worker_gates(f"(a) {name}", snap, out, pongs, L, L)
            for k in launches:
                launches[k] += worker[k]
        elif sorted(out["worker_state_bytes"].values()) != sorted(
                3 * 4 * (hi - lo) for lo, hi in zero1_partition(
                    out["n_params"], out["workers"])):
            fail(f"4e (a) {name}: state bytes {out['worker_state_bytes']}")
        e4_line(part="a", arm=name, steps=n, losses=out["losses"],
                run_s=out["elapsed_s"], arm_s=arm_s,
                replayed_steps=out["replayed_steps"],
                resizes=out["resizes"], workers=out["workers"],
                actions=acts, worker_state_bytes=out["worker_state_bytes"],
                worker_launches=worker,
                hellos=({w: dict(device=h["device"],
                                 jax_loaded=h["jax_loaded"],
                                 nvcc_runs=h["kernels"]["nvcc_runs"])
                         for w, h in snap["hellos"].items()}
                        if snap else None), **extra)
        return acts

    def churn(co):
        co.run(2)
        co.remove_worker(2)
        co.run(5)
        if sorted(co.workers) != [0]:
            raise RuntimeError(f"shrunk to {sorted(co.workers)}")
        co.add_worker(3)
        return co.run(steps)

    def drive(co, fn):
        t0 = time.perf_counter()
        with co:
            out = fn(co)
            return out, e4_snapshot(co), e4_pongs(co), \
                time.perf_counter() - t0
    out, snap, pongs, arm_s = drive(churn_co, churn)
    e4_exact("(a) kill, shrink-grow, hang", out, ref, steps)
    rec = recs["churn"]
    acts = report("kill_shrink_grow_hang", out, rec, snap, pongs, arm_s,
                  steps, bit_equal_reference=True,
                  step_barrier_s=churn_co.ecfg.step_timeout_s)
    reasons = [e.data.get("reason") for e in rec.recent(kind="elastic")
               if e.data.get("action") == "evict"]
    if not (out["replayed_steps"] >= 2 and acts.count("kill_detected") >= 3
            and reasons == ["leave", "stale_bound"]
            and acts.count("replay") >= 2 and out["workers"] == 1
            and "loose_enter" in acts):
        fail(f"4e (a) churn: replayed {out['replayed_steps']}, "
             f"{out['workers']} workers, evictions {reasons}, {acts}")
    steady = before_loose()
    e4_exact("(a) steady", steady[0], ref, steps)
    report("steady", steady[0], recs["a_steady"], None, None, steady[1],
           steps, bit_equal_reference=True)
    err = max(abs(a - b) for a, b in zip(steady[0]["losses"],
                                          cpu["losses"]))
    if not err <= 1e-4:
        fail(f"4e (a): steady losses {err} from the CPU reference_run")
    out, snap, pongs, arm_s = drive(loose_co, lambda co: co.run(8))
    acts = report("loose", out, recs["loose"], snap, pongs, arm_s, 8,
                  bit_equal_reference=False,
                  step_barrier_s=loose_co.ecfg.step_timeout_s,
                  slowdown_s=E4_LOOSE_SLOW_S)
    if "loose_enter" not in acts or "resync" not in acts[
            acts.index("loose_enter"):] or out["workers"] != 3:
        fail(f"4e (a) loose: {acts}, {out['workers']} workers")
    e4_line(part="a", run="summary", config=E4_NARROW, workers=3,
            microbatches=6, microbatch_rows=4, steps=steps,
            reference_s=ref_s, steady_vs_cpu_loss_max_abs_err=err,
            loss_tol=1e-4, launches=launches)
    return launches


def phase_elastic_training(torch, dev):
    """4e (module docstring): elastic ZeRO-1 training over worker
    processes on the card. Every fleet starts at once, the steady narrow
    arm's whole fit among them; then (b) and (a) run one arm at a time.
    Returns the workers' flash launches."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.models.transformer import \
        TransformerConfig
    from deeplearning4j_tpu_torch.observability.events import \
        FlightRecorder
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.failure import \
        ElasticFaultInjector
    from deeplearning4j_tpu_torch.scaleout.training_master import \
        ElasticTrainingMaster
    from deeplearning4j_tpu_torch.train.elastic import (ElasticConfig,
                                                        ElasticCoordinator,
                                                        reference_run,
                                                        set_deterministic)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dl4j-4e-")
    # the coordinators' own gradient calls (the oracle, a loose worker's
    # microbatches) are deterministic too; on for the phase so that the
    # coordinators' threads never toggle the process-wide flag under
    # each other
    prev = torch.are_deterministic_algorithms_enabled()
    set_deterministic(True)
    regs = {k: MetricsRegistry()
            for k in ("full", "a_steady", "churn", "loose")}
    recs = {k: FlightRecorder(capacity=512) for k in regs}
    cos = {}
    try:
        fcfg, fecfg = e4_full_config(tmp)
        ncfg = TransformerConfig(**E4_NARROW)
        nbase = dict(num_workers=3, microbatches_per_step=6,
                     microbatch_size=4, seq_len=32, checkpoint_every=2)

        def necfg(arm, **kw):
            return ElasticConfig(checkpoint_dir=os.path.join(tmp, arm),
                                 **dict(nbase, **kw))
        cos = {
            # (b): steady for 5 steps, then the kill arm on the same
            # fleet: worker 1 killed at step 7, worker 3 joining at 8
            "full": ElasticCoordinator(
                fcfg, fecfg("full"), registry=regs["full"],
                recorder=recs["full"],
                fault_injector=ElasticFaultInjector(
                    kill_at={E4_FULL_STEPS + 2: 1},
                    join_at={E4_FULL_STEPS + 3: 3})),
            # worker 2 leaves at step 2 (remove_worker), worker 1 is
            # killed at 3, worker 3 joins at 5 (add_worker: the kill's
            # replacement and the grow); worker 0 SIGSTOPped at 12,
            # loose at its first missed barrier (far above a step) and
            # evicted past a stale bound of 2
            "churn": ElasticCoordinator(
                ncfg, necfg("churn", step_timeout_s=E4_CHURN_BARRIER_S,
                            sync_every=1, stale_bound=2),
                registry=regs["churn"], recorder=recs["churn"],
                fault_injector=ElasticFaultInjector(
                    kill_at={3: 1}, hang_at={12: 0})),
            # worker 1 slowed for step 2: JAX's slowdown / barrier ratio
            "loose": ElasticCoordinator(
                ncfg, necfg("loose", step_timeout_s=E4_LOOSE_BARRIER_S,
                            sync_every=1, stale_bound=30),
                registry=regs["loose"], recorder=recs["loose"],
                fault_injector=ElasticFaultInjector(
                    slow_at={2: (1, E4_LOOSE_SLOW_S), 3: (1, 0.0)})),
        }
        tm = ElasticTrainingMaster(
            checkpoint_dir=os.path.join(tmp, "a_steady"), workers=3,
            microbatches_per_step=6, microbatch_size=4, seq_len=32,
            checkpoint_every=2, recorder=recs["a_steady"],
            registry=regs["a_steady"])
        # the narrow fleets and the steady fit start at once, the oracles
        # beside them
        t0 = time.perf_counter()
        narrow_start = e4_start({k: cos[k] for k in ("churn", "loose")})
        fit_thread, fit_box = e4_thread(
            lambda: tm.fit(ncfg, E4_CHURN_STEPS))
        torch.cuda.reset_peak_memory_stats()
        nref = reference_run(ncfg, necfg("ref"), E4_CHURN_STEPS)
        nref_s = time.perf_counter() - t0
        cpu = reference_run(ncfg, necfg("ref_cpu"), 8, device="cpu")
        t1 = time.perf_counter()
        fref = reference_run(fcfg, fecfg("ref"), 2 * E4_FULL_STEPS)
        fref_s = time.perf_counter() - t1
        coord_peak = torch.cuda.max_memory_allocated()
        narrow_boot_s, narrow_hello = e4_started(narrow_start)
        # the flagship fleet starts during the churn arm (whose barriers
        # are far above a step); the loose arm and (b) run alone
        full_start = e4_start({"full": cos["full"]})

        def before_loose():
            fit_thread.join(timeout=600)
            if "out" not in fit_box:
                fail(f"4e (a) steady: {fit_box.get('error', 'timed out')}")
            return fit_box["out"], fit_box["s"]
        t1 = time.perf_counter()
        narrow = e4_narrow(torch, cos["churn"], cos["loose"], recs, nref,
                           cpu, nref_s, before_loose)
        narrow_s = time.perf_counter() - t1
        full_boot_s, full_hello = e4_started(full_start)
        e4_line(run="starts", narrow_fleets_s=narrow_boot_s,
                full_fleet_s=full_boot_s,
                hello_s=dict(narrow_hello, **full_hello),
                full_fleet_started_beside="the churn arm")
        t1 = time.perf_counter()
        with cos["full"]:
            launches = e4_full(torch, cos["full"], regs["full"],
                               recs["full"], fref, fref_s, coord_peak)
        full_s = time.perf_counter() - t1
    finally:
        set_deterministic(prev)
        for co in cos.values():
            co.close()
        shutil.rmtree(tmp, ignore_errors=True)
    for k in launches:
        launches[k] += narrow[k]
    e4_line(run="summary", narrow_s=narrow_s, full_s=full_s,
            phase_s=time.perf_counter() - t_phase, launches=launches)
    return launches


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
    (dense then MoE in each turn): tokens/s and ms a step; (b) 3c's
    paged waves, (c) its chunk-256 paged arm on the first 24 requests of
    its first wave, (d) int8 weights and KV on phase 3's
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
    for p in (False, True):
        for m in ("dense", "moe"):
            timed.setdefault((m, p), []).append(
                run(m, engs[(m, p)], [prompts], want[m])[0])

    def col(m, p, k):
        return [r[k] for r in timed[(m, p)]]

    line(dict(phase="3g", run="moe_vs_dense_in_turns", order="S P",
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
            "chunked": ([first[:24]], dict(paged, prefill_chunk=256)),
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
                  results["chunked"], [contiguous_first[:24]])),
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
# phase 5d: the DSL's CNN training path (MultiLayerNetwork)
# ---------------------------------------------------------------------------

# the card's nvidia-smi line (name, power limit), beside every 5d number
CARD = "nvidia-smi unavailable"
D5_TOL = 1e-4          # f32 card vs CPU: scores, params, BN state


def d5_line(**rec):
    line(dict(phase="5d", card=CARD, **rec))


def d5_np(tree):
    return {k: {n: t.detach().float().cpu().numpy() for n, t in v.items()}
            for k, v in tree.items()}


def d5_tree_err(a, b):
    """Largest |a - b| over two {layer: {name: tensor}} trees."""
    return max([max_err(a[k][n].cpu(), b[k][n].cpu())
                for k in b for n in b[k]] or [0.0])


def d5_narrow_lenet(dtype="float32"):
    from deeplearning4j_tpu_torch.models.zoo import lenet_mnist
    conf = lenet_mnist(dtype=dtype)
    conf.layers[0].n_out, conf.layers[2].n_out = 4, 8
    conf.layers[4].n_out = 32
    return conf


def d5_bn_lrn_cnn():
    """A narrow CNN through every normalization and dropout path: conv,
    BN, LRN, max pool, a conv with input dropout, BN, avg pool, a dropout
    layer, dense, softmax."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    return (NeuralNetConfiguration(seed=21, updater="nesterovs",
                                   learning_rate=0.01, momentum=0.9)
            .list(L.ConvolutionLayer(n_out=8, kernel_size=(5, 5),
                                     convolution_mode="same",
                                     activation="relu"),
                  L.BatchNormalization(),
                  L.LocalResponseNormalization(n=5, alpha=1e-3),
                  L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                  L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                     stride=(2, 2), convolution_mode="same",
                                     activation="relu", dropout=0.2),
                  L.BatchNormalization(),
                  L.SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2),
                                     stride=(2, 2)),
                  L.DropoutLayer(rate=0.3),
                  L.DenseLayer(n_out=32, activation="relu"),
                  L.OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1)))


def d5_card_and_cpu(dev, conf_fn):
    """The network on the CPU and on the card from one set of weights."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    cpu = MultiLayerNetwork(conf_fn(), device="cpu").init()
    card = MultiLayerNetwork(conf_fn(), device=dev)
    card.set_params_from_numpy(d5_np(cpu.params))
    card.set_state_from_numpy(d5_np(cpu.state))
    return cpu, card


def d5_f32_card_vs_cpu(torch, dev):
    """(a) float32 card vs CPU: the narrow LeNet and the BN / LRN /
    dropout CNN, 3 fit steps each on synthetic MNIST (scores, params and
    BN state within D5_TOL; dropout's units are a function of its seed,
    the same on both devices), then 3 LBFGS iterations on mlp_mnist."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import mlp_mnist
    from deeplearning4j_tpu_torch.train.listeners import \
        CollectScoresIterationListener
    it = MnistDataSetIterator(32, num_examples=96)
    batches = [(b.features, b.labels) for b in it]
    for name, conf_fn in (("lenet_narrow_4_8_32", d5_narrow_lenet),
                          ("cnn_bn_lrn_dropout", d5_bn_lrn_cnn)):
        cpu, card = d5_card_and_cpu(dev, conf_fn)
        sc = {"cpu": [], "cuda": []}
        for x, y in batches:
            for key, net in (("cpu", cpu), ("cuda", card)):
                net.fit(x, y)
                sc[key].append(float(net.score_value))
        s_err = max(abs(a - b) for a, b in zip(sc["cpu"], sc["cuda"]))
        p_err = d5_tree_err(card.params, cpu.params)
        st_err = d5_tree_err(card.state, cpu.state)
        d5_line(part="a", net=name, steps=len(batches), batch=32,
                scores_cuda=sc["cuda"], scores_cpu=sc["cpu"],
                score_max_abs_err=s_err, param_max_abs_err=p_err,
                state_max_abs_err=st_err, tol=D5_TOL)
        if not (s_err <= D5_TOL and p_err <= D5_TOL and st_err <= D5_TOL):
            fail(f"5d {name}: card vs CPU scores {s_err}, params {p_err}, "
                 f"state {st_err} (tol {D5_TOL})")
    # LBFGS: the line search compares scores, so a step accepted on one
    # device and not the other would show as a score gap
    def lbfgs():
        conf = mlp_mnist()
        conf.training.optimization_algo = "lbfgs"
        conf.training.num_iterations = 3
        return conf
    cpu, card = d5_card_and_cpu(dev, lbfgs)
    big = MnistDataSetIterator(256, num_examples=256)
    x, y = big.features, big.labels
    got = {}
    for key, net in (("cpu", cpu), ("cuda", card)):
        col = CollectScoresIterationListener()
        net.set_listeners(col)
        net.fit(x, y)
        got[key] = [s for _, s in col.scores]
    rel = max(abs(a - b) / max(abs(a), 1e-12)
              for a, b in zip(got["cpu"], got["cuda"]))
    p_err = d5_tree_err(card.params, cpu.params)
    d5_line(part="a", net="mlp_mnist_lbfgs_3", batch=256,
            scores_cuda=got["cuda"], scores_cpu=got["cpu"],
            score_max_rel_err=rel, param_max_abs_err=p_err,
            tol="scores within 1e-4 relative, params within 1e-3")
    if len(got["cpu"]) != len(got["cuda"]) or not got["cpu"] or \
            rel > 1e-4 or p_err > 1e-3:
        fail(f"5d LBFGS card vs CPU: {got}, params {p_err}")


def d5_timed_fit_batched(torch, net, xs, ys, epochs, batch):
    """One warm pass, then `epochs` timed passes of fit_batched: the
    record of examples/s, ms a step, the flop share, peak memory."""
    warm = net.fit_batched(xs, ys, epochs=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = net.fit_batched(xs, ys, epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = xs.shape[0] * epochs
    cost = net.fit_batched_cost(xs[:1], ys[:1])
    sc = [float(v) for v in scores]
    return dict(batch=batch, pool=int(xs.shape[0]), epochs=epochs,
                wall_s=wall, examples_per_s=batch * steps / wall,
                ms_per_step=wall / steps * 1e3,
                flops_per_step=cost["flops"],
                bf16_peak_share=cost["flops"] * steps / wall
                / PEAK_FLOPS["bfloat16"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                warm_scores=[float(v) for v in warm], scores=sc)


def d5_lenet_full_width(torch, dev, b=4096, pool=15, test_n=10000):
    """(b) lenet_mnist bf16 at bench.py's shapes: B=4096, a pool of 15
    minibatches (one synthetic MNIST epoch, 61,440 examples), fit_batched
    2 epochs after a warm pass; then one epoch of fit(MnistDataSetIterator)
    with ScoreIterationListener and PerformanceListener, and evaluate."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import lenet_mnist
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.train.listeners import (
        PerformanceListener, ScoreIterationListener)
    it = MnistDataSetIterator(b, num_examples=b * pool)
    net = MultiLayerNetwork(lenet_mnist(dtype="bfloat16"), device=dev).init()
    xs = torch.from_numpy(it.features.reshape(pool, b, 784)).to(dev)
    ys = torch.from_numpy(it.labels.reshape(pool, b, 10)).to(dev)
    rec = d5_timed_fit_batched(torch, net, xs, ys, 2, b)
    sc, warm = rec["scores"], rec["warm_scores"]
    d5_line(part="b", config="lenet_mnist bf16", synthetic=it.synthetic,
            **{k: v for k, v in rec.items()
               if k not in ("scores", "warm_scores")},
            first_scores=warm[:3], last_scores=sc[-3:])
    if not (np.all(np.isfinite(sc)) and np.mean(sc[-pool:])
            < np.mean(warm)):
        fail(f"5d LeNet scores not finite or not falling: {warm} {sc}")
    reg = MetricsRegistry()
    perf = PerformanceListener(frequency=5, report=False, registry=reg)
    net.set_listeners(ScoreIterationListener(5, registry=reg), perf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    net.set_listeners()
    test = MnistDataSetIterator(b, train=False, num_examples=test_n)
    ev = net.evaluate(test)
    acc = ev.accuracy()
    d5_line(part="b", run="fit_iterator_and_evaluate",
            examples=it.num_examples(), wall_s=wall,
            examples_per_s=it.num_examples() / wall,
            listener_samples_per_s=perf.last_samples_per_sec,
            training_score=reg.get("training_score").value,
            training_samples=reg.get("training_samples").value,
            accuracy=acc, f1=ev.f1(), eval_examples=int(
                ev.confusion.matrix.sum()))
    if not acc > 0.5:
        fail(f"5d LeNet accuracy {acc} after 4 epochs (gate > 0.5)")
    if reg.get("training_samples").value != it.num_examples():
        fail("5d PerformanceListener counted "
             f"{reg.get('training_samples').value} samples")
    del net, xs, ys
    torch.cuda.empty_cache()


def d5_vgg16_full_width(torch, dev, b=512, pool=4):
    """(c) VGG16-CIFAR as benchmarks/flagship.py:131-158 builds it:
    vgg16(include_top=False, 32 x 32) + dense 512 + softmax 10, bf16,
    B=512, a pool of 4, fit_batched 2 epochs after a warm pass."""
    from deeplearning4j_tpu_torch.modelimport.trained_models import vgg16
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = vgg16(num_classes=10, include_top=False, height=32, width=32,
                 dtype="bfloat16")
    conf.layers.append(DenseLayer(name="fc", n_out=512, activation="relu"))
    conf.layers.append(OutputLayer(name="out", n_out=10,
                                   activation="softmax",
                                   loss_function="mcxent"))
    net = MultiLayerNetwork(conf, device=dev).init()
    rng = np.random.default_rng(0)                # flagship.py:147-149
    xs = torch.from_numpy(rng.random((pool, b, 32, 32, 3),
                                     dtype=np.float32)).to(dev)
    ys = torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, 10, (pool, b))), 10).float().to(dev)
    rec = d5_timed_fit_batched(torch, net, xs, ys, 2, b)
    sc = rec.pop("scores")
    d5_line(part="c", config="vgg16_cifar bf16 (+fc 512, softmax 10)",
            **{k: v for k, v in rec.items() if k != "warm_scores"},
            scores=sc)
    if not np.all(np.isfinite(sc)):
        fail(f"5d VGG16 scores not finite: {sc}")
    del net, xs, ys
    torch.cuda.empty_cache()


def d5_transformer(torch, dev, d=512, heads=8, t=1024, b=16):
    """(d) a MultiLayerNetwork of two causal TransformerBlocks and an
    RnnOutputLayer at d 512, 8 heads, T=1024, B=16, bf16: 3 fit steps;
    the flash forward and backward wrappers launch once a block a step."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    v, blocks, steps = 256, 2, 3
    conf = (NeuralNetConfiguration(seed=5, updater="adam",
                                   learning_rate=1e-3, dtype="bfloat16")
            .list(*[L.TransformerBlock(n_heads=heads, causal=True)
                    for _ in range(blocks)],
                  L.RnnOutputLayer(n_out=v, activation="softmax"))
            .set_input_type(InputType.recurrent(d, t)))
    net = MultiLayerNetwork(conf, device=dev).init()
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn((b, t, d), generator=g).to(dev)
    ids = torch.randint(0, v, (b, t), generator=g).to(dev)
    y = torch.nn.functional.one_hot(ids, v).float()
    net.fit(x, y)                                     # warm
    torch.cuda.synchronize()
    fa.flash_forward_cuda.launches = 0
    fa.flash_backward_cuda.launches = 0
    t0 = time.perf_counter()
    scores = []
    for _ in range(steps):
        net.fit(x, y)
        scores.append(float(net.score_value))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fa.flash_forward_cuda.launches, fa.flash_backward_cuda.launches
    d5_line(part="d", config="2 x TransformerBlock d512 h8 + RnnOutput",
            batch=b, seq=t, steps=steps, wall_s=wall,
            ms_per_step=wall / steps * 1e3,
            tokens_per_s=b * t * steps / wall, scores=scores,
            flash_fwd_launches=fwd, flash_bwd_launches=bwd)
    if fwd != blocks * steps or bwd != blocks * steps:
        fail(f"5d transformer: {fwd} forward / {bwd} backward flash "
             f"launches in {steps} steps of {blocks} blocks")
    if not (np.all(np.isfinite(scores)) and scores[-1] < scores[0]):
        fail(f"5d transformer scores {scores}")
    del net
    torch.cuda.empty_cache()
    return {"flash_fwd": fwd, "flash_bwd": bwd}


def d5_tools(torch, dev):
    """(e) The guard, early stopping, the serializer and the char-RNN
    under early stopping on the card."""
    import tempfile
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lstm as tl
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.train.guard import TrainingGuard
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    it = MnistDataSetIterator(64, num_examples=256)
    x, y = it.features[:64], it.labels[:64]
    # a NaN batch under the guard: SKIP, the tree bit-equal
    net = MultiLayerNetwork(d5_narrow_lenet(), device=dev).init()
    guard = TrainingGuard(registry=MetricsRegistry())
    net.set_training_guard(guard)
    net.fit(x, y)
    before = {k: {n: p.clone() for n, p in v.items()}
              for k, v in net.params.items()}
    bad = x.copy()
    bad[0, 0] = np.nan
    net.fit(bad, y)
    same = all(torch.equal(net.params[k][n], before[k][n])
               for k in before for n in before[k])
    net.fit(x, y)
    d5_line(part="e", run="guard_nan_batch", last_reason=guard.last_reason,
            accepted=guard.accepted_steps, params_bit_equal_after_skip=same,
            iteration_count=net.iteration_count)
    if not same or guard.accepted_steps != 2 or net.iteration_count != 3:
        fail("5d guard: the NaN batch changed the tree or was not skipped")
    net.set_training_guard(None)
    with tempfile.TemporaryDirectory() as tmp:
        # the serializer round trip, bit-equal
        path = os.path.join(tmp, "lenet.zip")
        ms.write_model(net, path)
        back = ms.restore_multi_layer_network(path, device=dev)
        eq = all(torch.equal(getattr(back, t)[k][n], getattr(net, t)[k][n])
                 for t in ("params", "state")
                 for k in getattr(net, t) for n in getattr(net, t)[k])
        out_eq = torch.equal(back.output(x), net.output(x))
        d5_line(part="e", run="serializer_round_trip", trees_bit_equal=eq,
                output_bit_equal=out_eq, bytes=os.path.getsize(path))
        if not (eq and out_eq):
            fail("5d serializer round trip is not bit-equal")
        # early stopping with a local-file saver: the restored best model
        # gives the saved model's output, bit for bit
        probe = torch.from_numpy(x).to(dev)
        saved = {}

        class Saver(es.LocalFileModelSaver):
            def save_best_model(self, n, score):
                saved["out"] = n.output(probe).clone()
                super().save_best_model(n, score)

        net = MultiLayerNetwork(d5_narrow_lenet(), device=dev).init()
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(4)],
            score_calculator=es.DataSetLossCalculator(
                BaseDatasetIterator(it.features[:128], it.labels[:128],
                                    64)),
            model_saver=Saver(os.path.join(tmp, "es")))
        res = es.EarlyStoppingTrainer(cfg, net, it).fit()
        best_eq = torch.equal(res.best_model.output(probe), saved["out"])
        d5_line(part="e", run="early_stopping_lenet",
                reason=res.termination_reason, best_epoch=res.best_model_epoch,
                total_epochs=res.total_epochs,
                scores=res.score_vs_epoch, best_output_bit_equal=best_eq)
        if not best_eq or res.total_epochs != 4:
            fail(f"5d early stopping: best model output equal {best_eq}, "
                 f"{res.total_epochs} epochs")
    # early stopping over phase 5b's float32 char-RNN, lstm_wavefront off
    b, t, n_batches, epochs = 32, 64, 3, 2
    net = MultiLayerNetwork(char_rnn_lstm(CHAR_V, hidden=CHAR_H, layers=2,
                                          tbptt_length=32,
                                          learning_rate=0.01), device=dev)
    net.init()
    net.lstm_wavefront = False
    rng = np.random.default_rng(12)
    eye = np.eye(CHAR_V, dtype=np.float32)
    ids = rng.integers(0, CHAR_V, (n_batches * b, t))
    data = BaseDatasetIterator(eye[ids], eye[np.roll(ids, -1, axis=1)], b)
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            es.MaxEpochsTerminationCondition(epochs)],
        iteration_termination_conditions=[
            es.InvalidScoreIterationTerminationCondition()])
    tl.lstm_scan_cuda.launches = 0
    res = es.EarlyStoppingTrainer(cfg, net, data).fit()
    n_lstm = tl.lstm_scan_cuda.launches
    chunks = epochs * n_batches * (t // 32)
    d5_line(part="e", run="early_stopping_char_rnn", reason=
            res.termination_reason, total_epochs=res.total_epochs,
            scores=res.score_vs_epoch, chunks=chunks,
            lstm_scan_launches=n_lstm)
    if n_lstm != 2 * chunks or res.total_epochs != epochs:
        fail(f"5d char-RNN early stopping: {n_lstm} lstm_scan launches for "
             f"{chunks} chunks of 2 layers")
    del net
    torch.cuda.empty_cache()
    return {"lstm_scan": n_lstm}


def phase_dsl_cnn(torch, dev):
    """5d. The DSL's CNN training path: (a) f32 card vs CPU, (b) LeNet and
    (c) VGG16-CIFAR at full width, (d) a DSL transformer's flash
    launches, (e) the tools. Returns the main-path kernels' launches
    (flash forward / backward from (d), lstm_scan from (e))."""
    t0 = time.perf_counter()
    d5_f32_card_vs_cpu(torch, dev)
    d5_lenet_full_width(torch, dev)
    d5_vgg16_full_width(torch, dev)
    launches = d5_transformer(torch, dev)
    launches.update(d5_tools(torch, dev))
    d5_line(run="phase_5d", wall_s=time.perf_counter() - t0,
            launches=launches)
    return launches


# ---------------------------------------------------------------------------
# phase 5e: the DAG runtime (ComputationGraph) and the training tools
# ---------------------------------------------------------------------------

E5_TOL = 1e-4          # f32 card vs CPU: scores, params, BN state


def e5_line(**rec):
    line(dict(phase="5e", card=CARD, **rec))


def e5_tree_equal(torch, a, b) -> bool:
    """Two nested {name: tensor} trees, bit for bit."""
    if isinstance(b, dict):
        return set(a) == set(b) and all(e5_tree_equal(torch, a[k], b[k])
                                        for k in b)
    return torch.equal(a, b)


def e5_residual(height=16, width=16, classes=10):
    """ResNet-50's structure at narrow widths: a stem conv + BN/relu, two
    bottleneck blocks (BN after every conv, element-wise adds, the first
    block with a stride-2 projection shortcut), global average pool,
    softmax; Nesterov momentum 0.9, lr 0.01."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph.vertices import \
        ElementWiseVertex
    b = (NeuralNetConfiguration(seed=6, learning_rate=0.01,
                                updater="nesterovs", momentum=0.9,
                                weight_init="relu", activation="identity")
         .graph_builder().add_inputs("input")
         .set_input_types(input=InputType.convolutional(height, width, 3)))

    def conv(name, n, k, s, src):
        b.add_layer(name, L.ConvolutionLayer(
            n_out=n, kernel_size=(k, k), stride=(s, s),
            convolution_mode="same", activation="identity"), src)
        return name

    def bn(name, src, relu):
        b.add_layer(name, L.BatchNormalization(
            activation="relu" if relu else "identity"), src)
        return name

    prev = bn("bn1", conv("conv1", 16, 3, 1, "input"), True)
    for i, (stride, proj) in enumerate(((2, True), (1, False))):
        n = f"b{i}"
        x = bn(f"{n}_bn1", conv(f"{n}_c1", 8, 1, stride, prev), True)
        x = bn(f"{n}_bn2", conv(f"{n}_c2", 8, 3, 1, x), True)
        x = bn(f"{n}_bn3", conv(f"{n}_c3", 32, 1, 1, x), False)
        sc = (bn(f"{n}_bnp", conv(f"{n}_proj", 32, 1, stride, prev), False)
              if proj else prev)
        b.add_vertex(f"{n}_add", ElementWiseVertex(op="add"), x, sc)
        b.add_layer(f"{n}_out", L.ActivationLayer(activation="relu"),
                    f"{n}_add")
        prev = f"{n}_out"
    b.add_layer("avg_pool", L.GlobalPoolingLayer(pooling_type="avg"), prev)
    b.add_layer("fc", L.OutputLayer(n_out=classes, activation="softmax",
                                    loss_function="mcxent"), "avg_pool")
    return b.set_outputs("fc").build()


def e5_two_input():
    """Two inputs through dense vertices (one with input dropout), a
    MergeVertex and an ElementWiseVertex into two output layers."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import vertices as V
    return (NeuralNetConfiguration(seed=3, updater="adam",
                                   learning_rate=0.01, activation="tanh")
            .graph_builder().add_inputs("a", "b")
            .set_input_types(a=InputType.feed_forward(20),
                             b=InputType.feed_forward(12))
            .add_layer("da", L.DenseLayer(n_out=16), "a")
            .add_layer("db", L.DenseLayer(n_out=16, dropout=0.3), "b")
            .add_vertex("m", V.MergeVertex(), "da", "db")
            .add_vertex("s", V.ElementWiseVertex(op="add"), "da", "db")
            .add_layer("h", L.DenseLayer(n_out=24), "m")
            .add_layer("out", L.OutputLayer(n_out=5, activation="softmax"),
                       "h")
            .add_layer("out2", L.OutputLayer(n_out=3, activation="softmax"),
                       "s")
            .set_outputs("out", "out2").build())


def e5_char_rnn_graph(v, h, tbptt, dtype, lr=0.1, seed=12345):
    """zoo.char_rnn_lstm's layers as a ComputationGraph: two GravesLSTM
    vertices and an RnnOutputLayer named layer_0..2 (topological index =
    layer index, so the same seed gives the same weights)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    b = (NeuralNetConfiguration(seed=seed, updater="rmsprop",
                                learning_rate=lr, weight_init="xavier",
                                dtype=dtype)
         .graph_builder().add_inputs("chars")
         .set_input_types(chars=InputType.recurrent(v)))
    b.add_layer("layer_0", L.GravesLSTM(n_out=h, activation="tanh"),
                "chars")
    b.add_layer("layer_1", L.GravesLSTM(n_out=h, activation="tanh"),
                "layer_0")
    b.add_layer("layer_2", L.RnnOutputLayer(n_out=v, activation="softmax",
                                            loss_function="mcxent"),
                "layer_1")
    return b.set_outputs("layer_2").backprop_type_tbptt(tbptt, tbptt).build()


def e5_graph_pair(dev, conf_fn):
    """The graph on the CPU and on the card from one set of weights."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    cpu = ComputationGraph(conf_fn(), device="cpu").init()
    card = ComputationGraph(conf_fn(), device=dev)
    card.set_params_from_numpy(d5_np(cpu.params))
    card.set_state_from_numpy(d5_np(cpu.state))
    return cpu, card


def e5_gate(name, sc, errs, **rec):
    """One (a) line: the card's and the CPU's scores ``sc`` and the
    other max-abs errors ``errs`` (params, state, outputs), each gated at
    E5_TOL."""
    errs = dict(score_max_abs_err=max(
        abs(a - b) for a, b in zip(sc["cpu"], sc["cuda"])), **errs)
    e5_line(part="a", net=name, scores_cuda=sc["cuda"],
            scores_cpu=sc["cpu"], tol=E5_TOL, **errs, **rec)
    if len(sc["cpu"]) != len(sc["cuda"]) or \
            not all(e <= E5_TOL for e in errs.values()):
        fail(f"5e {name}: card vs CPU {errs} (tol {E5_TOL})")


def e5_f32_card_vs_cpu(torch, dev):
    """(a) float32, card against CPU from one set of weights: the narrow
    residual graph (3 fit steps; BN state too), the two-input merge graph
    (3 steps, with dropout: its units are a function of the seed, the
    same on both devices), a GravesLSTM graph (TBPTT fit, then 20 steps
    of rnn_time_step) and the pretraining of a VAE vertex and an RBM
    layer (3 steps each; the draws are compared bit for bit)."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rng = np.random.default_rng(5)
    # the residual graph
    cpu, card = e5_graph_pair(dev, e5_residual)
    x = rng.random((8, 16, 16, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    sc = {"cpu": [], "cuda": []}
    for _ in range(3):
        for key, g in (("cpu", cpu), ("cuda", card)):
            g.fit(x, y)
            sc[key].append(float(g.score_value))
    e5_gate("residual_2_bottlenecks_bn", sc, dict(
        param_max_abs_err=d5_tree_err(card.params, cpu.params),
        state_max_abs_err=d5_tree_err(card.state, cpu.state)),
        steps=3, batch=8, preprocessors=len(card._preprocessors))
    # the two-input merge graph with dropout
    cpu, card = e5_graph_pair(dev, e5_two_input)
    xa = rng.random((16, 20), dtype=np.float32)
    xb = rng.random((16, 12), dtype=np.float32)
    y1 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    sc = {"cpu": [], "cuda": []}
    for _ in range(3):
        for key, g in (("cpu", cpu), ("cuda", card)):
            g.fit([xa, xb], [y1, y2])
            sc[key].append(float(g.score_value))
    out_err = max(max_err(a.cpu(), b) for a, b in zip(
        card.output(xa, xb), cpu.output(xa, xb)))
    e5_gate("two_input_merge_dropout", sc, dict(
        param_max_abs_err=d5_tree_err(card.params, cpu.params),
        output_max_abs_err=out_err), steps=3, batch=16)
    # a GravesLSTM graph: TBPTT fit, then rnn_time_step
    v, h = 20, 24
    cpu, card = e5_graph_pair(dev, lambda: e5_char_rnn_graph(
        v, h, 8, "float32", lr=0.01))
    eye = np.eye(v, dtype=np.float32)
    ids = rng.integers(0, v, (2, 16, 32))
    sc = {"cpu": [], "cuda": []}
    for n in range(2):
        for key, g in (("cpu", cpu), ("cuda", card)):
            g.fit(eye[ids[n]], eye[np.roll(ids[n], -1, axis=1)])
            sc[key].append(float(g.score_value))
    step_err = 0.0
    for g in (cpu, card):
        g.rnn_clear_previous_state()
    for t in range(20):
        a = card.rnn_time_step(eye[ids[0, :, t]])[0]
        b = cpu.rnn_time_step(eye[ids[0, :, t]])[0]
        step_err = max(step_err, max_err(a.cpu(), b))
    e5_gate("graves_lstm_graph_tbptt_and_rnn_time_step", sc, dict(
        param_max_abs_err=d5_tree_err(card.params, cpu.params),
        rnn_time_step_max_abs_err=step_err), chunks=8,
        iterations=card.iteration_count)
    if card.iteration_count != 8:
        fail(f"5e LSTM graph: {card.iteration_count} TBPTT updates, not 8")
    # pretraining: a VAE vertex (graph) and an RBM layer (network)
    def vae_graph():
        return (NeuralNetConfiguration(seed=3, updater="adam",
                                       learning_rate=0.01,
                                       activation="tanh")
                .graph_builder().add_inputs("in")
                .add_layer("d", L.DenseLayer(n_in=32, n_out=24), "in")
                .add_layer("vae", L.VariationalAutoencoder(
                    n_in=24, n_out=4, encoder_layer_sizes=(16,),
                    decoder_layer_sizes=(16,), num_samples=2), "d")
                .add_layer("out", L.OutputLayer(n_in=4, n_out=2,
                                                activation="softmax"),
                           "vae")
                .set_outputs("out").build())

    def rbm_net():
        return (NeuralNetConfiguration(seed=4, updater="sgd",
                                       learning_rate=0.1)
                .list(L.RBM(n_in=32, n_out=16, k=2),
                      L.OutputLayer(n_out=2, activation="softmax")))
    xp = (rng.random((64, 32)) < 0.4).astype(np.float32)
    cpu_g, card_g = e5_graph_pair(dev, vae_graph)
    cpu_n = MultiLayerNetwork(rbm_net(), device="cpu").init()
    card_n = MultiLayerNetwork(rbm_net(), device=dev)
    card_n.set_params_from_numpy(d5_np(cpu_n.params))
    sc = {"cpu": [], "cuda": []}
    for _ in range(3):
        for key, g, n in (("cpu", cpu_g, cpu_n), ("cuda", card_g, card_n)):
            g.pretrain(xp)
            n.pretrain(xp)
            sc[key] += [float(g.score_value), float(n.score_value)]
    lay = card_n.layers[0]
    draws_equal = all(torch.equal(lay.draw(kind, 77, (64, 32), dev).cpu(),
                                  lay.draw(kind, 77, (64, 32), "cpu"))
                      for kind in ("uniform", "normal"))
    e5_gate("pretrain_vae_vertex_and_rbm_layer", sc, dict(
        param_max_abs_err=max(d5_tree_err(card_g.params, cpu_g.params),
                              d5_tree_err(card_n.params, cpu_n.params))),
        steps=3, draws_bit_equal=draws_equal)
    if not draws_equal:
        fail("5e: the pretraining draws differ between the card and the CPU")


def e5_resnet50(torch, dev, b=128, pool=4, epochs=2):
    """(b) ResNet-50 as trained_models.resnet50() builds it (224 x 224 x
    3, 1000 classes, bf16, Nesterov 0.9, lr 0.01) at B=128 on a pool of
    4 seeded synthetic minibatches: fit_batched 2 epochs after a warm
    pass; FLOPs of one step by FlopCounterMode; one step under
    torch.profiler (busy share, top kernels); then a TransferLearning
    build (frozen up to avg_pool, fc1000 replaced with 10 classes) and 3
    steps of it."""
    from torch.utils.flop_counter import FlopCounterMode
    from deeplearning4j_tpu_torch.modelimport.trained_models import \
        resnet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.base import fold_in
    from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import \
        TransferLearning
    conf = resnet50()
    g = ComputationGraph(conf, device=dev).init()
    if g._preprocessors:
        fail(f"5e ResNet-50 has preprocessors {sorted(g._preprocessors)}")
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.random((pool, b, 224, 224, 3),
                                     dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, (pool, b))).to(dev)
    ys = torch.nn.functional.one_hot(labels, 1000).float()
    t0 = time.perf_counter()
    warm = g.fit_batched(xs, ys, epochs=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = g.fit_batched(xs, ys, epochs=epochs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = pool * epochs
    peak = torch.cuda.max_memory_allocated() / 1e9
    counter = FlopCounterMode(display=False)
    with counter:                  # one step, on copies: nothing kept
        g._step(g.params, g.state, g.updater_state, g.iteration_count,
                {"input": xs[0]}, {"fc1000": ys[0]},
                fold_in(conf.training.seed, g.iteration_count), None)
    flops = float(counter.get_total_flops())
    sc = [float(v) for v in scores]
    e5_line(part="b", config="resnet50 224x224x3, 1000 classes, bf16",
            batch=b, pool=pool, epochs=epochs, params=g.num_params(),
            warm_pass_s=warm_s, wall_s=wall,
            examples_per_s=b * steps / wall, ms_per_step=wall / steps * 1e3,
            flops_per_step=flops,
            bf16_peak_share=flops * steps / wall / PEAK_FLOPS["bfloat16"],
            peak_mem_gb=peak, preprocessors=0,
            warm_scores=[float(v) for v in warm], scores=sc)
    if not np.all(np.isfinite(sc)):
        fail(f"5e ResNet-50 scores not finite: {sc}")
    wall_p, rows, host = profiled(torch,
                                  lambda: g.fit_batched(xs[:1], ys[:1]))
    profile_line(wall_p, rows, host, phase="5e", card=CARD,
                 run="profiled_resnet50_step")
    new = (TransferLearning.GraphBuilder(g)
           .set_feature_extractor("avg_pool")
           .n_out_replace("fc1000", 10).build())
    frozen = [n for n, s in new.conf.vertices.items()
              if isinstance(s.vertex, FrozenLayer)]
    before = {n: {k: t.clone() for k, t in new.params[n].items()}
              for n in frozen}
    head = {k: t.clone() for k, t in new.params["fc1000"].items()}
    y10 = torch.nn.functional.one_hot(labels[0] % 10, 10).float()
    t0 = time.perf_counter()
    tl_scores = []
    for _ in range(3):
        new.fit(xs[0], y10)
        tl_scores.append(float(new.score_value))
    torch.cuda.synchronize()
    tl_wall = time.perf_counter() - t0
    frozen_equal = all(torch.equal(new.params[n][k], t)
                       for n in frozen for k, t in before[n].items())
    moved = any(not torch.equal(new.params["fc1000"][k], t)
                for k, t in head.items())
    e5_line(part="b", run="transfer_learning_fc1000_to_10",
            frozen_vertices=len(frozen), steps=3, wall_s=tl_wall,
            scores=tl_scores, frozen_params_bit_equal=frozen_equal,
            head_moved=moved)
    if not (frozen_equal and moved):
        fail(f"5e ResNet-50 transfer learning: frozen equal {frozen_equal},"
             f" head moved {moved}")
    del g, new, xs, ys
    torch.cuda.empty_cache()


def e5_lstm_graph_full_width(torch, dev, pool=4):
    """(c) phase 5c's BASELINE config 3 (V=80, H=200, two GravesLSTM,
    TBPTT 64, bf16, RMSProp lr 0.1) at B=1024, T=64 as a ComputationGraph:
    fit_batched over a pool of 4 after a warm pass, then 200 steps of
    rnn_time_step at B=1; the MultiLayerNetwork over the same layers and
    weights (lstm_wavefront off) on the same pool."""
    from deeplearning4j_tpu_torch.models.zoo import char_rnn_lstm
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import lstm as tl
    g = ComputationGraph(e5_char_rnn_graph(CHAR_V, CHAR_H, CHAR_T,
                                           "bfloat16"), device=dev).init()
    net = MultiLayerNetwork(char_rnn_lstm(vocab_size=CHAR_V, hidden=CHAR_H,
                                          layers=2, tbptt_length=CHAR_T,
                                          dtype="bfloat16"),
                            device=dev).init()
    net.lstm_wavefront = False
    net.params = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in g.params.items()}
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, CHAR_V, (pool, CHAR_B, CHAR_T)))
    eye = torch.eye(CHAR_V, device=dev)
    ids = ids.to(dev)
    xs, ys = eye[ids], eye[torch.roll(ids, -1, dims=2)]
    g.fit_batched(xs[:1], ys[:1])                    # warm
    net.fit_batched(xs[:1], ys[:1])
    torch.cuda.synchronize()
    tl.lstm_scan_cuda.launches = 0
    t0 = time.perf_counter()
    gs = g.fit_batched(xs, ys)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_fit = tl.lstm_scan_cuda.launches
    ns = net.fit_batched(xs, ys)
    gsc, nsc = [float(v) for v in gs], [float(v) for v in ns]
    bit_equal = torch.equal(gs, ns) and torch.equal(g.params_flat(),
                                                    net.params_flat())
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(gsc, nsc))
    chunks = pool                      # T = the TBPTT length: 1 a batch
    e5_line(part="c", config="graves_lstm_charrnn_2x200_T64 as a graph",
            dtype="bfloat16", batch=CHAR_B, seq=CHAR_T, pool=pool,
            wall_s=wall, chars_per_s=CHAR_B * CHAR_T * pool / wall,
            ms_per_minibatch=wall / pool * 1e3, scores_graph=gsc,
            scores_multilayer=nsc, scores_and_params_bit_equal=bit_equal,
            score_max_rel_diff=rel, lstm_scan_launches=n_fit,
            lstm_scan_per_vertex_chunk=n_fit / (2 * chunks))
    if n_fit != 2 * chunks:
        fail(f"5e LSTM graph: {n_fit} lstm_scan launches for {chunks} "
             "chunks of 2 GravesLSTM vertices")
    if not (bit_equal or rel <= 2.0 ** -7) or not np.all(np.isfinite(gsc)):
        fail(f"5e LSTM graph vs MultiLayerNetwork scores {gsc} / {nsc}")
    g.rnn_clear_previous_state()
    tl.lstm_scan_cuda.launches = 0
    srng = np.random.default_rng(1)
    cur = int(ids[0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(200):
        probs = g.rnn_time_step(eye[cur][None])[0][0].float().cpu().numpy()
        if probs.shape != (CHAR_V,) or not np.all(np.isfinite(probs)):
            fail(f"5e rnn_time_step gave {probs.shape} / non-finite values")
        cur = int(srng.choice(CHAR_V, p=probs / probs.sum()))
    swall = time.perf_counter() - t0
    n_step = tl.lstm_scan_cuda.launches
    e5_line(part="c", run="rnn_time_step_b1", steps=200, wall_s=swall,
            ms_per_step=swall / 200 * 1e3, lstm_scan_launches=n_step)
    if n_step != 2 * 200:
        fail(f"5e graph rnn_time_step: {n_step} lstm_scan launches for "
             "200 steps of 2 vertices")
    del g, net, xs, ys
    torch.cuda.empty_cache()
    return {"lstm_scan": n_fit + n_step}


def e5_attention(torch, dev, d=512, heads=8, t=1024, b=16, steps=3):
    """(d) two TransformerBlock vertices (causal, d 512, 8 heads) and an
    RnnOutputLayer as a graph at T=1024, B=16, bf16: 3 fit steps; the
    flash forward and backward launch once a block a step."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    v, blocks = 256, 2
    conf = (NeuralNetConfiguration(seed=5, updater="adam",
                                   learning_rate=1e-3, dtype="bfloat16")
            .graph_builder().add_inputs("seq")
            .set_input_types(seq=InputType.recurrent(d, t))
            .add_layer("blk0", L.TransformerBlock(n_heads=heads,
                                                  causal=True), "seq")
            .add_layer("blk1", L.TransformerBlock(n_heads=heads,
                                                  causal=True), "blk0")
            .add_layer("out", L.RnnOutputLayer(n_out=v,
                                               activation="softmax"),
                       "blk1")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device=dev).init()
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn((b, t, d), generator=gen).to(dev)
    y = torch.nn.functional.one_hot(
        torch.randint(0, v, (b, t), generator=gen), v).float().to(dev)
    g.fit(x, y)                                      # warm
    torch.cuda.synchronize()
    fa.flash_forward_cuda.launches = 0
    fa.flash_backward_cuda.launches = 0
    t0 = time.perf_counter()
    scores = []
    for _ in range(steps):
        g.fit(x, y)
        scores.append(float(g.score_value))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fa.flash_forward_cuda.launches, fa.flash_backward_cuda.launches
    e5_line(part="d", config="graph of 2 x TransformerBlock d512 h8",
            batch=b, seq=t, steps=steps, wall_s=wall,
            ms_per_step=wall / steps * 1e3,
            tokens_per_s=b * t * steps / wall, scores=scores,
            flash_fwd_launches=fwd, flash_bwd_launches=bwd)
    if fwd != blocks * steps or bwd != blocks * steps:
        fail(f"5e attention graph: {fwd} forward / {bwd} backward flash "
             f"launches in {steps} steps of {blocks} blocks")
    if not (np.all(np.isfinite(scores)) and scores[-1] < scores[0]):
        fail(f"5e attention graph scores {scores}")
    del g
    torch.cuda.empty_cache()
    return {"flash_fwd": fwd, "flash_bwd": bwd}


def e5_fault_tolerance(torch, dev, tmp):
    """FaultTolerantTrainer over the narrow LeNet (f32) with async
    checkpoints every 2 iterations and a NaN batch at iteration 3 (the
    guard skips it): an uninterrupted run; a run preempted at iteration 4
    and resumed by a fresh network over the batches left; a run whose
    step-4 write crashes mid-write, resumed by a fresh trainer from the
    last verified step. Both resumed runs must end bit-equal to the
    uninterrupted one."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.parallel import failure as pf
    from deeplearning4j_tpu_torch.train.guard import TrainingGuard
    it = MnistDataSetIterator(32, num_examples=192)
    fx, fy = it.features, it.labels

    def trainer(net, d, **kw):
        return pf.FaultTolerantTrainer(
            net, os.path.join(tmp, d), checkpoint_frequency=2,
            async_save=True, guard=TrainingGuard(registry=MetricsRegistry()),
            registry=MetricsRegistry(), **kw)

    def net(seed=None):
        n = MultiLayerNetwork(d5_narrow_lenet(), device=dev)
        return n.init(seed)

    plain = net()
    inj = pf.FaultInjector(nan_at=[3])
    t0 = time.perf_counter()
    tr = trainer(plain, "plain", fault_injector=inj)
    done = tr.fit(BaseDatasetIterator(fx, fy, 32))
    wall = time.perf_counter() - t0
    skipped = (inj.nans_injected == 1
               and tr.guard._m_events.labels("skip").value == 1)
    # preempted at 4, resumed by a fresh network over the batches left
    pre = net()
    ph = pf.PreemptionHandler(registry=MetricsRegistry())
    tr_p = trainer(pre, "pre", preemption=ph,
                   fault_injector=pf.FaultInjector(nan_at=[3],
                                                   preempt_at=[4]))
    stopped = tr_p.fit(BaseDatasetIterator(fx, fy, 32)) is False
    pre_latest = tr_p.manager.latest_step()
    resumed = net(seed=99)
    trainer(resumed, "pre").fit(BaseDatasetIterator(fx[128:], fy[128:],
                                                    32))
    # a crash while writing step 4 (surfaces at the next save), then a
    # fresh trainer: the orphan swept, step 2 restored
    crash = net()
    tr_c = trainer(crash, "crash", fault_injector=pf.FaultInjector(
        nan_at=[3], crash_write_at=[4]))
    try:
        tr_c.fit(BaseDatasetIterator(fx, fy, 32))
        crashed = False
    except RuntimeError:
        crashed = True
    orphan = os.path.isdir(os.path.join(tmp, "crash", "step_4.tmp"))
    crash_latest = tr_c.manager.latest_step()
    after = net(seed=98)
    tr_r = trainer(after, "crash",
                   fault_injector=pf.FaultInjector(nan_at=[3]))
    swept = not os.path.isdir(os.path.join(tmp, "crash", "step_4.tmp"))
    tr_r.fit(BaseDatasetIterator(fx[64:], fy[64:], 32))
    same_pre = all(e5_tree_equal(torch, getattr(resumed, a),
                                 getattr(plain, a))
                   for a in ("params", "state", "updater_state"))
    same_crash = all(e5_tree_equal(torch, getattr(after, a),
                                   getattr(plain, a))
                     for a in ("params", "state", "updater_state"))
    e5_line(part="e", run="fault_tolerant_trainer_lenet_async",
            completed=done, wall_s=wall, nan_batch_skipped=skipped,
            iterations=plain.iteration_count, steps=tr.manager.all_steps(),
            preempted_stop=stopped, preempt_checkpoint=pre_latest,
            resumed_bit_equal=same_pre, crashed=crashed,
            orphan_left=orphan, crash_latest_verified=crash_latest,
            orphan_swept=swept, crash_resume_bit_equal=same_crash)
    if not (done and skipped and plain.iteration_count == 6):
        fail(f"5e trainer: completed {done}, NaN skipped {skipped}, "
             f"{plain.iteration_count} iterations")
    if not (stopped and pre_latest == 4 and same_pre):
        fail(f"5e preemption: stopped {stopped} at {pre_latest}, resumed "
             f"bit-equal {same_pre}")
    if not (crashed and orphan and crash_latest == 2 and swept
            and same_crash):
        fail(f"5e crash mid-write: crashed {crashed}, orphan {orphan}, "
             f"latest {crash_latest}, swept {swept}, resume bit-equal "
             f"{same_crash}")


def e5_tools(torch, dev):
    """(e) The tools on the card, in float32 with TF32 off and cuDNN's
    deterministic algorithms (set here, for this part): the
    FaultTolerantTrainer schedule, a StepWatchdog over a step that sleeps
    past its deadline, the graph serializer's round trip and
    EarlyStoppingGraphTrainer."""
    import tempfile
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.failure import StepWatchdog
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            e5_fault_tolerance(torch, dev, tmp)
            # the watchdog flags a step that sleeps past its deadline
            reg = MetricsRegistry()
            wd = StepWatchdog(0.05, registry=reg).start()
            try:
                wd.arm(1)
                torch.ones(8, device=dev).sum().item()
                time.sleep(0.25)
                wd.disarm()
                wd.arm(2)
                wd.disarm()
            finally:
                wd.stop()
            e5_line(part="e", run="step_watchdog",
                    hung_iterations=wd.hung_iterations,
                    hung_total=reg.get("watchdog_hung_steps_total").value)
            if wd.hung_iterations != [1]:
                fail(f"5e watchdog flagged {wd.hung_iterations}")
            # the graph serializer's round trip
            rng = np.random.default_rng(3)
            x = rng.random((16, 16, 16, 3), dtype=np.float32)
            y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
            g = ComputationGraph(e5_residual(), device=dev).init()
            g.fit(x, y)
            path = os.path.join(tmp, "graph.zip")
            ms.write_model(g, path)
            back = ms.restore_computation_graph(path, device=dev)
            eq = all(e5_tree_equal(torch, getattr(back, a), getattr(g, a))
                     for a in ("params", "state", "updater_state"))
            out_eq = torch.equal(back.output(x)[0], g.output(x)[0])
            e5_line(part="e", run="graph_serializer_round_trip",
                    model_type=ms.model_type_of(path), trees_bit_equal=eq,
                    output_bit_equal=out_eq, bytes=os.path.getsize(path))
            if not (eq and out_eq):
                fail("5e graph serializer round trip is not bit-equal")
            # early stopping over the graph: the best model restored
            probe = torch.from_numpy(x).to(dev)
            saved = {}

            class Saver(es.LocalFileModelSaver):
                def save_best_model(self, n, score):
                    saved["out"] = n.output(probe)[0].clone()
                    super().save_best_model(n, score)

            g = ComputationGraph(e5_residual(), device=dev).init()
            xs = rng.random((64, 16, 16, 3), dtype=np.float32)
            ys = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
            cfg = es.EarlyStoppingConfiguration(
                epoch_termination_conditions=[
                    es.MaxEpochsTerminationCondition(4)],
                score_calculator=es.DataSetLossCalculator(
                    BaseDatasetIterator(xs[:32], ys[:32], 16)),
                model_saver=Saver(os.path.join(tmp, "es")))
            res = es.EarlyStoppingGraphTrainer(
                cfg, g, BaseDatasetIterator(xs, ys, 16)).fit()
            best_eq = (isinstance(res.best_model, ComputationGraph)
                       and torch.equal(res.best_model.output(probe)[0],
                                       saved["out"]))
            e5_line(part="e", run="early_stopping_graph",
                    reason=res.termination_reason,
                    best_epoch=res.best_model_epoch,
                    total_epochs=res.total_epochs,
                    scores=res.score_vs_epoch, best_output_bit_equal=best_eq)
            if not best_eq or res.total_epochs != 4:
                fail(f"5e graph early stopping: best output equal "
                     f"{best_eq}, {res.total_epochs} epochs")
    finally:
        (cudnn.deterministic, cudnn.benchmark,
         torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32) = prev


def phase_dag_runtime(torch, dev):
    """5e. The DAG runtime and the training tools: (a) f32 card vs CPU,
    (b) ResNet-50 at 224 x 224 with a transfer-learning build, (c) the
    char-RNN's GravesLSTM graph at full width, (d) attention vertices,
    (e) the tools. Returns the main-path kernels' launches (lstm_scan
    from (c), flash forward / backward from (d))."""
    t0 = time.perf_counter()
    e5_f32_card_vs_cpu(torch, dev)
    t_a = time.perf_counter() - t0
    e5_resnet50(torch, dev)
    t_b = time.perf_counter() - t0 - t_a
    launches = e5_lstm_graph_full_width(torch, dev)
    launches.update(e5_attention(torch, dev))
    t_cd = time.perf_counter() - t0 - t_a - t_b
    e5_tools(torch, dev)
    e5_line(run="phase_5e", wall_s=time.perf_counter() - t0,
            part_s={"a": t_a, "b": t_b, "c+d": t_cd,
                    "e": time.perf_counter() - t0 - t_a - t_b - t_cd},
            launches=launches)
    return launches


# ---------------------------------------------------------------------------
# phase 5f: Keras import on the port's HDF5 reader, the gateway server
# ---------------------------------------------------------------------------

F5_FIXTURES = os.path.join(ROOT, "tests", "fixtures")
F5_RESNET50_JSON = os.path.join(F5_FIXTURES, "torch_keras_resnet50_224.json")
F5_REL = 1e-5          # card vs CPU, relative to the largest output
F5_RESNET_REL = 1e-4   # the full-width ResNet-50, card vs CPU
# fixture -> (entry point, input feed, rtol, atol against the Keras
# golden): the JAX package's tests' tolerances
F5_CASES = {
    "real_mlp": ("import_keras_sequential_model_and_weights", "x",
                 1e-4, 1e-5),
    "real_cnn": ("import_keras_sequential_model_and_weights", "x",
                 1e-4, 1e-5),
    "real_cnn_chfirst": ("import_keras_model_auto", "nhwc", 1e-4, 1e-5),
    "real_lstm": ("import_keras_sequential_model_and_weights", "x",
                  1e-4, 1e-4),
    "real_functional": ("import_keras_model_and_weights", "two", 1e-4, 1e-5),
    "real_keras1_th": ("import_keras_model_auto", "nhwc", 1e-4, 1e-5),
    "real_resnet_residual": ("import_keras_model_and_weights", "img",
                             1e-4, 1e-5),
    "real_vgg16_trained": ("load_vgg16", "x", 1e-3, 1e-4),
}


def f5_line(**rec):
    line(dict(phase="5f", card=CARD, **rec))


def f5_host(out):
    """A network's output (a tensor, or a list with one per output) as a
    host float32 array of the first output."""
    if isinstance(out, list):
        out = out[0]
    return out.detach().float().cpu().numpy()


def f5_feed(g, kind):
    if kind == "nhwc":      # channels_first fixtures: NHWC-native import
        return np.transpose(g["x"], (0, 2, 3, 1))
    if kind == "two":
        return {"in_a": g["xa"], "in_b": g["xb"]}
    if kind == "img":
        return {"img": g["x"]}
    return g["x"]


def f5_import(entry, h5, device):
    from deeplearning4j_tpu_torch import modelimport
    return getattr(modelimport, entry)(h5, device=device)


def f5_rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def f5_fixtures(torch, dev):
    """(a) The eight tf_keras fixtures through the port's entry points on
    the card: each output against its Keras golden at the JAX tests'
    tolerances and against the port on the CPU within F5_REL; real_lstm
    with lstm_wavefront off launches lstm_scan exactly twice a call (two
    LSTM layers). Returns the lstm_scan launches."""
    import importlib.util
    from deeplearning4j_tpu_torch.ops import lstm as tl
    f5_line(part="a", h5py_on_this_machine=(
        importlib.util.find_spec("h5py") is not None),
        tf_keras_on_this_machine=(
            importlib.util.find_spec("tf_keras") is not None),
        note="recorded only; the port reads HDF5 itself")
    launches = 0
    for name, (entry, feed, rtol, atol) in F5_CASES.items():
        h5 = os.path.join(F5_FIXTURES, f"{name}.h5")
        g = dict(np.load(os.path.join(F5_FIXTURES, f"{name}_golden.npz")))
        t0 = time.perf_counter()
        card = f5_import(entry, h5, dev)
        import_s = time.perf_counter() - t0
        cpu = f5_import(entry, h5, "cpu")
        if card.device.type != "cuda":
            fail(f"5f {name}: imported onto {card.device}")
        x = f5_feed(g, feed)
        got = f5_host(card.output(x))
        want_cpu = f5_host(cpu.output(x))
        golden_err = float(np.abs(got - g["y"]).max())
        golden_ok = bool(np.allclose(got, g["y"], rtol=rtol, atol=atol))
        rel = f5_rel_err(got, want_cpu)
        rec = dict(fixture=name, entry=entry, model=type(card).__name__,
                   import_s=import_s, golden_max_abs_err=golden_err,
                   golden_rtol=rtol, golden_atol=atol,
                   card_vs_cpu_rel_err=rel)
        if name == "real_vgg16_trained":
            pred = got.argmax(1)
            rec["argmax_equal"] = bool((pred == g["y"].argmax(1)).all())
            rec["accuracy"] = float((pred == g["labels"]).mean())
            golden_ok = golden_ok and rec["argmax_equal"] and \
                rec["accuracy"] >= 0.8
        if name == "real_lstm":
            card.lstm_wavefront = False
            counts, outs = [], []
            for _ in range(2):
                n0 = tl.lstm_scan_cuda.launches
                outs.append(f5_host(card.output(x)))
                torch.cuda.synchronize()
                counts.append(tl.lstm_scan_cuda.launches - n0)
            launches += sum(counts)
            off = outs[0]
            if not np.array_equal(outs[0], outs[1]):
                fail("5f real_lstm: two kernel-path outputs differ")
            rec.update(lstm_scan_launches_per_call=counts,
                       wavefront_off_golden_max_abs_err=float(
                           np.abs(off - g["y"]).max()),
                       wavefront_off_vs_cpu_rel_err=f5_rel_err(off,
                                                               want_cpu))
            if counts != [2, 2]:
                fail(f"5f real_lstm: lstm_scan launches {counts} per "
                     "output call, want 2 (two LSTM layers)")
            if not np.allclose(off, g["y"], rtol=rtol, atol=atol) or \
                    rec["wavefront_off_vs_cpu_rel_err"] > F5_REL:
                fail(f"5f real_lstm through lstm_scan: {rec}")
        f5_line(part="a", **rec)
        if not golden_ok:
            fail(f"5f {name}: card output vs the Keras golden: {rec}")
        if rel > F5_REL:
            fail(f"5f {name}: card vs CPU relative error {rel}")
        del card, cpu
    return launches


def f5_server(torch, dev, tmp):
    """(b) A KerasServer on the card: /health, /predict on real_cnn.h5
    and real_lstm.h5 equal to the imported network's direct output, and a
    2-epoch /fit on real_mlp.h5 whose scores equal the CPU port's entry
    point's within 1e-5."""
    import urllib.request
    from deeplearning4j_tpu_torch.keras_server import (
        DeepLearning4jEntryPoint, KerasServer)

    def post(srv, path, payload):
        req = urllib.request.Request(
            srv.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    paths = {}
    for name in ("real_cnn", "real_lstm"):
        x = np.load(os.path.join(F5_FIXTURES, f"{name}_golden.npz"))["x"]
        paths[name] = os.path.join(tmp, f"{name}.npz")
        np.savez(paths[name], features=x)
    rng = np.random.default_rng(5)
    mx = rng.normal(size=(64, 8)).astype(np.float32)
    my = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 64)]
    paths["real_mlp"] = os.path.join(tmp, "real_mlp.npz")
    np.savez(paths["real_mlp"], features=mx, labels=my)
    srv = KerasServer(port=0, device=dev)
    try:
        t0 = time.perf_counter()
        with urllib.request.urlopen(srv.url + "/health", timeout=30) as r:
            health = json.loads(r.read())
        if health != {"ok": True}:
            fail(f"5f server /health: {health}")
        rec = {}
        for name in ("real_cnn", "real_lstm"):
            h5 = os.path.join(F5_FIXTURES, f"{name}.h5")
            res = post(srv, "/predict", {"model_path": h5,
                                         "data_path": paths[name]})
            got = np.load(res["output_path"])
            direct = f5_host(f5_import("import_keras_model_auto", h5,
                                       dev).output(np.load(
                                           paths[name])["features"]))
            rec[name] = bool(np.array_equal(got, direct))
            if not rec[name]:
                fail(f"5f server /predict {name}: differs from the "
                     f"direct output by {np.abs(got - direct).max()}")
        mlp = os.path.join(F5_FIXTURES, "real_mlp.h5")
        res = post(srv, "/fit", {"model_path": mlp,
                                 "data_path": paths["real_mlp"],
                                 "epochs": 2, "batch_size": 16})
        want = DeepLearning4jEntryPoint(device="cpu").fit(
            mlp, paths["real_mlp"], epochs=2, batch_size=16)["scores"]
        err = float(np.abs(np.array(res["scores"]) - want).max())
        f5_line(part="b", health=health, predict_equal_direct=rec,
                fit_scores=res["scores"], cpu_fit_scores=want,
                fit_max_abs_err=err, wall_s=time.perf_counter() - t0)
        if len(res["scores"]) != 2 or err > 1e-5:
            fail(f"5f server /fit scores {res['scores']} vs CPU {want}")
    finally:
        srv.stop()


class F5KerasArrays:
    """Keras-layout weights in memory with the archive surface that
    `copy_weights_to_network` reads (`has_group`, `root`,
    `layer_weights`, `read_attribute_as_string`): ``groups`` maps a
    Keras layer name to {weight name: array}."""

    def __init__(self, groups, keras_version="2.21.0"):
        self.groups = groups
        self.keras_version = keras_version

    def has_group(self, *path):
        return path == ("model_weights",)

    @property
    def root(self):
        return {"model_weights": self.groups}

    def layer_weights(self, group):
        return group

    def read_attribute_as_string(self, name, *path):
        return self.keras_version if name == "keras_version" else None


def f5_keras_arrays(torch, conf, seed=0):
    """Seeded Keras-layout arrays for every layer with weights of a
    configuration imported from Keras JSON: Conv2D kernels HWIO and Dense
    kernels [in, out] (Glorot-uniform) with small biases, BatchNormalization gamma / beta /
    moving_mean / moving_variance (means near 0, variances in
    [0.5, 1.5], so inference BN is not the identity). Shapes come from a
    CPU graph's initialized parameters, which have Keras's layout."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (BatchNormalization,
                                                    ConvolutionLayer,
                                                    DenseLayer)
    shapes = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(seed)
    groups = {}
    for name in shapes.topo:
        v = conf.vertices[name].vertex
        p = shapes.params.get(name, {})
        if isinstance(v, BatchNormalization):
            c = tuple(p["gamma"].shape)
            groups[name] = {
                f"{name}/gamma:0": rng.uniform(0.8, 1.2, c),
                f"{name}/beta:0": rng.normal(0.0, 0.1, c),
                f"{name}/moving_mean:0": rng.normal(0.0, 0.1, c),
                f"{name}/moving_variance:0": rng.uniform(0.5, 1.5, c)}
        elif isinstance(v, (ConvolutionLayer, DenseLayer)):
            # Glorot-uniform kernels, Keras's own default initializer
            w = tuple(p["W"].shape)
            field = int(np.prod(w[:-2]))
            limit = (6.0 / (field * (w[-2] + w[-1]))) ** 0.5
            groups[name] = {
                f"{name}/kernel:0": rng.uniform(-limit, limit, w),
                f"{name}/bias:0": rng.normal(0.0, 0.01, tuple(
                    p["b"].shape))}
        else:
            continue
        groups[name] = {k: a.astype(np.float32)
                        for k, a in groups[name].items()}
    return F5KerasArrays(groups)


def f5_resnet50(torch, dev, b=128, iters=10):
    """(c) tf_keras's ResNet-50 at full width (224 x 224 x 3, 1000
    classes, f32, TF32 off) from its checked-in Keras JSON through
    import_keras_model_configuration, filled with seeded Keras-layout
    weights through convert_weights and the weight copy of the HDF5 path:
    card vs CPU at B=2 (argmax equal, outputs within F5_RESNET_REL of the
    largest), then inference at B=b timed by CUDA events (warm-up
    excluded), FlopCounterMode's FLOPs a batch, peak memory."""
    from torch.utils.flop_counter import FlopCounterMode
    from deeplearning4j_tpu_torch.modelimport.keras import (
        copy_weights_to_network, import_keras_model_configuration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.base import Layer
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("5f: TF32 is on; the f32 comparisons need it off")
    t0 = time.perf_counter()
    conf_fn = lambda: import_keras_model_configuration(  # noqa: E731
        F5_RESNET50_JSON)
    arrays = f5_keras_arrays(torch, conf_fn())
    nets = {}
    for where in ("cpu", dev):
        conf = conf_fn()
        net = ComputationGraph(conf, device=where).init()
        names = [n for n, s in conf.vertices.items()
                 if isinstance(s.vertex, Layer)]
        copy_weights_to_network(arrays, net,
                                [conf.vertices[n].vertex for n in names],
                                names)
        nets[str(where)] = net
    card, cpu = nets[str(dev)], nets["cpu"]
    build_s = time.perf_counter() - t0
    if card._preprocessors:
        fail(f"5f ResNet-50 has preprocessors {sorted(card._preprocessors)}")
    inp = card.conf.network_inputs[0]
    n_params = card.num_params()
    n_state = sum(t.numel() for st in card.state.values()
                  for t in st.values())
    rng = np.random.default_rng(1)
    x2 = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    got = f5_host(card.output({inp: x2}))
    want = f5_host(cpu.output({inp: x2}))
    rel = f5_rel_err(got, want)
    argmax_equal = bool((got.argmax(1) == want.argmax(1)).all())
    f5_line(part="c", run="resnet50_card_vs_cpu", batch=2,
            config="tf_keras ResNet50 224x224x3, 1000 classes, f32",
            vertices=len(card.conf.vertices), params=n_params,
            bn_state=n_state, keras_params=n_params + n_state,
            build_s=build_s, max_abs_err=float(np.abs(got - want).max()),
            max_output=float(np.abs(want).max()), rel_err=rel,
            argmax=got.argmax(1).tolist(), argmax_equal=argmax_equal)
    if not argmax_equal or rel > F5_RESNET_REL:
        fail(f"5f ResNet-50 card vs CPU: argmax equal {argmax_equal}, "
             f"relative error {rel}")
    del cpu, nets
    xb = torch.from_numpy(rng.normal(size=(b, 224, 224, 3)).astype(
        np.float32)).to(dev)
    feed = {inp: xb}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = card.output(feed)[0]
    ms = time_ms(lambda: card.output(feed), iters=iters, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 1e9
    counter = FlopCounterMode(display=False)
    with counter:
        card.output(feed)
    flops = float(counter.get_total_flops())
    finite = bool(torch.isfinite(out).all())
    f5_line(part="c", run="resnet50_inference", batch=b, iters=iters,
            ms_per_batch=ms, examples_per_s=b / ms * 1e3,
            flops_per_batch=flops,
            f32_peak_share=flops / (ms / 1e3) / PEAK_FLOPS["float32"],
            peak_mem_gb=peak, outputs_finite=finite,
            row_sums_max_err=float((out.sum(1) - 1).abs().max()))
    if not finite:
        fail("5f ResNet-50 inference output not finite")
    del card, xb, feed, out
    torch.cuda.empty_cache()


def phase_keras_import(torch, dev):
    """5f. Keras import on the port's HDF5 reader: (a) the eight tf_keras
    fixtures through the entry points, (b) the gateway server, (c)
    tf_keras's ResNet-50 at full width from its JSON. Returns the
    main-path kernels' launches (lstm_scan from (a))."""
    import tempfile
    t0 = time.perf_counter()
    launches = {"lstm_scan": f5_fixtures(torch, dev)}
    t_a = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        f5_server(torch, dev, tmp)
    t_b = time.perf_counter() - t0 - t_a
    f5_resnet50(torch, dev)
    f5_line(run="phase_5f", wall_s=time.perf_counter() - t0,
            part_s={"a": t_a, "b": t_b,
                    "c": time.perf_counter() - t0 - t_a - t_b},
            launches=launches)
    return launches


# ---------------------------------------------------------------------------

def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == K3_CHILD:
        return phase_3k_child(sys.argv[2], sys.argv[3])
    t_run = time.perf_counter()
    # deterministic cuBLAS GEMMs (phase 4e's workers and its in-process
    # oracle must give the same bits), set before the first GEMM
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    global CARD
    CARD = card

    import deeplearning4j_tpu_torch  # noqa: F401  (sets allow_tf32=False)
    from deeplearning4j_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    line(dict(phase=0, build_s=time.perf_counter() - t0,
              torch=torch.__version__, cuda=torch.version.cuda))
    # the six libraries' SASS read at once (one cuobjdump each)
    from concurrent.futures import ThreadPoolExecutor
    names = ("flash_fwd", "flash_bwd", "flash_bwd_packed2",
             "decode_attention", "decode_window", "lstm_scan")
    with ThreadPoolExecutor(len(names)) as pool:
        mmas = list(pool.map(_build.sass_mma_counts, names))
    for name, mma in zip(names, mmas):
        build_report(name, mma)
    install_zero_fault_gate()
    only = {"3h": phase_observability_full_width,
            "3i": phase_faults_full_width,
            "3j": phase_engine_control_full_width,
            "3k": phase_cache_handoff_full_width,
            "3l": phase_fleet_full_width,
            "5d": phase_dsl_cnn,
            "5e": phase_dag_runtime,
            "5f": phase_keras_import,
            "4d": phase_parallel_training,
            "4e": phase_elastic_training}
    if len(sys.argv) == 3 and sys.argv[1] == "--only" and \
            sys.argv[2] in only:
        # a development run of phase 3h, 3i, 3j, 3k, 3l, 4d, 4e, 5d, 5e or
        # 5f
        # alone (no kernels line, no result); a full run takes no arguments
        line(dict(phase=sys.argv[2], launches=only[sys.argv[2]](
            torch, dev), wall_s=time.perf_counter() - t_run,
            tracer_marks=TRACER_MARKS_SEEN))
        check_zero_fault_gate("end of the run")
        return 0

    # seconds from the start at each block's end (the wall line)
    marks, threads = {}, {}

    def block_end(name):
        marks[name] = time.perf_counter() - t_run
        threads[name] = sorted(t.name for t in threading.enumerate()
                               if t is not threading.main_thread())
        settle()
    block_end("build")
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
    block_end("1-2f")
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
    block_end("3-3g")
    t_obs = time.perf_counter()
    obs_launches = phase_observability_full_width(torch, dev)
    t_obs = time.perf_counter() - t_obs
    settle()
    t_fault = time.perf_counter()
    fault_launches = phase_faults_full_width(torch, dev)
    t_fault = time.perf_counter() - t_fault
    settle()
    t_ctl = time.perf_counter()
    ctl_launches = phase_engine_control_full_width(torch, dev)
    t_ctl = time.perf_counter() - t_ctl
    settle()
    t_k3 = time.perf_counter()
    k3_launches = phase_cache_handoff_full_width(torch, dev)
    t_k3 = time.perf_counter() - t_k3
    settle()
    t_l3 = time.perf_counter()
    l3_launches = phase_fleet_full_width(torch, dev)
    t_l3 = time.perf_counter() - t_l3
    for part in (spec_launches, paged_launches, pipe_launches, c_launches,
                 moe_launches, obs_launches, fault_launches, ctl_launches,
                 k3_launches, l3_launches):
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + n
    block_end("3h-3l")
    phase_train_f32_card_vs_cpu(torch, dev)
    for name, n in phase_train_full_width(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_new = time.perf_counter()
    moe_train = phase_train_full_width(torch, dev, n_experts=8)
    new_phases["4c"] = time.perf_counter() - t_new
    for name, n in moe_train.items():
        launches[name] = launches.get(name, 0) + n
    line(dict(run="moe_launches", serving=moe_launches, training=moe_train))
    t_4d = time.perf_counter()
    for name, n in phase_parallel_training(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_4d = time.perf_counter() - t_4d
    settle()
    t_4e = time.perf_counter()
    for name, n in phase_elastic_training(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_4e = time.perf_counter() - t_4e
    block_end("4a-4e")
    phase_lstm_f32_card_vs_cpu(torch, dev)
    launches.update(phase_lstm_full_width(torch, dev))
    block_end("5a-5c")
    t_5d = time.perf_counter()
    for name, n in phase_dsl_cnn(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_5d = time.perf_counter() - t_5d
    t_5e = time.perf_counter()
    for name, n in phase_dag_runtime(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_5e = time.perf_counter() - t_5e
    t_5f = time.perf_counter()
    for name, n in phase_keras_import(torch, dev).items():
        launches[name] = launches.get(name, 0) + n
    t_5f = time.perf_counter() - t_5f
    block_end("5d-5f")
    launches.update(phase_experiments(torch, dev))
    block_end("6")

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
    line(dict(run="tracer_marks", sessions=len(TRACER_MARKS_SEEN),
              marks_each=TRACER_MARKS,
              sessions_short=sum(1 for n in TRACER_MARKS_SEEN
                                 if n < TRACER_MARKS),
              traced=TRACER_MARKS_SEEN))
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
    check_zero_fault_gate("end of the run")
    wall = time.perf_counter() - t_run
    line(dict(run="wall", wall_s=wall, moe_phases_s=new_phases,
              without_moe_phases_s=wall - sum(new_phases.values()),
              observability_phase_s=t_obs, fault_phase_s=t_fault,
              engine_control_phase_s=t_ctl, cache_handoff_phase_s=t_k3,
              fleet_phase_s=t_l3, dsl_cnn_phase_s=t_5d,
              dag_phase_s=t_5e, keras_import_phase_s=t_5f,
              parallel_phase_s=t_4d, elastic_phase_s=t_4e,
              block_ends_s=marks, threads_at_block_ends=threads))
    print(card, flush=True)
    line({"kernels": kernels})
    line({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

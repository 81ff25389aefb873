"""Continuous-batching inference engine on one device.

Port of the continuous subset of deeplearning4j_tpu/serving/engine.py.
Callers `submit()` prompts, drive the engine with `run_pending()` (or
`tick()` by tick) on their own thread, and read `RequestHandle.result()`.

Each tick (reference `_tick_continuous`, :2550): free slots are filled
from the queue in FIFO order, the admitted prompts run through ONE
prefill over the whole slot pool (prompts right-padded to a power-of-two
bucket, `_bucket_len`), then every occupied slot advances one decode
chunk of ``decode_chunk`` tokens through the slot programs of
`parallel.serving`. Tokens commit on the host at the end of the tick
(the synchronous loop) or one tick later (the pipelined loop, below); a
slot frees as soon as its request has its ``max_new_tokens``, and the
next tick refills it. Sampling draws are keyed by sequence position, so a
request's tokens do not depend on its slot, its neighbours or the chunk
size, except in a mixture-of-experts config (``n_experts > 0``), whose
experts' capacity is shared by every token of a call, as in the
reference; an MoE config serves on every pool, and ``spec_decode``
refuses it (reference :1491).

Paged KV (``EngineConfig(paged=True, page_size=P, kv_pages=N,
prefix_cache=True)``, reference :3460-4640): slot KV lives in a shared
pool of P-token pages addressed through a host-owned block table. At
admission (`_seat_paged`) the longest chain of full prompt pages in the
radix prefix cache maps into the slot's table (refcounted, shared with
its other readers) and private pages cover the rest of the prompt and
the decode budget; prefill resumes from the hit, so a shared system
prompt is prefilled once. A full-prefix hit recomputes the last prompt
token in a copy of its page (copy-on-write), and every call that writes
first privatises any still-shared page in its write range
(`_ensure_writable`). When the free list and LRU eviction of
unreferenced cache entries cannot seat a request, admission blocks; a
request that could never be seated is shed (OverloadError). Finished
prompts' full pages enter the cache (`_cache_prefilled`).

Chunked prefill (``prefill_chunk=C``, reference :2627-2900): admission
only seats a request; each tick spends ``tick_token_budget`` (0: slots x
decode_chunk + C) on prompt chunks of at most C tokens, oldest
admission first, after reserving one decode chunk per decoding slot
(at least one chunk a tick, so prefill never starves), then every
decoding slot advances one decode chunk. A long prompt therefore
delays the residents' next chunk by at most the budget's worth of
prefill, not its whole prefill.

``eng.counts`` carries, beside the call counts, ``prefill_chunks``
(slot-chunks advanced), ``prefix_hits`` / ``prefix_misses`` (paged
admissions with / without a cached prefix), ``prefix_shared_tokens``,
``prefix_evictions``, ``cow_copies`` (pages copied on write),
``pages_used`` / ``pages_free`` (the allocator's, live) and
``shed_overload`` (requests refused because the queue was full, or shed
because the pool could never seat them).

Quantized serving (``EngineConfig(quantize="int8" | "fp8",
kv_quantize="int8" | "fp8")``, reference :458-464, :1407-1430): both
modes resolve against the engine's device ("fp8" is fp8 only on a card of
capability (8, 9) or later, "int8" elsewhere). ``quantize`` quantizes the
weight tree on load (`quant.model.quantize_params`); ``kv_quantize``
switches the slot or page pool to int8 / e4m3 rows with float32 row
scales, on the contiguous, paged and chunked programs and under
speculative decoding; the scale rows travel with their pages through
prefix hits and copy-on-write. The programs are made per mode.
``quantize=None`` leaves the engine as it was. ``counts["param_bytes"]``
and ``counts["kv_pool_bytes"]`` give the at-rest bytes of the weight tree
and of the pool (the ``serving_param_bytes`` / ``serving_kv_pool_bytes``
gauges: the pool measured once allocated, analytic before). A hot reload
(`reload_weights`) restores the float checkpoint against the float
template and quantizes it again.

The pipelined tick loop (``EngineConfig.pipeline``, True by default as
in the reference, :553; reference `_tick_pipelined` :2922-3260): each tick
dispatches its calls without waiting on the device and then commits the
PREVIOUS tick's outputs behind one blocking wait, so the host schedules
tick n+1 while the card computes tick n. Each call's host-bound output
is copied on the current stream into pinned host memory without
blocking; the tick records one CUDA event after its last dispatch, and
the commit waits on it once (`_commit_tick`). The schedule runs one tick
ahead of the committed tokens: every request carries its tokens in
flight (``_pending_n``), which the budget masks (``rem``), the
scheduling and the copy-on-write write ranges count as spent; a spec
round reserves its worst case, K+1 tokens a slot, and the commit
releases what verification rejected (schedule-ahead spec, reference
:3061). Both loops run the same dispatch code (`_dispatch_tick`) and
the same commit (`_commit_tick`); they differ only in when they wait
and commit. ``pipeline=False`` is the synchronous loop: one blocking
wait per call, and the commit at the end of the tick, so nothing is in
flight when the next tick schedules. Without spec a slot frees once all
its request's tokens are dispatched (`_reap`), so the pipelined loop
makes the synchronous loop's calls, tick for tick. Sampling is keyed by
position, so the token streams are the synchronous loop's bit for bit.
Every call runs on the
device's current stream, so a dispatch reads the slot state the previous
tick's programs left there, in stream order (the programs update the
pool in place). Batch mode has no slot state to schedule ahead over, so
``pipeline=True`` there falls back to the synchronous loop (reason
``"batch"`` in ``debugz()["tick_pipeline"]`` and
``serving_pipeline_fallbacks_total``). KV export commits the pending tick
first (`_flush_pipeline`, billed to
``serving_pipeline_flush_seconds{reason}``).

On a CUDA device the per-tick slot programs (decode chunk, paged decode
chunk, spec round, paged spec round) replay as CUDA graphs, one per
(program, size) key (`serving.graphs`), in both loops; prefill stays
eager (its programs size their writes from the data). ``counts`` gains
``syncs`` (blocking device waits), ``pipelined_ticks``,
``graph_captures``, ``graph_replays``, ``graph_pool_bytes``,
``spec_committed`` (tokens spec rounds committed), ``spec_reserved`` and
``spec_released`` (the tokens the rounds reserved at dispatch, and
released at their commits). ``seconds`` holds each
call kind's host seconds (``prefill``, ``decode``, ``spec``): in the
synchronous loop a call's dispatch and wait, in the pipelined loop its
dispatch only; ``wait`` holds the seconds blocked on the device (the
calls' waits, or the commits').

Fault tolerance (``InferenceEngine(fault_injector=..., clock=...)``,
``EngineConfig.max_retries`` / ``backoff_*`` / ``breaker_*``, reference
:4967-5255): every program call (one-shot, chunked and paged prefill,
decode chunk, spec round, their masked twins, and on the card the graph
replays) goes through one guard, `_guarded`: the injector's hook with the
ids of every co-resident request, the call, its latency histogram, and on
a RuntimeError retries with exponential backoff (``retry`` trace events)
and the circuit breaker's accounting (consecutive failures open it;
`submit` then raises OverloadError until a cooldown on ``clock`` makes it
half-open, and any completed call closes it). The injector's step index
counts completed calls, so a failed attempt retries the same index. The
reference retries on its immutable state; the port's pool is updated in
place, so before each guarded call the per-slot ``pos`` and ``tok`` (and
a constrained engine's DFA states) are copied into standing buffers and
copied back before a retry (`_snapshot`, ``fault_snapshot_bytes``; the
KV rows a retry rewrites get the same values). After the retries every
implicated request is preempted: evicted, and re-run alone from its
committed prefix on a scratch contiguous pool of the live pool's slot
count and KV mode (`_isolate_slots`, even for a paged engine, as in the
reference; allocated for the isolation and dropped after, run eagerly,
since graphs hold the live pool; a constrained re-run gets a scratch DFA
vector). A survivor completes; a request that fails alone too is
QUARANTINED with RequestQuarantined. A pipelined tick whose wait fails
(`_recover_failed_tick`) drops every later pending dispatch, restores the
DFA states and seeds as they were before the tick's dispatch, flushes the
prefix cache and isolates every request of the dropped ticks; the kept
slots' state was never touched by those calls (every program updates
only its active slots), so no KV is copied. The injector's device hooks
are ported too: ``corrupt_page_at`` (`_poison_page`) and
``draft_poison_at`` (the spec round's ``poison`` input; a poisoned round
drops K to 1). Lifecycle (reference :2264-2375): ``submit(deadline_s=,
on_deadline="shed" | "partial")`` with the expiry checked at admission
and at each commit boundary on ``clock``, `cancel`, `start` / `stop` (the
background worker with the ``batch_timeout_s`` coalescing window),
`drain` / `resume` (`ready` false from the moment of `drain`), and the
typed EngineStopped / EngineDraining / DeadlineExceeded /
RequestCancelled / RequestQuarantined errors. A CUDA error that poisons
the context cannot be retried in-process; the injector raises on the host
before the launch, as the reference's does.

Batch mode (``EngineConfig(mode="batch")``, reference :2392-2478,
:5142-5216): each tick pops the head request and every queued request of
the same prompt length, up to ``max_batch_size`` (`_form_batch`), and runs
the batch to completion on the weights taken at its start
(`_process_batch`): every call is one `parallel.serving.
make_parallel_generate` over the whole batch that re-prefills prompt +
generated (the flash forward) and decodes ``decode_chunk`` tokens (0: the
whole budget in one call) through the decode kernel, keyed by
`parallel.serving.batch_key` (seed, prompt length), so a retry or a solo
continuation of the same prefix draws the same tokens. Calls go through
the guard; a batch whose retries run out re-runs each request alone
(`_isolate`, `_decode_solo`) and quarantines what fails alone. Batch mode
has no slot pool: ``prefill_chunk``, ``tick_token_budget``,
``preemption_budget``, ``paged`` and ``spec_decode`` refuse it with the
reference's ValueErrors, and a constrained submit is rejected with a
ConstraintError of reason ``"mode"``. ``set_listeners`` attaches
observers of the training listeners' protocol: after every batch (batch
mode) or tick (continuous) the engine calls ``record_batch(size)``
(where present) and ``iteration_done(engine, index, latency_s)``; a
listener that raises is logged and serving goes on. Every engine keeps
``serving_batches``, ``serving_batch_size`` and
``serving_batch_latency_seconds``.

Tenant QoS (reference :1298-1340, :2666-2800, :3397-3458, :5393):
``tenant_weights`` (with ``prefill_chunk``; absent tenants weigh
``qos_default_weight``) divides each tick's prefill budget among the
backlogged tenants by weight through deficit counters (an idle tenant's
share rolls over, a shortchanged one carries credit), on the chunked and
the paged chunked pool; ``submit(priority=0..MAX_PRIORITY)`` with
``preemption_budget`` > 0 seats the highest class first and lets a
waiter evict the lowest-priority resident of a strictly lower class, at
most ``preemption_budget`` evictions a tick; the evicted request
requeues at the head with its committed tokens and re-prefills.
`qos_control(spec_off=, decode_chunk=)` suspends speculative rounds and
shrinks the decode chunk (a new program key, so its own CUDA graph).
``serving_qos_prefill_tokens{tenant}`` and ``serving_qos_preemptions
{tenant}`` exist only where their knob is on; with QoS off the engine
schedules, and makes program keys, as it did without it.

Hot reload (`reload_weights(source, step=None)`, reference :5523): the
newest step that verifies (or ``step``) of a `util.checkpointing.
CheckpointManager` or directory is restored against the float template,
quantized again on a quantized engine, then, at a tick boundary and under
the lock, swapped in: every in-flight request is evicted and requeued at
the head with its committed tokens only (a pipelined tick's tokens in
flight are never committed into it: each request carries an eviction
epoch that a pending record checks), the prefix cache is flushed and the
drafter rebuilt. CUDA graphs hold their weight trees by identity, so a
reload drops them (after one wait for the device) and each key captures
again on the new tree at its next call. ``health()["weights_step"]``,
``stats["reloads"]`` and ``serving_weight_reloads_total`` report it.

The program cache and warm-up (reference :741-835, :4126-4397): every
engine takes its programs from one process-wide LRU (`_ProgramLRU`,
``EngineConfig.program_cache_size``, `set_program_cache_size`) keyed by
kind, size and geometry; an engine's first use of a key resolves it
(`_resolve`: on the card the CUDA libraries it launches are made ready,
from the build directory, the compile cache or nvcc), counted in
``serving_compiles{program,source}`` and timed through its first call in
``serving_compile_seconds{program}``. ``source="jit"``: resolved in this
process; ``"aot_cache"``: its manifest and every library it names came
from ``compile_cache_dir`` (`serving.compile_cache`). Only the libraries
save time: the manifest carries the reference's label and no work, and
on the CPU, where a program launches no library, ``"aot_cache"`` means
only that the manifest was present. An eviction drops
the key and its CUDA graph (``serving_program_cache_evictions``), so it
resolves and captures again at its next call. `warmup()` (or
``warmup_on_init=True``) resolves and calls the closed program set with
every slot inactive before traffic; `last_warmup` reports it.

KV handoff (reference :368, :1992-2096, :3541-3911): ``submit(hold_kv=
True)`` keeps a finished request's slot seated; `export_slot_kv` gathers
its committed rows (and scales) to the host as a `KVHandoff`;
``submit(kv=handoff)`` on a paged engine seats a request by adopting
them into fresh pages (no prefill), shedding it typed ``handoff`` when
misaligned or faulted; `export_cached_chain` / `seed_cached_chain` move
prefix-cache chains. ``serving_kv_adoptions{outcome}`` counts adoptions.
`serving.kvwire` carries handoffs between processes: the fleet router's
subprocess workers (`serving.fleet`, `serving.fleet_worker`) and the
disaggregated prefill/decode tiers (`serving.disagg`) drive these calls.

Grammar-constrained decoding (``submit(..., constrain=regex or spec
dict)``, reference :1841-1935, :2030-2180): `submit` compiles the
grammar (`serving.constrain`) outside the lock and reserves its rows in
the engine's ``[constrain_state_cap, V]`` table; every failure is a
typed ConstraintError raised there, never mid-decode. The first
constrained submit switches the engine to the masked programs, which
have keys of their own (``"decode_c"``, ...), so an engine that never
sees a constraint makes the programs and graphs it made before; from
then on every slot rides the masked programs, an unconstrained one on
the all-allow row 0. Each (re)seat seeds the slot's DFA state, replayed
on the host from the committed prefix (`_c_state_for`); the device
chains the state call to call in place (``cstate``, a fixed argument of
the graphs beside the table, whose tensors `ConstraintTable.device`
rewrites in place when the grammar set changes). The host walk at the
commit decides (`_c_advance_commit`): it truncates at a terminal state
and completes the request there; tokens the device made past it are
never committed. A finished request releases its table rows.
``counts`` gains ``constrained_requests``,
``constrained_rejected_<reason>``, ``constrained_grammar_compiles``,
``constrained_terminal``, ``constrained_illegal`` (committed tokens the
host walk refused: 0 unless the mask failed) and
``constrained_table_rows`` (the ``serving_constrained_*`` series,
registered at the first constrained submit). In the pipelined loop a grammar's
terminal is known only at the commit, a tick after its synchronous
loop knows it, so the slot is refilled a tick later: tokens agree with
the synchronous loop wherever that does not change a half-precision
call (see the loop's paragraph above).

Speculative decoding (``EngineConfig(spec_decode=True, spec_k=K,
draft="int8" | "fp8" | "self" | "layers:N")``, reference :4711-4944; the
default "int8" drafter is the int8-quantized weight tree, or the live
tree itself when the engine's weights are already quantized): a tick's
decode
phase runs one speculative round instead of a decode chunk, committing
1..K+1 tokens per slot, token-identical to the plain engine. The
adaptive-K controller walks K over {spec_k, spec_k/2, .., 1} on the
pool's acceptance and falls back to plain decode chunks for a cooldown
when even K=1 does not pay. ``counts["spec_rounds"/"spec_drafted"/
"spec_accepted"]`` and `spec_k_current` expose it, and
``counts["spec_draft_steps"]`` sums the K of every round.

Observability (reference :1525-1560, :1570, observability/): every
engine publishes into a `MetricsRegistry` (``registry``, a private one
by default), records each request's lifecycle in a `FlightRecorder`
(``recorder``; `RequestHandle.trace`), derives TTFT / TPOT / e2e /
queue age and goodput in an `SLOTracker` (``slo``) and costs every
program call in an `EngineProfiler` (``profiler``: per-program FLOPs,
bytes and device seconds, live ``serving_mfu``, rooflines, per-tenant
bills under ``submit(tenant=...)``). ``registry=NULL_REGISTRY`` makes
all four no-ops, as in the reference; the tokens and the calls do not
change. Metric names, label names, event kinds and report shapes are
the reference's. ``eng.counts`` and ``eng.seconds`` are read-through
views of the registry under the keys they always had: the series of
the reference where one exists (``prefix_hits`` is
``serving_prefix_cache_hits_total``, ``prefill_calls`` the count of
``serving_prefill_seconds``, ``spec_released`` the pipelined loop's
``serving_spec_schedule_waste_tokens_total``), else a series of the
port's own (`_PORT_SERIES`); with ``NULL_REGISTRY`` they read 0. No
series reads a device tensor: every value is host data the engine holds
at dispatch or at the commit's one wait, and nothing is recorded inside
a captured graph. The busy estimate behind
``serving_device_idle_fraction`` marks the device busy from a dispatch
to the wait that drains it (`_wait`). Read-outs: `stats`, `health`,
`ready`, `debugz`, `slo_report`, `profile_report`, `profilez` (with
``EngineConfig.profile_dir``) and `timeline`, for
`observability.MetricsServer`.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
import weakref
from collections import OrderedDict, deque, namedtuple
from collections.abc import Mapping
from dataclasses import astuple, dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.observability.events import (NULL_RECORDER,
                                                           NULL_TRACE,
                                                           FlightRecorder)
from deeplearning4j_tpu_torch.observability.metrics import (
    DECODE_LATENCY_BUCKETS, MetricsRegistry, NullRegistry)
from deeplearning4j_tpu_torch.observability.profiling import (
    NULL_PROFILER, EngineProfiler, ProfileCapture, program_cost, tree_bytes)
from deeplearning4j_tpu_torch.observability.slo import NULL_SLO, SLOTracker
from deeplearning4j_tpu_torch.observability.timeline import timeline_json
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         _check_slice,
                                                         params_to)
from deeplearning4j_tpu_torch.parallel.serving import (
    batch_key, init_paged_state, init_slot_state, make_chain_adopt,
    make_chunked_prefill, make_continuous_decode, make_continuous_prefill,
    make_kv_adopt, make_page_gather, make_paged_chunked_prefill,
    make_paged_decode, make_paged_prefill, make_paged_speculative_decode,
    make_parallel_generate, make_slot_gather, make_speculative_decode)
from deeplearning4j_tpu_torch.quant.core import raw, resolve_mode
from deeplearning4j_tpu_torch.quant.kv import (handoff_page_bucket,
                                               handoff_row_buffers,
                                               paged_pool_bytes,
                                               slot_pool_bytes)
from deeplearning4j_tpu_torch.quant.model import (draft_tree, param_bytes,
                                                  quantize_params)
from deeplearning4j_tpu_torch.serving.constrain import (ConstraintError,
                                                        ConstraintTable,
                                                        compile_grammar,
                                                        normalize_constraint)
from deeplearning4j_tpu_torch.serving.compile_cache import CompileCache
from deeplearning4j_tpu_torch.serving.graphs import SlotGraphs
from deeplearning4j_tpu_torch.serving.paging import (PageAllocator,
                                                     RadixPrefixCache,
                                                     pages_for)
from deeplearning4j_tpu_torch.util.checkpointing import CheckpointManager


log = logging.getLogger("deeplearning4j_tpu_torch")

_perf = time.perf_counter


_BREAKER_STATE = {"closed": 0.0, "half-open": 1.0, "open": 2.0}


class OverloadError(RuntimeError):
    """Admission rejected: queue full or circuit breaker open."""


class EngineStopped(RuntimeError):
    """Admission rejected: the engine has been stopped. `submit()` raises
    it at once: a request queued after `stop()` would never be served."""


class EngineDraining(RuntimeError):
    """Admission rejected: the engine is draining. `drain()` closes
    admissions the moment it is called (readiness flips at the same
    instant) while resident requests finish; `resume()` reopens them."""


class DeadlineExceeded(RuntimeError):
    """Request shed because its deadline passed before completion."""


class RequestCancelled(RuntimeError):
    """Request cancelled by the caller via `engine.cancel()`."""


class RequestQuarantined(RuntimeError):
    """Request failed persistently (solo, after max retries) and was
    quarantined so it cannot poison further calls."""


class _BatchDecodeFailed(RuntimeError):
    """A program call exhausted its retries (carries the last error);
    triggers slot isolation."""


class HandoffError(RuntimeError):
    """KV handoff failed (reference :305): exporting a held slot's
    committed KV, or adopting a handed-off page chain at seating. A
    request shed on the adoption path carries this error and the typed
    ``shed{reason="handoff"}`` trace event, and every page the adoption
    claimed is released first."""


@dataclass
class KVHandoff:
    """One request's committed KV state, portable between engines and
    processes (reference :368): the K/V rows of positions [0, pos) of
    every layer (``k``, ``v`` [L, pos, D] host tensors at the pool's
    dtype), the pending token ``tok`` (committed, its row not yet
    written: the adopter's first decode step writes it) and, for a
    quantized pool, the float32 row scales ``k_scale`` / ``v_scale``
    [L, pos, 1], which travel with their rows. Values are sliced, never
    requantized, so an adopted continuation is token-exact against an
    uninterrupted run. ``source="cache"`` carries a radix prefix-cache
    chain (full pages) instead, with its token ids (``tokens``) and the
    exporter's ``weights_step`` (a chain encodes the weights that wrote
    it). `serving.kvwire` moves it between processes."""
    pos: int
    tok: int
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    kv_mode: Optional[str] = None
    n_layers: int = 0
    d_model: int = 0
    source: str = "slot"
    tokens: Optional[np.ndarray] = None
    weights_step: Optional[int] = None

    @property
    def nbytes(self) -> int:
        return sum(int(a.numel()) * a.element_size() for a in
                   (self.k, self.v, self.k_scale, self.v_scale)
                   if a is not None)


class QoSValidationError(ValueError):
    """submit() rejected a malformed tenant or priority (reference
    :314): tenant ids flow into metric labels and the Prometheus
    exposition (the per-tenant cost counters, the QoS series), so a
    non-string / oversized / control-character id is rejected HERE,
    typed, at admission, instead of corrupting the scrape; priorities
    outside [0, MAX_PRIORITY] or not an int are rejected the same way."""


#: Priority classes are 0..MAX_PRIORITY: 0 is the default class; a
#: higher one seats first and may preempt a lower one where the engine's
#: ``preemption_budget`` allows it.
MAX_PRIORITY = 9
#: Tenant ids are metric-label material: bound their length so a
#: hostile id cannot bloat every labeled sample it lands in.
MAX_TENANT_LEN = 64


def validate_tenant(tenant):
    """The tenant half of `validate_tenant_priority`: coerce or reject
    BEFORE the id reaches the metric-label path. Returns the normalized
    tenant; raises `QoSValidationError`. An int tenant id becomes its
    decimal string; anything else that is not a str is rejected."""
    if tenant is None:
        return None
    if isinstance(tenant, int) and not isinstance(tenant, bool):
        tenant = str(tenant)
    if not isinstance(tenant, str):
        raise QoSValidationError(
            f"tenant must be a str (or int), got {type(tenant).__name__}")
    if not tenant or len(tenant) > MAX_TENANT_LEN:
        raise QoSValidationError(
            f"tenant id length must be 1..{MAX_TENANT_LEN}, got "
            f"{len(tenant)}")
    if any(ch in '"\\\n' or ord(ch) < 0x20 for ch in tenant):
        raise QoSValidationError(
            "tenant id contains control/exposition-breaking "
            "characters (newline, quote, backslash)")
    return tenant


def validate_tenant_priority(tenant, priority):
    """The reference's tenant/priority validation (:331): the tenant as
    `validate_tenant`, the priority an int (not a bool) in
    [0, MAX_PRIORITY]. Returns ``(tenant, priority)``; raises
    `QoSValidationError`."""
    tenant = validate_tenant(tenant)
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise QoSValidationError(
            f"priority must be an int, got {type(priority).__name__}")
    if not 0 <= priority <= MAX_PRIORITY:
        raise QoSValidationError(
            f"priority must be in [0, {MAX_PRIORITY}], got {priority}")
    return tenant, priority


class RequestStatus:
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    SHED = "shed"
    QUARANTINED = "quarantined"


DEFAULT_CONTINUOUS_CHUNK = 8

# the bound of the process-wide program cache (reference :420);
# EngineConfig.program_cache_size / set_program_cache_size resize it
DEFAULT_PROGRAM_CACHE_SIZE = 64

# plain-decode ticks the adaptive-K controller imposes when even K=1 does
# not pay (reference `_spec_update`)
SPEC_PLAIN_COOLDOWN = 24


@dataclass
class EngineConfig:
    """The reference's EngineConfig. Ported knobs: ``max_queue``,
    ``max_batch_size`` (slot-pool size unless ``num_slots`` overrides
    it), ``num_slots``, ``max_new_tokens`` (default AND per-request cap),
    ``decode_chunk`` (0 -> DEFAULT_CONTINUOUS_CHUNK), ``temperature``,
    ``top_k``, ``top_p``, ``seed`` (sampling counter root),
    ``prefill_bucket_min``, the queue-depth degradation
    (``degrade_queue_depth``, ``degraded_max_new_tokens``), quantization
    (``quantize``, ``kv_quantize``: "int8", "fp8" or None), speculative
    decoding (``spec_decode``, ``spec_k``, ``spec_adaptive``, ``draft`` =
    "int8", "fp8", "self" or "layers:N"), paged KV (``paged``,
    ``page_size``, ``kv_pages``: total pages with the scratch page, 0 ->
    every slot's full max_len + 1; ``prefix_cache``) and chunked prefill
    (``prefill_chunk``, ``tick_token_budget``) and the pipelined tick loop
    (``pipeline``), the grammar-constraint table bound
    (``constrain_state_cap``: rows of the [cap, V] allow / transition
    table, cap x V x 5 bytes on the device) and observability
    (``recorder_capacity``: the flight recorder's ring; ``profile_dir``:
    where ``/profilez`` writes its torch.profiler traces, None -> 503;
    ``tenant_top_n``: tenants with a label of their own before the rest
    fold into "other"), ``mode`` ("continuous" or "batch"; in batch mode
    ``max_batch_size`` caps a batch and ``decode_chunk`` 0 decodes a
    batch's budget in one call), fault handling (``max_retries``,
    ``backoff_*``, ``breaker_*``, ``batch_timeout_s``), tenant QoS
    (``tenant_weights``, ``qos_default_weight``, ``preemption_budget``)
    and the compile cache (``program_cache_size``: the bound of the
    process-wide program cache, which the last engine constructed sets;
    ``compile_cache_dir``: the persistent `serving.compile_cache.
    CompileCache` of built libraries and program manifests;
    ``warmup_on_init``: run `InferenceEngine.warmup` at construction)."""
    max_queue: int = 64
    max_batch_size: int = 8
    batch_timeout_s: float = 0.005
    max_new_tokens: int = 32
    decode_chunk: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_retries: int = 3
    backoff_base_s: float = 0.01
    backoff_max_s: float = 1.0
    breaker_failure_threshold: int = 5
    breaker_cooldown_s: float = 5.0
    degrade_queue_depth: int = 48
    degraded_max_new_tokens: int = 8
    seed: int = 0
    mode: str = "continuous"
    num_slots: int = 0
    prefill_bucket_min: int = 16
    quantize: Optional[str] = None
    kv_quantize: Optional[str] = None
    paged: bool = False
    page_size: int = 16
    kv_pages: int = 0
    prefix_cache: bool = True
    spec_decode: bool = False
    spec_k: int = 4
    draft: str = "int8"
    spec_adaptive: bool = True
    prefill_chunk: Optional[int] = None
    tick_token_budget: int = 0
    program_cache_size: int = DEFAULT_PROGRAM_CACHE_SIZE
    compile_cache_dir: Optional[str] = None
    warmup_on_init: bool = False
    pipeline: bool = True
    recorder_capacity: int = 4096
    profile_dir: Optional[str] = None
    tenant_top_n: int = 8
    tenant_weights: Optional[Dict[str, float]] = None
    qos_default_weight: float = 1.0
    preemption_budget: int = 0
    constrain_state_cap: int = 512


_CacheInfo = namedtuple("CacheInfo", ["hits", "misses", "maxsize",
                                      "currsize"])


class _ProgramLRU:
    """The process-wide program cache (reference `_ProgramLRU`, :741):
    one LRU with one bound over every engine's program keys. A key is
    the program's kind and size with the id of the engine's geometry
    (config, slots, pages, sampling, KV mode, draft depth), so engines of one
    geometry share the program; each entry also holds, weakly, the
    engines that resolved it. Over the bound, entries no live engine
    holds go first; evicting a live engine's key tells each of its
    holders (`InferenceEngine._program_evicted`): the engine drops it and,
    on the card, its CUDA graph, counts the eviction in
    ``serving_program_cache_evictions``, and resolves and captures the
    key again at its next call. `cache_info` / `cache_clear` keep
    `functools.lru_cache`'s surface. Thread-safe; a program is made
    outside the lock."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._od: "OrderedDict" = OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0

    def get(self, key, make: Callable, owner) -> Callable:
        """The program of ``key`` (made by ``make()`` on a miss), marked
        most recently used, with ``owner`` among its engines."""
        with self._lock:
            ent = self._od.get(key)
            if ent is not None:
                self._od.move_to_end(key)
                self._hits += 1
                ent[1].add(owner)
                return ent[0]
            self._misses += 1
        fn = make()
        with self._lock:
            ent = self._od.get(key)
            if ent is None:
                ent = self._od[key] = [fn, weakref.WeakSet()]
            else:
                self._od.move_to_end(key)
            ent[1].add(owner)
            evicted = self._overflow_locked()
        _notify_evicted(evicted)
        return ent[0]

    def _overflow_locked(self) -> list:
        """Entries over the bound, least recently used first: those no
        live engine holds go first and silently (a program is cheap to
        make again), then live engines' keys, which each owner is told
        of (returned)."""
        out = []
        while len(self._od) > max(1, self.maxsize):
            dead = next((k for k, (_, owners) in self._od.items()
                         if not owners), None)
            if dead is not None:
                del self._od[dead]
                continue
            key, (_, owners) = self._od.popitem(last=False)
            out.append((key, list(owners)))
        return out

    def resize(self, n: int) -> None:
        with self._lock:
            self.maxsize = int(n)
            evicted = self._overflow_locked()
        _notify_evicted(evicted)

    def cache_info(self) -> _CacheInfo:
        with self._lock:
            return _CacheInfo(self._hits, self._misses, self.maxsize,
                              len(self._od))

    def cache_clear(self) -> None:
        """Forget every entry (no eviction is counted): what a new
        process starts without."""
        with self._lock:
            self._od.clear()
            self._hits = 0
            self._misses = 0


def _notify_evicted(evicted) -> None:
    for key, owners in evicted:
        for eng in owners:
            eng._program_evicted(key)


_PROGRAMS = _ProgramLRU(DEFAULT_PROGRAM_CACHE_SIZE)

# an engine's geometry (`InferenceEngine._geometry`) -> its id in the
# program cache's keys; engines of one geometry share it
_GEOMETRY_IDS: Dict[tuple, int] = {}
_GEOMETRY_SEQ = itertools.count()


def set_program_cache_size(n: int) -> int:
    """Resize the process-wide program cache (reference :823); shrinking
    evicts the least recently used entries at once (counted)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"program_cache_size must be >= 1, got {n}")
    _PROGRAMS.resize(n)
    return n


def program_cache_info() -> _CacheInfo:
    return _PROGRAMS.cache_info()


def program_cache_clear() -> None:
    _PROGRAMS.cache_clear()


# the CUDA libraries (`ops._build` sources) each program kind launches
# on the card: what its compile-cache manifest names
_LIBRARIES = {"prefill": ("flash_fwd",),
              "decode": ("decode_attention",),
              "paged_decode": ("decode_attention",),
              "spec": ("decode_attention", "decode_window"),
              "paged_spec": ("decode_attention", "decode_window")}

# the rejection reasons of a constrained submit ("mode": batch mode)
_C_REASONS = ("unsupported", "invalid", "oversize", "empty", "mode")


# the port's own series: the counts the reference keeps no series for
# (count key -> (name, kind, the engines that register it, help)); the
# reference's own series stand for every other key of `counts`
_PORT_SERIES = {
    "decode_chunks": (
        "serving_decode_chunks", "counter", "all",
        "Decode chunk calls dispatched (speculative rounds apart)"),
    "spec_rounds": (
        "serving_spec_rounds", "counter", "spec",
        "Speculative rounds dispatched"),
    "spec_draft_steps": (
        "serving_spec_draft_steps", "counter", "spec",
        "Draft steps dispatched (the K of every speculative round)"),
    "spec_reserved": (
        "serving_spec_reserved_tokens", "counter", "spec",
        "Tokens speculative rounds reserved at dispatch (each slot's "
        "worst case, K+1 within its budget)"),
    "spec_committed": (
        "serving_spec_committed_tokens", "counter", "spec",
        "Tokens speculative rounds committed"),
    "spec_seconds": (
        "serving_spec_round_seconds", "counter", "spec",
        "Host seconds of speculative rounds (dispatch, and in the "
        "synchronous loop the wait; also in serving_decode_step_seconds)"),
    "cow_copies": (
        "serving_kv_cow_copies", "counter", "paged",
        "KV pages copied on write"),
    "syncs": (
        "serving_device_syncs", "counter", "all",
        "Blocking device waits"),
    "wait_seconds": (
        "serving_device_wait_seconds", "counter", "all",
        "Host seconds blocked on the device"),
    "pipelined_ticks": (
        "serving_pipelined_ticks", "counter", "pipeline",
        "Ticks of the pipelined loop that did work"),
    "graph_captures": (
        "serving_graph_captures", "counter", "cuda",
        "Slot programs captured as CUDA graphs"),
    "graph_replays": (
        "serving_graph_replays", "counter", "cuda",
        "CUDA graph replays of the slot programs"),
    "graph_pool_bytes": (
        "serving_graph_pool_bytes", "gauge", "cuda",
        "Device bytes the CUDA graph captures reserved for their pool"),
    "constrained_illegal": (
        "serving_constrained_illegal_tokens", "counter", "constrain",
        "Committed tokens the host's grammar walk refused (0 unless the "
        "device mask failed)"),
}


class _Readout(Mapping):
    """A read-only view of registry values under fixed keys
    (`InferenceEngine.counts` / `.seconds`)."""

    def __init__(self, getters: Dict[str, Callable[[], float]], cast):
        self._getters = getters
        self._cast = cast

    def __getitem__(self, key):
        return self._cast(self._getters[key]())

    def __iter__(self):
        return iter(self._getters)

    def __len__(self) -> int:
        return len(self._getters)

    def __repr__(self) -> str:
        return repr(dict(self))


def _value(m) -> float:
    """A counter's or gauge's value (0 where the engine registers
    none)."""
    return 0.0 if m is None else float(m.value)


def _hist(m, i: int) -> float:
    """An unlabeled histogram's sum (i=1) or count (i=2); 0 for a NULL
    one."""
    cells = m.collect()
    return float(cells[0][1].snapshot()[i]) if cells else 0.0


def _gauge(registry, name: str) -> float:
    """A registered gauge's value, 0 where it is not registered."""
    m = registry.get(name)
    return 0.0 if m is None else float(m.value)


def _meta_template(tree):
    """``tree``'s structure with every tensor leaf a storage-less
    ("meta") tensor of its shape and dtype: a float restore template."""
    if isinstance(tree, dict):
        return {k: _meta_template(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


class RequestHandle:
    """Caller-facing future for one submitted prompt."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int,
                 deadline_at: Optional[float] = None,
                 on_deadline: str = "shed"):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new
        # the deadline on the engine's clock, and what its expiry does
        # (reference :611-631): "shed" (DeadlineExceeded) or "partial"
        # (complete with the committed tokens)
        self.deadline_at = deadline_at
        self.on_deadline = on_deadline
        self.deadline_exceeded = False
        self._cancelled = False
        self.status = RequestStatus.QUEUED
        self.error: Optional[BaseException] = None
        self._generated: List[np.ndarray] = []
        self._done = threading.Event()
        # seating: admission order, the paged prefix-hit boundary, and
        # the chunked prefill's progress toward the committed prefix
        self._seat_seq = 0
        self._page_start = 0
        self._prefill_pos = 0
        self._prefill_target = 0
        # tokens dispatched but not committed (reference :641), and the
        # part of them a spec round reserved (its commit count is known
        # only at the commit); both 0 between ticks of the synchronous
        # loop
        self._pending_n = 0
        self._pending_spec = 0
        # a grammar constraint (reference :647-662): the compiled
        # grammar, its rows' base in the engine's table, the local DFA
        # state after the consumed prompt tail, and the host's state
        # after every committed token, which decides
        self._grammar = None
        self._cbase = 0
        self._cinit = 0
        self._cstate_host = 0
        # observability (reference :574-600): the tenant the request
        # bills under and its accumulated analytic bill; the engine
        # swaps in a live RequestTrace at submit, and its terminal hook
        self.tenant: Optional[str] = None
        # QoS (reference :625): the priority class; the slot it last
        # sat in, and its eviction epoch (a preemption or a reload
        # bumps it, so a pipelined tick dispatched before commits
        # nothing into the requeued request)
        self.priority = 0
        self._slot = -1
        self._epoch = 0
        self.cost_flops = 0.0
        self.cost_bytes = 0.0
        self.trace = NULL_TRACE
        self._on_terminal: Optional[Callable] = None
        self._in_flight = False
        # KV handoff (reference :632-634): keep the slot seated past
        # completion for `export_slot_kv`; the handoff to adopt at
        # seating; a failed adoption sheds with reason "handoff"
        self._hold_kv = False
        self._kv: Optional[KVHandoff] = None
        self._handoff_failed = False

    @property
    def generated(self) -> np.ndarray:
        """Tokens decoded so far (may be partial)."""
        if not self._generated:
            return np.zeros((0,), np.int32)
        return np.concatenate(self._generated)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Full sequence [T0 + generated] (generate's layout). Raises the
        terminal error of a shed or quarantined request."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt, self.generated])

    def _finish(self, status: str,
                error: Optional[BaseException] = None) -> None:
        self.status = status
        self.error = error
        # the terminal trace event and the SLO accounting run before
        # result() waiters wake, so a caller that sees done() sees a
        # complete trace (reference :737)
        cb, self._on_terminal = self._on_terminal, None
        if isinstance(cb, weakref.WeakMethod):
            cb = cb()
        if cb is not None:
            try:
                cb(self)
            except Exception:    # observability must not kill serving
                log.exception("terminal trace hook failed")
        self._done.set()


@dataclass
class _PendingTick:
    """One dispatched, uncommitted tick (reference :704): the commit
    items in dispatch order, ("prefill", entries,
    first), ("prefill_chunk", plan, first, finished), ("decode",
    entries, toks, needs) and ("spec", entries, out, reserved),
    each with its host-bound output in host memory (filled
    asynchronously), and the event recorded after the tick's last
    dispatch, which the pipelined commit's one wait blocks on (None on
    the CPU and in the synchronous loop). A constrained engine also keeps
    ``c_in_state``: the DFA states (a device copy) and the pending seeds
    as they were before the tick's first dispatch, which
    `_recover_failed_tick` restores (reference :718). ``epochs`` holds
    each request's eviction epoch at dispatch: an entry whose request was
    evicted since commits nothing. ``n_active`` is the tick's active
    count for the batch-size series (reference :711)."""
    items: list
    done: Optional[object]
    c_in_state: Optional[tuple] = None
    epochs: Dict[int, int] = None
    n_active: int = 0


class InferenceEngine:
    """Slot-pool continuous-batching engine over `parallel.serving`.

    ``params`` is a port parameter tree (`models.transformer.init_params`
    or `models.convert.params_from_numpy`); it is moved to ``device``,
    which is CUDA unless ``device="cpu"``. ``registry``, ``recorder``,
    ``slo`` and ``profiler`` are the reference's observability arguments
    (:1252-1259), with its defaults: a private registry, and the
    recorder, SLO tracker and profiler on with a live registry and NULL
    with `NULL_REGISTRY`. ``fault_injector`` (a
    `parallel.failure.ServingFaultInjector`) is called before every
    program call, and ``clock`` is what deadlines and the circuit
    breaker's cooldown read (reference :1252-1255)."""

    def __init__(self, cfg: TransformerConfig, params,
                 config: Optional[EngineConfig] = None, device=None,
                 registry=None, recorder=None, slo=None, profiler=None,
                 clock: Callable[[], float] = time.monotonic,
                 fault_injector=None):
        _check_slice(cfg)
        self.cfg = cfg
        self.config = config or EngineConfig()
        if self.config.mode not in ("continuous", "batch"):
            raise ValueError(f"mode must be 'continuous' or 'batch', "
                             f"got {self.config.mode!r}")
        self._continuous = self.config.mode == "continuous"
        self.device = resolve_device(device)
        # quantization (reference :1407-1430): both modes resolve against
        # the device; the weight tree is quantized on load, and a float
        # template (shapes and dtypes, no storage) is kept for reloads
        self._qmode = resolve_mode(self.config.quantize, self.device)
        self._kv_mode = resolve_mode(self.config.kv_quantize, self.device)
        self._params = params_to(params, self.device)
        self._float_template = None
        if self._qmode:
            self._float_template = _meta_template(self._params)
            self._params = quantize_params(self._params, mode=self._qmode)
        self._num_slots = self.config.num_slots or self.config.max_batch_size
        self._chunk = (self.config.decode_chunk
                       if self.config.decode_chunk > 0
                       else DEFAULT_CONTINUOUS_CHUNK)
        # chunked prefill and the token-budget scheduler (reference
        # :1273-1297): None keeps the one-shot admission prefill
        self._prefill_chunk = self.config.prefill_chunk
        if self._prefill_chunk is not None:
            if not self._continuous:
                raise ValueError(
                    "prefill_chunk requires mode='continuous' (batch "
                    "mode has no persistent slot state to resume a "
                    "partial prefill from)")
            self._prefill_chunk = int(self._prefill_chunk)
            if not 0 < self._prefill_chunk <= cfg.max_len:
                raise ValueError(f"prefill_chunk {self._prefill_chunk} out "
                                 f"of (0, {cfg.max_len}]")
        elif self.config.tick_token_budget:
            raise ValueError(
                "tick_token_budget without prefill_chunk has nothing to "
                "schedule: set prefill_chunk to enable the token-budget "
                "scheduler")
        self._tick_budget = (int(self.config.tick_token_budget)
                             or (self._num_slots * self._chunk
                                 + (self._prefill_chunk or 0)))
        self._seat_order = itertools.count()
        # tenant QoS (reference :1298-1344): fair share divides the
        # token-budget scheduler's prefill budget, so it needs chunked
        # prefill; preemption needs the continuous slot pool
        self._qos_weights: Optional[Dict[str, float]] = None
        if self.config.tenant_weights is not None:
            if self._prefill_chunk is None:
                raise ValueError(
                    "tenant_weights requires prefill_chunk: fair "
                    "share divides the token-budget scheduler's "
                    "prefill budget, which only exists under chunked "
                    "prefill")
            w = {}
            for t, v in self.config.tenant_weights.items():
                if not isinstance(t, str) or not t:
                    raise ValueError(
                        f"tenant_weights keys must be non-empty str, "
                        f"got {t!r}")
                v = float(v)
                if v <= 0:
                    raise ValueError(
                        f"tenant_weights[{t!r}] must be > 0, got {v}")
                w[t] = v
            self._qos_weights = w
        if float(self.config.qos_default_weight) <= 0:
            raise ValueError(
                f"qos_default_weight must be > 0, got "
                f"{self.config.qos_default_weight}")
        # per-tenant deficits (tokens of owed prefill budget), kept only
        # for backlogged tenants
        self._qos_deficit: Dict[str, float] = {}
        self._preempt_budget = int(self.config.preemption_budget)
        if self._preempt_budget < 0:
            raise ValueError(
                f"preemption_budget must be >= 0, got "
                f"{self._preempt_budget}")
        if self._preempt_budget and not self._continuous:
            raise ValueError(
                "preemption_budget requires mode='continuous' (batch "
                "mode has no resident slots to preempt)")
        # the overload controller's knobs (`qos_control`)
        self._qos_spec_off = False
        self._base_chunk = self._chunk
        self._qos_tenants_seen: set = set()
        self._listeners: list = []
        self._weights_step: Optional[int] = None
        # paged KV and the radix prefix cache (reference :1445-1471): page
        # indices are host-owned, the block table reaches every call as
        # data, so sharing, copy-on-write and recycling never change a
        # program's geometry
        self._paged = bool(self.config.paged)
        self._prefix_cache = None
        if self._paged:
            if not self._continuous:
                raise ValueError(
                    "paged KV requires mode='continuous' (batch mode "
                    "has no persistent slot state to page)")
            self._page_size = int(self.config.page_size)
            if self._page_size < 1:
                raise ValueError("page_size must be >= 1")
            self._max_pages = pages_for(cfg.max_len, self._page_size)
            self._num_pages = (int(self.config.kv_pages)
                               or self._num_slots * self._max_pages + 1)
            self._allocator = PageAllocator(self._num_pages,
                                            self._page_size)
            if self.config.prefix_cache:
                self._prefix_cache = RadixPrefixCache(self._page_size,
                                                      self._allocator)
            self._bt = np.zeros((self._num_slots, self._max_pages), np.int32)
            self._slot_pages: List[List[int]] = \
                [[] for _ in range(self._num_slots)]
        self._slots: List[Optional[RequestHandle]] = \
            [None] * self._num_slots
        self._slot_state = None
        # the (kind, size) keys this engine has resolved through the
        # process-wide program cache (`_program`), the evictions it was
        # told of and not yet applied, the resolutions whose first call
        # is still to be timed, and dropped graphs kept until the device
        # has run past them
        self._programs: Dict[Tuple[str, int], object] = {}
        self._evicted: deque = deque()
        self._resolving: Dict[Tuple[str, int], tuple] = {}
        self._graveyard: list = []
        self._geom: Optional[tuple] = None
        self._geom_id: Optional[int] = None
        set_program_cache_size(self.config.program_cache_size)
        self._aot = None
        if self.config.compile_cache_dir is not None:
            self._aot = CompileCache(self.config.compile_cache_dir,
                                     device=self.device)
        self._last_warmup: Optional[dict] = None
        self._last_flush: Optional[dict] = None
        self._lock = threading.RLock()
        # held for a whole tick: a reload swaps the weights between ticks
        self._tick_mutex = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._rids = itertools.count(1)
        # fault tolerance and the lifecycle (reference :1505-1523): the
        # breaker goes closed -> open (consecutive failures) -> half-open
        # (cooldown elapsed on ``clock``) -> closed (a completed call);
        # the step counter indexes COMPLETED calls, so a failed attempt
        # retries the same index (the injector's contract)
        self._injector = fault_injector
        self._clock = clock
        self._accepting = True
        self._draining = False
        self._stop_flag = False
        self._ticking = False
        self._thread: Optional[threading.Thread] = None
        self._breaker = "closed"
        self._opened_at = 0.0
        self._consec_failures = 0
        self._step_counter = 0
        # the per-call snapshot of the in-place per-slot state (`_snapshot`)
        # and the scratch pool of solo re-runs (`_isolate_slots`): while
        # ``_solo`` is set every call runs on the scratch pool, eagerly,
        # and waits for its output
        self._snap: Optional[tuple] = None
        self._snap_of: tuple = ()
        self._last_call_s = 0.0
        self._solo = False
        self._scratch = None
        self.scratch_pool_bytes = 0
        # the pipelined loop (reference :1345-1375): at most one tick in
        # flight; _pipe_items collects a tick's commit items while it
        # dispatches
        self._pipe = bool(self.config.pipeline)
        self._pipe_fallback: Optional[str] = None
        if self._pipe and not self._continuous:
            # the reference falls back instead of refusing (:1362)
            log.warning(
                "pipeline requires mode='continuous' (the batch path "
                "has no persistent slot state to schedule ahead "
                "over); falling back to the synchronous loop")
            self._pipe = False
            self._pipe_fallback = "batch"
        self._pending: deque = deque()
        self._pipe_items: list = []
        # grammar constraints (reference :1434-1444): the table, the
        # per-slot DFA states on the device and the seeds of the slots
        # (re)seated since the last call exist from the first
        # constrained submit on (`_ensure_constrain`)
        self._constrain_active = False
        self._ctab: Optional[ConstraintTable] = None
        self._cstate: Optional[torch.Tensor] = None
        self._cseed_pending: Dict[int, int] = {}
        self._cgrammar_keys: set = set()
        # speculative decoding (reference :1477-1504): the drafter comes
        # from the live params; acceptance drives the adaptive-K
        # controller (`_spec_update`)
        self._spec = bool(self.config.spec_decode)
        if self._spec:
            if not self._continuous:
                raise ValueError(
                    "spec_decode requires mode='continuous' (batch "
                    "mode has no persistent slot state to verify "
                    "against)")
            if cfg.n_experts > 0:
                raise ValueError(
                    "spec_decode does not support MoE configs (the "
                    "verify pass's token count changes the expert-"
                    "capacity cap — see parallel/serving.py)")
            self._spec_k = int(self.config.spec_k)
            if self._spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {self._spec_k}")
            self._rebuild_draft()
            self._spec_cur_k = self._spec_k
            self._spec_plain = 0          # plain-decode cooldown ticks
            self._accept_ema = [1.0] * self._num_slots
            self._accept_pool = 1.0       # engine-wide acceptance EMA
        # observability (reference :1525-1560): every counter lives in
        # the registry, and `counts` / `seconds` read it back; the
        # recorder, SLO tracker and profiler default on with a live
        # registry and NULL with NULL_REGISTRY
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        # the host-side busy estimate behind serving_device_idle_fraction
        # and the profiler's per-tick attribution (reference :1376-1390)
        self._busy_since: Optional[float] = None
        self._tick_busy_s = 0.0
        self._busy_total_s = 0.0
        self._last_idle = 0.0
        self._tick_perf0 = _perf()
        self._last_sync_s = 0.0
        self._tick_syncs = 0
        self._last_tick_syncs = 0
        self._last_tick_spent = 0
        self._init_metrics(self.registry)
        if recorder is None:
            recorder = (NULL_RECORDER
                        if isinstance(self.registry, NullRegistry)
                        else FlightRecorder(
                            capacity=self.config.recorder_capacity))
        self.recorder = recorder
        if slo is None:
            slo = (NULL_SLO if not recorder.enabled
                   else SLOTracker(registry=self.registry))
        self.slo = slo
        if profiler is None:
            profiler = (NULL_PROFILER
                        if isinstance(self.registry, NullRegistry)
                        else EngineProfiler(
                            self.registry,
                            tenant_top_n=self.config.tenant_top_n,
                            device=self.device))
        self.profiler = profiler
        self._capture = ProfileCapture(self.config.profile_dir)
        # program_cost's inputs: the trees' bytes, and each slot's
        # position on the device as the host's dispatches left it
        self._dev_pos = np.zeros((self._num_slots,), np.int64)
        self._call_rate = (0.0, 0.0)
        self._wbytes = self._dbytes = None
        if self.profiler.enabled:
            self._wbytes = tree_bytes(self._params, cfg)
            if self._spec:
                self._dbytes = tree_bytes(self._draft_params, cfg)
        # on the card the per-tick slot programs replay as CUDA graphs
        self._graphs = (SlotGraphs(self.device, self._m_graph_captures,
                                   self._m_graph_replays,
                                   self._m_graph_pool_bytes)
                        if self.device.type == "cuda" else None)
        if self.config.warmup_on_init and self._continuous:
            self.warmup()

    # -- metrics (reference `_init_metrics`, :1570) ------------------------
    def _init_metrics(self, r) -> None:
        """The reference's ``serving_*`` families for every path the port
        has (each registered where the reference registers it, so a
        scrape of an engine without a feature shows none of its series),
        then the port's own series for the counts the reference has no
        series for (`_PORT_SERIES`)."""
        self._m_completed = r.counter(
            "serving_requests_completed", "Requests fully decoded")
        shed = r.counter("serving_requests_shed",
                         "Requests rejected or abandoned, by reason",
                         labelnames=("reason",))
        self._m_shed = shed
        self._m_shed_overload = shed.labels("overload")
        self._m_shed_deadline = shed.labels("deadline")
        self._m_shed_cancelled = shed.labels("cancelled")
        self._m_quarantined = r.counter(
            "serving_requests_quarantined",
            "Requests that failed persistently after solo retries")
        self._m_retries = r.counter(
            "serving_decode_retries", "Decode step retry attempts")
        self._m_step_failures = r.counter(
            "serving_decode_step_failures", "Failed decode step calls")
        self._m_batches = r.counter(
            "serving_batches", "Dynamic batches processed")
        self._m_reloads = r.counter(
            "serving_weight_reloads", "Successful hot weight reloads")
        self._m_in_flight = r.gauge(
            "serving_in_flight_requests",
            "Requests currently inside the decode loop")
        r.gauge("serving_queue_depth",
                "Admitted requests waiting for a batch").set_function(
            self._weak(lambda e: float(len(e._queue))))
        r.gauge("serving_breaker_state",
                "Circuit breaker: 0=closed 1=half-open 2=open"
                ).set_function(
            self._weak(lambda e: _BREAKER_STATE.get(e._breaker, -1.0)))
        r.gauge("serving_degraded",
                "1 while admissions are token-budget-capped"
                ).set_function(
            self._weak(lambda e: float(e._degraded_locked())))
        self._m_preempted = r.counter(
            "serving_requests_preempted",
            "In-flight requests evicted from their slot (isolation or "
            "weight reload) and re-run from their committed prefix")
        r.gauge("serving_slot_occupancy",
                "Occupied continuous-batching slots").set_function(
            self._weak(lambda e: float(sum(s is not None
                                           for s in e._slots))))
        r.gauge("serving_param_bytes",
                "At-rest bytes of the serving weight tree "
                "(values + scales when quantized)").set_function(
            self._weak(lambda e: float(e.param_bytes())))
        r.gauge("serving_kv_bytes_per_slot",
                "KV-cache bytes one continuous-batching slot costs "
                "(caches + scales + slot vectors)").set_function(
            self._weak(lambda e: float(e.kv_bytes_per_slot())))
        r.gauge("serving_kv_pool_bytes",
                "Total at-rest bytes of the slot-pool KV state"
                ).set_function(
            self._weak(lambda e: float(e.kv_pool_bytes())))
        self._m_batch_size = r.histogram(
            "serving_batch_size", "Coalesced batch sizes",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        self._m_batch_seconds = r.histogram(
            "serving_batch_latency_seconds",
            "Wall time from batch formation to completion")
        self._m_step_seconds = r.histogram(
            "serving_decode_step_seconds",
            "Wall time of one compiled decode call",
            buckets=DECODE_LATENCY_BUCKETS)
        self._m_prefill_seconds = r.histogram(
            "serving_prefill_seconds",
            "Wall time of one compiled admission-prefill call",
            buckets=DECODE_LATENCY_BUCKETS)
        self._m_prefill_tokens = r.counter(
            "serving_prefill_tokens",
            "Prompt tokens prefilled by this engine (prefix-cache "
            "hits and adopted KV handoffs excluded)")
        # program resolutions by source (reference :1660-1676): "jit"
        # resolved in this process (its libraries built where missing,
        # then its first call and, on the card, its capture),
        # "aot_cache" its manifest and every library it names from the
        # compile cache; timed through the first call
        self._m_compiles = r.counter(
            "serving_compiles",
            "Compiled-program builds, by program and source (jit = "
            "resolved in-process: kernel libraries built, first call "
            "and capture; aot_cache = manifest and kernel libraries "
            "from the persistent compile cache)",
            labelnames=("program", "source"))
        self._m_compile_seconds = r.histogram(
            "serving_compile_seconds",
            "Wall time to resolve one program (its libraries, first "
            "call and capture), by program",
            labelnames=("program",), buckets=DECODE_LATENCY_BUCKETS)
        self._m_prog_evictions = r.counter(
            "serving_program_cache_evictions",
            "Process-wide program cache entries of this engine evicted "
            "(an evicted key resolves and captures again)")
        r.gauge("serving_device_idle_fraction",
                "Estimated fraction of the last scheduling round the "
                "device spent idle (1 - dispatched-work interval / "
                "tick wall time): the double-buffered tick loop's "
                "target metric").set_function(
            self._weak(lambda e: float(e._last_idle)))
        # the pipelined loop's fallback (reference :1683-1694): only
        # where one happened
        if self._pipe_fallback is not None:
            r.counter("serving_pipeline_fallbacks",
                      "Pipelined tick-loop configurations dropped to the "
                      "synchronous loop at construction, by reason",
                      labelnames=("reason",)).labels(
                self._pipe_fallback).inc()
        # forced pipeline flushes (reference :1700): a committed-view
        # consumer (KV export) drains the in-flight tick, billed by reason
        self._m_flush_seconds = None
        if self._pipe:
            self._m_flush_seconds = r.histogram(
                "serving_pipeline_flush_seconds",
                "Wall time a committed-view consumer (KV export, "
                "cache-chain migration, drain) spent draining the "
                "in-flight pipelined tick, by reason",
                labelnames=("reason",), buckets=DECODE_LATENCY_BUCKETS)
        self._m_prefix_hits = self._m_prefix_misses = None
        self._m_adoptions = None
        self._m_prefix_evictions = self._m_prefix_shared = None
        if self._paged:
            r.gauge("serving_kv_pages_free",
                    "Allocatable pages on the KV free list"
                    ).set_function(
                self._weak(lambda e: float(e._allocator.pages_free)))
            r.gauge("serving_kv_pages_used",
                    "KV pages referenced by slots or the prefix cache"
                    ).set_function(
                self._weak(lambda e: float(e._allocator.pages_used)))
            self._m_prefix_hits = r.counter(
                "serving_prefix_cache_hits",
                "Admissions whose prefix matched a cached page chain")
            self._m_prefix_misses = r.counter(
                "serving_prefix_cache_misses",
                "Admissions with no cached prefix to share")
            self._m_prefix_evictions = r.counter(
                "serving_prefix_cache_evictions",
                "Cached prefix pages reclaimed by LRU eviction")
            self._m_prefix_shared = r.counter(
                "serving_prefix_shared_tokens",
                "Prompt tokens whose prefill compute AND KV bytes "
                "were served from the radix prefix cache")
            self._m_adoptions = r.counter(
                "serving_kv_adoptions",
                "Handed-off KV chains seated into this engine's page "
                "pool, by outcome (ok / blocked / shed)",
                labelnames=("outcome",))
        self._m_spec_drafted = self._m_spec_accepted = None
        self._m_spec_waste = None
        if self._spec:
            self._m_spec_drafted = r.counter(
                "serving_spec_drafted_tokens",
                "Draft tokens proposed by speculative decode rounds")
            self._m_spec_accepted = r.counter(
                "serving_spec_accepted_tokens",
                "Draft tokens accepted by target-model verification")
            r.gauge("serving_spec_acceptance_ratio",
                    "Cumulative accepted/drafted draft-token ratio"
                    ).set_function(self._weak(lambda e: (
                        float(e._m_spec_accepted.value)
                        / max(1.0, float(e._m_spec_drafted.value)))))
            r.gauge("serving_spec_k",
                    "Adaptive draft length in use (0 while the "
                    "controller has fallen back to plain decode)"
                    ).set_function(
                self._weak(lambda e: float(e.spec_k_current)))
            if self._pipe:
                self._m_spec_waste = r.counter(
                    "serving_spec_schedule_waste_tokens",
                    "Worst-case K+1 window slots the schedule-ahead "
                    "dispatch reserved that verification then rejected "
                    "(the price of pipelining a nondeterministic commit "
                    "count)")
        self._m_prefill_chunks = None
        if self._prefill_chunk is not None:
            self._m_prefill_chunks = r.counter(
                "serving_prefill_chunks",
                "Prefill chunks advanced by the token-budget "
                "scheduler (one per slot per chunked-prefill call)")
            r.gauge("serving_tick_budget_utilization",
                    "Tokens scheduled in the last tick / "
                    "tick_token_budget (decode chunks + prefill "
                    "chunks; >1 when the progress floor overrode "
                    "the budget)").set_function(
                self._weak(lambda e: float(e._last_tick_spent)
                           / float(max(1, e._tick_budget))))
        # tenant QoS (reference :1786-1800): only where its knob is on
        self._m_qos_prefill_tokens = self._m_qos_preemptions = None
        if self._qos_weights is not None:
            self._m_qos_prefill_tokens = r.counter(
                "serving_qos_prefill_tokens",
                "Prefill tokens granted by the weighted fair-share "
                "scheduler, by tenant (folds past tenant_top_n)",
                labelnames=("tenant",))
        if self._preempt_budget > 0:
            self._m_qos_preemptions = r.counter(
                "serving_qos_preemptions",
                "Residents evicted by priority preemption, by the "
                "evicted request's tenant (token-exact resume from "
                "the committed prefix)",
                labelnames=("tenant",))
        # grammar constraints: registered at the first constrained
        # submit (`_ensure_constrain_metrics`)
        self._m_c_requests = self._m_c_rejections = None
        self._m_c_compiles = self._m_c_terminal = None
        self._m_c_illegal = None
        # the port's own series (`_PORT_SERIES`)
        m = {}
        for key, (name, kind, where, help_) in _PORT_SERIES.items():
            on = {"all": True, "spec": self._spec, "paged": self._paged,
                  "pipeline": self._pipe,
                  "cuda": self.device.type == "cuda",
                  "constrain": False}[where]
            m[key] = getattr(r, kind)(name, help_) if on else None
        self._m_port = m
        self._m_graph_captures = m["graph_captures"]
        self._m_graph_replays = m["graph_replays"]
        self._m_graph_pool_bytes = m["graph_pool_bytes"]
        self.counts = _Readout(self._count_getters(), int)
        self.seconds = _Readout(self._second_getters(), float)

    def _ensure_constrain_metrics(self) -> None:
        """Register the ``serving_constrained_*`` series at the first
        constrained submit (reference :1812), so a constraint-off
        engine's scrape has none of them."""
        if self._m_c_requests is not None:
            return
        r = self.registry
        self._m_c_requests = r.counter(
            "serving_constrained_requests",
            "Requests admitted with a grammar constraint")
        self._m_c_rejections = r.counter(
            "serving_constrained_rejections",
            "Constrained submissions rejected at submit() with a "
            "typed ConstraintError, by reason (never mid-decode)",
            labelnames=("reason",))
        self._m_c_compiles = r.counter(
            "serving_constrained_grammar_compiles",
            "Distinct compiled grammars this engine has admitted "
            "(cache hits on the same grammar hash do not count)")
        self._m_c_terminal = r.counter(
            "serving_constrained_terminal_completions",
            "Constrained requests completed early because their DFA "
            "reached a terminal accepting state")
        r.gauge("serving_constrained_states",
                "DFA states resident in the constraint mask table "
                "(bound: constrain_state_cap)").set_function(
            self._weak(lambda e: float(e._ctab.rows_used
                                       if e._ctab is not None else 0)))
        name, kind, _, help_ = _PORT_SERIES["constrained_illegal"]
        self._m_c_illegal = getattr(r, kind)(name, help_)
        self._m_port["constrained_illegal"] = self._m_c_illegal

    def _count_getters(self) -> Dict[str, Callable[[], float]]:
        """`counts`' keys -> the registry reads behind them. None holds
        the engine but through `_weak` (the series a constrained submit
        registers later), so the read-outs close no reference cycle."""
        port, reg, w = self._m_port, self.registry, self._weak

        def val(key):
            return lambda: _value(port.get(key))

        def of(m):
            return lambda: _value(m)

        def gauge(name):
            return lambda: _gauge(reg, name)

        def lazy(attr):
            return w(lambda e: _value(getattr(e, attr)))

        def rejected(reason):
            return w(lambda e: _value(e._m_c_rejections.labels(reason))
                     if e._m_c_rejections is not None else 0.0)

        prefill = self._m_prefill_seconds
        g = {"prefill_calls": lambda: _hist(prefill, 2),
             **{k: val(k) for k, (_, kind, _, _) in _PORT_SERIES.items()
                if kind == "counter" and not k.endswith("_seconds")},
             "spec_drafted": of(self._m_spec_drafted),
             "spec_accepted": of(self._m_spec_accepted),
             "spec_released": lambda: (_value(port.get("spec_reserved"))
                                       - _value(port.get(
                                           "spec_committed"))),
             "prefill_chunks": of(self._m_prefill_chunks),
             "prefix_hits": of(self._m_prefix_hits),
             "prefix_misses": of(self._m_prefix_misses),
             "prefix_shared_tokens": of(self._m_prefix_shared),
             "prefix_evictions": of(self._m_prefix_evictions),
             "pages_used": gauge("serving_kv_pages_used"),
             "pages_free": gauge("serving_kv_pages_free"),
             "shed_overload": of(self._m_shed_overload),
             "constrained_requests": lazy("_m_c_requests"),
             **{f"constrained_rejected_{r}": rejected(r)
                for r in _C_REASONS},
             "constrained_grammar_compiles": lazy("_m_c_compiles"),
             "constrained_terminal": lazy("_m_c_terminal"),
             "constrained_table_rows": gauge("serving_constrained_states"),
             "param_bytes": gauge("serving_param_bytes"),
             "kv_pool_bytes": gauge("serving_kv_pool_bytes")}
        if self.device.type == "cuda":
            g["graph_pool_bytes"] = val("graph_pool_bytes")
        else:
            for k in ("graph_captures", "graph_replays"):
                del g[k]
        return g

    def _second_getters(self) -> Dict[str, Callable[[], float]]:
        """`seconds`' keys -> the registry reads behind them: a call
        kind's host seconds are its histogram's sum (a spec round's are
        in the decode histogram, as in the reference, and apart in the
        port's own counter)."""
        port = self._m_port
        prefill, step = self._m_prefill_seconds, self._m_step_seconds
        return {"prefill": lambda: _hist(prefill, 1),
                "decode": lambda: (_hist(step, 1)
                                   - _value(port.get("spec_seconds"))),
                "spec": lambda: _value(port.get("spec_seconds")),
                "wait": lambda: _value(port.get("wait_seconds"))}

    def _weak(self, fn: Callable) -> Callable[[], float]:
        """``fn(engine)`` as a registry callback that holds the engine
        weakly, 0 once it is gone: the gauges and read-outs close no
        reference cycle through the engine, so dropping the last
        reference frees its pools and graphs at once, without the
        cyclic collector."""
        ref = weakref.ref(self)

        def read():
            eng = ref()
            return 0.0 if eng is None else fn(eng)
        return read

    def _inc(self, key: str, amount: float = 1) -> None:
        """One of the port's own series (`_PORT_SERIES`), where this
        engine registers it."""
        m = self._m_port.get(key)
        if m is not None:
            m.inc(amount)

    def _observe(self, what: str, fn, *args, **kw):
        """An observability call that must not kill serving: a failure
        is logged, and the serving path goes on (reference :693, :737).
        Never wraps a program dispatch."""
        try:
            return fn(*args, **kw)
        except Exception:
            log.exception("observability: %s failed", what)
            return None

    @property
    def num_slots(self) -> int:
        return self._num_slots

    @property
    def decode_chunk(self) -> int:
        return self._chunk

    @property
    def spec_k_current(self) -> int:
        """The draft length of the next speculative round: 0 while the
        controller has fallen back to plain decode, and for an engine
        without speculative decoding."""
        if not self._spec or self._spec_plain > 0:
            return 0
        return self._spec_cur_k

    @property
    def prefix_cache_pages(self) -> int:
        """Pages the radix prefix cache holds (0 without one)."""
        return 0 if self._prefix_cache is None else len(self._prefix_cache)

    # -- read-outs (reference :1940-1987, :5257-5522) ----------------------
    def param_bytes(self) -> int:
        """At-rest bytes of the serving weight tree (quantized trees
        count their values and scales)."""
        return param_bytes(self._params)

    def kv_pool_bytes(self) -> int:
        """At-rest bytes of the pool (paged: pages, scale planes and the
        block tables): measured once the pool is allocated, analytic
        before, so a pool can be sized before traffic arrives."""
        if self._slot_state is not None:
            meas = sum(int(a.numel()) * a.element_size()
                       for a in self._slot_state)
            if self._paged:
                meas += int(self._bt.nbytes)
            return int(meas)
        if self._paged:
            return paged_pool_bytes(
                self.cfg, self._num_slots, self._page_size, self._num_pages,
                self._max_pages, kv_mode=self._kv_mode)
        return slot_pool_bytes(self.cfg, self._num_slots,
                               kv_mode=self._kv_mode)

    def kv_bytes_per_slot(self) -> int:
        return self.kv_pool_bytes() // max(1, self._num_slots)

    @property
    def stats(self) -> dict:
        """Counter snapshot (registry-backed) plus the HBM accounting
        trio, under the reference's keys."""
        return {"param_bytes": self.param_bytes(),
                "kv_bytes_per_slot": self.kv_bytes_per_slot(),
                "kv_pool_bytes": self.kv_pool_bytes(),
                "completed": int(self._m_completed.value),
                "shed_overload": int(self._m_shed_overload.value),
                "shed_deadline": int(self._m_shed_deadline.value),
                "quarantined": int(self._m_quarantined.value),
                "retries": int(self._m_retries.value),
                "step_failures": int(self._m_step_failures.value),
                "batches": int(self._m_batches.value),
                "reloads": int(self._m_reloads.value),
                "preempted": int(self._m_preempted.value),
                "in_flight": int(self._m_in_flight.value)}

    @property
    def fault_snapshot_bytes(self) -> int:
        """Device bytes of the per-call snapshot of the per-slot state
        (`_snapshot`: ``pos``, ``tok`` and, constrained, the DFA states);
        0 before the first call."""
        return sum(int(t.numel()) * t.element_size()
                   for t in self._snap or ())

    def health(self) -> dict:
        """The `/healthz` body, the reference's keys: with the warm-up
        report and the resolutions by source (reference :5483)."""
        with self._lock:
            self._tick_breaker(self._clock())
            occupied = sum(s is not None for s in self._slots)
            out = {"ready": self.ready(),
                   "breaker": self._breaker,
                   "degraded": self._degraded_locked(),
                   "draining": self._draining,
                   "queue_depth": len(self._queue),
                   "num_slots": self._num_slots,
                   "slots_occupied": occupied,
                   "slot_occupancy": occupied / max(1, self._num_slots),
                   "tick_budget_utilization": (
                       self._last_tick_spent
                       / float(max(1, self._tick_budget))
                       if self._prefill_chunk is not None else None),
                   "weights_step": self._weights_step,
                   "quantize": self._qmode,
                   "kv_quantize": self._kv_mode,
                   "paged": self._paged,
                   "spec_decode": self._spec,
                   "prefill_chunk": self._prefill_chunk,
                   "pipeline": self._pipe,
                   "last_warmup": self._last_warmup,
                   "compiles_by_source": self._compiles_by_source()}
            if self._paged and self._prefix_cache is not None:
                out["prefix_digest"] = self._prefix_cache.chain_digest()
        return {**out, **self.stats}

    def ready(self) -> bool:
        """Admissions open: not stopped, not draining (false from the
        moment `drain()` is called) and the breaker not open."""
        with self._lock:
            self._tick_breaker(self._clock())
            return (self._accepting and not self._draining
                    and self._breaker != "open")

    def debugz(self, recent: int = 100) -> dict:
        """The operator's "why is it slow RIGHT NOW" snapshot
        (reference :5257): the slot table, queue ages, the recorder's
        recent events, the paged pool, the tick pipeline, the profiler's
        report, the chunked and spec state, and the QoS knobs."""
        now = self.recorder.now()

        def age(r):
            t = r.trace.first_ts("submit")
            return round(now - t, 6) if t is not None else None

        with self._lock:
            slots = [{"slot": i, "rid": r.rid, "status": r.status,
                      "tenant": r.tenant, "priority": r.priority,
                      "generated": int(sum(a.shape[0]
                                           for a in r._generated)),
                      "max_new_tokens": r.max_new_tokens,
                      "age_s": age(r),
                      **({"phase": ("prefilling"
                                    if self._is_prefilling(r)
                                    else "decoding"),
                          "prefill_pos": int(r._prefill_pos),
                          "prefill_target": int(r._prefill_target)}
                         if self._prefill_chunk is not None else {})}
                     for i, r in enumerate(self._slots) if r is not None]
            queue = [{"rid": r.rid, "queue_age_s": age(r),
                      "tenant": r.tenant, "priority": r.priority}
                     for r in self._queue]
            queue_by_tenant: Dict[str, int] = {}
            for r in self._queue:
                t = r.tenant or "default"
                queue_by_tenant[t] = queue_by_tenant.get(t, 0) + 1
            breaker = self._breaker
            degraded = self._degraded_locked()
            qos = None
            if (self._qos_weights is not None
                    or self._preempt_budget > 0
                    or self._qos_spec_off
                    or self._chunk != self._base_chunk):
                qos = {"tenant_weights": (dict(self._qos_weights)
                                          if self._qos_weights
                                          is not None else None),
                       "deficits": {t: round(d, 2) for t, d in
                                    self._qos_deficit.items()},
                       "preemption_budget": self._preempt_budget,
                       "spec_off": self._qos_spec_off,
                       "decode_chunk": self._chunk,
                       "base_decode_chunk": self._base_chunk}
        out = {"mode": self.config.mode,
               "num_slots": self._num_slots,
               "slots_occupied": len(slots),
               "slots": slots,
               "queue_depth": len(queue),
               "queue": queue,
               "queue_by_tenant": queue_by_tenant,
               "breaker": breaker,
               "degraded": degraded,
               "weights_step": self._weights_step,
               "recorder_events": len(self.recorder),
               "recent_events": [e.as_dict() for e in
                                 self.recorder.recent(recent)]}
        if self._paged:
            with self._lock:
                out["paged"] = {
                    "page_size": self._page_size,
                    "num_pages": self._num_pages,
                    "pages_free": self._allocator.pages_free,
                    "pages_used": self._allocator.pages_used,
                    "block_tables": {
                        i: list(map(int, pgs))
                        for i, pgs in enumerate(self._slot_pages) if pgs},
                    "prefix_cache": (
                        {**self._prefix_cache.stats(),
                         "hits": int(self.counts["prefix_hits"]),
                         "misses": int(self.counts["prefix_misses"]),
                         "shared_tokens": int(
                             self.counts["prefix_shared_tokens"])}
                        if self._prefix_cache is not None else None)}
        if self._continuous or self._pipe_fallback is not None:
            out["tick_pipeline"] = {
                "pipeline": self._pipe,
                "fallback_reason": self._pipe_fallback,
                "in_flight_ticks": len(self._pending),
                "last_sync_s": round(self._last_sync_s, 6),
                "syncs_last_tick": self._last_tick_syncs,
                "syncs_total": self.counts["syncs"],
                "device_idle_fraction": round(self._last_idle, 4),
                "last_flush": self._last_flush}
            out["compile_cache"] = {
                "program_cache_size": _PROGRAMS.maxsize,
                "aot": (self._aot.stats() if self._aot is not None
                        else None),
                "last_warmup": self._last_warmup}
        if self.profiler.enabled:
            out["profiling"] = self.profiler.report()
        if self._prefill_chunk is not None:
            out["chunked_prefill"] = {
                "prefill_chunk": self._prefill_chunk,
                "tick_token_budget": self._tick_budget,
                "last_tick_tokens": self._last_tick_spent,
                "budget_utilization": round(
                    self._last_tick_spent / max(1, self._tick_budget), 3),
                "prefill_chunks_total": self.counts["prefill_chunks"]}
        if self._spec:
            out["spec"] = {
                "spec_k": self._spec_k,
                "k": self.spec_k_current,
                "plain_cooldown": self._spec_plain,
                "draft": self.config.draft,
                "draft_layers": self._draft_layers,
                "accept_ema": {i: round(self._accept_ema[i], 3)
                               for i, r in enumerate(self._slots)
                               if r is not None},
                "drafted": self.counts["spec_drafted"],
                "accepted": self.counts["spec_accepted"]}
        if qos is not None:
            out["qos"] = qos
        return out

    def qos_control(self, spec_off: Optional[bool] = None,
                    decode_chunk: Optional[int] = None) -> dict:
        """The overload controller's knobs (reference :5393): ``spec_off``
        suspends speculative rounds (plain decode is token-exact, so only
        throughput changes); ``decode_chunk=N`` shrinks the decode chunk
        (clamped to [1, the configured chunk]: a new program key, so on
        the card a CUDA graph of its own), ``0`` restores it. Both are
        reversible and leave committed tokens as they are. Returns the
        knobs' state."""
        with self._lock:
            if spec_off is not None:
                self._qos_spec_off = bool(spec_off)
            if decode_chunk is not None:
                c = int(decode_chunk)
                self._chunk = (self._base_chunk if c == 0
                               else min(max(1, c), self._base_chunk))
        return {"spec_off": self._qos_spec_off,
                "decode_chunk": self._chunk,
                "base_decode_chunk": self._base_chunk}

    def slo_report(self) -> dict:
        """Windowed SLO report (observability/slo.py): TTFT / TPOT /
        e2e / queue-age percentiles + goodput — `GET /slo`'s body."""
        return self.slo.report()

    def profile_report(self) -> dict:
        """The profiler's report (observability/profiling.py): card
        peaks, live MFU, achieved FLOP/s and bytes/s, the per-program
        cost / roofline table and the per-tenant bill."""
        return self.profiler.report()

    def profilez(self, seconds) -> tuple:
        """`GET /profilez?seconds=N` backend: one bounded single-flight
        torch.profiler capture into ``EngineConfig.profile_dir``;
        ``(http_status, body_dict)`` (503 without a directory, while a
        capture runs, or while another torch.profiler session is
        active). Wire via ``MetricsServer(profilez=engine.profilez)``."""
        return self._capture.capture(seconds)

    def timeline(self, n: Optional[int] = None) -> dict:
        """Chrome/Perfetto trace_event JSON over the recorder's recent
        events: one lane per slot plus the queue lane."""
        return timeline_json(self.recorder, num_slots=self._num_slots, n=n)

    def _on_terminal(self, r: RequestHandle) -> None:
        """RequestHandle._finish hook (reference :2199): the terminal
        trace event, with the request's accumulated bill, and the SLO
        accounting, once per request."""
        bill = ({"cost_flops": float(r.cost_flops),
                 "cost_bytes": float(r.cost_bytes),
                 **({"tenant": r.tenant} if r.tenant is not None else {})}
                if self.profiler.enabled else {})
        if r.status == RequestStatus.COMPLETED:
            r.trace.add("finished",
                        tokens=int(sum(a.shape[0] for a in r._generated)),
                        partial=bool(r.deadline_exceeded), **bill)
        elif r.status == RequestStatus.SHED:
            r.trace.add("shed", reason=(
                "cancelled" if r._cancelled
                else "deadline" if r.deadline_exceeded
                else "handoff" if r._handoff_failed
                else "overload"), **bill)
        elif r.status == RequestStatus.QUARANTINED:
            r.trace.add("quarantined", **bill)
        self.slo.finished(r.trace)

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               constrain=None, tenant: Optional[str] = None,
               trace_ctx: Optional[dict] = None,
               deadline_s: Optional[float] = None,
               on_deadline: str = "shed",
               priority: int = 0, hold_kv: bool = False,
               kv: Optional[KVHandoff] = None) -> RequestHandle:
        """Admit one prompt. Raises EngineStopped after `stop()`,
        EngineDraining while draining, and OverloadError when the queue is
        full or the circuit breaker is open; past ``degrade_queue_depth``
        queued requests, or while the breaker is not closed, the token
        budget is capped at ``degraded_max_new_tokens`` (reference
        :2099-2127). ``deadline_s`` (seconds on the engine's clock) sheds
        the request with DeadlineExceeded once it passes, or with
        ``on_deadline="partial"`` completes it with the tokens committed
        by then. A paged engine refuses a request that needs more pages
        than its pool holds. ``constrain`` (a regex, or a spec dict of
        `serving.constrain.normalize_constraint`, whose ``consumed``
        counts prompt-tail tokens the grammar already read) restricts
        the output to the grammar; a spec that cannot be served raises
        ConstraintError here (reference :2030-2070, :2145-2180).
        ``tenant`` labels the request's bill and ``priority``
        (0..MAX_PRIORITY) is its QoS class: with ``preemption_budget`` > 0
        a higher class seats first and may preempt a lower one (a
        malformed tenant or priority raises QoSValidationError first);
        ``trace_ctx`` is merged into every event of its trace (reference
        :2180-2197).

        KV handoff (reference :2020-2096): ``hold_kv`` keeps the request's
        slot, and its pages, seated after it completes until
        `export_slot_kv` or `release_held` frees it. ``kv`` (a
        `KVHandoff`) seats the request by adopting the handed-off rows
        into fresh pages instead of prefilling (`_seat_adopted`), on a
        continuous paged engine of the handoff's KV mode and model
        widths; anywhere else it is dropped with a warning and the
        request prefills (the same tokens, slower). A ``source="cache"``
        handoff seeds the prefix cache at seating, then admits as
        usual."""
        if kv is not None:
            adoptable = (self._continuous and self._paged
                         and kv.kv_mode == self._kv_mode
                         and kv.n_layers == self.cfg.n_layers
                         and kv.d_model == self.cfg.d_model)
            if kv.source == "cache":
                adoptable = adoptable and self._prefix_cache is not None
            if not adoptable:
                log.warning("KV handoff not adoptable here (paged=%s, "
                            "kv_mode=%s vs handoff %s, source=%s): "
                            "falling back to re-prefill", self._paged,
                            self._kv_mode, kv.kv_mode, kv.source)
                kv = None
        if on_deadline not in ("shed", "partial"):
            raise ValueError(f"on_deadline must be 'shed' or 'partial', "
                             f"got {on_deadline!r}")
        tenant, priority = validate_tenant_priority(tenant, priority)
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            # an out-of-range id would fault the device-side gather
            raise ValueError(f"prompt token ids must be in "
                             f"[0, {self.cfg.vocab_size})")
        grammar, cstart = None, 0
        if constrain is not None:
            # compiled outside the lock: DFA construction is host work
            # keyed by the grammar's hash
            try:
                grammar, cstart = self._compile_constraint(prompt,
                                                           constrain)
            except ConstraintError as e:
                self._c_reject(e)
                raise
        now = self._clock()
        with self._lock:
            if not self._accepting:
                raise EngineStopped(
                    "engine is stopped: submit() would never be served")
            if self._draining:
                raise EngineDraining(
                    "engine is draining: admissions are closed until "
                    "resume()")
            self._tick_breaker(now)
            if self._breaker == "open":
                self._m_shed_overload.inc()
                raise OverloadError(
                    "circuit breaker open (recent step failures); "
                    f"retry after {self.config.breaker_cooldown_s}s")
            if len(self._queue) >= self.config.max_queue:
                self._m_shed_overload.inc()
                raise OverloadError(f"queue full ({self.config.max_queue})")
            cap = (self.config.degraded_max_new_tokens
                   if self._degraded_locked()
                   else self.config.max_new_tokens)
            eff = min(max_new_tokens or self.config.max_new_tokens, cap,
                      self.config.max_new_tokens)
            if eff < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if prompt.shape[0] + eff > self.cfg.max_len:
                raise ValueError(
                    f"prompt {prompt.shape[0]} + {eff} new tokens exceeds "
                    f"max_len={self.cfg.max_len}")
            if self._paged:
                need = pages_for(prompt.shape[0] + eff, self._page_size)
                if need > self._allocator.usable_pages:
                    raise ValueError(
                        f"request needs {need} KV pages but the pool has "
                        f"{self._allocator.usable_pages} (kv_pages="
                        f"{self._num_pages}, page_size={self._page_size})"
                        " - it could never be admitted")
            handle = RequestHandle(
                next(self._rids), prompt, eff,
                now + deadline_s if deadline_s is not None else None,
                on_deadline)
            if grammar is not None:
                # the last check: the grammar's rows in the table (a
                # resubmitted grammar shares them)
                self._ensure_constrain()
                try:
                    handle._cbase = self._ctab.acquire(grammar)
                except ConstraintError as e:
                    self._c_reject(e)
                    raise
                if grammar.key not in self._cgrammar_keys:
                    self._cgrammar_keys.add(grammar.key)
                    self._m_c_compiles.inc()
                self._m_c_requests.inc()
                handle._grammar = grammar
                handle._cinit = handle._cstate_host = cstart
            handle.tenant = tenant
            handle.priority = priority
            handle._hold_kv = bool(hold_kv)
            handle._kv = kv
            handle.trace = self.recorder.start_trace(handle.rid,
                                                     ctx=trace_ctx)
            # held weakly: an engine abandoned with requests in flight
            # (a fleet replica's simulated crash) is freed by its last
            # reference, not by the cyclic collector
            handle._on_terminal = weakref.WeakMethod(self._on_terminal)
            handle.trace.add(
                "submit", prompt_tokens=int(prompt.shape[0]),
                max_new_tokens=int(eff),
                deadline_s=(float(deadline_s)
                            if deadline_s is not None else None),
                **({"tenant": tenant} if tenant is not None else {}),
                **({"priority": priority} if priority else {}),
                **({"constrained": True, "grammar": grammar.key[:12],
                    "dfa_states": grammar.num_states}
                   if grammar is not None else {}))
            self._queue.append(handle)
            handle.trace.add("queued", depth=len(self._queue))
            self._cv.notify()
        return handle

    # -- grammar constraints (reference :1841-1935) ------------------------
    def _compile_constraint(self, prompt: np.ndarray, constrain):
        """(grammar, start state) of a ``constrain`` spec: compiled
        against the vocabulary under the table bound, with its
        ``consumed`` prompt tail replayed (which validates it); raises
        ConstraintError (reason ``"mode"`` in batch mode)."""
        if not self._continuous:
            raise ConstraintError(
                "constrain= requires mode='continuous' (batch mode has "
                "no per-slot DFA state to carry across steps)", "mode")
        spec, consumed = normalize_constraint(constrain)
        grammar = compile_grammar(
            spec, int(self.cfg.vocab_size),
            state_cap=int(self.config.constrain_state_cap))
        if consumed > int(prompt.size):
            raise ConstraintError(
                f"constrain consumed={consumed} exceeds the prompt length "
                f"{int(prompt.size)}", "invalid")
        start = grammar.replay(prompt[prompt.size - consumed:]
                               if consumed else ())
        if grammar.is_terminal(start):
            raise ConstraintError(
                "grammar is already terminal at the start state: it "
                "would emit zero tokens", "empty")
        return grammar, int(start)

    def _c_reject(self, e: ConstraintError) -> None:
        self._ensure_constrain_metrics()
        self._m_c_rejections.labels(reason=e.reason).inc()

    def _ensure_constrain(self) -> None:
        """The first constrained admission: the table, the per-slot DFA
        states (all row 0) on the device, and the switch to the masked
        programs for every later call."""
        if self._constrain_active:
            return
        self._ctab = ConstraintTable(int(self.config.constrain_state_cap),
                                     int(self.cfg.vocab_size))
        self._cstate = torch.zeros((self._num_slots,), dtype=torch.int32,
                                   device=self.device)
        self._ensure_constrain_metrics()
        self._constrain_active = True

    def _c_state_for(self, r: RequestHandle) -> int:
        """The table row a (re)seated request's slot starts from: its
        committed prefix replayed through the grammar on the host, offset
        by its rows' base; row 0 (all-allow) for an unconstrained
        request."""
        if r._grammar is None:
            return 0
        st = r._cinit
        for t in r.generated.tolist():
            st = r._grammar.advance(st, int(t))
        r._cstate_host = st
        return int(r._cbase) + int(st)

    def _c_advance_commit(self, r: RequestHandle, toks: np.ndarray):
        """The host's walk of committed tokens through the request's
        grammar, which decides: returns the tokens up to and with the
        one reaching a terminal state (or before one the grammar refuses,
        counted in ``constrained_illegal``: the device's mask makes that
        impossible), and whether the walk ended terminal."""
        g, st = r._grammar, r._cstate_host
        keep, terminal = 0, False
        for t in toks.tolist():
            if not g.legal(st, int(t)):
                log.error("request %d: committed token %d illegal in "
                          "DFA state %d (truncating)", r.rid, int(t), st)
                self._m_c_illegal.inc()
                break
            st = g.advance(st, int(t))
            keep += 1
            if g.is_terminal(st):
                terminal = True
                break
        r._cstate_host = st
        return toks[:keep], terminal

    def _finish(self, r: RequestHandle, status: str,
                error: Optional[BaseException] = None) -> None:
        """The one place a request finishes: its grammar's table rows are
        released (they stay resident for a resubmit until the table needs
        the room; reference :2230), a completion is counted and the
        request leaves the in-flight gauge."""
        if status == RequestStatus.COMPLETED:
            self._m_completed.inc()
        if r._in_flight:
            r._in_flight = False
            self._m_in_flight.dec()
        r._finish(status, error)
        if r._grammar is not None:
            self._ctab.release(r._grammar.key)

    # -- driving ---------------------------------------------------------
    def run_pending(self) -> int:
        """Tick until the queue and the slot pool are drained (and, in
        the pipelined loop, the last tick committed); returns the number
        of ticks run."""
        n = 0
        while self.tick():
            n += 1
        return n

    def drained(self) -> bool:
        """True when no request is queued, seated or awaiting its commit
        (reference :2319), and no tick is running: a slot frees once its
        tokens are all dispatched, so a request can be in no slot and no
        pending record while the tick that commits it runs (on the
        worker's thread)."""
        with self._lock:
            return (not self._ticking and not self._queue
                    and not self._pending
                    and all(r is None or (r._hold_kv and r.done())
                            for r in self._slots))

    def draining(self) -> bool:
        return self._draining

    def start(self) -> "InferenceEngine":
        """Drive the engine from a background worker thread (reference
        :2264): it ticks while there is work and sleeps on the engine's
        condition otherwise."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True,
                                            name="inference-engine")
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker; with ``drain`` the queued and resident
        requests are served to the end on the caller's thread first.
        Admissions stay closed after (`submit` raises EngineStopped)."""
        with self._cv:
            self._accepting = not drain and self._accepting
            self._stop_flag = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.run_pending()
        self._accepting = False

    def drain(self, wait: bool = True,
              timeout: Optional[float] = None) -> "InferenceEngine":
        """Close admissions at once (`submit` raises EngineDraining and
        `ready()` is false from this instant, not from when the last
        resident finishes) while queued and resident requests run to
        completion; with ``wait``, block until drained (driving the work
        on the caller's thread when no worker runs). `resume()` reopens
        admissions (reference :2291)."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        if wait:
            if self._thread is None:
                self.run_pending()
            else:
                deadline = (None if timeout is None
                            else time.monotonic() + timeout)
                while not self.drained():
                    if (deadline is not None
                            and time.monotonic() > deadline):
                        raise TimeoutError(
                            f"engine did not drain within {timeout}s")
                    time.sleep(0.002)
        return self

    def resume(self) -> None:
        """Reopen admissions after a `drain()`."""
        with self._cv:
            self._draining = False
            self._cv.notify_all()

    def cancel(self, handle: RequestHandle) -> bool:
        """Best-effort cancel (reference :2336): a queued request is shed
        at once, one in flight at the next commit boundary. Both are
        typed RequestCancelled and counted under
        ``serving_requests_shed_total{reason="cancelled"}``. Returns False
        for a request already finished."""
        with self._lock:
            if handle.done():
                return False
            handle._cancelled = True
            try:
                self._queue.remove(handle)
            except ValueError:
                return True      # in flight: the commit boundary sheds it
        self._m_shed_cancelled.inc()
        self._finish(handle, RequestStatus.SHED, RequestCancelled(
            f"request {handle.rid} cancelled while queued"))
        return True

    def _worker(self) -> None:
        while True:
            with self._cv:
                while (not self._queue and not self._pool_busy()
                       and not self._stop_flag):
                    self._cv.wait(0.05)
                if self._stop_flag:
                    return
            # the coalescing window lets near-simultaneous submissions
            # share an admission, but never stalls a busy pool and never
            # sleeps when the queue already fills every free slot
            if (self.config.batch_timeout_s > 0
                    and not self._pool_busy()
                    and not self._queue_fills_pool()):
                time.sleep(self.config.batch_timeout_s)
            self.tick()

    def _pool_busy(self) -> bool:
        """A seated slot, or a dispatched tick still to commit (a slot
        frees once its tokens are all dispatched)."""
        return bool(self._pending) or any(
            s is not None and not (s._hold_kv and s.done())
            for s in self._slots)

    def _queue_fills_pool(self) -> bool:
        """True when waiting cannot improve the next admission: the queue
        holds at least as many requests as there are seats to fill (free
        slots, or in batch mode the batch cap)."""
        with self._lock:
            if self._continuous:
                seats = sum(s is None for s in self._slots)
            else:
                seats = self.config.max_batch_size
            return len(self._queue) >= max(1, seats)

    def _shed_expired(self, batch) -> None:
        """Shed a cancelled request, and one past its deadline (or
        complete it partial), among ``batch`` (reference :2478)."""
        now = self._clock()
        for r in batch:
            if r.status not in (RequestStatus.RUNNING,
                                RequestStatus.QUEUED) or r.done():
                continue
            if r._cancelled:
                self._m_shed_cancelled.inc()
                self._finish(r, RequestStatus.SHED, RequestCancelled(
                    f"request {r.rid} cancelled with "
                    f"{r.generated.shape[0]} tokens decoded"))
                continue
            if r.deadline_at is not None and now > r.deadline_at:
                r.deadline_exceeded = True
                if r.on_deadline == "partial":
                    self._finish(r, RequestStatus.COMPLETED)
                else:
                    self._m_shed_deadline.inc()
                    self._finish(r, RequestStatus.SHED, DeadlineExceeded(
                        f"request {r.rid} past deadline with "
                        f"{r.generated.shape[0]}/{r.max_new_tokens} "
                        "tokens decoded"))

    def tick(self) -> bool:
        """One scheduling round. Continuous: admit into free slots,
        dispatch the tick's calls (`_dispatch_tick`: one-shot, one
        prefill over the pool and one decode chunk for every decoding
        slot; chunked, the token-budget round), then commit. The
        synchronous loop waits for each call's output as it dispatches it
        and commits this tick; the pipelined loop commits the previous
        tick behind one wait (see the module docstring). Batch mode: form
        one batch of equal prompt lengths and run it to completion.
        Returns whether any work was done."""
        with self._tick_mutex:
            self._ticking = True
            try:
                if not self._continuous:
                    batch = self._form_batch()
                    if not batch:
                        return False
                    self._process_batch(batch)
                    return True
                return self._tick()
            finally:
                self._ticking = False

    def _tick(self) -> bool:
        self._tick_perf0 = _perf()
        self._tick_syncs = 0
        self._observe("tick_begin", self.profiler.tick_begin)
        t_start = self._clock()
        admitted = self._fill_slots()
        pending = self._dispatch_tick(admitted)
        prev = pending
        if self._pipe:
            prev = self._pending.popleft() if self._pending else None
            if pending is not None:
                self._pending.append(pending)
        if prev is not None:
            self._commit_tick(prev)
        self._reap(shed=True)
        busy = bool(admitted) or pending is not None or prev is not None
        if busy:
            self._inc("pipelined_ticks")
            self._m_batches.inc()
            n_active = (pending.n_active if pending is not None
                        else len(admitted))
            self._observe("tick_end", self._tick_epilogue, t_start,
                          n_active or 1)
        return busy

    def set_listeners(self, *listeners) -> None:
        """Attach observers of the training listeners' protocol
        (reference :2392): after every batch (batch mode) or busy tick
        the engine calls ``record_batch(batch_size)`` where a listener
        has it, then ``iteration_done(engine, batch_index,
        batch_latency_s)``."""
        self._listeners = list(listeners)

    def _notify_listeners(self, size: int, idx: int,
                          latency: float) -> None:
        """The listener protocol's two calls; a listener that raises is
        logged and serving goes on."""
        for lst in self._listeners:
            try:
                if hasattr(lst, "record_batch"):
                    lst.record_batch(size)
                lst.iteration_done(self, idx, latency)
            except Exception:     # listeners must not kill serving
                log.exception("engine listener failed")

    def _tick_epilogue(self, t_start: float, n_active: int) -> None:
        """The device-idle estimate of the tick, its busy interval
        attributed across the programs it dispatched, the batch-size and
        latency series and the listeners (reference `_tick_epilogue`,
        :2592)."""
        nowp = _perf()
        wall = nowp - self._tick_perf0
        if self._busy_since is not None:
            # a dispatch chain is still outstanding (pipelined tick):
            # fold the elapsed busy interval into THIS tick and roll the
            # marker forward into the next one
            self._tick_busy_s += nowp - self._busy_since
            self._busy_since = nowp
        if wall > 0:
            self._last_idle = min(1.0, max(
                0.0, 1.0 - self._tick_busy_s / wall))
        self.profiler.tick_end(self._tick_busy_s)
        self._busy_total_s += self._tick_busy_s
        self._tick_busy_s = 0.0
        self._last_tick_syncs = self._tick_syncs
        self._m_batch_size.observe(n_active)
        latency = self._clock() - t_start
        self._m_batch_seconds.observe(latency)
        self._notify_listeners(n_active, int(self._m_batches.value),
                               latency)

    # -- batch mode (reference :2402-2478, :5142-5216) ----------------------
    def _form_batch(self) -> List[RequestHandle]:
        """Pop the head request and every queued request of the same
        prompt length, up to ``max_batch_size`` (the model masks no pad,
        so mixed lengths cannot share a batch); the rest keep their
        order."""
        with self._lock:
            if not self._queue:
                return []
            head = self._queue.popleft()
            t0 = head.prompt.shape[0]
            batch = [head]
            rest: deque = deque()
            while self._queue and len(batch) < self.config.max_batch_size:
                r = self._queue.popleft()
                (batch if r.prompt.shape[0] == t0 else rest).append(r)
            rest.extend(self._queue)
            self._queue = rest
            for r in batch:
                r._in_flight = True
            self._m_in_flight.inc(len(batch))
        self._m_batch_size.observe(len(batch))
        for r in batch:
            r.status = RequestStatus.RUNNING
            r.trace.add("admitted", batch_size=len(batch))
            self.slo.admitted(r.trace)
        return batch

    def _process_batch(self, batch: List[RequestHandle]) -> None:
        """Run ``batch`` to completion on the weights taken at its start
        (a reload meanwhile serves the next batch), then the batch
        series and the listeners."""
        t_start = self._clock()
        params = self._params
        try:
            self._decode_loop(batch, params)
        finally:
            for r in batch:
                if r._in_flight:
                    r._in_flight = False
                    self._m_in_flight.dec()
            self._m_batches.inc()
            latency = self._clock() - t_start
            self._m_batch_seconds.observe(latency)
            self._notify_listeners(len(batch), int(self._m_batches.value),
                                   latency)

    def _decode_loop(self, batch: List[RequestHandle], params) -> None:
        """Chunk by chunk: every running request's prompt + generated
        re-prefilled in one call that decodes the next ``decode_chunk``
        tokens (0: the whole remaining budget); a request is shed or
        completed at each chunk boundary."""
        self._shed_expired(batch)
        while True:
            active = [r for r in batch
                      if r.status == RequestStatus.RUNNING]
            if not active:
                return
            done = active[0].generated.shape[0]
            remaining = max(r.max_new_tokens - done for r in active)
            if remaining <= 0:
                for r in active:
                    self._finish(r, RequestStatus.COMPLETED)
                return
            n = remaining if self.config.decode_chunk <= 0 \
                else min(self.config.decode_chunk, remaining)
            prompts = np.stack(
                [np.concatenate([r.prompt, r.generated])
                 for r in active]).astype(np.int32)
            try:
                toks = self._invoke(params, prompts, n, active)
            except _BatchDecodeFailed as e:
                self._isolate(active, params, e)
                return
            for i, r in enumerate(active):
                need = min(n, r.max_new_tokens - done)
                self._commit_tokens(r, toks[i, :need].astype(np.int32),
                                    "decode_chunk", rate=(0.0, 0.0))
            self._shed_expired(batch)

    def _invoke(self, params, prompts: np.ndarray, n: int,
                reqs: List[RequestHandle]) -> np.ndarray:
        """One guarded batch generate of ``n`` tokens over ``prompts``
        [B, T], keyed by (seed, T); waits for its output. Returns the new
        tokens [B, n]. Raises _BatchDecodeFailed when the retries run
        out."""
        fn = self._program("generate", int(n))
        seed = batch_key(int(self.config.seed), prompts.shape[1])

        def call():
            self._busy_mark()
            return self._host(fn(params, self._tensor(prompts), seed))

        out = self._guarded(call, reqs, (), self._m_step_seconds)
        return out.numpy()[:, prompts.shape[1]:]

    def _isolate(self, active: List[RequestHandle], params,
                 err: BaseException) -> None:
        """A batch's retries ran out: each request re-runs alone, so one
        poisoned request cannot starve its batch peers; a request that
        fails alone is quarantined."""
        log.warning("batch of %d exhausted retries (%s); isolating",
                    len(active), str(err))
        for r in active:
            if r.status != RequestStatus.RUNNING:
                continue
            try:
                self._decode_solo(r, params)
            except _BatchDecodeFailed as e:
                self._quarantine(r, f"failed persistently: {e}")

    def _decode_solo(self, r: RequestHandle, params) -> None:
        while r.status == RequestStatus.RUNNING:
            self._shed_expired([r])
            if r.status != RequestStatus.RUNNING:
                return
            done = r.generated.shape[0]
            if done >= r.max_new_tokens:
                self._finish(r, RequestStatus.COMPLETED)
                return
            n = r.max_new_tokens - done
            if self.config.decode_chunk > 0:
                n = min(self.config.decode_chunk, n)
            prompts = np.concatenate([r.prompt, r.generated])[None]
            toks = self._invoke(params, prompts.astype(np.int32), n, [r])
            self._commit_tokens(r, toks[0].astype(np.int32),
                                "decode_chunk", rate=(0.0, 0.0), solo=True)

    def _fill_slots(self) -> List[tuple]:
        """Seat queued requests into free slots, FIFO (reference
        `_fill_slots`, :3268). A paged engine maps each request's cached
        prefix and allocates its private pages first (`_seat_paged`);
        when the pool cannot cover it the request goes back to the head
        of the queue and admission stops for this tick. With
        ``preemption_budget`` > 0 queued higher classes first evict
        lower-class residents (`_preempt_for_priority_locked`) and the
        queue is served highest class first (`_pop_request_locked`).
        Returns [(slot, handle)]."""
        admitted = []
        with self._lock:
            if self._preempt_budget > 0:
                self._preempt_for_priority_locked()
            free = deque(i for i in range(self._num_slots)
                         if self._slots[i] is None)
            seated_order: List[RequestHandle] = []
            while free and self._queue:
                r = self._pop_request_locked()
                self._shed_expired([r])
                if r.done():
                    continue
                i = free[0]
                hit = 0
                adopted = False
                if r._kv is not None and r._kv.source == "cache":
                    # a migrated chain seeds the prefix cache, then the
                    # request seats as usual, hitting it (a failed seed
                    # costs one prefill; reference :3301)
                    self._seed_cached_chain(r._kv)
                    r._kv = None
                if r._kv is not None:
                    seated = self._seat_adopted(i, r)
                    if seated is None:
                        if not r.done():      # blocked, not shed
                            self._queue.appendleft(r)
                        break
                    if not seated:
                        continue              # shed typed "handoff"
                    adopted = True
                elif self._paged:
                    hit = self._seat_paged(i, r)
                    if hit is None:
                        if not r.done():      # blocked, not shed
                            self._queue.appendleft(r)
                        break
                free.popleft()
                if not adopted:
                    seated_order.append(r)
                self._slots[i] = r
                r._slot = i
                if self._constrain_active:
                    # (re)seat (reference :3341-3347): the slot's next
                    # call starts it from its request's state, whatever
                    # its last occupant left on the device
                    self._cseed_pending[i] = self._c_state_for(r)
                if self._spec:
                    # seat with the pool's current belief (reference
                    # :3348-3353): a stream of fresh admissions must not
                    # drag the EMA back up under adversarial traffic
                    self._accept_ema[i] = self._accept_pool
                r.status = RequestStatus.RUNNING
                # a chunked slot prefills from the hit boundary toward
                # its committed prefix (reference :3355-3366)
                r._seat_seq = next(self._seat_order)
                r._pending_n = r._pending_spec = 0
                r._prefill_pos = int(hit)
                r._prefill_target = int(r.prompt.shape[0]
                                        + r.generated.shape[0])
                r._in_flight = True
                self._m_in_flight.inc()
                if adopted:
                    # the committed prefix arrived with the handoff: no
                    # prefill, the slot decodes from its next tick
                    # (reference :3373)
                    r._prefill_pos = r._prefill_target
                    self._dev_pos[i] = r._prefill_target - 1
                    r.trace.add("admitted", slot=i, bucket=0, adopted=True,
                                prefix_hit_tokens=int(r._prefill_target
                                                      - 1),
                                **({"prefill_chunk": self._prefill_chunk}
                                   if self._prefill_chunk is not None
                                   else {}))
                    self.slo.admitted(r.trace)
                    continue
                self._m_prefill_tokens.inc(
                    max(0, r._prefill_target - r._prefill_pos))
                self._observe("admitted", self._trace_admitted, i, r, hit)
                admitted.append((i, r))
            # admission order is seating order (reference :3390): the
            # oldest-first prefill scheduler's fairness rests on it
            assert [r for _, r in admitted] == seated_order, \
                "admission order diverged from queue order"
        return admitted

    def _pop_request_locked(self) -> RequestHandle:
        """The next request to seat: FIFO, or with ``preemption_budget``
        > 0 the first of the highest priority class (FIFO within a class,
        plain FIFO when every request is class 0; reference :3397)."""
        q = self._queue
        if self._preempt_budget <= 0 or len(q) <= 1:
            return q.popleft()
        best = max(range(len(q)), key=lambda j: (q[j].priority, -j))
        if best == 0:
            return q.popleft()
        r = q[best]
        del q[best]
        return r

    def _preempt_for_priority_locked(self) -> None:
        """Evict lower-priority residents so queued higher-priority
        requests seat this tick, at most ``preemption_budget`` evictions
        a tick (reference :3412): a waiter takes a free seat first, else
        evicts the lowest-priority resident, youngest seat first, and
        only of a strictly lower class, so equal classes never thrash.
        The evicted request requeues at the head with its committed
        tokens and re-prefills from them."""
        budget = self._preempt_budget
        free_n = sum(s is None for s in self._slots)
        waiting = sorted((r for r in self._queue
                          if r.priority > 0 and not r.done()),
                         key=lambda r: -r.priority)
        for w in waiting:
            if budget <= 0:
                break
            if free_n > 0:
                free_n -= 1      # a free seat serves this waiter
                continue
            residents = [(i, r) for i, r in enumerate(self._slots)
                         if r is not None and not r.done()
                         and not r._hold_kv]
            if not residents:
                break
            i, v = min(residents,
                       key=lambda e: (e[1].priority, -e[1]._seat_seq))
            if v.priority >= w.priority:
                break            # nothing strictly lower to displace
            self._free_slot(i)
            self._evict_to_queue(v)
            self._m_qos_preemptions.labels(
                self._qos_label(v.tenant)).inc()
            v.trace.add("preempted", reason="priority", by=int(w.rid),
                        slot=i)
            self._m_preempted.inc()
            self._queue.appendleft(v)
            budget -= 1
            # the freed seat is this waiter's: it does not count in
            # free_n, or the next waiter would spend it too

    def _evict_to_queue(self, r: RequestHandle) -> None:
        """The eviction of a seated or in-flight request back to the
        queue (priority preemption, reload): only its committed tokens
        stay; a pending tick's items for it commit nothing (its epoch
        moves on), and it leaves the in-flight gauge."""
        r.status = RequestStatus.QUEUED
        r._pending_n = r._pending_spec = 0
        r._epoch += 1
        if r._in_flight:
            r._in_flight = False
            self._m_in_flight.dec()

    def _evict_all_locked(self) -> int:
        """Reload's eviction (reference :5057; the caller holds the
        lock): every seated request and every one with tokens in flight
        (a pipelined slot frees once its tokens are all dispatched) is
        requeued at the head, in slot order, with its committed tokens:
        its KV encodes the old weights. Returns the number evicted."""
        if not self._continuous:
            return 0
        live = [r for r in self._in_flight_requests()
                if not r.done() and r.status == RequestStatus.RUNNING]
        for i, r in enumerate(self._slots):
            if r is not None:
                self._free_slot(i)
        for r in sorted(live, key=lambda r: r._slot, reverse=True):
            self._evict_to_queue(r)
            r.trace.add("preempted", reason="reload")
            self._queue.appendleft(r)
        return len(live)

    def _trace_admitted(self, i: int, r: RequestHandle, hit: int) -> None:
        """The ``admitted`` event (reference :3384) and the queue age."""
        extra = ({"prefill_chunk": self._prefill_chunk}
                 if self._prefill_chunk is not None else {})
        r.trace.add("admitted", slot=i, bucket=int(self._bucket_len(
            r.prompt.shape[0] + r.generated.shape[0] - hit)),
            prefix_hit_tokens=int(hit), **extra)
        self.slo.admitted(r.trace)

    def _occupied(self) -> List[tuple]:
        with self._lock:
            return [(i, r) for i, r in enumerate(self._slots)
                    if r is not None]

    def _ensure_state(self) -> None:
        if self._slot_state is None:
            if self._paged:
                self._slot_state = init_paged_state(
                    self.cfg, self._num_slots, self._page_size,
                    self._num_pages, self.device, kv_mode=self._kv_mode)
            else:
                self._slot_state = init_slot_state(
                    self.cfg, self._num_slots, self.device,
                    kv_mode=self._kv_mode)

    def _bucket_len(self, need: int) -> int:
        """Prefill bucket: the smallest power-of-two scaling of
        prefill_bucket_min that covers ``need``, capped at max_len."""
        b = max(1, self.config.prefill_bucket_min)
        while b < need:
            b *= 2
        return min(b, self.cfg.max_len)

    _MAKERS = {"prefill": make_continuous_prefill,
               "decode": make_continuous_decode,
               "chunked_prefill": make_chunked_prefill,
               "spec": make_speculative_decode,
               "paged_prefill": make_paged_prefill,
               "paged_decode": make_paged_decode,
               "paged_chunked_prefill": make_paged_chunked_prefill,
               "paged_spec": make_paged_speculative_decode}

    # the per-tick programs that replay as CUDA graphs on the card
    # (prefill's programs size their writes from the data: eager), and
    # their masked twins
    _GRAPHED = ("decode", "paged_decode", "spec", "paged_spec",
                "decode_c", "paged_decode_c", "spec_c", "paged_spec_c")

    # the KV handoff's gather and adopt programs (reference :1162-1240)
    _HANDOFF = {"page_gather": make_page_gather,
                "slot_gather": make_slot_gather,
                "kv_adopt": make_kv_adopt,
                "chain_adopt": make_chain_adopt}

    def _geometry(self) -> tuple:
        """What, beside its kind and size, a program of this engine is
        made from: the program cache's and the compile cache's key."""
        if self._geom is None:
            c = self.config
            self._geom = (
                astuple(self.cfg), self._num_slots,
                (self._page_size, self._max_pages, self._num_pages)
                if self._paged else None,
                float(c.temperature), int(c.top_k), float(c.top_p),
                self._kv_mode,
                self._draft_layers if self._spec else None)
        return self._geom

    def _geometry_id(self) -> int:
        """`_geometry` interned to a small int (`_GEOMETRY_IDS`), so that a
        program-cache key, looked up at every call, hashes cheaply."""
        if self._geom_id is None:
            self._geom_id = _GEOMETRY_IDS.setdefault(self._geometry(),
                                                     next(_GEOMETRY_SEQ))
        return self._geom_id

    def _make_program(self, kind: str, size: int):
        """A new program of ``kind`` (a `_MAKERS` or `_HANDOFF` key, one
        with ``"_c"`` appended for its masked variant, or ``"generate"``)
        at ``size`` (bucket or chunk length, decode chunk or K, handoff
        page bucket, generate length)."""
        c = self.config
        if kind == "generate":
            return make_parallel_generate(
                self.cfg, int(size), temperature=float(c.temperature),
                top_k=int(c.top_k), top_p=float(c.top_p))
        if kind in self._HANDOFF:
            return self._HANDOFF[kind]()
        base = kind[:-2] if kind.endswith("_c") else kind
        args = (self.cfg, size, self._num_slots)
        if base.startswith("paged"):
            args += (self._page_size, self._max_pages, self._num_pages)
        kw = dict(temperature=float(c.temperature), top_k=int(c.top_k),
                  top_p=float(c.top_p), kv_mode=self._kv_mode)
        if base.endswith("spec"):
            kw.update(draft_layers=self._draft_layers)
        fn = self._MAKERS[base](*args, **kw, constrain=base != kind)
        if base != kind:
            fn = self._masked(fn, 2 if base.endswith("spec") else 1)
        return fn

    def _program(self, kind: str, size: int):
        """The program (kind, size) from the process-wide program cache
        (`_ProgramLRU`), made there on a miss. An engine has one pool,
        so its KV mode is fixed; a quantized weight tree needs no program
        of its own (it dequantizes at each use). The first time this
        engine takes a key (again, after an eviction) it resolves it
        (`_resolve`); evictions it was told of are applied first."""
        if self._evicted or self._graveyard:
            self._apply_evictions()
        key = (kind, size)
        fn = _PROGRAMS.get((kind, size, self._geometry_id()),
                           lambda: self._make_program(kind, size), self)
        if self._evicted:
            self._apply_evictions()
        if key not in self._programs:
            if kind != "generate":
                self._resolve(kind, size)
            self._programs[key] = fn
        return fn

    def _program_evicted(self, gkey: tuple) -> None:
        """`_ProgramLRU`'s eviction notice for one of this engine's keys
        (from any thread): counted now, applied at the next `_program`."""
        self._m_prog_evictions.inc()
        self._evicted.append(gkey[:2])

    def _apply_evictions(self) -> None:
        """Drop each evicted key and, on the card, its CUDA graph. A
        graph may still have a replay queued on the stream, so it is
        kept, with an event recorded now, until the device has passed
        that event; dropped graphs whose event has completed go."""
        while self._evicted:
            key = self._evicted.popleft()
            self._programs.pop(key, None)
            g = self._graphs.drop(key) if self._graphs is not None else None
            if g is not None:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                self._graveyard.append((g, ev))
        if self._graveyard:
            self._graveyard = [(g, ev) for g, ev in self._graveyard
                               if not ev.query()]

    @classmethod
    def _compile_program(cls, kind: str) -> str:
        """A program kind's JAX program name, the ``program`` label of
        its resolutions (no bucket or K)."""
        masked = kind.endswith("_c")
        base = kind[:-2] if masked else kind
        return cls._JAX_PROGRAM.get(base, base) + ("_c" if masked else "")

    def _resolve(self, kind: str, size: int) -> None:
        """This engine's first resolution of (kind, size) (reference
        `_resolve_program`, :4126): on the card the CUDA libraries the
        program launches are made ready (`ops._build.ensure_built`: the
        build directory, the compile cache, or nvcc), and with a compile
        cache the program's manifest is read, or published when missing
        or different. The source is ``"aot_cache"`` when the manifest and
        every library it names came from the compile cache, else
        ``"jit"``; counted now, timed through the first call
        (`_resolved`)."""
        t0 = _perf()
        base = kind[:-2] if kind.endswith("_c") else kind
        libs = (_LIBRARIES.get(base, ()) if self.device.type == "cuda"
                else ())
        if libs:
            _build.ensure_built(*libs, cache=self._aot)
        program = self._compile_program(kind)
        source = "jit"
        if self._aot is not None:
            want = [(n, _build._digest(n)) for n in libs]
            ckey = self._aot.entry_key(program,
                                       (kind, size) + self._geometry())
            if self._aot.load_manifest(ckey) == want:
                if all(_build.origin.get(n) == "cache" for n in libs):
                    source = "aot_cache"
            else:
                self._aot.store_manifest(ckey, program, want)
        self._m_compiles.labels(program, source).inc()
        self._resolving[(kind, size)] = (t0, program)

    def _resolved(self, kind: str, size: int) -> None:
        """After a call of (kind, size): a resolution's seconds, from its
        start through this first call, into serving_compile_seconds."""
        pending = self._resolving.pop((kind, size), None)
        if pending is not None:
            t0, program = pending
            self._m_compile_seconds.labels(program).observe(_perf() - t0)

    def _masked(self, fn, lead: int):
        """A masked program in the engine's calling convention,
        ``(*weights, *pool, cstate, (callow, ctrans), *call tensors,
        cseed, cseedval, key)`` -> ``(*pool, cstate, *outputs)``: the
        DFA states and the table ride with the fixed arguments and the
        states come back with the pool, updated in place, as a captured
        graph needs them (`serving.graphs`)."""
        npool = 4 if self._kv_mode is None else 6
        n = lead + npool

        def run(*args):
            cstate, (callow, ctrans) = args[n], args[n + 1]
            *dyn, cseed, cseedval, key = args[n + 2:]
            out = fn(*args[:n], *dyn, callow, ctrans, cstate, cseed,
                     cseedval, key)
            return (*out[:npool], out[-1], *out[npool:-1])

        return run

    def _run(self, kind: str, size: int, lead: tuple, state: tuple,
             dyn: tuple, host: tuple, reqs: list, host_out) -> tuple:
        """One guarded call of the slot program (kind, size):
        ``program(*lead, *state, *dyn, seed)``, ``lead`` the weight trees,
        ``state`` the pool, ``dyn`` the call's tensors, ``host`` the (ctx,
        lens) host data that costs the call
        (`observability.profiling.program_cost`; its per-token rate is
        left in ``_call_rate``), ``reqs`` the co-resident requests the
        fault injector sees. ``host_out(*outputs)`` turns the program's
        outputs past the pool into the call's host-bound result. Returns
        (state, that result). On the card a per-tick program replays its
        CUDA graph (`serving.graphs`), except on the scratch pool of a
        solo re-run. A constraint-active engine runs the masked program
        instead, with the DFA states and the table added to the fixed
        arguments and the pending seeds to ``dyn``; the seeds it took
        retire after the call (`_cmask_begin` / `_cmask_commit`, JAX
        :1901-1935: a seed recorded since stays for the next call).
        Raises _BatchDecodeFailed when `_guarded` gives up."""
        taken = None
        fixed = (*lead, *state)
        if self._constrain_active:
            kind += "_c"
            fixed += (self._cstate, self._ctab.device(self.device))
            taken, seeds = self._cmask_begin()
            dyn += seeds
        fn = self._program(kind, size)
        self._call_rate = (0.0, 0.0)
        if self.profiler.enabled:
            self._observe("program cost", self._profile_call, kind, size,
                          *host)
        seed = int(self.config.seed)
        graphed = (self._graphs is not None and kind in self._GRAPHED
                   and not self._solo)
        npool = len(state)

        def call():
            self._busy_mark()
            if graphed:
                out = self._graphs.call((kind, size), fn, fixed, dyn, seed)
            else:
                out = fn(*fixed, *dyn, seed)
            rest = out[npool + 1:] if taken is not None else out[npool:]
            return tuple(out[:npool]), host_out(*rest)

        base = kind.removesuffix("_c")
        prefill = base.endswith("prefill")
        try:
            out = self._guarded(
                call, reqs, state,
                self._m_prefill_seconds if prefill
                else self._m_step_seconds,
                prefill=prefill, chunked=base.endswith("chunked_prefill"))
        finally:
            self._resolved(kind, size)
        if taken is not None:
            self._cmask_commit(taken)
        return out

    # -- the guarded call (reference `_guarded`, :5092-5140) ---------------
    def _guarded(self, call, reqs: list, state: tuple, hist,
                 prefill: bool = False, chunked: bool = False):
        """One program call under the engine's fault handling: the
        injector's hook first (``on_prefill_chunk`` for a chunked
        prefill, ``on_prefill`` for a prefill, else ``on_decode_step``,
        each with the ids of every co-resident request), then the call,
        its latency in ``hist`` and the breaker's accounting. The step
        counter indexes completed calls, so a failed attempt retries the
        same index. A RuntimeError (an injected fault, a CUDA error) is
        retried up to ``max_retries`` times with exponential backoff
        (each co-resident trace gets a ``retry`` event), the in-place
        per-slot state copied back from its snapshot before each retry;
        then _BatchDecodeFailed."""
        rids = [r.rid for r in reqs]
        self._snapshot(state)
        attempt = 0
        while True:
            try:
                if self._injector is not None:
                    hook = self._injector.on_decode_step
                    if prefill and chunked and hasattr(self._injector,
                                                       "on_prefill_chunk"):
                        hook = self._injector.on_prefill_chunk
                    elif prefill and hasattr(self._injector,
                                             "on_prefill"):
                        hook = self._injector.on_prefill
                    hook(self._step_counter, rids)
                t0 = _perf()
                out = call()
                self._last_call_s = _perf() - t0
                hist.observe(self._last_call_s)
                self._record_success()
                self._step_counter += 1
                return out
            except RuntimeError as e:
                self._record_failure(e)
                self._restore_snapshot()
                attempt += 1
                if attempt > self.config.max_retries:
                    raise _BatchDecodeFailed(str(e)) from e
                self._m_retries.inc()
                for r in reqs:
                    r.trace.add("retry", step=self._step_counter,
                                attempt=attempt, prefill=prefill)
                delay = min(self.config.backoff_base_s
                            * (2 ** (attempt - 1)),
                            self.config.backoff_max_s)
                log.warning(
                    "decode step %d failed (%s); retry %d/%d in %.3fs",
                    self._step_counter, str(e), attempt,
                    self.config.max_retries, delay)
                if delay > 0:
                    time.sleep(delay)

    def _snapshot(self, state: tuple) -> None:
        """Copy the per-slot tensors a program updates in place, the
        pool's ``pos`` and ``tok`` and a constrained engine's DFA states,
        into standing buffers (on the device's stream, no wait). The
        reference retries on its immutable state; these copies are what a
        retry restores (`_restore_snapshot`). The KV rows a retried call
        rewrites get the same values, and every other slot's state is
        left alone by the programs, so nothing else is copied."""
        live = tuple(state[-2:]) + ((self._cstate,)
                                    if self._constrain_active else ())
        snap = self._snap
        if snap is None or len(snap) != len(live) or any(
                a.shape != b.shape or a.device != b.device
                for a, b in zip(snap, live)):
            self._snap = tuple(t.clone() for t in live)
        else:
            for buf, t in zip(snap, live):
                buf.copy_(t)
        self._snap_of = live

    def _restore_snapshot(self) -> None:
        for t, buf in zip(self._snap_of, self._snap):
            t.copy_(buf)

    # -- the circuit breaker (reference :5218-5255) ------------------------
    def _record_failure(self, err: BaseException) -> None:
        self._m_step_failures.inc()
        with self._lock:
            self._consec_failures += 1
            if (self._breaker != "open" and self._consec_failures
                    >= self.config.breaker_failure_threshold):
                self._breaker = "open"
                self._opened_at = self._clock()
                log.error("circuit breaker OPEN after %d consecutive "
                          "step failures (last: %s)",
                          self._consec_failures, str(err))

    def _record_success(self) -> None:
        """Any completed call proves the path healthy: the breaker closes
        from half-open (the probe) and from open (a failure streak of one
        poisoned request whose peers then completed solo)."""
        with self._lock:
            self._consec_failures = 0
            if self._breaker != "closed":
                log.info("circuit breaker closed (was %s: a call "
                         "succeeded)", self._breaker)
                self._breaker = "closed"

    def _tick_breaker(self, now: float) -> None:
        if (self._breaker == "open"
                and now - self._opened_at
                >= self.config.breaker_cooldown_s):
            self._breaker = "half-open"
            log.info("circuit breaker half-open (cooldown elapsed)")

    def _degraded_locked(self) -> bool:
        return (len(self._queue) >= self.config.degrade_queue_depth
                or self._breaker != "closed")

    # JAX's names of the port's program kinds (the rest are the same)
    _JAX_PROGRAM = {"spec": "spec_decode", "paged_spec": "paged_spec_decode"}

    @classmethod
    def _program_label(cls, kind: str, size: int) -> str:
        """The reference's metric label of a program call (:4214): its
        JAX program name, plus the bucket of an admission prefill and the
        K of a spec round (``prefill_b1024``, ``spec_decode_k7``,
        ``paged_spec_decode_c_k4``)."""
        base = kind.removesuffix("_c")
        name = cls._compile_program(kind)
        if base in ("prefill", "paged_prefill"):
            return f"{name}_b{int(size)}"
        if base in ("spec", "paged_spec"):
            return f"{name}_k{int(size)}"
        return name

    def _program_tokens(self, kind: str, size: int) -> int:
        """Tokens one full invocation computes (reference :4225): the
        size over every slot, a spec round's K+1 window positions."""
        if kind.removesuffix("_c").endswith("spec"):
            return (int(size) + 1) * self._num_slots
        return int(size) * self._num_slots

    def _profile_call(self, kind: str, size: int, ctx, lens) -> None:
        """Cost one program call from its host data, install it under
        its label and record the dispatch for this tick's attribution;
        the per-token rate bills its tokens."""
        label = self._program_label(kind, size)
        paged = kind.startswith("paged")
        cost = program_cost(
            self.cfg, kind, size, self._num_slots, ctx, lens,
            kv_mode=self._kv_mode, weights=self._wbytes,
            draft=self._dbytes,
            draft_layers=self._draft_layers if self._spec else 0,
            page_size=self._page_size if paged else 0,
            max_pages=self._max_pages if paged else 0)
        tokens = self._program_tokens(kind, size)
        self.profiler.record_program(label, cost, tokens)
        self.profiler.dispatched(label, cost)
        self._call_rate = (cost["flops"] / tokens, cost["bytes"] / tokens)

    def _bill(self, pairs, kind: str, rate) -> None:
        """Bill each (handle, tokens) of ``pairs`` at ``rate``."""
        for r, n in pairs:
            self.profiler.bill_tokens(r, None, int(n), kind, rate)

    def _cmask_begin(self):
        """The pending seeds as one call's (cseed [Ns] bool, cseedval
        [Ns] int32) on the device, with the {slot: row} they carry."""
        taken = dict(self._cseed_pending)
        cseed = np.zeros((self._num_slots,), bool)
        cseedval = np.zeros((self._num_slots,), np.int32)
        for i, v in taken.items():
            cseed[i], cseedval[i] = True, v
        return taken, (self._tensor(cseed), self._tensor(cseedval))

    def _cmask_commit(self, taken) -> None:
        for i, v in taken.items():
            if self._cseed_pending.get(i) == v:
                del self._cseed_pending[i]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Host data on the device. On the card the copy goes through
        pinned memory without blocking (a pageable copy would wait for
        the stream); the pinned block is not reused before the copy has
        run."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A call's host-bound output: a host tensor the copy fills
        without blocking (pinned memory on the card), read at the commit
        (`_commit_tick`). The synchronous loop (and a solo re-run) waits
        for it here, one blocking wait a call; the pipelined loop at the
        commit."""
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        if not self._pipe or self._solo:
            self._wait(None)
        return t

    def _wait(self, done) -> None:
        """The blocking device wait: on event ``done``, or (None) on all
        work queued so far. Counted in ``counts["syncs"]``, its time in
        ``seconds["wait"]``; it ends the device's busy interval unless
        a dispatched tick is still pending (reference `_sync_done`,
        :4079)."""
        t0 = _perf()
        if self.device.type == "cuda":
            if done is None:
                torch.cuda.current_stream(self.device).synchronize()
            else:
                done.synchronize()
        now = _perf()
        self._inc("wait_seconds", now - t0)
        self._inc("syncs")
        self._last_sync_s = now - t0
        self._tick_syncs += 1
        if self._busy_since is not None and not self._pending:
            self._tick_busy_s += now - self._busy_since
            self._busy_since = None

    def _busy_mark(self) -> None:
        """The device is busy from a dispatch to the wait that drains
        it (reference :4072)."""
        if self._busy_since is None:
            self._busy_since = _perf()

    def _block_table(self, entries, span: Optional[int]) -> torch.Tensor:
        """Before a paged call that writes: privatise the shared pages in
        ``entries``' write ranges, then the block table on the device."""
        with self._lock:
            self._ensure_writable(entries, span)
            self._maybe_corrupt_page(entries, span)
            return self._tensor(self._bt.copy())

    def _call_prefill(self, state, entries, paged: Optional[bool] = None):
        """One admission prefill over ``state`` for ``entries``
        [(slot, handle)]: each committed prefix right-padded to the
        bucket; on a paged pool only the part past the prefix-cache hit
        (reference :4512). ``paged=False`` runs the contiguous program on
        a paged engine (the scratch pool of a solo re-run). Returns
        (state', first tokens [Ns], `_host`)."""
        paged = self._paged if paged is None else paged
        starts = {i: (r._page_start if paged else 0)
                  for i, r in entries}
        tails = {i: np.concatenate([r.prompt, r.generated]
                                   ).astype(np.int32)[starts[i]:]
                 for i, r in entries}
        tb = self._bucket_len(max(t.shape[0] for t in tails.values()))
        prompts = np.zeros((self._num_slots, tb), np.int32)
        plen = np.zeros((self._num_slots,), np.int32)
        start = np.zeros((self._num_slots,), np.int32)
        for i, tail in tails.items():
            prompts[i, :tail.shape[0]] = tail
            plen[i] = tail.shape[0]
            start[i] = starts[i]
        if paged:
            bt = self._block_table(entries, None)
            kind, lead, tail_args = "paged_prefill", (bt,), (start,)
        else:
            kind, lead, tail_args = "prefill", (), ()
        state, first = self._run(
            kind, tb, (self._params,), tuple(state),
            (*lead, *map(self._tensor, (prompts, plen, *tail_args))),
            (start, plen), [r for _, r in entries], self._host)
        rate = self._call_rate
        for i, _ in entries:
            self._dev_pos[i] = start[i] + plen[i]
        if self.profiler.enabled:
            self._observe("bill", self._bill,
                          [(r, plen[i]) for i, r in entries], "prefill",
                          rate)
        return state, first

    def _active_rem(self, entries):
        """The active mask and the budgets ``rem`` of a decode or spec
        call: each slot's tokens left after those committed and those in
        flight (reference :4475-4478)."""
        active = np.zeros((self._num_slots,), bool)
        rem = np.zeros((self._num_slots,), np.int32)
        for i, r in entries:
            active[i] = True
            rem[i] = r.max_new_tokens - r.generated.shape[0] - r._pending_n
        return active, rem

    def _call_chunk(self, state, entries, paged: Optional[bool] = None):
        """One decode chunk over ``state`` for the occupied ``entries``;
        per-slot budgets ride as ``rem``, so a slot finishing mid-chunk
        stops on the device (``paged=False``: as `_call_prefill`).
        Returns (state', toks [Ns, chunk] by `_host`, the call's
        per-token rate)."""
        paged = self._paged if paged is None else paged
        active, rem = self._active_rem(entries)
        steps = np.where(active, np.minimum(self._chunk,
                                            np.maximum(rem, 0)), 0)
        if paged:
            kind, lead = "paged_decode", (self._block_table(entries,
                                                            self._chunk),)
        else:
            kind, lead = "decode", ()
        state, toks = self._run(
            kind, self._chunk, (self._params,), tuple(state),
            (*lead, self._tensor(active), self._tensor(rem)),
            (self._dev_pos.copy(), steps), [r for _, r in entries],
            self._host)
        rate = self._call_rate
        self._inc("decode_chunks")
        self._dev_pos += steps
        return state, toks, rate

    def _commit_first(self, entries, first, **data) -> None:
        """Each live entry's first generated token (a one-shot prefill's
        or a last prefill chunk's)."""
        for i, r in entries:
            if not r.done():
                self._commit_tokens(r, first[i:i + 1].astype(np.int32),
                                    "prefill_done", slot=i, **data)

    def _commit_decode(self, entries, toks, needs, rate, data) -> None:
        """A decode chunk's tokens: ``needs[j]`` of entry j's row."""
        for (i, r), n in zip(entries, needs):
            if n > 0 and not r.done():
                self._commit_tokens(r, toks[i, :n].astype(np.int32),
                                    "decode_chunk", rate=rate, slot=i,
                                    **data)

    # -- chunked prefill: the token-budget scheduler (reference :2627) -----
    def _is_prefilling(self, r: RequestHandle) -> bool:
        """Seated with pos short of its committed prefix: only a chunked
        engine has such slots (one-shot prefill ends at admission)."""
        return (self._prefill_chunk is not None
                and r._prefill_pos < r._prefill_target)

    def _advance_prefill(self, budget: int) -> int:
        """Spend up to ``budget`` prompt tokens on prefilling slots,
        oldest admission first, each call advancing a slot by at most
        prefill_chunk tokens (reference :2666). When decode's bill has
        used up the budget the oldest admission still advances one chunk,
        so prefill never starves. Returns the tokens spent.

        Weighted fair share (``tenant_weights``): the budget is first
        credited to each backlogged tenant's deficit by weight
        (`_qos_credit`); slots are then served most-owed tenant first
        (oldest admission within a tenant), each tenant's grant in a call
        capped by what it is owed (deficit round-robin), and each granted
        token is charged back. When every deficit is spent the leftover
        budget serves slots in that order anyway (work conservation)."""
        qos = self._qos_weights is not None
        if qos:
            self._qos_credit(budget)
        spent = 0
        floor_used = False
        while True:
            prefilling = sorted(
                ((i, r) for i, r in self._occupied()
                 if self._is_prefilling(r) and not r.done()),
                key=lambda e: e[1]._seat_seq)
            if not prefilling:
                break
            if qos:
                prefilling.sort(key=lambda e: -self._qos_deficit.get(
                    e[1].tenant or "default", 0.0))
            rem = budget - spent
            floor = False
            if rem < 1:
                if spent > 0 or floor_used:
                    break
                # the progress floor: one chunk for the oldest admission
                # (under fair share, the most-owed tenant's oldest)
                floor_used = floor = True
                rem = self._prefill_chunk
                prefilling = prefilling[:1]
            plan = []
            if qos and not floor:
                owed = dict(self._qos_deficit)
                for i, r in prefilling:
                    if rem < 1:
                        break
                    t = r.tenant or "default"
                    cap = owed.get(t, 0.0)
                    if cap < 1.0:
                        continue
                    n = min(self._prefill_chunk,
                            r._prefill_target - r._prefill_pos, rem,
                            int(cap))
                    plan.append((i, r, n))
                    rem -= n
                    owed[t] = cap - n
            if not plan:
                for i, r in prefilling:
                    if rem < 1:
                        break
                    n = min(self._prefill_chunk,
                            r._prefill_target - r._prefill_pos, rem)
                    plan.append((i, r, n))
                    rem -= n
            try:
                self._prefill_chunk_call(plan)
            except _BatchDecodeFailed as e:
                self._isolate_slots([r for _, r, _ in plan], e)
                continue
            if qos:
                for i, r, n in plan:
                    t = r.tenant or "default"
                    self._qos_deficit[t] = self._qos_deficit.get(t, 0.0) - n
                    self._m_qos_prefill_tokens.labels(
                        self._qos_label(r.tenant)).inc(int(n))
            spent += sum(n for _, _, n in plan)
        return spent

    # -- tenant QoS (reference :2764-2800) ----------------------------------
    def _qos_weight(self, tenant: str) -> float:
        return self._qos_weights.get(
            tenant, float(self.config.qos_default_weight))

    def _qos_label(self, tenant: Optional[str]) -> str:
        """A tenant's metric label: the first ``tenant_top_n`` distinct
        tenants get their own, later ones fold into "other"."""
        t = "default" if tenant is None else tenant
        seen = self._qos_tenants_seen
        if t in seen:
            return t
        if len(seen) < self.config.tenant_top_n:
            seen.add(t)
            return t
        return "other"

    def _qos_credit(self, budget: int) -> None:
        """This tick's prefill budget divided among the backlogged
        tenants by weight; a tenant with no prefilling slot loses its
        deficit (no banking: its share rolls to the backlogged)."""
        backlogged = {r.tenant or "default"
                      for _, r in self._occupied()
                      if self._is_prefilling(r) and not r.done()}
        for t in list(self._qos_deficit):
            if t not in backlogged:
                del self._qos_deficit[t]
        if not backlogged or budget <= 0:
            return
        total = sum(self._qos_weight(t) for t in backlogged)
        for t in backlogged:
            self._qos_deficit[t] = (self._qos_deficit.get(t, 0.0)
                                    + budget * self._qos_weight(t) / total)

    def _prefill_chunk_call(self, plan) -> None:
        """One chunked-prefill call advancing ``plan`` [(slot, handle,
        n_tokens)] (reference :2801): each slot's next prompt slice, the
        final chunks flagged so they sample the first token; commits the
        first token of each slot whose prefill ended, then (paged) puts
        its prompt pages in the prefix cache."""
        self._ensure_state()
        entries = [(i, r) for i, r, _ in plan]
        c = self._prefill_chunk
        toks = np.zeros((self._num_slots, c), np.int32)
        clen = np.zeros((self._num_slots,), np.int32)
        start = np.zeros((self._num_slots,), np.int32)
        last = np.zeros((self._num_slots,), bool)
        for i, r, n in plan:
            pre = np.concatenate([r.prompt, r.generated]).astype(np.int32)
            toks[i, :n] = pre[r._prefill_pos:r._prefill_pos + n]
            clen[i] = n
            start[i] = r._prefill_pos
            last[i] = r._prefill_pos + n >= r._prefill_target
        if self._paged:
            kind, lead = ("paged_chunked_prefill",
                          (self._block_table(entries, None),))
        else:
            kind, lead = "chunked_prefill", ()
        self._slot_state, first = self._run(
            kind, c, (self._params,), self._slot_state,
            (*lead, *map(self._tensor, (toks, clen, start, last))),
            (start, clen), [r for _, r, _ in plan], self._host)
        rate = self._call_rate
        if self.profiler.enabled:
            self._observe("bill", self._bill,
                          [(r, n) for _, r, n in plan], "prefill", rate)
        finished = []
        for i, r, n in plan:
            r._prefill_pos += n
            self._dev_pos[i] = r._prefill_pos
            self._m_prefill_chunks.inc()
            if r._prefill_pos >= r._prefill_target:
                finished.append((i, r))
        # (reference :2895-2905) the chunk progress above is scheduling
        # state; the first tokens commit with the tick
        for _, r in finished:
            r._pending_n += 1
        self._pipe_items.append(("prefill_chunk", plan, first, finished))
        if self._paged and finished:
            # a prompt's pages hold its whole K/V only after its last
            # chunk: mid-prefill pages must never be shared (pipelined:
            # inserted at dispatch, read only by calls queued after it)
            self._cache_prefilled(finished)
        self._reap()

    # -- the tick loop: dispatch, then commit (reference :2922-3245) -------
    def _dispatch_tick(self, admitted) -> Optional[_PendingTick]:
        """Dispatch one tick's calls (reference :2960), scheduling on the
        tokens committed and in flight; returns the record to commit, or
        None when nothing was dispatched."""
        # the DFA states and seeds before this tick's dispatches: what
        # `_recover_failed_tick` restores (reference :2965)
        c_in = ((self._cstate.clone(), dict(self._cseed_pending))
                if self._pipe and self._constrain_active else None)
        self._pipe_items = []
        try:
            if self._prefill_chunk is not None:
                n_active = self._dispatch_budgeted(admitted)
            else:
                n_active = self._dispatch_oneshot(admitted)
        finally:
            items, self._pipe_items = self._pipe_items, []
        if not items:
            return None
        done = None
        if self._pipe and self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        rec = _PendingTick(items, done, c_in, n_active=n_active)
        rec.epochs = {id(r): r._epoch for r in self._record_requests([rec])}
        return rec

    def _sched_decoding(self) -> List[tuple]:
        """The slots this tick's decode dispatch takes (reference :2987):
        seated, not done, past prefill, and with budget left after the
        tokens in flight."""
        return [(i, r) for i, r in self._occupied()
                if not r.done() and not self._is_prefilling(r)
                and r.generated.shape[0] + r._pending_n < r.max_new_tokens]

    def _dispatch_oneshot(self, admitted) -> int:
        """The admissions' prefill, then the decode (reference :2996).
        A paged prefill's prompt pages enter the prefix cache at
        dispatch: a later reader's calls queue after its writes. Returns
        the tick's active count."""
        if admitted:
            self._ensure_state()
            try:
                self._slot_state, first = self._call_prefill(
                    self._slot_state, admitted)
            except _BatchDecodeFailed as e:
                with self._lock:
                    for i, r in admitted:
                        if self._slots[i] is r:
                            self._free_slot(i)
                self._isolate_slots([r for _, r in admitted], e)
                admitted = []
            else:
                for _, r in admitted:
                    r._pending_n += 1
                if self._paged:
                    self._cache_prefilled(admitted)
                self._pipe_items.append(("prefill", list(admitted), first))
                self._reap()
        decoding = self._sched_decoding()
        if decoding:
            self._dispatch_decode(decoding, {})
        return len(decoding) or len(admitted)

    def _dispatch_budgeted(self, admitted) -> int:
        """The chunked round (reference :3027): prefill chunks bought by
        the budget left after the decode bill, then the decode. Returns
        the tick's active count."""
        decoding0 = [(i, r) for i, r in self._occupied()
                     if not self._is_prefilling(r) and not r.done()]
        spent = self._advance_prefill(self._tick_budget
                                      - len(decoding0) * self._chunk)
        decoding = self._sched_decoding()
        if decoding:
            self._dispatch_decode(decoding, {"prefill_chunk": int(spent)})
        self._last_tick_spent = spent + len(decoding) * self._chunk
        return len(decoding) or len(admitted)

    def _dispatch_decode(self, decoding, data: dict) -> None:
        """A decode chunk, or a spec round (reference :3039): each slot's
        tokens of the chunk, min(chunk, its budget), go in flight.
        ``data`` rides on the commit's decode_chunk events; while
        `qos_control` has spec off the tick decodes plainly (reference
        :3040)."""
        if self._spec and not self._qos_spec_off and self._spec_tick():
            self._dispatch_spec(decoding, data)
            return
        try:
            self._slot_state, toks, rate = self._call_chunk(
                self._slot_state, decoding)
        except _BatchDecodeFailed as e:
            self._isolate_slots([r for _, r in decoding], e)
            return
        needs = []
        for _, r in decoding:
            n = min(self._chunk, r.max_new_tokens - r.generated.shape[0]
                    - r._pending_n)
            needs.append(n)
            r._pending_n += n
        self._pipe_items.append(("decode", list(decoding), toks, needs,
                                 rate, data))

    def _dispatch_spec(self, decoding, data: dict) -> None:
        """Schedule-ahead spec round (reference :3061): a round's commit
        count is known only after verification, so each slot reserves the
        worst case, K+1 tokens within its budget, as in flight; the
        commit releases what verification rejected. K is what the last
        commit decided (`_spec_update` runs at commit)."""
        k1 = self._spec_cur_k + 1
        try:
            self._slot_state, out, rate, poison = self._call_spec(
                self._slot_state, decoding)
        except _BatchDecodeFailed as e:
            self._isolate_slots([r for _, r in decoding], e)
            return
        reserved = []
        for i, r in decoding:
            n = min(k1, r.max_new_tokens - r.generated.shape[0]
                    - r._pending_n)
            reserved.append(n)
            r._pending_n += n
            r._pending_spec += n
            self._dev_pos[i] += n     # the commit corrects it by ncommit
        self._inc("spec_reserved", sum(reserved))
        self._pipe_items.append(("spec", list(decoding), out, reserved,
                                 rate, dict(data, step=self._step_counter
                                            - 1, poison=poison)))

    def _commit_tick(self, prev: _PendingTick) -> None:
        """A dispatched tick's items committed in dispatch order
        (reference :3096), pipelined behind the tick's one blocking wait
        (the synchronous loop waited at each call). A spec item releases
        its unused reservation and runs the adaptive-K controller here,
        so the next dispatch's K was decided at a commit."""
        if self._pipe:
            try:
                self._wait(prev.done)
            except RuntimeError as e:
                self._recover_failed_tick(prev, e)
                return
        ep = prev.epochs or {}

        def live(entries, counts):
            # an entry whose request was evicted (preempted or reloaded)
            # since the dispatch commits nothing and releases nothing:
            # its tokens in flight were dropped at the eviction
            keep = [(e, n) for e, n in zip(entries, counts)
                    if ep.get(id(e[1]), e[1]._epoch) == e[1]._epoch]
            return [e for e, _ in keep], [n for _, n in keep]

        for kind, entries, out, *rest in prev.items:
            # (a request isolated since the dispatch has no tokens in
            # flight any more and is done: its items commit nothing)
            out = out.numpy()
            if kind == "prefill":
                entries, _ = live(entries, [1] * len(entries))
                for _, r in entries:
                    r._pending_n = max(0, r._pending_n - 1)
                self._commit_first(entries, out)
            elif kind == "prefill_chunk":
                finished, _ = live(rest[0], [1] * len(rest[0]))
                for _, r in finished:
                    r._pending_n = max(0, r._pending_n - 1)
                self._commit_first(finished, out,
                                   prefill_chunk=self._prefill_chunk)
            elif kind == "decode":
                needs, rate, data = rest
                entries, needs = live(entries, needs)
                for (_, r), n in zip(entries, needs):
                    r._pending_n = max(0, r._pending_n - n)
                self._commit_decode(entries, out, needs, rate, data)
            else:
                reserved, rate, data = rest
                entries, reserved = live(entries, reserved)
                for (_, r), n in zip(entries, reserved):
                    r._pending_n = max(0, r._pending_n - n)
                    r._pending_spec = max(0, r._pending_spec - n)
                needs = self._commit_spec(entries, out, reserved, rate,
                                          data)
                if self._m_spec_waste is not None:
                    self._m_spec_waste.inc(sum(reserved) - sum(needs))

    # -- paged KV: host page bookkeeping (under self._lock) ----------------
    def _alloc_page(self) -> Optional[int]:
        """One private page, LRU-evicting unreferenced prefix-cache
        entries when the free list runs dry (reference :3460)."""
        p = self._allocator.alloc()
        if p is None and self._prefix_cache is not None:
            freed = self._prefix_cache.evict(1)
            if freed:
                self._m_prefix_evictions.inc(freed)
                p = self._allocator.alloc()
        return p

    def _seat_paged(self, i: int, r: RequestHandle) -> Optional[int]:
        """Build slot ``i``'s block table for ``r`` (reference :3471): map
        the longest cached chain of prompt pages (a refcount per sharer),
        allocate private pages for the rest and the decode budget, and
        copy the boundary page when a full-prefix hit must recompute the
        last token inside it. Returns the hit's token count, or None when
        the pool cannot cover the request (admission blocks); a request
        that could never be seated (no slot holds pages and eviction
        frees nothing) is shed instead, since waiting would deadlock."""
        self._ensure_state()
        prefix = np.concatenate([r.prompt, r.generated]).astype(np.int32)
        plen = int(prefix.shape[0])
        total = plen + (r.max_new_tokens - int(r.generated.shape[0]))
        need = pages_for(total, self._page_size)
        matched: List[int] = []
        if self._prefix_cache is not None:
            matched = self._prefix_cache.match(prefix)
        m = len(matched) * self._page_size
        cow_src = None
        if m >= plen:             # full-prefix hit: recompute the last
            m = plen - 1          # token in a copy of its page
            cow_src = matched[-1]
            matched = matched[:-1]
        # claim the shared chain before allocating the private tail, so
        # eviction cannot reap it meanwhile
        held = matched + ([cow_src] if cow_src is not None else [])
        for p in held:
            self._allocator.incref(p)
        fresh: List[int] = []
        for _ in range(need - len(matched)):
            p = self._alloc_page()
            if p is None:
                for q in fresh + held:
                    self._allocator.decref(q)
                if not any(self._slot_pages):
                    self._m_shed_overload.inc()
                    self._finish(r, RequestStatus.SHED, OverloadError(
                        f"request {r.rid} needs {need} KV pages; the pool "
                        f"cannot free enough "
                        f"({self._allocator.pages_free} free)"))
                return None
            fresh.append(p)
        pages = matched + fresh
        if cow_src is not None:
            # the copy exists before any write lands: the shared page
            # keeps serving its other readers
            self._copy_page(cow_src, pages[len(matched)])
            self._allocator.decref(cow_src)
        self._slot_pages[i] = pages
        self._bt[i, :] = 0
        self._bt[i, :len(pages)] = pages
        r._page_start = m
        if self._prefix_cache is not None:
            if m > 0:
                self._m_prefix_hits.inc()
                self._m_prefix_shared.inc(m)
            else:
                self._m_prefix_misses.inc()
        return m

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: physical page ``src`` into ``dst``, all layers,
        with its scale rows on a quantized pool (one-byte pages copied as
        their bytes)."""
        for plane in self._slot_state[:-2]:
            plane = raw(plane)
            plane[:, dst] = plane[:, src]
        self._inc("cow_copies")

    def _poison_page(self, pg: int) -> None:
        """Write an out-of-distribution pattern over physical page ``pg``'s
        K and V values in every layer, in place (1e3, or the byte 97 on a
        one-byte pool); the scale planes keep their values, as the
        reference's do (:1141)."""
        for plane in self._slot_state[:2]:
            plane = raw(plane)
            plane[:, pg] = 97 if plane.element_size() == 1 else 1e3

    def _maybe_corrupt_page(self, entries, span: Optional[int]) -> None:
        """The injector's ``corrupt_page_at`` hook (reference :4007): poison
        the named request's next-write page. It runs after the
        copy-on-write guard, so the page is the writer's own."""
        inj = self._injector
        if inj is None or not hasattr(inj, "check_corrupt_page"):
            return
        rid = inj.check_corrupt_page(self._step_counter)
        if rid is None:
            return
        for i, r in entries:
            if r.rid == rid and self._slot_pages[i]:
                lp = self._write_range(r, span)[0] // self._page_size
                lp = min(lp, len(self._slot_pages[i]) - 1)
                self._poison_page(self._slot_pages[i][lp])
                inj.pages_corrupted += 1
                log.warning("injected corruption: request %d slot %d page "
                            "%d poisoned", rid, i, self._slot_pages[i][lp])
                return

    def _release_slot_pages(self, i: int) -> None:
        self._allocator.release_chain(self._slot_pages[i])
        self._slot_pages[i] = []
        self._bt[i, :] = 0

    def _free_slot(self, i: int) -> None:
        """The one place a slot is vacated: a paged slot's pages go back
        to the refcount pool (pages the prefix cache or another slot
        still references live on)."""
        self._slots[i] = None
        if self._paged:
            self._release_slot_pages(i)

    def _write_range(self, r: RequestHandle, span: Optional[int]) -> tuple:
        """The logical positions [lo, hi) the next call writes for ``r``
        (reference :3943-3978): its prefill (``span`` None): one chunk
        from the resume point, or the part past the prefix hit; else a
        decode of ``span`` rows (a chunk, or a spec round's K+1 window)
        from the pending token's row, the last of the prefix scheduled so
        far (committed, and in flight in the pipelined loop). A spec
        round in flight commits 1 to its reservation of tokens, so where
        one is, the start is known only to within that reservation and
        the range widens to the union of every possible window."""
        plen = int(r.prompt.shape[0] + r.generated.shape[0] + r._pending_n)
        if span is None:
            if self._prefill_chunk is not None:
                return r._prefill_pos, min(r._prefill_pos
                                           + self._prefill_chunk,
                                           r._prefill_target)
            return r._page_start, plen
        lo = plen - 1 - max(0, r._pending_spec - 1)
        return lo, min(plen - 1 + span,
                       int(r.prompt.shape[0]) + r.max_new_tokens)

    def _ensure_writable(self, entries, span: Optional[int]) -> None:
        """Copy-on-write guard before every paged call that writes
        (reference :3980): a page backing an entry's write range that is
        still shared (refcount > 1) is copied to a fresh private page
        first, so no write lands on a page another slot or the prefix
        cache reads."""
        ps = self._page_size
        for i, r in entries:
            lo, hi = self._write_range(r, span)
            for lp in range(lo // ps, (hi - 1) // ps + 1 if hi > lo else 0):
                if lp >= len(self._slot_pages[i]):
                    continue
                p = self._slot_pages[i][lp]
                if self._allocator.refcount(p) > 1:
                    fresh = self._alloc_page()
                    if fresh is None:
                        raise RuntimeError(
                            f"copy-on-write for slot {i} page {lp}: page "
                            "pool exhausted")
                    self._copy_page(p, fresh)
                    self._allocator.decref(p)
                    self._slot_pages[i][lp] = fresh
                    self._bt[i, lp] = fresh

    def _cache_prefilled(self, entries) -> None:
        """After a paged prefill: each request's full prompt pages enter
        the radix cache (which then co-owns them), so the next request
        sharing the prefix maps them instead of recomputing (reference
        :4627). Decode pages are never cached."""
        if self._prefix_cache is None:
            return
        with self._lock:
            for i, r in entries:
                if self._slots[i] is not r or not self._slot_pages[i]:
                    continue
                self._prefix_cache.insert(np.asarray(r.prompt, np.int32),
                                          self._slot_pages[i])

    # -- speculative decoding (reference :4711-4944) -----------------------
    def _rebuild_draft(self) -> None:
        """Derive the drafter tree from the live params (reference
        :4711): "int8" / "fp8" quantize it, or share it when the live
        weights are already quantized."""
        (self._draft_params, self._draft_qmode,
         self._draft_layers) = draft_tree(self._params, self.config.draft,
                                          self.cfg, base_mode=self._qmode)

    def _spec_tick(self) -> bool:
        """Whether this tick decodes speculatively; counts down the
        plain-decode cooldown, probing with K=1 when it expires."""
        if self._spec_plain > 0:
            self._spec_plain -= 1
            if self._spec_plain == 0:
                self._spec_cur_k = 1
            return False
        return True

    def _spec_poison(self, entries) -> np.ndarray:
        """The injector's ``draft_poison_at`` hook (reference :4765): mark
        the named request's slot so the round derails its drafts on the
        device (the round's ``poison`` input: data, so a graph replays
        it)."""
        poison = np.zeros((self._num_slots,), bool)
        inj = self._injector
        if inj is None or not hasattr(inj, "check_draft_poison"):
            return poison
        rid = inj.check_draft_poison(self._step_counter)
        if rid is None:
            return poison
        for i, r in entries:
            if r.rid == rid:
                poison[i] = True
                inj.drafts_poisoned += 1
                log.warning("injected draft poison: request %d (slot %d) "
                            "at step %d", rid, i, self._step_counter)
        return poison

    def _call_spec(self, state, entries):
        """One speculative round over the pool for ``entries``; a paged
        pool first privatises every page the K+1 window can write.
        Returns (state', out [Ns, K+4] by `_host`: each row's window
        tokens, then its commit count, drafted and accepted, see
        `_spec_out`; the call's per-token rate; the round's ``poison``
        mask, `_spec_poison`)."""
        active, rem = self._active_rem(entries)
        poison = self._spec_poison(entries)
        k = self._spec_cur_k
        if self._paged:
            kind, lead = "paged_spec", (self._block_table(entries, k + 1),)
        else:
            kind, lead = "spec", ()

        def host_out(emit, nc, drafted, accepted):
            return self._host(torch.cat([emit, nc[:, None],
                                         drafted[:, None],
                                         accepted[:, None]], dim=1))

        state, out = self._run(
            kind, k, (self._params, self._draft_params), tuple(state),
            (*lead, *map(self._tensor, (active, rem, poison))),
            (self._dev_pos.copy(), (active & (rem > 0)).astype(np.int64)),
            [r for _, r in entries], host_out)
        rate = self._call_rate
        self._inc("spec_seconds", self._last_call_s)
        self._inc("spec_rounds")
        self._inc("spec_draft_steps", k)
        return state, out, rate, poison

    @staticmethod
    def _spec_out(out: np.ndarray):
        """(toks [Ns, K+1], ncommit, drafted, accepted) of a round's
        packed output."""
        return out[:, :-3], out[:, -3], out[:, -2], out[:, -1]

    def _commit_spec(self, entries, out, reserved, rate, data
                     ) -> List[int]:
        """A round's commit: each live entry's accepted prefix and
        correction token, its drafted / accepted counts (and a
        draft_rejected event when it accepted none, reference :3176),
        then the adaptive-K controller. Returns the tokens committed per
        entry."""
        toks, nc, drafted, accepted = self._spec_out(out)
        data = dict(data)
        step = data.pop("step")
        poison = data.pop("poison")
        needs = []
        for (i, r), n_res in zip(entries, reserved):
            # the device advanced the slot by its commit count: the
            # dispatch counted the whole reservation
            self._dev_pos[i] += int(nc[i]) - n_res
            need = 0
            if not r.done():
                d_i, a_i = int(drafted[i]), int(accepted[i])
                self._m_spec_drafted.inc(d_i)
                self._m_spec_accepted.inc(a_i)
                if d_i and a_i == 0:
                    self._observe("draft_rejected", r.trace.add,
                                  "draft_rejected", step=step, drafted=d_i,
                                  poisoned=bool(poison[i]))
                need = min(int(nc[i]),
                           r.max_new_tokens - r.generated.shape[0])
                need = self._commit_tokens(
                    r, toks[i, :need].astype(np.int32), "decode_chunk",
                    rate=rate, slot=i, drafted=d_i, accepted=a_i, **data)
            needs.append(need)
        self._inc("spec_committed", sum(needs))
        self._spec_update(entries, drafted, accepted, poison)
        return needs

    def _spec_update(self, occupied, drafted, accepted, poison) -> None:
        """Adaptive K over {spec_k, spec_k/2, .., 1}: per-slot acceptance
        EMAs (a drop takes effect at once, a recovery averages in) give a
        pool mean; below 0.2 K collapses to 1, and from 1 to plain decode
        for a cooldown; below 0.45 K halves; above 0.8 it doubles back
        (capped at spec_k). A poisoned round bypasses the EMA and falls
        straight back to K=1 (reference :4913)."""
        if bool(np.asarray(poison).any()):
            self._spec_cur_k = 1
            return
        if not self.config.spec_adaptive:
            return
        sampled = [i for i, _ in occupied if drafted[i] > 0]
        if not sampled:
            return
        for i in sampled:
            ratio = float(accepted[i]) / float(drafted[i])
            self._accept_ema[i] = min(
                ratio, 0.5 * self._accept_ema[i] + 0.5 * ratio)
        pool = float(np.mean([self._accept_ema[i] for i in sampled]))
        self._accept_pool = pool
        k = self._spec_cur_k
        if pool < 0.2:
            if k == 1:
                self._spec_plain = SPEC_PLAIN_COOLDOWN
            else:
                self._spec_cur_k = 1
        elif pool < 0.45 and k > 1:
            self._spec_cur_k = max(1, k // 2)
        elif pool > 0.8 and k < self._spec_k:
            self._spec_cur_k = min(self._spec_k, k * 2)

    def _commit_tokens(self, r: RequestHandle, toks: np.ndarray,
                       event: str, rate=None, **data) -> int:
        """The one place generated tokens land on a handle; a constrained
        request's pass the host's grammar walk first, and a terminal
        state completes it (grammar complete -> EOS, reference
        :2509-2548). Records ``event`` (prefill_done / decode_chunk)
        with ``data``, the first token's TTFT, and bills a decode's
        tokens at ``rate``. Returns the tokens committed."""
        first = not r._generated
        terminal = False
        if r._grammar is not None:
            toks, terminal = self._c_advance_commit(r, toks)
        r._generated.append(toks)
        self._observe("commit", self._trace_commit, r, int(toks.shape[0]),
                      event, first, rate, data)
        if terminal and not r.done():
            self._m_c_terminal.inc()
            self._observe("constraint", r.trace.add, "constraint",
                          terminal=True, state=int(r._cstate_host))
        if (terminal or r.generated.shape[0] >= r.max_new_tokens) and \
                not r.done():
            self._finish(r, RequestStatus.COMPLETED)
        return int(toks.shape[0])

    def _trace_commit(self, r: RequestHandle, n: int, event: str,
                      first: bool, rate, data) -> None:
        ev = r.trace.add(event, tokens=n, **data)
        if first:
            self.slo.first_token(r.trace, ev.ts)
        if event == "decode_chunk" and rate is not None:
            self.profiler.bill_tokens(r, None, n, "decode", rate)

    def _reap(self, shed: bool = False) -> None:
        """Free the slots whose request has all its tokens: committed,
        or, without spec, committed and in flight. A slot freed with
        tokens in flight is refilled by calls queued after the ones
        computing them, and its request still takes them at the commit;
        so the pipelined loop admits, and then schedules, as the
        synchronous loop does, tick for tick (the same prefill buckets and chunk plans:
        half-precision pools stay exact). A spec round's commit count is
        known only at its commit, so a spec engine frees there, as the
        reference does (:3268); so is a grammar's terminal state, which
        frees its slot a tick later than the synchronous loop does. With
        ``shed`` (a commit boundary) the cancelled and expired requests
        among the seated and those with tokens in flight are shed first
        (`_shed_expired`; reference :4946)."""
        if shed:
            live = self._in_flight_requests()
            if live:
                self._shed_expired(live)
        with self._lock:
            for i, r in enumerate(self._slots):
                # a held slot (hold_kv) stays seated until export_slot_kv
                # or release_held frees it (reference :4954)
                if r is not None and not r._hold_kv and (
                        r.done() or (not self._spec and
                                     r.generated.shape[0] + r._pending_n
                                     >= r.max_new_tokens)):
                    self._free_slot(i)

    def _in_flight_requests(self) -> List[RequestHandle]:
        """The seated requests, then those of the pending ticks' records,
        each once, in that order."""
        return self._record_requests(self._pending,
                                     [r for _, r in self._occupied()])

    @staticmethod
    def _record_requests(records, first=()) -> List[RequestHandle]:
        """``first``, then the requests of the dispatched ticks'
        ``records`` in item order (an entry's request is its second
        field), each once."""
        out = list(first)
        for rec in records:
            for it in rec.items:
                out += [ent[1] for ent in it[1]]
        return list({id(r): r for r in out}.values())

    # -- failure recovery (reference :3207-3246, :4967-5056) --------------
    def _recover_failed_tick(self, prev: _PendingTick, err) -> None:
        """A pipelined tick whose outputs failed at the commit's wait,
        after later ticks may have dispatched on them: every pending
        dispatch is dropped, the DFA states and seeds go back to what
        they were before the failed tick's dispatch (the seeds recorded
        since win), the prefix cache is flushed (pages inserted at
        dispatch may hold the failed call's rows), and every request of
        the dropped ticks is isolated: its solo re-run resumes from its
        committed prefix, the guarantee of a failure at the call. The
        slots kept were in none of the dropped calls, and a program
        changes only the state of the slots it runs, so no KV is
        restored."""
        log.warning("pipelined tick failed at its wait (%s); recovering "
                    "from the committed state", str(err))
        reqs = self._record_requests([prev, *self._pending])
        self._pending.clear()
        if prev.c_in_state is not None:
            cstate, seeds = prev.c_in_state
            self._cstate.copy_(cstate)
            merged = dict(seeds)
            merged.update(self._cseed_pending)
            self._cseed_pending = merged
        if self._prefix_cache is not None:
            with self._lock:
                flushed = self._prefix_cache.flush()
            if flushed:
                self._m_prefix_evictions.inc(flushed)
        self._isolate_slots(reqs, _BatchDecodeFailed(str(err)))

    def _isolate_slots(self, requests: List[RequestHandle],
                       err: BaseException) -> None:
        """A pool call exhausted its retries (or a pipelined tick failed
        at its wait): every implicated request is preempted (evicted from
        its slot) and re-run alone on a scratch pool from its committed
        prefix, synchronously, even inside a pipelined dispatch. A solo
        survivor completes; a solo failure is quarantined, so a poisoned
        request cannot take down its co-resident slots. A paged slot's
        pages go back to the refcount pool: pages another slot or the
        prefix cache still references live on. The scratch pool is
        allocated at the first re-run and dropped after the last. An
        error the guard does not take (the scratch pool's allocation
        running out of memory, say) quarantines the request being re-run
        and every one not yet reached, which are in no slot any more,
        before it propagates: every handle resolves."""
        log.warning("slot pool of %d exhausted retries (%s); isolating",
                    len(requests), str(err))
        with self._lock:
            implicated = set(id(r) for r in requests)
            for i, r in enumerate(self._slots):
                if r is not None and id(r) in implicated:
                    self._free_slot(i)
        for r in requests:
            # the tokens in flight died with the failed call or tick
            r._pending_n = r._pending_spec = 0
        k = 0
        try:
            for k, r in enumerate(requests):
                if r.status != RequestStatus.RUNNING or r.done():
                    continue
                self._m_preempted.inc()
                r.trace.add("preempted", reason="isolation")
                try:
                    self._run_isolated(r)
                except _BatchDecodeFailed as e:
                    self._quarantine(r, f"failed persistently: {e}")
        except Exception as e:
            for r in requests[k:]:
                if not r.done():
                    self._quarantine(r, f"could not be re-run alone: "
                                        f"{type(e).__name__}: {e}")
            raise
        finally:
            self._scratch = None

    def _quarantine(self, r: RequestHandle, why: str) -> None:
        self._m_quarantined.inc()
        log.error("request %d quarantined (%s)", r.rid, why)
        self._finish(r, RequestStatus.QUARANTINED,
                     RequestQuarantined(f"request {r.rid} {why}"))

    def _run_isolated(self, r: RequestHandle) -> None:
        """Solo re-run of ``r`` in slot 0 of the scratch pool, a contiguous
        pool of the live pool's slot count and KV mode (so the live
        programs' shapes serve it), run eagerly (the graphs hold the live
        pool) with a wait a call. A constrained engine swaps in a scratch
        DFA vector whose slot 0 is seeded from ``r``'s committed prefix;
        the live states, seeds and profiling positions are put back
        after."""
        if self._scratch is None:
            self._scratch = init_slot_state(self.cfg, self._num_slots,
                                            self.device,
                                            kv_mode=self._kv_mode)
            self.scratch_pool_bytes = sum(int(a.numel()) * a.element_size()
                                          for a in self._scratch)
        saved = (self._cstate, self._cseed_pending, self._dev_pos)
        if self._constrain_active:
            self._cstate = torch.zeros((self._num_slots,),
                                       dtype=torch.int32,
                                       device=self.device)
            self._cseed_pending = {0: self._c_state_for(r)}
        self._dev_pos = np.zeros_like(self._dev_pos)
        self._solo = True
        try:
            self._run_isolated_inner(r)
        finally:
            self._solo = False
            self._cstate, self._cseed_pending, self._dev_pos = saved

    def _run_isolated_inner(self, r: RequestHandle) -> None:
        """Re-prefill the committed prefix in one one-shot call, then
        decode chunks to the end (reference :5033). Sampling is keyed by
        position, so the continuation is the pooled run's."""
        state = self._scratch
        r.trace.add("admitted", slot=0, scratch=True, bucket=int(
            self._bucket_len(r.prompt.shape[0] + r.generated.shape[0])))
        self.slo.admitted(r.trace)
        state, first = self._call_prefill(state, [(0, r)], paged=False)
        self._commit_tokens(r, first.numpy()[:1].astype(np.int32),
                            "prefill_done", scratch=True)
        while True:
            self._shed_expired([r])
            if r.status != RequestStatus.RUNNING or r.done():
                return
            if r.generated.shape[0] >= r.max_new_tokens:
                self._finish(r, RequestStatus.COMPLETED)
                return
            state, toks, rate = self._call_chunk(state, [(0, r)],
                                                 paged=False)
            toks = toks.numpy()
            need = min(int(toks.shape[1]),
                       r.max_new_tokens - r.generated.shape[0])
            self._commit_tokens(r, toks[0, :need].astype(np.int32),
                                "decode_chunk", rate=rate, scratch=True)

    # -- warm-up (reference :4261-4397) ------------------------------------
    def warmup(self, buckets: Optional[Sequence[int]] = None) -> dict:
        """Resolve the engine's closed program set before traffic: the
        decode chunk (paged: the paged one), the spec ladder K, K/2, ..,
        1, the chunked prefill, and the admission bucket ladder
        (``buckets``, default every power-of-two scaling of
        ``prefill_bucket_min`` up to max_len; a one-shot engine's, paged
        or not). Each key is resolved (`_resolve`) and called once with
        every slot inactive, on the live pool (the port's first call is
        eager, and on the card the per-tick programs are captured right
        after it): an inactive slot's rows, ``pos``, ``tok`` and DFA
        state are written back unchanged, and a paged pool's inactive
        writes land on the scratch page 0, which no unmasked read sees.
        Returns {"seconds", "programs", "jit", "aot_cache", "aot"} (the
        resolutions by source, the compile cache's stats), also kept as
        `last_warmup`."""
        if not self._continuous:
            raise ValueError(
                "warmup requires mode='continuous' (batch-mode programs "
                "are shaped by per-call batch geometry)")
        with self._tick_mutex:
            t0 = _perf()
            before = self._compiles_by_source()
            self._ensure_state()
            pre = "paged_" if self._paged else ""
            keys = [(pre + "decode", self._chunk)]
            if self._spec:
                k = self._spec_k
                while True:
                    keys.append((pre + "spec", k))
                    if k == 1:
                        break
                    k = max(1, k // 2)
            if self._prefill_chunk is not None:
                keys.append((pre + "chunked_prefill", self._prefill_chunk))
            else:
                if buckets is None:
                    buckets, b = [], max(1, self.config.prefill_bucket_min)
                    while True:
                        buckets.append(min(b, self.cfg.max_len))
                        if b >= self.cfg.max_len:
                            break
                        b *= 2
                keys += [(pre + "prefill", tb)
                         for tb in dict.fromkeys(int(b) for b in buckets)]
            libs = {n: None for kind, _ in keys
                    for n in _LIBRARIES.get(kind, ())}
            if libs and self.device.type == "cuda":
                # one nvcc each, at once
                _build.ensure_built(*libs, cache=self._aot)
            for kind, size in keys:
                self._warm_call(kind, size)
            if self.device.type == "cuda":
                self._wait(None)
            after = self._compiles_by_source()
            report = {"seconds": round(_perf() - t0, 4),
                      "programs": len(keys),
                      **{s: after.get(s, 0) - before.get(s, 0)
                         for s in ("jit", "aot_cache")},
                      "aot": (self._aot.stats() if self._aot is not None
                              else None)}
            self._last_warmup = report
        log.info("engine warmup: %d program(s) in %.3fs (%d resolved "
                 "in-process, %d from the compile cache)",
                 report["programs"], report["seconds"], report["jit"],
                 report["aot_cache"])
        return report

    @property
    def last_warmup(self) -> Optional[dict]:
        return self._last_warmup

    def _warm_call(self, kind: str, size: int) -> None:
        """One call of (kind, size) with every slot inactive (see
        `warmup`), outside the guard: no injector hook, step or latency
        is recorded."""
        ns = self._num_slots
        paged = kind.startswith("paged_")
        base = kind.removeprefix("paged_")
        def z(dt, *rest):
            return np.zeros((ns,) + rest, dt)

        lead = ((self._params, self._draft_params) if base == "spec"
                else (self._params,))
        dyn = [self._bt.copy()] if paged else []
        if base == "decode":
            dyn += [z(bool), z(np.int32)]
        elif base == "spec":
            dyn += [z(bool), z(np.int32), z(bool)]
        elif base == "prefill":
            dyn += [z(np.int32, size), z(np.int32)]
            dyn += [z(np.int32)] if paged else []
        else:
            dyn += [z(np.int32, size), z(np.int32), z(np.int32), z(bool)]
        fixed = (*lead, *self._slot_state)
        if self._constrain_active:
            kind += "_c"
            fixed += (self._cstate, self._ctab.device(self.device))
            dyn += [z(bool), z(np.int32)]
        dyn = tuple(self._tensor(a) for a in dyn)
        fn = self._program(kind, size)
        seed = int(self.config.seed)
        try:
            if self._graphs is not None and kind in self._GRAPHED:
                self._graphs.call((kind, size), fn, fixed, dyn, seed)
            else:
                fn(*fixed, *dyn, seed)
        finally:
            self._resolved(kind, size)

    def _compiles_by_source(self) -> dict:
        """serving_compiles summed over programs by source (reference
        :5502)."""
        out: dict = {}
        for values, child in self._m_compiles.collect():
            out[values[1]] = out.get(values[1], 0) + int(child.value)
        return out

    # -- KV handoff: export and adopt (reference :3541-3911) ---------------
    def _flush_pipeline(self, reason: Optional[str] = None) -> None:
        """Commit every dispatched, uncommitted tick now (reference
        :3248): KV export reads committed state. With ``reason`` the wait
        is billed to serving_pipeline_flush_seconds{reason} and kept as
        debugz's ``tick_pipeline.last_flush``."""
        if not self._pending:
            return
        t0 = _perf()
        while self._pending:
            self._commit_tick(self._pending.popleft())
        if reason is not None:
            dt = _perf() - t0
            if self._m_flush_seconds is not None:
                self._m_flush_seconds.labels(reason).observe(dt)
            self._last_flush = {"reason": reason, "seconds": round(dt, 6)}

    def _to_host(self, tensors) -> List[torch.Tensor]:
        """Device tensors copied to host tensors behind one counted wait
        (the CPU's are the tensors themselves)."""
        if self.device.type != "cuda":
            return list(tensors)
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        self._wait(None)
        return out

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _handoff_bucket(self, npages: int) -> int:
        """The power-of-two page bucket of a handoff's gather or adopt
        (`quant.kv.handoff_page_bucket`; reference :3630)."""
        return handoff_page_bucket(npages, self._max_pages)

    def _page_index_vectors(self, pages: List[int], size: int):
        idx = np.zeros((size,), np.int32)
        idx[:len(pages)] = pages
        valid = np.zeros((size,), bool)
        valid[:len(pages)] = True
        return idx, valid

    def _gather_chain(self, pages: List[int], rows: int) -> list:
        """Rows [0, rows) of a page chain, every layer and plane (values,
        then scales), on the host: the bucketed gather program, then the
        copy (reference :3725-3740)."""
        nb = self._handoff_bucket(len(pages))
        idx, _ = self._page_index_vectors(pages[:nb], nb)
        fn = self._program("page_gather", nb)
        try:
            planes = fn(self._tensor(idx), *self._slot_state[:-2])
        finally:
            self._resolved("page_gather", nb)
        planes = self._to_host(planes)
        return [a.reshape(self.cfg.n_layers, -1, a.shape[-1])[:, :rows]
                .contiguous() for a in planes]

    def _handoff(self, pos: int, tok: int, planes, **kw) -> KVHandoff:
        q = self._kv_mode is not None
        return KVHandoff(pos=pos, tok=tok, k=planes[0], v=planes[1],
                         k_scale=planes[2] if q else None,
                         v_scale=planes[3] if q else None,
                         kv_mode=self._kv_mode, n_layers=self.cfg.n_layers,
                         d_model=self.cfg.d_model, **kw)

    def export_slot_kv(self, handle: RequestHandle,
                       release: bool = True) -> KVHandoff:
        """The committed KV of ``handle``'s slot (still seated: submitted
        with ``hold_kv=True``) on the host (reference :3689): K/V rows
        [0, pos) and, quantized, their scales, bit-exact slices of the
        live pool, through the page gather (paged) or the slot gather.
        A pipelined engine's pending tick commits first
        (`_flush_pipeline`). ``release`` frees the held slot afterwards,
        also when the export fails. Raises `HandoffError` when the
        request is not resident or still prefilling."""
        try:
            with self._tick_mutex:
                self._flush_pipeline(reason="export_slot_kv")
                with self._lock:
                    slot = next((i for i, r in enumerate(self._slots)
                                 if r is handle), None)
                    if slot is None:
                        raise HandoffError(
                            f"request {handle.rid} is not resident - "
                            "nothing to export (was it submitted with "
                            "hold_kv=True?)")
                    if self._is_prefilling(handle):
                        raise HandoffError(
                            f"request {handle.rid} is mid-prefill: its "
                            "KV rows are incomplete")
                    pages = (list(self._slot_pages[slot]) if self._paged
                             else None)
                state = self._slot_state
                pos, tok = (int(t[0]) for t in self._to_host(
                    (state[-2][slot:slot + 1], state[-1][slot:slot + 1])))
                if self._paged:
                    planes = self._gather_chain(pages, pos)
                else:
                    fn = self._program("slot_gather", 0)
                    try:
                        planes = fn(slot, pos, *state[:-2])
                    finally:
                        self._resolved("slot_gather", 0)
                    planes = self._to_host(planes)
            return self._handoff(pos, tok, planes)
        finally:
            if release:
                self.release_held(handle)

    def release_held(self, handle: RequestHandle) -> bool:
        """Free a slot held past completion by ``hold_kv=True``
        (idempotent; reference :3759): its pages go back to the refcount
        pool, the prefix cache keeping what it co-owns."""
        with self._lock:
            handle._hold_kv = False
            for i, r in enumerate(self._slots):
                if r is handle and r.done():
                    self._free_slot(i)
                    return True
        return False

    def committed_kv_pages(self, handle: RequestHandle) -> int:
        """KV pages ``handle``'s slot references (0 for a request not
        resident and on a contiguous pool; reference :3901)."""
        with self._lock:
            if not self._paged:
                return 0
            for i, r in enumerate(self._slots):
                if r is handle:
                    return len(self._slot_pages[i])
        return 0

    def _shed_handoff(self, r: RequestHandle, msg: str) -> None:
        """The typed handoff shed (reference :3543): shed{reason=
        "handoff"}, the adoption outcome "shed" and a HandoffError."""
        r._handoff_failed = True
        self._m_shed.labels("handoff").inc()
        if self._m_adoptions is not None:
            self._m_adoptions.labels("shed").inc()
        self._finish(r, RequestStatus.SHED, HandoffError(msg))

    def _adopt_rows(self, pages: List[int], kv: KVHandoff,
                    slot: int) -> None:
        """The handoff's rows (and scales) scattered into ``pages`` and
        the slot's pos / tok set, by one call of the bucketed adopt
        program (reference :3664). Pages past the committed prefix are
        left to decode, which writes a row before any read of it."""
        nb = self._handoff_bucket(pages_for(max(int(kv.pos), 1),
                                            self._page_size))
        rows = handoff_row_buffers(kv, self.cfg.n_layers, nb,
                                   self._page_size,
                                   self._slot_state[0].dtype)
        idx, valid = self._page_index_vectors(pages[:nb], nb)
        fn = self._program("kv_adopt", nb)
        try:
            fn(self._tensor(idx), self._tensor(valid), slot, int(kv.pos),
               int(kv.tok), *map(self._to_device, rows), *self._slot_state)
        finally:
            self._resolved("kv_adopt", nb)

    def _seat_adopted(self, i: int, r: RequestHandle) -> Optional[bool]:
        """Seat ``r`` in slot ``i`` by adopting its `KVHandoff` (under the
        lock; reference :3553): check that the handoff is exactly one
        pending token short of the committed prefix and ends in its last
        token, allocate the whole page chain of the prefix and the decode
        budget (all or none), scatter the rows and seat pos / tok. Returns
        True once seated; None when the pool cannot cover it (admission
        blocks at the queue head); False after shedding it typed
        ``handoff`` (misaligned, an injected adoption fault, a failed
        adopt call, or a pool that could never free enough), every page
        it claimed released first."""
        kv = r._kv
        self._ensure_state()
        prefix = np.concatenate([r.prompt, r.generated]).astype(np.int32)
        plen = int(prefix.shape[0])
        if (kv.pos != plen - 1 or int(kv.tok) != int(prefix[-1])
                or kv.k.shape[1] != kv.pos):
            self._shed_handoff(
                r, f"request {r.rid}: KV handoff misaligned (pos={kv.pos} "
                   f"rows={kv.k.shape[1]} vs committed prefix {plen}, "
                   f"tok={kv.tok} vs {int(prefix[-1])})")
            return False
        inj = self._injector
        if (inj is not None and hasattr(inj, "check_adopt")
                and inj.check_adopt(r.rid)):
            self._shed_handoff(r, f"request {r.rid}: injected adoption "
                                  "fault")
            return False
        total = plen + (r.max_new_tokens - int(r.generated.shape[0]))
        need = pages_for(total, self._page_size)
        fresh: List[int] = []
        for _ in range(need):
            p = self._alloc_page()
            if p is None:
                self._allocator.release_chain(fresh)
                if not any(self._slot_pages):
                    self._shed_handoff(
                        r, f"request {r.rid} needs {need} KV pages to "
                           f"adopt its handoff; the pool cannot free "
                           f"enough ({self._allocator.pages_free} free)")
                    return False
                self._m_adoptions.labels("blocked").inc()
                return None
            fresh.append(p)
        try:
            self._adopt_rows(fresh, kv, i)
        except Exception as e:
            self._allocator.release_chain(fresh)
            self._shed_handoff(r, f"request {r.rid}: KV adopt call "
                                  f"failed: {e}")
            return False
        self._slot_pages[i] = fresh
        self._bt[i, :] = 0
        self._bt[i, :len(fresh)] = fresh
        r._page_start = plen - 1
        r._kv = None
        self._m_adoptions.labels("ok").inc()
        if self._prefix_cache is not None and kv.pos > 0:
            # the adopted rows are complete KV: their full pages join the
            # cache, a co-owner by refcount, as after a prefill
            self._prefix_cache.insert(prefix[:kv.pos], fresh)
        return True

    def export_cached_chain(self, chain_hash: int) -> Optional[KVHandoff]:
        """A radix prefix-cache chain, by its advertised chain hash, on
        the host (reference :3772): a ``source="cache"`` handoff with its
        rows, token ids and this engine's weights step; None when the
        chain is no longer cached, the pool was never allocated, or the
        engine has no prefix cache."""
        if not (self._continuous and self._paged
                and self._prefix_cache is not None):
            return None
        with self._tick_mutex:
            self._flush_pipeline(reason="export_cached_chain")
            with self._lock:
                node = self._prefix_cache.node_for_hash(chain_hash)
                if node is None or self._slot_state is None:
                    return None
                pages = self._prefix_cache.chain_pages(node)
                tokens = self._prefix_cache.chain_tokens(node)
                pos = len(pages) * self._page_size
                planes = self._gather_chain(pages, pos)
        return self._handoff(pos, int(tokens[-1]), planes, source="cache",
                             tokens=tokens, weights_step=self._weights_step)

    def _seed_cached_chain(self, kv: KVHandoff) -> bool:
        """Adopt a ``source="cache"`` handoff into the radix prefix cache
        (under the lock; reference :3816): fresh pages for the chain (all
        or none), the rows scattered by the pool-only adopt program (no
        slot's pos / tok is touched), then tokens -> pages inserted, so
        the next admission sharing the prefix maps them as a hit. Every
        failure returns False with nothing claimed: that request just
        prefills."""
        cache = self._prefix_cache
        ps = self._page_size
        npages = kv.pos // ps
        tokens = (np.asarray(kv.tokens, np.int32)
                  if kv.tokens is not None else None)
        if (cache is None or tokens is None or npages < 1
                or kv.pos % ps != 0 or int(tokens.shape[0]) != kv.pos
                or kv.k.shape[1] != kv.pos):
            self._m_adoptions.labels("seed_failed").inc()
            return False
        if kv.weights_step != self._weights_step:
            # cached K/V encodes the weights that wrote it
            log.warning("cache-chain seed refused: exporter weights step "
                        "%s vs local %s", kv.weights_step,
                        self._weights_step)
            self._m_adoptions.labels("seed_failed").inc()
            return False
        self._ensure_state()
        pages: List[int] = []
        for _ in range(npages):
            p = self._alloc_page()
            if p is None:
                self._allocator.release_chain(pages)
                self._m_adoptions.labels("seed_failed").inc()
                return False
            pages.append(p)
        try:
            nb = self._handoff_bucket(npages)
            rows = handoff_row_buffers(kv, self.cfg.n_layers, nb, ps,
                                       self._slot_state[0].dtype)
            idx, valid = self._page_index_vectors(pages, nb)
            fn = self._program("chain_adopt", nb)
            try:
                fn(self._tensor(idx), self._tensor(valid),
                   *map(self._to_device, rows), *self._slot_state[:-2])
            finally:
                self._resolved("chain_adopt", nb)
        except Exception as e:
            self._allocator.release_chain(pages)
            self._m_adoptions.labels("seed_failed").inc()
            log.warning("cache-chain seed scatter failed: %s", e)
            return False
        cache.insert(tokens, pages)
        # the cache co-owns what it took; pages of chunks it already had
        # just go back
        self._allocator.release_chain(pages)
        self._m_adoptions.labels("seeded").inc()
        return True

    def seed_cached_chain(self, kv: KVHandoff) -> bool:
        """Adopt a ``source="cache"`` handoff (decoded off the wire or
        exported by a peer) into this engine's prefix cache (reference
        :3876); False, nothing claimed, where the engine cannot hold
        chains or the seed fails."""
        if not (self._continuous and self._paged
                and self._prefix_cache is not None):
            return False
        with self._tick_mutex, self._lock:
            return self._seed_cached_chain(kv)

    def set_advertised_chains(self, hashes) -> int:
        """The chain hashes a fleet advertises (reference :3889): the
        prefix cache's LRU eviction passes over them while it can.
        Returns the set's size (0 without a prefix cache)."""
        if self._prefix_cache is None:
            return 0
        with self._lock:
            return self._prefix_cache.set_advertised(hashes)

    # -- hot weight reload (reference :5523-5606) --------------------------
    def reload_weights(self, source, step: Optional[int] = None) -> int:
        """Swap in the weights of checkpoint step ``step`` (None: the
        newest step that verifies, falling back past a corrupt or torn
        one) from ``source``, a `util.checkpointing.CheckpointManager` or
        a checkpoint directory in the npz layout, without draining.
        Each step is checksum-verified, then restored against the float
        template (the live tree, or a quantized engine's float template,
        which then quantizes it again). The swap waits for the running
        tick (a batch finishes on the weights it started with) and, under
        the lock, evicts every in-flight request back to the head of the
        queue with its committed tokens, flushes the prefix cache (its
        KV encodes the old weights) and drops the CUDA graphs (they hold
        the old tree); the drafter is rebuilt from the new tree. Returns
        the step loaded; raises FileNotFoundError for a directory without
        steps and RuntimeError when no step reads."""
        mgr = (source if isinstance(source, CheckpointManager)
               else CheckpointManager(str(source)))
        steps = ([int(step)] if step is not None
                 else list(reversed(mgr.all_steps())))
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint steps under {mgr.directory}")
        last_err: Optional[BaseException] = None
        for s in steps:
            try:
                # a torn step (zip-valid, wrong bytes) never swaps in
                if not mgr.verify_step(s):
                    raise RuntimeError(
                        f"step {s} failed checksum verification")
                template = (self._float_template if self._qmode
                            else self._params)
                tree = mgr.restore_tree(template, step=s,
                                        device=self.device)
            except Exception as e:           # corrupt / partial step
                last_err = e
                log.warning("weight reload: step %s unreadable (%s); "
                            "falling back", s, e)
                continue
            if tree is None:
                continue
            if self._qmode:
                tree = quantize_params(tree, mode=self._qmode)
            with self._tick_mutex:
                self._swap_weights(tree, int(s))
            log.info("weights hot-reloaded from step %d", int(s))
            return int(s)
        raise RuntimeError(
            f"no readable checkpoint step under {mgr.directory}"
        ) from last_err

    def _swap_weights(self, tree, step: int) -> None:
        """The reload's swap, between ticks: the new tree in, every
        in-flight request evicted, the prefix cache flushed, the graphs
        dropped (after the device has run what was queued on them), the
        drafter and the profiler's tree bytes rebuilt."""
        if self._graphs is not None and self._graphs.keys():
            self._wait(None)
            self._graphs = SlotGraphs(self.device, self._m_graph_captures,
                                      self._m_graph_replays,
                                      self._m_graph_pool_bytes)
            self._m_graph_pool_bytes.set(0.0)
        with self._lock:
            self._params = tree
            self._weights_step = step
            preempted = self._evict_all_locked()
            if self._prefix_cache is not None:
                flushed = self._prefix_cache.flush()
                if flushed:
                    self._m_prefix_evictions.inc(flushed)
                    log.info("weight reload flushed %d prefix-cache "
                             "entries", flushed)
        if self._spec:
            self._rebuild_draft()
        if self.profiler.enabled:
            self._wbytes = tree_bytes(self._params, self.cfg)
            if self._spec:
                self._dbytes = tree_bytes(self._draft_params, self.cfg)
        if preempted:
            self._m_preempted.inc(preempted)
            log.info("weight reload preempted %d in-flight request(s); "
                     "requeued for re-prefill", preempted)
        self._m_reloads.inc()

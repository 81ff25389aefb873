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
``pages_used`` / ``pages_free`` (refreshed after every tick) and
``shed_overload`` (requests shed because the pool could never seat
them).

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
and of the pool (analytic, as the reference's gauges, which wait for the
metrics port, ROADMAP queue A item 8). Hot reload with requantization
waits for reload (item 9).

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
pool in place). Not ported with it: the recovery of a tick that fails at
its wait and the in-flight state snapshot it restores (ROADMAP queue A
item 9), the forced flush of KV export (items 9, 11), the batch-mode
fallback (batch mode is unported), and the pipeline's metrics (item 8).

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

Not ported yet (set to a non-default value, each raises
NotImplementedError naming its ROADMAP item): batch mode, the background
worker, retries / circuit breaker / deadlines, KV handoff and adoption,
the fault injector, the compile cache and warm-up, QoS (so fair-share
prefill), and the metrics / recorder / profiler stack.

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
``constrained_table_rows`` (the reference's ``serving_constrained_*``
series wait for ROADMAP item 8). In the pipelined loop a grammar's
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
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import (TransformerConfig,
                                                         _check_slice,
                                                         params_to)
from deeplearning4j_tpu_torch.parallel.serving import (
    init_paged_state, init_slot_state, make_chunked_prefill,
    make_continuous_decode, make_continuous_prefill,
    make_paged_chunked_prefill, make_paged_decode, make_paged_prefill,
    make_paged_speculative_decode, make_speculative_decode)
from deeplearning4j_tpu_torch.quant.core import raw, resolve_mode
from deeplearning4j_tpu_torch.quant.kv import (paged_pool_bytes,
                                               slot_pool_bytes)
from deeplearning4j_tpu_torch.quant.model import (draft_tree, param_bytes,
                                                  quantize_params)
from deeplearning4j_tpu_torch.serving.constrain import (ConstraintError,
                                                        ConstraintTable,
                                                        compile_grammar,
                                                        normalize_constraint)
from deeplearning4j_tpu_torch.serving.graphs import SlotGraphs
from deeplearning4j_tpu_torch.serving.paging import (PageAllocator,
                                                     RadixPrefixCache,
                                                     pages_for)


class OverloadError(RuntimeError):
    """Admission rejected: the queue is full."""


class RequestStatus:
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    SHED = "shed"


DEFAULT_CONTINUOUS_CHUNK = 8

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
    (``pipeline``) and the grammar-constraint table bound
    (``constrain_state_cap``: rows of the [cap, V] allow / transition
    table, cap x V x 5 bytes on the device). Every other field must keep
    its default (see `_UNPORTED`, `_check_config`)."""
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
    program_cache_size: int = 64
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


# unported EngineConfig fields -> the ROADMAP item that ports them
_UNPORTED = {
    "mode": "batch mode (ROADMAP queue A6)",
    "batch_timeout_s": "the background worker (ROADMAP queue A6)",
    "max_retries": "retries and the circuit breaker (ROADMAP queue A6)",
    "backoff_base_s": "retries and the circuit breaker (ROADMAP queue A6)",
    "backoff_max_s": "retries and the circuit breaker (ROADMAP queue A6)",
    "breaker_failure_threshold":
        "retries and the circuit breaker (ROADMAP queue A6)",
    "breaker_cooldown_s":
        "retries and the circuit breaker (ROADMAP queue A6)",
    "program_cache_size": "the compile cache (ROADMAP queue A6)",
    "compile_cache_dir": "the compile cache (ROADMAP queue A6)",
    "warmup_on_init": "the compile cache (ROADMAP queue A6)",
    "recorder_capacity": "metrics and the flight recorder (ROADMAP A8)",
    "profile_dir": "metrics and the flight recorder (ROADMAP A8)",
    "tenant_top_n": "metrics and the flight recorder (ROADMAP A8)",
    "tenant_weights": "tenant QoS (ROADMAP queue A6)",
    "qos_default_weight": "tenant QoS (ROADMAP queue A6)",
    "preemption_budget": "tenant QoS (ROADMAP queue A6)",
}


# what paged KV and chunked prefill do not combine with yet -> the ROADMAP
# queue A item that ports it (checked before `_UNPORTED`, so the error
# names the combination)
_PAGED_CHUNKED_TODO = {
    "tenant_weights": "fair-share prefill (ROADMAP queue A item 9)",
}

# the rejection reasons of a constrained submit the port can raise
# (the reference's "mode" needs batch mode, which is unported)
_C_REASONS = ("unsupported", "invalid", "oversize", "empty")


def _check_config(config: EngineConfig) -> None:
    uses = [name for name, on in (("paged", config.paged),
                                  ("prefill_chunk",
                                   config.prefill_chunk is not None))
            if on]
    defaults = {f.name: f.default for f in fields(EngineConfig)}
    for name, todo in _PAGED_CHUNKED_TODO.items():
        value = getattr(config, name)
        if uses and value != defaults[name]:
            raise NotImplementedError(
                f"EngineConfig.{uses[0]}={getattr(config, uses[0])!r} with "
                f"{name}={value!r}: {todo} is not ported yet")
    for f in fields(EngineConfig):
        if f.name in _UNPORTED and getattr(config, f.name) != f.default:
            raise NotImplementedError(
                f"EngineConfig.{f.name}={getattr(config, f.name)!r}: "
                f"{_UNPORTED[f.name]} is not ported yet")


class RequestHandle:
    """Caller-facing future for one submitted prompt."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new
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
        terminal error of a shed request."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt, self.generated])

    def _finish(self, status: str,
                error: Optional[BaseException] = None) -> None:
        self.status = status
        self.error = error
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
    the CPU and in the synchronous loop)."""
    items: list
    done: Optional[object]


class InferenceEngine:
    """Slot-pool continuous-batching engine over `parallel.serving`.

    ``params`` is a port parameter tree (`models.transformer.init_params`
    or `models.convert.params_from_numpy`); it is moved to ``device``,
    which is CUDA unless ``device="cpu"``."""

    def __init__(self, cfg: TransformerConfig, params,
                 config: Optional[EngineConfig] = None, device=None):
        _check_slice(cfg)
        self.cfg = cfg
        self.config = config or EngineConfig()
        _check_config(self.config)
        self.device = resolve_device(device)
        # quantization (reference :1407-1430): both modes resolve against
        # the device; the weight tree is quantized on load
        self._qmode = resolve_mode(self.config.quantize, self.device)
        self._kv_mode = resolve_mode(self.config.kv_quantize, self.device)
        self._params = params_to(params, self.device)
        if self._qmode:
            self._params = quantize_params(self._params, mode=self._qmode)
        self._num_slots = self.config.num_slots or self.config.max_batch_size
        self._chunk = (self.config.decode_chunk
                       if self.config.decode_chunk > 0
                       else DEFAULT_CONTINUOUS_CHUNK)
        # chunked prefill and the token-budget scheduler (reference
        # :1273-1297): None keeps the one-shot admission prefill
        self._prefill_chunk = self.config.prefill_chunk
        if self._prefill_chunk is not None:
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
        # paged KV and the radix prefix cache (reference :1445-1471): page
        # indices are host-owned, the block table reaches every call as
        # data, so sharing, copy-on-write and recycling never change a
        # program's geometry
        self._paged = bool(self.config.paged)
        self._prefix_cache = None
        if self._paged:
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
        self._programs: Dict[Tuple[str, int], object] = {}
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._rids = itertools.count(1)
        # call counters, and host seconds by call kind (see the module
        # docstring for what each loop times)
        self.counts = {"prefill_calls": 0, "decode_chunks": 0,
                       "spec_rounds": 0, "spec_draft_steps": 0,
                       "spec_drafted": 0, "spec_accepted": 0,
                       "spec_reserved": 0, "spec_released": 0,
                       "spec_committed": 0,
                       "prefill_chunks": 0,
                       "prefix_hits": 0, "prefix_misses": 0,
                       "prefix_shared_tokens": 0, "prefix_evictions": 0,
                       "cow_copies": 0, "pages_used": 0, "pages_free": 0,
                       "shed_overload": 0, "syncs": 0, "pipelined_ticks": 0,
                       "constrained_requests": 0,
                       **{f"constrained_rejected_{r}": 0
                          for r in _C_REASONS},
                       "constrained_grammar_compiles": 0,
                       "constrained_terminal": 0, "constrained_illegal": 0,
                       "constrained_table_rows": 0}
        self.seconds = {"prefill": 0.0, "decode": 0.0, "spec": 0.0,
                        "wait": 0.0}
        # the pipelined loop (reference :1345-1375): at most one tick in
        # flight; _pipe_items collects a tick's commit items while it
        # dispatches
        self._pipe = bool(self.config.pipeline)
        self._pending: deque = deque()
        self._pipe_items: list = []
        # on the card the per-tick slot programs replay as CUDA graphs
        self._graphs = (SlotGraphs(self.device, self.counts)
                        if self.device.type == "cuda" else None)
        # at-rest bytes of the weight tree and of the pool (analytic: the
        # pool is allocated at the first admission)
        self.counts["param_bytes"] = param_bytes(self._params)
        if self._paged:
            self.counts["kv_pool_bytes"] = paged_pool_bytes(
                cfg, self._num_slots, self._page_size, self._num_pages,
                self._max_pages, kv_mode=self._kv_mode)
        else:
            self.counts["kv_pool_bytes"] = slot_pool_bytes(
                cfg, self._num_slots, kv_mode=self._kv_mode)
        self._page_counts()
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

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               constrain=None) -> RequestHandle:
        """Admit one prompt. Raises OverloadError when the queue is full;
        past ``degrade_queue_depth`` queued requests the token budget is
        capped at ``degraded_max_new_tokens`` (reference :2123-2127). A
        paged engine refuses a request that needs more pages than its
        pool holds. ``constrain`` (a regex, or a spec dict of
        `serving.constrain.normalize_constraint`, whose ``consumed``
        counts prompt-tail tokens the grammar already read) restricts
        the output to the grammar; a spec that cannot be served raises
        ConstraintError here (reference :2030-2070, :2145-2180)."""
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
        with self._lock:
            if len(self._queue) >= self.config.max_queue:
                raise OverloadError(f"queue full ({self.config.max_queue})")
            cap = (self.config.degraded_max_new_tokens
                   if len(self._queue) >= self.config.degrade_queue_depth
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
            handle = RequestHandle(next(self._rids), prompt, eff)
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
                    self.counts["constrained_grammar_compiles"] += 1
                self.counts["constrained_requests"] += 1
                self.counts["constrained_table_rows"] = self._ctab.rows_used
                handle._grammar = grammar
                handle._cinit = handle._cstate_host = cstart
            self._queue.append(handle)
        return handle

    # -- grammar constraints (reference :1841-1935) ------------------------
    def _compile_constraint(self, prompt: np.ndarray, constrain):
        """(grammar, start state) of a ``constrain`` spec: compiled
        against the vocabulary under the table bound, with its
        ``consumed`` prompt tail replayed (which validates it); raises
        ConstraintError."""
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
        key = f"constrained_rejected_{e.reason}"
        self.counts[key] = self.counts.get(key, 0) + 1

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
                self.counts["constrained_illegal"] += 1
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
        the room; reference :2230)."""
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
        (reference :2319)."""
        with self._lock:
            return (not self._queue and not self._pending
                    and all(r is None for r in self._slots))

    def tick(self) -> bool:
        """One scheduling round: admit into free slots, dispatch the
        tick's calls (`_dispatch_tick`: one-shot, one prefill over the
        pool and one decode chunk for every decoding slot; chunked, the
        token-budget round), then commit. The synchronous loop waits for
        each call's output as it dispatches it and commits this tick; the
        pipelined loop commits the previous tick behind one wait (see the
        module docstring). Returns whether any work was done."""
        admitted = self._fill_slots()
        pending = self._dispatch_tick(admitted)
        prev = pending
        if self._pipe:
            prev = self._pending.popleft() if self._pending else None
            if pending is not None:
                self._pending.append(pending)
        if prev is not None:
            self._commit_tick(prev)
        self._reap()
        self._page_counts()
        busy = bool(admitted) or pending is not None or prev is not None
        if busy and self._pipe:
            self.counts["pipelined_ticks"] += 1
        return busy

    def _fill_slots(self) -> List[tuple]:
        """Seat queued requests into free slots, FIFO (reference
        `_fill_slots`, :3268). A paged engine maps each request's cached
        prefix and allocates its private pages first (`_seat_paged`);
        when the pool cannot cover it the request goes back to the head
        of the queue and admission stops for this tick. Returns
        [(slot, handle)]."""
        admitted = []
        with self._lock:
            free = deque(i for i in range(self._num_slots)
                         if self._slots[i] is None)
            while free and self._queue:
                r = self._queue.popleft()
                i = free[0]
                hit = 0
                if self._paged:
                    hit = self._seat_paged(i, r)
                    if hit is None:
                        if not r.done():      # blocked, not shed
                            self._queue.appendleft(r)
                        break
                free.popleft()
                self._slots[i] = r
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
                admitted.append((i, r))
        return admitted

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

    def _program(self, kind: str, size: int):
        """The slot program of ``kind`` (a `_MAKERS` key, or one with
        ``"_c"`` appended for its masked variant) at ``size`` (bucket or
        chunk length, decode chunk or K), made once per key. An engine
        has one pool, so its KV mode is fixed; a quantized weight tree
        needs no program of its own (it dequantizes at each use)."""
        key = (kind, size)
        fn = self._programs.get(key)
        if fn is None:
            c = self.config
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
            self._programs[key] = fn
        return fn

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

    def _run(self, kind: str, size: int, fixed: tuple, dyn: tuple) -> tuple:
        """``program(*fixed, *dyn, seed)`` for the slot program (kind,
        size): ``fixed`` the weight trees and the pool, ``dyn`` the
        call's tensors. On the card a per-tick program replays its CUDA
        graph (`serving.graphs`). A constraint-active engine runs the
        masked program instead, with the DFA states and the table added
        to ``fixed`` and the pending seeds to ``dyn``; the seeds it took
        retire after the call (`_cmask_begin` / `_cmask_commit`, JAX
        :1901-1935: a seed recorded since stays for the next call)."""
        taken = None
        if self._constrain_active:
            kind += "_c"
            fixed += (self._cstate, self._ctab.device(self.device))
            taken, seeds = self._cmask_begin()
            dyn += seeds
        fn = self._program(kind, size)
        seed = int(self.config.seed)
        if self._graphs is not None and kind in self._GRAPHED:
            out = self._graphs.call((kind, size), fn, fixed, dyn, seed)
        else:
            out = fn(*fixed, *dyn, seed)
        if taken is None:
            return out
        self._cmask_commit(taken)
        npool = len(self._slot_state)
        return (*out[:npool], *out[npool + 1:])

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
        (`_commit_tick`). The synchronous loop waits for it here, one
        blocking wait a call; the pipelined loop at the commit."""
        if t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        if not self._pipe:
            self._wait(None)
        return t

    def _wait(self, done) -> None:
        """The blocking device wait: on event ``done``, or (None) on all
        work queued so far. Counted in ``counts["syncs"]``, its time in
        ``seconds["wait"]``."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if done is None:
                torch.cuda.current_stream(self.device).synchronize()
            else:
                done.synchronize()
        self.seconds["wait"] += time.perf_counter() - t0
        self.counts["syncs"] += 1

    def _block_table(self, entries, span: Optional[int]) -> torch.Tensor:
        """Before a paged call that writes: privatise the shared pages in
        ``entries``' write ranges, then the block table on the device."""
        with self._lock:
            self._ensure_writable(entries, span)
            return self._tensor(self._bt.copy())

    def _call_prefill(self, state, entries):
        """One admission prefill over ``state`` for ``entries``
        [(slot, handle)]: each committed prefix right-padded to the
        bucket; on a paged pool only the part past the prefix-cache hit
        (reference :4512). Returns (state', first tokens [Ns], `_host`)."""
        starts = {i: (r._page_start if self._paged else 0)
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
        if self._paged:
            bt = self._block_table(entries, None)
            kind, lead, tail_args = "paged_prefill", (bt,), (start,)
        else:
            kind, lead, tail_args = "prefill", (), ()
        t0 = time.perf_counter()
        *state, first = self._run(
            kind, tb, (self._params, *state),
            (*lead, *map(self._tensor, (prompts, plen, *tail_args))))
        first = self._host(first)
        self.seconds["prefill"] += time.perf_counter() - t0
        self.counts["prefill_calls"] += 1
        return tuple(state), first

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

    def _call_chunk(self, state, entries):
        """One decode chunk over ``state`` for the occupied ``entries``;
        per-slot budgets ride as ``rem``, so a slot finishing mid-chunk
        stops on the device. Returns (state', toks [Ns, chunk],
        `_host`)."""
        active, rem = self._active_rem(entries)
        if self._paged:
            kind, lead = "paged_decode", (self._block_table(entries,
                                                            self._chunk),)
        else:
            kind, lead = "decode", ()
        t0 = time.perf_counter()
        *state, toks = self._run(
            kind, self._chunk, (self._params, *state),
            (*lead, self._tensor(active), self._tensor(rem)))
        toks = self._host(toks)
        self.seconds["decode"] += time.perf_counter() - t0
        self.counts["decode_chunks"] += 1
        return tuple(state), toks

    def _commit_first(self, entries, first) -> None:
        """Each live entry's first generated token (a one-shot prefill's
        or a last prefill chunk's)."""
        for i, r in entries:
            if not r.done():
                self._commit_tokens(r, first[i:i + 1].astype(np.int32))

    def _commit_decode(self, entries, toks, needs) -> None:
        """A decode chunk's tokens: ``needs[j]`` of entry j's row."""
        for (i, r), n in zip(entries, needs):
            if n > 0 and not r.done():
                self._commit_tokens(r, toks[i, :n].astype(np.int32))

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
        so prefill never starves. Returns the tokens spent."""
        spent = 0
        floor_used = False
        while True:
            prefilling = sorted(
                ((i, r) for i, r in self._occupied()
                 if self._is_prefilling(r) and not r.done()),
                key=lambda e: e[1]._seat_seq)
            if not prefilling:
                break
            rem = budget - spent
            if rem < 1:
                if spent > 0 or floor_used:
                    break
                floor_used = True
                rem = self._prefill_chunk
                prefilling = prefilling[:1]
            plan = []
            for i, r in prefilling:
                if rem < 1:
                    break
                n = min(self._prefill_chunk,
                        r._prefill_target - r._prefill_pos, rem)
                plan.append((i, r, n))
                rem -= n
            self._prefill_chunk_call(plan)
            spent += sum(n for _, _, n in plan)
        return spent

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
        t0 = time.perf_counter()
        *state, first = self._run(
            kind, c, (self._params, *self._slot_state),
            (*lead, *map(self._tensor, (toks, clen, start, last))))
        first = self._host(first)
        self.seconds["prefill"] += time.perf_counter() - t0
        self.counts["prefill_calls"] += 1
        self._slot_state = tuple(state)
        finished = []
        for i, r, n in plan:
            r._prefill_pos += n
            self.counts["prefill_chunks"] += 1
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
        self._pipe_items = []
        try:
            if self._prefill_chunk is not None:
                self._dispatch_budgeted(admitted)
            else:
                self._dispatch_oneshot(admitted)
        finally:
            items, self._pipe_items = self._pipe_items, []
        if not items:
            return None
        done = None
        if self._pipe and self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return _PendingTick(items, done)

    def _sched_decoding(self) -> List[tuple]:
        """The slots this tick's decode dispatch takes (reference :2987):
        seated, not done, past prefill, and with budget left after the
        tokens in flight."""
        return [(i, r) for i, r in self._occupied()
                if not r.done() and not self._is_prefilling(r)
                and r.generated.shape[0] + r._pending_n < r.max_new_tokens]

    def _dispatch_oneshot(self, admitted) -> None:
        """The admissions' prefill, then the decode (reference :2996).
        A paged prefill's prompt pages enter the prefix cache at
        dispatch: a later reader's calls queue after its writes."""
        if admitted:
            self._ensure_state()
            self._slot_state, first = self._call_prefill(self._slot_state,
                                                         admitted)
            for _, r in admitted:
                r._pending_n += 1
            if self._paged:
                self._cache_prefilled(admitted)
            self._pipe_items.append(("prefill", list(admitted), first))
            self._reap()
        decoding = self._sched_decoding()
        if decoding:
            self._dispatch_decode(decoding)

    def _dispatch_budgeted(self, admitted) -> None:
        """The chunked round (reference :3027): prefill chunks bought by
        the budget left after the decode bill, then the decode."""
        decoding0 = [(i, r) for i, r in self._occupied()
                     if not self._is_prefilling(r)]
        self._advance_prefill(self._tick_budget
                              - len(decoding0) * self._chunk)
        decoding = self._sched_decoding()
        if decoding:
            self._dispatch_decode(decoding)

    def _dispatch_decode(self, decoding) -> None:
        """A decode chunk, or a spec round (reference :3039): each slot's
        tokens of the chunk, min(chunk, its budget), go in flight."""
        if self._spec and self._spec_tick():
            self._dispatch_spec(decoding)
            return
        self._slot_state, toks = self._call_chunk(self._slot_state,
                                                  decoding)
        needs = []
        for _, r in decoding:
            n = min(self._chunk, r.max_new_tokens - r.generated.shape[0]
                    - r._pending_n)
            needs.append(n)
            r._pending_n += n
        self._pipe_items.append(("decode", list(decoding), toks, needs))

    def _dispatch_spec(self, decoding) -> None:
        """Schedule-ahead spec round (reference :3061): a round's commit
        count is known only after verification, so each slot reserves the
        worst case, K+1 tokens within its budget, as in flight; the
        commit releases what verification rejected. K is what the last
        commit decided (`_spec_update` runs at commit)."""
        k1 = self._spec_cur_k + 1
        self._slot_state, out = self._call_spec(self._slot_state, decoding)
        reserved = []
        for _, r in decoding:
            n = min(k1, r.max_new_tokens - r.generated.shape[0]
                    - r._pending_n)
            reserved.append(n)
            r._pending_n += n
            r._pending_spec += n
        self.counts["spec_reserved"] += sum(reserved)
        self._pipe_items.append(("spec", list(decoding), out, reserved))

    def _commit_tick(self, prev: _PendingTick) -> None:
        """A dispatched tick's items committed in dispatch order
        (reference :3096), pipelined behind the tick's one blocking wait
        (the synchronous loop waited at each call). A spec item releases
        its unused reservation and runs the adaptive-K controller here,
        so the next dispatch's K was decided at a commit."""
        if self._pipe:
            self._wait(prev.done)
        for kind, entries, out, *rest in prev.items:
            out = out.numpy()
            if kind == "prefill":
                for _, r in entries:
                    r._pending_n -= 1
                self._commit_first(entries, out)
            elif kind == "prefill_chunk":
                finished = rest[0]
                for _, r in finished:
                    r._pending_n -= 1
                self._commit_first(finished, out)
            elif kind == "decode":
                needs = rest[0]
                for (_, r), n in zip(entries, needs):
                    r._pending_n -= n
                self._commit_decode(entries, out, needs)
            else:
                reserved = rest[0]
                for (_, r), n in zip(entries, reserved):
                    r._pending_n -= n
                    r._pending_spec -= n
                needs = self._commit_spec(entries, out)
                self.counts["spec_released"] += sum(reserved) - sum(needs)

    # -- paged KV: host page bookkeeping (under self._lock) ----------------
    def _alloc_page(self) -> Optional[int]:
        """One private page, LRU-evicting unreferenced prefix-cache
        entries when the free list runs dry (reference :3460)."""
        p = self._allocator.alloc()
        if p is None and self._prefix_cache is not None:
            freed = self._prefix_cache.evict(1)
            if freed:
                self.counts["prefix_evictions"] += freed
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
                    self.counts["shed_overload"] += 1
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
                self.counts["prefix_hits"] += 1
                self.counts["prefix_shared_tokens"] += m
            else:
                self.counts["prefix_misses"] += 1
        return m

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: physical page ``src`` into ``dst``, all layers,
        with its scale rows on a quantized pool (one-byte pages copied as
        their bytes)."""
        for plane in self._slot_state[:-2]:
            plane = raw(plane)
            plane[:, dst] = plane[:, src]
        self.counts["cow_copies"] += 1

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

    def _page_counts(self) -> None:
        if self._paged:
            self.counts["pages_used"] = self._allocator.pages_used
            self.counts["pages_free"] = self._allocator.pages_free

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

    def _call_spec(self, state, entries):
        """One speculative round over the pool for ``entries``; a paged
        pool first privatises every page the K+1 window can write.
        Returns (state', out [Ns, K+4] by `_host`): each row's window
        tokens, then its commit count, drafted and accepted (see
        `_spec_out`). ``poison`` stays all false: the fault injector's
        draft_poison_at hook, and with it the controller's poisoned-round
        fallback to K=1, are not ported (ROADMAP queue A6)."""
        active, rem = self._active_rem(entries)
        poison = np.zeros((self._num_slots,), bool)
        k = self._spec_cur_k
        if self._paged:
            kind, lead = "paged_spec", (self._block_table(entries, k + 1),)
        else:
            kind, lead = "spec", ()
        t0 = time.perf_counter()
        *state, emit, nc, drafted, accepted = self._run(
            kind, k, (self._params, self._draft_params, *state),
            (*lead, *map(self._tensor, (active, rem, poison))))
        out = self._host(torch.cat([emit, nc[:, None], drafted[:, None],
                                    accepted[:, None]], dim=1))
        self.seconds["spec"] += time.perf_counter() - t0
        self.counts["spec_rounds"] += 1
        self.counts["spec_draft_steps"] += k
        return tuple(state), out

    @staticmethod
    def _spec_out(out: np.ndarray):
        """(toks [Ns, K+1], ncommit, drafted, accepted) of a round's
        packed output."""
        return out[:, :-3], out[:, -3], out[:, -2], out[:, -1]

    def _commit_spec(self, entries, out) -> List[int]:
        """A round's commit: each live entry's accepted prefix and
        correction token, its drafted / accepted counts, then the
        adaptive-K controller. Returns the tokens committed per entry."""
        toks, nc, drafted, accepted = self._spec_out(out)
        needs = []
        for i, r in entries:
            need = 0
            if not r.done():
                self.counts["spec_drafted"] += int(drafted[i])
                self.counts["spec_accepted"] += int(accepted[i])
                need = min(int(nc[i]),
                           r.max_new_tokens - r.generated.shape[0])
                need = self._commit_tokens(r, toks[i, :need].astype(
                    np.int32))
            needs.append(need)
        self.counts["spec_committed"] += sum(needs)
        self._spec_update(entries, drafted, accepted)
        return needs

    def _spec_update(self, occupied, drafted, accepted) -> None:
        """Adaptive K over {spec_k, spec_k/2, .., 1}: per-slot acceptance
        EMAs (a drop takes effect at once, a recovery averages in) give a
        pool mean; below 0.2 K collapses to 1, and from 1 to plain decode
        for a cooldown; below 0.45 K halves; above 0.8 it doubles back
        (capped at spec_k)."""
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

    def _commit_tokens(self, r: RequestHandle, toks: np.ndarray) -> int:
        """The one place generated tokens land on a handle; a constrained
        request's pass the host's grammar walk first, and a terminal
        state completes it (grammar complete -> EOS, reference
        :2509-2548). Returns the tokens committed."""
        terminal = False
        if r._grammar is not None:
            toks, terminal = self._c_advance_commit(r, toks)
        r._generated.append(toks)
        if terminal and not r.done():
            self.counts["constrained_terminal"] += 1
        if (terminal or r.generated.shape[0] >= r.max_new_tokens) and \
                not r.done():
            self._finish(r, RequestStatus.COMPLETED)
        return int(toks.shape[0])

    def _reap(self) -> None:
        """Free the slots whose request has all its tokens: committed,
        or, without spec, committed and in flight. A slot freed with
        tokens in flight is refilled by calls queued after the ones
        computing them, and its request still takes them at the commit;
        so the pipelined loop admits, and then schedules, as the
        synchronous loop does, tick for tick (the same prefill buckets and chunk plans:
        half-precision pools stay exact). A spec round's commit count is
        known only at its commit, so a spec engine frees there, as the
        reference does (:3268); so is a grammar's terminal state, which
        frees its slot a tick later than the synchronous loop does."""
        with self._lock:
            for i, r in enumerate(self._slots):
                if r is not None and (
                        r.done() or (not self._spec and
                                     r.generated.shape[0] + r._pending_n
                                     >= r.max_new_tokens)):
                    self._free_slot(i)

"""Continuous-batching inference engine (synchronous) on one device.

Port of the continuous, synchronous subset of
deeplearning4j_tpu/serving/engine.py. Callers `submit()` prompts, drive
the engine with `run_pending()` (or `tick()` by tick) on their own
thread, and read `RequestHandle.result()`.

Each tick (reference `_tick_continuous`, :2550): free slots are filled
from the queue in FIFO order, the admitted prompts run through ONE
prefill over the whole slot pool (prompts right-padded to a power-of-two
bucket, `_bucket_len`), then every occupied slot advances one decode
chunk of ``decode_chunk`` tokens through the slot programs of
`parallel.serving`. Tokens commit on the host after each call; a slot
frees as soon as its request has its ``max_new_tokens``, and the next
tick refills it. Sampling draws are keyed by sequence position, so a
request's tokens do not depend on its slot, its neighbours or the chunk
size.

Not ported yet (set to a non-default value, each raises
NotImplementedError naming its ROADMAP item): batch mode, the background
worker, retries / circuit breaker / deadlines, quantized weights and KV,
paged KV and the prefix cache, the quantized drafter, chunked prefill,
the compile cache and warm-up, the pipelined tick loop, QoS, grammar
constraints, and the metrics / recorder / profiler stack. The port's
`pipeline` default is False: it runs the synchronous loop, which the
reference documents as bit-identical to its pipelined one.

Speculative decoding (``EngineConfig(spec_decode=True, spec_k=K,
draft="self" | "layers:N")``, reference :4711-4944): a tick's decode
phase runs one speculative round instead of a decode chunk, committing
1..K+1 tokens per slot, token-identical to the plain engine. The
adaptive-K controller walks K over {spec_k, spec_k/2, .., 1} on the
pool's acceptance and falls back to plain decode chunks for a cooldown
when even K=1 does not pay. ``counts["spec_rounds"/"spec_drafted"/
"spec_accepted"]`` and `spec_k_current` expose it.
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
    init_slot_state, make_continuous_decode, make_continuous_prefill,
    make_speculative_decode)
from deeplearning4j_tpu_torch.quant.model import draft_tree


class OverloadError(RuntimeError):
    """Admission rejected: the queue is full."""


class RequestStatus:
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"


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
    (``degrade_queue_depth``, ``degraded_max_new_tokens``) and
    speculative decoding (``spec_decode``, ``spec_k``, ``spec_adaptive``,
    ``draft`` = "self" or "layers:N"; the default "int8" drafter is not
    ported and raises). Every other field must keep its default (see
    `_UNPORTED`)."""
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
    pipeline: bool = False
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
    "quantize": "quantized serving (ROADMAP queues A4 and A6)",
    "kv_quantize": "quantized serving (ROADMAP queues A4 and A6)",
    "paged": "paged KV serving (ROADMAP queue A6)",
    "page_size": "paged KV serving (ROADMAP queue A6)",
    "kv_pages": "paged KV serving (ROADMAP queue A6)",
    "prefix_cache": "paged KV serving (ROADMAP queue A6)",
    "prefill_chunk": "chunked prefill (ROADMAP queue A6)",
    "tick_token_budget": "chunked prefill (ROADMAP queue A6)",
    "program_cache_size": "the compile cache (ROADMAP queue A6)",
    "compile_cache_dir": "the compile cache (ROADMAP queue A6)",
    "warmup_on_init": "the compile cache (ROADMAP queue A6)",
    "pipeline": "the pipelined tick loop (ROADMAP queue A6)",
    "recorder_capacity": "metrics and the flight recorder (ROADMAP A8)",
    "profile_dir": "metrics and the flight recorder (ROADMAP A8)",
    "tenant_top_n": "metrics and the flight recorder (ROADMAP A8)",
    "tenant_weights": "tenant QoS (ROADMAP queue A6)",
    "qos_default_weight": "tenant QoS (ROADMAP queue A6)",
    "preemption_budget": "tenant QoS (ROADMAP queue A6)",
    "constrain_state_cap": "grammar constraints (ROADMAP queue A6)",
}


def _check_config(config: EngineConfig) -> None:
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
        self._generated: List[np.ndarray] = []
        self._done = threading.Event()

    @property
    def generated(self) -> np.ndarray:
        """Tokens decoded so far (may be partial)."""
        if not self._generated:
            return np.zeros((0,), np.int32)
        return np.concatenate(self._generated)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Full sequence [T0 + generated] (generate's layout)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        return np.concatenate([self.prompt, self.generated])

    def _finish(self, status: str) -> None:
        self.status = status
        self._done.set()


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
        self._params = params_to(params, self.device)
        self._num_slots = self.config.num_slots or self.config.max_batch_size
        self._chunk = (self.config.decode_chunk
                       if self.config.decode_chunk > 0
                       else DEFAULT_CONTINUOUS_CHUNK)
        self._slots: List[Optional[RequestHandle]] = \
            [None] * self._num_slots
        self._slot_state = None
        self._programs: Dict[Tuple[str, int], object] = {}
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._rids = itertools.count(1)
        # call counters, and host seconds spent in each kind of call (a
        # call ends in a device->host copy of its tokens, so the time
        # includes the device work)
        self.counts = {"prefill_calls": 0, "decode_chunks": 0,
                       "spec_rounds": 0, "spec_drafted": 0,
                       "spec_accepted": 0}
        self.seconds = {"prefill": 0.0, "decode": 0.0, "spec": 0.0}
        # speculative decoding (reference :1477-1504): the drafter comes
        # from the live params; acceptance drives the adaptive-K
        # controller (`_spec_update`)
        self._spec = bool(self.config.spec_decode)
        if self._spec:
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

    # -- admission -------------------------------------------------------
    def submit(self, prompt,
               max_new_tokens: Optional[int] = None) -> RequestHandle:
        """Admit one prompt. Raises OverloadError when the queue is full;
        past ``degrade_queue_depth`` queued requests the token budget is
        capped at ``degraded_max_new_tokens`` (reference :2123-2127)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            # an out-of-range id would fault the device-side gather
            raise ValueError(f"prompt token ids must be in "
                             f"[0, {self.cfg.vocab_size})")
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
            handle = RequestHandle(next(self._rids), prompt, eff)
            self._queue.append(handle)
        return handle

    # -- driving ---------------------------------------------------------
    def run_pending(self) -> int:
        """Tick until the queue and the slot pool are drained; returns
        the number of ticks run."""
        n = 0
        while self.tick():
            n += 1
        return n

    def tick(self) -> bool:
        """One scheduling round: admit into free slots (one prefill over
        the pool), then advance every occupied slot one decode chunk.
        Returns whether any work was done."""
        admitted = self._fill_slots()
        if admitted:
            self._prefill_slots(admitted)
        occupied = [(i, r) for i, r in self._occupied() if not r.done()]
        if occupied:
            self._decode_chunk_slots(occupied)
            self._reap()
        return bool(admitted or occupied)

    def _fill_slots(self) -> List[tuple]:
        """Seat queued requests into free slots, FIFO (reference
        `_fill_slots`, :3268). Returns [(slot, handle)]."""
        admitted = []
        with self._lock:
            free = deque(i for i in range(self._num_slots)
                         if self._slots[i] is None)
            while free and self._queue:
                r = self._queue.popleft()
                i = free.popleft()
                self._slots[i] = r
                if self._spec:
                    # seat with the pool's current belief (reference
                    # :3348-3353): a stream of fresh admissions must not
                    # drag the EMA back up under adversarial traffic
                    self._accept_ema[i] = self._accept_pool
                r.status = RequestStatus.RUNNING
                admitted.append((i, r))
        return admitted

    def _occupied(self) -> List[tuple]:
        with self._lock:
            return [(i, r) for i, r in enumerate(self._slots)
                    if r is not None]

    def _ensure_state(self) -> None:
        if self._slot_state is None:
            self._slot_state = init_slot_state(self.cfg, self._num_slots,
                                               self.device)

    def _bucket_len(self, need: int) -> int:
        """Prefill bucket: the smallest power-of-two scaling of
        prefill_bucket_min that covers ``need``, capped at max_len."""
        b = max(1, self.config.prefill_bucket_min)
        while b < need:
            b *= 2
        return min(b, self.cfg.max_len)

    def _program(self, kind: str, size: int):
        """The slot program of ``kind`` ("prefill", "decode" or "spec")
        at ``size`` (bucket length, chunk or K), made once per key."""
        key = (kind, size)
        fn = self._programs.get(key)
        if fn is None:
            c = self.config
            sampling = (float(c.temperature), int(c.top_k), float(c.top_p))
            if kind == "spec":
                fn = make_speculative_decode(
                    self.cfg, size, self._num_slots, *sampling,
                    draft_layers=self._draft_layers)
            else:
                make = (make_continuous_prefill if kind == "prefill"
                        else make_continuous_decode)
                fn = make(self.cfg, size, self._num_slots, *sampling)
            self._programs[key] = fn
        return fn

    def _call_prefill(self, state, entries):
        """One admission prefill over ``state`` for ``entries``
        [(slot, handle)]: each committed prefix right-padded to the
        bucket. Returns (state', first_tokens numpy [Ns])."""
        prefixes = {i: np.concatenate([r.prompt, r.generated]
                                      ).astype(np.int32)
                    for i, r in entries}
        tb = self._bucket_len(max(p.shape[0] for p in prefixes.values()))
        prompts = np.zeros((self._num_slots, tb), np.int32)
        plen = np.zeros((self._num_slots,), np.int32)
        for i, pre in prefixes.items():
            prompts[i, :pre.shape[0]] = pre
            plen[i] = pre.shape[0]
        fn = self._program("prefill", tb)
        t0 = time.perf_counter()
        ck, cv, pos, tok, first = fn(
            self._params, *state,
            torch.from_numpy(prompts).to(self.device),
            torch.from_numpy(plen).to(self.device), int(self.config.seed))
        first = first.cpu().numpy()
        self.seconds["prefill"] += time.perf_counter() - t0
        self.counts["prefill_calls"] += 1
        return (ck, cv, pos, tok), first

    def _call_chunk(self, state, entries):
        """One decode chunk over ``state`` for the occupied ``entries``;
        per-slot budgets ride as ``rem``, so a slot finishing mid-chunk
        stops on the device. Returns (state', toks numpy [Ns, chunk])."""
        active = np.zeros((self._num_slots,), bool)
        rem = np.zeros((self._num_slots,), np.int32)
        for i, r in entries:
            active[i] = True
            rem[i] = r.max_new_tokens - r.generated.shape[0]
        fn = self._program("decode", self._chunk)
        t0 = time.perf_counter()
        ck, cv, pos, tok, toks = fn(
            self._params, *state, torch.from_numpy(active).to(self.device),
            torch.from_numpy(rem).to(self.device), int(self.config.seed))
        toks = toks.cpu().numpy()
        self.seconds["decode"] += time.perf_counter() - t0
        self.counts["decode_chunks"] += 1
        return (ck, cv, pos, tok), toks

    def _prefill_slots(self, admitted) -> None:
        self._ensure_state()
        self._slot_state, first = self._call_prefill(self._slot_state,
                                                     admitted)
        for i, r in admitted:
            self._commit_tokens(r, np.asarray([first[i]], np.int32))
        self._reap()

    def _decode_chunk_slots(self, occupied) -> None:
        if self._spec and self._spec_tick():
            self._decode_spec_slots(occupied)
            return
        self._slot_state, toks = self._call_chunk(self._slot_state,
                                                  occupied)
        for i, r in occupied:
            need = min(int(toks.shape[1]),
                       r.max_new_tokens - r.generated.shape[0])
            self._commit_tokens(r, toks[i, :need].astype(np.int32))

    # -- speculative decoding (reference :4711-4944) -----------------------
    def _rebuild_draft(self) -> None:
        """Derive the drafter tree from the live params."""
        self._draft_params, _, self._draft_layers = draft_tree(
            self._params, self.config.draft, self.cfg)

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
        """One speculative round over the pool for ``entries``. Returns
        (state', toks [Ns, K+1], ncommit, drafted, accepted) with numpy
        outputs. ``poison`` stays all false: the fault injector's
        draft_poison_at hook, and with it the controller's poisoned-round
        fallback to K=1, are not ported (ROADMAP queue A6)."""
        active = np.zeros((self._num_slots,), bool)
        rem = np.zeros((self._num_slots,), np.int32)
        for i, r in entries:
            active[i] = True
            rem[i] = r.max_new_tokens - r.generated.shape[0]
        poison = np.zeros((self._num_slots,), bool)
        fn = self._program("spec", self._spec_cur_k)
        dev = self.device
        t0 = time.perf_counter()
        ck, cv, pos, tok, emit, nc, drafted, accepted = fn(
            self._params, self._draft_params, *state,
            torch.from_numpy(active).to(dev), torch.from_numpy(rem).to(dev),
            torch.from_numpy(poison).to(dev), int(self.config.seed))
        out = torch.stack([nc, drafted, accepted]).cpu().numpy()
        toks = emit.cpu().numpy()
        self.seconds["spec"] += time.perf_counter() - t0
        self.counts["spec_rounds"] += 1
        return (ck, cv, pos, tok), toks, out[0], out[1], out[2]

    def _decode_spec_slots(self, occupied) -> None:
        """One speculative round: commit each slot's accepted prefix and
        correction token (1..K+1 tokens), then feed the acceptance to the
        adaptive-K controller."""
        self._slot_state, toks, nc, drafted, accepted = self._call_spec(
            self._slot_state, occupied)
        for i, r in occupied:
            self.counts["spec_drafted"] += int(drafted[i])
            self.counts["spec_accepted"] += int(accepted[i])
            need = min(int(nc[i]), r.max_new_tokens - r.generated.shape[0])
            self._commit_tokens(r, toks[i, :need].astype(np.int32))
        self._spec_update(occupied, drafted, accepted)

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

    def _commit_tokens(self, r: RequestHandle, toks: np.ndarray) -> None:
        """The one place generated tokens land on a handle."""
        r._generated.append(toks)
        if r.generated.shape[0] >= r.max_new_tokens and not r.done():
            r._finish(RequestStatus.COMPLETED)

    def _reap(self) -> None:
        """Free the slots whose request is done."""
        with self._lock:
            for i, r in enumerate(self._slots):
                if r is not None and r.done():
                    self._slots[i] = None

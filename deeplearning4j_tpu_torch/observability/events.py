"""Per-request flight recorder: typed lifecycle events in a ring buffer.

The metrics layer (observability/metrics.py) answers *how much* —
counts, rates, latency distributions — but when ONE request is slow or
shed, aggregates explain nothing. The flight recorder is the other
half: every request carries a `RequestTrace` of typed,
monotonically-timestamped lifecycle events
(``submit → queued → admitted{slot,bucket} → prefill_done →
decode_chunk{tokens}* → finished`` on the happy path; ``retry``,
``preempted``, ``quarantined``, ``shed{reason}`` on the others), and a
`FlightRecorder` keeps the last N events of the whole engine in a
bounded thread-safe ring — the raw material for `/debugz`, the SLO
layer (observability/slo.py), and the Perfetto timeline export
(observability/timeline.py).

Design constraints, mirroring the metrics substrate:

- **Near-zero hot-path cost.** Recording one event is a perf_counter
  read, a tuple construction, and two GIL-atomic appends (~1 µs); the
  engine adds a handful per request per chunk against
  milliseconds-to-seconds of compiled decode. `NULL_RECORDER` /
  `NULL_TRACE` mirror `NULL_REGISTRY`: disabling is injection, not
  if-guards — the "off" arm of the `engine_slo` benchmark.
- **Bounded memory.** The global ring is a `deque(maxlen=capacity)`;
  per-request traces are bounded by the request's own lifetime
  (≤ max_new_tokens/chunk decode events) and die with the handle.
- **Monotonic timestamps.** `time.perf_counter`, never `time.time` —
  event deltas survive wall-clock steps; exports re-base to t=0.
- **Typed kinds.** An unknown kind raises: two subsystems silently
  inventing dialects is the drift this catches (the same reason
  `MetricsRegistry` hard-errors on kind mismatch).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

_now = time.perf_counter

#: The request-lifecycle event vocabulary (docs/observability.md has
#: the per-kind payload schema). Engine code MUST use these exact
#: names; `RequestTrace.add` rejects anything else.
EVENT_KINDS = frozenset({
    "submit",        # handle created, admission checks passed
    "queued",        # appended to the bounded admission queue
    "admitted",      # seated: {slot, bucket} (continuous) /
    #                  {batch_size} (batch mode) / {scratch: True}
    #                  (solo isolation re-run); chunked-prefill
    #                  engines add {prefill_chunk}
    "prefill_done",  # prompt prefilled, first token committed {tokens}
    "decode_chunk",  # one decode chunk committed {tokens, slot}
    #                  (speculative engines add {drafted, accepted};
    #                  chunked-prefill engines add {prefill_chunk} —
    #                  prompt tokens co-scheduled in the same tick)
    "draft_rejected",  # a speculative round's drafts were ALL
    #                  rejected by verification {step, drafted,
    #                  poisoned} — the forensic marker for injected
    #                  draft poisoning and for adaptive-K backoff
    "preempted",     # evicted from its slot {reason: isolation|
    #                  reload|priority} — priority preemptions add
    #                  {by: preemptor rid, slot}
    "qos",           # QoS control-plane action (rid 0, fleet-wide):
    #                  admission rejection {action: reject, tenant,
    #                  reason: rate|concurrency} or an overload-
    #                  controller transition {action: degrade|restore,
    #                  level, step: spec_off|chunk_shrink|shed_low|
    #                  none} — the degradation ladder's audit trail
    "dispatched",    # fleet router: handed to a replica {replica,
    #                  hedge} — the router-hop span opener
    "failover",      # fleet router: re-dispatched onto a survivor
    #                  after a replica loss {from, to, committed}
    "hedge",         # fleet router: hedged pair resolved {winner,
    #                  loser, outcome: primary_won|hedge_won}
    "handoff",       # tiered router: committed prefill KV moved from
    #                  a prefill-tier replica toward a decode-tier
    #                  one {from, tokens, outcome: ok|fallback|failed}
    #                  — outcome "fallback"/"failed" means the decode
    #                  dispatch re-prefills instead
    "autoscale",     # tiered router (rid 0, fleet-wide): a tier's
    #                  replica count changed {tier, direction: up|down,
    #                  replicas} — the occupancy-driven policy's
    #                  audit trail
    "kv_migration",  # fleet router: a cached prefix chain moved
    #                  across replicas ahead of a dispatch {from, to,
    #                  tokens, bytes, outcome: ok|stale|failed} —
    #                  "stale" means the advertised chain was evicted
    #                  before export, "failed" an export error; both
    #                  degrade to a normal prefill.
    #                  Proactive pushes at autoscale-up add
    #                  {proactive: True}
    "kvwire",        # KV wire transport: one kvwire frame
    #                  crossed (or failed to cross) a process boundary
    #                  {direction: export|adopt|seed|control, outcome:
    #                  ok|magic|version|crc|truncated|type|error,
    #                  bytes, seconds} — every failure outcome
    #                  degrades to the re-prefill path, never a lost
    #                  request
    "elastic",       # elastic training membership/sync transition
    #                  (rid 0, fleet-wide): {action: join|
    #                  leave|kill_detected|resize|replay|loose_enter|
    #                  resync|evict, worker, step, ...} — the elastic
    #                  coordinator's audit trail (resize adds
    #                  {workers, reason}; loose_enter/resync add
    #                  {pending}; replay adds {from_step, to_step})
    "constraint",    # grammar-constrained decoding: the
    #                  request's DFA reached a terminal accepting
    #                  state {terminal: True, state} — the EOS-forcing
    #                  audit mark; only constrained requests ever
    #                  record it, so constrain-off traces are
    #                  byte-unchanged
    "retry",         # a compiled call containing it failed and is
    #                  being retried {step, attempt, prefill}
    "quarantined",   # terminal: failed persistently after solo retries
    "finished",      # terminal: completed {tokens, partial}
    "shed",          # terminal: rejected/abandoned {reason}
})

#: Terminal kinds — exactly one of these ends a complete trace.
TERMINAL_KINDS = frozenset({"finished", "shed", "quarantined"})


class Event(NamedTuple):
    """One lifecycle event: monotonic timestamp, kind, request id, and
    a small JSON-serializable payload dict."""
    ts: float
    kind: str
    rid: int
    data: dict

    def as_dict(self) -> dict:
        return {"ts": self.ts, "kind": self.kind, "rid": self.rid,
                **self.data}


class RequestTrace:
    """The per-request event list, exposed as `RequestHandle.trace`.

    `add()` stamps the event once and appends it to BOTH this trace
    and the owning recorder's ring, so the per-request view and the
    engine-wide view can never disagree.

    ``ctx`` is the distributed-tracing hop context: a small
    dict (``{"fleet_rid": ..., "hop": ..., "tier": ...}``) stamped by
    a fleet router at dispatch and merged into EVERY event this trace
    records, so a replica's local ring events stay attributable to the
    fleet request that caused them — the raw material
    `observability/stitch.py` reassembles into one distributed trace.
    Explicit per-event data wins over ctx keys on collision."""

    __slots__ = ("rid", "ctx", "_recorder", "_events", "_lock")

    def __init__(self, rid: int, recorder: "FlightRecorder" = None,
                 ctx: Optional[dict] = None):
        self.rid = int(rid)
        self.ctx = dict(ctx) if ctx else None
        self._recorder = recorder
        self._events: List[Event] = []
        self._lock = threading.Lock()

    def add(self, kind: str, **data) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; "
                             f"valid: {sorted(EVENT_KINDS)}")
        if self.ctx:
            data = {**self.ctx, **data}
        rec = self._recorder
        ev = Event(rec.now() if rec is not None else _now(),
                   kind, self.rid, data)
        with self._lock:
            self._events.append(ev)
        if rec is not None:
            rec._push(ev)
        return ev

    @property
    def events(self) -> Tuple[Event, ...]:
        with self._lock:
            return tuple(self._events)

    def kinds(self) -> List[str]:
        return [e.kind for e in self.events]

    def first_ts(self, kind: str) -> Optional[float]:
        for e in self.events:
            if e.kind == kind:
                return e.ts
        return None

    def last_ts(self, kind: str) -> Optional[float]:
        ts = None
        for e in self.events:
            if e.kind == kind:
                ts = e.ts
        return ts

    def complete(self) -> bool:
        """True when the trace reached a terminal event."""
        evs = self.events
        return bool(evs) and evs[-1].kind in TERMINAL_KINDS

    def as_dicts(self) -> List[dict]:
        return [e.as_dict() for e in self.events]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class FlightRecorder:
    """Thread-safe bounded ring of lifecycle events plus the
    `RequestTrace` factory. One recorder per engine (the engine's
    `recorder=` kwarg), or share one across engines the way a
    registry is shared."""

    enabled = True

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = _now):
        self.capacity = int(capacity)
        # long-soak fleet stitching needs DEEPER rings
        # (EngineConfig.recorder_capacity / the Router's
        # recorder_capacity kwarg size this); a non-positive ring
        # cannot hold a single lifecycle and is always a config bug
        if self.capacity < 1:
            raise ValueError(
                f"recorder capacity must be >= 1, got {capacity}")
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def now(self) -> float:
        return self._clock()

    def start_trace(self, rid: int,
                    ctx: Optional[dict] = None) -> RequestTrace:
        return RequestTrace(rid, self, ctx=ctx)

    def record(self, kind: str, rid: int = 0, **data) -> Event:
        """Ring-only event (no per-request trace) — engine-scope
        happenings that belong to no single request."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        ev = Event(self.now(), kind, int(rid), data)
        self._push(ev)
        return ev

    def _push(self, ev: Event) -> None:
        with self._lock:
            self._ring.append(ev)

    def recent(self, n: Optional[int] = None,
               kind: Optional[str] = None,
               rid: Optional[int] = None) -> List[Event]:
        """The last ``n`` ring events (oldest first), optionally
        filtered by kind and/or request id."""
        with self._lock:
            evs: Iterable[Event] = tuple(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if rid is not None:
            evs = [e for e in evs if e.rid == rid]
        evs = list(evs)
        return evs[-n:] if n is not None else evs

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_NULL_EVENT = Event(0.0, "shed", 0, {})


class NullTrace:
    """No-op trace: `add` costs one call and returns a constant."""

    __slots__ = ()
    rid = 0
    ctx = None
    events: Tuple[Event, ...] = ()

    def add(self, kind: str, **data) -> Event:
        return _NULL_EVENT

    def kinds(self) -> list:
        return []

    def first_ts(self, kind: str) -> None:
        return None

    def last_ts(self, kind: str) -> None:
        return None

    def complete(self) -> bool:
        return False

    def as_dicts(self) -> list:
        return []

    def __len__(self) -> int:
        return 0


NULL_TRACE = NullTrace()


class NullRecorder:
    """Recorder whose traces record nothing — the flight recorder can
    be disabled by injection (mirroring `NULL_REGISTRY`) instead of by
    `if` guards at every engine call site."""

    enabled = False
    capacity = 0

    def now(self) -> float:
        return _now()

    def start_trace(self, rid: int,
                    ctx: Optional[dict] = None) -> NullTrace:
        return NULL_TRACE

    def record(self, kind: str, rid: int = 0, **data) -> Event:
        return _NULL_EVENT

    def recent(self, n=None, kind=None, rid=None) -> list:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_RECORDER = NullRecorder()

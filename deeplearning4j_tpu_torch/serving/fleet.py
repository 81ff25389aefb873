"""Replicated serving fleet: a health-aware router over N engines.

Port of deeplearning4j_tpu/serving/fleet.py: `TenantCapExceeded`,
`ReplicaState`, `ReplicaCrashed`, `FleetConfig` (reference :120-244),
`FleetHandle` and `_Hop` (:245-374), `InProcessReplica` (:375-575),
`SubprocessReplica` and `_ProxyHandle` (:595-1133), `_ReplicaCtl`
(:1135) and `Router` (:1186-3292), with the reference's names and
structure. The router is host code over the port's `InferenceEngine`:
on the card its replicas run the engine's kernels, and the fleet adds
none of its own.

The single `InferenceEngine` is a hardened process (retry, isolation,
quarantine, breaker, drain), but one process is one blast radius. The
`Router` fronts N engine replicas and makes the fleet as fault-tolerant
as the single engine already is: a replica crash, hang, or slowdown
costs at most one retried request, never an outage.

Replicas
--------
- `InProcessReplica` (default): one `InferenceEngine` per replica in
  this process, driven by the router's scheduling tick. Deterministic,
  fast, and what the fault-injection suite uses. "Crash" abandons the
  engine exactly as a dead process would abandon it (device state,
  in-flight handles and all); optional per-replica `MetricsServer`s
  make the probe path the real HTTP one.
- `SubprocessReplica`: a real separate process
  (`serving/fleet_worker.py`) hosting an engine plus its
  `MetricsServer`. The router probes over real HTTP
  (`/healthz`/`/readyz`) and dispatches over a JSON-lines pipe; the
  worker streams per-request progress so the router always knows each
  request's committed prefix. Crash realism: SIGKILL; hang realism:
  SIGSTOP. The worker runs on the card unless its spec says
  ``"device": "cpu"``.

Routing policy
--------------
Admission is router-owned: replicas only ever see work they have slot
capacity for, so the router queue is the ONE queue (queue-age
histograms and hedging read it directly). Each tick:

1. **Probes**: every replica's `/healthz` semantics (direct call or
   HTTP) feed an active health view; consecutive probe failures take a
   replica out of rotation WITHOUT killing it (in-flight work
   finishes), and a recovered probe returns it.
2. **Passive signals**: per-replica error EMAs from dispatch
   failures/crashes, plus a per-replica circuit breaker (consecutive
   dispatch failures open it for a cooldown).
3. **Dispatch**: least-occupancy, health-weighted: score =
   outstanding/capacity + error-EMA penalty; lowest score wins.
   Submit-time deadlines ride along as the REMAINING deadline, and a
   request already past its deadline is shed typed `deadline` at the
   router, so a retried request can never resurrect past its deadline.
4. **Failover**: a crashed (or hang-detected) replica's in-flight
   requests are requeued at the queue FRONT and re-dispatched onto
   survivors from their COMMITTED PREFIX (position-keyed sampling
   makes the continuation token-exact vs an uninterrupted run); the
   fleet trace gains `failover{from,to,committed}`.
5. **Hedging** (optional): a request whose queue age lands in the
   slowest decile (or past `hedge_age_s`) is dispatched to TWO
   replicas; the first terminal result wins and the loser is cancelled
   (`engine.cancel` -> shed `cancelled`), counted in
   `serving_fleet_hedges_total{outcome}`.
6. **Supervised restart**: a dead replica is restarted with
   exponential backoff under a CONSECUTIVE-crash budget (the budget
   resets once the replica completes work again); past the budget it
   stays dead and the fleet serves on the survivors.

`drain()` flips the router's `/readyz` the moment it is called, stops
admission, and lets residents finish; `rolling_reload()` drains ONE
replica at a time (the rest keep serving), hot-reloads its weights,
and returns it to rotation: a fleet-wide weight rollout with zero
dropped requests.

Observability: `serving_fleet_replicas{state}` /
`serving_fleet_queue_depth` gauges, `serving_fleet_failovers_total`,
`serving_fleet_hedges_total{outcome}`, `serving_fleet_restarts_total`,
`serving_fleet_probe_failures_total`,
`serving_fleet_requests_{completed,shed}_total`,
`serving_fleet_queue_age_seconds` / `serving_fleet_recovery_seconds`
histograms, a `debugz()` fleet table, and router-hop
`dispatched`/`failover`/`hedge` events on every fleet trace.

Every behavior is deterministic on the CPU via
`parallel.failure.FleetFaultInjector` (kill-replica-at, hang-replica,
slow-replica, fail-probe): tests/test_torch_fleet.py holds it to the
reference router on converted weights.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.observability.events import (FlightRecorder,
                                                           NULL_RECORDER,
                                                           NULL_TRACE)
from deeplearning4j_tpu_torch.observability.export import json_snapshot
from deeplearning4j_tpu_torch.observability.federation import \
    merge_snapshots
from deeplearning4j_tpu_torch.observability.metrics import (
    DECODE_LATENCY_BUCKETS, MetricsRegistry, NullRegistry)
from deeplearning4j_tpu_torch.observability.slo import NULL_SLO, SLOTracker
from deeplearning4j_tpu_torch.observability.stitch import (
    fleet_timeline_json, stitch)
from deeplearning4j_tpu_torch.serving import kvwire
from deeplearning4j_tpu_torch.serving.engine import (DeadlineExceeded,
                                                     EngineDraining,
                                                     EngineStopped,
                                                     HandoffError,
                                                     OverloadError,
                                                     RequestCancelled,
                                                     RequestQuarantined,
                                                     RequestStatus,
                                                     validate_tenant_priority)
from deeplearning4j_tpu_torch.serving.paging import (chain_hashes,
                                                     digest_lookup)

log = logging.getLogger("deeplearning4j_tpu_torch")


class TenantCapExceeded(OverloadError):
    """Admission rejected a tenant's request at the router because the
    tenant is over its per-tenant rate or concurrency cap. Subclasses
    OverloadError so existing retry/backoff callers treat it as the
    transient overload it is, but typed, so a tenant can distinguish
    'the fleet is full' from 'YOU are over cap'."""


class ReplicaState:
    READY = "ready"
    DRAINING = "draining"
    UNHEALTHY = "unhealthy"      # probes failing; in-flight may finish
    RESTARTING = "restarting"    # dead, restart scheduled
    DEAD = "dead"                # dead, crash budget exhausted
    STOPPED = "stopped"          # deliberately scaled down;
    #                              revivable by the autoscaler

    ALL = ("ready", "draining", "unhealthy", "restarting", "dead",
           "stopped")


class ReplicaCrashed(RuntimeError):
    """A replica is dead (crashed, killed, or declared hung)."""


@dataclass
class FleetConfig:
    """Router policy knobs (see module docstring for semantics)."""
    max_queue: int = 256             # router admission bound
    probe_every_ticks: int = 1       # probe cadence (scheduling ticks)
    probe_failure_threshold: int = 1  # consecutive failures -> out
    probe_timeout_s: float = 2.0     # HTTP probe timeout
    error_ema_alpha: float = 0.3     # passive failure-signal decay
    breaker_failure_threshold: int = 3   # consecutive dispatch errors
    breaker_cooldown_s: float = 1.0
    hang_ticks: int = 8              # no-progress ticks w/ in-flight
    #                                  work before a replica is
    #                                  declared hung (then crashed)
    hang_min_s: float = 2.0          # AND at least this much wall (or
    #                                  injected-clock) time without
    #                                  progress — tick counts alone
    #                                  would misfire on replicas whose
    #                                  progress reports arrive async
    #                                  (subprocess pipes)
    hedge: bool = False              # hedged dispatch of slow-decile
    hedge_age_s: Optional[float] = None  # absolute age trigger; None
    #                                  uses the rolling p90 policy
    hedge_quantile: float = 0.9      # "slowest decile"
    hedge_min_age_s: float = 0.05    # never hedge younger than this
    hedge_warmup: int = 20           # window samples before quantile
    #                                  hedging activates
    max_restarts: int = 3            # CONSECUTIVE crash budget/replica
    restart_backoff_base_s: float = 0.05  # exponential: base*2^(n-1)
    restart_backoff_max_s: float = 2.0
    # prefix-cache affinity dispatch + KV migration.
    # ``affinity_weight`` blends the advertised-cached-tokens fraction
    # into the dispatch score: score = occupancy + error-EMA penalty
    # - affinity_weight * (cached_tokens / prompt_len) — 0 disables
    # affinity entirely (pure occupancy dispatch, the bench's control
    # arm). The ANTI-HERD cap zeroes the bonus on any replica at or
    # above ``affinity_max_occupancy`` occupancy, so one hot tenant
    # cannot pin a single replica into overload — the spillover
    # replica gets the chain MIGRATED instead (``migrate_kv``): the
    # router pulls it from the advertising replica via
    # engine.export_cached_chain and ships it on the dispatch as a
    # cache-source KVHandoff that seeds the target's radix cache.
    # Advertisements older than ``affinity_digest_ttl_s`` are ignored
    # (a replica that stopped answering probes must not keep
    # attracting traffic on a stale digest).
    affinity_weight: float = 1.0
    affinity_max_occupancy: float = 0.75
    affinity_digest_ttl_s: float = 10.0
    migrate_kv: bool = True
    migrate_min_tokens: int = 16     # don't ship chains smaller than
    # tenant QoS admission caps + SLO-aware overload control
    #. ``tenant_max_concurrency`` bounds each tenant's
    # live (queued + in-flight) fleet requests; ``tenant_rate_per_s``
    # is a per-tenant token-bucket admission rate (burst =
    # ``tenant_rate_burst``, None = max(1, 2x rate)). Both None
    # (default) = no caps, admission byte-identical. Over-cap submits
    # raise the typed `TenantCapExceeded`.
    # The overload controller is armed by ``overload_ttft_p99_ms``
    # (fleet SLO tracker's TTFT p99 target) and/or
    # ``overload_queue_depth`` (deterministic router-queue watermark —
    # the injected-clock test trigger). Every
    # ``overload_check_every_ticks`` ticks it walks the degradation
    # ladder one rung in COST order: (1) drop speculative decode,
    # (2) halve decode chunks, (3) shed queued lowest-priority /
    # over-cap requests (at most ``overload_shed_per_tick`` per tick,
    # shed reason "qos") — and walks back one rung after
    # ``overload_cooldown_ticks`` ticks below the trigger. Every
    # transition is a typed ``qos`` trace event and a
    # serving_fleet_qos_* metric.
    tenant_max_concurrency: Optional[int] = None
    tenant_rate_per_s: Optional[float] = None
    tenant_rate_burst: Optional[int] = None
    overload_ttft_p99_ms: Optional[float] = None
    overload_queue_depth: Optional[int] = None
    overload_check_every_ticks: int = 5
    overload_cooldown_ticks: int = 20
    overload_shed_per_tick: int = 4
    # ``priority_overcommit`` lets a priority > 0 request dispatch to
    # a replica that is already at capacity (up to this many extra
    # in-flight requests per replica), so the ENGINE's preemption path
    # can actually see it and evict a lower class for its seat —
    # without it a full fleet parks high-priority work in the router
    # queue where no preemption can reach. Priority-0 dispatch is
    # byte-identical (headroom 0), so QoS-off behavior is unchanged.
    priority_overcommit: int = 1
    # KV wire transport. At autoscale-up the tiered router
    # PUSHES the fleet's ``proactive_chains`` hottest advertised
    # chains into the new replica's radix cache before traffic lands
    # (0 disables the push). Every ``advertise_every_ticks`` ticks the
    # router unions the live digests' top chains and installs the set
    # on every replica, biasing their LRU eviction away from chains
    # the fleet is actively routing by (pushed only when the set
    # changed — an idle fleet costs the pipes nothing).
    proactive_chains: int = 4
    advertise_every_ticks: int = 16


class FleetHandle:
    """Caller-facing future for one fleet-submitted prompt. Mirrors
    `RequestHandle`'s surface (`result`/`done`/`generated`/`status`/
    `error`/`trace`) — callers should not care whether they talk to an
    engine or a fleet."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int,
                 deadline_at: Optional[float], on_deadline: str):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new
        self.deadline_at = deadline_at
        self.on_deadline = on_deadline
        self.status = RequestStatus.QUEUED
        self.error: Optional[BaseException] = None
        self.deadline_exceeded = False
        # per-tenant cost metering: forwarded on every
        # dispatch hop so the serving replica bills the right tenant
        self.tenant: Optional[str] = None
        # QoS priority class: forwarded on every hop;
        # higher classes dispatch first at the router
        self.priority = 0
        self.trace = NULL_TRACE
        self._committed = np.zeros((0,), np.int32)
        self._failover_from: Optional[int] = None
        self._queued_at = 0.0
        self._failovers = 0
        self._hedged = False
        # tiered routing (serving/disagg.py): which tier the
        # next dispatch targets (None reads as "prefill" under a
        # TieredRouter; the plain Router never looks) and the pending
        # KV handoff the decode dispatch should adopt
        self._phase: Optional[str] = None
        self._handoff = None
        # distributed tracing: every resolved hop's replica
        # trace is captured here (clock offset and all) so the router
        # can stitch ONE timeline per request; _next_hop numbers the
        # dispatches, _stitched caches the terminal stitch
        self._hops_done: List[dict] = []
        self._next_hop = 0
        self._stitched = None
        # prefix affinity: page-prefix chain hashes of the
        # PROMPT, computed lazily once per page size encountered, and
        # the migrated cache-chain handoff the next dispatch ships
        self._chain_hashes: Dict[int, List[int]] = {}
        self._migrate_kv = None
        # grammar constraint: the normalized consumed-free
        # spec + the submit-time consumed count. Every dispatch hop
        # recomputes `consumed` from how much committed prefix was
        # folded into the hop's prompt, so a failover target replays
        # the DFA to exactly the state the lost replica held
        self._constrain: Optional[dict] = None
        self._consumed0 = 0
        self._on_terminal: Optional[Callable] = None
        self._done = threading.Event()

    @property
    def generated(self) -> np.ndarray:
        """Tokens COMMITTED at the router (authoritative once done;
        mid-flight it trails the serving replica by up to the progress
        cadence)."""
        return self._committed

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(f"fleet request {self.rid} not done")
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt, self._committed])

    def _finish(self, status: str,
                error: Optional[BaseException] = None) -> None:
        self.status = status
        self.error = error
        hook = self._on_terminal
        if hook is not None:
            try:
                hook(self)       # stitch + fleet SLO before done flips
            except Exception:
                log.exception("fleet trace finalize failed (rid %d)",
                              self.rid)
        self._done.set()


class _Hop:
    """One dispatch of a fleet request onto one replica."""

    __slots__ = ("fr", "replica_id", "inner", "base", "hedge",
                 "dispatched_at", "seq", "phase", "trace_ts",
                 "recorded", "aff_pred", "aff_ps", "aff_checked")

    def __init__(self, fr: FleetHandle, replica_id: int, inner,
                 base: np.ndarray, hedge: bool, t: float,
                 seq: int = 0, phase: str = "serving"):
        self.fr = fr
        self.replica_id = replica_id
        self.inner = inner           # engine RequestHandle / proxy
        self.base = base             # tokens committed before this hop
        self.hedge = hedge
        self.dispatched_at = t
        self.seq = seq               # hop index within the request
        self.phase = phase           # prefill | decode | serving
        self.trace_ts = None         # recorder ts of the dispatched ev
        self.recorded = False        # captured into fr._hops_done
        # affinity prediction audit: tokens the dispatch
        # believed were cached at the target (+ the digest's page
        # size); checked against the replica's admitted event at
        # harvest — a shortfall is a MISPREDICT (bloom false positive
        # or eviction), which cost only a normal prefill
        self.aff_pred = 0
        self.aff_ps = 0
        self.aff_checked = False

    def committed(self) -> np.ndarray:
        """base + whatever this hop's replica has committed since."""
        gen = np.asarray(self.inner.generated, np.int32)
        if self.base.size == 0:
            return gen
        if gen.size == 0:
            return self.base
        return np.concatenate([self.base, gen])


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

class InProcessReplica:
    """One `InferenceEngine` in this process, driven by the router's
    tick. ``factory`` builds the engine (and rebuilds it on restart —
    the process-wide compiled-program caches make that cheap).
    ``http_probes=True`` mounts a per-replica `MetricsServer` and
    routes `probe()` through real HTTP `/healthz` semantics."""

    kind = "inprocess"
    #: replicas export/adopt KV handoffs — by reference in-process
    #:, as versioned CRC-checked kvwire frames over the
    #: worker pipe for subprocess replicas; the tiered
    #: router re-prefills only as the DEGRADED mode, when a target
    #: cannot take KV at all or the wire itself fails
    supports_handoff = True
    #: same process, same perf_counter: replica trace timestamps are
    #: already in the router's clock domain
    clock_offset = 0.0

    def __init__(self, replica_id: int, factory: Callable[[], object],
                 http_probes: bool = False):
        self.id = int(replica_id)
        self._factory = factory
        # cold-start-to-ready: how long the factory took to
        # hand back a servable engine — with a warm AOT compile cache
        # (EngineConfig.compile_cache_dir + warmup_on_init) this is a
        # load, not a compile set; surfaced on the debugz replica row
        # so autoscale/restart latency is observable per replica
        t0 = time.perf_counter()
        self.engine = factory()
        self.cold_start_s = time.perf_counter() - t0
        self._num_slots = self.engine._num_slots
        self._dead = False
        self._hung = False
        self._slow_s = 0.0
        self._slow_phase = 0
        self._http = bool(http_probes)
        self._server = None
        if self._http:
            self._start_server()

    def _start_server(self) -> None:
        from deeplearning4j_tpu_torch.observability.export import \
            MetricsServer
        self._server = MetricsServer(self.engine.registry, port=0,
                                     health=self.engine.health,
                                     ready=self.engine.ready,
                                     debug=self.engine.debugz)

    @property
    def capacity(self) -> int:
        return self._num_slots

    @property
    def last_warmup(self) -> Optional[dict]:
        eng = self.engine
        return eng.last_warmup if eng is not None else None

    @property
    def cache_warm(self) -> Optional[bool]:
        """Did this replica's warmup load its program set from the
        persistent AOT cache instead of compiling it (the
        autoscale-onto-new-host priming signal)? None
        until a warmup ran."""
        return _warmup_cache_warm(self.last_warmup)

    @property
    def probe_url(self) -> Optional[str]:
        return self._server.url if self._server is not None else None

    def alive(self) -> bool:
        return not self._dead

    def busy(self) -> bool:
        """True while the engine still holds queued or resident work —
        including cancelled hedge losers awaiting their chunk-boundary
        shed. The router keeps stepping busy replicas after the fleet
        queue empties so residents always reach a terminal state."""
        return not self._dead and not self._hung \
            and not self.engine.drained()

    def step(self) -> bool:
        """One engine scheduling round. A hung replica stays alive but
        makes no progress (the failure mode probes cannot see); a slow
        one stalls first; a dead one raises."""
        if self._dead:
            raise ReplicaCrashed(f"replica {self.id} is dead")
        if self._hung:
            return False
        if self._slow_s > 0:
            # gray failure with DIFFERENTIAL progress: co-driven
            # replicas share the router's tick loop, so a plain sleep
            # would slow the whole fleet in lockstep. A slow replica
            # instead stalls a bounded slice of wall time (so queue
            # ages really grow) AND advances its engine only every
            # _SLOW_STRIDE-th round — fast replicas genuinely outpace
            # it, which is what hedging exists to exploit.
            time.sleep(min(self._slow_s, 0.05))
            self._slow_phase += 1
            if self._slow_phase % self._SLOW_STRIDE != 0:
                return False
        return self.engine.tick()

    _SLOW_STRIDE = 4

    def submit(self, prompt, max_new_tokens, deadline_s, on_deadline,
               **kw):
        """``kw`` passes the handoff knobs through to the
        engine (``hold_kv=`` on the prefill tier, ``kv=`` on the
        decode tier)."""
        if self._dead:
            raise ReplicaCrashed(f"replica {self.id} is dead")
        return self.engine.submit(prompt,
                                  max_new_tokens=max_new_tokens,
                                  deadline_s=deadline_s,
                                  on_deadline=on_deadline, **kw)

    def export_kv(self, inner, release: bool = True):
        """Host-gather ``inner``'s committed KV out of its held slot
        (engine.export_slot_kv) — the prefill-tier half of a
        cross-tier handoff."""
        if self._dead:
            raise ReplicaCrashed(f"replica {self.id} is dead")
        return self.engine.export_slot_kv(inner, release=release)

    def export_cached_chain(self, chain_hash: int):
        """Cached-chain migration source: the engine's
        host-gathered ``source="cache"`` handoff, or None when the
        chain was evicted since its advertisement."""
        if self._dead:
            raise ReplicaCrashed(f"replica {self.id} is dead")
        return self.engine.export_cached_chain(chain_hash)

    def seed_chain(self, kv) -> bool:
        """Cached-chain migration sink: adopt a peer's
        exported chain into this engine's radix cache."""
        if self._dead:
            return False
        return self.engine.seed_cached_chain(kv)

    def set_advertised(self, hashes) -> None:
        """Fleet-advertised chain hashes: bias this engine's cache
        eviction away from them."""
        if not self._dead:
            self.engine.set_advertised_chains(hashes)

    def cancel(self, inner) -> None:
        if not self._dead:
            self.engine.cancel(inner)

    def probe(self) -> dict:
        """Health snapshot with the `/healthz` contract ({"ready":
        bool, ...}); raises when the replica cannot answer."""
        if self._dead:
            raise ReplicaCrashed(f"replica {self.id} is dead")
        if self._http:
            return _http_probe(f"{self._server.url}/healthz",
                               timeout=2.0)
        return self.engine.health()

    # -- fault-injection / supervision surface -------------------------
    def kill(self) -> None:
        """Simulated crash: the engine (and every in-flight request's
        state) is abandoned the way a dead process abandons it; the
        probe endpoint dies with it. The abandoned engine's device
        memory returns as a dead process's would: `_abandon` waits for
        its queued device work, then drops the engine."""
        self._dead = True
        if self._server is not None:
            self._server.stop()
            self._server = None
        self._abandon()

    def _abandon(self) -> None:
        """Drop the engine once its device work has ended. A dead
        engine may still have a pipelined tick or a graph replay queued
        on the card; its pools and graph pools go back to the caching
        allocator only after that work finished, so nothing a new engine
        allocates can be written by it. In-flight handles keep only
        their host-side tokens and traces (the failover substrate)."""
        eng, self.engine = self.engine, None
        if eng is not None and eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    def set_hung(self, flag: bool) -> None:
        self._hung = bool(flag)

    def set_slow(self, seconds: float) -> None:
        self._slow_s = float(seconds)

    def restart(self) -> None:
        self._abandon()
        t0 = time.perf_counter()
        self.engine = self._factory()
        self._num_slots = self.engine._num_slots
        self.cold_start_s = time.perf_counter() - t0
        self._dead = False
        self._hung = False
        if self._http:
            self._start_server()

    def drain(self, wait: bool = False) -> None:
        self.engine.drain(wait=wait)

    def resume(self) -> None:
        self.engine.resume()

    def reload(self, source, step: Optional[int] = None) -> int:
        return self.engine.reload_weights(source, step=step)

    def close(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
        if not self._dead and self.engine is not None:
            try:
                self.engine.stop(drain=False)
            except Exception:
                pass
        self._abandon()


def _warmup_cache_warm(report: Optional[dict]) -> Optional[bool]:
    """Classify a warmup report as cache-warm (every program an AOT
    load, zero jit compiles) vs cold. None when no warmup ran."""
    if not report:
        return None
    return (int(report.get("aot_cache", 0) or 0) > 0
            and int(report.get("jit", 0) or 0) == 0)


def _http_probe(url: str, timeout: float) -> dict:
    """GET a probe endpoint; 503 bodies parse like 200 bodies (the
    probe ANSWERED — "ready": False is information, not an error)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:      # 503 carries a body too
        return json.loads(e.read().decode())


class _ProxyHandle:
    """Router-side stand-in for a subprocess replica's RequestHandle:
    updated from the worker's streamed progress/done/error events so
    the router always knows the request's committed prefix — the
    failover substrate when the process is SIGKILLed."""

    def __init__(self, lrid: int, prompt: np.ndarray, max_new: int):
        self.rid = int(lrid)
        self.prompt = prompt
        self.max_new_tokens = max_new
        self.status = RequestStatus.RUNNING
        self.error: Optional[BaseException] = None
        self.deadline_exceeded = False
        self._cancelled = False
        self._tokens = np.zeros((0,), np.int32)
        # the worker ships the request's completed RequestTrace back
        # on its done/error line; a SIGKILLed worker leaves
        # this empty and the stitched trace shows only the router side
        self.trace_events: List[dict] = []
        self._done = threading.Event()

    @property
    def generated(self) -> np.ndarray:
        return self._tokens

    def done(self) -> bool:
        return self._done.is_set()

    def _update(self, tokens: List[int]) -> None:
        if len(tokens) > self._tokens.shape[0]:
            self._tokens = np.asarray(tokens, np.int32)

    def _finish(self, status: str, error=None,
                tokens: Optional[List[int]] = None) -> None:
        if tokens is not None:
            self._update(tokens)
        self.status = status
        self.error = error
        self._done.set()


_ERR_TYPES = {"DeadlineExceeded": DeadlineExceeded,
              "RequestQuarantined": RequestQuarantined,
              "RequestCancelled": None,       # handled via status
              "OverloadError": OverloadError,
              "EngineDraining": EngineDraining,
              "EngineStopped": EngineStopped}


class SubprocessReplica:
    """A real separate engine process (`serving/fleet_worker.py`):
    JSON-lines command pipe in, streamed request events out, probes
    over real HTTP. ``spec`` is the worker's config:
    ``{"cfg": {TransformerConfig kwargs}, "engine": {EngineConfig
    kwargs}, "params_seed": int, "device": "cpu" | "cuda"}``. The worker
    re-derives the weight tree from the seed
    (`models.transformer.init_params`), so replicas are token-identical
    to an in-process engine built the same way. Without ``"device"`` the
    worker runs on the card (and exits with the engine's error where
    there is none). For a card worker the kernel libraries the engine
    launches are made ready HERE, in the parent, before the spawn
    (`ops._build.ensure_built`, through the spec's ``compile_cache_dir``
    when it names one), so children load them from the build directory
    or the cache and never run nvcc themselves, and two children
    started at once never both build."""

    kind = "subprocess"
    #: KV crosses the process boundary as versioned,
    #: length-framed, CRC32-checked kvwire frames (serving/kvwire.py)
    #: — base64 on this JSON pipe, raw on sockets. Re-prefill is the
    #: DEGRADED mode now, taken only when a frame fails its checks.
    supports_handoff = True

    #: probe-RTT pings per clock handshake; min-RTT midpoint wins
    _CLOCK_PINGS = 5

    def __init__(self, replica_id: int, spec: dict,
                 startup_timeout_s: float = 180.0):
        self.id = int(replica_id)
        self._spec = dict(spec)
        self._startup_timeout_s = float(startup_timeout_s)
        self._lrids = itertools.count(1)
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self.clock_offset = 0.0      # worker perf_counter - router's
        self.clock_rtt: Optional[float] = None
        self.cold_start_s = 0.0
        self.last_warmup: Optional[dict] = None
        self.cache_warm: Optional[bool] = None   # hello-reported
        # the worker piggybacks its radix-cache digest on hello and
        # progress lines: the router's probe loop reads it
        # here between HTTP probes
        self.prefix_digest: Optional[dict] = None
        # KV wire state: the worker's frame version (from
        # hello), the last wire transfer's {bytes, seconds} audit, and
        # the last qos_applied ack off the pipe
        self.wire_version: Optional[int] = None
        self.last_wire: Optional[dict] = None
        self.last_qos: Optional[dict] = None
        #: the worker's hello line (the port's keys: device, jax_loaded,
        #: kernels)
        self.hello: dict = {}
        self._prebuild()
        self._spawn()

    def _prebuild(self) -> None:
        """Card workers: every kernel library the engine can launch,
        ready in the build directory before any child starts."""
        dev = resolve_device(self._spec.get("device"))
        if dev.type != "cuda":
            return
        from deeplearning4j_tpu_torch.ops import _build
        from deeplearning4j_tpu_torch.serving.engine import _LIBRARIES
        cache = None
        cdir = (self._spec.get("engine") or {}).get("compile_cache_dir")
        if cdir is not None:
            from deeplearning4j_tpu_torch.serving.compile_cache import \
                CompileCache
            cache = CompileCache(cdir, device=dev)
        _build.ensure_built(*sorted({n for libs in _LIBRARIES.values()
                                     for n in libs}), cache=cache)

    # -- process lifecycle ---------------------------------------------
    def _spawn(self) -> None:
        self._handles: Dict[int, _ProxyHandle] = {}
        self._acks: Dict[str, threading.Event] = {}
        self._ack_payload: Dict[str, dict] = {}
        # kvwire rpc plumbing: call-id -> (Event, payload)
        # for the synchronous wire ops, plus the held-slot handles a
        # later export_kv/release_held will name by rid
        self._rpc: Dict[int, tuple] = {}
        self._rpc_seq = itertools.count(1)
        self._held_handles: Dict[int, "_ProxyHandle"] = {}
        self._eof = threading.Event()
        self._hello = threading.Event()
        self._port = None
        self.capacity = 1
        env = os.environ.copy()
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + ([env["PYTHONPATH"]]
                          if env.get("PYTHONPATH") else []))
        # the child's stderr is kept (its last lines) so that a worker
        # that dies before its hello says why
        self.stderr_tail: deque = deque(maxlen=40)
        self._proc = subprocess.Popen(
            [sys.executable, "-m",
             "deeplearning4j_tpu_torch.serving.fleet_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env, text=True)
        self._clock_samples: List[tuple] = []
        self._clock_done = threading.Event()
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True,
                                        name=f"fleet-replica-{self.id}")
        self._reader.start()
        threading.Thread(target=self._stderr_loop, args=(self._proc,),
                         daemon=True,
                         name=f"fleet-replica-{self.id}-stderr").start()
        try:
            self._send(self._spec)
        except ReplicaCrashed:
            pass                 # the wait below reports the exit
        deadline = time.monotonic() + self._startup_timeout_s
        while not self._hello.wait(0.05):
            if self._eof.is_set() or time.monotonic() > deadline:
                early = self._eof.is_set()
                self.close()
                if early:
                    raise RuntimeError(
                        f"subprocess replica {self.id} exited before its "
                        f"hello (rc {self._proc.returncode}): "
                        + " | ".join(list(self.stderr_tail)[-6:]))
                raise TimeoutError(
                    f"subprocess replica {self.id} did not come up "
                    f"within {self._startup_timeout_s}s")
        self._sync_clock()

    def _stderr_loop(self, proc) -> None:
        try:
            for line in proc.stderr:
                self.stderr_tail.append(line.rstrip())
        except (ValueError, OSError):
            pass

    def _sync_clock(self, timeout: float = 10.0) -> None:
        """Per-process clock alignment: each ping carries
        this side's perf_counter; the worker answers with ITS
        perf_counter; the reply computes offset = worker_t - RTT
        midpoint. The min-RTT sample wins (the NTP discipline) — the
        residual error is bounded by RTT/2, which `stitch()` absorbs
        by clamping hop edges. A worker that never answers (older
        protocol) leaves the offset at 0 with a warning."""
        self._clock_samples = []
        self._clock_done.clear()
        try:
            for _ in range(self._CLOCK_PINGS):
                self._send({"op": "clock",
                            "t0": time.perf_counter()})
        except ReplicaCrashed:
            return
        self._clock_done.wait(timeout)
        if not self._clock_samples:
            log.warning("replica %d: clock handshake got no reply; "
                        "trace timestamps stay unaligned", self.id)
            return
        self.clock_rtt, self.clock_offset = min(self._clock_samples)

    def _send(self, obj: dict) -> None:
        try:
            self._proc.stdin.write(json.dumps(obj) + "\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            raise ReplicaCrashed(
                f"replica {self.id}: worker pipe is gone")

    def _read_loop(self) -> None:
        try:
            for line in self._proc.stdout:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                self._on_event(ev)
        except (ValueError, OSError):
            pass
        self._eof.set()

    def _on_event(self, ev: dict) -> None:
        kind = ev.get("ev")
        if kind == "hello":
            self._port = int(ev["port"])
            self.capacity = int(ev.get("num_slots", 1))
            # cold-start surfacing: the hello line's figures land on
            # the replica object for the router's debugz rows
            self.cold_start_s = float(ev.get("cold_start_s", 0.0)
                                      or 0.0)
            self.last_warmup = ev.get("warmup")
            # cache-warm vs cold: a fresh host
            # primed via compile_cache_dir says so in its hello line
            self.cache_warm = ev.get("cache_warm",
                                     _warmup_cache_warm(
                                         self.last_warmup))
            if ev.get("prefix_digest"):
                self.prefix_digest = ev["prefix_digest"]
            self.wire_version = ev.get("kv_wire")
            self.hello = ev
            self._hello.set()
            return
        if kind == "wire":
            # one kvwire rpc answered
            with self._lock:
                ent = self._rpc.get(ev.get("call"))
            if ent is not None:
                ent[1].update(ev)
                ent[0].set()
            return
        if kind == "qos_applied":
            self.last_qos = ev.get("state") or {"error": ev.get("error")}
            return
        if kind == "clock":
            t1 = time.perf_counter()
            t0 = float(ev.get("t0", t1))
            rtt = max(0.0, t1 - t0)
            off = float(ev.get("t", 0.0)) - (t0 + t1) / 2.0
            self._clock_samples.append((rtt, off))
            if len(self._clock_samples) >= self._CLOCK_PINGS:
                self._clock_done.set()
            return
        if kind in ("reloaded", "drained", "resumed"):
            self._ack_payload[kind] = ev
            ack = self._acks.get(kind)
            if ack is not None:
                ack.set()
            return
        lrid = ev.get("rid")
        with self._lock:
            h = self._handles.get(lrid)
        if h is None:
            return
        if kind == "progress":
            h._update(ev.get("tokens", []))
            if ev.get("prefix_digest"):
                self.prefix_digest = ev["prefix_digest"]
        elif kind == "done":
            h.trace_events = ev.get("trace") or []
            h.deadline_exceeded = bool(ev.get("partial", False))
            h._finish(RequestStatus.COMPLETED,
                      tokens=ev.get("tokens", []))
        elif kind in ("error", "rejected"):
            h.trace_events = ev.get("trace") or []
            etype = ev.get("etype", "RuntimeError")
            msg = ev.get("msg", "")
            if etype == "DeadlineExceeded":
                h.deadline_exceeded = True
                h._finish(RequestStatus.SHED, DeadlineExceeded(msg),
                          tokens=ev.get("tokens"))
            elif etype == "RequestQuarantined":
                h._finish(RequestStatus.QUARANTINED,
                          RequestQuarantined(msg))
            elif etype == "RequestCancelled":
                h._cancelled = True
                h._finish(RequestStatus.SHED, RequestCancelled(msg))
            else:
                exc = _ERR_TYPES.get(etype, RuntimeError) or RuntimeError
                h._finish(RequestStatus.SHED, exc(msg))

    # -- router-facing surface -----------------------------------------
    @property
    def probe_url(self) -> Optional[str]:
        return (f"http://127.0.0.1:{self._port}"
                if self._port is not None else None)

    def alive(self) -> bool:
        return (self._proc is not None and self._proc.poll() is None
                and not self._eof.is_set())

    def busy(self) -> bool:
        return False             # the worker reaps its own residents

    def step(self) -> bool:
        return False             # the worker drives its own engine

    def submit(self, prompt, max_new_tokens, deadline_s, on_deadline,
               **kw):
        # the hop's trace context DOES cross the pipe, and
        # so does the tenant label (the worker's engine
        # bills the right tenant). The KV-handoff knobs cross it too
        # now: hold_kv as a flag, kv as one base64 kvwire
        # frame the worker decodes and adopts — any decode failure
        # over there degrades to a plain (re-prefill) submit.
        trace_ctx = kw.pop("trace_ctx", None)
        tenant = kw.pop("tenant", None)
        priority = kw.pop("priority", 0)
        hold_kv = bool(kw.pop("hold_kv", False))
        kv = kw.pop("kv", None)
        # grammar constraint: the spec dict is JSON-able
        # by construction (normalize_constraint), so it crosses the
        # pipe verbatim and the worker's engine compiles/validates it
        constrain = kw.pop("constrain", None)
        if kw:
            log.warning("subprocess replica %d ignores submit "
                        "kwargs %s", self.id, sorted(kw))
        if not self.alive():
            raise ReplicaCrashed(f"replica {self.id} is dead")
        lrid = next(self._lrids)
        h = _ProxyHandle(lrid, np.asarray(prompt, np.int32),
                         max_new_tokens)
        msg = {"op": "submit", "rid": lrid,
               "prompt": np.asarray(prompt).tolist(),
               "max_new_tokens": max_new_tokens,
               "deadline_s": deadline_s,
               "on_deadline": on_deadline,
               "trace_ctx": trace_ctx,
               "tenant": tenant,
               # QoS class crosses the pipe too: the
               # worker's engine seats/preempts by it
               "priority": int(priority)}
        if constrain is not None:
            msg["constrain"] = constrain
        if hold_kv:
            msg["hold_kv"] = True
        if kv is not None:
            t0 = time.perf_counter()
            frame = kvwire.encode_handoff(kv)
            msg["kvframe"] = kvwire.frame_to_text(frame)
            self.last_wire = {"bytes": len(frame),
                              "seconds": time.perf_counter() - t0}
        with self._lock:
            self._handles[lrid] = h
        self._send(msg)
        if hold_kv:
            self._held_handles[lrid] = h
        return h

    # -- KV wire surface ------------------------------------
    def _wire_rpc(self, msg: dict, timeout: float) -> dict:
        """One synchronous kvwire op over the pipe: send with a call
        id, wait for the worker's matching ``wire`` event."""
        call = next(self._rpc_seq)
        ev = threading.Event()
        payload: dict = {}
        with self._lock:
            self._rpc[call] = (ev, payload)
        try:
            self._send({**msg, "call": call})
            if not ev.wait(timeout):
                raise kvwire.WireError(
                    "error", f"replica {self.id}: no answer to "
                             f"{msg.get('op')} within {timeout}s")
        finally:
            with self._lock:
                self._rpc.pop(call, None)
        return payload

    def export_kv(self, inner, release: bool = True,
                  timeout: float = 60.0):
        """Pull ``inner``'s held committed KV across the pipe as one
        kvwire frame and decode it ROUTER-side (the CRC/version checks
        run here, where a failure can still degrade to re-prefill).
        Sets ``last_wire`` to the transfer's {bytes, seconds}."""
        self.last_wire = None
        t0 = time.perf_counter()
        p = self._wire_rpc({"op": "export_kv", "rid": inner.rid},
                           timeout)
        self._held_handles.pop(inner.rid, None)
        if p.get("error") or not p.get("frame"):
            raise HandoffError(
                f"replica {self.id}: wire export failed: "
                f"{p.get('error', 'no frame returned')}")
        frame = kvwire.frame_from_text(p["frame"])
        kv = kvwire.decode_handoff(frame)
        self.last_wire = {"bytes": len(frame),
                          "seconds": time.perf_counter() - t0}
        return kv

    def export_cached_chain(self, chain_hash: int,
                            timeout: float = 30.0):
        """Cached-chain migration source over the wire: None when the
        worker no longer caches the chain (stale advertisement)."""
        self.last_wire = None
        t0 = time.perf_counter()
        p = self._wire_rpc({"op": "export_chain",
                            "hash": int(chain_hash)}, timeout)
        if p.get("error"):
            raise HandoffError(
                f"replica {self.id}: chain export failed: {p['error']}")
        if not p.get("frame"):
            return None
        frame = kvwire.frame_from_text(p["frame"])
        kv = kvwire.decode_handoff(frame)
        self.last_wire = {"bytes": len(frame),
                          "seconds": time.perf_counter() - t0}
        return kv

    def seed_chain(self, kv, timeout: float = 30.0) -> bool:
        """Cached-chain migration sink over the wire."""
        self.last_wire = None
        t0 = time.perf_counter()
        frame = kvwire.encode_handoff(kv)
        p = self._wire_rpc({"op": "seed_chain",
                            "frame": kvwire.frame_to_text(frame)},
                           timeout)
        ok = bool(p.get("ok"))
        if ok:
            self.last_wire = {"bytes": len(frame),
                              "seconds": time.perf_counter() - t0}
        return ok

    def release_held(self, inner) -> bool:
        """Drop a held slot the router will never export (fallback or
        failed handoff): fire-and-forget across the pipe."""
        self._held_handles.pop(inner.rid, None)
        try:
            self._send({"op": "release_held", "rid": inner.rid})
        except ReplicaCrashed:
            return False
        return True

    def held_handles(self):
        """Handles whose worker slot is still held for export — the
        tiered router's orphan-hold sweep reads this."""
        return list(self._held_handles.values())

    def set_advertised(self, hashes) -> None:
        """Fleet-advertised chain hashes -> worker eviction bias."""
        try:
            self._send({"op": "advertised",
                        "hashes": [int(h) for h in hashes]})
        except ReplicaCrashed:
            pass

    def qos_control(self, spec_off=None, decode_chunk=None,
                    chunk_shrink=None) -> int:
        """Actuate the worker engine's qos_control over the pipe as
        one kvwire CONTROL frame. chunk_shrink
        lets the WORKER halve against its own base chunk, which the
        router cannot see. Fire-and-forget: the worker's qos_applied
        ack lands on ``last_qos``. Returns the frame size sent."""
        payload: dict = {}
        if spec_off is not None:
            payload["spec_off"] = bool(spec_off)
        if decode_chunk is not None:
            payload["decode_chunk"] = int(decode_chunk)
        if chunk_shrink is not None:
            payload["chunk_shrink"] = bool(chunk_shrink)
        frame = kvwire.encode_control(payload)
        self._send({"op": "qos",
                    "frame": kvwire.frame_to_text(frame)})
        return len(frame)

    def cancel(self, inner) -> None:
        if self.alive():
            try:
                self._send({"op": "cancel", "rid": inner.rid})
            except ReplicaCrashed:
                pass

    def probe(self) -> dict:
        if not self.alive() or self._port is None:
            raise ReplicaCrashed(f"replica {self.id} is dead")
        return _http_probe(f"{self.probe_url}/healthz", timeout=2.0)

    _ACK_OPS = {"reloaded": "reload", "drained": "drain",
                "resumed": "resume"}

    def _ack(self, ack_kind: str, timeout: float) -> dict:
        ev = self._acks.setdefault(ack_kind, threading.Event())
        ev.clear()
        self._send({"op": self._ACK_OPS[ack_kind]})
        if not ev.wait(timeout):
            raise TimeoutError(
                f"replica {self.id}: no {ack_kind} ack within "
                f"{timeout}s")
        return self._ack_payload.get(ack_kind, {})

    def drain(self, wait: bool = False, timeout: float = 60.0) -> None:
        self._ack("drained", timeout)

    def resume(self) -> None:
        self._ack("resumed", 10.0)

    def reload(self, source, step: Optional[int] = None,
               timeout: float = 120.0) -> int:
        ev = self._acks.setdefault("reloaded", threading.Event())
        ev.clear()
        self._send({"op": "reload", "dir": str(source), "step": step})
        if not ev.wait(timeout):
            raise TimeoutError(
                f"replica {self.id}: reload did not ack in {timeout}s")
        payload = self._ack_payload.get("reloaded", {})
        if "error" in payload:
            raise RuntimeError(payload["error"])
        return int(payload.get("step", -1))

    # -- fault-injection / supervision surface -------------------------
    def kill(self) -> None:
        if self._proc is not None:
            try:
                self._proc.kill()           # SIGKILL: crash realism
            except OSError:
                pass

    def set_hung(self, flag: bool) -> None:
        """True hang realism: SIGSTOP freezes the process (probes time
        out, the pipe goes silent); SIGCONT resumes it."""
        if self._proc is not None and self._proc.poll() is None:
            os.kill(self._proc.pid,
                    signal.SIGSTOP if flag else signal.SIGCONT)

    def set_slow(self, seconds: float) -> None:
        log.warning("slow injection is not supported on subprocess "
                    "replicas; ignoring")

    def restart(self) -> None:
        self.close()
        self._spawn()

    def close(self) -> None:
        p = self._proc
        if p is None:
            return
        if p.poll() is None:
            try:
                self._send({"op": "stop"})
            except ReplicaCrashed:
                pass
            try:
                p.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                p.kill()
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    pass
        else:
            p.wait()             # reap the zombie
        for s in (p.stdin, p.stdout, p.stderr):
            try:
                if s is not None:
                    s.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class _ReplicaCtl:
    """Router-side bookkeeping for one replica."""

    def __init__(self, replica):
        self.replica = replica
        self.id = replica.id
        self.tier = "serving"        # TieredRouter: prefill | decode
        self.scaled_down = False     # deliberately stopped
        self.draining = False
        self.dead = False
        self.unhealthy = False
        self.ready = False           # last probe's readiness verdict
        self.last_health: dict = {}
        self.consec_probe_failures = 0
        # prefix-cache advertisement: the last probe's
        # chain digest + when it landed (the TTL's reference point)
        self.digest: Optional[dict] = None
        self.digest_at = 0.0
        self.err_ema = 0.0
        self.breaker_failures = 0
        self.breaker_open_until = 0.0
        self.no_progress = 0
        self.last_progress_mark = (0, 0)
        self.last_progress_t = 0.0
        self.consec_crashes = 0
        self.restarts = 0
        self.killed_at: Optional[float] = None
        self.next_restart_at: Optional[float] = None
        self.outstanding: Dict[int, List[_Hop]] = {}

    @property
    def capacity(self) -> int:
        return max(1, int(getattr(self.replica, "capacity", 1)))

    def state(self) -> str:
        if self.scaled_down:
            return ReplicaState.STOPPED
        if self.dead:
            return (ReplicaState.RESTARTING
                    if self.next_restart_at is not None
                    else ReplicaState.DEAD)
        if self.draining:
            return ReplicaState.DRAINING
        if self.unhealthy:
            return ReplicaState.UNHEALTHY
        return ReplicaState.READY

    def n_outstanding(self) -> int:
        return sum(len(hs) for hs in self.outstanding.values())


class Router:
    """Health-aware load balancer + supervisor over N engine replicas
    (module docstring has the policy). Construct either from a list of
    pre-built ``replicas`` (e.g. `SubprocessReplica`s) or from
    ``cfg``/``params`` + ``num_replicas``, in which case the router
    builds `InProcessReplica`s itself (every replica gets the same
    weights/config, so which replica serves a request never changes its
    tokens). The port has no mesh: ``device`` places every in-process
    engine (CUDA unless ``device="cpu"``; without CUDA and without
    ``device="cpu"`` the constructor raises), ``engine_config`` and
    ``engine_kwargs`` are the `InferenceEngine` arguments.

    Drive it like the engine: synchronously — `submit()` then
    `run_pending()`/`tick()` on the caller thread (what the
    deterministic tests use) — or with `start()`/`stop()` for a
    background scheduling thread."""

    def __init__(self, replicas: Optional[List] = None, *,
                 cfg=None, params=None, device=None,
                 num_replicas: int = 2,
                 engine_config=None,
                 config: Optional[FleetConfig] = None,
                 fault_injector=None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, recorder=None,
                 recorder_capacity: int = 4096,
                 slo=None,
                 http_probes: bool = False,
                 engine_kwargs: Optional[dict] = None):
        self.config = config or FleetConfig()
        self._clock = clock
        self._injector = fault_injector
        self.cfg = cfg
        if replicas is None:
            if cfg is None or params is None:
                raise ValueError("pass replicas=[...] or cfg+params to "
                                 "build in-process replicas")
            from deeplearning4j_tpu_torch.serving.engine import (
                EngineConfig, InferenceEngine)
            device = resolve_device(device)
            engine_config = engine_config or EngineConfig()
            ekw = dict(engine_kwargs or {})
            ekw.setdefault("clock", clock)

            def factory():
                return InferenceEngine(cfg, params, engine_config,
                                       device=device, **ekw)

            replicas = [InProcessReplica(i, factory,
                                         http_probes=http_probes)
                        for i in range(num_replicas)]
        self._ctls = [_ReplicaCtl(r) for r in replicas]
        self._lock = threading.RLock()
        self._queue: deque = deque()
        self._rids = itertools.count(1)
        self._ticks = 0
        self._accepting = True
        self._draining = False
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        self._age_window: deque = deque(maxlen=256)
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self._init_metrics(self.registry)
        if recorder is None:
            recorder = (NULL_RECORDER
                        if isinstance(self.registry, NullRegistry)
                        else FlightRecorder(
                            capacity=recorder_capacity))
        self.recorder = recorder
        # fleet SLO rollup: derived from STITCHED traces at
        # each request's terminal, so serving_fleet_ttft_seconds /
        # _e2e_seconds include router queue time and handoff time —
        # numbers no per-replica tracker can see
        if slo is None:
            slo = (NULL_SLO if not recorder.enabled
                   else SLOTracker(registry=self.registry,
                                   prefix="serving_fleet"))
        self.slo = slo
        # per-tier span-latency window (queue/prefill/decode/handoff
        # durations from stitched traces): tier_latency()'s substrate,
        # the breakdown the autoscaler can consume
        self._span_window: deque = deque(maxlen=512)
        # recently seen fleet handles, rid-keyed, for
        # distributed_trace(): done handles are evicted oldest-first
        # past the retention bound, live ones never are
        self._recent_handles: Dict[int, FleetHandle] = {}
        self._trace_retention = 256
        # tenant QoS control plane: per-tenant live-request
        # counts (concurrency cap), token buckets (rate cap, injected-
        # clock driven), and the overload controller's ladder state
        self._tenant_live: Dict[str, int] = {}
        self._tenant_bucket: Dict[str, tuple] = {}
        self._qos_level = 0
        self._qos_level_tick = 0     # tick of the last ladder move

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _init_metrics(self, r) -> None:
        self._m_completed = r.counter(
            "serving_fleet_requests_completed",
            "Fleet requests fully decoded (across failovers/hedges)")
        shed = r.counter(
            "serving_fleet_requests_shed",
            "Fleet requests rejected or abandoned, by reason",
            labelnames=("reason",))
        self._m_shed_family = shed
        self._m_shed_deadline = shed.labels("deadline")
        self._m_shed_overload = shed.labels("overload")
        self._m_shed_outage = shed.labels("outage")
        self._m_quarantined = r.counter(
            "serving_fleet_requests_quarantined",
            "Fleet requests quarantined by their serving replica")
        self._m_dispatches = r.counter(
            "serving_fleet_dispatches",
            "Request dispatches onto replicas (hedges included)")
        self._m_failovers = r.counter(
            "serving_fleet_failovers",
            "In-flight requests re-dispatched onto a survivor after a "
            "replica crash or hang, resuming from their committed "
            "prefix")
        self._m_hedges = r.counter(
            "serving_fleet_hedges",
            "Hedged dispatch resolutions, by which copy won",
            labelnames=("outcome",))
        self._m_hedge_primary = self._m_hedges.labels("primary_won")
        self._m_hedge_hedge = self._m_hedges.labels("hedge_won")
        self._m_restarts = r.counter(
            "serving_fleet_restarts",
            "Supervised replica restarts after a crash")
        self._m_probe_failures = r.counter(
            "serving_fleet_probe_failures",
            "Replica health probes that failed or timed out")
        self._m_queue_age = r.histogram(
            "serving_fleet_queue_age_seconds",
            "Router-queue wait between (re-)enqueue and dispatch",
            buckets=DECODE_LATENCY_BUCKETS)
        self._m_recovery = r.histogram(
            "serving_fleet_recovery_seconds",
            "Wall time from replica loss to serving-ready again",
            buckets=DECODE_LATENCY_BUCKETS)
        g = r.gauge("serving_fleet_replicas",
                    "Replicas by lifecycle state",
                    labelnames=("state",))
        for st in ReplicaState.ALL:
            g.labels(st).set_function(
                lambda s=st: float(sum(1 for c in self._ctls
                                       if c.state() == s)))
        r.gauge("serving_fleet_queue_depth",
                "Requests waiting in the router queue").set_function(
            lambda: float(len(self._queue)))
        r.gauge("serving_fleet_in_flight_requests",
                "Fleet requests currently dispatched to a replica"
                ).set_function(
            lambda: float(sum(c.n_outstanding() for c in self._ctls)))
        # distributed tracing + federation
        self._m_span_seconds = r.histogram(
            "serving_fleet_span_seconds",
            "Stitched distributed-trace span durations by tier and "
            "span (queue / prefill / decode / handoff)",
            labelnames=("tier", "span"),
            buckets=DECODE_LATENCY_BUCKETS)
        self._m_federation_errors = r.counter(
            "serving_fleet_federation_errors",
            "Per-replica snapshot scrapes that failed during metrics "
            "federation (the replica's series are absent from that "
            "federated scrape)")
        # prefix-cache affinity dispatch + KV migration
        self._m_aff_hits = r.counter(
            "serving_fleet_affinity_hits",
            "Dispatches routed to a replica advertising a cached "
            "prefix of the request")
        self._m_aff_misses = r.counter(
            "serving_fleet_affinity_misses",
            "Dispatches for which no replica advertised a usable "
            "cached prefix (counted only while some replica "
            "advertises a digest)")
        self._m_aff_mispredicts = r.counter(
            "serving_fleet_affinity_mispredicts",
            "Affinity dispatches whose advertised prefix turned out "
            "evicted or a bloom false positive at admission — served "
            "as a normal prefill, never wrong")
        self._m_migrations = r.counter(
            "serving_fleet_kv_migrations",
            "Cross-replica prefix-chain KV migrations, by outcome: "
            "ok (chain shipped on the dispatch), stale (advertised "
            "chain already evicted at the source), failed (export "
            "error) — stale/failed degrade to a normal prefill",
            labelnames=("outcome",))
        self._m_migrations_ok = self._m_migrations.labels("ok")
        self._m_migrations_stale = self._m_migrations.labels("stale")
        self._m_migrations_failed = self._m_migrations.labels("failed")
        self._m_migrated_tokens = r.counter(
            "serving_fleet_kv_migrated_tokens",
            "Prefix-chain K/V rows migrated across replicas instead "
            "of being recomputed")
        self._m_migrated_bytes = r.counter(
            "serving_fleet_kv_migrated_bytes",
            "Bytes of prefix-chain K/V values + scales migrated "
            "across replicas")
        # tenant QoS: registered only when the relevant
        # knob is configured, so QoS-off scrapes are byte-unchanged
        cfgf = self.config
        if (cfgf.tenant_max_concurrency is not None
                or cfgf.tenant_rate_per_s is not None):
            self._m_qos_rejections = r.counter(
                "serving_fleet_qos_rejections",
                "Admissions rejected by per-tenant QoS caps, by "
                "reason (rate = token bucket empty, concurrency = "
                "too many live requests)",
                labelnames=("reason",))
        if (cfgf.overload_ttft_p99_ms is not None
                or cfgf.overload_queue_depth is not None):
            self._m_qos_actions = r.counter(
                "serving_fleet_qos_actions",
                "Overload-controller ladder transitions, by action "
                "(degrade_spec_off / degrade_chunk_shrink / "
                "degrade_shed_low / restore)",
                labelnames=("action",))
            r.gauge("serving_fleet_qos_degradation_level",
                    "Overload-controller ladder rung in force (0 = "
                    "healthy, 1 = spec decode off, 2 = + decode "
                    "chunks halved, 3 = + shedding lowest-priority)"
                    ).set_function(lambda: float(self._qos_level))
            self._m_shed_qos = self._m_shed_family.labels("qos")

    @property
    def stats(self) -> dict:
        return {
            "completed": int(self._m_completed.value),
            "shed_deadline": int(self._m_shed_deadline.value),
            "shed_overload": int(self._m_shed_overload.value),
            "shed_outage": int(self._m_shed_outage.value),
            "quarantined": int(self._m_quarantined.value),
            "dispatches": int(self._m_dispatches.value),
            "failovers": int(self._m_failovers.value),
            "hedges_primary_won": int(self._m_hedge_primary.value),
            "hedges_hedge_won": int(self._m_hedge_hedge.value),
            "restarts": int(self._m_restarts.value),
            "probe_failures": int(self._m_probe_failures.value),
            "affinity_hits": int(self._m_aff_hits.value),
            "affinity_misses": int(self._m_aff_misses.value),
            "affinity_mispredicts": int(
                self._m_aff_mispredicts.value),
            "kv_migrations_ok": int(self._m_migrations_ok.value),
            "kv_migrations_stale": int(self._m_migrations_stale.value),
            "kv_migrations_failed": int(
                self._m_migrations_failed.value),
            "kv_migrated_tokens": int(self._m_migrated_tokens.value)}

    # ------------------------------------------------------------------
    # KV wire accounting
    # ------------------------------------------------------------------
    def _kvwire_metrics(self) -> dict:
        """The serving_kvwire_* families, registered LAZILY on first
        wire activity: a wire-off fleet (all-in-process, no faults)
        never touches them, so its scrape stays byte-identical."""
        m = getattr(self, "_m_kvwire", None)
        if m is None:
            r = self.registry
            self._m_kvwire = m = {
                "frames": r.counter(
                    "serving_kvwire_frames",
                    "KV wire frames moved (or refused) across a "
                    "process boundary, by direction (export = "
                    "prefill-tier handoff out, adopt = decode-tier "
                    "handoff in, seed = cached-chain migration, "
                    "control = qos actuation) and outcome (ok, or "
                    "the typed decode failure: magic | version | "
                    "crc | truncated | type | error — every failure "
                    "degrades to re-prefill)",
                    labelnames=("direction", "outcome")),
                "bytes": r.counter(
                    "serving_kvwire_bytes",
                    "Encoded kvwire frame bytes moved across process "
                    "boundaries (header + payload, pre-base64)"),
                "seconds": r.histogram(
                    "serving_kvwire_seconds",
                    "One kvwire encode + transfer + decode round "
                    "trip",
                    buckets=DECODE_LATENCY_BUCKETS)}
        return m

    def _kvwire_count(self, direction: str, outcome: str,
                      nbytes: int = 0,
                      seconds: Optional[float] = None) -> None:
        m = self._kvwire_metrics()
        m["frames"].labels(direction, outcome).inc()
        if nbytes:
            m["bytes"].inc(int(nbytes))
        if seconds is not None:
            m["seconds"].observe(float(seconds))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_deadline: str = "shed",
               tenant: Optional[str] = None,
               priority: int = 0,
               constrain=None) -> FleetHandle:
        """Admit one prompt to the fleet. The submit-time deadline is
        stamped ABSOLUTE here and every later hop — dispatch, failover,
        hedge — carries only the remaining budget, so no retry can
        resurrect a request past its deadline.

        ``tenant`` labels every dispatch hop's analytic
        cost bill — `cost_report()` federates the per-tenant
        serving_request_cost_* counters across the fleet into one
        bill, failovers and hedges included (a re-dispatched request
        bills its recompute to the same tenant).

        ``priority`` is the request's QoS class
        (0..MAX_PRIORITY): the router dispatches the highest waiting
        class first, and replicas with a preemption budget seat it
        ahead of (or in place of) lower classes. Per-tenant admission
        caps (`FleetConfig.tenant_max_concurrency` /
        `tenant_rate_per_s`) reject over-cap submits with the typed
        `TenantCapExceeded`; malformed tenant/priority values raise
        `QoSValidationError` before touching any metric label."""
        if on_deadline not in ("shed", "partial"):
            raise ValueError(f"on_deadline must be 'shed' or "
                             f"'partial', got {on_deadline!r}")
        tenant, priority = validate_tenant_priority(tenant, priority)
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token "
                             "array")
        cspec = None
        cconsumed = 0
        if constrain is not None:
            # typed validation at the ROUTER — an
            # unsupported/invalid grammar raises ConstraintError here
            # instead of bouncing off every replica as a shed. The
            # compile is cache-shared with the replicas (same grammar
            # hash), so it costs once per distinct grammar
            from deeplearning4j_tpu_torch.serving.constrain import (
                compile_grammar, normalize_constraint)
            cspec, cconsumed = normalize_constraint(constrain)
            compile_grammar(
                cspec,
                int(self.cfg.vocab_size) if self.cfg is not None
                else 256)
        now = self._clock()
        with self._lock:
            if not self._accepting:
                raise EngineStopped("fleet router is stopped")
            if self._draining:
                raise EngineDraining(
                    "fleet router is draining: admissions are closed")
            if len(self._queue) >= self.config.max_queue:
                self._m_shed_overload.inc()
                raise OverloadError(
                    f"router queue full ({self.config.max_queue})")
            eff = int(max_new_tokens) if max_new_tokens else None
            if eff is not None and eff < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if eff is None:
                eff = self._default_max_new()
            if (self.cfg is not None
                    and prompt.shape[0] + eff > self.cfg.max_len):
                raise ValueError(
                    f"prompt {prompt.shape[0]} + {eff} new tokens "
                    f"exceeds max_len={self.cfg.max_len}")
            # per-tenant admission caps: checked LAST so a
            # rejected-for-other-reasons submit never burns a rate
            # token, and the live count only ever increments for a
            # handle that actually exists
            self._qos_admit_locked(tenant, now)
            fr = FleetHandle(
                next(self._rids), prompt, eff,
                now + deadline_s if deadline_s is not None else None,
                on_deadline)
            fr.tenant = tenant
            fr.priority = priority
            fr._constrain = cspec
            fr._consumed0 = int(cconsumed)
            tkey = tenant or "default"
            self._tenant_live[tkey] = (
                self._tenant_live.get(tkey, 0) + 1)
            fr._on_terminal = self._fleet_terminal
            fr.trace = self.recorder.start_trace(fr.rid)
            if self.recorder.enabled:
                self._remember_locked(fr)
            fr.trace.add("submit", prompt_tokens=int(prompt.shape[0]),
                         max_new_tokens=int(eff),
                         deadline_s=(float(deadline_s)
                                     if deadline_s is not None
                                     else None),
                         **({"tenant": fr.tenant}
                            if fr.tenant is not None else {}),
                         **({"priority": priority}
                            if priority else {}))
            fr._queued_at = now
            self._queue.append(fr)
            fr.trace.add("queued", depth=len(self._queue))
        return fr

    def _default_max_new(self) -> int:
        for ctl in self._ctls:
            eng = getattr(ctl.replica, "engine", None)
            if eng is not None:
                return int(eng.config.max_new_tokens)
        return 32

    # ------------------------------------------------------------------
    # tenant QoS admission caps + overload control
    # ------------------------------------------------------------------
    def _qos_admit_locked(self, tenant: Optional[str],
                          now: float) -> None:
        """Per-tenant cap enforcement at admission (caller holds the
        lock): concurrency first (no rate token burned on a
        concurrency reject), then the token bucket. Raises the typed
        `TenantCapExceeded`; every rejection is a metered metric and
        a ``qos`` trace event."""
        cfgf = self.config
        if (cfgf.tenant_max_concurrency is None
                and cfgf.tenant_rate_per_s is None):
            return
        t = tenant or "default"
        if (cfgf.tenant_max_concurrency is not None
                and self._tenant_live.get(t, 0)
                >= int(cfgf.tenant_max_concurrency)):
            self._qos_reject(t, "concurrency")
        if cfgf.tenant_rate_per_s is not None:
            rate = float(cfgf.tenant_rate_per_s)
            burst = (int(cfgf.tenant_rate_burst)
                     if cfgf.tenant_rate_burst is not None
                     else max(1, int(2 * rate)))
            level, last = self._tenant_bucket.get(
                t, (float(burst), now))
            level = min(float(burst),
                        level + max(0.0, now - last) * rate)
            if level < 1.0:
                self._tenant_bucket[t] = (level, now)
                self._qos_reject(t, "rate")
            self._tenant_bucket[t] = (level - 1.0, now)

    def _qos_reject(self, tenant: str, reason: str) -> None:
        m = getattr(self, "_m_qos_rejections", None)
        if m is not None:
            m.labels(reason).inc()
        if self.recorder.enabled:
            self.recorder.record("qos", action="reject",
                                 tenant=tenant, reason=reason)
        raise TenantCapExceeded(
            f"tenant {tenant!r} over its {reason} cap")

    def _fleet_terminal(self, fr: FleetHandle) -> None:
        """The ONE fleet-handle terminal hook: release the tenant's
        concurrency-cap seat, then finalize the stitched trace (when
        recording)."""
        t = fr.tenant or "default"
        with self._lock:
            n = self._tenant_live.get(t, 0) - 1
            if n > 0:
                self._tenant_live[t] = n
            else:
                self._tenant_live.pop(t, None)
        if self.recorder.enabled:
            self._finalize_trace(fr)

    def _qos_tick(self, now: float) -> None:
        """The SLO-aware overload controller: every
        overload_check_every_ticks ticks, compare the fleet's TTFT
        p99 (stitched-trace SLO tracker) and/or router queue depth
        against their targets and walk the degradation ladder ONE
        rung — degrading in cost order (spec decode off -> decode
        chunks halved -> shed lowest-priority/over-cap), restoring in
        reverse after overload_cooldown_ticks healthy ticks. Knob
        actuation reaches in-process replicas via
        `engine.qos_control`; every transition is a typed ``qos``
        event + metered action."""
        cfgf = self.config
        if (cfgf.overload_ttft_p99_ms is None
                and cfgf.overload_queue_depth is None):
            return
        if self._ticks % max(1, cfgf.overload_check_every_ticks):
            return
        overloaded = False
        if (cfgf.overload_queue_depth is not None
                and len(self._queue) > int(cfgf.overload_queue_depth)):
            overloaded = True
        if not overloaded and cfgf.overload_ttft_p99_ms is not None:
            try:
                p99 = self.slo.report().get("ttft_p99_ms")
            except Exception:
                p99 = None
            if p99 is not None and p99 > float(
                    cfgf.overload_ttft_p99_ms):
                overloaded = True
        if overloaded:
            if self._qos_level < 3:
                self._qos_level += 1
                self._qos_level_tick = self._ticks
                step = {1: "spec_off", 2: "chunk_shrink",
                        3: "shed_low"}[self._qos_level]
                self._qos_apply()
                self._qos_record("degrade", step)
            if self._qos_level >= 3:
                self._qos_shed_low()
            return
        if (self._qos_level > 0
                and self._ticks - self._qos_level_tick
                >= int(cfgf.overload_cooldown_ticks)):
            self._qos_level -= 1
            self._qos_level_tick = self._ticks
            self._qos_apply()
            self._qos_record("restore", {0: "none", 1: "spec_off",
                                         2: "chunk_shrink"}[
                                             self._qos_level])

    def _qos_record(self, action: str, step: str) -> None:
        m = getattr(self, "_m_qos_actions", None)
        if m is not None:
            m.labels(f"{action}_{step}").inc()
        if self.recorder.enabled:
            self.recorder.record("qos", action=action, step=step,
                                 level=self._qos_level)

    def _qos_apply(self) -> None:
        """Push the current ladder rung's knob state to every live
        replica (idempotent — qos_control sets absolute state, so
        re-applying a rung is a no-op). In-process engines are called
        directly; subprocess replicas actuate over the worker pipe as
        one kvwire CONTROL frame — chunk_shrink
        resolves against the WORKER's base chunk, which this side
        cannot see."""
        spec_off = self._qos_level >= 1
        shrink = self._qos_level >= 2
        for ctl in self._ctls:
            if ctl.dead:
                continue
            eng = getattr(ctl.replica, "engine", None)
            qc = getattr(eng, "qos_control", None)
            if qc is None:
                rqc = getattr(ctl.replica, "qos_control", None)
                if rqc is None:
                    continue
                try:
                    nbytes = rqc(spec_off=spec_off,
                                 chunk_shrink=shrink)
                    self._kvwire_count("control", "ok", nbytes)
                except Exception:
                    log.exception("wire qos_control failed on "
                                  "replica %d", ctl.id)
                continue
            try:
                base = eng._base_chunk
                qc(spec_off=spec_off,
                   decode_chunk=(max(1, base // 2) if shrink else 0))
            except Exception:    # a degradation knob must never kill
                log.exception("qos_control failed on replica %d",
                              ctl.id)

    def _qos_shed_low(self) -> None:
        """Ladder rung 3: shed queued work cheapest-first — lowest
        priority class first, over-concurrency-cap tenants first
        within a class, newest arrival first (it has waited least) —
        at most overload_shed_per_tick per tick, typed shed reason
        "qos"."""
        cap = self.config.tenant_max_concurrency
        with self._lock:
            entries = list(enumerate(self._queue))
            if not entries:
                return

            def over_cap(fr):
                return (cap is not None
                        and self._tenant_live.get(
                            fr.tenant or "default", 0) > int(cap))

            entries.sort(key=lambda e: (e[1].priority,
                                        0 if over_cap(e[1]) else 1,
                                        -e[0]))
            victims = [fr for _, fr in entries if not fr.done()][
                :max(1, int(self.config.overload_shed_per_tick))]
            for fr in victims:
                self._queue.remove(fr)
        for fr in victims:
            self._shed(fr, "qos", OverloadError(
                f"fleet overloaded (qos level {self._qos_level}): "
                f"request {fr.rid} shed lowest-priority-first"))

    # ------------------------------------------------------------------
    # distributed tracing
    # ------------------------------------------------------------------
    def _remember_locked(self, fr: FleetHandle) -> None:
        """Retain ``fr`` for distributed_trace(); evict the oldest
        DONE handles past the retention bound (live ones are never
        evicted — their trace is still being built)."""
        self._recent_handles[fr.rid] = fr
        if len(self._recent_handles) <= self._trace_retention:
            return
        for rid in list(self._recent_handles):
            if len(self._recent_handles) <= self._trace_retention:
                break
            if self._recent_handles[rid].done():
                del self._recent_handles[rid]

    def _hop_phase(self, fr: FleetHandle) -> str:
        """Which phase the next dispatch serves — the flat router is
        single-phase; the tiered router reads the request."""
        return "serving"

    def _hop_record(self, hop: _Hop, ctl: Optional[_ReplicaCtl],
                    status: str) -> dict:
        """One hop's capture: identity, clock offset, and the replica-
        side trace (read by reference for in-process replicas, the
        pipe-shipped copy for subprocess ones)."""
        inner = hop.inner
        # Event tuples pass through by reference (immutable) — the
        # as_dict conversion happens lazily at export time, not on
        # the serving path (the ≤2% fleet-overhead bound)
        tr = getattr(inner, "trace", None)
        if tr is not None and getattr(tr, "events", None):
            evs = list(tr.events)
        else:
            evs = list(getattr(inner, "trace_events", None) or [])
        replica = ctl.replica if ctl is not None else None
        return {"hop": hop.seq, "replica": hop.replica_id,
                "tier": ctl.tier if ctl is not None else "?",
                "kind": getattr(replica, "kind", "?"),
                "phase": hop.phase, "hedge": hop.hedge,
                "status": status,
                "clock_offset": float(getattr(replica, "clock_offset",
                                              0.0) or 0.0),
                "dispatched_ts": hop.trace_ts,
                "events": evs}

    def _record_hop(self, fr: FleetHandle, hop: _Hop,
                    ctl: Optional[_ReplicaCtl], status: str) -> None:
        if hop.recorded or not self.recorder.enabled:
            return
        hop.recorded = True
        try:
            fr._hops_done.append(self._hop_record(hop, ctl, status))
        except Exception:
            log.exception("hop capture failed (rid %d, replica %d)",
                          fr.rid, hop.replica_id)

    def _finalize_trace(self, fr: FleetHandle) -> None:
        """Terminal hook: stitch the request's router trace with its
        captured hops into ONE distributed trace, feed the fleet SLO
        rollup (TTFT/e2e now include queue + handoff time), and bank
        the per-tier span durations for tier_latency()."""
        if not self.recorder.enabled or fr._stitched is not None:
            return
        st = stitch(fr.rid, fr.trace.events, fr._hops_done)
        fr._stitched = st
        tok = next((e for e in st.events
                    if e.kind in ("prefill_done", "decode_chunk")
                    and e.data.get("tokens")), None)
        if tok is not None:
            self.slo.first_token(st, tok.ts)
        self.slo.finished(st)
        for s in st.spans:
            tier = s.get("tier") or "fleet"
            dur = max(0.0, s["t1"] - s["t0"])
            if s["name"] == "hop":
                continue       # sub-spans carry the usable breakdown
            self._m_span_seconds.labels(tier, s["name"]).observe(dur)
            self._span_window.append((tier, s["name"], dur))

    def distributed_trace(self, rid: int) -> Optional[dict]:
        """THE stitched view of one fleet request: every router event
        and every hop's replica events on one aligned timeline, plus
        the derived queue/prefill/decode/handoff spans. Completed
        requests return their cached terminal stitch; in-flight ones
        stitch the live hop snapshots. None when the rid has aged out
        (or tracing is disabled)."""
        fr = self._recent_handles.get(int(rid))
        if fr is None:
            return None
        st = fr._stitched
        if st is None:
            hops = list(fr._hops_done)
            with self._lock:
                live = [(ctl, hop) for ctl in self._ctls
                        for hop in ctl.outstanding.get(fr.rid, ())]
            for ctl, hop in live:
                hops.append(self._hop_record(hop, ctl, "running"))
            st = stitch(fr.rid, fr.trace.events, hops)
        return st.to_dict()

    def tier_latency(self) -> Dict[str, dict]:
        """Windowed per-tier span-latency breakdown from stitched
        traces: ``{tier: {span: {p50_ms, p95_ms, p99_ms, n}}}`` — the
        signal an occupancy autoscaler can consume to scale on
        latency, and the `slo_report()` "tiers" section."""
        window = list(self._span_window)
        grouped: Dict[tuple, List[float]] = {}
        for tier, span, dur in window:
            grouped.setdefault((tier, span), []).append(dur)
        out: Dict[str, dict] = {}
        for (tier, span), vals in sorted(grouped.items()):
            vals.sort()
            cell = {"n": len(vals)}
            for q in (50, 95, 99):
                i = min(len(vals) - 1,
                        int(round(q / 100.0 * (len(vals) - 1))))
                cell[f"p{q}_ms"] = round(vals[i] * 1e3, 3)
            out.setdefault(tier, {})[span] = cell
        return out

    def slo_report(self) -> dict:
        """The fleet `/slo` body: the stitched-trace SLO window
        (TTFT/e2e include router queue + handoff time) plus the
        per-tier span breakdown."""
        rep = self.slo.report()
        rep["tiers"] = self.tier_latency()
        return rep

    def timeline(self, n: Optional[int] = None) -> dict:
        """Fleet-wide Perfetto export: the router's queue/dispatch
        lanes as one process group plus one process group per replica
        (``<tier>/replica <id>``) — in-process replicas render their
        live recorder ring, subprocess replicas render the pipe-
        shipped hop traces of recently completed requests — all
        re-based to one shared t=0."""
        groups = [{"pid": 0, "name": "fleet router", "router": True,
                   "events": self.recorder.recent(n)}]
        with self._lock:
            ctls = list(self._ctls)
            recents = [fr for fr in self._recent_handles.values()
                       if fr._stitched is not None]
        for ctl in ctls:
            name = f"{ctl.tier}/replica {ctl.id}"
            eng = getattr(ctl.replica, "engine", None)
            if eng is not None and not ctl.dead:
                groups.append({"pid": ctl.id + 1, "name": name,
                               "events": eng.recorder.recent(n),
                               "num_slots": eng._num_slots})
                continue
            evs = [e for fr in recents for e in fr._stitched.events
                   if e.data.get("src") == "replica"
                   and e.data.get("replica") == ctl.id]
            evs.sort(key=lambda e: e.ts)
            if evs:
                groups.append({"pid": ctl.id + 1, "name": name,
                               "events": evs[-(n or len(evs)):],
                               "num_slots": ctl.capacity})
        return fleet_timeline_json(groups)

    # ------------------------------------------------------------------
    # metrics federation
    # ------------------------------------------------------------------
    def federate(self) -> dict:
        """One scrape for the whole fleet: the router's own registry
        plus every live replica's snapshot (in-process registries read
        directly, subprocess ones scraped over `/metrics.json`),
        merged under ``tier=``/``replica=`` labels — counters summed,
        histogram buckets merged bucket-exact, gauges kept
        per-replica (observability/federation.py has the contract).
        A replica that fails to answer is skipped and counted in
        ``serving_fleet_federation_errors_total``; federation
        degrades, it never takes the fleet scrape down."""
        parts = [({"tier": "router", "replica": "router"},
                  json_snapshot(self.registry))]
        with self._lock:
            ctls = list(self._ctls)
        for ctl in ctls:
            if ctl.dead or ctl.scaled_down:
                continue
            try:
                eng = getattr(ctl.replica, "engine", None)
                if eng is not None:
                    snap = json_snapshot(eng.registry)
                else:
                    url = getattr(ctl.replica, "probe_url", None)
                    if url is None:
                        continue
                    with urllib.request.urlopen(
                            url + "/metrics.json",
                            timeout=self.config.probe_timeout_s
                            ) as resp:
                        snap = json.loads(resp.read().decode())
                parts.append(({"tier": ctl.tier, "replica": ctl.id},
                              snap))
            except Exception as e:
                self._m_federation_errors.inc()
                log.warning("federation: replica %d snapshot failed "
                            "(%s)", ctl.id, e)
        return merge_snapshots(parts)

    def federated_text(self) -> str:
        """The federated scrape in Prometheus text format — what the
        router's `/metrics` serves when wired via
        ``MetricsServer(snapshot=router.federate)``."""
        from deeplearning4j_tpu_torch.observability.export import \
            snapshot_prometheus_text
        return snapshot_prometheus_text(self.federate())

    # ------------------------------------------------------------------
    # profiling & cost attribution
    # ------------------------------------------------------------------
    def cost_report(self) -> dict:
        """ONE fleet-wide per-tenant bill: the replicas' per-tenant
        serving_request_cost_flops/_bytes + serving_tenant_tokens
        counters, federated (counters sum across tiers/replicas by the
        federation merge) and re-grouped by tenant. The exactness
        contract: every tenant row equals the sum of that tenant's
        per-request bills across the whole fleet, prefix-cache hits
        and migrated chains billing only the tokens actually
        computed."""
        snap = self.federate()
        tenants: Dict[str, dict] = {}

        def _cell(t: str) -> dict:
            return tenants.setdefault(
                t, {"flops": 0.0, "bytes": 0.0,
                    "prefill_tokens": 0, "decode_tokens": 0})

        for fam, key in (("serving_request_cost_flops", "flops"),
                         ("serving_request_cost_bytes", "bytes")):
            for s in snap.get(fam, {}).get("samples", ()):
                t = (s.get("labels") or {}).get("tenant", "default")
                _cell(t)[key] += float(s.get("value", 0.0))
        for s in snap.get("serving_tenant_tokens",
                          {}).get("samples", ()):
            labels = s.get("labels") or {}
            t = labels.get("tenant", "default")
            kind = labels.get("kind", "decode")
            _cell(t)[f"{kind}_tokens"] = (
                _cell(t).get(f"{kind}_tokens", 0)
                + int(s.get("value", 0)))
        ranked = dict(sorted(tenants.items(),
                             key=lambda kv: -kv[1]["flops"]))
        return {"tenants": ranked,
                "total_flops": sum(v["flops"]
                                   for v in tenants.values()),
                "total_bytes": sum(v["bytes"]
                                   for v in tenants.values())}

    def profile_report(self) -> dict:
        """Per-replica profiling reports (cost tables, MFU,
        rooflines) for every in-process replica, keyed
        ``"<tier>/<id>"`` — subprocess replicas expose the same data
        on their own `/debugz`; the federated scrape already carries
        their counters."""
        out = {}
        with self._lock:
            ctls = list(self._ctls)
        for ctl in ctls:
            eng = getattr(ctl.replica, "engine", None)
            if eng is None or ctl.dead or ctl.scaled_down:
                continue
            try:
                out[f"{ctl.tier}/{ctl.id}"] = eng.profile_report()
            except Exception as e:
                out[f"{ctl.tier}/{ctl.id}"] = {"error": str(e)}
        return out

    def profilez(self, seconds) -> tuple:
        """Fleet-fanned on-demand capture: start one
        bounded torch.profiler capture (the engine's `EngineProfiler`
        session) on EVERY live replica — in-process
        engines directly, subprocess ones over their real
        `/profilez?seconds=N` endpoint. Returns ``(status, body)``
        with the per-replica outcomes; 200 when at least one replica
        started capturing, 503 when none could (each replica's
        single-flight/unsupported semantics are its own)."""
        results = {}
        started = 0
        with self._lock:
            ctls = list(self._ctls)
        for ctl in ctls:
            if ctl.dead or ctl.scaled_down:
                continue
            name = f"{ctl.tier}/{ctl.id}"
            try:
                eng = getattr(ctl.replica, "engine", None)
                if eng is not None:
                    code, body = eng.profilez(seconds)
                else:
                    url = getattr(ctl.replica, "probe_url", None)
                    if url is None:
                        results[name] = {"status": 503,
                                         "error": "unreachable"}
                        continue
                    req = urllib.request.urlopen(
                        f"{url}/profilez?seconds={float(seconds)}",
                        timeout=self.config.probe_timeout_s)
                    with req as resp:
                        code = resp.getcode()
                        body = json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                code, body = e.code, {"error": str(e)}
            except Exception as e:
                code, body = 503, {"error": f"{type(e).__name__}: {e}"}
            results[name] = {"status": int(code), **body}
            if code == 200:
                started += 1
        return ((200 if started else 503),
                {"replicas": results, "started": started})

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def pending(self) -> bool:
        with self._lock:
            return (bool(self._queue)
                    or any(c.outstanding for c in self._ctls)
                    or any(not c.dead and c.replica.busy()
                           for c in self._ctls))

    def run_pending(self, max_idle_ticks: int = 4000) -> int:
        """Drive scheduling rounds on the caller thread until the queue
        and every replica are drained. ``max_idle_ticks`` bounds
        consecutive no-progress rounds (restart backoffs and hang
        detection advance within it) — a wedged fleet sheds its work
        typed instead of spinning forever."""
        n = idle = 0
        while self.pending():
            if self.tick():
                idle = 0
            else:
                idle += 1
                if idle >= max_idle_ticks:
                    self._shed_stuck("router made no progress "
                                     f"in {max_idle_ticks} rounds")
                    break
                time.sleep(0.0005)
            n += 1
        return n

    def tick(self) -> bool:
        """One scheduling round: injected faults -> crash detection ->
        restart supervision -> probes -> dispatch (failover/hedge
        aware) -> replica steps -> harvest -> hang detection. Returns
        whether the round made progress."""
        now = self._clock()
        tick = self._ticks
        self._ticks += 1
        self._apply_injections(tick)
        progressed = self._detect_crashes(now)
        progressed |= self._tick_restarts(now)
        if tick % max(1, self.config.probe_every_ticks) == 0:
            self._probe_all(now)
        if tick % max(1, self.config.advertise_every_ticks) == 0:
            self._push_advertised()
        progressed |= self._dispatch(now) > 0
        for ctl in self._ctls:
            if ctl.dead or not ctl.replica.alive():
                continue
            try:
                progressed |= bool(ctl.replica.step())
            except ReplicaCrashed:
                progressed |= self._on_replica_loss(ctl, "crash", now)
            except Exception as e:       # a replica must never kill
                log.exception("replica %d step failed", ctl.id)
                self._passive_failure(ctl)
                progressed |= self._on_replica_loss(
                    ctl, f"step error: {e}", now)
        progressed |= self._harvest(self._clock()) > 0
        self._detect_hangs()
        self._qos_tick(now)
        return progressed

    def _push_advertised(self) -> None:
        """Eviction bias for advertised chains: union the
        live digests' top chains and install the set on every replica
        — their radix caches then evict advertised chains LAST, so a
        chain the fleet is actively routing by (or about to migrate)
        is not the first casualty of a local pool squeeze. Pushed
        only when the set changed; an idle fleet costs the pipes
        nothing."""
        hot: set = set()
        for ctl in self._ctls:
            if ctl.dead or not ctl.digest:
                continue
            hot.update(int(h) for h, _ in ctl.digest.get("top", ()))
        if hot == getattr(self, "_advertised_pushed", None):
            return
        self._advertised_pushed = hot
        for ctl in self._ctls:
            if ctl.dead:
                continue
            setter = getattr(ctl.replica, "set_advertised", None)
            if setter is None:
                continue
            try:
                setter(hot)
            except Exception:
                log.debug("advertised-set push to replica %d failed",
                          ctl.id, exc_info=True)

    def start(self) -> "Router":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_flag = False
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True,
                                            name="fleet-router")
            self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if drain:
            self.drain(wait=True)
        self._stop_flag = True
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._accepting = False
        self.close()

    def close(self) -> None:
        for ctl in self._ctls:
            try:
                ctl.replica.close()
            except Exception:
                pass

    def _worker(self) -> None:
        while not self._stop_flag:
            if not self.tick():
                time.sleep(0.001)

    # ------------------------------------------------------------------
    # drain / rolling reload
    # ------------------------------------------------------------------
    def drain(self, wait: bool = True,
              timeout: Optional[float] = None) -> "Router":
        """Fleet-wide graceful drain: the router's `/readyz` flips
        not-ready and `submit()` raises `EngineDraining` from this
        instant; queued and in-flight requests finish normally (the
        queue keeps dispatching — residents are never shed). `resume()`
        reopens admissions."""
        self._draining = True
        if wait:
            self._await(lambda: not self.pending(), timeout)
        return self

    def resume(self) -> None:
        self._draining = False

    def rolling_reload(self, source, step: Optional[int] = None,
                       timeout: Optional[float] = 120.0) -> List[int]:
        """Zero-downtime weight rollout: ONE replica at a time is
        drained out of rotation (the survivors keep serving the
        queue), hot-reloads its weights, and returns to rotation.
        Returns the checkpoint step each replica loaded."""
        loaded = []
        for ctl in self._ctls:
            if ctl.dead:
                continue
            ctl.draining = True
            try:
                self._await(lambda: not ctl.outstanding, timeout)
                loaded.append(int(ctl.replica.reload(source,
                                                     step=step)))
            finally:
                ctl.draining = False
        return loaded

    def _await(self, cond: Callable[[], bool],
               timeout: Optional[float]) -> None:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        idle = 0
        while not cond():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("fleet wait timed out")
            if self._thread is None:
                if not self.tick():
                    idle += 1
                    time.sleep(0.0005)
                    if idle > 4000 and not self.pending():
                        break
            else:
                time.sleep(0.002)

    # ------------------------------------------------------------------
    # fault injection + supervision
    # ------------------------------------------------------------------
    def _ctl(self, replica_id: int) -> Optional[_ReplicaCtl]:
        for c in self._ctls:
            if c.id == int(replica_id):
                return c
        return None

    def _apply_injections(self, tick: int) -> None:
        inj = self._injector
        if inj is None:
            return
        if hasattr(inj, "check_kill"):
            rid = inj.check_kill(tick)
            if rid is not None:
                ctl = self._ctl(rid)
                if ctl is not None and not ctl.dead:
                    log.warning("injected kill: replica %d at tick %d",
                                rid, tick)
                    ctl.replica.kill()
        if hasattr(inj, "check_hang"):
            rid = inj.check_hang(tick)
            if rid is not None:
                ctl = self._ctl(rid)
                if ctl is not None and not ctl.dead:
                    log.warning("injected hang: replica %d at tick %d",
                                rid, tick)
                    ctl.replica.set_hung(True)
        if hasattr(inj, "check_slow"):
            v = inj.check_slow(tick)
            if v is not None:
                ctl = self._ctl(v[0])
                if ctl is not None:
                    log.warning("injected slowdown: replica %d "
                                "+%.3fs/step", v[0], v[1])
                    ctl.replica.set_slow(v[1])

    def _detect_crashes(self, now: float) -> bool:
        progressed = False
        for ctl in self._ctls:
            if not ctl.dead and not ctl.replica.alive():
                progressed |= self._on_replica_loss(ctl, "crash", now)
        return progressed

    def _on_replica_loss(self, ctl: _ReplicaCtl, reason: str,
                         now: float) -> bool:
        """A replica is gone (crashed, killed, or declared hung): mark
        it dead, schedule a supervised restart under the consecutive-
        crash budget, and fail its in-flight requests over."""
        if ctl.dead:
            return False
        ctl.dead = True
        ctl.killed_at = now
        ctl.consec_crashes += 1
        ctl.ready = False
        ctl.digest = None            # its cache died with it
        cfgf = self.config
        if ctl.consec_crashes <= cfgf.max_restarts:
            backoff = min(
                cfgf.restart_backoff_base_s
                * (2 ** (ctl.consec_crashes - 1)),
                cfgf.restart_backoff_max_s)
            ctl.next_restart_at = now + backoff
            log.error("replica %d lost (%s); restart %d/%d in %.3fs",
                      ctl.id, reason, ctl.consec_crashes,
                      cfgf.max_restarts, backoff)
        else:
            ctl.next_restart_at = None
            log.error("replica %d lost (%s); consecutive-crash budget "
                      "exhausted (%d) — staying dead", ctl.id, reason,
                      cfgf.max_restarts)
        self._failover_outstanding(ctl, now)
        return True

    def _failover_outstanding(self, ctl: _ReplicaCtl,
                              now: float) -> None:
        """Requeue a dead replica's in-flight requests at the queue
        FRONT, each resuming from its committed prefix. A request
        whose hedge twin is still live just drops this hop (the hedge
        IS the failover); one already past its deadline is shed typed
        `deadline` — never resurrected."""
        with self._lock:
            hops_by_fr = list(ctl.outstanding.items())
            ctl.outstanding = {}
            for fr_rid, hops in hops_by_fr:
                for hop in hops:
                    fr = hop.fr
                    if fr.done():
                        continue
                    inner = hop.inner
                    # capture the dying hop's trace NOW:
                    # an in-process engine's ring is still readable
                    # after the kill; a SIGKILLed worker left only
                    # what it streamed — the stitched trace shows
                    # the truncation honestly either way
                    self._record_hop(
                        fr, hop, ctl,
                        "completed" if (inner.done() and inner.status
                                        == RequestStatus.COMPLETED)
                        else "lost")
                    if (inner.done()
                            and inner.status == RequestStatus.COMPLETED):
                        # the result survived the crash (it was already
                        # on this side of the process boundary)
                        self._resolve_success(fr, hop)
                        continue
                    if self._live_hops(fr, exclude=hop):
                        continue       # hedge twin still serving it
                    fr._committed = hop.committed()
                    if fr._committed.shape[0] >= fr.max_new_tokens:
                        self._resolve_success(fr, hop)
                        continue
                    if (fr.deadline_at is not None
                            and now > fr.deadline_at):
                        self._shed(fr, "deadline", DeadlineExceeded(
                            f"fleet request {fr.rid} past deadline "
                            f"with {fr._committed.shape[0]}/"
                            f"{fr.max_new_tokens} tokens at replica "
                            f"{ctl.id}'s loss"))
                        continue
                    self._prepare_failover(fr, ctl)
                    fr._failover_from = ctl.id
                    fr._failovers += 1
                    fr.status = RequestStatus.QUEUED
                    fr._queued_at = now
                    self._m_failovers.inc()
                    self._queue.appendleft(fr)

    def _tick_restarts(self, now: float) -> bool:
        progressed = False
        for ctl in self._ctls:
            if (not ctl.dead or ctl.next_restart_at is None
                    or now < ctl.next_restart_at):
                continue
            try:
                ctl.replica.restart()
            except Exception as e:
                ctl.consec_crashes += 1
                if ctl.consec_crashes <= self.config.max_restarts:
                    ctl.next_restart_at = now + min(
                        self.config.restart_backoff_base_s
                        * (2 ** (ctl.consec_crashes - 1)),
                        self.config.restart_backoff_max_s)
                    log.error("replica %d restart failed (%s); "
                              "retrying", ctl.id, e)
                else:
                    ctl.next_restart_at = None
                    log.error("replica %d restart failed (%s); budget "
                              "exhausted", ctl.id, e)
                continue
            ctl.dead = False
            ctl.unhealthy = False
            ctl.next_restart_at = None
            ctl.no_progress = 0
            ctl.digest = None        # fresh engine, empty cache
            ctl.restarts += 1
            ctl.breaker_failures = 0
            ctl.breaker_open_until = 0.0
            self._m_restarts.inc()
            if ctl.killed_at is not None:
                self._m_recovery.observe(max(0.0, now - ctl.killed_at))
                ctl.killed_at = None
            log.info("replica %d restarted (restart #%d)", ctl.id,
                     ctl.restarts)
            progressed = True
        return progressed

    def _probe_all(self, now: float) -> None:
        inj = self._injector
        for ctl in self._ctls:
            if ctl.dead:
                continue
            try:
                if (inj is not None and hasattr(inj, "check_probe")
                        and inj.check_probe(ctl.id)):
                    raise RuntimeError(
                        f"injected probe failure for replica {ctl.id}")
                h = ctl.replica.probe()
            except ReplicaCrashed:
                continue         # crash detection owns this case
            except Exception:
                self._m_probe_failures.inc()
                ctl.consec_probe_failures += 1
                if (ctl.consec_probe_failures
                        >= self.config.probe_failure_threshold):
                    if not ctl.unhealthy:
                        log.warning("replica %d out of rotation "
                                    "(%d consecutive probe failures)",
                                    ctl.id, ctl.consec_probe_failures)
                    ctl.unhealthy = True
                    ctl.ready = False
                continue
            if ctl.unhealthy:
                log.info("replica %d probe recovered; back in "
                         "rotation", ctl.id)
            ctl.consec_probe_failures = 0
            ctl.unhealthy = False
            ctl.last_health = h if isinstance(h, dict) else {}
            ctl.ready = bool(ctl.last_health.get("ready", False))
            # prefix-cache advertisement capture: from the
            # probe body, or — subprocess replicas between HTTP
            # probes — the digest its worker piggybacked on the pipe
            dg = (ctl.last_health.get("prefix_digest")
                  or getattr(ctl.replica, "prefix_digest", None))
            if dg:
                ctl.digest, ctl.digest_at = dg, now

    def _detect_hangs(self) -> None:
        """A replica with in-flight work that commits nothing for
        ``hang_ticks`` consecutive rounds is declared hung — the
        wedged-grant mode a liveness probe cannot see — and handled
        exactly like a crash (in-flight fails over; supervised restart
        replaces the wedged engine)."""
        now = self._clock()
        for ctl in self._ctls:
            if ctl.dead or not ctl.outstanding:
                ctl.no_progress = 0
                continue
            mark = (sum(int(np.asarray(h.inner.generated).shape[0])
                        for hs in ctl.outstanding.values()
                        for h in hs),
                    sum(int(h.inner.done())
                        for hs in ctl.outstanding.values()
                        for h in hs))
            if mark != ctl.last_progress_mark:
                ctl.last_progress_mark = mark
                ctl.last_progress_t = now
                ctl.no_progress = 0
                continue
            ctl.no_progress += 1
            if (ctl.no_progress >= self.config.hang_ticks
                    and now - ctl.last_progress_t
                    >= self.config.hang_min_s):
                log.error("replica %d declared HUNG (%d rounds with "
                          "in-flight work and zero progress)", ctl.id,
                          ctl.no_progress)
                try:
                    ctl.replica.set_hung(False)   # un-freeze first so
                except Exception:                 # kill() can land
                    pass
                ctl.replica.kill()
                self._on_replica_loss(ctl, "hang detected", now)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _dispatchable(self, ctl: _ReplicaCtl, now: float,
                      headroom: int = 0) -> bool:
        return (not ctl.dead and not ctl.draining and not ctl.unhealthy
                and ctl.ready and now >= ctl.breaker_open_until
                and ctl.n_outstanding() < ctl.capacity + headroom
                and ctl.replica.alive())

    def _score(self, ctl: _ReplicaCtl) -> float:
        """Least-occupancy, health-weighted: occupancy fraction plus
        an error-EMA penalty — a replica that has been failing needs a
        visibly emptier queue before it wins dispatches again."""
        return (ctl.n_outstanding() / ctl.capacity
                + 2.0 * ctl.err_ema)

    # ------------------------------------------------------------------
    # prefix-cache affinity
    # ------------------------------------------------------------------
    def _request_hashes(self, fr: FleetHandle,
                        page_size: int) -> List[int]:
        hs = fr._chain_hashes.get(page_size)
        if hs is None:
            hs = chain_hashes(fr.prompt, page_size)
            fr._chain_hashes[page_size] = hs
        return hs

    def _affinity_tokens(self, ctl: _ReplicaCtl, fr: FleetHandle,
                         now: float) -> tuple:
        """``(cached_tokens, chain_hash)`` the replica's advertised
        digest claims for ``fr``'s prompt — (0, None) when the digest
        is absent or older than the staleness TTL (the generation-
        stamped digest goes stale the moment probes stop refreshing
        it, and a stale advertisement must not attract traffic)."""
        dg = ctl.digest
        if (not dg
                or now - ctl.digest_at
                > self.config.affinity_digest_ttl_s):
            return 0, None
        ps = int(dg.get("page_size", 0) or 0)
        if ps <= 0:
            return 0, None
        toks, h = digest_lookup(dg, self._request_hashes(fr, ps))
        return min(toks, int(fr.prompt.shape[0])), h

    def _affinity_applies(self, fr: FleetHandle) -> bool:
        """Which dispatches affinity scores — every one on the flat
        router; only prefill-phase hops on the tiered router (the
        decode tier receives its KV via the cross-tier handoff)."""
        return True

    def _affinity_bonus(self, ctl: _ReplicaCtl,
                        fr: Optional[FleetHandle],
                        now: float) -> float:
        """The dispatch-score credit for advertised cached prefix
        tokens, anti-herd capped: a replica already at/above the
        occupancy cap gets NO bonus, so a hot tenant spills to
        emptier replicas (which the KV migration then warms) instead
        of pinning one replica into overload."""
        w = self.config.affinity_weight
        if w <= 0.0 or fr is None or not self._affinity_applies(fr):
            return 0.0
        if (ctl.n_outstanding() / ctl.capacity
                >= self.config.affinity_max_occupancy):
            return 0.0
        toks, _ = self._affinity_tokens(ctl, fr, now)
        if toks <= 0:
            return 0.0
        return w * min(1.0, toks / max(1, int(fr.prompt.shape[0])))

    def _pick(self, now: float, exclude: Optional[int] = None,
              fr: Optional[FleetHandle] = None) -> Optional[_ReplicaCtl]:
        """``fr`` lets tier-aware subclasses pick by the request's
        phase (serving/disagg.py) and gives affinity the
        prompt to score cached-prefix advertisements against."""
        best, best_score = None, None
        # priority overcommit: a priority > 0 request may
        # dispatch past capacity so engine preemption can seat it;
        # priority 0 keeps headroom 0 (byte-identical dispatch)
        headroom = (max(0, int(self.config.priority_overcommit))
                    if (fr is not None and fr.priority > 0) else 0)
        for ctl in self._ctls:
            if (ctl.id == exclude
                    or not self._dispatchable(ctl, now, headroom)):
                continue
            s = self._score(ctl) - self._affinity_bonus(ctl, fr, now)
            if best_score is None or s < best_score:
                best, best_score = ctl, s
        return best

    def _restartable(self) -> bool:
        return any(c.dead and c.next_restart_at is not None
                   for c in self._ctls)

    def _dispatch(self, now: float) -> int:
        n = 0
        while True:
            with self._lock:
                if not self._queue:
                    return n
                # priority dispatch: the FIRST request of
                # the HIGHEST waiting class goes next — identical to
                # plain FIFO when every class is 0 (idx stays 0)
                idx = 0
                if any(f.priority for f in self._queue):
                    idx = max(range(len(self._queue)),
                              key=lambda j: (self._queue[j].priority,
                                             -j))
                fr = self._queue[idx]
                if fr.done():               # e.g. cancelled upstream
                    del self._queue[idx]
                    continue
                if (fr.deadline_at is not None
                        and now > fr.deadline_at):
                    del self._queue[idx]
                    self._shed(fr, "deadline", DeadlineExceeded(
                        f"fleet request {fr.rid} past deadline before "
                        "dispatch"))
                    n += 1
                    continue
                ctl = self._pick(now, fr=fr)
                if ctl is None:
                    if (not self._restartable()
                            and not any(not c.dead
                                        for c in self._ctls)):
                        # total outage, nothing will come back: fail
                        # fast and typed instead of hanging callers
                        del self._queue[idx]
                        self._shed(fr, "outage", OverloadError(
                            "fleet outage: every replica is dead and "
                            "the restart budget is exhausted"))
                        n += 1
                        continue
                    return n
                del self._queue[idx]
                age = max(0.0, now - fr._queued_at)
                self._m_queue_age.observe(age)
                self._age_window.append(age)
                hedge_ctl = None
                if self._should_hedge(fr, age):
                    hedge_ctl = self._pick(now, exclude=ctl.id, fr=fr)
            ok = self._dispatch_to(fr, ctl, now, hedge=False)
            if ok is None:
                # replica-side rejection: the request is back at the
                # queue head; stop dispatching this round so the next
                # tick's probes/breaker see the failure first
                return n
            if ok and hedge_ctl is not None:
                if self._dispatch_to(fr, hedge_ctl, now, hedge=True):
                    fr._hedged = True
            n += 1

    def _should_hedge(self, fr: FleetHandle, age: float) -> bool:
        cfgf = self.config
        if not cfgf.hedge or fr._hedged:
            return False
        if cfgf.hedge_age_s is not None:
            return age >= cfgf.hedge_age_s
        if (age < cfgf.hedge_min_age_s
                or len(self._age_window) < cfgf.hedge_warmup):
            return False
        window = sorted(self._age_window)
        q = window[min(len(window) - 1,
                       int(cfgf.hedge_quantile * (len(window) - 1)))]
        return age >= q

    def _dispatch_to(self, fr: FleetHandle, ctl: _ReplicaCtl,
                     now: float, hedge: bool) -> Optional[bool]:
        """Submit ``fr``'s remaining work to ``ctl``: the committed
        prefix rides in the prompt, only the REMAINING token budget
        and the REMAINING deadline cross the hop. Returns True on
        dispatch, False when ``fr`` reached a terminal state instead,
        and None when the replica rejected the submit (the request is
        requeued at the head unless a live hop still serves it)."""
        committed = fr._committed
        prompt = (np.concatenate([fr.prompt, committed])
                  if committed.size else fr.prompt)
        remaining = fr.max_new_tokens - int(committed.shape[0])
        if remaining <= 0:
            self._resolve_success(fr, None)
            return False
        deadline_s = None
        if fr.deadline_at is not None:
            deadline_s = fr.deadline_at - now
            if deadline_s <= 0:
                self._shed(fr, "deadline", DeadlineExceeded(
                    f"fleet request {fr.rid} past deadline at "
                    "dispatch"))
                return False
        # prefix affinity + KV migration: what does the
        # chosen replica advertise for this prompt, and should a
        # hotter chain elsewhere be shipped ahead of the dispatch?
        aff_pred, aff_ps = self._affinity_accounting(fr, ctl, now,
                                                     hedge)
        # hop context: every dispatch gets a per-request
        # hop id the replica stamps on its own recorder events
        seq = fr._next_hop
        fr._next_hop += 1
        phase = self._hop_phase(fr)
        ctx = ({"fleet_rid": fr.rid, "hop": seq, "tier": ctl.tier}
               if self.recorder.enabled else None)
        try:
            inner = self._submit_hop(ctl, fr, prompt.astype(np.int32),
                                     remaining, deadline_s, ctx)
        except (OverloadError, EngineDraining, EngineStopped,
                ReplicaCrashed) as e:
            # dispatch failure: passive signal + breaker; requeue at
            # the front (next round tries elsewhere) — unless a live
            # hop still serves the request (failed HEDGE attempt)
            self._passive_failure(ctl)
            log.warning("dispatch of request %d to replica %d "
                        "rejected (%s)", fr.rid, ctl.id, e)
            if self._live_hops(fr):
                return False
            with self._lock:
                fr.status = RequestStatus.QUEUED
                self._queue.appendleft(fr)
            return None
        except ValueError as e:
            # validation errors are permanent — retrying them on
            # another replica would loop forever
            self._shed(fr, "overload", e)
            return False
        self._passive_success(ctl)
        hop = _Hop(fr, ctl.id, inner, committed, hedge, now,
                   seq=seq, phase=phase)
        hop.aff_pred, hop.aff_ps = aff_pred, aff_ps
        with self._lock:
            ctl.outstanding.setdefault(fr.rid, []).append(hop)
            ctl.last_progress_t = now    # a dispatch IS progress
        fr.status = RequestStatus.RUNNING
        self._m_dispatches.inc()
        if fr._failover_from is not None:
            fr.trace.add("failover", **{
                "from": int(fr._failover_from), "to": ctl.id,
                "committed": int(committed.shape[0])})
            fr._failover_from = None
        ev = fr.trace.add("dispatched", replica=ctl.id,
                          hedge=bool(hedge),
                          committed=int(committed.shape[0]),
                          hop=seq, tier=ctl.tier, phase=phase,
                          affinity_tokens=int(aff_pred))
        hop.trace_ts = ev.ts if self.recorder.enabled else None
        return True

    # ------------------------------------------------------------------
    # prefix affinity accounting + KV migration
    # ------------------------------------------------------------------
    def _affinity_accounting(self, fr: FleetHandle, ctl: _ReplicaCtl,
                             now: float, hedge: bool) -> tuple:
        """Pre-dispatch affinity bookkeeping for the chosen replica:
        count the hit/miss (primary dispatches only — a hedge twin is
        a latency bet, not a routing decision), and when another
        replica advertises a meaningfully deeper chain, MIGRATE it —
        export from the advertiser, stamp it on ``fr`` so
        `_submit_hop` ships it with the dispatch. Returns
        ``(predicted_cached_tokens, digest_page_size)`` for the hop's
        mispredict audit."""
        if not self._affinity_applies(fr):
            return 0, 0
        if self.config.affinity_weight <= 0.0:
            # pure-occupancy control arm: the affinity series must
            # not move (migration stays independently gated below)
            if self.config.migrate_kv:
                mig = self._maybe_migrate(fr, ctl, 0, now)
                if mig:
                    return mig, int((ctl.digest or {}).get(
                        "page_size", 0) or 0)
            return 0, 0
        pred, _ = self._affinity_tokens(ctl, fr, now)
        ps = int((ctl.digest or {}).get("page_size", 0) or 0)
        advertised_anywhere = any(
            c.digest is not None and not c.dead for c in self._ctls)
        if not hedge and advertised_anywhere:
            (self._m_aff_hits if pred > 0
             else self._m_aff_misses).inc()
        mig = self._maybe_migrate(fr, ctl, pred, now)
        if mig:
            pred = max(pred, mig)
            ps = ps or int((ctl.digest or {}).get("page_size", 0)
                           or 0)
        return pred, ps

    def _migration_target_ok(self, ctl: _ReplicaCtl) -> bool:
        """Can the chosen replica ADOPT a migrated chain? In-process:
        its engine is paged with the radix cache on. Subprocess: the
        chain crosses the pipe as a kvwire frame; the capability shows
        as the digest advertisement the worker's hello/progress/probes
        carry (only a paged engine with a radix cache ever advertises
        one)."""
        eng = getattr(ctl.replica, "engine", None)
        if eng is not None:
            return (getattr(eng, "_paged", False)
                    and getattr(eng, "_prefix_cache", None) is not None)
        return ("prefix_digest" in (ctl.last_health or {})
                or getattr(ctl.replica, "prefix_digest", None)
                is not None)

    def _maybe_migrate(self, fr: FleetHandle, ctl: _ReplicaCtl,
                       pred: int, now: float) -> int:
        """Move bytes, don't recompute: when capacity (or the
        anti-herd cap) forced ``fr`` onto a replica missing its
        prefix while another replica advertises it, pull the chain
        from the advertiser (replica.export_cached_chain — direct
        in-process, a kvwire frame over the pipe for subprocess
        sources) and ship it on this dispatch as a
        cache-source KVHandoff. Misprediction — the chain evicted
        between advertisement and export (stale), or an export error
        (failed) — degrades to a normal prefill. Returns the migrated
        token count (0 = no migration)."""
        cfgf = self.config
        if not cfgf.migrate_kv or fr._migrate_kv is not None:
            return 0
        if not self._migration_target_ok(ctl):
            return 0
        best_toks, best_hash, best_ctl = 0, None, None
        for cand in self._ctls:
            if (cand is ctl or cand.dead
                    or not cand.replica.alive()
                    or not hasattr(cand.replica,
                                   "export_cached_chain")):
                continue
            toks, h = self._affinity_tokens(cand, fr, now)
            if h is not None and toks > best_toks:
                best_toks, best_hash, best_ctl = toks, h, cand
        if (best_ctl is None
                or best_toks < cfgf.migrate_min_tokens
                or best_toks <= pred):
            return 0
        outcome, kvh = "stale", None
        try:
            kvh = best_ctl.replica.export_cached_chain(best_hash)
            if kvh is not None:
                outcome = "ok"
                lw = getattr(best_ctl.replica, "last_wire", None)
                if lw:   # the chain crossed a pipe as a kvwire frame
                    self._kvwire_count("seed", "ok", lw["bytes"],
                                       lw["seconds"])
        except Exception as e:
            outcome = "failed"
            log.warning("KV migration export from replica %d failed "
                        "(%s); request %d prefills normally",
                        best_ctl.id, e, fr.rid)
        nbytes = int(kvh.nbytes) if kvh is not None else 0
        toks = int(kvh.pos) if kvh is not None else 0
        if kvh is not None:
            self._m_migrations_ok.inc()
            self._m_migrated_tokens.inc(toks)
            self._m_migrated_bytes.inc(nbytes)
            fr._migrate_kv = kvh
        elif outcome == "failed":
            self._m_migrations_failed.inc()
        else:
            self._m_migrations_stale.inc()
        fr.trace.add("kv_migration", outcome=outcome, **{
            "from": int(best_ctl.id), "to": int(ctl.id),
            "tokens": toks, "bytes": nbytes})
        return toks

    def _submit_hop(self, ctl: _ReplicaCtl, fr: FleetHandle,
                    prompt: np.ndarray, remaining: int,
                    deadline_s: Optional[float],
                    ctx: Optional[dict] = None):
        """One replica submit — the seam tier-aware subclasses
        override (prefill hops carry hold_kv, decode hops carry the
        pending KVHandoff). ``ctx`` is the hop context the replica
        stamps on its recorder events. A migrated cache chain rides the
        same submit, consumed-on-dispatch so a failed dispatch never
        replays it."""
        kw = {}
        kv, fr._migrate_kv = fr._migrate_kv, None
        if kv is not None:
            kw["kv"] = kv
        if fr.tenant is not None:
            kw["tenant"] = fr.tenant
        if fr.priority:
            kw["priority"] = fr.priority
        kw.update(self._constrain_kw(fr, prompt))
        rep = ctl.replica
        if kv is not None:
            rep.last_wire = None
        inner = rep.submit(prompt, remaining, deadline_s,
                           fr.on_deadline, trace_ctx=ctx, **kw)
        lw = getattr(rep, "last_wire", None) if kv is not None else None
        if lw:    # the migrated chain crossed a pipe
            self._kvwire_count("seed", "ok", lw["bytes"],
                               lw["seconds"])
            fr.trace.add("kvwire", direction="seed", outcome="ok",
                         bytes=lw["bytes"], seconds=lw["seconds"])
        return inner

    @staticmethod
    def _constrain_kw(fr: FleetHandle, prompt: np.ndarray) -> dict:
        """The constraint spec a dispatch hop forwards:
        the grammar plus a `consumed` count covering the submit-time
        consumed tail AND every committed token folded into this
        hop's prompt — the receiving engine replays that tail through
        the DFA, so failover/requeue resume in exactly the state the
        lost replica held."""
        if fr._constrain is None:
            return {}
        return {"constrain": dict(
            fr._constrain,
            consumed=(fr._consumed0
                      + int(prompt.shape[0] - fr.prompt.shape[0])))}

    def _prepare_failover(self, fr: FleetHandle,
                          ctl: _ReplicaCtl) -> None:
        """Hook before a lost replica's request is requeued: the
        tiered router resets the request to the prefill phase here (a
        lost decode replica's KV is gone — the committed prefix
        re-prefills on the prefill tier)."""

    def _passive_failure(self, ctl: _ReplicaCtl) -> None:
        a = self.config.error_ema_alpha
        ctl.err_ema = ctl.err_ema * (1 - a) + a
        ctl.breaker_failures += 1
        if ctl.breaker_failures >= self.config.breaker_failure_threshold:
            ctl.breaker_open_until = (self._clock()
                                      + self.config.breaker_cooldown_s)
            log.warning("replica %d dispatch breaker open for %.1fs",
                        ctl.id, self.config.breaker_cooldown_s)

    def _passive_success(self, ctl: _ReplicaCtl) -> None:
        ctl.err_ema *= (1 - self.config.error_ema_alpha)
        ctl.breaker_failures = 0

    # ------------------------------------------------------------------
    # harvest
    # ------------------------------------------------------------------
    def _live_hops(self, fr: FleetHandle,
                   exclude: Optional[_Hop] = None) -> List[_Hop]:
        out = []
        for ctl in self._ctls:
            if ctl.dead:
                continue
            for hop in ctl.outstanding.get(fr.rid, ()):
                if hop is not exclude and not hop.inner.done():
                    out.append(hop)
        return out

    def _drop_hop(self, hop: _Hop) -> None:
        ctl = self._ctl(hop.replica_id)
        if ctl is None:
            return
        hops = ctl.outstanding.get(hop.fr.rid)
        if hops and hop in hops:
            hops.remove(hop)
            if not hops:
                ctl.outstanding.pop(hop.fr.rid, None)

    def _harvest(self, now: float) -> int:
        n = 0
        with self._lock:
            terminal = [(ctl, hop)
                        for ctl in self._ctls
                        for hops in list(ctl.outstanding.values())
                        for hop in list(hops)
                        if hop.inner.done()]
        for ctl, hop in terminal:
            fr = hop.fr
            inner = hop.inner
            with self._lock:
                self._drop_hop(hop)
            self._affinity_outcome(hop)
            if fr.done():
                self._record_hop(fr, hop, ctl, str(inner.status))
                continue         # a twin already resolved it
            self._record_hop(fr, hop, ctl, str(inner.status))
            st = inner.status
            if st == RequestStatus.COMPLETED:
                self._resolve_success(fr, hop)
                # a replica that completes work has proven itself:
                # reset its consecutive-crash budget (durability
                # subsystem semantics — spaced crashes don't kill it)
                ctl.consec_crashes = 0
                n += 1
            elif st == RequestStatus.QUARANTINED:
                self._cancel_twins(fr, None)
                fr._committed = hop.committed()
                self._m_quarantined.inc()
                fr.trace.add("quarantined")
                fr._finish(RequestStatus.QUARANTINED, inner.error)
                n += 1
            elif getattr(inner, "_cancelled", False):
                n += 1           # a hedge loser we cancelled: drop
            elif inner.deadline_exceeded:
                self._cancel_twins(fr, None)
                fr._committed = hop.committed()
                fr.deadline_exceeded = True
                self._shed(fr, "deadline",
                           inner.error or DeadlineExceeded(
                               f"fleet request {fr.rid} past deadline "
                               "at its replica"))
                n += 1
            else:
                # replica-side rejection (overload/drain race): one
                # more chance on the rest of the fleet
                self._passive_failure(ctl)
                if self._live_hops(fr):
                    continue
                with self._lock:
                    fr.status = RequestStatus.QUEUED
                    fr._queued_at = now
                    self._queue.appendleft(fr)
                n += 1
        return n

    @staticmethod
    def _admitted_hit_tokens(inner) -> Optional[int]:
        """The replica-reported prefix-cache hit of a hop's admission
        — from the live RequestTrace (in-process) or the pipe-shipped
        event dicts (subprocess). None when untraced."""
        tr = getattr(inner, "trace", None)
        evs = list(getattr(tr, "events", None) or [])
        if not evs:
            evs = list(getattr(inner, "trace_events", None) or [])
        for e in evs:
            kind = getattr(e, "kind", None)
            data = getattr(e, "data", None)
            if kind is None and isinstance(e, dict):
                kind, data = e.get("kind"), e
            if kind == "admitted" and data is not None:
                v = data.get("prefix_hit_tokens")
                return int(v) if v is not None else None
        return None

    def _affinity_outcome(self, hop: _Hop) -> None:
        """The mispredict audit: a hop dispatched on an
        advertised cached prefix whose admission reported at least a
        page LESS than predicted hit a stale digest, an eviction, or
        a bloom false positive — the cost was one normal prefill,
        counted so operators can see advertisement quality."""
        if hop.aff_pred <= 0 or hop.aff_checked:
            return
        hop.aff_checked = True
        actual = self._admitted_hit_tokens(hop.inner)
        if actual is None:
            return               # untraced replica: nothing to audit
        if actual + max(1, hop.aff_ps) <= hop.aff_pred:
            self._m_aff_mispredicts.inc()

    def _resolve_success(self, fr: FleetHandle,
                         hop: Optional[_Hop]) -> None:
        if fr.done():
            return
        if hop is not None:
            self._record_hop(fr, hop, self._ctl(hop.replica_id),
                             "completed")
            fr._committed = hop.committed()
            fr.deadline_exceeded = bool(hop.inner.deadline_exceeded)
        winners = "hedge_won" if (hop is not None
                                  and hop.hedge) else "primary_won"
        if fr._hedged:
            (self._m_hedge_hedge if winners == "hedge_won"
             else self._m_hedge_primary).inc()
        self._cancel_twins(fr, hop)
        if fr._hedged and hop is not None:
            fr.trace.add("hedge", winner=hop.replica_id,
                         outcome=winners)
        self._m_completed.inc()
        fr.trace.add("finished",
                     tokens=int(fr._committed.shape[0]),
                     partial=bool(fr.deadline_exceeded))
        fr._finish(RequestStatus.COMPLETED)

    def _cancel_twins(self, fr: FleetHandle,
                      winner: Optional[_Hop]) -> None:
        """First-winner-cancels: every other live hop of ``fr`` is
        cancelled at its replica and dropped."""
        with self._lock:
            losers = [(ctl, hop) for ctl in self._ctls
                      for hop in list(ctl.outstanding.get(fr.rid, ()))
                      if hop is not winner]
            for ctl, hop in losers:
                self._drop_hop(hop)
        for ctl, hop in losers:
            self._record_hop(fr, hop, ctl, "cancelled")
            try:
                ctl.replica.cancel(hop.inner)
            except Exception:
                pass

    def _shed(self, fr: FleetHandle, reason: str,
              err: BaseException) -> None:
        self._cancel_twins(fr, None)
        if reason == "deadline":
            fr.deadline_exceeded = True
            if fr.on_deadline == "partial":
                # mirror the engine's partial contract at fleet level
                self._m_completed.inc()
                fr.trace.add("finished",
                             tokens=int(fr._committed.shape[0]),
                             partial=True)
                fr._finish(RequestStatus.COMPLETED)
                return
            self._m_shed_deadline.inc()
        elif reason == "outage":
            self._m_shed_outage.inc()
        elif reason == "qos":
            # overload-controller rung 3: lowest-priority /
            # over-cap shed — own label so operators can tell "the
            # controller chose this victim" from FIFO overload
            self._m_shed_qos.inc()
        else:
            self._m_shed_overload.inc()
        fr.trace.add("shed", reason=reason)
        fr._finish(RequestStatus.SHED, err)

    def _shed_stuck(self, why: str) -> None:
        log.error("fleet stalled: %s — shedding pending work", why)
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            for ctl in self._ctls:
                for hops in ctl.outstanding.values():
                    pending.extend(h.fr for h in hops)
                ctl.outstanding = {}
        for fr in pending:
            if not fr.done():
                self._shed(fr, "outage", OverloadError(
                    f"fleet stalled: {why}"))

    # ------------------------------------------------------------------
    # health / introspection
    # ------------------------------------------------------------------
    def ready(self) -> bool:
        """Router readiness: accepting, not draining, and at least one
        replica is dispatchable-or-probing-ready. Wire into
        `MetricsServer(ready=router.ready)` for the fleet `/readyz`."""
        if not self._accepting or self._draining:
            return False
        return any(not c.dead and not c.draining and not c.unhealthy
                   and c.ready for c in self._ctls)

    def health(self) -> dict:
        return {"ready": self.ready(),
                "draining": self._draining,
                "queue_depth": len(self._queue),
                "replicas": {c.id: c.state() for c in self._ctls},
                **self.stats}

    def debugz(self, recent: int = 100) -> dict:
        """The fleet table: per-replica state, occupancy, passive
        signals, restart budget, plus the router queue and recent
        router-hop events — `MetricsServer(debug=router.debugz)`."""
        now = self._clock()
        with self._lock:
            replicas = [{
                "replica": c.id,
                "tier": c.tier,
                "kind": getattr(c.replica, "kind", "?"),
                "state": c.state(),
                "ready": c.ready,
                "capacity": c.capacity,
                "outstanding": c.n_outstanding(),
                "err_ema": round(c.err_ema, 4),
                "consec_probe_failures": c.consec_probe_failures,
                "consec_crashes": c.consec_crashes,
                "restarts": c.restarts,
                "probe_url": getattr(c.replica, "probe_url", None),
                # replica build latency: ~the compile set
                # cold, ~the AOT-cache load set warm — the autoscale /
                # supervised-restart elasticity number
                "cold_start_s": round(getattr(
                    c.replica, "cold_start_s", 0.0), 4),
                # compile-cache/warmup surfacing:
                # a cold autoscaled replica is visible at the fleet
                # level — no warmup report, jit compiles climbing
                "last_warmup": getattr(c.replica, "last_warmup",
                                       None),
                "compiles_by_source": c.last_health.get(
                    "compiles_by_source"),
                "clock_offset_s": round(float(getattr(
                    c.replica, "clock_offset", 0.0) or 0.0), 6),
                "occupancy": c.last_health.get("slots_occupied"),
                # prefix-cache advertisement: what this
                # replica's digest claims, and how old the claim is —
                # the affinity dispatcher's per-replica view
                "prefix_digest": ({
                    "generation": c.digest.get("generation"),
                    "entries": c.digest.get("entries"),
                    "top_chains": len(c.digest.get("top", ())),
                    "age_s": round(max(0.0, now - c.digest_at), 3)}
                    if c.digest else None),
                # cross-host compile-cache priming: did this replica
                # start warm?
                "cache_warm": getattr(c.replica, "cache_warm", None),
                # health-probe load piggyback:
                # the slot-occupancy / budget-utilization gauge values
                # every probe now carries
                "slot_occupancy": c.last_health.get("slot_occupancy"),
                "budget_utilization": c.last_health.get(
                    "tick_budget_utilization"),
                "weights_step": c.last_health.get("weights_step"),
                # KV transport mode: "wire" replicas move
                # handoffs/chains across boundaries (by reference
                # in-process, kvwire frames over the pipe);
                # "fallback" replicas force the re-prefill degraded
                # mode on every handoff that targets them
                "handoff_mode": ("wire" if getattr(
                    c.replica, "supports_handoff", False)
                    else "fallback"),
            } for c in self._ctls]
            queue = [{"rid": fr.rid,
                      "queue_age_s": round(max(0.0,
                                               now - fr._queued_at), 6),
                      "failovers": fr._failovers,
                      "tenant": fr.tenant,
                      "priority": fr.priority}
                     for fr in self._queue]
            # per-tenant queue depths: a tenant
            # storm is diagnosable from this endpoint alone
            queue_by_tenant: Dict[str, int] = {}
            for fr in self._queue:
                t = fr.tenant or "default"
                queue_by_tenant[t] = queue_by_tenant.get(t, 0) + 1
            cfgf = self.config
            qos = None
            if (cfgf.tenant_max_concurrency is not None
                    or cfgf.tenant_rate_per_s is not None
                    or cfgf.overload_ttft_p99_ms is not None
                    or cfgf.overload_queue_depth is not None):
                qos = {"level": self._qos_level,
                       "tenant_live": dict(self._tenant_live),
                       "tenant_max_concurrency":
                           cfgf.tenant_max_concurrency,
                       "tenant_rate_per_s": cfgf.tenant_rate_per_s,
                       "overload_ttft_p99_ms":
                           cfgf.overload_ttft_p99_ms,
                       "overload_queue_depth":
                           cfgf.overload_queue_depth}
            tiers = self._tier_table_locked()
            # stitched-trace section: the last few
            # completed requests' distributed traces in summary form
            # (full bodies via Router.distributed_trace(rid))
            stitched = [fr._stitched
                        for fr in self._recent_handles.values()
                        if fr._stitched is not None][-8:]
        return {"replicas": replicas,
                "tiers": tiers,
                "queue_depth": len(queue),
                "queue": queue,
                "queue_by_tenant": queue_by_tenant,
                **({"qos": qos} if qos is not None else {}),
                "draining": self._draining,
                "ticks": self._ticks,
                "stats": self.stats,
                "distributed_traces": [
                    {"rid": st.rid,
                     "hops": [{k: h.get(k) for k in
                               ("hop", "replica", "tier", "phase",
                                "status")}
                              for h in st.hops],
                     "spans": [{"name": s["name"],
                                "tier": s.get("tier"),
                                "ms": round(1e3 * max(
                                    0.0, s["t1"] - s["t0"]), 3)}
                               for s in st.spans]}
                    for st in stitched],
                "recent_events": [e.as_dict() for e in
                                  self.recorder.recent(recent)]}

    def _tier_table_locked(self) -> List[dict]:
        """The per-tier summary table: one row
        per tier with replica states, mean probe-reported occupancy,
        in-flight work, and the tier's last handoff (tiered routers
        only — the flat router is one 'serving' tier)."""
        tiers: Dict[str, List[_ReplicaCtl]] = {}
        for c in self._ctls:
            tiers.setdefault(c.tier, []).append(c)
        out = []
        for tier, ctls in tiers.items():
            occ = [c.last_health.get("slot_occupancy")
                   for c in ctls
                   if c.last_health.get("slot_occupancy") is not None]
            states: Dict[str, int] = {}
            for c in ctls:
                states[c.state()] = states.get(c.state(), 0) + 1
            out.append({
                "tier": tier,
                "replicas": len(ctls),
                "states": states,
                "occupancy": (round(sum(occ) / len(occ), 3)
                              if occ else None),
                "in_flight": sum(c.n_outstanding() for c in ctls),
                "last_handoff": self._last_handoff_for(tier)})
        return out

    def _last_handoff_for(self, tier: str) -> Optional[dict]:
        return None              # tiered routers override

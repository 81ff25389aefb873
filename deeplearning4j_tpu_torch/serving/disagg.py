"""Disaggregated prefill/decode tiers with cross-tier KV handoff and
occupancy-driven autoscaling.

Port of deeplearning4j_tpu/serving/disagg.py: `AutoscalePolicy`,
`Autoscaler`, `_validate_tier_configs` and `TieredRouter` (reference
:105-993), with the reference's names and structure, over the port's
`InferenceEngine` (``cfg + params + device``; no mesh). The handoff is
the engine's own: `export_slot_kv` gathers a held slot's committed rows
to host tensors and ``submit(kv=)`` adopts them into a paged pool; a
corrupted frame is refused by `serving.kvwire`'s real CRC check.

Prefill is compute-bound and decode is memory-bound, yet a flat fleet
(serving/fleet.py) runs both phases on every replica with one engine
config. `TieredRouter` splits them: a PREFILL tier of replicas runs
(chunked) prefill to completion, then each request's committed KV
pages are HANDED OFF into a decode-tier replica's page pool and decode
resumes token-exactly from the committed prefix. Each tier gets its
own engine config (sharding, slot count, paging, chunking, replica
count) — the disaggregation arxiv 2112.01075's portable collective
redistribution argues for, realized here as the host-gather →
device-put hop the same machinery would ship cross-mesh.

Request lifecycle
-----------------
1. ``submit()`` — one router queue, phase = prefill.
2. **Prefill dispatch** — least-occupancy pick WITHIN the prefill
   tier; the hop submits with ``max_new_tokens=1`` and
   ``hold_kv=True``: the replica prefills the whole prompt (its
   chunked scheduler / prefix cache apply), samples the first token,
   and HOLDS the finished slot — pages referenced — for export.
3. **Handoff** — the router exports the held slot's committed K/V rows
   (+ per-row scales on int8-KV pools, bit-exact slices — quant/kv.py
   scales travel with their rows) to host and releases the hold; the
   request re-enters the queue in phase = decode carrying the
   `KVHandoff`.
4. **Decode dispatch** — pick within the decode tier; the hop submits
   with ``kv=handoff``: the engine seats the request by ADOPTING the
   rows into freshly allocated pages (allocator-owned, all-or-nothing
   — a near-full pool blocks or sheds, never corrupts) and decode
   resumes at the committed position. Position-keyed sampling makes
   the continuation bit-identical to a single-replica run.
5. **Failover** — a lost decode replica's requests generalize the
   round-14 contract: their KV died with the replica, so
   `_prepare_failover` resets them to phase = prefill and the
   committed prefix RE-PREFILLS on the prefill tier (hitting its
   prefix cache when warm), hands off again, and continues token-
   exactly. A failed EXPORT (injected via
   `FleetFaultInjector.handoff_fail_at`, or a crashed prefill replica)
   degrades the same way: the decode dispatch re-prefills — slower,
   never wrong, counted ``outcome="fallback"``/``"failed"``.

Autoscaling
-----------
An `Autoscaler` per tier turns the load signals every health probe now
piggybacks — ``slot_occupancy`` (the `serving_slot_occupancy` gauge's
value) and ``tick_budget_utilization`` — into replica-count decisions:
sustained high occupancy/utilization scales the tier up (reviving a
STOPPED replica or building a fresh one), sustained idleness scales it
down through the existing ``drain()``-style machinery (the victim
drains out of rotation, finishes its residents, then stops — zero
shed requests). ``min_replicas=0`` on the prefill tier gives
scale-to-zero under decode-only load; pending prefill work force-
scales it back up. Every action lands in `autoscale_log`, the
``autoscale`` recorder event, and
``serving_autoscale_events_total{tier,direction}``.

Observability: ``serving_tier_replicas{tier}`` /
``serving_tier_occupancy{tier}`` /
``serving_tier_budget_utilization{tier}`` /
``serving_tier_queue_depth{tier}`` gauges,
``serving_handoff_transfers_total{outcome}`` /
``serving_handoff_tokens_total`` / ``serving_handoff_bytes_total``
counters + ``serving_handoff_seconds`` histogram, ``handoff`` events
on request traces, a per-tier table in ``debugz()``.

Deterministic on CPU via `parallel.failure.FleetFaultInjector`
(kill/hang/probe knobs tier-agnostic, ``handoff_fail_at`` for the
export path, ``corrupt_frame_at`` for the kvwire frame path —
) and `ServingFaultInjector.adopt_fail_requests` for the
decode-side seating path — tests/test_serving_disagg.py and
tests/test_serving_kvwire.py.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.observability.metrics import (
    DECODE_LATENCY_BUCKETS)
from deeplearning4j_tpu_torch.serving import kvwire
from deeplearning4j_tpu_torch.serving.engine import (DeadlineExceeded,
                                                     EngineConfig,
                                                     HandoffError,
                                                     InferenceEngine,
                                                     OverloadError,
                                                     RequestStatus)
from deeplearning4j_tpu_torch.serving.fleet import (FleetConfig,
                                                    FleetHandle,
                                                    InProcessReplica, Router,
                                                    _ReplicaCtl)

log = logging.getLogger("deeplearning4j_tpu_torch")

_perf = time.perf_counter

PREFILL = "prefill"
DECODE = "decode"


@dataclass
class AutoscalePolicy:
    """Per-tier scaling policy. Signals are the health-probe
    piggybacked gauges: mean slot occupancy across the tier's active
    replicas and (chunked engines) mean tick-budget utilization. A
    signal must persist ``window`` consecutive observations (router
    ticks) before acting, and actions are ``cooldown_s`` apart —
    except the cold-start force-up (pending work, zero active
    replicas), which fires immediately."""
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_occupancy: float = 0.75     # mean occupancy >= -> up
    scale_up_budget_utilization: float = 0.95   # OR budget util >= ->
    scale_down_occupancy: float = 0.25   # mean occupancy <= -> down
    # latency-aware scale-up: the tier's stitched-trace
    # span p99 (prefill span for the prefill tier, decode span for
    # the decode tier — Router.tier_latency()) at/over this many
    # milliseconds counts as a high observation, so a tier can scale
    # on what users feel even when occupancy averages hide it.
    # None (default) keeps the pure-occupancy policy.
    scale_up_span_p99_ms: Optional[float] = None
    window: int = 4                      # consecutive observations
    cooldown_s: float = 0.5              # between actions

    def __post_init__(self):
        if not 0 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


class Autoscaler:
    """The pure decision core: feed it one observation per scheduling
    tick, get back -1 / 0 / +1. Owns only counters and the cooldown
    clock — replica lifecycle stays in the router, so the policy is
    unit-testable without a fleet (tests/test_serving_disagg.py)."""

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy
        self._high = 0
        self._low = 0
        self._last_action_at: Optional[float] = None

    def _cooled(self, now: float) -> bool:
        return (self._last_action_at is None
                or now - self._last_action_at >= self.policy.cooldown_s)

    def observe(self, now: float, active: int, occupancy: float,
                budget_utilization: Optional[float], pending: int,
                in_flight: int,
                span_p99_ms: Optional[float] = None) -> int:
        """One observation -> a decision. ``active`` counts replicas
        in rotation (not draining/stopped/dead); ``pending`` is queued
        work addressed to this tier; ``in_flight`` its dispatched
        work. Scale-to-zero: the last replica only retires when the
        tier is COMPLETELY idle, and pending work with zero active
        replicas force-scales up regardless of window/cooldown (cold
        start beats hysteresis)."""
        p = self.policy
        if pending > 0 and active == 0:
            if active < p.max_replicas:
                self._high = self._low = 0
                self._last_action_at = now
                return 1
            return 0
        high = (occupancy >= p.scale_up_occupancy
                or (budget_utilization is not None
                    and budget_utilization
                    >= p.scale_up_budget_utilization)
                or (span_p99_ms is not None
                    and p.scale_up_span_p99_ms is not None
                    and span_p99_ms >= p.scale_up_span_p99_ms))
        low = (occupancy <= p.scale_down_occupancy and pending == 0
               and (active > 1 or in_flight == 0))
        self._high = self._high + 1 if high else 0
        self._low = self._low + 1 if low else 0
        if (high and self._high >= p.window and active < p.max_replicas
                and self._cooled(now)):
            self._high = self._low = 0
            self._last_action_at = now
            return 1
        if (low and self._low >= p.window and active > p.min_replicas
                and self._cooled(now)):
            self._high = self._low = 0
            self._last_action_at = now
            return -1
        return 0


def _validate_tier_configs(pc: EngineConfig, dc: EngineConfig) -> None:
    """Token-exactness guardrails: the first token samples on the
    prefill tier, the rest on the decode tier — the position-keyed
    sampling schedule (and the weight/KV quantization the rows carry)
    must agree across tiers or the handoff would be silently wrong."""
    for f in ("temperature", "top_k", "top_p", "seed", "quantize",
              "kv_quantize"):
        if getattr(pc, f) != getattr(dc, f):
            if (f == "kv_quantize" and not pc.kv_quantize
                    and dc.kv_quantize):
                # quantize-on-adopt: a FLOAT prefill tier
                # may feed a quantized decode tier — the handoff is
                # row-quantized at encode time (kvwire), per-row
                # scales riding with the rows, so the continuation
                # matches the decode tier's own numerics exactly as
                # if it had prefilled there itself
                log.info("heterogeneous tiers: float prefill KV will "
                         "be quantized to %r on adopt",
                         dc.kv_quantize)
                continue
            raise ValueError(
                f"prefill/decode tier configs disagree on {f!r} "
                f"({getattr(pc, f)!r} vs {getattr(dc, f)!r}) — the "
                "handoff continuation would not be token-exact")
    for c, name in ((pc, "prefill"), (dc, "decode")):
        if c.mode != "continuous":
            raise ValueError(f"{name} tier must run mode='continuous'")
    if not dc.paged:
        log.warning("decode tier is not paged: KV handoffs cannot be "
                    "adopted, every decode dispatch will re-prefill")


class TieredRouter(Router):
    """A `Router` whose replicas are split into a prefill tier and a
    decode tier joined by the KV handoff, with an optional
    occupancy-driven `Autoscaler` per tier (module docstring has the
    lifecycle). Built from ``cfg + params`` (on ``device``: CUDA unless
    ``device="cpu"``, and without CUDA and without ``device="cpu"`` the
    constructor raises) plus one `EngineConfig` per tier; replica ids
    are prefill-first, then decode, then autoscale-created ones."""

    def __init__(self, *, cfg=None, params=None, device=None,
                 prefill_replicas: int = 1,
                 decode_replicas: int = 2,
                 prefill_engine_config: Optional[EngineConfig] = None,
                 decode_engine_config: Optional[EngineConfig] = None,
                 prefill_autoscale: Optional[AutoscalePolicy] = None,
                 decode_autoscale: Optional[AutoscalePolicy] = None,
                 config: Optional[FleetConfig] = None,
                 fault_injector=None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, recorder=None,
                 recorder_capacity: int = 4096,
                 http_probes: bool = False,
                 engine_kwargs: Optional[dict] = None,
                 replicas: Optional[List] = None,
                 tiers: Optional[List[str]] = None):
        self._http_probes = bool(http_probes)
        if replicas is not None:
            # pre-built replicas (e.g. SubprocessReplicas):
            # the caller assigns each to a tier. No factories exist,
            # so the autoscaler (which builds/revives replicas) is
            # unsupported here, and config parity across tiers is the
            # caller's contract. KV crosses process boundaries as
            # versioned CRC-checked kvwire frames, so
            # subprocess tiers hand off for real; only a replica that
            # cannot export at all — or a frame that fails its
            # checks — degrades to re-prefill on the decode tier,
            # the explicit DEGRADED mode: slower, never wrong.
            if tiers is None or len(tiers) != len(replicas):
                raise ValueError("pass tiers=[...] naming each "
                                 "pre-built replica's tier")
            bad = set(tiers) - {PREFILL, DECODE}
            if bad:
                raise ValueError(f"unknown tier(s) {sorted(bad)}; "
                                 f"use {PREFILL!r}/{DECODE!r}")
            if DECODE not in tiers:
                raise ValueError("need at least one decode replica")
            if prefill_autoscale or decode_autoscale:
                raise ValueError(
                    "autoscaling needs engine factories; it is not "
                    "supported with pre-built replicas")
            self._tier_cfgs = {}
            self._factories = {}
            tier_list = list(tiers)
            self._next_id = 1 + max(int(r.id) for r in replicas)
        else:
            if cfg is None or params is None:
                raise ValueError("pass cfg+params (or pre-built "
                                 "replicas= + tiers=)")
            if prefill_replicas < 0 or decode_replicas < 1:
                raise ValueError("need prefill_replicas >= 0 and "
                                 "decode_replicas >= 1")
            dc = decode_engine_config or EngineConfig(paged=True)
            pc = prefill_engine_config or replace(dc, paged=True)
            _validate_tier_configs(pc, dc)
            self._tier_cfgs = {PREFILL: pc, DECODE: dc}
            device = resolve_device(device)
            ekw = dict(engine_kwargs or {})
            ekw.setdefault("clock", clock)
            self._factories: Dict[str, Callable[[], object]] = {
                tier: (lambda c=c: InferenceEngine(cfg, params, c,
                                                   device=device, **ekw))
                for tier, c in self._tier_cfgs.items()}
            replicas = []
            tier_list = []
            rid = 0
            for tier, n in ((PREFILL, prefill_replicas),
                            (DECODE, decode_replicas)):
                for _ in range(n):
                    replicas.append(InProcessReplica(
                        rid, self._factories[tier],
                        http_probes=http_probes))
                    tier_list.append(tier)
                    rid += 1
            self._next_id = rid
        super().__init__(replicas, cfg=cfg, config=config,
                         fault_injector=fault_injector, clock=clock,
                         registry=registry, recorder=recorder,
                         recorder_capacity=recorder_capacity)
        for ctl, tier in zip(self._ctls, tier_list):
            ctl.tier = tier
        self._scalers: Dict[str, Optional[Autoscaler]] = {
            PREFILL: (Autoscaler(prefill_autoscale)
                      if prefill_autoscale else None),
            DECODE: (Autoscaler(decode_autoscale)
                     if decode_autoscale else None)}
        self._handoff_seq = 0
        self._last_handoff: Optional[dict] = None
        #: [{t, tier, direction, replicas}] — the bench's replica-count
        #: trajectory and the debugz audit trail
        self.autoscale_log: List[dict] = []

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _init_metrics(self, r) -> None:
        super()._init_metrics(r)
        self._m_handoffs = r.counter(
            "serving_handoff_transfers",
            "Prefill->decode handoff resolutions, by outcome: ok "
            "(KV moved — by reference in-process, as a kvwire frame "
            "across a process boundary), fallback (handoff-incapable "
            "target re-prefilled: the degraded mode), failed "
            "(export/wire error; target re-prefilled)",
            labelnames=("outcome",))
        self._m_handoff_ok = self._m_handoffs.labels("ok")
        self._m_handoff_fallback = self._m_handoffs.labels("fallback")
        self._m_handoff_failed = self._m_handoffs.labels("failed")
        self._m_handoff_tokens = r.counter(
            "serving_handoff_tokens",
            "Committed-prefix K/V rows moved across tiers")
        self._m_handoff_bytes = r.counter(
            "serving_handoff_bytes",
            "Bytes of K/V values + scales moved across tiers")
        self._m_handoff_seconds = r.histogram(
            "serving_handoff_seconds",
            "Wall time of one KV export (host-gather) hop",
            buckets=DECODE_LATENCY_BUCKETS)
        self._m_autoscale = r.counter(
            "serving_autoscale_events",
            "Tier replica-count changes by the autoscaler",
            labelnames=("tier", "direction"))
        for tier in (PREFILL, DECODE):
            r.gauge("serving_tier_replicas",
                    "Replicas in rotation per tier",
                    labelnames=("tier",)).labels(tier).set_function(
                lambda t=tier: float(len(self._active_ctls(t))))
            r.gauge("serving_tier_occupancy",
                    "Mean probe-reported slot occupancy per tier",
                    labelnames=("tier",)).labels(tier).set_function(
                lambda t=tier: self._tier_occupancy(t))
            r.gauge("serving_tier_budget_utilization",
                    "Mean probe-reported tick-budget utilization per "
                    "tier (0 when the tier is unchunked)",
                    labelnames=("tier",)).labels(tier).set_function(
                lambda t=tier: self._tier_budget_utilization(t) or 0.0)
            r.gauge("serving_tier_queue_depth",
                    "Queued requests addressed to each tier",
                    labelnames=("tier",)).labels(tier).set_function(
                lambda t=tier: float(self._tier_pending(t)))

    # ------------------------------------------------------------------
    # tier views
    # ------------------------------------------------------------------
    def _tier_ctls(self, tier: str) -> List[_ReplicaCtl]:
        return [c for c in self._ctls if c.tier == tier]

    def _active_ctls(self, tier: str) -> List[_ReplicaCtl]:
        return [c for c in self._tier_ctls(tier)
                if not c.dead and not c.scaled_down and not c.draining]

    def _tier_occupancy(self, tier: str) -> float:
        vals = []
        for c in self._active_ctls(tier):
            v = c.last_health.get("slot_occupancy")
            if v is None:        # probe not landed yet: router view
                v = c.n_outstanding() / c.capacity
            vals.append(float(v))
        return sum(vals) / len(vals) if vals else 0.0

    def _tier_budget_utilization(self, tier: str) -> Optional[float]:
        vals = [float(v) for c in self._active_ctls(tier)
                if (v := c.last_health.get(
                    "tick_budget_utilization")) is not None]
        return sum(vals) / len(vals) if vals else None

    def _phase_of(self, fr: FleetHandle) -> str:
        return fr._phase or PREFILL

    def _tier_pending(self, tier: str) -> int:
        with self._lock:
            return sum(1 for fr in self._queue
                       if not fr.done() and self._phase_of(fr) == tier)

    # ------------------------------------------------------------------
    # tier-aware dispatch
    # ------------------------------------------------------------------
    def _affinity_applies(self, fr) -> bool:
        # prefix affinity steers PREFILL dispatch only:
        # the decode tier receives its KV via the cross-tier handoff,
        # so cached-prefix locality buys it nothing
        return self._phase_of(fr) == PREFILL

    def _pick(self, now, exclude=None, fr=None):
        tier = DECODE if fr is None else self._phase_of(fr)
        best, best_score = None, None
        headroom = (max(0, int(self.config.priority_overcommit))
                    if (fr is not None and fr.priority > 0) else 0)
        for ctl in self._ctls:
            if (ctl.tier != tier or ctl.id == exclude
                    or not self._dispatchable(ctl, now, headroom)):
                continue
            s = self._score(ctl) - self._affinity_bonus(ctl, fr, now)
            if best_score is None or s < best_score:
                best, best_score = ctl, s
        return best

    def _should_hedge(self, fr, age) -> bool:
        # hedged PREFILL dispatch would hold two slots' KV for one
        # request and cancel cannot release a held twin — tiers and
        # hedging are mutually exclusive for now
        return False

    def _dispatch(self, now: float) -> int:
        """Tier-aware queue scan: the first request whose TIER has a
        dispatchable replica dispatches — a decode-phase head waiting
        on a full decode tier no longer blocks prefill-phase work
        behind it (and vice versa), which is what keeps both tiers'
        pipelines full."""
        n = 0
        while True:
            with self._lock:
                fr = ctl = None
                # priority dispatch: scan highest class
                # first, arrival order within a class (stable sort) —
                # the identity permutation when every class is 0
                scan = list(self._queue)
                if any(f.priority for f in scan):
                    scan.sort(key=lambda f: -f.priority)
                for cand in scan:
                    if cand.done():
                        self._queue.remove(cand)
                        continue
                    if (cand.deadline_at is not None
                            and now > cand.deadline_at):
                        self._queue.remove(cand)
                        self._shed(cand, "deadline", DeadlineExceeded(
                            f"fleet request {cand.rid} past deadline "
                            "before dispatch"))
                        n += 1
                        continue
                    c = self._pick(now, fr=cand)
                    if c is not None:
                        fr, ctl = cand, c
                        self._queue.remove(cand)
                        break
                if fr is None:
                    if (self._queue and not self._restartable()
                            and all(c.dead or c.scaled_down
                                    for c in self._ctls)
                            and not any(self._scalers.values())):
                        head = self._queue.popleft()
                        self._shed(head, "outage", OverloadError(
                            "fleet outage: every replica is dead and "
                            "nothing can bring one back"))
                        n += 1
                        continue
                    return n
                age = max(0.0, now - fr._queued_at)
                self._m_queue_age.observe(age)
                self._age_window.append(age)
            ok = self._dispatch_to(fr, ctl, now, hedge=False)
            if ok is None:
                return n
            n += 1

    def _hop_phase(self, fr) -> str:
        return self._phase_of(fr)

    def _submit_hop(self, ctl, fr, prompt, remaining, deadline_s,
                    ctx=None):
        if self._phase_of(fr) == PREFILL:
            # the prefill tier's job ends at the first token: hold the
            # finished slot (when the replica can export) so the
            # handoff finds its pages still referenced. A migrated
            # cache chain rides along, consumed-on-dispatch
            kw = {}
            mig, fr._migrate_kv = fr._migrate_kv, None
            if mig is not None:
                kw["kv"] = mig
            if fr.tenant is not None:         # per-tenant metering:
                kw["tenant"] = fr.tenant      # both hops bill the
            #                                   same tenant
            if fr.priority:                   # QoS class rides both
                kw["priority"] = fr.priority  # hops too
            # the first token is grammar-masked too
            kw.update(self._constrain_kw(fr, prompt))
            hold = bool(getattr(ctl.replica, "supports_handoff",
                                False))
            return ctl.replica.submit(prompt, 1, deadline_s,
                                      fr.on_deadline, hold_kv=hold,
                                      trace_ctx=ctx, **kw)
        kv, fr._handoff = fr._handoff, None   # consumed: a redispatch
        #                                       after any failure
        #                                       re-prefills instead
        if kv is not None:
            kv = self._match_target_kv(kv, ctl, fr)
        kw = {"kv": kv} if kv is not None else {}
        if fr.tenant is not None:
            kw["tenant"] = fr.tenant
        if fr.priority:
            kw["priority"] = fr.priority
        # the decode hop replays the whole committed prefix
        kw.update(self._constrain_kw(fr, prompt))
        rep = ctl.replica
        if kv is not None:
            rep.last_wire = None
        inner = rep.submit(prompt, remaining, deadline_s,
                           fr.on_deadline, trace_ctx=ctx, **kw)
        lw = getattr(rep, "last_wire", None) if kv is not None else None
        if lw:  # the handoff crossed the pipe as a kvwire frame
            self._kvwire_count("adopt", "ok", lw["bytes"],
                               lw["seconds"])
            fr.trace.add("kvwire", direction="adopt", outcome="ok",
                         bytes=lw["bytes"], seconds=lw["seconds"])
        return inner

    def _target_kv_mode(self, ctl) -> Optional[str]:
        """The decode target's KV quantization mode: read off the
        in-process engine directly, else the last health probe's
        kv_quantize, else the decode tier's own EngineConfig."""
        eng = getattr(ctl.replica, "engine", None)
        if eng is not None:
            return eng._kv_mode
        h = ctl.last_health or {}
        if "kv_quantize" in h:
            return h["kv_quantize"]
        dc = self._tier_cfgs.get(DECODE)
        return getattr(dc, "kv_quantize", None) if dc else None

    def _match_target_kv(self, kv, ctl, fr):
        """Quantize-on-adopt: a FLOAT handoff headed for a
        quantized decode replica is row-quantized HERE, at encode
        time — per-row absmax scales computed on the float rows ride
        with them — so heterogeneous tiers adopt instead of
        re-prefilling. Anything else passes through unchanged (the
        engine's own adoptability check still guards it), and a
        failed requantize just leaves the float handoff to be dropped
        there — re-prefill, never wrong."""
        want = self._target_kv_mode(ctl)
        if not want or kv.kv_mode is not None or kv.kv_mode == want:
            return kv
        try:
            return kvwire.requantize_handoff(kv, want)
        except Exception as e:
            log.warning("quantize-on-adopt to %r failed (%s); "
                        "request %d re-prefills", want, e, fr.rid)
            return kv

    # ------------------------------------------------------------------
    # the handoff
    # ------------------------------------------------------------------
    def _resolve_success(self, fr, hop) -> None:
        if fr.done():
            return
        if (hop is not None and self._phase_of(fr) == PREFILL
                and hop.committed().shape[0] < fr.max_new_tokens):
            self._finish_prefill_phase(fr, hop)
            return
        super()._resolve_success(fr, hop)

    def _finish_prefill_phase(self, fr: FleetHandle, hop) -> None:
        """The prefill hop completed: export the held slot's KV,
        flip the request to the decode phase, and requeue it at the
        FRONT (its first token is already committed — decode dispatch
        is the tail latency now). Export failure of any kind degrades
        to re-prefill on the decode tier — never a lost request."""
        now = self._clock()
        # capture the prefill hop's trace before its slot releases —
        # the stitched distributed trace's prefill-hop span
        self._record_hop(fr, hop, self._ctl(hop.replica_id),
                         "completed")
        fr._committed = hop.committed()
        ctl = self._ctl(hop.replica_id)
        seq = self._handoff_seq
        self._handoff_seq += 1
        handoff = None
        outcome = "fallback"
        wire = None                  # kvwire audit
        t0 = _perf()
        try:
            inj = self._injector
            if (inj is not None and hasattr(inj, "check_handoff")
                    and inj.check_handoff(seq)):
                raise HandoffError(
                    f"injected handoff export failure (seq {seq})")
            if (ctl is not None and not ctl.dead
                    and ctl.replica.alive()
                    and getattr(ctl.replica, "supports_handoff",
                                False)):
                handoff = ctl.replica.export_kv(hop.inner)
                lw = getattr(ctl.replica, "last_wire", None)
                if lw:   # the export crossed the pipe as a frame
                    wire = {"direction": "export", "outcome": "ok",
                            **lw}
                if (handoff is not None and inj is not None
                        and hasattr(inj, "check_corrupt_frame")
                        and inj.check_corrupt_frame(seq)):
                    # deterministic wire-fault realism: run the
                    # handoff through a REAL encode -> flip one
                    # payload byte -> decode round trip; the frame's
                    # CRC32 — not a mock — rejects it and the request
                    # degrades to re-prefill
                    frame = bytearray(kvwire.encode_handoff(handoff))
                    frame[-1] ^= 0xFF
                    wire = {"direction": "export",
                            "bytes": len(frame)}
                    handoff = kvwire.decode_handoff(bytes(frame))
                outcome = "ok"
        except Exception as e:
            outcome = "failed"
            handoff = None   # a corrupt frame's rows are never kept
            kind = getattr(e, "kind", None)   # typed WireError
            if kind is not None:
                wire = {**(wire or {"direction": "export"}),
                        "outcome": kind}
            log.warning("KV export from replica %d failed (%s); "
                        "request %d will re-prefill on the decode "
                        "tier", hop.replica_id, e, fr.rid)
            # the injected/raised-before-export case: release the held
            # slot so the prefill replica's pages (and seat) free —
            # engine directly in-process, over the pipe for subprocess
            # replicas
            self._release_hold(ctl, hop.inner)
        dt = _perf() - t0
        if wire is not None:
            wire.setdefault("outcome", "error")
            wire.setdefault("seconds", round(dt, 6))
            self._kvwire_count(wire["direction"], wire["outcome"],
                               wire.get("bytes", 0), wire["seconds"])
            fr.trace.add("kvwire", **wire)
        if handoff is not None:
            self._m_handoff_ok.inc()
            self._m_handoff_tokens.inc(int(handoff.pos))
            self._m_handoff_bytes.inc(int(handoff.nbytes))
            self._m_handoff_seconds.observe(dt)
        elif outcome == "failed":
            self._m_handoff_failed.inc()
        else:
            self._m_handoff_fallback.inc()
        fr.trace.add("handoff", outcome=outcome, **{
            "from": int(hop.replica_id),
            "tokens": (int(handoff.pos) if handoff is not None
                       else int(fr._committed.shape[0])),
            # the export's wall time rides in the event so the
            # stitcher can derive the handoff SPAN
            "seconds": round(dt, 6)})
        self._last_handoff = {
            "t": round(now, 6), "rid": fr.rid,
            "from": int(hop.replica_id), "outcome": outcome,
            "tokens": (int(handoff.pos) if handoff is not None
                       else None)}
        with self._lock:
            fr._phase = DECODE
            fr._handoff = handoff
            fr.status = RequestStatus.QUEUED
            fr._queued_at = now
            self._queue.appendleft(fr)

    def _release_hold(self, ctl, inner) -> None:
        """Free a held prefill slot this router will never export:
        the engine directly when we hold one, the replica's own
        release path (op over the pipe) otherwise. Always
        best-effort — the hold also dies with its process."""
        try:
            if ctl is None or ctl.dead:
                return
            eng = getattr(ctl.replica, "engine", None)
            if eng is not None:
                eng.release_held(inner)
                return
            rel = getattr(ctl.replica, "release_held", None)
            if rel is not None:
                rel(inner)
        except Exception:
            pass

    def _prepare_failover(self, fr: FleetHandle, ctl) -> None:
        """A lost DECODE replica took the request's adopted KV with
        it: reset to the prefill phase so the committed prefix
        re-prefills on the prefill tier (round-14 failover,
        generalized across the tier boundary). A lost prefill hop
        stays in its phase — it simply re-prefills elsewhere."""
        if self._phase_of(fr) == DECODE:
            fr._phase = PREFILL
            fr._handoff = None

    # ------------------------------------------------------------------
    # autoscaling
    # ------------------------------------------------------------------
    def tick(self) -> bool:
        progressed = super().tick()
        self._release_orphan_holds()
        progressed |= self._autoscale_tick()
        return progressed

    def _release_orphan_holds(self) -> None:
        """Free held prefill slots whose request will never export:
        a request can reach a terminal state with its prefill hop
        already done-and-held (budget filled during a failover
        re-prefill, deadline shed, cancel) — the harvest resolved the
        fleet handle without an export, so nothing else would release
        the seat. Any done+held slot with no outstanding hop pointing
        at it is such an orphan (exports happen synchronously inside
        the harvest, so none can be pending here)."""
        with self._lock:
            live = {id(h.inner) for ctl in self._ctls
                    for hops in ctl.outstanding.values()
                    for h in hops}
        for ctl in self._ctls:
            if ctl.dead:
                continue
            eng = getattr(ctl.replica, "engine", None)
            if eng is None:
                # subprocess replicas: the replica proxy
                # tracks which submits held their slot; any done one
                # no hop still points at is an orphan to release
                # over the pipe
                holds = getattr(ctl.replica, "held_handles", None)
                if holds is None:
                    continue
                for h in holds():
                    if h.done() and id(h) not in live:
                        log.info("releasing orphaned held slot for "
                                 "worker request %d on replica %d",
                                 h.rid, ctl.id)
                        ctl.replica.release_held(h)
                continue
            with eng._lock:
                orphans = [s for s in eng._slots
                           if s is not None and s.done()
                           and s._hold_kv and id(s) not in live]
            for s in orphans:
                log.info("releasing orphaned held slot for engine "
                         "request %d on replica %d", s.rid, ctl.id)
                eng.release_held(s)

    def _autoscale_tick(self) -> bool:
        now = self._clock()
        progressed = self._finish_scale_downs()
        lat = (self.tier_latency()
               if any(s is not None
                      and s.policy.scale_up_span_p99_ms is not None
                      for s in self._scalers.values()) else {})
        for tier, scaler in self._scalers.items():
            if scaler is None:
                continue
            active = self._active_ctls(tier)
            in_flight = sum(c.n_outstanding()
                            for c in self._tier_ctls(tier))
            # the tier's own work span (prefill tier -> prefill span,
            # decode tier -> decode span) from stitched traces
            span = lat.get(tier, {}).get(
                PREFILL if tier == PREFILL else DECODE, {})
            d = scaler.observe(
                now, len(active), self._tier_occupancy(tier),
                self._tier_budget_utilization(tier),
                self._tier_pending(tier), in_flight,
                span_p99_ms=span.get("p99_ms"))
            if d > 0:
                progressed |= self._scale_up(tier, now)
            elif d < 0:
                progressed |= self._scale_down(tier, now)
        return progressed

    def _log_autoscale(self, tier: str, direction: str, now: float,
                       cold_start_s: Optional[float] = None) -> None:
        n = len(self._active_ctls(tier))
        self._m_autoscale.labels(tier, direction).inc()
        entry = {"t": round(now, 6), "tier": tier,
                 "direction": direction, "replicas": n}
        if cold_start_s is not None:
            # scale-up build latency: ~the compile set on a
            # cold host, ~the AOT-cache load set on a warm one — the
            # number EngineConfig.compile_cache_dir exists to shrink
            entry["cold_start_s"] = round(cold_start_s, 4)
        self.autoscale_log.append(entry)
        self.recorder.record("autoscale", rid=0, tier=tier,
                             direction=direction, replicas=n)
        log.info("autoscale: tier %s %s -> %d replica(s)", tier,
                 direction, n)

    def _scale_up(self, tier: str, now: float) -> bool:
        """Revive a STOPPED replica of the tier, else build a fresh
        one from the tier's factory. The process-wide compiled-
        program caches make either path cheap on a warm host, and a
        factory whose EngineConfig sets compile_cache_dir (+
        warmup_on_init) makes it cheap on a COLD one too: the new
        engine LOADS its program set from the persistent AOT cache
        (serving/compile_cache.py) instead of recompiling it — the
        per-event build latency lands in autoscale_log as
        cold_start_s."""
        for ctl in self._tier_ctls(tier):
            if ctl.scaled_down:
                try:
                    ctl.replica.restart()
                except Exception as e:
                    log.error("autoscale: revive of replica %d failed "
                              "(%s)", ctl.id, e)
                    return False
                ctl.scaled_down = False
                ctl.dead = False
                ctl.unhealthy = False
                ctl.draining = False
                ctl.no_progress = 0
                ctl.consec_crashes = 0
                ctl.breaker_failures = 0
                ctl.breaker_open_until = 0.0
                ctl.next_restart_at = None
                self._log_autoscale(
                    tier, "up", now,
                    cold_start_s=getattr(ctl.replica, "cold_start_s",
                                         None))
                self._proactive_seed(ctl)
                return True
        replica = InProcessReplica(self._next_id,
                                   self._factories[tier],
                                   http_probes=self._http_probes)
        self._next_id += 1
        ctl = _ReplicaCtl(replica)
        ctl.tier = tier
        with self._lock:
            self._ctls.append(ctl)
        self._log_autoscale(tier, "up", now,
                            cold_start_s=getattr(replica,
                                                 "cold_start_s", None))
        self._proactive_seed(ctl)
        return True

    def _proactive_seed(self, ctl) -> None:
        """Proactive KV migration: before any traffic
        lands on a just-scaled-up replica, push the fleet's hottest
        advertised chains into its radix cache — its first dispatches
        then hit the prefix cache instead of prefilling from zero,
        which is the whole point of scaling up under prefix-heavy
        load. Takes the ``proactive_chains`` largest chains across
        every live digest (0 disables). Best-effort end to end: a
        stale or failed push costs nothing but itself, counted with
        the same kv_migration metrics/events as demand migration
        (marked ``proactive``)."""
        k = max(0, int(getattr(self.config, "proactive_chains", 0)))
        seeder = getattr(ctl.replica, "seed_chain", None)
        if k == 0 or seeder is None:
            return
        cands = []
        for src in self._ctls:
            if (src is ctl or src.dead or not src.digest
                    or not hasattr(src.replica, "export_cached_chain")):
                continue
            for h, toks in src.digest.get("top", ()):
                cands.append((int(toks), int(h), src))
        cands.sort(key=lambda t: -t[0])
        pushed = 0
        seen = set()
        for toks, h, src in cands:
            if pushed >= k:
                break
            if h in seen:
                continue
            seen.add(h)
            outcome, nbytes = "stale", 0
            try:
                kvh = src.replica.export_cached_chain(h)
                if kvh is not None:
                    nbytes = int(kvh.nbytes)
                    outcome = "ok" if seeder(kvh) else "failed"
            except Exception as e:
                outcome = "failed"
                log.warning("proactive chain push %x from replica %d "
                            "failed (%s)", h, src.id, e)
            if outcome == "ok":
                pushed += 1
                self._m_migrations_ok.inc()
                self._m_migrated_tokens.inc(toks)
                self._m_migrated_bytes.inc(nbytes)
            elif outcome == "failed":
                self._m_migrations_failed.inc()
            else:
                self._m_migrations_stale.inc()
            self.recorder.record(
                "kv_migration", rid=0, outcome=outcome,
                proactive=True, **{"from": int(src.id),
                                   "to": int(ctl.id),
                                   "tokens": int(toks),
                                   "bytes": nbytes})
        if pushed:
            log.info("proactively seeded %d chain(s) into replica %d",
                     pushed, ctl.id)

    def _scale_down(self, tier: str, now: float) -> bool:
        """Pick the emptiest replica of the tier and drain it out of
        rotation; `_finish_scale_downs` stops it once its residents
        finish — zero shed requests by construction."""
        candidates = self._active_ctls(tier)
        if not candidates:
            return False
        victim = min(candidates,
                     key=lambda c: (c.n_outstanding(), -c.id))
        victim.draining = True
        victim._scale_down_pending = True
        self._log_autoscale(tier, "down", now)
        return True

    def _finish_scale_downs(self) -> bool:
        progressed = False
        for ctl in self._ctls:
            if not getattr(ctl, "_scale_down_pending", False):
                continue
            if ctl.dead:             # crashed while draining: the
                ctl._scale_down_pending = False   # failover path owns
                ctl.draining = False              # it now
                continue
            if ctl.outstanding or ctl.replica.busy():
                continue
            ctl._scale_down_pending = False
            try:
                ctl.replica.kill()
            except Exception:
                pass
            ctl.dead = True
            ctl.scaled_down = True
            ctl.draining = False
            ctl.next_restart_at = None
            ctl.killed_at = None
            ctl.consec_crashes = 0
            progressed = True
        return progressed

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def _last_handoff_for(self, tier: str) -> Optional[dict]:
        return self._last_handoff if tier in (PREFILL, DECODE) else None

    def health(self) -> dict:
        h = super().health()
        h["tiers"] = {tier: {
            "replicas": len(self._active_ctls(tier)),
            "occupancy": round(self._tier_occupancy(tier), 3),
            "pending": self._tier_pending(tier)}
            for tier in (PREFILL, DECODE)}
        return h

    def debugz(self, recent: int = 100) -> dict:
        d = super().debugz(recent)
        d["handoffs"] = {
            "ok": int(self._m_handoff_ok.value),
            "fallback": int(self._m_handoff_fallback.value),
            "failed": int(self._m_handoff_failed.value),
            "tokens": int(self._m_handoff_tokens.value),
            "bytes": int(self._m_handoff_bytes.value),
            "last": self._last_handoff}
        d["autoscale"] = {
            "log": list(self.autoscale_log[-20:]),
            "policies": {t: (vars(s.policy) if s else None)
                         for t, s in self._scalers.items()}}
        return d

    @property
    def stats(self) -> dict:
        s = super().stats
        s["handoffs_ok"] = int(self._m_handoff_ok.value)
        s["handoffs_fallback"] = int(self._m_handoff_fallback.value)
        s["handoffs_failed"] = int(self._m_handoff_failed.value)
        return s

"""Deterministic fault injection for the serving engine.

Port of the serving half of deeplearning4j_tpu/parallel/failure.py
(:47-322): `TrainingFailure`, the base `FaultInjector` and
`ServingFaultInjector`, copied so that the port imports nothing of the
JAX package (whose module imports its training guard, its checkpoint
manager and its metrics registry). The engine
(`serving.engine.InferenceEngine(fault_injector=...)`) calls the
injector's hooks immediately before every program call, with the ids of
every co-resident request; a hook that raises `TrainingFailure` is a
failed call, which the engine retries, then isolates and quarantines.

The base class's checkpoint hooks (`on_checkpoint_write`,
`on_checkpoint_published`) are plain methods on a directory path, which
the port's `util.checkpointing.CheckpointManager(fault_injector=...)`
calls around its atomic publication (a crash mid-write, a torn step).

The hostile-tenant storm generator (`StormArrival`,
`hostile_tenant_storm`, `storm_prompt`; reference :526-611) is copied too:
the scripted traffic that tenant QoS (fair-share prefill and priority
preemption) is held to.

`FleetFaultInjector` (reference :324-446) is copied too: the fleet
router's hooks (`serving.fleet.Router`, `serving.disagg.TieredRouter`)
for replica kill, hang, slowdown, probe failure, a failed KV export and
a corrupted kvwire frame.

The training side (reference :612-956) is ported: `PreemptionHandler`
(SIGTERM / SIGINT, or `request_stop()` in flag-only mode off the main
thread), `StepWatchdog` (a monitor thread; escalates with
`train.guard.StepTimeout`) and `FaultTolerantTrainer` (periodic, optionally
async, checkpoints; restore and resume; the injector's crash, NaN and
preemption knobs; rollback with LR back-off through the guard; the
consecutive-failure budget), under the reference's series names. A
failed step on the card surfaces as a RuntimeError, as on the CPU, and
is the only error the trainer recovers from.

`ElasticFaultInjector` (reference :447-523) is copied too: the elastic
coordinator's one-shot kill, hang, slow and join knobs
(`train.elastic.ElasticCoordinator`).
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.multilayer import _unpack_batch
from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.train.guard import (DivergenceError,
                                                  StepTimeout, TrainingGuard)
from deeplearning4j_tpu_torch.util.checkpointing import CheckpointManager

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingFailure(RuntimeError):
    """Raised by fault injection; real device errors (a CUDA error
    surfaces as a RuntimeError) are caught by their base RuntimeError."""


class FaultInjector:
    """Deterministically fail chosen iterations (test harness).
    `persistent=True` keeps failing the same iteration on retry: a hard
    fault (bad host, poisoned input) rather than a transient one.

    Durability knobs (all one-shot unless ``persistent``):

    - ``nan_at``: iterations whose batch a trainer poisons to NaN
      (checked via `check_nan`).
    - ``preempt_at``: iterations at which a simulated SIGTERM requests a
      graceful stop (checked via `check_preempt`).
    - ``crash_write_at``: checkpoint steps whose write dies mid-staging
      (before the atomic rename).
    - ``torn_write_at``: checkpoint steps whose arrays.npz is replaced
      after publication with zip-valid zeroed arrays.
    - ``write_delay_s``: stall every checkpoint write by this many
      seconds.
    """

    def __init__(self, fail_at: Iterable[int] = (),
                 persistent: bool = False,
                 nan_at: Iterable[int] = (),
                 preempt_at: Iterable[int] = (),
                 crash_write_at: Iterable[int] = (),
                 torn_write_at: Iterable[int] = (),
                 write_delay_s: float = 0.0):
        self.fail_at = set(int(i) for i in fail_at)
        self.persistent = persistent
        self.nan_at = set(int(i) for i in nan_at)
        self.preempt_at = set(int(i) for i in preempt_at)
        self.crash_write_at = set(int(i) for i in crash_write_at)
        self.torn_write_at = set(int(i) for i in torn_write_at)
        self.write_delay_s = float(write_delay_s)
        self.injected = 0
        self.nans_injected = 0
        self.preempts_injected = 0
        self.writes_crashed = 0
        self.writes_torn = 0

    def check(self, iteration: int) -> None:
        if iteration in self.fail_at:
            if not self.persistent:
                self.fail_at.discard(iteration)
            self.injected += 1
            raise TrainingFailure(f"injected fault at iteration "
                                  f"{iteration}")

    def check_nan(self, iteration: int) -> bool:
        """True when this iteration's batch should be NaN-poisoned."""
        if iteration in self.nan_at:
            if not self.persistent:
                self.nan_at.discard(iteration)
            self.nans_injected += 1
            return True
        return False

    def check_preempt(self, iteration: int) -> bool:
        """True when a simulated preemption signal lands here."""
        if iteration in self.preempt_at:
            self.preempt_at.discard(iteration)
            self.preempts_injected += 1
            return True
        return False

    # -- checkpoint-writer hooks -------------------------------------------
    def on_checkpoint_write(self, step: int, staging_dir) -> None:
        """Runs after staging is fully written, before the atomic rename:
        a raise here models a kill mid-write."""
        if self.write_delay_s > 0:
            time.sleep(self.write_delay_s)
        if step in self.crash_write_at:
            if not self.persistent:
                self.crash_write_at.discard(step)
            self.writes_crashed += 1
            raise TrainingFailure(
                f"injected crash during checkpoint write of step {step}")

    def on_checkpoint_published(self, step: int, final_dir) -> None:
        """Runs after the atomic rename: a torn write replaces the
        published arrays with zip-valid zeroed content (same names,
        shapes, dtypes), which only a checksum manifest can tell."""
        if step not in self.torn_write_at:
            return
        if not self.persistent:
            self.torn_write_at.discard(step)
        p = Path(final_dir) / "arrays.npz"
        with np.load(p) as data:
            zeroed = {k: np.zeros_like(data[k]) for k in data.files}
        np.savez(p, **zeroed)
        self.writes_torn += 1
        log.warning("injected torn write: step %d arrays zeroed "
                    "post-publication", step)


class ServingFaultInjector(FaultInjector):
    """Serving-side deterministic fault injection: the engine calls
    ``on_decode_step`` (or ``on_prefill`` / ``on_prefill_chunk``)
    immediately before every program call.

    Knobs:
      - ``fail_at`` / ``persistent``: step indices to fail. Step indices
        count completed calls, so a failed attempt is retried at the
        same index: a non-persistent fault vanishes on the first retry,
        ``persistent=True`` fails the step through every retry (the
        circuit breaker is what reacts).
      - ``poison_requests``: request ids that fail every call containing
        them: the per-request hard fault. The engine isolates the pool
        (solo re-runs) and quarantines exactly the poisoned requests.
      - ``delay_at``: ``{step: seconds}`` one-shot host stalls before the
        step launches (deadline misses without real overload).
      - ``prefill_fail_at``: step indices at which a prefill call fails
        (admission prefills and decode chunks share one step counter).
      - ``corrupt_page_at``: ``{step: request_id}``: before the call
        holding that step index, a paged engine writes garbage over the
        KV page the named request's next token is written to. The
        copy-on-write guard makes every write target private, so the
        garbage lands on the writer's page only.
      - ``prefill_chunk_fail_at``: step indices at which a chunked
        prefill call fails (``prefill_fail_at`` fires on those calls
        too; this knob is the narrower one).
      - ``adopt_fail_requests``: request ids whose KV adoption fails at
        seating: the engine's `_seat_adopted` calls `check_adopt` and
        sheds the request typed ``handoff``.
      - ``draft_poison_at``: ``{step: request_id}``: the speculative
        round at that step derails the named request's drafts ((d+1)
        mod V on the device), so verification rejects them all; the
        round commits one target-verified token and the adaptive-K
        controller falls back to K=1.
    """

    def __init__(self, fail_at: Iterable[int] = (),
                 persistent: bool = False,
                 poison_requests: Iterable[int] = (),
                 delay_at: Optional[dict] = None,
                 prefill_fail_at: Iterable[int] = (),
                 corrupt_page_at: Optional[dict] = None,
                 draft_poison_at: Optional[dict] = None,
                 prefill_chunk_fail_at: Iterable[int] = (),
                 adopt_fail_requests: Iterable[int] = ()):
        super().__init__(fail_at, persistent=persistent)
        self.adopt_fail_requests = set(int(r)
                                       for r in adopt_fail_requests)
        self.adoptions_failed = 0
        self.poison_requests = set(int(r) for r in poison_requests)
        self.delay_at = {int(k): float(v)
                         for k, v in (delay_at or {}).items()}
        self.delays_injected = 0
        self.prefill_fail_at = set(int(i) for i in prefill_fail_at)
        self.prefills_failed = 0
        self.prefill_chunk_fail_at = set(
            int(i) for i in prefill_chunk_fail_at)
        self.prefill_chunks_failed = 0
        self.corrupt_page_at = {int(k): int(v)
                                for k, v in (corrupt_page_at
                                             or {}).items()}
        self.pages_corrupted = 0
        self.draft_poison_at = {int(k): int(v)
                                for k, v in (draft_poison_at
                                             or {}).items()}
        self.drafts_poisoned = 0

    def check_corrupt_page(self, step: int) -> Optional[int]:
        """One-shot: the request id whose next-write page the paged
        engine should poison before the call at ``step``, else None.
        The counter bumps when the engine confirms the write landed."""
        return self.corrupt_page_at.pop(int(step), None)

    def check_adopt(self, rid: int) -> bool:
        """One-shot: True when request ``rid``'s KV adoption should fail
        at seating."""
        if int(rid) in self.adopt_fail_requests:
            if not self.persistent:
                self.adopt_fail_requests.discard(int(rid))
            self.adoptions_failed += 1
            return True
        return False

    def check_draft_poison(self, step: int) -> Optional[int]:
        """One-shot: the request id whose draft proposals the speculative
        round at ``step`` should derail, else None. The counter bumps
        when the engine confirms the poison landed on a seated slot."""
        return self.draft_poison_at.pop(int(step), None)

    def on_decode_step(self, step: int,
                       request_ids: Iterable[int] = ()) -> None:
        d = self.delay_at.pop(int(step), 0.0)
        if d > 0:
            self.delays_injected += 1
            time.sleep(d)
        bad = self.poison_requests.intersection(
            int(r) for r in request_ids)
        if bad:
            self.injected += 1
            raise TrainingFailure(
                f"poisoned request(s) {sorted(bad)} at decode step "
                f"{step}")
        self.check(int(step))

    def on_prefill(self, step: int,
                   request_ids: Iterable[int] = ()) -> None:
        """Prefill-side hook: the shared step counter and the poison /
        fail_at / delay semantics of `on_decode_step`, plus the
        prefill-only ``prefill_fail_at`` knob."""
        if int(step) in self.prefill_fail_at:
            if not self.persistent:
                self.prefill_fail_at.discard(int(step))
            self.injected += 1
            self.prefills_failed += 1
            raise TrainingFailure(
                f"injected prefill fault at step {step}")
        self.on_decode_step(step, request_ids)

    def on_prefill_chunk(self, step: int,
                         request_ids: Iterable[int] = ()) -> None:
        """Chunked-prefill hook: ``prefill_chunk_fail_at`` fires only on
        the token-budget scheduler's chunk calls, then the call falls
        through to `on_prefill` (a chunked call is a prefill call)."""
        if int(step) in self.prefill_chunk_fail_at:
            if not self.persistent:
                self.prefill_chunk_fail_at.discard(int(step))
            self.injected += 1
            self.prefill_chunks_failed += 1
            raise TrainingFailure(
                f"injected prefill-chunk fault at step {step}")
        self.on_prefill(step, request_ids)


class FleetFaultInjector:
    """Fleet-level deterministic fault injection (reference :324-446),
    the router-hook analog of `ServingFaultInjector`: `serving/fleet.py`'s
    `Router` consults it at the start of every scheduling tick (and at
    every probe), so replica-loss scenarios that would need a real
    crashed host replay deterministically on the CPU
    (tests/test_torch_fleet.py).

    Knobs (router-TICK indexed where time matters):

    - ``kill_at``: ``{tick: replica_id}`` — the replica crashes at the
      start of that router tick. In-process replicas are marked dead
      (their engine, and every in-flight request's device state, is
      abandoned exactly as a crashed process would abandon it);
      subprocess replicas take a real SIGKILL. The router's contract
      under test: every in-flight request fails over to a survivor
      from its committed prefix — at most one retried dispatch, zero
      lost requests.
    - ``hang_at``: ``{tick: replica_id}`` — the replica stops making
      progress while staying alive and (in-process) answering probes:
      the wedged-grant failure mode a liveness probe cannot see.
      Subprocess replicas are SIGSTOPped (probes time out too). The
      router's no-progress detector must declare it hung and fail
      over.
    - ``slow_at``: ``{tick: (replica_id, seconds)}`` — from that tick
      on, every scheduling step of the replica stalls ``seconds``
      (in-process replicas only): the gray-failure mode hedged
      dispatch exists for.
    - ``fail_probe``: ``{replica_id: n}`` — the replica's next ``n``
      probes fail (the router must take it out of rotation WITHOUT
      killing it, and return it when probes recover).
    - ``handoff_fail_at``: handoff sequence indices (0-based, counted
      across the tiered router's lifetime) whose KV EXPORT from the
      prefill-tier replica fails. The contract under test:
      the request is never lost — the decode dispatch falls back to
      re-prefilling the committed prefix, token-exactly, and the
      handoff is counted ``outcome="failed"``.
    - ``corrupt_frame_at``: handoff sequence indices whose EXPORTED
      kvwire frame is corrupted in flight: the tiered
      router runs the exported handoff through a real encode ->
      flip-one-payload-byte -> decode round trip, so the frame's
      CRC32 check — not a mock — rejects it. Contract under test:
      typed ``WireError(kind="crc")``, a ``kvwire`` trace event, the
      handoff counted ``outcome="failed"``, and the request completes
      token-exactly via re-prefill.
    """

    def __init__(self, kill_at: Optional[dict] = None,
                 hang_at: Optional[dict] = None,
                 slow_at: Optional[dict] = None,
                 fail_probe: Optional[dict] = None,
                 handoff_fail_at: Iterable[int] = (),
                 corrupt_frame_at: Iterable[int] = ()):
        self.kill_at = {int(k): int(v)
                        for k, v in (kill_at or {}).items()}
        self.hang_at = {int(k): int(v)
                        for k, v in (hang_at or {}).items()}
        self.slow_at = {int(k): (int(v[0]), float(v[1]))
                        for k, v in (slow_at or {}).items()}
        self.fail_probe = {int(k): int(v)
                           for k, v in (fail_probe or {}).items()}
        self.handoff_fail_at = set(int(i) for i in handoff_fail_at)
        self.corrupt_frame_at = set(int(i) for i in corrupt_frame_at)
        self.kills_injected = 0
        self.hangs_injected = 0
        self.slows_injected = 0
        self.probe_failures_injected = 0
        self.handoffs_failed = 0
        self.frames_corrupted = 0

    def check_kill(self, tick: int) -> Optional[int]:
        """One-shot: the replica id to crash at ``tick``, else None."""
        rid = self.kill_at.pop(int(tick), None)
        if rid is not None:
            self.kills_injected += 1
        return rid

    def check_hang(self, tick: int) -> Optional[int]:
        """One-shot: the replica id to wedge at ``tick``, else None."""
        rid = self.hang_at.pop(int(tick), None)
        if rid is not None:
            self.hangs_injected += 1
        return rid

    def check_slow(self, tick: int) -> Optional[tuple]:
        """One-shot: ``(replica_id, seconds)`` to slow from ``tick``
        on, else None."""
        v = self.slow_at.pop(int(tick), None)
        if v is not None:
            self.slows_injected += 1
        return v

    def check_handoff(self, seq: int) -> bool:
        """One-shot: True when the ``seq``-th handoff's KV export
        should fail (the tiered router then falls back to
        re-prefilling on the decode tier)."""
        if int(seq) in self.handoff_fail_at:
            self.handoff_fail_at.discard(int(seq))
            self.handoffs_failed += 1
            return True
        return False

    def check_corrupt_frame(self, seq: int) -> bool:
        """One-shot: True when the ``seq``-th handoff's exported
        kvwire frame should be corrupted in flight (the CRC check
        rejects it and the decode tier re-prefills)."""
        if int(seq) in self.corrupt_frame_at:
            self.corrupt_frame_at.discard(int(seq))
            self.frames_corrupted += 1
            return True
        return False

    def check_probe(self, replica_id: int) -> bool:
        """True when this probe of ``replica_id`` should fail
        (decrements that replica's remaining failure budget)."""
        n = self.fail_probe.get(int(replica_id), 0)
        if n > 0:
            self.fail_probe[int(replica_id)] = n - 1
            self.probe_failures_injected += 1
            return True
        return False


class ElasticFaultInjector:
    """Elastic-training deterministic fault injection (reference
    :447-523), the training analog of `FleetFaultInjector`: the elastic
    coordinator (`train/elastic.py`) consults it at the start of every
    global step, so membership churn that would need real crashed hosts
    replays deterministically.

    All knobs are keyed by GLOBAL step index and fire one-shot: after a
    lossy resize rewinds the step counter, replayed steps do not re-fire
    an already-consumed injection.

    - ``kill_at``: ``{step: worker_id}`` — the worker takes a real
      SIGKILL at the start of that step; the coordinator resizes from
      the last published checksummed checkpoint and replays the data
      cursor, bit-identical to an uninterrupted run.
    - ``hang_at``: ``{step: worker_id}`` — the worker is SIGSTOPped:
      alive to the OS, silent on the pipe. The straggler path escalates
      (loose sync) and eventually evicts it.
    - ``slow_at``: ``{step: (worker_id, seconds)}`` — from that step
      on, the worker sleeps ``seconds`` before answering each command
      (worker-side, over the pipe). ``seconds=0`` clears the slowdown.
    - ``join_at``: ``{step: worker_id}`` — a new worker (or a killed
      one's replacement, same id) is spawned and adopted at that step's
      resize barrier.
    """

    def __init__(self, kill_at: Optional[dict] = None,
                 hang_at: Optional[dict] = None,
                 slow_at: Optional[dict] = None,
                 join_at: Optional[dict] = None):
        self.kill_at = {int(k): int(v)
                        for k, v in (kill_at or {}).items()}
        self.hang_at = {int(k): int(v)
                        for k, v in (hang_at or {}).items()}
        self.slow_at = {int(k): (int(v[0]), float(v[1]))
                        for k, v in (slow_at or {}).items()}
        self.join_at = {int(k): int(v)
                        for k, v in (join_at or {}).items()}
        self.kills_injected = 0
        self.hangs_injected = 0
        self.slows_injected = 0
        self.joins_injected = 0

    def check_kill(self, step: int) -> Optional[int]:
        """One-shot: the worker id to SIGKILL at ``step``, else None."""
        wid = self.kill_at.pop(int(step), None)
        if wid is not None:
            self.kills_injected += 1
        return wid

    def check_hang(self, step: int) -> Optional[int]:
        """One-shot: the worker id to SIGSTOP at ``step``, else None."""
        wid = self.hang_at.pop(int(step), None)
        if wid is not None:
            self.hangs_injected += 1
        return wid

    def check_slow(self, step: int) -> Optional[tuple]:
        """One-shot: ``(worker_id, seconds)`` per-command slowdown to
        apply from ``step`` on (0 clears), else None."""
        v = self.slow_at.pop(int(step), None)
        if v is not None:
            self.slows_injected += 1
        return v

    def check_join(self, step: int) -> Optional[int]:
        """One-shot: the worker id to spawn+adopt at ``step``, else
        None."""
        wid = self.join_at.pop(int(step), None)
        if wid is not None:
            self.joins_injected += 1
        return wid


@dataclass(frozen=True)
class StormArrival:
    """One scripted submission of a hostile-tenant storm: at tick
    ``tick``, tenant ``tenant`` submits a ``prompt_tokens``-long prompt
    (derived from ``seed`` by `storm_prompt`) asking for
    ``max_new_tokens`` at QoS class ``priority``."""
    tick: int
    tenant: str
    priority: int
    seed: int
    prompt_tokens: int
    max_new_tokens: int


def hostile_tenant_storm(ticks: int = 120, *,
                         victim: str = "victim",
                         victim_every: int = 4,
                         victim_prompt: int = 8,
                         victim_new: int = 8,
                         victim_priority: int = 5,
                         hostiles: int = 3,
                         flood_per_tick: int = 2,
                         hostile_prompt: int = 24,
                         hostile_new: int = 16,
                         start_tick: int = 0,
                         kill_tick: Optional[int] = None,
                         kill_replica: int = 0,
                         slow_tick: Optional[int] = None,
                         slow_replica: int = 0,
                         slow_seconds: float = 0.05,
                         ) -> Tuple[List[StormArrival], Dict]:
    """Deterministic hostile-tenant arrival script (reference :541).

    One well-behaved ``victim`` tenant submits a short high-priority
    request every ``victim_every`` ticks while ``hostiles`` flood
    tenants each submit ``flood_per_tick`` long low-priority requests
    every tick. No RNG is consulted: the same kwargs always yield the
    same arrivals.

    Returns ``(arrivals, injector_kwargs)``: arrivals sorted by
    ``(tick, submission order)``, and the fleet injector's kwargs for
    the optional ``kill_tick`` and ``slow_tick`` knobs (empty when
    neither is set)."""
    if ticks <= 0 or victim_every <= 0:
        raise ValueError("ticks and victim_every must be positive")
    arrivals: List[StormArrival] = []
    seed = 0
    for t in range(start_tick, start_tick + int(ticks)):
        if (t - start_tick) % int(victim_every) == 0:
            arrivals.append(StormArrival(
                tick=t, tenant=victim, priority=int(victim_priority),
                seed=seed, prompt_tokens=int(victim_prompt),
                max_new_tokens=int(victim_new)))
            seed += 1
        for h in range(int(hostiles)):
            for _ in range(int(flood_per_tick)):
                arrivals.append(StormArrival(
                    tick=t, tenant=f"hostile{h}", priority=0,
                    seed=seed, prompt_tokens=int(hostile_prompt),
                    max_new_tokens=int(hostile_new)))
                seed += 1
    injector_kwargs: Dict = {}
    if kill_tick is not None:
        injector_kwargs["kill_at"] = {int(kill_tick): int(kill_replica)}
    if slow_tick is not None:
        injector_kwargs["slow_at"] = {
            int(slow_tick): (int(slow_replica), float(slow_seconds))}
    return arrivals, injector_kwargs


def storm_prompt(arrival: StormArrival, vocab_size: int) -> np.ndarray:
    """The deterministic prompt of one `StormArrival`, keyed on its seed
    so distinct arrivals exercise distinct prefixes."""
    n = int(arrival.prompt_tokens)
    return (np.arange(n, dtype=np.int32) * (int(arrival.seed) * 2 + 3)
            + int(arrival.seed)) % int(vocab_size)


class PreemptionHandler:
    """Graceful-stop coordination for SIGTERM/SIGINT preemptions.

    `install()` hooks the signals (main thread only — elsewhere the
    handler degrades to flag-only mode, driven via `request_stop()`,
    which is also what `FaultInjector.preempt_at` simulation uses).
    The flag is checked by `FaultTolerantTrainer` at every step
    boundary: the current step finishes, a checkpoint is written, and
    `fit` returns resumable instead of dying mid-step with hours of
    work discarded. Publishes `preemption_stop_requested` (gauge) and
    `preemption_signals_total`."""

    def __init__(self, signals: Optional[Iterable[int]] = None,
                 registry=None):
        import signal as _signal
        self._signal_mod = _signal
        if signals is None:
            signals = [s for s in (getattr(_signal, "SIGTERM", None),
                                   getattr(_signal, "SIGINT", None))
                       if s is not None]
        self.signals = tuple(signals)
        self._stop = threading.Event()
        self._prev: dict = {}
        self.installed = False
        self.signals_seen = 0
        reg = registry if registry is not None else default_registry()
        self._m_signals = reg.counter(
            "preemption_signals_total",
            "Preemption signals (or simulations) observed")
        reg.gauge(
            "preemption_stop_requested",
            "1 while a graceful stop is pending"
        ).set_function(lambda: 1.0 if self._stop.is_set() else 0.0)

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            log.warning("PreemptionHandler: not on the main thread; "
                        "signal hooks unavailable (flag-only mode)")
            return self
        for sig in self.signals:
            self._prev[sig] = self._signal_mod.signal(sig,
                                                      self._on_signal)
        self.installed = True
        return self

    def _on_signal(self, signum, frame) -> None:
        self.signals_seen += 1
        self._m_signals.inc()
        log.warning("signal %s received: graceful stop requested at "
                    "next step boundary", signum)
        self.request_stop()

    def request_stop(self) -> None:
        self._stop.set()

    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def clear(self) -> None:
        self._stop.clear()

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                self._signal_mod.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class StepWatchdog:
    """Monitor thread flagging training steps that exceed a wall-clock
    deadline: the hung step that neither completes nor raises. `arm()`
    before the step, `disarm()` after; a step still armed past
    ``deadline_s`` is flagged once (logged,
    `watchdog_hung_steps_total` bumped, ``on_hung(iteration,
    elapsed_s)`` called if given — e.g. a PreemptionHandler's
    request_stop for checkpoint-and-exit policies).

    ``escalate`` receives a typed `train.guard.StepTimeout` for the same
    flagging.
    ``clock`` is injectable and `check()` is the synchronous detection
    step the monitor thread runs — unit tests drive it directly with a
    fake clock, no thread, fully deterministic."""

    def __init__(self, deadline_s: float,
                 on_hung: Optional[Callable[[int, float], None]] = None,
                 poll_s: Optional[float] = None,
                 escalate: Optional[Callable[..., None]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 registry=None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.on_hung = on_hung
        self.escalate = escalate
        self.clock = clock
        self.poll_s = (max(0.005, min(self.deadline_s / 4.0, 0.25))
                       if poll_s is None else float(poll_s))
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None
        self._iteration = 0
        self._flagged = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hung_iterations: list = []
        self.timeouts: list = []
        reg = registry if registry is not None else default_registry()
        self._m_hung = reg.counter(
            "watchdog_hung_steps_total",
            "Steps that exceeded the watchdog deadline")
        reg.gauge(
            "watchdog_step_deadline_seconds",
            "Configured per-step watchdog deadline").set(self.deadline_s)

    def start(self) -> "StepWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="step-watchdog",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def arm(self, iteration: int) -> None:
        with self._lock:
            self._armed_at = self.clock()
            self._iteration = int(iteration)
            self._flagged = False

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None

    def check(self) -> Optional["StepTimeout"]:
        """One synchronous detection pass: flag the armed step if it
        is past deadline (once per arm), run the callbacks, and return
        the typed `StepTimeout` — or None when nothing fired. The
        monitor thread calls this every ``poll_s``; callers with their
        own event loop (or a fake clock in tests) call it directly."""
        cb = esc = None
        with self._lock:
            if self._armed_at is None or self._flagged:
                return None
            elapsed = self.clock() - self._armed_at
            if elapsed <= self.deadline_s:
                return None
            self._flagged = True
            self.hung_iterations.append(self._iteration)
            self._m_hung.inc()
            it, cb, esc = self._iteration, self.on_hung, self.escalate
            log.error("watchdog: step %d exceeded %.3fs "
                      "deadline (%.3fs elapsed and counting)",
                      self._iteration, self.deadline_s, elapsed)
        timeout = StepTimeout(iteration=it, deadline_s=self.deadline_s,
                              elapsed_s=elapsed)
        self.timeouts.append(timeout)
        if cb is not None:
            cb(it, elapsed)
        if esc is not None:
            esc(timeout)
        return timeout

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check()

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class FaultTolerantTrainer:
    """Run fit over an iterator with checkpoint/restore-based recovery.

    Each minibatch step is guarded; on failure the model is restored
    from the latest checkpoint and the epoch continues from the current
    batch (at-least-once batch semantics — same guarantee as the
    reference's Spark retry, which may also re-process a split).

    ``max_restarts`` bounds CONSECUTIVE failures, not lifetime
    failures: the counter resets on every successful step, so
    max_restarts transient faults spread across a long job no longer
    abort it — only a fault that persists through max_restarts
    back-to-back recovery attempts does. ``restarts`` stays the
    cumulative total for reporting.

    Durability integrations (all optional):

    - ``guard``: a `TrainingGuard` installed on the net — NaN/spike
      steps are skipped; a `DivergenceError` rollback restores the
      last checkpoint AND backs the learning rate off.
    - ``preemption``: a `PreemptionHandler` (or True to create+install
      one) — a pending stop checkpoints at the step boundary and
      `fit` returns False (resumable) instead of True (completed).
    - ``step_deadline_s``: arms a `StepWatchdog` around every step.
    - ``async_save``: checkpoint writes happen off the step loop's
      critical path (see CheckpointManager.async_save).
    """

    def __init__(self, net, checkpoint_dir: str,
                 checkpoint_frequency: int = 50, max_restarts: int = 3,
                 fault_injector: Optional[FaultInjector] = None,
                 use_orbax: Optional[bool] = None,
                 guard: Optional[TrainingGuard] = None,
                 preemption=None,
                 step_deadline_s: Optional[float] = None,
                 async_save: bool = False,
                 registry=None):
        self.net = net
        self.manager = CheckpointManager(checkpoint_dir,
                                         use_orbax=use_orbax,
                                         async_save=async_save,
                                         fault_injector=fault_injector,
                                         registry=registry)
        self.checkpoint_frequency = max(1, checkpoint_frequency)
        self.max_restarts = max_restarts
        self.fault_injector = fault_injector
        self.guard = guard
        if guard is not None and hasattr(net, "set_training_guard"):
            net.set_training_guard(guard)
        if preemption is True:
            preemption = PreemptionHandler(registry=registry).install()
        self.preemption: Optional[PreemptionHandler] = preemption
        self.step_deadline_s = step_deadline_s
        self._registry = registry
        self.restarts = 0              # cumulative (reporting)
        self.consecutive_failures = 0  # gates max_restarts
        self.preempted = False

    def _maybe_checkpoint(self) -> None:
        if self.net.iteration_count % self.checkpoint_frequency == 0:
            self.manager.save(self.net)

    def _stop_requested(self) -> bool:
        return (self.preemption is not None
                and self.preemption.stop_requested())

    def _checkpoint_and_yield(self) -> bool:
        """Preemption exit: persist a resumable checkpoint, flush the
        writer, report not-completed."""
        self.preempted = True
        self.manager.save(self.net)
        self.manager.wait()
        log.warning("preemption: checkpointed at iteration %d and "
                    "stopping (resumable — rerun fit to continue)",
                    self.net.iteration_count)
        return False

    def _recover(self, err: RuntimeError) -> None:
        """One failure: count it, restore the last good checkpoint,
        apply LR backoff on divergence rollbacks, or re-raise when the
        consecutive budget is exhausted."""
        self.restarts += 1
        self.consecutive_failures += 1
        if self.consecutive_failures > self.max_restarts:
            raise err
        log.warning(
            "step failed (%s); restoring last checkpoint "
            "(consecutive failure %d/%d, %d total)", err,
            self.consecutive_failures, self.max_restarts, self.restarts)
        if self.manager.restore(self.net) is None:
            log.warning("no checkpoint yet; retrying from current "
                        "params")
        if isinstance(err, DivergenceError) and self.guard is not None:
            self.guard.apply_lr_backoff(self.net)

    def fit(self, iterator, epochs: int = 1) -> bool:
        """Train; True when all epochs completed, False when a
        preemption stop was honored (checkpoint written; call fit
        again to resume — the iteration count continues)."""
        if not self.net._initialized:
            self.net.init()
        self.preempted = False
        restored = self.manager.restore(self.net)
        if restored is not None:
            log.info("resumed from checkpoint step %d", restored)
        watchdog = None
        if self.step_deadline_s is not None:
            watchdog = StepWatchdog(self.step_deadline_s,
                                    registry=self._registry).start()
        try:
            for _ in range(epochs):
                for batch in iterator:
                    feats, labs, fmask, lmask = _unpack_batch(batch)
                    it = self.net.iteration_count
                    if self.fault_injector is not None \
                            and self.fault_injector.check_preempt(it) \
                            and self.preemption is not None:
                        self.preemption.request_stop()
                    if self._stop_requested():
                        return self._checkpoint_and_yield()
                    while True:
                        try:
                            # per-attempt view: a NaN-poisoned batch
                            # must not stay poisoned across the retry
                            # after a rollback restore
                            step_feats = feats
                            if self.fault_injector is not None:
                                self.fault_injector.check(
                                    self.net.iteration_count)
                                if self.fault_injector.check_nan(
                                        self.net.iteration_count):
                                    step_feats = (np.asarray(feats)
                                                  * np.float32("nan"))
                            if watchdog is not None:
                                watchdog.arm(self.net.iteration_count)
                            self.net.fit(step_feats, labs,
                                         lmask if lmask is not None
                                         else fmask)
                            self.consecutive_failures = 0
                            break
                        except RuntimeError as e:
                            self._recover(e)
                        finally:
                            if watchdog is not None:
                                watchdog.disarm()
                    self._maybe_checkpoint()
                if hasattr(iterator, "reset"):
                    iterator.reset()
                if self._stop_requested():
                    return self._checkpoint_and_yield()
        finally:
            if watchdog is not None:
                watchdog.stop()
        self.manager.save(self.net)
        self.manager.wait()
        return True

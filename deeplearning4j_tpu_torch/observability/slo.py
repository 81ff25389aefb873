"""Serving SLO layer: TTFT / TPOT / e2e / queue-age / goodput.

Production LLM serving is judged on time-to-first-token and
inter-token latency under load (PAPERS.md: Orca-style continuous
batching), not on aggregate tokens/sec — a pool that streams 10k tok/s
while one request waits 30 s for its first token is failing its SLO.
`SLOTracker` derives the per-request numbers from the flight
recorder's traces (observability/events.py) and publishes them twice:

- as registry histograms with serving-appropriate buckets, so an
  external scraper gets the full distributions
  (``serving_ttft_seconds``, ``serving_tpot_seconds``,
  ``serving_e2e_seconds``, ``serving_queue_age_seconds``,
  ``serving_slo_requests_total{outcome}``, ``serving_goodput_ratio``);
- as a windowed `report()` dict (p50/p95/p99 over the last N terminal
  requests) — the `/slo` endpoint's body and the `engine_slo`
  benchmark's output.

Definitions (all from monotonic trace timestamps):

- **TTFT**: submit → first generated token committed (continuous mode:
  the admission prefill's sampled token; batch mode: the first decode
  chunk — both modes record it, so batch-mode TTFT is honest too).
- **TPOT** (inter-token latency): (t_last_token − t_first_token) /
  (n_generated − 1); undefined for single-token requests.
- **e2e**: submit → terminal event (finished/shed/quarantined).
- **queue-age**: wait before (re-)admission — last ``admitted`` minus
  the later of ``submit`` and the last ``preempted`` (a reload-
  preempted request re-queues; its second wait is a real wait).
- **goodput**: fraction of terminal requests that FINISHED within
  their deadline (no deadline = within). ``late`` = completed partial
  past deadline; ``shed``/``quarantined`` are never good.

Stdlib-only, like the rest of observability/. `NULL_SLO` mirrors
`NULL_REGISTRY`/`NULL_RECORDER`: disable by injection.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.observability.events import RequestTrace
from deeplearning4j_tpu_torch.observability.metrics import (
    DECODE_LATENCY_BUCKETS, default_registry)

#: Inter-token latency buckets (seconds): a decode chunk amortizes one
#: compiled call over `chunk` tokens, so per-token cadence sits well
#: below DECODE_LATENCY_BUCKETS' compiled-call range — these reach
#: down to 0.1 ms while keeping a multi-second overload tail.
TPOT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

_OUTCOMES = ("ok", "late", "shed", "quarantined")


def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1,
            int(round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class SLOTracker:
    """Per-request SLO accounting over flight-recorder traces.

    The engine calls `admitted(trace)` when a request is seated,
    `first_token(trace, ts)` when its first generated token commits,
    and `finished(trace)` at the terminal transition; everything else
    (timestamps, token counts, outcome) is derived from the trace so
    the tracker stays decoupled from engine internals.

    ``prefix`` names the metric families: the default ``"serving"``
    keeps the engine series; a fleet router passes
    ``"serving_fleet"`` so its STITCHED-trace rollup (TTFT
    and e2e that include router queue time and cross-tier handoff
    time) publishes as ``serving_fleet_ttft_seconds`` etc. without
    colliding with the per-replica engine series it federates."""

    def __init__(self, registry=None, window: int = 512,
                 prefix: str = "serving"):
        reg = registry if registry is not None else default_registry()
        self._ttft = reg.histogram(
            f"{prefix}_ttft_seconds",
            "Submit to first generated token (time-to-first-token)",
            buckets=DECODE_LATENCY_BUCKETS)
        self._tpot = reg.histogram(
            f"{prefix}_tpot_seconds",
            "Inter-token latency: decode span / (tokens - 1)",
            buckets=TPOT_BUCKETS)
        self._e2e = reg.histogram(
            f"{prefix}_e2e_seconds",
            "Submit to terminal event (end-to-end request latency)",
            buckets=DECODE_LATENCY_BUCKETS)
        self._qage = reg.histogram(
            f"{prefix}_queue_age_seconds",
            "Wait between enqueue (submit or preemption) and admission"
            if prefix == "serving" else
            "Router-queue wait between (re-)enqueue and dispatch",
            buckets=DECODE_LATENCY_BUCKETS)
        self._outcomes = reg.counter(
            f"{prefix}_slo_requests",
            "Terminal requests by SLO outcome", labelnames=("outcome",))
        self._outcome_cells = {o: self._outcomes.labels(o)
                               for o in _OUTCOMES}
        reg.gauge(
            f"{prefix}_goodput_ratio",
            "Fraction of windowed terminal requests finished within "
            "deadline (1.0 when the window is empty)"
        ).set_function(self.goodput)
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=int(window))

    # -- engine-side hooks ---------------------------------------------
    def admitted(self, trace: RequestTrace) -> None:
        t_adm = trace.last_ts("admitted")
        if t_adm is None:
            return
        t_from = trace.first_ts("submit")
        t_pre = trace.last_ts("preempted")
        if t_pre is not None and (t_from is None or t_pre > t_from):
            t_from = t_pre
        if t_from is not None:
            self._qage.observe(max(0.0, t_adm - t_from))

    def first_token(self, trace: RequestTrace, ts: float) -> None:
        t_sub = trace.first_ts("submit")
        if t_sub is not None:
            self._ttft.observe(max(0.0, ts - t_sub))

    def finished(self, trace: RequestTrace) -> None:
        """Terminal accounting; expects the terminal event (finished /
        shed / quarantined) to already be the trace's last event."""
        evs = trace.events
        if not evs:
            return
        term = evs[-1]
        t_sub = trace.first_ts("submit")
        rec = {"rid": trace.rid, "outcome": self._outcome(term),
               "e2e": None, "ttft": None, "tpot": None,
               "queue_age": None}
        if t_sub is not None:
            rec["e2e"] = max(0.0, term.ts - t_sub)
            self._e2e.observe(rec["e2e"])
        tok_evs = [e for e in evs
                   if e.kind in ("prefill_done", "decode_chunk")
                   and e.data.get("tokens")]
        if tok_evs and t_sub is not None:
            rec["ttft"] = max(0.0, tok_evs[0].ts - t_sub)
        n_tok = sum(int(e.data["tokens"]) for e in tok_evs)
        if n_tok > 1:
            span = tok_evs[-1].ts - tok_evs[0].ts
            rec["tpot"] = max(0.0, span / (n_tok - 1))
            self._tpot.observe(rec["tpot"])
        t_adm = trace.first_ts("admitted")
        if t_adm is not None and t_sub is not None:
            rec["queue_age"] = max(0.0, t_adm - t_sub)
        self._outcome_cells[rec["outcome"]].inc()
        with self._lock:
            self._window.append(rec)

    @staticmethod
    def _outcome(term) -> str:
        if term.kind == "finished":
            return "late" if term.data.get("partial") else "ok"
        if term.kind == "shed":
            return "shed"
        return "quarantined"

    # -- read side -----------------------------------------------------
    def goodput(self) -> float:
        with self._lock:
            recs = list(self._window)
        if not recs:
            return 1.0
        return sum(r["outcome"] == "ok" for r in recs) / len(recs)

    def report(self) -> Dict[str, object]:
        """Windowed SLO report over the last ``window`` terminal
        requests: flat p50/p95/p99 milliseconds per dimension, goodput,
        and outcome counts — the `/slo` endpoint body."""
        with self._lock:
            recs = list(self._window)
        out: Dict[str, object] = {
            "window": len(recs),
            "goodput": (sum(r["outcome"] == "ok" for r in recs)
                        / len(recs)) if recs else 1.0,
            "outcomes": {o: sum(r["outcome"] == o for r in recs)
                         for o in _OUTCOMES},
        }
        for dim in ("ttft", "tpot", "e2e", "queue_age"):
            vals = sorted(r[dim] for r in recs if r[dim] is not None)
            for q in (50, 95, 99):
                v = _pct(vals, q)
                out[f"{dim}_p{q}_ms"] = (round(v * 1e3, 3)
                                         if v is not None else None)
        return out


class NullSLOTracker:
    """No-op SLO tracker (injection-disable, mirroring NULL_REGISTRY)."""

    def admitted(self, trace) -> None:
        pass

    def first_token(self, trace, ts) -> None:
        pass

    def finished(self, trace) -> None:
        pass

    def goodput(self) -> float:
        return 1.0

    def report(self) -> dict:
        return {}


NULL_SLO = NullSLOTracker()

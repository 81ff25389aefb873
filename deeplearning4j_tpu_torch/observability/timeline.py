"""Chrome/Perfetto ``trace_event`` export of the flight recorder.

`timeline_json(recorder)` turns the engine's recent lifecycle events
into the Trace Event JSON any chrome://tracing / https://ui.perfetto.dev
build renders: one lane (``tid``) per continuous-batching slot plus a
**queue lane**, so a slot-pool schedule gap — a slot idle while the
queue is non-empty, a long request pinning a lane, a preemption storm
after a weight reload — is *visible* instead of inferred from
histograms. This is the `/timeline.json` endpoint's body.

Mapping (the JSON object format: ``{"traceEvents": [...]}``):

- lane ``queue``: one complete event (``ph:"X"``) per wait — submit →
  admitted, and preempted → re-admitted (reload requeues).
- lane ``slot <i>``: one complete event per residency — admitted on
  slot *i* → the request's next preempted/terminal event; decode
  chunks and prefill completions ride as instant events (``ph:"i"``)
  with their token counts in ``args``; retries likewise.
- lanes ``scratch`` / ``pool``: solo-isolation re-runs and batch-mode
  residencies (batch mode has no slots — the whole batch is one lane).
- ``ph:"M"`` metadata names every lane (``thread_name``) and orders
  them (``thread_sort_index``: queue first, then slots).

Timestamps are the recorder's monotonic perf_counter values re-based
to the first exported event and scaled to microseconds (the
trace_event unit). Stdlib-only.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Union

from deeplearning4j_tpu_torch.observability.events import (
    Event, FlightRecorder, TERMINAL_KINDS)

_PID = 0
_QUEUE_TID = 0


def _lane_of(ev: Event, num_slots: int) -> int:
    """tid for the residency an ``admitted`` event starts."""
    if ev.data.get("scratch"):
        return num_slots + 1
    slot = ev.data.get("slot")
    if slot is None:                       # batch mode: one shared lane
        return num_slots + 2
    return int(slot) + 1


def trace_events(events: Iterable[Event],
                 num_slots: Optional[int] = None,
                 pid: int = _PID,
                 process_name: str = "serving engine",
                 base: Optional[float] = None) -> List[dict]:
    """Render lifecycle events as a ``traceEvents`` list. ``events``
    must be in chronological order (the recorder's ring is).

    ``pid``/``process_name``/``base`` exist for the FLEET timeline
    (observability/stitch.py): each replica renders as its
    own process lane group, and every group re-bases to one shared
    fleet-wide t=0 so the lanes align in Perfetto."""
    evs = [e for e in events]
    out: List[dict] = []
    if num_slots is None:
        num_slots = 1 + max(
            [int(e.data["slot"]) for e in evs
             if e.data.get("slot") is not None and not e.data.get(
                 "scratch")] or [-1])
    if base is None:
        base = evs[0].ts if evs else 0.0
    us = lambda t: round((t - base) * 1e6, 3)      # noqa: E731

    lanes: Dict[int, str] = {_QUEUE_TID: "queue"}
    for s in range(num_slots):
        lanes[s + 1] = f"slot {s}"

    # per-request open spans: rid -> (start_ts, tid, phase)
    open_span: Dict[int, tuple] = {}

    def close(rid: int, end_ts: float, status: str) -> None:
        start_ts, tid, phase = open_span.pop(rid)
        out.append({"name": f"r{rid} {phase}", "ph": "X", "pid": pid,
                    "tid": tid, "ts": us(start_ts),
                    "dur": max(0.0, round((end_ts - start_ts) * 1e6,
                                          3)),
                    "args": {"rid": rid, "status": status}})

    for ev in evs:
        rid = ev.rid
        if ev.kind == "submit":
            open_span[rid] = (ev.ts, _QUEUE_TID, "wait")
        elif ev.kind == "admitted":
            if rid in open_span:
                close(rid, ev.ts, "admitted")
            tid = _lane_of(ev, num_slots)
            if tid == num_slots + 1:
                lanes.setdefault(tid, "scratch")
            elif tid == num_slots + 2:
                lanes.setdefault(tid, "pool")
            open_span[rid] = (ev.ts, tid, "decode")
        elif ev.kind == "preempted":
            if rid in open_span:
                close(rid, ev.ts, "preempted")
            open_span[rid] = (ev.ts, _QUEUE_TID, "wait")
        elif ev.kind in TERMINAL_KINDS:
            if rid in open_span:
                close(rid, ev.ts, ev.kind)
        elif ev.kind in ("prefill_done", "decode_chunk", "retry",
                         "queued"):
            tid = (open_span[rid][1] if rid in open_span
                   else _QUEUE_TID)
            out.append({"name": f"{ev.kind} r{rid}", "ph": "i",
                        "pid": pid, "tid": tid, "ts": us(ev.ts),
                        "s": "t", "args": {"rid": rid, **ev.data}})

    # still-running requests: close their span at the last known time
    if evs:
        for rid in list(open_span):
            close(rid, evs[-1].ts, "running")

    meta: List[dict] = [{"name": "process_name", "ph": "M",
                         "pid": pid, "tid": 0,
                         "args": {"name": process_name}},
                        {"name": "process_sort_index", "ph": "M",
                         "pid": pid, "tid": 0,
                         "args": {"sort_index": pid}}]
    for tid in sorted(lanes):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": lanes[tid]}})
        meta.append({"name": "thread_sort_index", "ph": "M",
                     "pid": pid, "tid": tid,
                     "args": {"sort_index": tid}})
    return meta + out


def timeline_json(source: Union[FlightRecorder, Iterable[Event]],
                  num_slots: Optional[int] = None,
                  n: Optional[int] = None) -> dict:
    """The Trace Event JSON *object* form Perfetto/chrome://tracing
    load directly. ``source`` is a FlightRecorder (its last ``n`` ring
    events) or any chronological Event iterable."""
    events = (source.recent(n) if hasattr(source, "recent")
              else list(source))
    return {"traceEvents": trace_events(events, num_slots=num_slots),
            "displayTimeUnit": "ms"}

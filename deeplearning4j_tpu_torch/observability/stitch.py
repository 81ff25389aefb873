"""Distributed-trace stitching: ONE timeline per fleet request.

A fleet request's lifecycle is scattered across N process-local flight
recorders: the router records ``submit → queued → dispatched →
handoff/failover → finished`` in ITS ring, while every replica that
served a hop recorded ``submit → admitted → prefill_done →
decode_chunk* → finished`` in its OWN ring, on its OWN
``perf_counter`` clock. This module reassembles them:

- `stitch()` merges the router-side trace with the per-hop replica
  traces the router captured (`serving/fleet.py` ships a subprocess
  replica's completed trace back over the pipe; an in-process
  replica's is read by reference), aligning replica timestamps into
  the router's clock domain via each replica's probe-RTT-midpoint
  ``clock_offset`` and producing a `StitchedTrace`: one chronological
  event list plus derived SPANS — ``queue`` waits, per-hop
  ``hop``/``prefill``/``decode`` spans, and cross-tier ``handoff``
  spans. A kill-mid-decode failover shows both hops (and the
  re-prefill) in the same trace.
- `StitchedTrace` duck-types the `RequestTrace` read surface
  (``events`` / ``first_ts`` / ``last_ts`` / ``complete``), so the
  fleet-level `SLOTracker` consumes it directly — fleet TTFT and e2e
  finally include router queue time and handoff time.
- `router_lane_events()` + `fleet_timeline_json()` render the
  fleet-wide Perfetto export: the router's queue/dispatch lanes as one
  process group, each replica's slot lanes as its own process group
  (named ``<tier>/replica <id>``), every group re-based to one shared
  t=0.

Clock-alignment caveat: a subprocess replica's offset is estimated as
the midpoint of a ping's send/receive ``perf_counter`` pair (the NTP
idea, min-RTT sample wins), so aligned timestamps carry up to ±RTT/2
of error. `stitch()` therefore CLAMPS each hop's events to start no
earlier than its ``dispatched`` event and to end no later than the
router-side terminal event — the stitched trace is monotonically
consistent by construction, at the cost of up to RTT/2 of distortion
at hop edges. In-process replicas share the router's clock
(offset 0) and are exact. Stdlib-only.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional

from deeplearning4j_tpu_torch.observability.events import (
    Event, TERMINAL_KINDS)
from deeplearning4j_tpu_torch.observability.timeline import \
    trace_events

log = logging.getLogger("deeplearning4j_tpu_torch")

#: span vocabulary a stitched trace can derive (docs/observability.md)
SPAN_NAMES = ("queue", "hop", "prefill", "decode", "handoff")


def _as_event(e) -> Event:
    """Accept Event tuples or their `as_dict` form (pipe-shipped)."""
    if isinstance(e, Event):
        return e
    d = dict(e)
    return Event(float(d.pop("ts", 0.0)), str(d.pop("kind", "shed")),
                 int(d.pop("rid", 0)), d)


class StitchedTrace:
    """One fleet request's merged router+replica timeline plus the
    spans derived from it. Read surface mirrors `RequestTrace` so the
    SLO layer can consume either."""

    __slots__ = ("rid", "_events", "spans", "hops")

    def __init__(self, rid: int, events: List[Event],
                 spans: List[dict], hops: List[dict]):
        self.rid = int(rid)
        self._events = tuple(events)
        self.spans = spans
        self.hops = hops

    @property
    def events(self):
        return self._events

    def kinds(self) -> List[str]:
        return [e.kind for e in self._events]

    def first_ts(self, kind: str) -> Optional[float]:
        for e in self._events:
            if e.kind == kind:
                return e.ts
        return None

    def last_ts(self, kind: str) -> Optional[float]:
        ts = None
        for e in self._events:
            if e.kind == kind:
                ts = e.ts
        return ts

    def complete(self) -> bool:
        return bool(self._events) and \
            self._events[-1].kind in TERMINAL_KINDS

    def span(self, name: str) -> List[dict]:
        return [s for s in self.spans if s["name"] == name]

    def as_dicts(self) -> List[dict]:
        return [e.as_dict() for e in self._events]

    def to_dict(self) -> dict:
        """The `/debugz` / `Router.distributed_trace` JSON body."""
        return {"rid": self.rid,
                "events": self.as_dicts(),
                "spans": list(self.spans),
                "hops": [{k: v for k, v in h.items() if k != "events"}
                         for h in self.hops]}

    def __len__(self) -> int:
        return len(self._events)


def stitch(rid: int, router_events: Iterable[Event],
           hops: Iterable[dict]) -> StitchedTrace:
    """Merge one fleet request's router trace with its captured hops.

    ``hops`` entries are the router's hop records::

        {"hop": int, "replica": int, "tier": str, "kind": str,
         "phase": "prefill"|"decode"|"serving", "hedge": bool,
         "status": str, "clock_offset": float,
         "dispatched_ts": float|None, "events": [Event|dict, ...]}

    Replica event timestamps are aligned (``ts - clock_offset``),
    clamped to the hop's ``dispatched`` moment on the left and the
    router-side terminal event on the right (see module docstring),
    then merged with the router events into one chronological list.
    """
    r_evs = sorted((_as_event(e) for e in router_events),
                   key=lambda e: e.ts)
    term_ts = None
    for e in reversed(r_evs):
        if e.kind in TERMINAL_KINDS:
            term_ts = e.ts
            break
    merged: List[Event] = [
        Event(e.ts, e.kind, e.rid, {**e.data, "src": "router"})
        for e in r_evs]
    spans: List[dict] = []
    out_hops: List[dict] = []
    hop_close: Dict[int, float] = {}       # replica -> last lost-hop t1

    for h in sorted(hops, key=lambda d: int(d.get("hop", 0) or 0)):
        off = float(h.get("clock_offset") or 0.0)
        raw = sorted((_as_event(e) for e in (h.get("events") or ())),
                     key=lambda e: e.ts)
        d_ts = h.get("dispatched_ts")
        # one pass: clock alignment, then clamp-shift right so the
        # hop can't start before its dispatch (midpoint clock error —
        # shifting the whole hop keeps its internal deltas exact),
        # then clamp left of the router-side terminal
        shift = -off
        if raw and d_ts is not None and raw[0].ts + shift < d_ts:
            shift = d_ts - raw[0].ts
        evs = [Event(e.ts + shift if term_ts is None
                     else min(e.ts + shift, term_ts),
                     e.kind, e.rid, e.data)
               for e in raw]
        meta = {k: h.get(k) for k in ("hop", "replica", "tier",
                                      "phase", "kind", "status",
                                      "hedge")}
        t0 = d_ts if d_ts is not None else (evs[0].ts if evs else None)
        t1 = max([e.ts for e in evs] + ([t0] if t0 is not None else []),
                 default=None)
        out_hops.append({**meta, "t0": t0, "t1": t1,
                         "n_events": len(evs)})
        if h.get("status") == "lost" and t1 is not None:
            hop_close[int(h.get("replica", -1))] = t1
        anchor = {k: meta[k] for k in ("hop", "replica", "tier",
                                       "phase")}
        if t0 is not None:
            spans.append({"name": "hop", **anchor, "t0": t0,
                          "t1": max(t0, t1)})
        pf = next((e for e in evs if e.kind == "prefill_done"), None)
        if pf is not None and t0 is not None:
            spans.append({"name": "prefill", **anchor, "t0": t0,
                          "t1": max(t0, pf.ts)})
        toks = [e for e in evs
                if e.kind in ("prefill_done", "decode_chunk")
                and e.data.get("tokens")]
        if toks and meta.get("phase") != "prefill":
            dt0 = pf.ts if pf is not None else (
                t0 if t0 is not None else toks[0].ts)
            spans.append({"name": "decode", **anchor, "t0": dt0,
                          "t1": max(dt0, toks[-1].ts)})
        merged.extend(
            Event(e.ts, e.kind, e.rid,
                  {**e.data, "src": "replica",
                   "replica": meta["replica"], "tier": meta["tier"],
                   "hop": meta["hop"]})
            for e in evs)

    # router-side spans: queue waits (submit→dispatch, handoff→dispatch,
    # replica-loss→re-dispatch) and the handoff export itself
    mark = next((e.ts for e in r_evs if e.kind == "submit"), None)
    for e in r_evs:
        if e.kind == "dispatched":
            if mark is not None:
                spans.append({"name": "queue", "t0": mark,
                              "t1": max(mark, e.ts)})
            mark = None
        elif e.kind == "handoff":
            sec = float(e.data.get("seconds") or 0.0)
            spans.append({"name": "handoff",
                          "from": e.data.get("from"),
                          "outcome": e.data.get("outcome"),
                          "tier": "prefill",
                          "t0": e.ts - sec, "t1": e.ts})
            mark = e.ts
        elif e.kind == "failover":
            # the wait began when the lost replica stopped progressing;
            # its captured hop's last event is the best estimate we have
            lost_t1 = hop_close.get(int(e.data.get("from", -1)))
            mark = min(lost_t1, e.ts) if lost_t1 is not None else e.ts

    # terminal-last tiebreak: clamped replica events sharing the
    # terminal's timestamp must sort BEFORE it, so `complete()` (and
    # the SLO outcome derivation) always sees the terminal event last
    merged.sort(key=lambda e: (
        e.ts, 1 if (e.kind in TERMINAL_KINDS
                    and e.data.get("src") == "router") else 0))
    spans.sort(key=lambda s: (s["t0"], s["t1"]))
    return StitchedTrace(rid, merged, spans, out_hops)


# ---------------------------------------------------------------------------
# fleet-wide Perfetto export
# ---------------------------------------------------------------------------

_ROUTER_QUEUE_TID = 0


def router_lane_events(events: Iterable[Event], pid: int = 0,
                       base: Optional[float] = None,
                       process_name: str = "fleet router"
                       ) -> List[dict]:
    """Render ROUTER-side lifecycle events as trace_event lanes: a
    queue lane of wait spans plus one lane per replica holding each
    request's dispatch-to-resolution span, with
    failover/hedge/handoff/autoscale instants marked. The router
    vocabulary differs from the engine's (no slots), hence the
    dedicated renderer."""
    evs = sorted((_as_event(e) for e in events), key=lambda e: e.ts)
    if base is None:
        base = evs[0].ts if evs else 0.0
    us = lambda t: round((t - base) * 1e6, 3)      # noqa: E731
    lanes: Dict[int, str] = {_ROUTER_QUEUE_TID: "queue"}
    open_span: Dict[int, tuple] = {}
    out: List[dict] = []

    def close(rid: int, end_ts: float, status: str) -> None:
        t0, tid, label = open_span.pop(rid)
        out.append({"name": label, "ph": "X", "pid": pid, "tid": tid,
                    "ts": us(t0),
                    "dur": max(0.0, round((end_ts - t0) * 1e6, 3)),
                    "args": {"rid": rid, "status": status}})

    for e in evs:
        rid = e.rid
        if e.kind == "submit":
            open_span[rid] = (e.ts, _ROUTER_QUEUE_TID, f"r{rid} wait")
        elif e.kind == "dispatched":
            if rid in open_span:
                close(rid, e.ts, "dispatched")
            rep = int(e.data.get("replica", -1))
            tid = rep + 1
            lanes.setdefault(tid, f"replica {rep}")
            hop = e.data.get("hop")
            open_span[rid] = (
                e.ts, tid,
                f"r{rid} hop{'' if hop is None else ' ' + str(hop)}")
        elif e.kind == "handoff":
            if rid in open_span:
                close(rid, e.ts, f"handoff_{e.data.get('outcome')}")
            out.append({"name": f"handoff r{rid}", "ph": "i",
                        "pid": pid, "tid": _ROUTER_QUEUE_TID,
                        "ts": us(e.ts), "s": "t",
                        "args": {"rid": rid, **e.data}})
            open_span[rid] = (e.ts, _ROUTER_QUEUE_TID, f"r{rid} wait")
        elif e.kind in ("failover", "hedge", "autoscale", "queued"):
            tid = (open_span[rid][1] if rid in open_span
                   else _ROUTER_QUEUE_TID)
            out.append({"name": f"{e.kind} r{rid}", "ph": "i",
                        "pid": pid, "tid": tid, "ts": us(e.ts),
                        "s": "t", "args": {"rid": rid, **e.data}})
        elif e.kind in TERMINAL_KINDS:
            if rid in open_span:
                close(rid, e.ts, e.kind)
    if evs:
        for rid in list(open_span):
            close(rid, evs[-1].ts, "running")

    meta: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": process_name}},
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


def fleet_timeline_json(groups: List[dict]) -> dict:
    """The fleet-wide Perfetto export: one process lane group per
    entry in ``groups``, all re-based to one shared t=0.

    Each group::

        {"pid": int, "name": str, "events": [Event, ...],
         "router": bool,            # router vocabulary vs engine's
         "num_slots": int|None}     # engine groups: slot-lane count
    """
    all_ts = [e.ts for g in groups for e in g.get("events", ())]
    if not all_ts:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(all_ts)
    out: List[dict] = []
    for g in groups:
        evs = g.get("events") or ()
        if not evs:
            continue
        if g.get("router"):
            out.extend(router_lane_events(
                evs, pid=int(g.get("pid", 0)), base=base,
                process_name=g.get("name", "fleet router")))
        else:
            out.extend(trace_events(
                list(evs), num_slots=g.get("num_slots"),
                pid=int(g.get("pid", 0)),
                process_name=g.get("name", "replica"), base=base))
    return {"traceEvents": out, "displayTimeUnit": "ms"}

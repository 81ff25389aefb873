"""Port parity: the host-only observability modules against JAX's.

Every host-only module of deeplearning4j_tpu_torch/observability/ is a
copy of the reference's (apart from imports), so each scenario drives
the same sequence of calls on the reference's objects and on the port's
and compares what comes out: the Prometheus text and the JSON snapshot
(byte for byte), `FlightRecorder.recent`, `SLOTracker.report` (with an
injected clock), `timeline_json`, `stitch` / `fleet_timeline_json`, and
`merge_snapshots` / `check_cardinality`. Errors must be the same type
with the same message. `tracing.span` is the port's own: its names must
reach a CPU torch.profiler trace as record_function events, and its
span stack must unwind on an exception.
"""
import importlib
import json

import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu.observability import events as jev  # noqa: E402
from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.observability import federation as jfed  # noqa
from deeplearning4j_tpu.observability import metrics as jme  # noqa: E402
from deeplearning4j_tpu.observability import slo as jslo  # noqa: E402
from deeplearning4j_tpu.observability import timeline as jtl  # noqa: E402

from deeplearning4j_tpu_torch.observability import events as tev  # noqa
from deeplearning4j_tpu_torch.observability import export as tex  # noqa
from deeplearning4j_tpu_torch.observability import federation as tfed  # noqa
from deeplearning4j_tpu_torch.observability import metrics as tme  # noqa
from deeplearning4j_tpu_torch.observability import slo as tslo  # noqa
from deeplearning4j_tpu_torch.observability import timeline as ttl  # noqa
from deeplearning4j_tpu_torch.observability import tracing  # noqa: E402

# the packages export a function named `stitch`, which shadows the module
jst = importlib.import_module("deeplearning4j_tpu.observability.stitch")
tst = importlib.import_module("deeplearning4j_tpu_torch.observability.stitch")

JAX_SIDE = dict(me=jme, ex=jex, ev=jev, slo=jslo, tl=jtl, st=jst, fed=jfed)
PORT_SIDE = dict(me=tme, ex=tex, ev=tev, slo=tslo, tl=ttl, st=tst, fed=tfed)


def _both(fn):
    """fn(side) on the reference's modules and on the port's; an
    exception is part of the result (its type name and message)."""
    out = []
    for side in (JAX_SIDE, PORT_SIDE):
        try:
            out.append(("ok", fn(side)))
        except Exception as e:          # compared, never swallowed
            out.append(("raise", type(e).__name__, str(e)))
    return out


# ---------------------------------------------------------------------------
# metrics + export
# ---------------------------------------------------------------------------

def _serving_like(s):
    r = s["me"].MetricsRegistry()
    c = r.counter("serving_requests_completed", "Requests fully decoded")
    c.inc()
    c.inc(2.5)
    shed = r.counter("serving_requests_shed", "by reason",
                     labelnames=("reason",))
    shed.labels("overload").inc(3)
    shed.labels(reason="deadline")
    g = r.gauge("serving_queue_depth", "depth")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    r.gauge("serving_kv_pool_bytes", "bytes").set_function(lambda: 1 << 40)
    h = r.histogram("serving_decode_step_seconds", "step",
                    buckets=s["me"].DECODE_LATENCY_BUCKETS)
    for v in (0.0, 0.001, 0.0011, 0.5, 0.5, 7.0, 1e9):
        h.observe(v)
    lh = r.histogram("serving_ttft_seconds", "ttft", labelnames=("tenant",),
                     buckets=(0.1, 0.01, 1.0))
    lh.labels("a").observe(0.05)
    lh.labels("b").observe(2.0)
    # re-requesting a family with the same shape is idempotent
    assert r.counter("serving_requests_completed") is c
    return r


def _escapes(s):
    r = s["me"].MetricsRegistry()
    r.counter("x_total", 'help with \\ backslash\nand a newline',
              labelnames=("tenant",)).labels('quo"te\\slash\nnl').inc()
    r.gauge("y", "", labelnames=("a", "b")).labels(1, "2").set(float("inf"))
    r.gauge("z", "nan").set(float("nan"))
    r.gauge("w", "neg").set(-0.25)
    r.counter("big").inc(1e16)
    return r


def _errors(s):
    r = s["me"].MetricsRegistry()
    r.counter("dup", labelnames=("a",))
    errs = []
    for fn in (lambda: r.gauge("dup", labelnames=("a",)),
               lambda: r.counter("dup", labelnames=("b",)),
               lambda: r.counter("bad-name"),
               lambda: r.counter("ok", labelnames=("bad-label",)),
               lambda: r.counter("pos").inc(-1),
               lambda: r.get("dup").labels(),
               lambda: r.get("dup").labels(1, a=2),
               lambda: r.get("dup").labels(b=1),
               lambda: r.get("dup").inc(),
               lambda: r.histogram("h", buckets=())):
        try:
            fn()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    r.gauge("errors", "").set(len([e for e in errs if e]))
    return r, errs


def _null(s):
    n = s["me"].NULL_REGISTRY
    n.counter("a").labels("x").inc(5)
    n.gauge("b").set_function(lambda: 1)
    with n.histogram("c").time():
        pass
    assert n.get("a") is None and n.collect() == []
    return n


METRIC_SCRIPTS = {"serving_like": _serving_like, "escapes": _escapes,
                  "errors": lambda s: _errors(s)[0], "null": _null}


@pytest.mark.parametrize("name", sorted(METRIC_SCRIPTS))
def test_exposition_byte_equal(name):
    """The port's prometheus_text, json_snapshot and the snapshot's own
    text rendering equal the reference's byte for byte."""
    script = METRIC_SCRIPTS[name]

    def render(s):
        r = script(s)
        snap = s["ex"].json_snapshot(r)
        return (s["ex"].prometheus_text(r), json.dumps(snap, sort_keys=True),
                s["ex"].snapshot_prometheus_text(snap))

    got = _both(render)
    assert got[0][0] == "ok", got[0]
    assert got[1] == got[0]


def test_registry_errors_match():
    got = _both(lambda s: _errors(s)[1])
    assert got[0][0] == "ok" and sum(e is not None for e in got[0][1]) == 10
    assert got[1] == got[0]


@pytest.mark.parametrize("res", [lambda: {"ready": False, "q": 1},
                                 lambda: {"q": 2}, lambda: 0, lambda: 1,
                                 None, lambda: 1 / 0])
def test_probe_response_matches(res):
    assert tex.probe_response(res) == jex.probe_response(res)


# ---------------------------------------------------------------------------
# events, slo, timeline
# ---------------------------------------------------------------------------

class _Clock:
    """A deterministic clock: each read advances by ``step``."""

    def __init__(self, t0=100.0, step=0.001):
        self.t = t0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _lifecycle(s, capacity=4096, ctx=None, slots=3):
    """A small serving history on a recorder with an injected clock:
    completed, shed, quarantined and still-running requests on three
    slots, with a preemption, retries and chunk events."""
    rec = s["ev"].FlightRecorder(capacity=capacity, clock=_Clock())
    slo = s["slo"].SLOTracker(registry=s["me"].MetricsRegistry(), window=8)
    traces = {}
    for rid in range(1, 7):
        tr = rec.start_trace(rid, ctx=ctx)
        traces[rid] = tr
        tr.add("submit", prompt_tokens=10 + rid, max_new_tokens=8,
               deadline_s=None, **({"tenant": "t%d" % (rid % 2)}
                                   if rid % 3 else {}))
        tr.add("queued", depth=rid)
    for rid in (1, 2, 3, 4):
        tr = traces[rid]
        tr.add("admitted", slot=(rid - 1) % slots, bucket=16,
               prefix_hit_tokens=0)
        slo.admitted(tr)
        ev = tr.add("prefill_done", tokens=1, slot=(rid - 1) % slots)
        slo.first_token(tr, ev.ts)
    traces[2].add("retry", step=3, attempt=1, prefill=False)
    traces[3].add("preempted", reason="reload")
    traces[3].add("admitted", slot=0, bucket=32, prefix_hit_tokens=4)
    slo.admitted(traces[3])
    for rid in (1, 2, 3):
        for _ in range(2):
            traces[rid].add("decode_chunk", tokens=4, slot=rid - 1,
                            drafted=3, accepted=rid % 3)
    traces[2].add("draft_rejected", step=5, drafted=3, poisoned=False)
    traces[1].add("constraint", terminal=True, state=2)
    traces[1].add("finished", tokens=9, partial=False, cost_flops=1.5)
    traces[2].add("finished", tokens=9, partial=True)
    traces[5].add("shed", reason="overload")
    traces[3].add("quarantined")
    for rid in (1, 2, 5, 3):
        slo.finished(traces[rid])
    rec.record("qos", rid=0, action="degrade", level=1, step="spec_off")
    return rec, slo, traces


@pytest.mark.parametrize("case", ["plain", "ring_overflow", "ctx"])
def test_flight_recorder_recent(case):
    kw = {"plain": {}, "ring_overflow": {"capacity": 7},
          "ctx": {"ctx": {"fleet_rid": 9, "hop": 1, "tier": "decode"}}}[case]

    def run(s):
        rec, _, traces = _lifecycle(s, **kw)
        views = [rec.recent(), rec.recent(5), rec.recent(kind="admitted"),
                 rec.recent(rid=3), rec.recent(2, kind="decode_chunk",
                                               rid=2)]
        return ([[e.as_dict() for e in v] for v in views], len(rec),
                {rid: (t.kinds(), t.complete(), t.first_ts("admitted"),
                       t.last_ts("admitted"), t.as_dicts())
                 for rid, t in traces.items()})

    got = _both(run)
    assert got[0][0] == "ok"
    assert got[1] == got[0]


def test_unknown_event_kind_raises_the_same():
    def run(s):
        rec = s["ev"].FlightRecorder(capacity=4, clock=_Clock())
        return rec.start_trace(1).add("not_a_kind")

    got = _both(run)
    assert got[0][0] == "raise" and got[1] == got[0]
    assert tev.EVENT_KINDS == jev.EVENT_KINDS
    assert tev.TERMINAL_KINDS == jev.TERMINAL_KINDS
    assert tev.NULL_RECORDER.start_trace(1).add("x").kind == "shed"


def test_slo_report_and_series():
    def run(s):
        reg = s["me"].MetricsRegistry()
        rec, _, traces = _lifecycle(s)
        slo = s["slo"].SLOTracker(registry=reg, window=3)
        for tr in traces.values():
            slo.admitted(tr)
            ts = tr.first_ts("prefill_done")
            if ts is not None:
                slo.first_token(tr, ts)
            slo.finished(tr)
        return slo.report(), slo.goodput(), s["ex"].prometheus_text(reg)

    got = _both(run)
    assert got[0][0] == "ok"
    assert got[1] == got[0]
    assert tslo.NULL_SLO.report() == jslo.NULL_SLO.report() == {}


@pytest.mark.parametrize("slots,n", [(3, None), (None, None), (3, 9)])
def test_timeline_json(slots, n):
    def run(s):
        rec, _, _ = _lifecycle(s)
        return s["tl"].timeline_json(rec, num_slots=slots, n=n)

    got = _both(run)
    assert got[0][0] == "ok" and got[0][1]["traceEvents"]
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# stitch, federation
# ---------------------------------------------------------------------------

def _fleet(s):
    Event = s["ev"].Event
    t = 1000.0
    router = [Event(t, "submit", 7, {}), Event(t + 0.001, "queued", 7, {}),
              Event(t + 0.010, "dispatched", 7,
                    {"replica": 3, "hop": 0, "tier": "prefill"}),
              Event(t + 0.200, "handoff", 7,
                    {"from": 3, "tokens": 12, "outcome": "ok"}),
              Event(t + 0.210, "dispatched", 7,
                    {"replica": 1, "hop": 1, "tier": "decode"}),
              Event(t + 0.500, "finished", 7, {"tokens": 4})]
    off = 100.0
    hop0 = [{"ts": t + 0.005 + off, "kind": "submit", "rid": 1},
            {"ts": t + 0.020 + off, "kind": "admitted", "rid": 1,
             "slot": 0},
            {"ts": t + 0.150 + off, "kind": "prefill_done", "rid": 1,
             "tokens": 1},
            {"ts": t + 0.190 + off, "kind": "finished", "rid": 1,
             "tokens": 1}]
    hop1 = [Event(t + 0.220, "submit", 4, {}),
            Event(t + 0.230, "admitted", 4, {"slot": 2}),
            Event(t + 0.400, "decode_chunk", 4, {"tokens": 3}),
            Event(t + 0.700, "finished", 4, {"tokens": 4})]
    hops = [{"hop": 1, "replica": 1, "tier": "decode", "phase": "decode",
             "kind": "inproc", "status": "completed", "hedge": False,
             "clock_offset": 0.0, "dispatched_ts": t + 0.210,
             "events": hop1},
            {"hop": 0, "replica": 3, "tier": "prefill", "phase": "prefill",
             "kind": "subprocess", "status": "completed", "hedge": False,
             "clock_offset": off, "dispatched_ts": t + 0.010,
             "events": hop0}]
    return router, hops, hop1


def test_stitch_and_fleet_timeline():
    def run(s):
        router, hops, hop1 = _fleet(s)
        st = s["st"].stitch(7, router, hops)
        fleet = s["st"].fleet_timeline_json(
            [{"pid": 0, "name": "fleet router", "events": router,
              "router": True},
             {"pid": 1, "name": "decode/replica 1", "events": hop1,
              "num_slots": 4}])
        return (st.to_dict(), [e.as_dict() for e in st.events],
                st.span("hop"), st.complete(), fleet,
                s["st"].router_lane_events(router, pid=2, base=990.0))

    got = _both(run)
    assert got[0][0] == "ok" and got[0][1][0]["spans"]
    assert got[1] == got[0]
    assert tst.SPAN_NAMES == jst.SPAN_NAMES


def test_federation_merge_and_cardinality():
    def run(s):
        parts = []
        for rep, tier in ((0, "prefill"), (1, "decode"), (2, "decode")):
            r = _serving_like(s)
            r.counter("serving_requests_completed").inc(rep)
            parts.append(({"tier": tier, "replica": rep},
                          s["ex"].json_snapshot(r)))
        skew = s["me"].MetricsRegistry()
        skew.gauge("serving_requests_completed").set(1)     # kind skew
        skew.histogram("serving_decode_step_seconds",
                       buckets=(1.0,)).observe(0.5)          # edge skew
        parts.append(({"tier": "decode", "replica": 3},
                      s["ex"].json_snapshot(skew)))
        merged = s["fed"].merge_snapshots(parts)
        ok = s["fed"].check_cardinality(merged)
        try:
            s["fed"].check_cardinality(merged, budget=1)
            over = None
        except ValueError as e:
            over = str(e)
        return (merged, ok, over, s["fed"].series_cardinality(merged),
                s["ex"].snapshot_prometheus_text(merged))

    got = _both(run)
    assert got[0][0] == "ok" and got[0][1][2]
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# tracing (the port's own: torch.profiler + NVTX)
# ---------------------------------------------------------------------------

def test_span_names_reach_the_profiler_trace():
    reg = tme.MetricsRegistry()

    @tracing.traced("step", registry=reg)
    def step():
        return torch.ones(4).sum()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer", registry=reg) as q:
            assert q == "outer" and tracing.current_span() == "outer"
            with tracing.span("inner", registry=reg) as q2:
                assert q2 == "outer/inner"
                step()
    keys = {e.key for e in prof.key_averages()}
    assert {"outer", "outer/inner", "outer/inner/step"} <= keys
    fam = reg.get("trace_span_seconds")
    spans = {v[0]: c.snapshot()[2] for v, c in fam.collect()}
    assert spans == {"outer": 1, "outer/inner": 1, "outer/inner/step": 1}
    assert tracing.current_span() is None


def test_span_stack_unwinds_on_exception():
    reg = tme.MetricsRegistry()
    with pytest.raises(KeyError):
        with tracing.span("a", registry=reg):
            with tracing.span("b", registry=reg):
                assert tracing.current_span() == "a/b"
                raise KeyError("boom")
    assert tracing.current_span() is None
    with tracing.span("c", registry=tme.NULL_REGISTRY) as q:
        assert q == "c"
    fam = reg.get("trace_span_seconds")
    assert sorted(v[0] for v, _ in fam.collect()) == ["a", "a/b"]


def test_package_exports_the_reference_names():
    """The port's observability package exports the reference's names;
    `program_cost` stands where XLA's `cost_from_compiled` stood."""
    import deeplearning4j_tpu.observability as jo
    import deeplearning4j_tpu_torch.observability as to
    jnames = {n for n in dir(jo) if not n.startswith("_")
              and not isinstance(getattr(jo, n), type(jo))}
    tnames = {n for n in dir(to) if not n.startswith("_")
              and not isinstance(getattr(to, n), type(to))}
    assert jnames - tnames == {"cost_from_compiled"}
    assert tnames - jnames == {"program_cost"}

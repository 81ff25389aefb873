"""Port parity of the serving engine's observability against JAX's engine.

Both engines run float32 with ``pipeline=False`` (JAX's pipelined loop
refills a freed slot a tick later than the port's; ROADMAP queue C) on
the same weights (one JAX `init_params` tree converted with
`params_from_numpy`) and the same traffic, one arm at a time: plain with
two tenants, spec ("layers:1", K 3), paged with prefix hits and a
copy-on-write copy, chunked prefill, int8 weights and KV, and
constrained with one rejection. Each arm is served once a module and
read by every test.

- Equal: every counter family both scrapes have (timings and the
  analytic costs apart: the port's `program_cost` is not XLA's cost
  analysis, so those compare by their label sets), every histogram's
  ``_count``, and each request's lifecycle events (kinds and payloads
  but timestamps and bills).
- Pinned: the families JAX exposes and the port does not (none since the
  compile cache and KV adoption are ported: their series, the compiles by
  program and source among them, are compared like the rest), and the
  port's own series. Both engines resolve every program anew: JAX's
  process-wide program caches and the port's are cleared before each
  arm, so each engine's compiles count its own first resolutions.
- The naming lint (chip_smoke.py's copy of tests/test_metrics_naming.py's
  rules, itself held to JAX's scrape), the default and the NULL registry
  giving equal tokens, the pipelined and the sync port engine giving
  equal counters, the read-outs' keys, the per-request bills summing to
  the tenant counters, the HTTP endpoints, and the EngineConfig fields.
"""
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.observability import (  # noqa: E402
    NULL_REGISTRY, EngineProfiler, FlightRecorder, MetricsRegistry,
    MetricsServer, SLOTracker, json_snapshot, prometheus_text)
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

FIELDS = dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2, max_len=48)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
TENANTS = ("acme", "globex")

# families JAX's engine exposes and the port's does not -> the ROADMAP
# queue A item that brings them (none left: item 10's compile series and
# item 11a's KV adoptions are ported)
JAX_ONLY = {}
# the fault-handling families (ROADMAP queue A item 9a), equal to JAX's
# on every arm (no faults: zeros, the breaker closed)
FAULT_FAMILIES = ("serving_breaker_state", "serving_decode_retries",
                  "serving_decode_step_failures",
                  "serving_requests_quarantined",
                  "serving_requests_preempted")
# counter families compared by label set only: device timings and the
# analytic costs (the port's program_cost, JAX's XLA cost analysis)
COST_OR_TIME = {"serving_program_device_seconds", "serving_program_flops",
                "serving_program_bytes", "serving_request_cost_flops",
                "serving_request_cost_bytes"}
# the port's own series (engine._PORT_SERIES), by the arms that have them
PORT_ALL = {"serving_decode_chunks", "serving_device_syncs",
            "serving_device_wait_seconds"}
PORT_SPEC = {"serving_spec_rounds", "serving_spec_draft_steps",
             "serving_spec_reserved_tokens", "serving_spec_committed_tokens",
             "serving_spec_round_seconds"}

ARMS = {"plain": {}, "spec": dict(spec_decode=True, spec_k=3,
                                  draft="layers:1"),
        "paged": dict(paged=True, page_size=4, prefix_cache=True),
        "chunked": dict(prefill_chunk=6),
        "int8": dict(quantize="int8", kv_quantize="int8"),
        "constrained": {}}
ARM_IDS = sorted(ARMS)


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.delenv("DL4JTPU_FLASH", raising=False)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshSpec(data=1, model=1))


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _config(arm, **kw):
    return dict(num_slots=3, decode_chunk=3, max_new_tokens=7,
                pipeline=False, **ARMS[arm], **kw)


def _waves(arm):
    """The arm's traffic: waves of (prompt, submit kwargs). The paged arm
    shares a 12-token prefix (three pages) and resubmits one prompt
    whole (a full-prefix hit: copy-on-write); the constrained one mixes
    two grammars, an unconstrained request and one rejected spec."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 200, size=12).astype(np.int32)

    def p(n):
        return rng.integers(0, 200, size=n).astype(np.int32)

    if arm == "paged":
        a = np.concatenate([shared, p(4)])        # four full pages
        w1 = [(a, {}), (np.concatenate([shared, p(5)]), {}), (p(9), {})]
        w2 = [(a.copy(), {}), (np.concatenate([shared, p(2)]), {})]
        return [w1, w2]
    if arm == "constrained":
        return [[(p(6), {"constrain": "[ab]{1,5}"}), (p(4), {}),
                 (p(5), {"constrain": "(ab)+c"}), (p(3), {"constrain": "("}),
                 (p(7), {"constrain": "[ab]{1,5}"})]]
    lens = (5, 11, 3, 8, 14) if arm != "chunked" else (13, 4, 9, 6, 16)
    return [[(p(n), {"tenant": TENANTS[i % 2]})
             for i, n in enumerate(lens)]]


def _serve(eng, arm, port: bool):
    """Each wave submitted then drained; returns the handles (None for a
    rejected submit)."""
    hs = []
    for wave in _waves(arm):
        for prompt, kw in wave:
            try:
                hs.append(eng.submit(prompt, **kw))
            except ValueError:               # ConstraintError
                hs.append(None)
        eng.run_pending()
    return hs


_SERVED = {}


@pytest.fixture
def served(mesh1, jparams, tparams):
    def get(arm):
        if arm not in _SERVED:
            for c in jeng._ProgramLRU._instances:
                c.cache_clear()
            teng.program_cache_clear()
            jcfg = jeng.EngineConfig(**_config(arm))
            jeng_ = jeng.InferenceEngine(JCFG, mesh1, jparams, jcfg)
            jh = _serve(jeng_, arm, False)
            teng_ = teng.InferenceEngine(
                TCFG, tparams, teng.EngineConfig(**_config(arm)),
                device="cpu")
            th = _serve(teng_, arm, True)
            _SERVED[arm] = (jeng_, jh, teng_, th)
        return _SERVED[arm]
    return get


def _fams(eng):
    return {k: v for k, v in json_snapshot(eng.registry).items()}


def _gen(h):
    return None if h is None else h.result()[h.prompt.shape[0]:].tolist()


@pytest.mark.parametrize("arm", ARM_IDS)
def test_tokens_equal(served, arm):
    j, jh, t, th = served(arm)
    assert [_gen(h) for h in th] == [_gen(h) for h in jh]


@pytest.mark.parametrize("arm", ARM_IDS)
def test_counters_and_histogram_counts_equal(served, arm):
    j, _, t, _ = served(arm)
    jf, tf_ = jex.json_snapshot(j.registry), _fams(t)
    both = sorted(set(jf) & set(tf_))
    compared = 0
    for name in both:
        a, b = jf[name], tf_[name]
        assert a["kind"] == b["kind"], name
        if a["kind"] == "counter":
            if name in COST_OR_TIME:
                # JAX's constrained engine bills nothing (its bills read
                # the cost table under the unmasked program label), so
                # the port's labels cover JAX's
                got = {str(s["labels"]) for s in b["samples"]}
                assert got >= {str(s["labels"]) for s in a["samples"]}, name
                assert got or not a["samples"], name
                continue
            assert b["samples"] == a["samples"], name
            compared += 1
        elif a["kind"] == "histogram":
            assert [(s["labels"], s["count"]) for s in b["samples"]] == \
                [(s["labels"], s["count"]) for s in a["samples"]], name
            compared += 1
    assert compared >= 8
    for name in FAULT_FAMILIES:
        assert tf_[name]["kind"] == jf[name]["kind"], name
        assert tf_[name]["samples"] == jf[name]["samples"], name
    assert tf_["serving_requests_shed"]["samples"] == \
        jf["serving_requests_shed"]["samples"]
    # the engines really did the arm's work
    c = t.counts
    assert c["prefill_calls"] > 0 and c["decode_chunks"] + \
        c["spec_rounds"] > 0
    if arm == "paged":
        assert c["prefix_hits"] >= 2 and c["cow_copies"] >= 1
    if arm == "spec":
        assert c["spec_drafted"] > 0
    if arm == "chunked":
        assert c["prefill_chunks"] > c["prefill_calls"]
    if arm == "constrained":
        assert c["constrained_rejected_invalid"] == 1


@pytest.mark.parametrize("arm", ARM_IDS)
def test_family_sets_pinned(served, arm):
    j, _, t, _ = served(arm)
    jf, tf_ = set(jex.json_snapshot(j.registry)), set(_fams(t))
    assert jf - tf_ == set(JAX_ONLY)
    want_port = set(PORT_ALL)
    if arm == "spec":
        want_port |= PORT_SPEC
    if arm == "paged":
        want_port.add("serving_kv_cow_copies")
    if arm == "constrained":
        want_port.add("serving_constrained_illegal_tokens")
    assert tf_ - jf == want_port


@pytest.mark.parametrize("arm", ARM_IDS)
def test_naming_lint(served, arm):
    j, _, t, _ = served(arm)
    assert chip_smoke.lint_exposition(jex.prometheus_text(j.registry)) == []
    assert chip_smoke.lint_exposition(prometheus_text(t.registry)) == []


@pytest.mark.parametrize("arm", ARM_IDS)
def test_chip_scrape_gates_hold_on_the_cpu(served, arm):
    """chip_smoke.py's phase 3h scrape gates on the port's CPU engine:
    the lint, counts = series, pages, bills, and the series against the
    handles (completions, TTFT observations, prompt tokens)."""
    _, _, eng, th = served(arm)
    hs = [h for h in th if h is not None]
    got, bills = chip_smoke.scrape_gates(eng, hs, arm)
    facts = chip_smoke.handle_facts(got, hs)
    assert facts["completed"] == (len(hs), len(hs))
    assert all(a == b for a, b in facts.values()), facts
    assert min(bills.values()) > 0


def test_naming_lint_catches_drift():
    bad = ("# HELP serving_AdmissionWait x\n# TYPE serving_AdmissionWait "
           "gauge\nserving_AdmissionWait 1\n# HELP lat x\n# TYPE lat "
           "histogram\nlat_count 1\n# HELP c x\n# TYPE c counter\nc 1\n"
           "orphan 2\n")
    errs = chip_smoke.lint_exposition(bad)
    assert len(errs) == 4, errs


def _events(h):
    drop = ("cost_flops", "cost_bytes")
    return [(e.kind, {k: v for k, v in e.data.items() if k not in drop})
            for e in h.trace.events]


@pytest.mark.parametrize("arm", ARM_IDS)
def test_lifecycle_events_equal(served, arm):
    _, jh, _, th = served(arm)
    for a, b in zip(jh, th):
        if a is None:
            assert b is None
            continue
        assert _events(b) == _events(a)
        assert b.trace.complete() and b.trace.events[-1].kind == "finished"


@pytest.mark.parametrize("arm", ARM_IDS)
def test_bills_sum_to_the_tenant_counters(served, arm):
    _, _, t, th = served(arm)
    snap = _fams(t)
    for what in ("flops", "bytes"):
        total = sum(s["value"] for s in
                    snap[f"serving_request_cost_{what}"]["samples"])
        bills = sum(getattr(h, f"cost_{what}") for h in th if h is not None)
        assert total > 0
        np.testing.assert_allclose(bills, total, rtol=1e-9)
    # the per-program FLOPs cover at least the bills (a bill is a share
    # of its call's cost)
    prog = sum(s["value"] for s in snap["serving_program_flops"]["samples"])
    assert prog >= total * (1 - 1e-9)
    report = t.profile_report()
    assert report["mfu"] == 0.0 and report["peak_flops"] is None
    if arm == "plain":
        assert set(report["tenant_costs"]["tenants"]) == set(TENANTS)


def _keys(d):
    return set(d) if isinstance(d, dict) else set()


# keys of JAX's read-outs whose items are unported (none left: the
# warm-up report, the compiles by source and the compile cache's section
# came with item 10)
READOUT_UNPORTED = {
    "health": set(),
    "debugz": set(),
    "stats": set(),
}


@pytest.mark.parametrize("arm", ["paged", "chunked", "spec"])
def test_readouts_have_jax_keys(served, arm):
    j, _, t, _ = served(arm)
    for name in ("health", "debugz", "stats"):
        jv = getattr(j, name)
        tv = getattr(t, name)
        jv, tv = (jv() if callable(jv) else jv), (tv() if callable(tv)
                                                  else tv)
        assert _keys(jv) - _keys(tv) == READOUT_UNPORTED[name], name
        assert _keys(tv) <= _keys(jv), name
    jd, td = j.debugz(), t.debugz()
    for sec in ("paged", "chunked_prefill", "spec", "profiling"):
        assert _keys(td.get(sec)) == _keys(jd.get(sec)), sec
    assert _keys(td["tick_pipeline"]) == _keys(jd["tick_pipeline"])
    assert _keys(td["compile_cache"]) == _keys(jd["compile_cache"])
    assert _keys(td["slots"][0] if td["slots"] else {}) <= \
        {"slot", "rid", "status", "tenant", "priority", "generated",
         "max_new_tokens", "age_s", "phase", "prefill_pos",
         "prefill_target"}
    assert _keys(t.slo_report()) == _keys(j.slo_report())
    assert _keys(t.profile_report()) == _keys(j.profile_report())
    tl = t.timeline()
    assert _keys(tl) == _keys(j.timeline())
    lanes = {e["args"]["name"] for e in tl["traceEvents"]
             if e["name"] == "thread_name"}
    assert lanes == {"queue", "slot 0", "slot 1", "slot 2"}


@pytest.mark.parametrize("arm", ARM_IDS)
def test_null_registry_same_tokens(served, tparams, arm):
    _, _, t, th = served(arm)
    n = teng.InferenceEngine(TCFG, tparams,
                             teng.EngineConfig(**_config(arm)),
                             device="cpu", registry=NULL_REGISTRY)
    nh = _serve(n, arm, True)
    assert [_gen(h) for h in nh] == [_gen(h) for h in th]
    assert not n.recorder.enabled and not n.profiler.enabled
    assert n.slo.report() == {} and prometheus_text(n.registry) == "\n"
    assert sorted(n._programs) == sorted(t._programs)
    assert all(v == 0 for v in n.counts.values())


@pytest.mark.parametrize("arm", ["plain", "paged", "chunked", "int8"])
def test_pipelined_counters_equal_sync(served, tparams, arm):
    _, _, s, sh = served(arm)
    p = teng.InferenceEngine(
        TCFG, tparams, teng.EngineConfig(**{**_config(arm),
                                            "pipeline": True}),
        device="cpu")
    ph = _serve(p, arm, True)
    assert [_gen(h) for h in ph] == [_gen(h) for h in sh]
    # the tick series count ticks: the pipelined loop's last tick only
    # commits, one tick more than the synchronous loop runs
    own = {"serving_device_syncs", "serving_pipelined_ticks",
           "serving_device_wait_seconds", "serving_batches",
           "serving_batch_size", "serving_batch_latency_seconds"}
    sf, pf = _fams(s), _fams(p)
    # JAX registers the flush histogram on pipelined engines only
    # (engine.py:1701)
    assert set(pf) - set(sf) == {"serving_pipelined_ticks",
                                 "serving_pipeline_flush_seconds"}
    for fams, eng in ((sf, s), (pf, p)):
        ticks = fams["serving_batches"]["samples"][0]["value"]
        assert ticks == fams["serving_batch_size"]["samples"][0]["count"] \
            == fams["serving_batch_latency_seconds"]["samples"][0]["count"]
        assert ticks == (eng.counts["pipelined_ticks"] if eng is p else
                         ticks) > 0
    for name in sorted(set(sf) & set(pf)):
        if name in own:
            continue
        if sf[name]["kind"] == "counter" and name not in COST_OR_TIME:
            assert pf[name]["samples"] == sf[name]["samples"], name
        elif sf[name]["kind"] == "histogram":
            assert [s["count"] for s in pf[name]["samples"]] == \
                [s["count"] for s in sf[name]["samples"]], name


def test_metrics_server_endpoints(served, tmp_path):
    _, _, t, _ = served("plain")
    srv = MetricsServer(t.registry, port=0, health=t.health, ready=t.ready,
                        debug=t.debugz, slo=t.slo_report,
                        timeline=t.timeline, profilez=t.profilez)
    try:
        def get(path):
            try:
                with urllib.request.urlopen(srv.url + path,
                                            timeout=30) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        def types(text):
            return [ln for ln in text.splitlines()
                    if ln.startswith("# TYPE")]

        # (the windowed rate gauges move between two reads)
        code, text = get("/metrics")
        assert code == 200 and types(text) == types(prometheus_text(
            t.registry)) and chip_smoke.lint_exposition(text) == []
        assert json.loads(get("/metrics.json")[1]).keys() == \
            json_snapshot(t.registry).keys()
        for path in ("/healthz", "/readyz", "/debugz", "/slo",
                     "/timeline.json"):
            code, body = get(path)
            assert code == 200, path
            json.loads(body)
        code, body = get("/profilez?seconds=1")
        assert code == 503 and "profile_dir" in json.loads(body)["error"]
    finally:
        srv.stop()


@pytest.mark.parametrize("tenant", [b"x", 1.5, "", "a" * 65, 'q"t', "n\nl",
                                    "\x01"])
def test_malformed_tenant_refused_like_jax(tparams, tenant):
    eng = teng.InferenceEngine(TCFG, tparams, teng.EngineConfig(),
                               device="cpu")
    with pytest.raises(teng.QoSValidationError) as got:
        eng.submit(np.arange(4), tenant=tenant)
    with pytest.raises(jeng.QoSValidationError) as want:
        jeng.validate_tenant_priority(tenant, 0)
    assert str(got.value) == str(want.value)
    assert not eng._queue
    assert eng.submit(np.arange(4), tenant=7).tenant == "7"


def test_observability_fields_accepted_and_unported_named(tparams,
                                                          tmp_path):
    eng = teng.InferenceEngine(
        TCFG, tparams, teng.EngineConfig(recorder_capacity=16,
                                         profile_dir=str(tmp_path),
                                         tenant_top_n=1),
        device="cpu")
    assert eng.recorder.capacity == 16
    assert eng.profiler.meter.top_n == 1
    for i in range(3):
        eng.submit(np.arange(4) + i, tenant=f"t{i}")
    eng.run_pending()
    assert set(eng.profile_report()["tenant_costs"]["tenants"]) == \
        {"t0", "other"}
    assert len(eng.recorder) == 16
    # the compile cache's fields construct engines now (item 10)
    for field, value in (("compile_cache_dir", str(tmp_path / "cc")),
                         ("warmup_on_init", True),
                         ("program_cache_size", 8)):
        eng = teng.InferenceEngine(TCFG, tparams,
                                   teng.EngineConfig(**{field: value}),
                                   device="cpu")
        h = eng.submit(np.arange(4))
        eng.run_pending()
        assert h.status == "completed"
    assert teng.program_cache_info().maxsize == 8
    teng.set_program_cache_size(teng.DEFAULT_PROGRAM_CACHE_SIZE)
    # batch mode and tenant QoS construct engines now
    for kw in (dict(mode="batch"), dict(preemption_budget=1),
               dict(prefill_chunk=4, tenant_weights={"a": 1.0},
                    qos_default_weight=2.0)):
        eng = teng.InferenceEngine(TCFG, tparams, teng.EngineConfig(**kw),
                                   device="cpu")
        h = eng.submit(np.arange(4), tenant="a")
        eng.run_pending()
        assert h.status == "completed"
    assert not hasattr(teng, "_UNPORTED")
    # an injected clock is what deadlines read
    t = {"now": 0.0}
    eng = teng.InferenceEngine(TCFG, tparams, teng.EngineConfig(),
                               device="cpu", clock=lambda: t["now"])
    h = eng.submit(np.arange(4), deadline_s=1.0)
    t["now"] = 2.0
    eng.run_pending()
    assert h.status == teng.RequestStatus.SHED and h.deadline_exceeded
    assert eng.stats["shed_deadline"] == 1


def test_injected_recorder_slo_and_profiler_are_the_engines(tparams):
    """The recorder, SLO tracker and profiler a caller passes are the
    ones the engine feeds: a 5-event recorder fills to 5, a 3-request
    SLO window holds 3, and a profiler with injected peaks reads a
    non-zero MFU on the CPU (where the chip table gives none)."""
    reg = MetricsRegistry()
    rec = FlightRecorder(capacity=5)
    slo = SLOTracker(registry=reg, window=3)
    prof = EngineProfiler(reg, peak_flops=1e9, peak_bytes_per_s=1e9,
                          device="cpu")
    eng = teng.InferenceEngine(TCFG, tparams,
                               teng.EngineConfig(**_config("plain")),
                               device="cpu", registry=reg, recorder=rec,
                               slo=slo, profiler=prof)
    assert (eng.recorder, eng.slo, eng.profiler) == (rec, slo, prof)
    hs = _serve(eng, "plain", True)
    assert all(h.done() for h in hs)
    assert len(rec) == 5 and {e.rid for e in rec.recent(5)} <= \
        {h.rid for h in hs}
    assert slo.report()["window"] == 3 == eng.slo_report()["window"]
    rep = eng.profile_report()
    assert (rep["peak_flops"], rep["peak_bytes_per_s"]) == (1e9, 1e9)
    assert reg.get("serving_mfu").value > 0

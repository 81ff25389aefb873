"""The port's fleet router against the reference's, on the CPU.

`deeplearning4j_tpu_torch.serving.fleet.Router` and
`deeplearning4j_tpu.serving.fleet.Router` run the same scenario on the
same weights (one JAX `init_params` tree converted with
`params_from_numpy`), float32, greedy, ``pipeline=False`` (JAX's
pipelined loop refills a freed slot a tick later than the port's;
ROADMAP queue C), each driven tick by tick with its own injected clock
advanced by the same step and its own `FleetFaultInjector` of the same
schedule. Every scenario returns a record: per request the terminal
status, the error type, the shed reasons, the router-side trace kinds
and the committed tokens; the fleet `stats` counters and the injector's
counts. The port's record must equal the reference's, and the port is
also held to the contract the reference's own test asserts
(tests/test_serving_fleet.py, tests/test_serving_qos.py:425-560,
tests/test_serving_constrained.py:248): token-exact against an
uninterrupted single port engine, zero lost requests under a kill,
hang, slowdown or probe failure, typed sheds.

Also: the pipelined loop (the default) under no fault and a kill,
token-exact and nothing lost; the router's metric families against the
reference's (names, kinds, label names) and the naming lint
(chip_smoke.py's copy of tests/test_metrics_naming.py's rules);
`Router(cfg=, params=)` without ``device=`` raising on a CUDA-less
machine; HTTP probes and the router's own endpoints.
"""
import os
import sys
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.util import checkpointing as jckpt  # noqa: E402

from deeplearning4j_tpu_torch.observability import (  # noqa: E402
    MetricsServer, json_snapshot, prometheus_text)
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving import fleet as tfleet  # noqa: E402
from deeplearning4j_tpu_torch.util import checkpointing as tckpt  # noqa
from torch_fleet_helpers import (FIELDS, STEP, drive, prompt,  # noqa: E402
                                 record)
from torch_fleet_helpers import impls as make_impls  # noqa: E402
from torch_fleet_helpers import single as single_engine  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

CFIELDS = dict(FIELDS, vocab_size=256)       # constrained: byte vocab
RX = "[ab]{1,5}"
_prompt = prompt


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(MeshSpec(data=1, model=1))


@pytest.fixture(scope="module")
def impls(mesh1):
    return make_impls(FIELDS, mesh1)


@pytest.fixture(scope="module")
def cimpls(mesh1):
    return make_impls(CFIELDS, mesh1)


@pytest.fixture(scope="module")
def single(impls):
    """Uninterrupted single port engine: the token-exactness oracle."""
    imp = impls["port"]
    cache = {}

    def run(prompts, max_new=12):
        for p in prompts:
            key = (tuple(p.tolist()), max_new)
            if key not in cache:
                cache[key] = single_engine(imp, [p], max_new)[0]
        return [cache[(tuple(p.tolist()), max_new)] for p in prompts]
    return run


# ---------------------------------------------------------------------------
# scenarios: each runs on one side and returns (record, router, handles)
# ---------------------------------------------------------------------------

def _plain(imp, n=3, inj=None, fleet=None, prompts=None, max_new=12,
           submit=None, **ec):
    prompts = prompts if prompts is not None else [
        _prompt(8, i) for i in range(5)]
    r = imp.router(n=n, ec=imp.ec(**ec), fleet=fleet, inj=inj)
    inj_obj = r._injector
    try:
        hs = [r.submit(p, max_new_tokens=max_new, **(submit or {}))
              for p in prompts]
        drive(r)
        return record(r, hs, inj_obj), r, hs
    finally:
        r.close()


SCENARIOS = {
    "none": dict(n=3),
    "kill": dict(n=2, inj=dict(kill_at={2: 0}),
                 prompts=[_prompt(8, i) for i in range(4)]),
    "kill_heavy": dict(n=3, inj=dict(kill_at={3: 1}),
                       prompts=[_prompt(8 + (i % 2) * 4, i)
                                for i in range(9)]),
    "hang": dict(n=2, inj=dict(hang_at={2: 0}),
                 fleet=dict(hang_ticks=5, hang_min_s=0.0),
                 prompts=[_prompt(8, i) for i in range(4)]),
    "slow_hedge": dict(n=2, inj=dict(slow_at={1: (0, 0.001)}),
                       fleet=dict(hedge=True, hedge_age_s=0.0),
                       prompts=[_prompt(8, i) for i in range(2)]),
    "fail_probe": dict(n=2, inj=dict(fail_probe={0: 3}),
                       fleet=dict(probe_failure_threshold=1), max_new=4,
                       prompts=[_prompt(8, i) for i in range(2)]),
    "restart_budget": dict(n=2, inj=dict(kill_at={1: 0, 4: 0, 7: 0}),
                           fleet=dict(max_restarts=1,
                                      restart_backoff_base_s=0.0),
                           prompts=[_prompt(8, i) for i in range(6)]),
    "outage": dict(n=1, inj=dict(kill_at={1: 0}),
                   fleet=dict(max_restarts=0),
                   prompts=[_prompt(8, i) for i in range(3)]),
    "deadline": dict(n=2, inj=dict(kill_at={2: 0}),
                     prompts=[_prompt(8, i) for i in range(4)],
                     submit=dict(deadline_s=0.12)),
    "deadline_partial": dict(n=2, inj=dict(kill_at={2: 0}),
                             prompts=[_prompt(8, i) for i in range(4)],
                             submit=dict(deadline_s=0.12,
                                         on_deadline="partial")),
}


@pytest.mark.parametrize("arm", list(SCENARIOS))
def test_router_matches_reference(impls, single, arm):
    spec = dict(SCENARIOS[arm])
    want, _, _ = _plain(impls["jax"], **spec)
    got, r, hs = _plain(impls["port"], **spec)
    assert got == want
    # the reference test's contract, on the port
    prompts = spec.get("prompts") or [_prompt(8, i) for i in range(5)]
    oracle = single(prompts, spec.get("max_new", 12))
    done = [h for h in hs if h.status == "completed"]
    if arm == "outage":
        assert got["stats"]["shed_outage"] >= 1
        assert all(h.done() for h in hs)
        assert {type(h.error).__name__ for h in hs
                if h.error is not None} == {"OverloadError"}
        return
    if arm.startswith("deadline"):
        assert all(h.done() for h in hs)
        for h, w in zip(hs, oracle):    # a partial is a prefix of it
            n = len(h.generated)
            np.testing.assert_array_equal(h.result(0)[8:] if h.error
                                          is None else h.generated,
                                          w[8:8 + n])
        return
    assert len(done) == len(hs), got       # zero lost
    for h, w in zip(hs, oracle):
        np.testing.assert_array_equal(h.result(0), w)
    st = got["stats"]
    if arm in ("kill", "kill_heavy", "hang"):
        assert st["failovers"] >= 1
    if arm == "slow_hedge":
        assert st["hedges_primary_won"] + st["hedges_hedge_won"] >= 1
    if arm == "fail_probe":
        assert st["probe_failures"] >= 1
    if arm == "restart_budget":
        row = [x for x in r.debugz()["replicas"] if x["replica"] == 0][0]
        assert row["state"] == "dead" and row["consec_crashes"] > 1


@pytest.mark.parametrize("arm", ["none", "kill"])
def test_pipelined_router_token_exact(impls, single, arm):
    """The default pipelined loop behind the router: token-exact against
    the uninterrupted engine and nothing lost (its counters are held to
    nothing: the reference's pipelined loop seats a freed slot a tick
    later)."""
    spec = dict(SCENARIOS[arm], pipeline=True)
    got, _, hs = _plain(impls["port"], **spec)
    prompts = spec.get("prompts") or [_prompt(8, i) for i in range(5)]
    for h, w in zip(hs, single(prompts)):
        assert h.status == "completed"
        np.testing.assert_array_equal(h.result(0), w)
    if arm == "kill":
        assert got["stats"]["failovers"] >= 1


def test_hedge_loser_cancelled_at_its_engine(impls):
    """The slow replica's hedge loser is cancelled engine-side (shed
    reason ``cancelled``) and the hedged traces carry the hop."""
    spec = dict(SCENARIOS["slow_hedge"])
    imp = impls["port"]
    r = imp.router(n=2, ec=imp.ec(), fleet=spec["fleet"],
                   inj=spec["inj"])
    try:
        hs = [r.submit(p, max_new_tokens=12) for p in spec["prompts"]]
        cancelled = 0
        engines = [c.replica.engine for c in r._ctls]
        drive(r)
        for eng in engines:
            cancelled += int(eng.registry.get("serving_requests_shed")
                             .labels("cancelled").value)
        assert cancelled >= 1
        hedged = [h for h in hs if any(
            e.kind == "dispatched" and e.data.get("hedge")
            for e in h.trace.events)]
        assert hedged and any("hedge" in h.trace.kinds() for h in hedged)
    finally:
        r.close()


def test_hedge_slow_decile_policy(impls):
    """The rolling-p90 hedge trigger, on both sides with the same
    window."""
    for imp in impls.values():
        r = imp.router(n=2, fleet=dict(hedge=True, hedge_min_age_s=0.05,
                                       hedge_warmup=10,
                                       hedge_quantile=0.9))
        try:
            fr = r.submit(_prompt(8, 0), max_new_tokens=2)
            assert not r._should_hedge(fr, 10.0)
            r._age_window.extend([0.001] * 18 + [1.0, 2.0])
            assert [r._should_hedge(fr, a) for a in (1.5, 0.0005, 0.01)] \
                == [True, False, False]
            drive(r)
        finally:
            r.close()


# ---------------------------------------------------------------------------
# admission: validation, queue bound, drain, rolling reload
# ---------------------------------------------------------------------------

def _admission(imp):
    out = []
    r = imp.router(n=2, fleet=dict(max_queue=3))
    try:
        for bad in (dict(prompt=np.zeros((0,), np.int32)),
                    dict(prompt=_prompt(8), max_new_tokens=-1),
                    dict(prompt=_prompt(8), max_new_tokens=100),
                    dict(prompt=_prompt(8), on_deadline="late")):
            p = bad.pop("prompt")
            with pytest.raises(ValueError):
                r.submit(p, **bad)
        hs = [r.submit(_prompt(8, i), max_new_tokens=4) for i in range(3)]
        with pytest.raises(imp.eng.OverloadError):
            r.submit(_prompt(8, 9), max_new_tokens=4)
        drive(r)
        out.append(record(r, hs))
        # drain: readiness flips at once, nothing shed, resume reopens
        hs = [r.submit(_prompt(8, i), max_new_tokens=12) for i in range(3)]
        r.tick()
        ready0 = r.ready()
        r.drain(wait=False)
        ready1 = r.ready()
        with pytest.raises(imp.eng.EngineDraining):
            r.submit(_prompt(8, 9), max_new_tokens=4)
        drive(r)
        r.resume()
        h = r.submit(_prompt(8, 5), max_new_tokens=4)
        drive(r)
        out.append(dict(record(r, hs + [h]), ready=[ready0, ready1]))
        return out
    finally:
        r.close()


def test_admission_and_drain_match_reference(impls):
    want = _admission(impls["jax"])
    got = _admission(impls["port"])
    assert got == want
    assert got[1]["ready"] == [True, False]
    assert got[1]["stats"]["shed_overload"] == 1     # the full queue's
    assert all(q["status"] == "completed" for q in got[1]["requests"])


def test_rolling_reload_matches_reference(impls, tmp_path):
    """One replica at a time drains and reloads a checkpoint step
    written by the reference's npz `CheckpointManager` (the port's reads
    the same layout): zero dropped, every replica on the new step."""
    jmgr = jckpt.CheckpointManager(str(tmp_path / "w"), use_orbax=False)
    jmgr.save_tree(impls["jax"].build["params"], 7)
    recs = {}
    for name, imp in impls.items():
        mgr = (jmgr if name == "jax"
               else tckpt.CheckpointManager(str(tmp_path / "w")))
        r = imp.router(n=2)
        try:
            hs = [r.submit(_prompt(8, i), max_new_tokens=12)
                  for i in range(6)]
            r.tick()
            loaded = r.rolling_reload(mgr, timeout=120.0)
            drive(r)
            steps = [c.replica.engine._weights_step for c in r._ctls]
            recs[name] = dict(record(r, hs), loaded=loaded, steps=steps)
        finally:
            r.close()
    assert recs["port"]["loaded"] == recs["port"]["steps"] == [7, 7]
    # the reference's drain loop ticks on wall time: only outcomes compare
    for rec in recs.values():
        assert all(q["status"] == "completed" for q in rec["requests"])
        assert rec["stats"]["shed_overload"] == 0
    assert [q["tokens"] for q in recs["port"]["requests"]] == \
        [q["tokens"] for q in recs["jax"]["requests"]]


def test_supervised_restart_serves_again(impls):
    """A crashed replica restarts under the backoff, takes traffic again
    and the recovery histogram has its one sample; the abandoned engine
    is dropped (its device memory returns as a dead process's would)."""
    recs = {}
    for name, imp in impls.items():
        r = imp.router(n=2, inj=dict(kill_at={1: 0}))
        try:
            hs = [r.submit(_prompt(8, i), max_new_tokens=4)
                  for i in range(2)]
            drive(r)
            for _ in range(4):
                r.tick()
                r._test_clock.advance(STEP)
            r._ctls[1].draining = True
            h = r.submit(_prompt(8, 5), max_new_tokens=4)
            drive(r)
            hist = r.registry.get("serving_fleet_recovery_seconds")
            recs[name] = dict(record(r, hs + [h]),
                              recoveries=hist.labels().snapshot()[2],
                              served_by=[e.data.get("replica")
                                         for e in h.trace.events
                                         if e.kind == "dispatched"])
        finally:
            r.close()
    assert recs["port"] == recs["jax"]
    assert recs["port"]["stats"]["restarts"] == 1
    assert recs["port"]["recoveries"] == 1
    assert recs["port"]["served_by"] == [0]


def test_killed_in_process_replica_frees_its_engine(impls):
    """A simulated crash abandons the engine with requests in flight:
    with the cyclic collector off, the engine is freed at the kill (its
    in-flight handles hold its terminal hook weakly; on the card its
    pools and graphs return at once), and the request still completes
    by failover."""
    import gc
    import weakref
    imp = impls["port"]
    r = imp.router(n=2)
    gc.disable()
    try:
        rep = r._ctls[0].replica
        ref = weakref.ref(rep.engine)
        hs = [r.submit(_prompt(8, i), max_new_tokens=12) for i in range(3)]
        r.tick()
        inner = [h.inner for hops in r._ctls[0].outstanding.values()
                 for h in hops]
        assert inner and not any(i.done() for i in inner)
        rep.kill()
        assert rep.engine is None and not rep.alive()
        assert ref() is None
        drive(r)
        assert [h.status for h in hs] == ["completed"] * 3
        assert r.stats["failovers"] == len(inner)
    finally:
        gc.enable()
        r.close()


# ---------------------------------------------------------------------------
# tenant caps, the rate bucket, the overload ladder, constrained failover
# ---------------------------------------------------------------------------

def _qos_ec(imp, **kw):
    base = dict(decode_chunk=2, max_new_tokens=4, backoff_base_s=0.0,
                prefill_chunk=4, max_batch_size=2, pipeline=False)
    base.update(kw)
    return imp.eng.EngineConfig(**base)


def _tenant_caps(imp):
    cap_err = imp.fleet.TenantCapExceeded
    r = imp.router(n=1, ec=_qos_ec(imp),
                   fleet=dict(tenant_max_concurrency=2))
    try:
        hs = [r.submit(_prompt(8, i), tenant="capped") for i in range(2)]
        rejected = 0
        for _ in range(2):
            with pytest.raises(cap_err):
                r.submit(_prompt(), tenant="capped")
            rejected += 1
        hs.append(r.submit(_prompt(8, 4), tenant="other"))
        drive(r)
        hs.append(r.submit(_prompt(8, 5), tenant="capped"))
        drive(r)
        assert issubclass(cap_err, imp.eng.OverloadError)
        return dict(record(r, hs), rejected=rejected,
                    metric=r._m_qos_rejections.labels(
                        "concurrency").value)
    finally:
        r.close()


def _rate_bucket(imp):
    cap_err = imp.fleet.TenantCapExceeded
    r = imp.router(n=1, ec=_qos_ec(imp),
                   fleet=dict(tenant_rate_per_s=1.0, tenant_rate_burst=2))
    clk = r._test_clock
    try:
        hs = [r.submit(_prompt(8, i), tenant="rl") for i in range(2)]
        with pytest.raises(cap_err):
            r.submit(_prompt(), tenant="rl")
        m1 = r._m_qos_rejections.labels("rate").value
        clk.t = 1.0                        # one token refilled
        hs.append(r.submit(_prompt(8, 3), tenant="rl"))
        with pytest.raises(cap_err):
            r.submit(_prompt(), tenant="rl")
        hs.append(r.submit(_prompt(8, 4), tenant="free"))
        drive(r)
        return dict(record(r, hs), rate_rejections=[
            m1, r._m_qos_rejections.labels("rate").value])
    finally:
        r.close()


def _overload_ladder(imp):
    r = imp.router(n=1, ec=_qos_ec(imp, max_batch_size=1,
                                   max_new_tokens=8),
                   fleet=dict(overload_queue_depth=2,
                              overload_check_every_ticks=1,
                              overload_cooldown_ticks=3,
                              overload_shed_per_tick=2))
    try:
        eng = r._ctls[0].replica.engine
        base = eng._base_chunk
        keep = [r.submit(_prompt(8, i), priority=2) for i in range(2)]
        flood = [r.submit(_prompt(8, 10 + i)) for i in range(8)]
        for _ in range(3):
            r.tick()
            r._test_clock.advance(STEP)
        degraded = dict(level=r.debugz()["qos"]["level"],
                        spec_off=eng._qos_spec_off,
                        chunk=eng._chunk == max(1, base // 2))
        drive(r)
        for _ in range(16):
            r.tick()
            r._test_clock.advance(STEP)
        acts = r._m_qos_actions
        return dict(record(r, keep + flood), degraded=degraded,
                    restored=dict(level=r.debugz()["qos"]["level"],
                                  spec_off=eng._qos_spec_off,
                                  chunk=eng._chunk == base),
                    actions={a: acts.labels(a).value for a in (
                        "degrade_spec_off", "degrade_chunk_shrink",
                        "degrade_shed_low", "restore_none")},
                    qos_events=[(e.data.get("action"), e.data.get("step"))
                                for e in r.recorder.recent(200)
                                if e.kind == "qos"])
    finally:
        r.close()


@pytest.mark.parametrize("scenario", [_tenant_caps, _rate_bucket,
                                      _overload_ladder],
                         ids=["tenant_caps", "rate_bucket",
                              "overload_ladder"])
def test_qos_admission_matches_reference(impls, scenario):
    want = scenario(impls["jax"])
    got = scenario(impls["port"])
    assert got == want
    reqs = got["requests"]
    if scenario is _tenant_caps:
        assert got["rejected"] == 2 and got["metric"] >= 2
        assert all(q["error"] is None for q in reqs)
    elif scenario is _rate_bucket:
        assert got["rate_rejections"] == [1, 2]
        assert all(q["error"] is None for q in reqs)
    else:
        assert got["degraded"] == dict(level=3, spec_off=True, chunk=True)
        assert got["restored"] == dict(level=0, spec_off=False, chunk=True)
        assert all(v == 1 for v in got["actions"].values())
        assert all(q["error"] is None for q in reqs[:2])   # class 2 kept
        assert any(q["shed"] == ["qos"] for q in reqs[2:])


def _constrained_failover(imp):
    r = imp.router(n=2, ec=imp.ec(max_new_tokens=8),
                   inj=dict(kill_at={1: 0}))
    try:
        hs = [r.submit(_prompt(6, i, 256), max_new_tokens=8, constrain=RX)
              for i in range(3)]
        drive(r)
        return record(r, hs, r._injector)
    finally:
        r.close()


def test_constrained_failover_matches_reference(cimpls):
    """A kill mid-constrained-decode: the failover hop folds the
    committed prefix into the prompt with ``consumed=`` and the target
    replays the DFA to the lost replica's state."""
    want = _constrained_failover(cimpls["jax"])
    got = _constrained_failover(cimpls["port"])
    assert got == want
    assert got["stats"]["failovers"] >= 1
    imp = cimpls["port"]
    eng = teng.InferenceEngine(imp.cfg, imp.build["params"],
                               imp.ec(max_new_tokens=8), device="cpu")
    for i, q in enumerate(got["requests"]):
        h = eng.submit(_prompt(6, i, 256), max_new_tokens=8, constrain=RX)
        eng.run_pending()
        assert q["status"] == "completed"
        assert q["tokens"] == h.generated.tolist()
        assert set(q["tokens"]) <= {ord("a"), ord("b")}


def test_constrained_submit_rejected_at_router(cimpls):
    for imp in cimpls.values():
        r = imp.router(n=1)
        try:
            with pytest.raises(Exception) as e:
                r.submit(_prompt(6, 0, 256), constrain="(a")
            assert type(e.value).__name__ == "ConstraintError"
            assert r.stats["dispatches"] == 0
        finally:
            r.close()


# ---------------------------------------------------------------------------
# prefix affinity and chain migration (tests/test_fleet_affinity.py)
# ---------------------------------------------------------------------------

SHARED = np.arange(16, dtype=np.int32)      # 4 full pages of 4


def _aff_prompt(i):
    return np.concatenate([SHARED,
                           np.asarray([5 + i, (7 + i) % 32], np.int32)])


def _affinity(imp, arm):
    ec = dict(decode_chunk=2, max_new_tokens=4, max_batch_size=1,
              num_slots=1, paged=True, page_size=4)
    fleet = dict(migrate_min_tokens=8)
    if arm == "anti_herd":
        ec.update(max_new_tokens=24, num_slots=2, max_batch_size=2)
        fleet.update(migrate_kv=False, affinity_max_occupancy=0.5)
    r = imp.router(n=2, ec=imp.ec(**ec), fleet=fleet)
    try:
        hs = [r.submit(_aff_prompt(0))]
        drive(r)
        if arm == "follow_cache":
            hs.append(r.submit(_aff_prompt(1)))
        elif arm == "migration":
            hs += [r.submit(_aff_prompt(1)), r.submit(_aff_prompt(2))]
        else:
            hs.append(r.submit(_aff_prompt(1), max_new_tokens=24))
            for _ in range(200):
                r.tick()
                if "dispatched" in hs[1].trace.kinds():
                    break
            hs.append(r.submit(_aff_prompt(2)))
        drive(r)
        rec = record(r, hs)
        rec["dispatch"] = [[(e.data["replica"], e.data["affinity_tokens"])
                            for e in h.trace.events
                            if e.kind == "dispatched"] for h in hs]
        rec["migrations"] = [e.data for h in hs for e in h.trace.events
                             if e.kind == "kv_migration"]
        rec["cache_hits"] = [int(c.replica.engine.registry.get(
            "serving_prefix_cache_hits").value) for c in r._ctls]
        return rec
    finally:
        r.close()


@pytest.mark.parametrize("arm", ["follow_cache", "migration", "anti_herd"])
def test_prefix_affinity_matches_reference(impls, arm):
    """The advertised radix-cache digests steer dispatch: a shared
    prompt follows the cache; under capacity pressure the chain migrates
    to the cold replica, which serves it as a prefix hit; the anti-herd
    cap spills past a warm replica at the occupancy cap."""
    want = _affinity(impls["jax"], arm)
    got = _affinity(impls["port"], arm)
    assert got == want
    first = got["dispatch"][0][0][0]
    st = got["stats"]
    assert all(q["status"] == "completed" for q in got["requests"])
    if arm == "follow_cache":
        assert got["dispatch"][1][0][0] == first
        assert got["dispatch"][1][0][1] >= SHARED.shape[0]
        assert st["affinity_hits"] == 1 and st["affinity_mispredicts"] == 0
    elif arm == "migration":
        assert st["kv_migrations_ok"] == 1
        assert st["kv_migrated_tokens"] >= SHARED.shape[0]
        assert len(got["migrations"]) == 1
        assert got["migrations"][0]["from"] == first
        assert got["cache_hits"][1 - first] >= 1
    else:
        assert got["dispatch"][1][0][0] == first
        assert got["dispatch"][2][0][0] == 1 - first


# ---------------------------------------------------------------------------
# observability, probes, devices
# ---------------------------------------------------------------------------

def _families(snap):
    return {name: (fam["kind"], sorted({k for s in fam["samples"]
                                        for k in s["labels"]}))
            for name, fam in snap.items()}


def test_fleet_metric_families_match_reference(impls):
    """After a kill and a hedge, the router registry's families equal
    the reference's (names, kinds, label names) and pass the lint."""
    snaps = {}
    texts = {}
    spec = dict(n=2, inj=dict(kill_at={2: 0}),
                fleet=dict(hedge=True, hedge_age_s=0.0,
                           tenant_max_concurrency=8,
                           overload_queue_depth=64),
                prompts=[_prompt(8, i) for i in range(4)],
                submit=dict(tenant="acme"))
    for name, imp in impls.items():
        _, r, _ = _plain(imp, **spec)
        snaps[name] = (jex.json_snapshot(r.registry) if name == "jax"
                       else json_snapshot(r.registry))
        texts[name] = (jex.prometheus_text(r.registry) if name == "jax"
                       else prometheus_text(r.registry))
    assert _families(snaps["port"]) == _families(snaps["jax"])
    assert chip_smoke.lint_exposition(texts["port"]) == []
    fams = _families(snaps["port"])
    assert fams["serving_fleet_hedges"][1] == ["outcome"]
    assert fams["serving_fleet_replicas"][1] == ["state"]
    counters = {n: sum(s["value"] for s in f["samples"])
                for n, f in snaps["port"].items() if f["kind"] == "counter"}
    jcounters = {n: sum(s["value"] for s in f["samples"])
                 for n, f in snaps["jax"].items() if f["kind"] == "counter"}
    assert counters == jcounters


def test_http_probes_and_router_endpoints(impls):
    """Per-replica MetricsServers put the probe on real HTTP; a killed
    replica's endpoint dies with it; the router's own server serves
    /healthz, /readyz, /debugz and the federated /metrics."""
    imp = impls["port"]
    r = imp.router(n=2, http_probes=True)
    srv = None
    try:
        assert all(c.replica.probe_url for c in r._ctls)
        h = r.submit(_prompt(8, 0), max_new_tokens=4)
        drive(r)
        assert h.status == "completed"
        srv = MetricsServer(r.registry, port=0, health=r.health,
                            ready=r.ready, debug=r.debugz,
                            snapshot=r.federate, slo=r.slo_report,
                            profilez=r.profilez)
        for path in ("/healthz", "/readyz", "/debugz", "/slo"):
            with urllib.request.urlopen(srv.url + path, timeout=10) as f:
                assert f.status == 200
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as f:
            text = f.read().decode()
        assert 'replica="0"' in text and 'tier="router"' in text
        assert chip_smoke.lint_exposition(text) == []
        code, body = r.profilez(0.01)     # no profile_dir: 503 each
        assert code == 503 and body["started"] == 0
        r._ctls[0].replica.kill()
        r.tick()
        states = {row["replica"]: row["state"]
                  for row in r.debugz()["replicas"]}
        assert states[0] in ("restarting", "dead")
        assert r.timeline()["traceEvents"]
    finally:
        if srv is not None:
            srv.stop()
        r.close()


def test_no_silent_cpu_fallback(impls):
    """Built without ``device=``, the router and its engines run on the
    card; with no card they raise instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    imp = impls["port"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.Router(cfg=imp.cfg, params=imp.build["params"],
                      num_replicas=1)
    with pytest.raises(ValueError):
        tfleet.Router(cfg=imp.cfg, device="cpu")

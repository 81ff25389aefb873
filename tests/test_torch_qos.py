"""Port parity: tenant QoS against JAX's engine.

The engine-side contracts of tests/test_serving_qos.py, each run on JAX's
engine and the port's (float32, one converted `init_params` tree, the
synchronous loop, where JAX refills a freed slot in the same tick as the
port) and compared: the validation of tenants, priorities and the QoS
knobs (types and words); weighted fair share converging to the weights
on the chunked and the paged chunked pool (the granted-token counters
equal JAX's, tick for tick); no starvation behind a hostile prefill; an
idle tenant's share rolling over; priority preemption of the lowest,
youngest resident with a token-exact resume; the per-tick eviction
budget; equal priorities never thrashing; the storm generator; debugz's
tenant and priority columns; `qos_control`; and QoS off leaving tokens,
program keys and the scrape as they were. The port's pipelined loop runs
the same schedules and is held to the synchronous results.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.parallel import failure as jfail  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.observability import (  # noqa: E402
    json_snapshot, prometheus_text)
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

# max_len 80: JAX's program caches are process-wide, and an AOT-loaded
# executable another test file leaves for the 64-position config of its
# own tests cannot serve this file's engines
FIELDS = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=80)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
SIDES = {"jax": jeng, "port": teng}
POOLS = {"chunked": {}, "paged": dict(paged=True, page_size=4)}


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


def _prompt(t0=8, seed=0):
    return (np.arange(t0, dtype=np.int32) * (seed + 3)) % FIELDS[
        "vocab_size"]


def _config(**kw):
    base = dict(decode_chunk=2, max_new_tokens=4, backoff_base_s=0.0,
                prefill_chunk=4, max_batch_size=2, pipeline=False)
    base.update(kw)
    return base


@pytest.fixture
def make(mesh1, jparams, tparams):
    """make(side, **config) -> one side's engine over `_config`."""
    def build(side, **kw):
        mod = SIDES[side]
        cfg = mod.EngineConfig(**_config(**kw))
        if side == "jax":
            return mod.InferenceEngine(JCFG, mesh1, jparams, cfg)
        return mod.InferenceEngine(TCFG, tparams, cfg, device="cpu")
    return build


def _solo(make, prompt, max_new):
    eng = make("port", max_new_tokens=max_new)
    h = eng.submit(prompt, max_new_tokens=max_new)
    eng.run_pending()
    return h.result(0)


def _granted(eng, tenant):
    return eng._m_qos_prefill_tokens.labels(tenant).value


def _events(h):
    drop = ("cost_flops", "cost_bytes")
    return [(e.kind, {k: v for k, v in e.data.items() if k not in drop})
            for e in h.trace.events]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

BAD_TENANTS = ("", "a" * 65, 'evil"', "two\nlines", "back\\slash",
               "bell\x07", 1.5, b"bytes", True, object())
BAD_PRIORITIES = (-1, 10, 1.0, "1", None, False)


def test_validate_tenant_priority_matches_jax():
    """Coerce or reject as JAX does, with JAX's words."""
    assert teng.MAX_PRIORITY == jeng.MAX_PRIORITY
    for args in ((None, 0), ("acme", 3), (42, 0)):
        assert teng.validate_tenant_priority(*args) == \
            jeng.validate_tenant_priority(*args)
    for args in ([(t, 0) for t in BAD_TENANTS]
                 + [("t", p) for p in BAD_PRIORITIES]):
        with pytest.raises(teng.QoSValidationError) as got:
            teng.validate_tenant_priority(*args)
        with pytest.raises(jeng.QoSValidationError) as want:
            jeng.validate_tenant_priority(*args)
        assert str(got.value) == str(want.value)
    assert issubclass(teng.QoSValidationError, ValueError)


def test_submit_validates_tenant_and_priority(make):
    eng = make("port")
    with pytest.raises(teng.QoSValidationError):
        eng.submit(_prompt(), tenant="bad\nid")
    with pytest.raises(teng.QoSValidationError):
        eng.submit(_prompt(), priority=teng.MAX_PRIORITY + 1)
    assert not eng._queue
    h = eng.submit(_prompt(), tenant=7, priority=2)
    assert (h.tenant, h.priority) == ("7", 2)
    assert _events(h)[0] == ("submit", {"prompt_tokens": 8,
                                        "max_new_tokens": 4,
                                        "deadline_s": None, "tenant": "7",
                                        "priority": 2})
    eng.run_pending()
    assert h.error is None


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=None, tenant_weights={"a": 1.0}),
    dict(tenant_weights={"a": 0.0}),
    dict(tenant_weights={"": 1.0}),
    dict(qos_default_weight=0.0),
    dict(preemption_budget=-1),
    dict(mode="batch", decode_chunk=0, prefill_chunk=None,
         preemption_budget=1),
], ids=["no-chunk", "zero-weight", "empty-key", "default-weight",
        "negative-budget", "batch"])
def test_qos_config_validation_matches_jax(make, kw):
    """Misconfigured QoS knobs fail at construction with JAX's type and
    words."""
    with pytest.raises(ValueError) as got:
        make("port", **kw)
    with pytest.raises(ValueError) as want:
        make("jax", **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# weighted fair share
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", sorted(POOLS))
def test_weighted_share_converges_like_jax(make, pool):
    """Two tenants at 3:1 saturating the pool with long prompts under a
    small budget: the granted-token ratio converges to the weights, with
    JAX's counters and deficits tick for tick, and everything
    completes with JAX's tokens."""
    hs, grants = {}, {}
    for side in SIDES:
        eng = make(side, max_batch_size=4, max_new_tokens=2,
                   tick_token_budget=8, **POOLS[pool],
                   tenant_weights={"gold": 3.0, "bronze": 1.0})
        hs[side] = []
        for i in range(2):
            hs[side].append(eng.submit(_prompt(48, i), tenant="gold"))
            hs[side].append(eng.submit(_prompt(48, 10 + i),
                                       tenant="bronze"))
        seq = []
        for _ in range(8):
            eng.tick()
            seq.append((_granted(eng, "gold"), _granted(eng, "bronze"),
                        eng.debugz()["qos"]["deficits"]))
        grants[side] = seq
        eng.run_pending()
    assert grants["port"] == grants["jax"]
    gold, bronze = grants["port"][-1][:2]
    assert 2.0 <= gold / bronze <= 4.0
    assert [h.result(0).tolist() for h in hs["port"]] == \
        [h.result(0).tolist() for h in hs["jax"]]


def _ticks_until_victim(make, side, weights, pool=None, **kw):
    eng = make(side, max_new_tokens=2, tick_token_budget=4,
               tenant_weights=weights, **(POOLS[pool] if pool else {}),
               **kw)
    hostile = eng.submit(_prompt(48, 1), tenant="hostile")
    victim = eng.submit(_prompt(8, 2), tenant="victim")
    for t in range(1, 64):
        eng.tick()
        if victim._prefill_pos >= victim._prefill_target:
            eng.run_pending()
            assert victim.error is None and hostile.error is None
            return t
    pytest.fail("victim never finished prefill")


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_no_starvation_like_jax(make, pool):
    """A small victim behind a hostile 48-token prefill reaches its first
    token within a few ticks under fair share, where oldest-first serves
    the hostile prompt whole first, tick for tick as JAX's engine."""
    fair = _ticks_until_victim(make, "port", {"victim": 1.0,
                                              "hostile": 1.0}, pool)
    assert fair == _ticks_until_victim(make, "jax", {"victim": 1.0,
                                                     "hostile": 1.0}, pool)
    assert fair <= 8
    fifo = _ticks_until_victim(make, "port", None, pool)
    assert fifo == _ticks_until_victim(make, "jax", None, pool) >= 12
    # the pipelined loop schedules the same prefill chunks
    assert _ticks_until_victim(make, "port", {"victim": 1.0,
                                              "hostile": 1.0}, pool,
                               pipeline=True) == fair


def test_idle_tenant_share_rolls_over(make):
    """One tenant backlogged: fair share gives it the whole budget (the
    idle tenant's deficit is dropped, not banked), tick for tick as
    QoS off."""
    def ticks(weights):
        eng = make("port", max_new_tokens=2, tick_token_budget=8,
                   tenant_weights=weights)
        h = eng.submit(_prompt(48, 3), tenant="solo")
        for t in range(1, 64):
            eng.tick()
            if h.done():
                assert h.error is None
                return t
        pytest.fail("request never completed")

    assert ticks({"solo": 1.0, "idle": 8.0}) == ticks(None)


# ---------------------------------------------------------------------------
# priority preemption
# ---------------------------------------------------------------------------

PREEMPT_POOLS = {"chunked": {}, "contiguous": dict(prefill_chunk=None),
                 "paged": dict(prefill_chunk=None, paged=True, page_size=4),
                 "paged_chunked": dict(paged=True, page_size=4)}


@pytest.mark.parametrize("pool", sorted(PREEMPT_POOLS))
@pytest.mark.parametrize("pipeline", [False, True], ids=["sync",
                                                         "pipelined"])
def test_priority_preempts_lowest_and_resumes_token_exact(make, pipeline,
                                                          pool):
    """A class-3 arrival with both slots held by class-0 requests evicts
    one (the youngest seat), seats at once, and the victim resumes from
    its committed prefix to the tokens of an uninterrupted run, on every
    pool; the synchronous loop's events and counters equal JAX's."""
    out = {}
    sides = ("jax", "port") if not pipeline else ("port",)
    for side in sides:
        eng = make(side, max_new_tokens=8, preemption_budget=1,
                   pipeline=pipeline, **PREEMPT_POOLS[pool])
        low = [eng.submit(_prompt(8, i), max_new_tokens=8, tenant="batch")
               for i in range(2)]
        eng.tick()
        hi = eng.submit(_prompt(8, 5), max_new_tokens=8, tenant="urgent",
                        priority=3)
        eng.tick()
        assert eng._m_qos_preemptions.labels("batch").value == 1
        evicted = [r for r in low if any(
            e.kind == "preempted" and e.data.get("reason") == "priority"
            for e in r.trace.events)]
        assert len(evicted) == 1 and evicted[0] is low[1]
        ev = next(e for e in evicted[0].trace.events
                  if e.kind == "preempted")
        assert ev.data["by"] == hi.rid
        eng.run_pending()
        for r in low + [hi]:
            assert r.error is None
            np.testing.assert_array_equal(
                r.result(0), _solo(make, r.prompt, 8))
        out[side] = (eng, low + [hi])
    if not pipeline:
        (je, jh), (te, th) = out["jax"], out["port"]
        assert [_events(h) for h in th] == [_events(h) for h in jh]
        assert te.stats["preempted"] == je.stats["preempted"] == 1


@pytest.mark.parametrize("pipeline", [False, True], ids=["sync",
                                                         "pipelined"])
def test_preemption_budget_bounds_evictions_per_tick(make, pipeline):
    """Two waiting class-5 requests against a full pool of class-0 ones:
    a budget of 1 evicts one resident a tick, and nothing is lost."""
    eng = make("port", max_new_tokens=8, preemption_budget=1,
               pipeline=pipeline)
    low = [eng.submit(_prompt(8, i), max_new_tokens=8) for i in range(2)]
    eng.tick()
    his = [eng.submit(_prompt(8, 7 + i), max_new_tokens=8, priority=5)
           for i in range(2)]
    eng.tick()
    assert eng._m_qos_preemptions.labels("default").value == 1
    eng.tick()
    assert eng._m_qos_preemptions.labels("default").value == 2
    eng.run_pending()
    for r in low + his:
        assert r.error is None
        np.testing.assert_array_equal(r.result(0),
                                      _solo(make, r.prompt, 8))


def test_equal_priority_never_thrashes(make):
    eng = make("port", max_new_tokens=4, preemption_budget=4)
    hs = [eng.submit(_prompt(8, i), priority=3) for i in range(5)]
    eng.run_pending()
    assert all(h.error is None for h in hs)
    assert eng._m_qos_preemptions.labels("default").value == 0


def test_higher_class_seats_first_fifo_within(make):
    """With preemption on, the queue serves the highest class first and
    FIFO within a class, as JAX's `_pop_request_locked` does."""
    order = {}
    for side in SIDES:
        eng = make(side, max_batch_size=1, preemption_budget=1,
                   prefill_chunk=None)
        hs = [eng.submit(_prompt(6, i), priority=p)
              for i, p in enumerate((0, 2, 1, 2, 0))]
        eng.run_pending()
        first = {h.rid: next(e.ts for e in h.trace.events
                             if e.kind == "admitted") for h in hs}
        order[side] = [rid - hs[0].rid for rid in sorted(first,
                                                         key=first.get)]
    assert order["port"] == order["jax"]


def test_storm_generator_equals_jax():
    a1, k1 = tfail.hostile_tenant_storm(ticks=40, kill_tick=7, slow_tick=3)
    a2, k2 = jfail.hostile_tenant_storm(ticks=40, kill_tick=7, slow_tick=3)
    assert [tuple(vars(a).values()) for a in a1] == \
        [tuple(vars(a).values()) for a in a2]
    assert k1 == k2
    for a, b in zip(a1[:12], a2):
        np.testing.assert_array_equal(tfail.storm_prompt(a, 32),
                                      jfail.storm_prompt(b, 32))
    assert tfail.hostile_tenant_storm(ticks=5) == \
        tfail.hostile_tenant_storm(ticks=5)
    with pytest.raises(ValueError):
        tfail.hostile_tenant_storm(ticks=0)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_storm_on_one_engine_loses_no_victim(make, pool):
    """The hostile storm through one engine with fair share and
    preemption: every victim completes (none lost), every request
    completes, and the port's tokens and counters equal JAX's."""
    arrivals, ik = tfail.hostile_tenant_storm(
        ticks=8, hostiles=2, flood_per_tick=1, victim_every=2,
        victim_prompt=8, victim_new=6, hostile_prompt=24, hostile_new=6)
    assert ik == {}
    res = {}
    for side in SIDES:
        eng = make(side, max_new_tokens=6, tick_token_budget=16,
                   max_queue=64, tenant_weights={"victim": 4.0},
                   preemption_budget=1, **POOLS[pool])
        pending, hs, tick = list(arrivals), [], 0
        while pending or not eng.drained():
            while pending and pending[0].tick <= tick:
                a = pending.pop(0)
                hs.append((a, eng.submit(tfail.storm_prompt(a, 32),
                                         max_new_tokens=a.max_new_tokens,
                                         tenant=a.tenant,
                                         priority=a.priority)))
            eng.tick()
            tick += 1
            assert tick < 500
        res[side] = (eng, hs)
    (je, jh), (te, th) = res["jax"], res["port"]
    assert all(h.error is None and h.generated.shape[0] == a.max_new_tokens
               for a, h in th)
    assert [h.generated.tolist() for _, h in th] == \
        [h.generated.tolist() for _, h in jh]
    js, ts = jex.json_snapshot(je.registry), json_snapshot(te.registry)
    for name in ("serving_qos_prefill_tokens", "serving_qos_preemptions",
                 "serving_requests_preempted"):
        assert ts[name]["samples"] == js[name]["samples"], name


# ---------------------------------------------------------------------------
# read-outs, the overload knobs, QoS off
# ---------------------------------------------------------------------------

def test_debugz_tenant_priority_columns_like_jax(make):
    d = {}
    for side in SIDES:
        eng = make(side, max_batch_size=1, preemption_budget=1,
                   tick_token_budget=8, tenant_weights={"a": 2.0})
        eng.submit(_prompt(8, 0), tenant="a", priority=1)
        eng.submit(_prompt(8, 1), tenant="b")
        eng.submit(_prompt(8, 2), tenant="b")
        eng.tick()
        d[side] = eng.debugz()
        eng.run_pending()
    t, j = d["port"], d["jax"]
    assert all({"tenant", "priority"} <= set(row)
               for row in t["slots"] + t["queue"])
    assert t["queue_by_tenant"] == j["queue_by_tenant"] == {"b": 2}
    assert t["qos"] == j["qos"]
    assert [(r["rid"], r["tenant"], r["priority"]) for r in t["slots"]] \
        == [(r["rid"], r["tenant"], r["priority"]) for r in j["slots"]]


def test_qos_control_keeps_tokens(make, tparams):
    """`qos_control` shrinks the decode chunk (a program key of its own)
    and restores it, and turns spec rounds off and on: committed tokens
    equal an untouched run's, and the knobs read back as JAX's."""
    ref = [_solo(make, _prompt(8, i), 10) for i in range(2)]
    for extra in ({}, dict(spec_decode=True, spec_k=3, draft="layers:1")):
        eng = make("port", max_new_tokens=10, decode_chunk=4,
                   prefill_chunk=None, **extra)
        hs = [eng.submit(_prompt(8, i), max_new_tokens=10)
              for i in range(2)]
        eng.tick()
        assert eng.qos_control(decode_chunk=2) == {
            "spec_off": False, "decode_chunk": 2, "base_decode_chunk": 4}
        if extra:
            eng.qos_control(spec_off=True)
            rounds = eng.counts["spec_rounds"]
        eng.tick()
        eng.tick()
        if extra:
            assert eng.counts["spec_rounds"] == rounds
            assert eng.debugz()["qos"]["spec_off"] is True
            eng.qos_control(spec_off=False)
        assert ("decode", 2) in eng._programs
        assert eng.qos_control(decode_chunk=0)["decode_chunk"] == 4
        assert eng.qos_control(decode_chunk=99)["decode_chunk"] == 4
        eng.run_pending()
        for h, want in zip(hs, ref):
            np.testing.assert_array_equal(h.result(0), want)
    j = make("jax", decode_chunk=4, prefill_chunk=None)
    assert j.qos_control(decode_chunk=2) == make(
        "port", decode_chunk=4, prefill_chunk=None).qos_control(
            decode_chunk=2)


def test_qos_off_bit_identical_no_new_program_keys(make):
    """An engine with QoS knobs at their defaults makes the programs a
    plain one makes and the same tokens; a QoS-on engine changes the
    schedule only, so its tokens match too."""
    ref = make("port")
    h = ref.submit(_prompt(24, 6))
    ref.run_pending()
    eng = make("port", qos_default_weight=1.0, preemption_budget=0)
    h2 = eng.submit(_prompt(24, 6))
    eng.run_pending()
    np.testing.assert_array_equal(h2.result(0), h.result(0))
    assert sorted(eng._programs) == sorted(ref._programs)
    qos = make("port", tick_token_budget=8, preemption_budget=1,
               tenant_weights={"gold": 3.0})
    hq = qos.submit(_prompt(24, 6), tenant="gold", priority=1)
    qos.run_pending()
    np.testing.assert_array_equal(hq.result(0), h.result(0))
    assert sorted(qos._programs) == sorted(ref._programs)


def test_qos_off_engine_has_no_qos_series(make):
    eng = make("port")
    h = eng.submit(_prompt(), tenant="t")
    eng.run_pending()
    assert h.error is None
    assert "qos" not in prometheus_text(eng.registry)
    assert "qos" not in eng.debugz()
    on = make("port", preemption_budget=1)
    assert "serving_qos_preemptions" in prometheus_text(on.registry)
    assert "serving_qos_prefill_tokens" not in prometheus_text(on.registry)

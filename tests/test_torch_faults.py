"""Port parity: the serving engine's fault handling against JAX's engine.

Every case runs one injector schedule through JAX's engine (1x1 mesh,
plain reference paths, DL4JTPU_FLASH unset) and the port's on the CPU,
both float32 from one JAX `init_params` tree converted with
`params_from_numpy`, each with its own package's `ServingFaultInjector`
(the port's is a copy, `deeplearning4j_tpu_torch.parallel.failure`).
Compared exactly: every handle's status and tokens, each request's
lifecycle events (kinds and payloads: retry steps, preemptions, the
scratch re-run's admission, quarantines), and the fault counters
(``retries``, ``step_failures``, ``quarantined``, ``preempted``,
``shed_deadline`` and ``serving_requests_shed{cancelled}``).

The contracts are JAX's (tests/test_serving_engine.py :121-304 and
:467-498, test_serving_continuous.py :264-455, test_serving_pipeline.py
:220-243, test_serving_paged.py :368-402, test_serving_spec.py :250,
test_serving_chunked.py :316-366 and :563, test_serving_spec_pipeline.py
:224): transient faults retry token-exact; a poisoned request is
quarantined alone while its co-residents complete from their committed
prefixes on the scratch pool; the breaker opens and recovers on an
injected clock; a pipelined tick that fails at its wait is recovered;
page corruption stays on the writer's page; a poisoned draft round
commits one verified token and drops K to 1. The pools and loops:
contiguous, paged, chunked, spec, int8 (weights and KV) and constrained,
each in the synchronous and the pipelined loop.

The port's own guarantees, which JAX's engine has no counterpart for, run
on the port alone: an isolation that cannot start still resolves every
handle; a dropped engine is freed by its last reference (its pools on
the card); a failed CUDA graph capture is not retried; chip_smoke.py's
zero-failure gate fires on facts a NULL_REGISTRY engine cannot zero and
on a worker thread's faults.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import failure as jfail  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

FIELDS = dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2, max_len=64)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
BASE = dict(decode_chunk=2, max_new_tokens=6, backoff_base_s=0.0)
SIDES = {"jax": (jeng, jfail), "port": (teng, tfail)}
FAULT_KEYS = ("retries", "step_failures", "quarantined", "preempted",
              "shed_deadline", "completed")
ARMS = {"contiguous": {},
        "paged": dict(paged=True, page_size=4),
        "chunked": dict(prefill_chunk=6),
        "spec": dict(spec_decode=True, spec_k=3, draft="layers:1"),
        "int8": dict(quantize="int8", kv_quantize="int8"),
        "constrained": {}}
LOOPS = pytest.mark.parametrize("pipeline", [False, True],
                                ids=["sync", "pipelined"])
ARM = pytest.mark.parametrize("arm", sorted(ARMS))


@pytest.fixture(autouse=True)
def _reference_paths(monkeypatch):
    monkeypatch.delenv("DL4JTPU_FLASH", raising=False)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_programs_left_behind():
    """JAX's program caches are process-wide, and this module's JAX
    engines share their geometry with tests/test_serving_constrained.py,
    whose constrain-off test counts its engine's own first compiles (and
    failed after this module on one worker): a later module on this
    worker starts from empty caches."""
    yield
    for c in jeng._ProgramLRU._instances:
        c.cache_clear()


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


@pytest.fixture
def make(mesh1, jparams, tparams):
    """make(side, inj=None, clock=None, **config) -> one side's engine."""
    def build(side, inj=None, clock=None, **kw):
        mod = SIDES[side][0]
        cfg = mod.EngineConfig(**{**BASE, **kw})
        extra = {} if clock is None else {"clock": clock}
        if side == "jax":
            return mod.InferenceEngine(JCFG, mesh1, jparams, cfg,
                                       fault_injector=inj, **extra)
        return mod.InferenceEngine(TCFG, tparams, cfg, device="cpu",
                                   fault_injector=inj, **extra)
    return build


def _prompt(t0=8, seed=0):
    return (np.arange(t0, dtype=np.int32) * (seed + 3)) % 50


def _prompts(arm):
    """Three requests of different lengths (a constrained arm: two under
    ``[ab]+``, one free)."""
    spec = [("[ab]+" if arm == "constrained" and k != 1 else None)
            for k in range(3)]
    return [(_prompt(n, k), c) for k, (n, c) in
            enumerate(zip((8, 12, 10), spec))]


def _submit(eng, reqs, **kw):
    return [eng.submit(p, constrain=c, **kw) for p, c in reqs]


def _events(h):
    """A request's lifecycle events, the ``retry`` events (recorded at
    the call) apart from the rest: the port's synchronous loop commits at
    the tick's end, JAX's after each call, so a decode call's retry can
    come before or after the admission prefill's commit."""
    drop = ("cost_flops", "cost_bytes")
    evs = [(e.kind, {k: v for k, v in e.data.items() if k not in drop})
           for e in h.trace.events]
    return ([e for e in evs if e[0] != "retry"],
            [e for e in evs if e[0] == "retry"])


def _shed_cancelled(eng):
    return int(eng.registry.get("serving_requests_shed")
               .labels("cancelled").value)


def _facts(eng, hs):
    return ([h.status for h in hs], [h.generated.tolist() for h in hs],
            {k: eng.stats[k] for k in FAULT_KEYS}, _shed_cancelled(eng))


def both(make, scenario, inj_kw=None, events=True, **cfg):
    """``scenario(eng, inj, side) -> handles`` on JAX's engine and the
    port's, each with its own injector built from ``inj_kw`` (None: no
    injector); asserts the two agree and returns {side: (eng, inj, hs)}."""
    out = {}
    for side, (_, fmod) in SIDES.items():
        inj = (None if inj_kw is None
               else fmod.ServingFaultInjector(**inj_kw))
        eng = make(side, inj=inj, **cfg)
        out[side] = (eng, inj, scenario(eng, inj, side))
    (je, _, jh), (te, _, th) = out["jax"], out["port"]
    assert _facts(te, th) == _facts(je, jh)
    if events:
        for a, b in zip(jh, th):
            assert _events(b) == _events(a), a.rid
    return out


def _clean(make, arm, pipeline, reqs, **kw):
    """The port's fault-free run of ``reqs``: tokens per request."""
    eng = make("port", **ARMS[arm], pipeline=pipeline, **kw)
    hs = _submit(eng, reqs)
    eng.run_pending()
    return [h.generated.tolist() for h in hs]


def _no_leak(eng):
    if eng.config.paged:
        assert eng.counts["pages_used"] == eng.prefix_cache_pages
    assert eng.drained() and not eng._pending
    assert eng._scratch is None


# ---------------------------------------------------------------------------
# transient faults: retried with backoff, token-exact
# ---------------------------------------------------------------------------

@ARM
@LOOPS
def test_transient_faults_retried_token_exact(make, arm, pipeline):
    """JAX :121 / :142 / test_serving_pipeline.py :220: two transient
    faults (and on the chunked arm a chunk-call fault) are retried at the
    same step index; every request completes with its fault-free tokens,
    and the breaker ends closed."""
    reqs = _prompts(arm)
    inj_kw = dict(fail_at=[1, 3])
    if arm == "chunked":
        inj_kw["prefill_chunk_fail_at"] = [0]

    def scenario(eng, inj, side):
        hs = _submit(eng, reqs)
        eng.run_pending()
        return hs

    out = both(make, scenario, inj_kw, **ARMS[arm], pipeline=pipeline)
    eng, inj, hs = out["port"]
    n = 3 if arm == "chunked" else 2
    assert inj.injected == n
    assert eng.stats["retries"] == eng.stats["step_failures"] == n
    assert eng.health()["breaker"] == "closed"
    assert [h.generated.tolist() for h in hs] == \
        _clean(make, arm, pipeline, reqs)
    retry = [e for e in hs[0].trace.events if e.kind == "retry"]
    assert retry and retry[0].data["step"] in (0, 1)
    _no_leak(eng)


# ---------------------------------------------------------------------------
# a poisoned request: isolation on the scratch pool, quarantine
# ---------------------------------------------------------------------------

@ARM
@LOOPS
def test_poisoned_request_quarantined_peers_exact(make, arm, pipeline):
    """JAX :163 / test_serving_continuous.py :264 / test_serving_pipeline.py
    :229: the pool call fails for good, every resident is preempted to
    a solo re-run on the scratch pool, the poisoned request alone is
    quarantined, the others complete with their fault-free tokens, and
    the engine serves the next request. A constrained arm's scratch DFA
    vector leaves the live pool's states as they were."""
    reqs = _prompts(arm)
    live = []

    def scenario(eng, inj, side):
        hs = _submit(eng, reqs)
        inj.poison_requests.add(hs[1].rid)
        if side == "port" and arm == "constrained":
            orig = eng._run_isolated

            def watched(r):
                cs = eng._cstate
                before = cs.clone()
                orig(r)
                live.append(eng._cstate is cs and torch.equal(cs, before))
            eng._run_isolated = watched
        eng.run_pending()
        hs.append(eng.submit(_prompt(9, 7)))
        eng.run_pending()
        return hs

    out = both(make, scenario, {}, **ARMS[arm], pipeline=pipeline,
               max_retries=1)
    eng, _, hs = out["port"]
    assert [h.status for h in hs] == ["completed", "quarantined",
                                      "completed", "completed"]
    with pytest.raises(teng.RequestQuarantined):
        hs[1].result(0)
    assert eng.stats["quarantined"] == 1
    assert eng.stats["preempted"] == 3
    clean = _clean(make, arm, pipeline, reqs)
    assert [hs[0].generated.tolist(), hs[2].generated.tolist()] == \
        [clean[0], clean[2]]
    assert eng.scratch_pool_bytes == teng.slot_pool_bytes(
        TCFG, eng.num_slots, kv_mode=eng._kv_mode)
    if arm == "constrained":
        assert live and all(live)
        assert eng.counts["constrained_illegal"] == 0
    _no_leak(eng)


def test_quarantine_only_after_max_retries(make):
    """JAX :188: a poisoned request is retried max_retries times in the
    pool, then once plus max_retries alone, before it is quarantined."""
    def scenario(eng, inj, side):
        h = eng.submit(_prompt())
        inj.poison_requests.add(h.rid)
        eng.run_pending()
        return [h]

    out = both(make, scenario, {}, max_retries=2)
    eng, inj, (h,) = out["port"]
    assert h.status == teng.RequestStatus.QUARANTINED
    assert inj.injected == 6 and eng.stats["retries"] == 4


@LOOPS
def test_mid_stream_poison_keeps_committed_prefix(make, pipeline):
    """test_serving_continuous.py :293: a request poisoned after its
    neighbour committed a chunk; the neighbour resumes solo from its
    committed prefix, token-exact against the fault-free run."""
    def scenario(eng, inj, side):
        good = eng.submit(_prompt())
        bad = eng.submit(_prompt(12, 2))
        for _ in range(4):
            eng.tick()
            committed = good.generated.copy()
            if committed.shape[0] > 0:
                break
        assert committed.shape[0] > 0
        inj.poison_requests.add(bad.rid)
        eng.run_pending()
        np.testing.assert_array_equal(
            good.generated[:committed.shape[0]], committed)
        return [good, bad]

    out = both(make, scenario, {}, max_new_tokens=10, max_retries=1,
               pipeline=pipeline)
    eng, _, (good, bad) = out["port"]
    assert bad.status == "quarantined" and good.status == "completed"
    assert eng.stats["preempted"] == 2
    ref = make("port", max_new_tokens=10, pipeline=pipeline)
    h = ref.submit(_prompt())
    ref.run_pending()
    assert good.generated.tolist() == h.generated.tolist()


def test_prefill_fault_knob_transient_and_persistent(make):
    """test_serving_continuous.py :326: ``prefill_fail_at`` transient is
    retried; persistent on every step quarantines the admission (its solo
    prefill fails too), and once cleared the engine serves."""
    def transient(eng, inj, side):
        h = eng.submit(_prompt())
        eng.run_pending()
        return [h]

    out = both(make, transient, dict(prefill_fail_at=[0]))
    eng, inj, (h,) = out["port"]
    assert h.status == "completed" and inj.prefills_failed == 1
    assert eng.stats["retries"] == 1

    def persistent(eng, inj, side):
        ok = eng.submit(_prompt(8, 1))
        eng.tick()
        inj.prefill_fail_at.clear()
        ok2 = eng.submit(_prompt(8, 2))
        eng.run_pending()
        return [ok, ok2]

    out = both(make, persistent, dict(prefill_fail_at=range(100),
                                      persistent=True),
               max_retries=1, max_new_tokens=12,
               breaker_failure_threshold=100)
    eng, inj, (ok, ok2) = out["port"]
    assert ok.status == "quarantined" and ok2.status == "completed"
    assert inj.prefills_failed >= 2


# ---------------------------------------------------------------------------
# the circuit breaker, on an injected clock
# ---------------------------------------------------------------------------

def test_circuit_breaker_opens_and_recovers(make):
    """JAX :264, on an injected clock instead of a sleep: a systemic
    persistent fault quarantines, opens the breaker (not ready, submit
    refused); once the cooldown has passed on the clock the probe
    admission is half-open, and its completed call closes the breaker."""
    def scenario(eng, inj, side):
        t = clocks[side]
        h = eng.submit(_prompt())
        eng.run_pending()
        got = [h.status, eng.health()["breaker"], eng.ready()]
        with pytest.raises(SIDES[side][0].OverloadError,
                           match="circuit breaker"):
            eng.submit(_prompt())
        t["now"] += 0.06
        inj.fail_at.clear()
        probe = eng.submit(_prompt())
        got.append(eng.health()["breaker"])
        eng.run_pending()
        got += [probe.status, eng.health()["breaker"], eng.ready()]
        states[side] = got
        return [h, probe]

    clocks = {s: {"now": 0.0} for s in SIDES}
    states = {}
    out = {}
    for side, (_, fmod) in SIDES.items():
        inj = fmod.ServingFaultInjector(fail_at=range(100), persistent=True)
        eng = make(side, inj=inj, clock=lambda t=clocks[side]: t["now"],
                   max_retries=1, breaker_failure_threshold=3,
                   breaker_cooldown_s=0.05)
        out[side] = (eng, scenario(eng, inj, side))
    assert states["port"] == ["quarantined", "open", False, "half-open",
                              "completed", "closed", True]
    assert states["port"] == states["jax"]
    assert _facts(*out["port"]) == _facts(*out["jax"])
    eng = out["port"][0]
    gauge = eng.registry.get("serving_breaker_state")
    assert gauge.value == 0.0 and eng.stats["shed_overload"] == 1


def test_degraded_cap_by_queue_depth_and_breaker(make):
    """JAX :304: past the queue watermark an admission gets the degraded
    token cap; while the breaker is half-open so does every admission."""
    def scenario(eng, inj, side):
        t = clocks[side]
        a = eng.submit(_prompt(8, 1))
        eng.submit(_prompt(8, 2))
        assert eng.health()["degraded"]
        c = eng.submit(_prompt(8, 3))
        assert (a.max_new_tokens, c.max_new_tokens) == (6, 2)
        eng.run_pending()
        assert not eng.health()["degraded"]
        bad = eng.submit(_prompt(8, 4))
        inj.poison_requests.add(bad.rid)
        eng.run_pending()
        t["now"] += 1.0
        inj.poison_requests.clear()
        d = eng.submit(_prompt(8, 5))
        caps[side] = (bad.status, eng.health()["breaker"],
                      d.max_new_tokens)
        eng.run_pending()
        return [a, c, bad, d]

    clocks = {s: {"now": 0.0} for s in SIDES}
    caps = {}
    for side, (_, fmod) in SIDES.items():
        inj = fmod.ServingFaultInjector()
        eng = make(side, inj=inj, clock=lambda t=clocks[side]: t["now"],
                   degrade_queue_depth=2, degraded_max_new_tokens=2,
                   max_queue=16, max_retries=0,
                   breaker_failure_threshold=1, breaker_cooldown_s=0.5)
        scenario(eng, inj, side)
    assert caps["port"] == ("quarantined", "half-open", 2)
    assert caps["port"] == caps["jax"]


# ---------------------------------------------------------------------------
# a pipelined tick that fails at its wait
# ---------------------------------------------------------------------------

def _fail_wait_once(eng, side, when):
    """Make the pipelined commit's wait (the port's `_wait`, JAX's
    `_block_on_many`) raise once, the first time ``when(eng)`` holds."""
    name = "_wait" if side == "port" else "_block_on_many"
    orig = getattr(eng, name)
    fired = []

    def flaky(x):
        if not fired and when(eng):
            fired.append(True)
            raise RuntimeError("injected sync-time device failure")
        return orig(x)

    setattr(eng, name, flaky)
    return fired


def _ticks(eng):
    if isinstance(eng, teng.InferenceEngine):
        return eng.counts["pipelined_ticks"]
    return eng._m_batches.value


@ARM
def test_sync_time_failure_recovers_token_exact(make, arm):
    """test_serving_pipeline.py :243: the commit's wait fails after the
    next tick has dispatched; both ticks are dropped, the prefix cache is
    flushed and every request of theirs re-runs solo from its committed
    prefix: all complete token-exact, nothing is left pending."""
    reqs = _prompts(arm) + [(_prompt(5, 4), None)]

    def scenario(eng, inj, side):
        fired = _fail_wait_once(eng, side, lambda e: _ticks(e) >= 3)
        hs = _submit(eng, reqs)
        eng.run_pending()
        assert fired
        return hs

    out = both(make, scenario, None, **ARMS[arm], pipeline=True,
               num_slots=4, max_new_tokens=8)
    eng, _, hs = out["port"]
    assert all(h.status == "completed" for h in hs)
    assert eng.stats["preempted"] > 0 and not eng._pending
    assert [h.generated.tolist() for h in hs] == \
        _clean(make, arm, True, reqs, num_slots=4, max_new_tokens=8)
    _no_leak(eng)


def test_sync_failure_with_a_poisoned_round_in_flight(make):
    """test_serving_spec_pipeline.py :224: a poisoned draft round is in
    flight when the previous round's wait fails; the recovery drops it,
    so every committed prefix is a prefix of the clean stream, and the
    solo re-runs finish token-exact."""
    prompts = [_prompt(6, s) for s in range(3)]
    cfg = dict(spec_decode=True, spec_k=4, draft="self", pipeline=True,
               max_new_tokens=11)
    ref = make("port", **{**cfg, "pipeline": False})
    want = [ref.submit(p) for p in prompts]
    ref.run_pending()

    def scenario(eng, inj, side):
        fired = _fail_wait_once(eng, side,
                                lambda e: inj.drafts_poisoned > 0)
        hs = [eng.submit(p) for p in prompts]
        while not fired and eng.tick():
            pass
        assert fired
        for h, w in zip(hs, want):
            g = h.generated.tolist()
            assert g == w.generated.tolist()[:len(g)]
        assert not eng._pending
        eng.run_pending()
        return hs

    out = both(make, scenario, dict(draft_poison_at={2: 1}), **cfg)
    eng, _, hs = out["port"]
    assert [h.generated.tolist() for h in hs] == \
        [w.generated.tolist() for w in want]
    assert eng.stats["preempted"] > 0


# ---------------------------------------------------------------------------
# the injector's device hooks: page corruption and draft poison
# ---------------------------------------------------------------------------

def test_quarantine_never_frees_shared_pages(make):
    """test_serving_paged.py :368: a reader and a poisoned writer share a
    cached prefix; the writer is quarantined, the reader completes
    exactly, and a later request still hits the prefix: the quarantine
    released only the writer's references (no page leaks)."""
    p = _prompt(26, 7)
    cont = make("port", max_new_tokens=8)
    w = cont.submit(p)
    cont.run_pending()

    def scenario(eng, inj, side):
        seed_req = eng.submit(p)
        eng.run_pending()
        a = eng.submit(p)
        bad = eng.submit(p)
        inj.poison_requests.add(bad.rid)
        eng.run_pending()
        c = eng.submit(p)
        eng.run_pending()
        adm = [e for e in c.trace.events if e.kind == "admitted"][0]
        assert adm.data["prefix_hit_tokens"] > 0
        return [seed_req, a, bad, c]

    out = both(make, scenario, {}, paged=True, page_size=4,
               max_new_tokens=8, max_retries=1)
    eng, _, hs = out["port"]
    assert [h.status for h in hs] == ["completed", "completed",
                                      "quarantined", "completed"]
    for h in (hs[0], hs[1], hs[3]):
        assert h.generated.tolist() == w.generated.tolist()
    _no_leak(eng)


@LOOPS
def test_corrupt_page_lands_on_the_writer_only(make, pipeline):
    """test_serving_paged.py :402: ``corrupt_page_at`` poisons the
    writer's next-write page mid-stream (its own page, after the
    copy-on-write guard): the writer's tokens change, the reader sharing
    its prefix and every later reader stay exact."""
    p = _prompt(26, 7)
    clean = make("port", max_new_tokens=8)
    w = clean.submit(p)
    clean.run_pending()

    def scenario(eng, inj, side):
        seed_req = eng.submit(p)
        eng.run_pending()
        reader = eng.submit(p)
        writer = eng.submit(p)
        eng.tick()
        inj.corrupt_page_at[eng._step_counter] = writer.rid
        eng.run_pending()
        assert inj.pages_corrupted == 1
        later = eng.submit(p)
        eng.run_pending()
        return [seed_req, reader, writer, later]

    # JAX's paged suite's page size: the poisoned page then also holds
    # committed rows (26, 27), which the writer's next calls attend
    out = both(make, scenario, dict(corrupt_page_at={}), paged=True,
               page_size=8, max_new_tokens=8, pipeline=pipeline)
    eng, _, hs = out["port"]
    assert hs[2].status == "completed"
    assert hs[2].generated.tolist() != w.generated.tolist()
    for h in (hs[0], hs[1], hs[3]):
        assert h.generated.tolist() == w.generated.tolist()
    _no_leak(eng)


@LOOPS
def test_draft_poison_never_corrupts_committed_kv(make, pipeline):
    """test_serving_spec.py :250: the round at the poisoned step commits
    exactly its verified correction token (a ``draft_rejected`` event
    with ``poisoned``), K falls to 1, and the stream equals the plain
    engine's."""
    plain = make("port", max_new_tokens=11)
    want = plain.submit(_prompt())
    plain.run_pending()

    def scenario(eng, inj, side):
        h = eng.submit(_prompt())
        eng.tick()
        assert inj.drafts_poisoned == 1
        if pipeline:
            eng.tick()
        ev = [e for e in h.trace.events if e.kind == "draft_rejected"]
        assert len(ev) == 1 and ev[0].data["poisoned"] is True
        assert ev[0].data["drafted"] == 4
        chunk = [e for e in h.trace.events if e.kind == "decode_chunk"][0]
        assert chunk.data["accepted"] == 0 and chunk.data["tokens"] == 1
        assert eng.debugz()["spec"]["k"] == 1
        eng.run_pending()
        return [h]

    out = both(make, scenario, dict(draft_poison_at={1: 1}),
               spec_decode=True, spec_k=4, draft="self", max_new_tokens=11,
               pipeline=pipeline)
    assert out["port"][2][0].generated.tolist() == want.generated.tolist()


# ---------------------------------------------------------------------------
# chunked prefill: faults mid-prefill
# ---------------------------------------------------------------------------

def test_mid_prefill_chunk_fault_retries_same_chunk(make):
    """test_serving_chunked.py :316: a transient chunk-call fault retries
    the same chunk (same step index, ``retry{prefill}``), token-exact."""
    def scenario(eng, inj, side):
        h = eng.submit(_prompt(24))
        eng.run_pending()
        return [h]

    out = both(make, scenario, dict(prefill_chunk_fail_at=[1]),
               prefill_chunk=8)
    eng, inj, (h,) = out["port"]
    assert inj.prefill_chunks_failed == 1 and eng.stats["retries"] == 1
    assert any(e.kind == "retry" and e.data["prefill"]
               for e in h.trace.events)
    assert h.generated.tolist() == _clean(
        make, "contiguous", True, [(_prompt(24), None)])[0]


def test_mid_prefill_poison_spares_the_decoders(make):
    """test_serving_chunked.py :334: a request poisoned mid-prefill fails
    only its chunk calls (a prefilling slot is in no decode call); it is
    quarantined and the decoding request completes without a retry."""
    def scenario(eng, inj, side):
        good = eng.submit(_prompt(6, 1), max_new_tokens=12)
        eng.tick()
        bad = eng.submit(_prompt(40, 2), max_new_tokens=4)
        inj.poison_requests.add(bad.rid)
        eng.run_pending()
        return [good, bad]

    out = both(make, scenario, {}, prefill_chunk=4, tick_token_budget=6,
               max_new_tokens=12, max_retries=1, num_slots=4)
    eng, _, (good, bad) = out["port"]
    assert (good.status, bad.status) == ("completed", "quarantined")
    assert {"preempted", "quarantined"} <= set(bad.trace.kinds())
    assert not any(e.kind == "retry" for e in good.trace.events)


def test_mid_prefill_persistent_chunk_fault_recovers_solo(make):
    """test_serving_chunked.py :366: with every chunk call failing the
    pooled prefill never advances, but the solo re-run's one-shot prefill
    is not a chunk call: the request completes token-exact."""
    def scenario(eng, inj, side):
        h = eng.submit(_prompt(24))
        eng.run_pending()
        return [h]

    out = both(make, scenario, dict(prefill_chunk_fail_at=range(1000),
                                    persistent=True),
               prefill_chunk=8, max_retries=1,
               breaker_failure_threshold=100)
    eng, inj, (h,) = out["port"]
    assert h.status == "completed" and eng.stats["preempted"] == 1
    assert h.generated.tolist() == _clean(
        make, "contiguous", True, [(_prompt(24), None)])[0]


# ---------------------------------------------------------------------------
# the per-call snapshot of the in-place pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["contiguous", "constrained"])
def test_retry_after_the_call_ran_restores_the_slot_state(make, arm):
    """The port's pool is updated in place: a call that fails after its
    program ran (here the synchronous loop's wait, once) has advanced
    pos and tok (and the DFA states); the retry starts from the snapshot
    and the tokens equal the fault-free run's. The snapshot holds only
    the per-slot vectors."""
    reqs = _prompts(arm)
    eng = make("port", **ARMS[arm], pipeline=False)
    fired = _fail_wait_once(eng, "port", lambda e: e._step_counter == 2)
    hs = _submit(eng, reqs)
    eng.run_pending()
    assert fired and eng.stats["retries"] == 1
    assert [h.generated.tolist() for h in hs] == \
        _clean(make, arm, False, reqs)
    per = 3 if arm == "constrained" else 2
    assert eng.fault_snapshot_bytes == per * 4 * eng.num_slots


# ---------------------------------------------------------------------------
# the port's own guarantees: handles resolve, memory frees, captures stop
# ---------------------------------------------------------------------------

@LOOPS
def test_isolation_that_cannot_start_still_resolves_every_handle(
        make, pipeline, monkeypatch):
    """A poisoned request sends its co-residents to isolation, whose
    scratch pool cannot be allocated (an out-of-memory error outside the
    guard). The error propagates, and every evicted request, in no slot
    any more, is quarantined first: no result() waits forever."""
    inj = tfail.ServingFaultInjector()
    eng = make("port", inj=inj, pipeline=pipeline)
    hs = _submit(eng, _prompts("contiguous"))
    eng.tick()
    inj.poison_requests.add(hs[1].rid)

    def no_memory(*a, **kw):
        raise torch.cuda.OutOfMemoryError("scratch pool: out of memory")

    monkeypatch.setattr(teng, "init_slot_state", no_memory)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.run_pending()
    assert all(h.done() for h in hs)
    assert [h.status for h in hs] == ["quarantined"] * 3
    for h in hs:
        with pytest.raises(teng.RequestQuarantined,
                           match="could not be re-run alone"):
            h.result(timeout=0)
    assert eng.stats["quarantined"] == 3 and eng._scratch is None
    assert all(s is None for s in eng._slots)


@pytest.mark.parametrize("arm", sorted(ARMS) + ["pipelined_worker"])
def test_dropped_engine_is_freed_by_its_last_reference(tparams, arm):
    """With the cyclic collector off, an engine that served, isolated
    and quarantined a request (and ran its worker thread) is freed when
    its last reference goes, while its handles live on: the registry's
    gauges and the read-outs hold it weakly and a finished handle drops
    its terminal hook. On the card this frees its pool and graphs at
    once. A registry shared with a dropped engine reads its gauges as
    0."""
    import gc
    import weakref
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    reg = MetricsRegistry()
    inj = tfail.ServingFaultInjector()
    kw = ARMS.get(arm, {})
    gc.disable()
    try:
        eng = teng.InferenceEngine(TCFG, tparams, teng.EngineConfig(
            **{**BASE, **kw}), device="cpu", fault_injector=inj,
            registry=reg)
        hs = _submit(eng, _prompts(arm))
        eng.tick()
        inj.poison_requests.add(hs[1].rid)
        if arm == "pipelined_worker":
            eng.start()
            hs[0].result(timeout=60)
            eng.stop()
        else:
            eng.run_pending()
        assert hs[1].status == "quarantined" and eng.stats["preempted"]
        assert eng.counts["pipelined_ticks"] >= 0 and eng.health()
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        gc.enable()
    assert reg.get("serving_queue_depth").value == 0.0
    assert [h.status for h in hs].count("completed") == 2


class _Counter:
    def __init__(self):
        self.value = 0

    def inc(self, n=1):
        self.value += n


@LOOPS
def test_failed_graph_capture_is_not_retried(make, pipeline, monkeypatch):
    """A CUDA graph capture that fails (here out of memory, as seen on
    the card mid-capture) raises GraphCaptureError past the guard: no
    retry into the allocator's state, no preemption, no quarantine."""
    from deeplearning4j_tpu_torch.serving import graphs
    eng = make("port", pipeline=pipeline)
    eng._graphs = graphs.SlotGraphs(torch.device("cpu"), _Counter(),
                                    _Counter(), _Counter())

    def no_memory(*a, **kw):
        raise torch.cuda.OutOfMemoryError("out of memory mid-capture")

    monkeypatch.setattr(graphs.SlotGraphs, "_capture", no_memory)
    _submit(eng, _prompts("contiguous"))
    with pytest.raises(graphs.GraphCaptureError,
                       match="capture of slot program") as got:
        eng.run_pending()
    assert isinstance(got.value.__cause__, torch.cuda.OutOfMemoryError)
    assert {k: eng.stats[k] for k in ("retries", "step_failures",
                                      "quarantined", "preempted")} == \
        dict.fromkeys(("retries", "step_failures", "quarantined",
                       "preempted"), 0)


def test_graph_capture_runs_with_the_collector_off(monkeypatch):
    """A CUDA graph freed during another's capture invalidates it (seen
    on the card: a dropped engine's graph reached by the cyclic
    collector mid-capture). `_capture` collects first and holds the
    collector off while it captures; torch.cuda's graph, stream and pool
    are stand-ins here, on the CPU."""
    import gc
    import weakref
    from deeplearning4j_tpu_torch.serving import graphs

    class Stub:
        def __init__(self, *a, **kw):
            pass

        def capture_begin(self, pool=None):
            pass

        def capture_end(self):
            pass

        def wait_stream(self, other):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    for name, value in (("CUDAGraph", Stub), ("Stream", Stub),
                        ("graph_pool_handle", lambda: object()),
                        ("current_stream", lambda d=None: Stub()),
                        ("stream", lambda s: Stub()),
                        ("memory_reserved", lambda d=None: 0)):
        monkeypatch.setattr(torch.cuda, name, value)

    class Cycle:
        pass
    c = Cycle()
    c.me = c
    dead = weakref.ref(c)
    del c
    seen = {}
    pool = torch.zeros(2)

    def program(state, x, seed):
        seen.update(collecting=gc.isenabled(), freed=dead() is None)
        return (state,)

    sg = graphs.SlotGraphs(torch.device("cpu"), _Counter(), _Counter(),
                           _Counter())
    assert gc.isenabled()
    sg._capture(program, (pool,), (torch.ones(1),), 0)
    assert seen == {"collecting": False, "freed": True}
    assert gc.isenabled()


def test_serving_loops_script_draws_phase_3_traffic(monkeypatch):
    """benchmarks/serving_loops.py (the guard's cost beside the parent,
    on the card) serves phase 3's 128 requests and, without a card,
    exits 2 before it measures anything."""
    from deeplearning4j_tpu_torch.benchmarks import serving_loops as sl
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, size=128)
    want = [rng.integers(0, 256, size=int(n)) for n in lens]
    got = sl.traffic(np)
    assert len(got) == 128 and all(
        a.dtype == np.int32 and np.array_equal(a, b)
        for a, b in zip(got, want))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["serving_loops.py"])
    assert sl.main() == 2


# ---------------------------------------------------------------------------
# chip_smoke.py's zero-failure gate, on the CPU
# ---------------------------------------------------------------------------

def _gate(monkeypatch):
    """chip_smoke's gate installed on a subclass of the port's engine
    (the class itself stays as it is), with a fresh record."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "ZERO_FAULT_SEEN", [])

    class Gated(teng.InferenceEngine):
        pass

    chip_smoke.install_zero_fault_gate(Gated)
    return chip_smoke, Gated


def _fail_first_call(eng):
    """The engine's first decode-chunk call raises once (as a kernel
    launch that fails, then succeeds on the retry)."""
    program, fired = eng._program, []

    def prog(kind, size):
        fn = program(kind, size)

        def run(*a):
            if kind.startswith("decode") and not fired:
                fired.append(kind)
                raise RuntimeError("CUDA error: unspecified launch failure")
            return fn(*a)
        return run
    eng._program = prog
    return fired


@pytest.mark.parametrize("how", ["null_registry", "worker", "failed_wait",
                                 "clean"])
def test_zero_fault_gate_reads_facts_not_counters(tparams, how,
                                                   monkeypatch):
    """The gate fires on a fault the engine retried on a NULL_REGISTRY
    engine, whose fault counters read 0; on one the worker thread hit,
    without ending that thread (the phase's check after `stop()` fails
    the run); and on a pipelined wait that failed and isolated. An
    engine that served without a fault passes it."""
    from deeplearning4j_tpu_torch.observability import NULL_REGISTRY
    cs, Gated = _gate(monkeypatch)
    kw = {"registry": NULL_REGISTRY} if how == "null_registry" else {}
    eng = Gated(TCFG, tparams, teng.EngineConfig(**BASE), device="cpu",
                **kw)
    if how in ("null_registry", "worker"):
        _fail_first_call(eng)
    elif how == "failed_wait":
        _fail_wait_once(eng, "port", lambda e: True)
    hs = _submit(eng, _prompts("contiguous"))
    if how == "worker":
        eng.start()
        for h in hs:
            h.result(timeout=60)
        assert eng._thread.is_alive()
        assert eng.stats["retries"] == 1 and len(cs.ZERO_FAULT_SEEN) == 1
        with pytest.raises(SystemExit):      # stop()'s drain ticks here
            eng.stop()
        assert eng._thread is None
        with pytest.raises(SystemExit):
            cs.check_zero_fault_gate("after the worker stopped")
        return
    if how == "clean":
        eng.run_pending()
        cs.check_zero_fault_gate("end")
        assert cs.ZERO_FAULT_SEEN == []
        return
    with pytest.raises(SystemExit):
        eng.run_pending()
    assert cs.ZERO_FAULT_SEEN
    if how == "null_registry":
        assert eng.stats["retries"] == eng.stats["step_failures"] == 0


# ---------------------------------------------------------------------------
# the injector's semantics (the port's copy against JAX's)
# ---------------------------------------------------------------------------

def _delay_one_shot(f):
    inj = f.ServingFaultInjector(delay_at={0: 0.02})
    import time
    t0 = time.perf_counter()
    inj.on_decode_step(0)
    first = time.perf_counter() - t0 >= 0.02
    t0 = time.perf_counter()
    inj.on_decode_step(0)
    return first, time.perf_counter() - t0 < 0.02, inj.delays_injected


def _transient_vs_persistent(f):
    out = []
    t = f.ServingFaultInjector(fail_at=[2])
    with pytest.raises(f.TrainingFailure):
        t.on_decode_step(2)
    t.on_decode_step(2)
    p = f.ServingFaultInjector(fail_at=[2], persistent=True)
    for _ in range(3):
        with pytest.raises(f.TrainingFailure):
            p.on_decode_step(2)
    out.append((t.injected, p.injected))
    return out


def _poison_matches_ids(f):
    inj = f.ServingFaultInjector(poison_requests=[7])
    inj.on_decode_step(0, request_ids=[1, 2])
    with pytest.raises(f.TrainingFailure, match="poisoned"):
        inj.on_decode_step(1, request_ids=[2, 7])
    return inj.injected


def _on_prefill(f):
    inj = f.ServingFaultInjector(fail_at=[1], prefill_fail_at=[0],
                                 poison_requests=[9])
    with pytest.raises(f.TrainingFailure, match="prefill"):
        inj.on_prefill(0)
    inj.on_prefill(0)
    with pytest.raises(f.TrainingFailure):
        inj.on_prefill(1)
    with pytest.raises(f.TrainingFailure, match="poisoned"):
        inj.on_prefill(2, request_ids=[9])
    inj.on_prefill(2, request_ids=[3])
    return inj.prefills_failed, inj.injected


def _on_prefill_chunk(f):
    inj = f.ServingFaultInjector(prefill_chunk_fail_at=[0],
                                 prefill_fail_at=[1], poison_requests=[7])
    with pytest.raises(f.TrainingFailure, match="prefill-chunk"):
        inj.on_prefill_chunk(0)
    inj.on_prefill_chunk(0)
    with pytest.raises(f.TrainingFailure, match="prefill"):
        inj.on_prefill_chunk(1)
    with pytest.raises(f.TrainingFailure, match="poisoned"):
        inj.on_prefill_chunk(2, request_ids=[7])
    inj.on_prefill_chunk(2, request_ids=[3])
    return inj.prefill_chunks_failed, inj.prefills_failed, inj.injected


def _one_shot_hooks(f):
    inj = f.ServingFaultInjector(corrupt_page_at={3: 5},
                                 draft_poison_at={4: 6},
                                 adopt_fail_requests=[8])
    return (inj.check_corrupt_page(3), inj.check_corrupt_page(3),
            inj.check_draft_poison(4), inj.check_draft_poison(4),
            inj.check_adopt(8), inj.check_adopt(8), inj.adoptions_failed)


@pytest.mark.parametrize("case", [
    _delay_one_shot, _transient_vs_persistent, _poison_matches_ids,
    _on_prefill, _on_prefill_chunk, _one_shot_hooks],
    ids=lambda c: c.__name__.strip("_"))
def test_injector_semantics_equal_jax(case):
    """JAX :467-498, test_serving_continuous.py :455 and
    test_serving_chunked.py :563 on the port's copy, each outcome equal
    to JAX's injector's."""
    assert case(tfail) == case(jfail)
    assert issubclass(tfail.TrainingFailure, RuntimeError)

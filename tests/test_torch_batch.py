"""Port parity: batch mode and the whole-batch generate against JAX's.

`parallel.serving.make_parallel_generate` is held to JAX's
`make_parallel_generate(cfg, mesh1, ...)` on one converted float32 tree
(dense, mixture-of-experts and int8), greedy token for token. The engine
in ``mode="batch"`` is held to JAX's engine on the same traffic: the
batches it forms (one a prompt length, capped at ``max_batch_size``),
each request's tokens and lifecycle events, the batch series
(``serving_batches``, ``serving_batch_size``,
``serving_batch_latency_seconds``'s count), a transient fault retried and
a poisoned request quarantined while its batch peers complete solo, the
listeners' protocol (``record_batch`` then ``iteration_done``), the
refusals of what batch mode has no slot pool for, the ``"mode"``
rejection of a constrained submit and the pipelined loop's fallback.
Sampled batch tokens cannot match JAX's (the port draws from a counter,
not threefry), so the port is held to its own contract there: a retried
call and a solo continuation draw what the batch drew.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.observability import export as jex  # noqa: E402
from deeplearning4j_tpu.parallel import failure as jfail  # noqa: E402
from deeplearning4j_tpu.parallel import serving as jps  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.quant import model as jqm  # noqa: E402
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.observability import json_snapshot  # noqa
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.parallel import serving as tps  # noqa: E402
from deeplearning4j_tpu_torch.quant import model as tqm  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=64)
MOE = dict(FIELDS, n_experts=4, capacity_factor=1.25)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
BASE = dict(mode="batch", max_batch_size=3, max_new_tokens=6,
            decode_chunk=4, backoff_base_s=0.0)
SIDES = {"jax": (jeng, jfail), "port": (teng, tfail)}
BATCH_SERIES = ("serving_batches", "serving_batch_size",
                "serving_batch_latency_seconds", "serving_weight_reloads")


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


@pytest.fixture
def make(mesh1, jparams, tparams):
    """make(side, inj=None, **config) -> one side's engine."""
    def build(side, inj=None, **kw):
        mod = SIDES[side][0]
        cfg = mod.EngineConfig(**{**BASE, **kw})
        if side == "jax":
            return mod.InferenceEngine(JCFG, mesh1, jparams, cfg,
                                       fault_injector=inj)
        return mod.InferenceEngine(TCFG, tparams, cfg, device="cpu",
                                   fault_injector=inj)
    return build


def _traffic(lens=(5, 7, 5, 5, 7, 9, 5)):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 64, n).astype(np.int32) for n in lens]


def _events(h):
    drop = ("cost_flops", "cost_bytes")
    return [(e.kind, {k: v for k, v in e.data.items() if k not in drop})
            for e in h.trace.events]


def _serve(eng, prompts, **kw):
    hs = [eng.submit(p, **kw) for p in prompts]
    n = eng.run_pending()
    return hs, n


def _series(snap, name):
    fam = snap[name]
    if fam["kind"] == "histogram":
        return [(s["labels"], s["count"]) for s in fam["samples"]]
    return fam["samples"]


# ---------------------------------------------------------------------------
# make_parallel_generate
# ---------------------------------------------------------------------------

def _jax_gen(cfg, mesh, params, n, prompts, quantized=None):
    if quantized:
        placed = jqm.shard_quantized_serving_params(params, cfg, mesh)
    else:
        placed = jps.shard_serving_params(params, cfg, mesh)
    fn = jps.make_parallel_generate(cfg, mesh, n, quantized=quantized)
    return np.asarray(fn(placed, jax.numpy.asarray(prompts),
                         jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arm", ["dense", "moe", "int8"])
def test_generate_matches_jax(mesh1, arm):
    """Greedy tokens of the port's batch generate equal JAX's, [B, T0 + n]
    int32, on a float32 tree, a 4-expert tree and its int8 twin."""
    fields = MOE if arm == "moe" else FIELDS
    jcfg, tcfg = jtf.TransformerConfig(**fields), ttf.TransformerConfig(
        **fields)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(1))
    prompts = np.random.default_rng(0).integers(0, 64, (3, 9)).astype(
        np.int32)
    if arm == "int8":
        jq = jqm.quantize_params(jp, mode="int8")
        want = _jax_gen(jcfg, mesh1, jq, 7, prompts, quantized="int8")
        tp = tqm.quantize_params(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu"),
            mode="int8")
    else:
        want = _jax_gen(jcfg, mesh1, jp, 7, prompts)
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    got = tps.make_parallel_generate(tcfg, 7)(tp, torch.from_numpy(prompts),
                                             0)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_equals_generate_and_checks(tparams):
    """At one row the batch generate is `models.transformer.generate`
    (greedy and sampled with the same counter root); over-long requests
    and bad sampling knobs raise."""
    prompt = torch.from_numpy(_traffic((6,))[0])[None]
    for kw in (dict(temperature=0.0), dict(temperature=0.9, top_k=7)):
        got = tps.make_parallel_generate(TCFG, 5, **kw)(tparams, prompt, 11)
        want = ttf.generate(TCFG, tparams, prompt, 5, seed=11, **kw)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="max_len"):
        tps.make_parallel_generate(TCFG, 60)(tparams, prompt, 0)
    with pytest.raises(ValueError):
        tps.make_parallel_generate(TCFG, 0)
    with pytest.raises(ValueError, match="top_p"):
        tps.make_parallel_generate(TCFG, 2, top_p=0.0)
    assert tps.batch_key(0, 5) == tps.batch_key(0, 5)
    assert len({tps.batch_key(s, t) for s in range(3)
                for t in range(3)}) == 9


# ---------------------------------------------------------------------------
# the batch engine against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [0, 4])
def test_batches_and_tokens_match_jax(make, chunk):
    """One batch a prompt length (head first, peers of its length up to
    the cap, the rest in order), the same greedy tokens, admitted events
    with the batch size, and equal batch series and completions; a
    decode_chunk of 0 decodes a batch's budget in one call."""
    out = {}
    for side in SIDES:
        eng = make(side, decode_chunk=chunk)
        hs, n = _serve(eng, _traffic())
        out[side] = (eng, hs, n)
    (je, jh, jn), (te, th, tn) = out["jax"], out["port"]
    assert tn == jn == 4
    assert [h.result().tolist() for h in th] == \
        [h.result().tolist() for h in jh]
    assert [_events(h) for h in th] == [_events(h) for h in jh]
    js, ts = jex.json_snapshot(je.registry), json_snapshot(te.registry)
    for name in BATCH_SERIES + ("serving_requests_completed",
                                "serving_decode_step_seconds"):
        assert _series(ts, name) == _series(js, name), name
    assert te.stats["batches"] == 4 and te.stats["in_flight"] == 0
    assert sorted(te._programs) == ([("generate", 6)] if chunk == 0 else
                                    [("generate", 2), ("generate", 4)])


def test_deadline_and_cancel_match_jax(make):
    """A request past its deadline is shed at the chunk boundary, a
    partial one completes with what it has, and a cancelled one is shed:
    statuses, tokens and the shed counters equal JAX's."""
    clock = {"t": 0.0}

    def scenario(side):
        mod = SIDES[side][0]
        eng = make(side)
        eng._clock = lambda: clock["t"]
        clock["t"] = 0.0
        p = _traffic((5, 5, 5))
        hs = [eng.submit(p[0], deadline_s=1.0),
              eng.submit(p[1], deadline_s=1.0, on_deadline="partial"),
              eng.submit(p[2])]
        eng.cancel(hs[2])
        clock["t"] = 2.0
        eng.run_pending()
        shed = eng.registry.get("serving_requests_shed")
        return ([h.status for h in hs], [h.generated.tolist() for h in hs],
                [type(h.error).__name__ for h in hs],
                int(shed.labels("deadline").value),
                int(shed.labels("cancelled").value), mod)

    j, t = scenario("jax"), scenario("port")
    assert t[:5] == j[:5]
    assert t[0] == ["shed", "completed", "shed"]


def test_transient_fault_retried_token_exact(make):
    """Two injected transient faults retry at the same step index; every
    request completes with its fault-free tokens, with JAX's retry
    events and counters."""
    clean = [h.result().tolist() for h in _serve(make("port"),
                                                  _traffic())[0]]
    out = {}
    for side, (_, fmod) in SIDES.items():
        inj = fmod.ServingFaultInjector(fail_at=[1, 2])
        eng = make(side, inj=inj)
        hs, _ = _serve(eng, _traffic())
        out[side] = (eng, inj, hs)
    (je, ji, jh), (te, ti, th) = out["jax"], out["port"]
    assert [h.result().tolist() for h in th] == clean == \
        [h.result().tolist() for h in jh]
    assert ti.injected == ji.injected == 2
    for k in ("retries", "step_failures", "quarantined", "completed"):
        assert te.stats[k] == je.stats[k], k
    assert [_events(h) for h in th] == [_events(h) for h in jh]
    assert te.health()["breaker"] == "closed"


def test_poisoned_request_quarantined_peers_complete(make):
    """A request that fails every call takes its batch through the
    retries into isolation: each peer re-runs alone and completes with
    its fault-free tokens (the solo calls keyed by their own prefix),
    the poisoned one is quarantined, as in JAX's engine."""
    prompts = _traffic((5, 5, 5))
    clean = [h.result().tolist() for h in _serve(make("port"), prompts)[0]]
    out = {}
    for side, (_, fmod) in SIDES.items():
        inj = fmod.ServingFaultInjector()
        eng = make(side, inj=inj, max_retries=1)
        hs = [eng.submit(p) for p in prompts]
        inj.poison_requests.add(hs[1].rid)
        eng.run_pending()
        out[side] = (eng, hs)
    (je, jh), (te, th) = out["jax"], out["port"]
    assert [h.status for h in th] == [h.status for h in jh] == \
        ["completed", "quarantined", "completed"]
    with pytest.raises(teng.RequestQuarantined, match="persistently"):
        th[1].result(0)
    assert [th[0].result().tolist(), th[2].result().tolist()] == \
        [clean[0], clean[2]]
    for k in ("retries", "step_failures", "quarantined", "completed"):
        assert te.stats[k] == je.stats[k], k
    assert [_events(h) for h in th] == [_events(h) for h in jh]


def test_sampled_retry_and_solo_reproduce(make):
    """Sampled batch tokens are the port's own (a counter keyed by the
    seed and the prompt length): a retried call and a solo continuation
    after an isolation draw exactly what the clean batch drew."""
    kw = dict(temperature=0.9, top_k=8, seed=5)
    prompts = _traffic((5, 5, 5))
    clean = [h.result().tolist()
             for h in _serve(make("port", **kw), prompts)[0]]
    inj = tfail.ServingFaultInjector(fail_at=[1])
    retried = [h.result().tolist()
               for h in _serve(make("port", inj=inj, **kw), prompts)[0]]
    assert retried == clean and inj.injected == 1


    class BatchOnly:
        """Fails the second call whenever it holds more than one
        request: the batch isolates, each request goes on alone."""
        def on_decode_step(self, step, rids):
            if step == 1 and len(rids) > 1:
                raise tfail.TrainingFailure("batch call down")

    eng = make("port", inj=BatchOnly(), max_retries=0, **kw)
    hs, _ = _serve(eng, prompts)
    # every request re-ran alone from its committed first chunk (4
    # tokens) and drew the same tokens
    assert eng.stats["quarantined"] == 0 and eng.stats["step_failures"] == 1
    assert all(any(e.data.get("solo") for e in h.trace.events) for h in hs)
    assert [h.result().tolist() for h in hs] == clean


class _Listener:
    def __init__(self, fail=False):
        self.sizes, self.calls, self.fail = [], [], fail

    def record_batch(self, n):
        self.sizes.append(n)

    def iteration_done(self, engine, idx, latency):
        self.calls.append((engine, idx, latency >= 0))
        if self.fail:
            raise RuntimeError("listener down")


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_listeners_protocol_matches_jax(make, mode):
    """After every batch (or busy tick) each listener gets
    ``record_batch(size)`` then ``iteration_done(engine, index,
    latency)``, with JAX's sizes and indices; a listener that raises is
    logged and neither serving nor the next listener stops."""
    kw = {} if mode == "batch" else dict(mode="continuous", pipeline=False,
                                         num_slots=2)
    got = {}
    for side in SIDES:
        eng = make(side, **kw)
        bad, good = _Listener(fail=True), _Listener()
        eng.set_listeners(bad, good)
        hs, _ = _serve(eng, _traffic())
        assert all(h.status == "completed" for h in hs)
        assert good.calls and all(c[0] is eng and c[2] for c in good.calls)
        got[side] = (good.sizes, [c[1] for c in good.calls], bad.sizes)
    assert got["port"] == got["jax"]
    assert got["port"][1] == list(range(1, len(got["port"][1]) + 1))


def test_listener_without_record_batch(make):
    class OnlyDone:
        calls = 0

        def iteration_done(self, engine, idx, latency):
            OnlyDone.calls += 1

    eng = make("port")
    eng.set_listeners(OnlyDone())
    _serve(eng, _traffic((5, 5)))
    assert OnlyDone.calls == 1


def test_constrained_submit_rejected_with_reason_mode(make):
    """Batch mode has no per-slot DFA state: a constrained submit raises
    ConstraintError("mode") at submit, counted as JAX counts it."""
    from deeplearning4j_tpu_torch.serving.constrain import ConstraintError
    from deeplearning4j_tpu.serving.constrain import \
        ConstraintError as JConstraintError
    t, j = make("port"), make("jax")
    with pytest.raises(ConstraintError) as te_:
        t.submit(_traffic((5,))[0], constrain="[ab]+")
    with pytest.raises(JConstraintError) as je_:
        j.submit(_traffic((5,))[0], constrain="[ab]+")
    assert te_.value.reason == je_.value.reason == "mode"
    assert str(te_.value) == str(je_.value)
    assert t.counts["constrained_rejected_mode"] == 1
    assert not t._queue
    js, ts = jex.json_snapshot(j.registry), json_snapshot(t.registry)
    assert _series(ts, "serving_constrained_rejections") == \
        _series(js, "serving_constrained_rejections")


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=8), "prefill_chunk requires mode='continuous'"),
    (dict(tick_token_budget=32), "tick_token_budget without"),
    (dict(preemption_budget=1), "preemption_budget requires"),
    (dict(paged=True), "paged KV requires mode='continuous'"),
    (dict(spec_decode=True), "spec_decode requires mode='continuous'"),
    (dict(mode="stream"), "mode must be"),
])
def test_batch_refusals_match_jax(make, kw, match):
    for side in SIDES:
        with pytest.raises(ValueError, match=match):
            make(side, **kw)


def test_pipeline_falls_back_to_sync(make):
    """``pipeline=True`` (the default) in batch mode falls back to the
    synchronous loop with reason "batch": in debugz and in
    serving_pipeline_fallbacks_total, as JAX's; with ``pipeline=False``
    neither appears."""
    t, j = make("port", pipeline=True), make("jax", pipeline=True)
    assert t.debugz()["tick_pipeline"]["fallback_reason"] == "batch"
    assert j.debugz()["tick_pipeline"]["fallback_reason"] == "batch"
    assert t.health()["pipeline"] is False
    js, ts = jex.json_snapshot(j.registry), json_snapshot(t.registry)
    assert _series(ts, "serving_pipeline_fallbacks") == \
        _series(js, "serving_pipeline_fallbacks")
    t2 = make("port", pipeline=False)
    assert "tick_pipeline" not in t2.debugz()
    assert "serving_pipeline_fallbacks" not in json_snapshot(t2.registry)
    # JAX's families (the compile series are ported too) and the port's
    # own three
    assert sorted(set(json_snapshot(t2.registry))) == sorted(
        set(jex.json_snapshot(make("jax", pipeline=False).registry))
        | {"serving_decode_chunks", "serving_device_syncs",
           "serving_device_wait_seconds"})


def test_quantized_batch_engine_matches_jax(mesh1, jparams, tparams):
    """An int8 weight tree in batch mode: JAX's tokens, and the
    parameter bytes JAX reports."""
    jcfg = jeng.EngineConfig(**BASE, quantize="int8")
    je = jeng.InferenceEngine(JCFG, mesh1, jparams, jcfg)
    te = teng.InferenceEngine(TCFG, tparams,
                              teng.EngineConfig(**BASE, quantize="int8"),
                              device="cpu")
    jh, _ = _serve(je, _traffic())
    th, _ = _serve(te, _traffic())
    assert [h.result().tolist() for h in th] == \
        [h.result().tolist() for h in jh]
    assert te.stats["param_bytes"] == je.stats["param_bytes"]

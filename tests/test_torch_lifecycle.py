"""Port parity: the serving engine's request lifecycle against JAX's.

Deadlines (``submit(deadline_s=, on_deadline=)``, shed at admission and
at each commit boundary on the engine's clock), `cancel`, `stop`,
`drain` / `resume` and `ready`, the background worker and its coalescing
window, and `drained` with a tick pending. Where a case runs on both
engines, JAX's (1x1 mesh, plain reference paths) and the port's on the
CPU take the same float32 weights (one JAX `init_params` tree converted
with `params_from_numpy`), the same requests and the same clock, and
agree exactly on every handle's status and tokens and on the shed
counters. Time is an injected clock that a test injector advances at
chosen steps (in place of JAX's wall-clock ``delay_at`` sleeps), so the
cases are deterministic.

The contracts are JAX's (tests/test_serving_engine.py :100-115,
:208-262, :362, :500-620; test_serving_pipeline.py :271, :317, :329;
test_serving_chunked.py :389-430).
"""
import json
import time
import urllib.error
import urllib.request

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
from deeplearning4j_tpu_torch.observability import \
    MetricsServer  # noqa: E402
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=64)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
BASE = dict(decode_chunk=2, max_new_tokens=6, backoff_base_s=0.0)
SIDES = {"jax": (jeng, jfail), "port": (teng, tfail)}
LOOPS = pytest.mark.parametrize("pipeline", [False, True],
                                ids=["sync", "pipelined"])


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


def _clocked(fmod):
    """A ServingFaultInjector of ``fmod`` whose ``advance_at`` ({step:
    seconds}) moves the shared clock ``t`` before that step's call: a
    deterministic stand-in for ``delay_at``'s host sleep."""
    class Clocked(fmod.ServingFaultInjector):
        def __init__(self, t, advance_at):
            super().__init__()
            self.t, self.advance_at = t, dict(advance_at)

        def on_decode_step(self, step, request_ids=()):
            self.t["now"] += self.advance_at.pop(int(step), 0.0)
            super().on_decode_step(step, request_ids)
    return Clocked


@pytest.fixture
def make(mesh1, jparams, tparams):
    """make(side, advance_at=None, **config) -> (engine, clock dict): the
    engine reads the clock; with ``advance_at`` its injector moves it."""
    def build(side, advance_at=None, **kw):
        mod, fmod = SIDES[side]
        t = {"now": 0.0}
        inj = None if advance_at is None else _clocked(fmod)(t, advance_at)
        cfg = mod.EngineConfig(**{**BASE, **kw})
        clock = lambda: t["now"]  # noqa: E731
        if side == "jax":
            eng = mod.InferenceEngine(JCFG, mesh1, jparams, cfg,
                                      fault_injector=inj, clock=clock)
        else:
            eng = mod.InferenceEngine(TCFG, tparams, cfg, device="cpu",
                                      fault_injector=inj, clock=clock)
        return eng, t
    return build


def _prompt(t0=8, seed=0):
    return (np.arange(t0, dtype=np.int32) * (seed + 3)) % FIELDS[
        "vocab_size"]


def _shed(eng, reason):
    return int(eng.registry.get("serving_requests_shed")
               .labels(reason).value)


def _facts(eng, hs):
    return ([h.status for h in hs], [h.generated.tolist() for h in hs],
            [bool(h.deadline_exceeded) for h in hs],
            [type(h.error).__name__ for h in hs],
            {r: _shed(eng, r) for r in ("deadline", "cancelled",
                                        "overload")},
            eng.stats["completed"])


def both(make, scenario, **cfg):
    """``scenario(eng, t) -> handles`` on JAX's engine and the port's;
    asserts they agree and returns the port's (eng, handles)."""
    out = {}
    for side in SIDES:
        eng, t = make(side, **cfg)
        out[side] = (eng, scenario(eng, t))
    assert _facts(*out["port"]) == _facts(*out["jax"])
    for a, b in zip(out["jax"][1], out["port"][1]):
        assert [e.data["reason"] for e in b.trace.events
                if e.kind == "shed"] == \
            [e.data["reason"] for e in a.trace.events if e.kind == "shed"]
    return out["port"]


def _solo(make, prompt, **kw):
    eng, _ = make("port", **kw)
    h = eng.submit(prompt)
    eng.run_pending()
    return h.generated.tolist()


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

@LOOPS
def test_deadline_shed_while_peer_completes(make, pipeline):
    """JAX :208: the clock passes one request's deadline mid-decode; it is
    shed with DeadlineExceeded at the next commit boundary while its
    co-resident peer completes its whole budget."""
    def scenario(eng, t):
        doomed = eng.submit(_prompt(8, 1), deadline_s=0.04)
        peer = eng.submit(_prompt(8, 2))
        eng.run_pending()
        return [doomed, peer]

    eng, (doomed, peer) = both(make, scenario, advance_at={1: 0.08},
                               pipeline=pipeline)
    assert doomed.status == teng.RequestStatus.SHED
    with pytest.raises(teng.DeadlineExceeded):
        doomed.result(0)
    assert peer.result(0).shape[0] == 8 + 6
    assert eng.stats["shed_deadline"] == 1


def test_deadline_partial_returns_the_committed_prefix(make):
    """JAX :227 (synchronous loop): ``on_deadline="partial"`` completes
    the request with the tokens committed by then, a prefix of the full
    run's."""
    def scenario(eng, t):
        h = eng.submit(_prompt(), deadline_s=0.04, on_deadline="partial")
        eng.run_pending()
        return [h]

    eng, (h,) = both(make, scenario, advance_at={1: 0.08}, pipeline=False)
    assert h.status == teng.RequestStatus.COMPLETED and h.deadline_exceeded
    assert 0 < h.generated.shape[0] < h.max_new_tokens
    full = _solo(make, _prompt())
    assert h.generated.tolist() == full[:h.generated.shape[0]]
    fin = [e for e in h.trace.events if e.kind == "finished"]
    assert fin[0].data["partial"] is True


@LOOPS
def test_expired_before_launch_is_shed_cheaply(make, pipeline):
    """JAX :251: a deadline already past at admission sheds the request
    before any call, with no tokens."""
    def scenario(eng, t):
        h = eng.submit(_prompt(), deadline_s=-1.0)
        eng.run_pending()
        return [h]

    eng, (h,) = both(make, scenario, pipeline=pipeline)
    assert h.status == teng.RequestStatus.SHED
    assert h.generated.shape[0] == 0
    assert eng.counts["prefill_calls"] == 0


def test_deadline_and_cancel_shed_at_the_commit_boundary(make):
    """test_serving_pipeline.py :271: with a tick in flight, one request
    passes its deadline and another is cancelled; both are shed at the
    next commit boundary and the third completes exactly."""
    def scenario(eng, t):
        h_dead = eng.submit(_prompt(6, 0), deadline_s=1.0)
        h_live = eng.submit(_prompt(6, 1))
        h_cancel = eng.submit(_prompt(6, 2))
        eng.tick()
        eng.tick()
        assert h_dead.generated.shape[0] > 0
        t["now"] = 5.0
        assert eng.cancel(h_cancel)
        eng.run_pending()
        return [h_dead, h_live, h_cancel]

    eng, (h_dead, h_live, h_cancel) = both(
        make, scenario, pipeline=True, max_new_tokens=16, num_slots=4)
    assert (h_dead.status, h_cancel.status) == ("shed", "shed")
    assert h_live.status == "completed"
    assert h_live.generated.tolist() == _solo(
        make, _prompt(6, 1), max_new_tokens=16)
    assert eng.drained() and not eng._pending


def test_mid_prefill_deadline_shed_and_partial(make):
    """test_serving_chunked.py :409: deadlines that pass mid-prefill; the
    shed one raises DeadlineExceeded before sampling a token, the
    partial one completes with none."""
    def scenario(eng, t):
        shed = eng.submit(_prompt(40, 1), deadline_s=5.0)
        part = eng.submit(_prompt(40, 2), deadline_s=5.0,
                          on_deadline="partial")
        eng.tick()
        assert eng._is_prefilling(shed)
        t["now"] = 10.0
        eng.run_pending()
        return [shed, part]

    eng, (shed, part) = both(make, scenario, prefill_chunk=4,
                             tick_token_budget=4, num_slots=2)
    assert shed.status == "shed" and part.status == "completed"
    assert part.generated.shape[0] == 0


# ---------------------------------------------------------------------------
# cancel
# ---------------------------------------------------------------------------

@LOOPS
def test_cancel_queued_and_in_flight(make, pipeline):
    """JAX :572: a queued request is shed at once, an in-flight one at its
    next commit boundary, both RequestCancelled and counted under
    ``shed{reason="cancelled"}``; a finished handle is left alone."""
    def scenario(eng, t):
        running = eng.submit(_prompt(8, 0))
        queued = eng.submit(_prompt(8, 1))
        eng.tick()
        assert running.status == "running"
        assert eng.cancel(queued) is True
        assert queued.status == "shed"
        assert eng.cancel(running) is True
        eng.run_pending()
        assert eng.cancel(queued) is False
        return [running, queued]

    eng, (running, queued) = both(make, scenario, max_batch_size=1,
                                  num_slots=1, pipeline=pipeline)
    for h in (running, queued):
        with pytest.raises(teng.RequestCancelled):
            h.result(0)
    assert running.generated.shape[0] < 6
    assert _shed(eng, "cancelled") == 2
    assert [e.data["reason"] for e in running.trace.events
            if e.kind == "shed"] == ["cancelled"]


def test_mid_prefill_cancel_frees_the_slot(make):
    """test_serving_chunked.py :389: a cancel mid-prefill sheds at the
    tick boundary, frees the slot, and the pool keeps serving."""
    def scenario(eng, t):
        h = eng.submit(_prompt(40, 3))
        eng.tick()
        assert eng._is_prefilling(h)
        assert eng.cancel(h)
        eng.run_pending()
        assert eng.health()["slots_occupied"] == 0
        nxt = eng.submit(_prompt(8, 4))
        eng.run_pending()
        return [h, nxt]

    eng, (h, nxt) = both(make, scenario, prefill_chunk=4,
                         tick_token_budget=4, num_slots=2)
    assert h.status == "shed" and nxt.status == "completed"


# ---------------------------------------------------------------------------
# stop, drain, ready
# ---------------------------------------------------------------------------

def test_submit_after_stop_raises_engine_stopped(make):
    """JAX :500: `submit` after `stop()` raises EngineStopped at once (a
    RuntimeError, as before)."""
    eng, _ = make("port")
    h = eng.submit(_prompt())
    eng.run_pending()
    assert h.status == "completed"
    eng.stop()
    t0 = time.perf_counter()
    with pytest.raises(teng.EngineStopped):
        eng.submit(_prompt())
    assert time.perf_counter() - t0 < 1.0
    with pytest.raises(RuntimeError):
        eng.submit(_prompt())
    assert not eng.ready()


@LOOPS
def test_drain_flips_readyz_at_once(make, pipeline):
    """JAX :521: the instant `drain(wait=False)` is called `submit` raises
    EngineDraining and /readyz answers 503 (/healthz shows draining),
    while the residents still run; they all complete, nothing is shed,
    and `resume()` reopens admissions."""
    eng, _ = make("port", pipeline=pipeline)
    srv = MetricsServer(eng.registry, port=0, health=eng.health,
                        ready=eng.ready)
    try:
        hs = [eng.submit(_prompt(8, i)) for i in range(2)]
        eng.tick()
        with urllib.request.urlopen(srv.url + "/readyz",
                                    timeout=10) as resp:
            assert resp.status == 200
        eng.drain(wait=False)
        assert not eng.drained() and not eng.ready() and eng.draining()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/readyz", timeout=10)
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/healthz", timeout=10)
        assert json.loads(ei.value.read())["draining"] is True
        with pytest.raises(teng.EngineDraining):
            eng.submit(_prompt())
        eng.run_pending()
        assert eng.drained()
        assert all(h.status == "completed" for h in hs)
        assert eng.stats["shed_deadline"] == eng.stats["shed_overload"] == 0
        eng.resume()
        assert eng.ready()
        h = eng.submit(_prompt())
        eng.run_pending()
        assert h.status == "completed"
    finally:
        srv.stop()


def test_drained_accounts_for_a_pending_tick(make):
    """test_serving_pipeline.py :317: a request whose whole budget is
    dispatched but not committed keeps the engine from reporting
    drained."""
    eng, _ = make("port", pipeline=True, max_new_tokens=2)
    eng.submit(_prompt(6, 1))
    eng.tick()
    assert eng._pending and not eng.drained()
    eng.run_pending()
    assert eng.drained()


# ---------------------------------------------------------------------------
# the background worker
# ---------------------------------------------------------------------------

@LOOPS
def test_background_worker_serves_like_run_pending(make, pipeline):
    """JAX :362 / test_serving_pipeline.py :329: `start()` serves from the
    worker thread, the tokens those of `run_pending`; `stop()` drains and
    closes admissions."""
    prompts = [_prompt(5 + 3 * i, i) for i in range(5)]
    ref, _ = make("port", pipeline=pipeline, num_slots=4)
    want = [ref.submit(p) for p in prompts]
    ref.run_pending()
    eng, _ = make("port", pipeline=pipeline, num_slots=4,
                  batch_timeout_s=0.002)
    eng.start()
    try:
        hs = [eng.submit(p) for p in prompts]
        outs = [h.result(timeout=120) for h in hs]
    finally:
        eng.stop()
    assert [o.tolist() for o in outs] == [w.result(0).tolist()
                                         for w in want]
    assert eng._thread is None and eng.drained()
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit(_prompt())


def test_worker_under_concurrent_submitters(make):
    """Eight submitter threads against the worker, the interpreter's
    switch interval shortened: `drain` returns only once every request
    is done (`drained` is false while a tick runs), and each request's
    tokens are its solo run's (sampling is keyed by position)."""
    import sys
    import threading
    prompts = {(k, j): _prompt(5 + j, k) for k in range(8) for j in range(3)}
    want = {key: _solo(make, p, max_new_tokens=4)
            for key, p in prompts.items()}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng, _ = make("port", num_slots=4, max_new_tokens=4)
        eng.start()
        got, lock = {}, threading.Lock()

        def submit(k):
            for j in range(3):
                h = eng.submit(prompts[(k, j)])
                with lock:
                    got[(k, j)] = h

        threads = [threading.Thread(target=submit, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        eng.drain(wait=True, timeout=120)
        assert len(got) == 24 and all(h.done() for h in got.values())
        eng.stop()
    finally:
        sys.setswitchinterval(old)
    assert {key: h.generated.tolist() for key, h in got.items()} == want


def test_worker_skips_the_coalescing_sleep_when_the_queue_fills_the_pool(
        make):
    """JAX :605: the worker's wait is skipped exactly when the queue
    already holds a request for every free slot."""
    eng, _ = make("port", max_batch_size=2, num_slots=2)
    assert not eng._queue_fills_pool()
    eng.submit(_prompt(8, 1))
    assert not eng._queue_fills_pool()
    eng.submit(_prompt(8, 2))
    assert eng._queue_fills_pool()
    eng.tick()
    eng.submit(_prompt(8, 3))
    assert eng._queue_fills_pool()
    eng.run_pending()
    assert not eng._queue_fills_pool()


# ---------------------------------------------------------------------------
# validation and the read-outs
# ---------------------------------------------------------------------------

def test_submit_validation_and_fault_readouts(make):
    """JAX :100: ``on_deadline`` must be "shed" or "partial"; the
    handle carries its deadline on the engine's clock; a fresh engine's
    read-outs hold JAX's fault keys at their idle values."""
    eng, t = make("port")
    with pytest.raises(ValueError, match="on_deadline"):
        eng.submit(_prompt(), on_deadline="explode")
    t["now"] = 3.0
    h = eng.submit(_prompt(), deadline_s=2.0)
    assert h.deadline_at == 5.0 and h.on_deadline == "shed"
    sub = [e for e in h.trace.events if e.kind == "submit"][0]
    assert sub.data["deadline_s"] == 2.0
    health = eng.health()
    assert (health["breaker"], health["draining"]) == ("closed", False)
    jeng_, _ = make("jax")
    assert set(eng.stats) == set(jeng_.stats)
    for k in ("shed_deadline", "quarantined", "retries", "step_failures",
              "preempted"):
        assert eng.stats[k] == 0 == jeng_.stats[k]
    eng.run_pending()
    assert h.status == "completed"

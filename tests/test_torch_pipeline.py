"""Port parity: the pipelined (double-buffered) tick loop.

The port's pipelined loop (`EngineConfig.pipeline`, the default) against
its synchronous loop on every pool, and against the JAX engine's own
pipelined loop (1x1 mesh, plain reference paths as in
tests/test_torch_serving.py). Both sides hold one JAX `init_params` tree
converted with `params_from_numpy`. Tolerances: token streams exactly
(greedy and sampled: the port samples by position, so its two loops draw
the same tokens; against JAX greedy only, as threefry is not ported);
the prefix-cache counts and spec drafted / accepted counts exactly.

Every run is driven tick by tick and checked as it goes (`_drive`): a
pipelined tick blocks on the device at most once, at most one tick is in
flight, and after the drain nothing is pending, no request holds tokens
in flight and no page is leaked. The contracts are the reference's
(tests/test_serving_pipeline.py, tests/test_serving_spec_pipeline.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=96)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
BASE = dict(num_slots=4, decode_chunk=3, max_new_tokens=12)


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


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab_size"], size=(n,)).astype(np.int32)


def _waves():
    """Seven requests through 4 slots (a refill wave), then four that
    share a 16-token system prompt with one of them (on a paged pool:
    prefix hits, a full-prefix hit whose last page is copied on write)."""
    sys_prompt = _prompt(16, 99)
    first = [(_prompt(n, 10 + i), m) for i, (n, m) in enumerate(
        zip((5, 17, 8, 30, 3, 12, 9), (11, 9, 4, 12, 10, 5, 12)))]
    first.append((sys_prompt, 7))
    second = [(np.concatenate([sys_prompt, _prompt(k, 50 + k)]), 8)
              for k in (1, 4, 9)] + [(sys_prompt, 6)]
    return [first, second]


def _port(tparams, **kw):
    return teng.InferenceEngine(TCFG, tparams,
                                teng.EngineConfig(**{**BASE, **kw}),
                                device="cpu")


def _drive(eng, waves):
    """Serve ``waves`` one after the other, tick by tick, checking the
    pipeline's invariants on every tick and after each drain. Returns
    (results, blocking syncs of each tick)."""
    results, syncs = [], []
    for wave in waves:
        hs = [eng.submit(p, max_new_tokens=m) for p, m in wave]
        while True:
            s0 = eng.counts["syncs"]
            busy = eng.tick()
            syncs.append(eng.counts["syncs"] - s0)
            assert len(eng._pending) <= 1, "more than one tick in flight"
            if not busy:
                break
        assert eng.drained()
        assert all((h._pending_n, h._pending_spec) == (0, 0) for h in hs)
        results += [h.result() for h in hs]
    if eng.config.paged:
        assert eng.counts["pages_used"] == eng.prefix_cache_pages
    if eng.config.pipeline:
        assert max(syncs) <= 1
    return results, syncs


POOLS = {
    "contiguous": {},
    "paged": dict(paged=True, page_size=8),
    "chunked": dict(prefill_chunk=8, tick_token_budget=24),
    "paged_chunked": dict(paged=True, page_size=8, prefill_chunk=8,
                          tick_token_budget=24),
    "int8_kv": dict(kv_quantize="int8"),
    "int8_weights": dict(quantize="int8"),
    "spec": dict(spec_decode=True, spec_k=4),
    "paged_spec": dict(spec_decode=True, spec_k=4, paged=True, page_size=8),
}
SAMPLING = {"greedy": {}, "sampled": dict(temperature=0.8, top_k=5, seed=7)}


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_pipelined_equals_sync(tparams, pool, sampling):
    """Both loops serve both waves token for token on every pool (spec:
    adaptive K from 4 with the default int8 drafter), greedy and
    sampled; without spec, through the same calls."""
    kw = {**POOLS[pool], **SAMPLING[sampling]}
    sync = _port(tparams, pipeline=False, **kw)
    want, _ = _drive(sync, _waves())
    eng = _port(tparams, **kw)
    got, _ = _drive(eng, _waves())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.counts["pipelined_ticks"] > 0
    if "spec_decode" in kw:
        assert eng.counts["spec_rounds"] > 0
    else:
        # token counts are known at dispatch, so the pipelined loop
        # makes the synchronous loop's calls: the same prefill buckets
        # and chunk plans, which is what makes half-precision pools
        # exact too
        for k in ("prefill_calls", "prefill_chunks", "decode_chunks",
                  "prefix_hits", "cow_copies"):
            assert eng.counts[k] == sync.counts[k], k
    if kw.get("paged"):
        assert eng.counts["prefix_hits"] > 0
        assert eng.counts["cow_copies"] > 0


def test_default_is_pipelined():
    assert teng.EngineConfig().pipeline is True


def test_at_most_one_blocking_sync_per_tick(tparams):
    """The pipelined loop waits on the device once a tick (its commit),
    where the synchronous loop waits once a call: twice on a tick that
    admits and decodes (reference test_serving_pipeline.py:103)."""
    _, sync_ticks = _drive(_port(tparams, pipeline=False), _waves()[:1])
    eng = _port(tparams)
    _, pipe_ticks = _drive(eng, _waves()[:1])
    assert max(pipe_ticks) == 1 and max(sync_ticks) >= 2
    c = eng.counts
    assert c["syncs"] < c["prefill_calls"] + c["decode_chunks"]


def test_pipeline_depth_bounded_at_one(tparams):
    """One tick in flight at most: each tick commits the one dispatched
    before it, and the drain ends with none."""
    eng = _port(tparams, prefill_chunk=8)
    for p, m in _waves()[0]:
        eng.submit(p, max_new_tokens=m)
    depths = []
    while eng.tick():
        depths.append(len(eng._pending))
    assert set(depths) == {0, 1} and depths[-1] == 0
    assert eng.drained() and not eng._pending


def test_schedule_ahead_spec_releases_unused_reservation(tparams):
    """A spec round in flight reserves K+1 tokens a slot (within its
    budget); what verification rejected is released at its commit:
    reserved - committed = released, with rejections present (the
    "layers:1" drafter of random weights is often wrong)."""
    eng = _port(tparams, spec_decode=True, spec_k=4, draft="layers:1",
                spec_adaptive=False)
    _drive(eng, _waves())
    c = eng.counts
    assert c["spec_reserved"] - c["spec_committed"] == c["spec_released"]
    assert c["spec_released"] > 0 and c["spec_committed"] > 0
    assert c["spec_accepted"] < c["spec_drafted"]


def test_paged_write_range_counts_tokens_in_flight(tparams):
    """A pipelined paged request's write range starts at its scheduled
    prefix: tokens in flight count as written, and an in-flight spec
    round widens the range by its unknown commit count."""
    eng = _port(tparams, paged=True, page_size=8)
    r = eng.submit(_prompt(10, 3), max_new_tokens=12)
    eng.tick()                     # prefill and first chunk in flight
    assert r._pending_n == 1 + 3
    assert eng._write_range(r, 3) == (13, 16)
    r._pending_spec = 5            # as if a K=4 round were in flight
    assert eng._write_range(r, 5) == (9, 18)
    r._pending_spec = 0
    eng.run_pending()


def _jax(mesh1, jparams, **kw):
    return jeng.InferenceEngine(JCFG, mesh1, jparams, jeng.EngineConfig(
        backoff_base_s=0.0, **{**BASE, **kw}))


def _jax_serve(eng, waves):
    out = []
    for wave in waves:
        hs = [eng.submit(p, max_new_tokens=m) for p, m in wave]
        eng.run_pending()
        out += [h.result() for h in hs]
    return out


@pytest.mark.parametrize("pool", ["contiguous", "paged", "spec"])
def test_pipelined_matches_jax_pipelined(mesh1, jparams, tparams, pool):
    """The port's pipelined loop against the JAX engine's (pipeline=True,
    its default) on both waves: every result token-exact; paged: the
    prefix-cache counts equal; spec (adaptive K, the default int8
    drafter): the drafted / accepted counts equal."""
    kw = dict(POOLS[pool], pipeline=True)
    jengine = _jax(mesh1, jparams, **kw)
    want = _jax_serve(jengine, _waves())
    eng = _port(tparams, **kw)
    got, _ = _drive(eng, _waves())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    c = eng.counts
    if pool == "paged":
        jc = jengine.debugz()["paged"]["prefix_cache"]
        assert (c["prefix_hits"], c["prefix_misses"],
                c["prefix_shared_tokens"]) == \
            (jc["hits"], jc["misses"], jc["shared_tokens"])
    if pool == "spec":
        assert c["spec_rounds"] > 0
        assert (c["spec_drafted"], c["spec_accepted"]) == tuple(
            int(jengine.registry.get(name)._unlabeled().value)
            for name in ("serving_spec_drafted_tokens",
                         "serving_spec_accepted_tokens"))

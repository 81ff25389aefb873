"""Port parity: paged KV serving (programs, prefix cache, copy-on-write).

The JAX side runs on a 1x1 mesh through its plain reference paths
(DL4JTPU_FLASH unset), as tests/test_torch_serving.py does, and its
engine with both loops (`pipeline=False` and the default pipelined
one), each against the same loop of the port's. Both sides hold one JAX
`init_params` tree converted with `params_from_numpy`. Tolerances: page
pools 1e-5 (the scratch page 0 excluded: pad rows and inactive slots
write it in no defined order); pos, tok, first and emitted tokens exactly (greedy);
engine results token-exact, with the prefix-cache hit / miss /
shared-token counts equal to JAX's. The port's own contracts (paged ≡
contiguous, copy-on-write, blocking, shedding, the scratch page never
read) are copied from tests/test_serving_paged.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402
from deeplearning4j_tpu.parallel import serving as jsv  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import MeshSpec, make_mesh  # noqa
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402
from deeplearning4j_tpu.serving import paging as jpg  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving import paging as tpg  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=96)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
NS = 4
PS = 8
CACHE = dict(rtol=0, atol=1e-5)


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


def _assert_pool(tstate, jstate):
    """kp, vp on every page but the scratch page; pos, tok exactly."""
    for name, t, j in zip(("kp", "vp", "pos", "tok"), tstate, jstate):
        if name in ("kp", "vp"):
            np.testing.assert_allclose(t.numpy()[:, 1:],
                                       np.asarray(j)[:, 1:], **CACHE,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


def _both(fn_j, fn_t, jstate, tstate, sparams, tparams, *args):
    """One call on each side with the same numpy arguments."""
    key = jax.random.PRNGKey(0)
    *jstate, jout = fn_j(sparams, *jstate, *(jnp.asarray(a) for a in args),
                         key)
    *tstate, tout = fn_t(tparams, *tstate,
                         *(torch.from_numpy(a) for a in args), 0)
    _assert_pool(tstate, jstate)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    return jstate, tstate, tout.numpy()


# ---------------------------------------------------------------------------
# the programs against JAX's
# ---------------------------------------------------------------------------

def _tables(ps):
    """Block tables for slots 0 (21-token prompt) and 2 (10), each with
    8 decode rows, and slot 1 (23 tokens) sharing slot 0's first 16
    tokens' pages; slot 3 holds none. Returns (bt, max_pages, pages)."""
    mp = tpg.pages_for(FIELDS["max_len"], ps)
    bt = np.zeros((NS, mp), np.int32)
    fresh = iter(range(1, 10 ** 6))
    for i, n in ((0, 29), (2, 18)):
        k = tpg.pages_for(n, ps)
        bt[i, :k] = [next(fresh) for _ in range(k)]
    shared = 16 // ps
    bt[1, :shared] = bt[0, :shared]
    k = tpg.pages_for(31, ps)
    bt[1, shared:k] = [next(fresh) for _ in range(k - shared)]
    return bt, mp, next(fresh) + 2


@pytest.mark.parametrize("ps", [4, 8])
def test_paged_prefill_and_decode_match_jax(mesh1, jparams, tparams, ps):
    """A fresh prefill (slots 0 and 2), a prefix-hit resume at start 16
    over pages slot 0 wrote (slot 1; slots 0, 2, 3 pass through), then a
    decode chunk with an inactive slot and budgets ending mid-chunk:
    pools at 1e-5, every int output exactly."""
    bt, mp, npg = _tables(ps)
    sparams = jsv.shard_serving_params(jparams, JCFG, mesh1)
    jstate = tuple(jsv.init_paged_state(JCFG, mesh1, NS, ps, npg))
    tstate = tsv.init_paged_state(TCFG, NS, ps, npg, "cpu")
    a = _prompt(21, 1)
    b = np.concatenate([a[:16], _prompt(7, 2)])
    tb = 32
    for tails, start in (({0: a, 2: _prompt(10, 3)}, 0),
                         ({1: b[16:]}, 16)):
        suffix = np.zeros((NS, tb), np.int32)
        slen = np.zeros((NS,), np.int32)
        st = np.zeros((NS,), np.int32)
        for i, t in tails.items():
            suffix[i, :t.shape[0]] = t
            slen[i] = t.shape[0]
            st[i] = start
        jfn = jsv.make_paged_prefill(JCFG, mesh1, tb, NS, ps, mp, npg)
        tfn = tsv.make_paged_prefill(TCFG, tb, NS, ps, mp, npg)
        jstate, tstate, first = _both(jfn, tfn, jstate, tstate, sparams,
                                      tparams, bt, suffix, slen, st)
        assert (first[slen == 0] == -1).all()
    assert tstate[2].tolist() == [21, 23, 10, 0]
    active = np.array([True, True, True, False])
    rem = np.array([4, 2, 1, 3], np.int32)
    jfn = jsv.make_paged_decode(JCFG, mesh1, 4, NS, ps, mp, npg)
    tfn = tsv.make_paged_decode(TCFG, 4, NS, ps, mp, npg)
    _, _, toks = _both(jfn, tfn, jstate, tstate, sparams, tparams, bt,
                       active, rem)
    assert (toks[3] == -1).all() and (toks[2, 1:] == -1).all()


@pytest.mark.parametrize("draft_layers", [0, 1])
def test_paged_spec_round_matches_jax(mesh1, jparams, tparams,
                                      draft_layers):
    """After a paged prefill, two speculative rounds (K=4): slot 1's
    budget ends mid-window, slot 2 is poisoned, slot 1's window runs past
    its mapped pages and slot 3's past S (those rows land on the scratch
    page), then every slot active. Pools at 1e-5, every int output
    exactly."""
    mp = tpg.pages_for(FIELDS["max_len"], PS)
    lens = {0: 5, 1: 12, 2: 9, 3: FIELDS["max_len"] - 3}
    bt = np.zeros((NS, mp), np.int32)
    nxt = 1
    for i, n in lens.items():
        k = min(mp, tpg.pages_for(n + 1, PS))      # prompt + 1 row
        bt[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    npg = nxt + 1
    sparams = jsv.shard_serving_params(jparams, JCFG, mesh1)
    jstate = tuple(jsv.init_paged_state(JCFG, mesh1, NS, PS, npg))
    tstate = tsv.init_paged_state(TCFG, NS, PS, npg, "cpu")
    tb = FIELDS["max_len"]
    suffix = np.zeros((NS, tb), np.int32)
    slen = np.zeros((NS,), np.int32)
    for i, n in lens.items():
        suffix[i, :n] = _prompt(n, 20 + i)
        slen[i] = n
    jstate, tstate, _ = _both(
        jsv.make_paged_prefill(JCFG, mesh1, tb, NS, PS, mp, npg),
        tsv.make_paged_prefill(TCFG, tb, NS, PS, mp, npg), jstate, tstate,
        sparams, tparams, bt, suffix, slen, np.zeros((NS,), np.int32))
    key = jax.random.PRNGKey(0)
    jfn = jsv.make_paged_speculative_decode(JCFG, mesh1, 4, NS, PS, mp,
                                            npg, draft_layers=draft_layers)
    tfn = tsv.make_paged_speculative_decode(TCFG, 4, NS, PS, mp, npg,
                                            draft_layers=draft_layers)
    for active, rem, poison in (
            (np.ones(NS, bool), np.array([10, 2, 10, 10], np.int32),
             np.array([0, 0, 1, 0], bool)),
            (np.ones(NS, bool), np.array([10, 1, 10, 1], np.int32),
             np.zeros(NS, bool))):
        *jstate, je, jc, jd, ja = jfn(
            sparams, sparams, *jstate, jnp.asarray(bt), jnp.asarray(active),
            jnp.asarray(rem), jnp.asarray(poison), key)
        *tstate, te, tc, td, ta = tfn(
            tparams, tparams, *tstate, torch.from_numpy(bt),
            torch.from_numpy(active), torch.from_numpy(rem),
            torch.from_numpy(poison), 0)
        _assert_pool(tstate, jstate)
        for name, t, j in (("emit", te, je), ("ncommit", tc, jc),
                           ("drafted", td, jd), ("accepted", ta, ja)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


@pytest.mark.parametrize("kw,match", [
    (dict(page_size=0, num_pages=8, max_pages=12), "page_size must be"),
    (dict(page_size=8, num_pages=1, max_pages=12), "num_pages must be"),
    (dict(page_size=8, num_pages=8, max_pages=11), "cannot address"),
])
def test_paged_geometry_errors_match_jax(mesh1, kw, match):
    """`_check_paged` keeps the reference's errors word for word."""
    with pytest.raises(ValueError, match=match) as want:
        jsv.make_paged_decode(JCFG, mesh1, 2, NS, **kw)
    with pytest.raises(ValueError) as got:
        tsv.make_paged_decode(TCFG, 2, NS, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the engine against JAX's, and against the contiguous pool
# ---------------------------------------------------------------------------

def _shared_mix(n_shared=3, n_unique=2):
    """Co-tenant traffic: n_shared prompts open with one 18-token system
    prompt (2 full 8-token pages) and distinct tails; n_unique do not."""
    rng = np.random.default_rng(11)
    sys_prompt = rng.integers(0, FIELDS["vocab_size"], 18).astype(np.int32)
    out = [np.concatenate([sys_prompt, rng.integers(
        0, FIELDS["vocab_size"], 2 + i).astype(np.int32)])
        for i in range(n_shared)]
    out += [rng.integers(0, FIELDS["vocab_size"], 7 + 3 * i).astype(
        np.int32) for i in range(n_unique)]
    return out


BASE = dict(num_slots=NS, decode_chunk=2, max_new_tokens=6)
PAGED = dict(paged=True, page_size=PS)


def _port(tparams, **kw):
    return teng.InferenceEngine(TCFG, tparams,
                                teng.EngineConfig(**{**BASE, **kw}),
                                device="cpu")


def _serve(eng, prompts, waves=1):
    out = []
    for _ in range(waves):
        hs = [eng.submit(p) for p in prompts]
        eng.run_pending()
        out += [h.result() for h in hs]
    return out


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("extra", [{}, dict(spec_decode=True, spec_k=3,
                                            draft="self")])
def test_paged_engine_matches_jax_engine(mesh1, jparams, tparams, extra,
                                         pipeline):
    """The shared-prefix mix twice (the second wave all prefix hits, one
    of them full: copy-on-write): tokens equal JAX's paged engine, and
    so do the prefix-cache hits, misses and shared tokens."""
    extra = dict(extra, pipeline=pipeline)
    jengine = jeng.InferenceEngine(JCFG, mesh1, jparams, jeng.EngineConfig(
        backoff_base_s=0.0, **BASE, **PAGED, **extra))
    tengine = _port(tparams, **PAGED, **extra)
    prompts = _shared_mix() + [_prompt(16, 5)]
    want = _serve(jengine, prompts, waves=2)
    got = _serve(tengine, prompts, waves=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jc = jengine.debugz()["paged"]["prefix_cache"]
    c = tengine.counts
    assert (c["prefix_hits"], c["prefix_misses"],
            c["prefix_shared_tokens"]) == \
        (jc["hits"], jc["misses"], jc["shared_tokens"])
    assert c["prefix_hits"] > 0 and c["cow_copies"] > 0
    assert c["pages_used"] == tengine.prefix_cache_pages   # no leak


@pytest.mark.parametrize("chunk", [2, 5])
def test_paged_matches_contiguous(tparams, chunk):
    """Paged with prefix sharing equals the contiguous engine, fresh
    admissions and a second wave of prefix hits alike."""
    want = _serve(_port(tparams, decode_chunk=chunk), _shared_mix())
    eng = _port(tparams, decode_chunk=chunk, **PAGED)
    got = _serve(eng, _shared_mix(), waves=2)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % len(want)])
    # the second wave: every prompt holding a full page hits
    assert eng.counts["prefix_hits"] == sum(p.shape[0] >= PS
                                            for p in _shared_mix())


def test_paged_sampled_decode_matches_contiguous(tparams):
    """Position-keyed sampling is page-placement independent."""
    kw = dict(temperature=0.8, top_k=5, seed=3)
    want = _serve(_port(tparams, **kw), _shared_mix())
    got = _serve(_port(tparams, **PAGED, **kw), _shared_mix())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_prefix_hit_skips_prefill_compute(tparams):
    """A second request with the same 26-token prompt maps 3 cached pages
    (24 tokens) and prefills only its 2-token tail, in a 4-token bucket:
    one prefill call per admission, the pages shared, the output equal."""
    p26 = _prompt(26, 7)
    eng = _port(tparams, prefill_bucket_min=4, **PAGED)
    a = eng.submit(p26)
    eng.run_pending()
    b = eng.submit(p26)
    eng.tick()
    assert b._page_start == 24 and a._page_start == 0
    assert eng.counts["prefill_calls"] == 2
    assert ("paged_prefill", 4) in eng._programs
    eng.run_pending()
    np.testing.assert_array_equal(a.result(), b.result())
    assert eng.counts["prefix_shared_tokens"] == 24


def test_cow_on_full_prefix_hit(tparams):
    """A full-prefix hit (24 tokens, 3 full pages) recomputes its last
    token in a copy of the boundary page; the diverging tenant and later
    re-readers of the original prefix stay exact: the shared page was
    never written."""
    p24 = _prompt(24, 5)
    tail = np.concatenate([p24, _prompt(3, 9)])
    want = _serve(_port(tparams), [p24, tail])
    eng = _port(tparams, **PAGED)
    a, = _serve(eng, [p24])
    b, = _serve(eng, [p24])                 # full-prefix hit -> copy
    assert eng.counts["cow_copies"] == 1
    c, = _serve(eng, [tail])
    d, = _serve(eng, [p24])
    for h in (a, b, d):
        np.testing.assert_array_equal(h, want[0])
    np.testing.assert_array_equal(c, want[1])


def test_page_exhaustion_blocks_admission_then_proceeds(tparams):
    """A pool with room for one resident: the second request stays queued
    (blocked, not shed) until the first frees its pages and its cached
    page is LRU-evicted, then completes with its exact solo tokens."""
    eng = _port(tparams, kv_pages=3, **PAGED)
    a = eng.submit(_prompt(9, 1))
    b = eng.submit(_prompt(9, 2))
    assert eng.tick()
    assert (a.status, b.status) == (teng.RequestStatus.RUNNING,
                                    teng.RequestStatus.QUEUED)
    eng.run_pending()
    assert a.done() and b.done()
    assert eng.counts["prefix_evictions"] >= 1
    for h in (a, b):
        np.testing.assert_array_equal(h.result(),
                                      _serve(_port(tparams), [h.prompt])[0])


@pytest.mark.parametrize("case", ["submit", "seat"])
def test_request_that_can_never_fit(tparams, case):
    """Needing more pages than the pool holds is refused at submit; a
    full-prefix hit that needs one page more than the pool (the copy of
    its boundary page) while no slot holds pages is shed with
    OverloadError at seating, not left to block forever."""
    eng = _port(tparams, kv_pages=5, **PAGED)        # 4 usable pages
    if case == "submit":
        with pytest.raises(ValueError, match="KV pages"):
            eng.submit(_prompt(30, 0), max_new_tokens=6)
        return
    p24 = _prompt(24, 5)                             # 24 + 6 -> 4 pages
    _serve(eng, [p24])
    h = eng.submit(p24)
    eng.run_pending()
    assert h.status == teng.RequestStatus.SHED
    with pytest.raises(teng.OverloadError, match="KV pages"):
        h.result()
    assert eng.counts["shed_overload"] == 1


@pytest.mark.parametrize("extra", [{}, dict(spec_decode=True, spec_k=3,
                                            draft="layers:1"),
                                   dict(prefill_chunk=5)])
def test_scratch_page_poison_changes_no_token(tparams, extra):
    """Page 0 filled with 1e4 before any request (pad rows, inactive
    slots and unmapped table entries all touch it): no token changes."""
    prompts = _shared_mix()
    want = _serve(_port(tparams, **PAGED, **extra), prompts, waves=2)
    eng = _port(tparams, **PAGED, **extra)
    eng._ensure_state()
    for plane in eng._slot_state[:2]:
        plane[:, 0] = 1e4
    got = _serve(eng, prompts, waves=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the host-side paging module, the port's copy and JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paging", [tpg, jpg], ids=["port", "jax"])
def test_page_allocator_refcounts(paging):
    al = paging.PageAllocator(num_pages=4, page_size=8)
    assert al.usable_pages == 3
    a, b = al.alloc(), al.alloc()
    assert {a, b}.isdisjoint({0})
    al.incref(a)
    al.decref(a)
    assert al.refcount(a) == 1 and al.pages_free == 1
    al.decref(a)
    assert al.pages_free == 2
    with pytest.raises(ValueError):
        al.decref(a)
    c, d = al.alloc(), al.alloc()
    assert al.alloc() is None                  # exhausted
    assert {b, c, d} == {1, 2, 3} and al.pages_used == 3


@pytest.mark.parametrize("paging", [tpg, jpg], ids=["port", "jax"])
def test_radix_cache_match_insert_evict(paging):
    al = paging.PageAllocator(num_pages=8, page_size=2)
    cache = paging.RadixPrefixCache(2, al)
    pages = [al.alloc() for _ in range(3)]
    cache.insert([1, 2, 3, 4, 5, 6], pages)
    assert len(cache) == 3
    assert [al.refcount(p) for p in pages] == [2, 2, 2]
    assert cache.match([1, 2, 3, 4, 9, 9]) == pages[:2]
    assert cache.match([7, 7]) == []
    for p in pages:                            # owner departs
        al.decref(p)
    assert cache.evict(1) == 1 and len(cache) == 2
    assert cache.match([1, 2, 3, 4, 5, 6]) == pages[:2]
    assert cache.evict(10) == 2 and len(cache) == 0
    assert al.pages_free == al.usable_pages
    pages2 = [al.alloc() for _ in range(2)]
    cache.insert([1, 2, 3, 4], pages2)
    for p in pages2:
        al.decref(p)
    assert cache.flush() == 2
    assert al.pages_free == al.usable_pages


def test_chain_hashes_match_jax():
    """The copy hashes prefixes as the reference does (fleet routing
    compares hashes across processes)."""
    toks = _prompt(40, 3).tolist()
    assert tpg.chain_hashes(toks, 8) == jpg.chain_hashes(toks, 8)
    assert tpg.ROOT_CHAIN_HASH == jpg.ROOT_CHAIN_HASH

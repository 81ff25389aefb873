"""Port parity: chunked prefill and the token-budget scheduler.

The JAX side runs on a 1x1 mesh through its plain reference paths
(DL4JTPU_FLASH unset) and its engine with both loops, each against the
same loop of the port's, as tests/test_torch_serving.py does; both sides hold one JAX `init_params`
tree converted with `params_from_numpy`. Tolerances: caches 1e-5 (a paged
pool's scratch page 0 excluded); pos, tok and first exactly (greedy);
engine results token-exact. The port's own contracts (chunked ≡ one-shot
≡ `generate`, oldest-first prefill, the stall bound, spec with chunked
prefill) are copied from tests/test_serving_chunked.py; fair-share
prefill and grammar constraints, which once raised with them, serve.
"""
import functools

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

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.quant import model as tqm  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402
from deeplearning4j_tpu_torch.serving.paging import pages_for  # noqa

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=96)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
NS = 4
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


# ---------------------------------------------------------------------------
# the programs against JAX's
# ---------------------------------------------------------------------------

def _chunk_schedule(prompts, begin, c):
    """The calls that prefill ``prompts`` {slot: tokens} in chunks of c,
    slot i joining at call begin[i] (a slot passes through, clen 0,
    before it joins and after it ends): [(toks, clen, start, last)]."""
    done = {i: 0 for i in prompts}
    calls = []
    n = 0
    while any(done[i] < p.shape[0] for i, p in prompts.items()):
        toks = np.zeros((NS, c), np.int32)
        clen = np.zeros((NS,), np.int32)
        start = np.zeros((NS,), np.int32)
        last = np.zeros((NS,), bool)
        for i, p in prompts.items():
            if n < begin[i] or done[i] >= p.shape[0]:
                continue
            k = min(c, p.shape[0] - done[i])
            toks[i, :k] = p[done[i]:done[i] + k]
            clen[i], start[i] = k, done[i]
            done[i] += k
            last[i] = done[i] == p.shape[0]
        calls.append((toks, clen, start, last))
        n += 1
    return calls


def _check_state(tstate, jstate, paged):
    for name, t, j in zip(("k", "v", "pos", "tok"), tstate, jstate):
        t, j = t.numpy(), np.asarray(j)
        if name in ("k", "v"):
            if paged:
                t, j = t[:, 1:], j[:, 1:]
            np.testing.assert_allclose(t, j, **CACHE, err_msg=name)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


def _run_chunks(jfn, tfn, jstate, tstate, sparams, tparams, calls, lead=(),
                paged=False):
    key = jax.random.PRNGKey(0)
    for toks, clen, start, last in calls:
        args = (*lead, toks, clen, start, last)
        *jstate, jfirst = jfn(sparams, *jstate,
                              *(jnp.asarray(a) for a in args), key)
        *tstate, tfirst = tfn(tparams, *tstate,
                              *(torch.from_numpy(a) for a in args), 0)
        _check_state(tstate, jstate, paged)
        np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
        # mid-prompt chunks and idle slots report no first token
        assert (tfirst.numpy()[~last] == -1).all()
    return tstate


PROMPTS = {0: _prompt(21, 1), 2: _prompt(10, 2), 3: _prompt(90, 3)}
BEGIN = {0: 0, 2: 1, 3: 0}


@pytest.mark.parametrize("c", [3, 40])
def test_chunked_prefill_program_matches_jax(mesh1, jparams, tparams, c):
    """Three prompts on the contiguous pool in chunks of c (slot 2 joins
    one call late, slot 1 never advances, slot 3's last chunk at c=40 has
    pad rows past S): caches at 1e-5, pos, tok and first exactly."""
    sparams = jsv.shard_serving_params(jparams, JCFG, mesh1)
    jstate = tuple(jsv.init_slot_state(JCFG, mesh1, NS))
    tstate = tsv.init_slot_state(TCFG, NS, "cpu")
    tstate = _run_chunks(jsv.make_chunked_prefill(JCFG, mesh1, c, NS),
                         tsv.make_chunked_prefill(TCFG, c, NS), jstate,
                         tstate, sparams, tparams,
                         _chunk_schedule(PROMPTS, BEGIN, c))
    assert tstate[2].tolist() == [21, 0, 10, 90]


@pytest.mark.parametrize("ps", [4, 8])
def test_paged_chunked_prefill_program_matches_jax(mesh1, jparams, tparams,
                                                   ps):
    """The same prompts in chunks of 5 on the paged pool, slot 1 resuming
    at 16 over pages slot 0 wrote (a prefix hit inside a chunk
    schedule): pools at 1e-5 (page 0 excluded), ints exactly."""
    mp = pages_for(FIELDS["max_len"], ps)
    bt = np.zeros((NS, mp), np.int32)
    nxt = 1
    for i, p in PROMPTS.items():
        k = pages_for(p.shape[0], ps)
        bt[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    shared = 16 // ps
    bt[1, :shared] = bt[0, :shared]
    bt[1, shared:shared + 2] = [nxt, nxt + 1]
    npg = nxt + 2
    sparams = jsv.shard_serving_params(jparams, JCFG, mesh1)
    jstate = tuple(jsv.init_paged_state(JCFG, mesh1, NS, ps, npg))
    tstate = tsv.init_paged_state(TCFG, NS, ps, npg, "cpu")
    jfn = jsv.make_paged_chunked_prefill(JCFG, mesh1, 5, NS, ps, mp, npg)
    tfn = tsv.make_paged_chunked_prefill(TCFG, 5, NS, ps, mp, npg)
    calls = _chunk_schedule(PROMPTS, BEGIN, 5)
    # then slot 1 resumes at 16 over slot 0's pages: 7 tokens in 5 + 2
    tail = _prompt(7, 4)
    for lo, n, last in ((0, 5, False), (5, 2, True)):
        toks = np.zeros((NS, 5), np.int32)
        toks[1, :n] = tail[lo:lo + n]
        calls.append((toks, np.array([0, n, 0, 0], np.int32),
                      np.array([0, 16 + lo, 0, 0], np.int32),
                      np.array([False, last, False, False])))
    tstate = _run_chunks(jfn, tfn, jstate, tstate, sparams, tparams, calls,
                         lead=(bt,), paged=True)
    assert tstate[2].tolist() == [21, 23, 10, 90]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

BASE = dict(num_slots=NS, decode_chunk=2, max_new_tokens=6,
            prefill_chunk=8)


def _port(tparams, **kw):
    return teng.InferenceEngine(TCFG, tparams,
                                teng.EngineConfig(**{**BASE, **kw}),
                                device="cpu")


def _serve(eng, prompts, max_new=None):
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_pending()
    return [h.result() for h in hs]


def _solo(tparams, prompt, max_new, **kw):
    """The one-shot (prefill_chunk None) engine's result for prompt."""
    return _serve(_port(tparams, prefill_chunk=None, max_new_tokens=max_new,
                        **kw), [prompt], max_new)[0]


def _mix():
    sys_prompt = _prompt(18, 30)
    return ([np.concatenate([sys_prompt, _prompt(3 + i, 31 + i)])
             for i in range(3)] + [_prompt(n, 40 + n) for n in (7, 33, 12)])


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
@pytest.mark.parametrize("paged", [False, True])
def test_chunked_engine_matches_jax_engine(mesh1, jparams, tparams, paged,
                                           pipeline):
    """Six requests through 4 slots with prefill_chunk 5 and the default
    budget, twice (paged: the second wave prefix hits): tokens equal the
    JAX chunked engine's, and so do the prefix-cache counts."""
    kw = dict(prefill_chunk=5, max_new_tokens=7, pipeline=pipeline)
    if paged:
        kw.update(paged=True, page_size=8)
    jengine = jeng.InferenceEngine(JCFG, mesh1, jparams, jeng.EngineConfig(
        backoff_base_s=0.0, **{**BASE, **kw}))
    tengine = _port(tparams, **kw)
    for _ in range(2):
        want = _serve(jengine, _mix())
        got = _serve(tengine, _mix())
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tengine.counts["prefill_chunks"] > len(_mix())
    if paged:
        jc = jengine.debugz()["paged"]["prefix_cache"]
        c = tengine.counts
        assert (c["prefix_hits"], c["prefix_misses"],
                c["prefix_shared_tokens"]) == \
            (jc["hits"], jc["misses"], jc["shared_tokens"])
        assert c["pages_used"] == tengine.prefix_cache_pages


@pytest.mark.parametrize("chunk", [3, 8, 24, 40])
def test_chunked_matches_oneshot_and_generate(jparams, tparams, chunk):
    """Every chunk size, uneven, whole-prompt and larger than the prompt,
    reproduces the one-shot engine, the port's `generate` and JAX's."""
    p = _prompt(24, 0)
    want = np.asarray(jtf.generate(JCFG, jparams, p[None], 6,
                                   key=jax.random.PRNGKey(0),
                                   temperature=0.0))[0]
    got, = _serve(_port(tparams, prefill_chunk=chunk), [p])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_solo(tparams, p, 6), want)
    np.testing.assert_array_equal(
        ttf.generate(TCFG, tparams, torch.from_numpy(p)[None], 6,
                     temperature=0.0)[0].numpy(), want)


@pytest.mark.parametrize("chunk", [4, 7])
def test_chunked_sampled_continuations_bit_identical(tparams, chunk):
    """Sampled decode is chunk-invariant: draws are keyed by absolute
    position, whatever chunk boundary produced the first token."""
    kw = dict(temperature=0.8, top_k=5)
    ref = _solo(tparams, _prompt(20, 2), 8, **kw)
    got, = _serve(_port(tparams, prefill_chunk=chunk, max_new_tokens=8,
                        **kw), [_prompt(20, 2)])
    np.testing.assert_array_equal(got, ref)


def test_chunked_paged_fresh_and_prefix_hit_resume(tparams):
    """Paged pool, page_size 4, chunks of 5: a fresh admission and a
    full-prefix hit, whose chunked prefill resumes at 23 (no chunk
    boundary), both equal the one-shot paged engine."""
    ref = _solo(tparams, _prompt(24, 0), 6, paged=True, page_size=4)
    eng = _port(tparams, prefill_chunk=5, paged=True, page_size=4)
    for _ in range(2):
        got, = _serve(eng, [_prompt(24, 0)])
        np.testing.assert_array_equal(got, ref)
    assert eng.counts["prefix_hits"] == 1 and eng.counts["cow_copies"] == 1


def test_prefill_is_oldest_first(tparams):
    """Two long admissions share an 8-token budget oldest first: the
    younger never samples before the older."""
    eng = _port(tparams, tick_token_budget=8, max_new_tokens=2)
    a = eng.submit(_prompt(40, 1))
    b = eng.submit(_prompt(40, 2))
    while not (a.done() and b.done()):
        eng.tick()
        if a.generated.shape[0] == 0:
            assert b.generated.shape[0] == 0, \
                "younger admission sampled before the older one"


def test_decode_never_stalls_while_long_prompt_prefills(tparams):
    """Three residents decode while an 80-token prompt prefills under a
    12-token budget: every tick each resident commits one decode chunk,
    and no tick runs more than ceil(budget / prefill_chunk) chunk calls
    (the one-shot engine would run the whole prompt in one call)."""
    budget, pfc, dchunk = 12, 8, 2
    eng = _port(tparams, prefill_chunk=pfc, tick_token_budget=budget,
                decode_chunk=dchunk, max_new_tokens=16)
    residents = [eng.submit(_prompt(6, i), max_new_tokens=16)
                 for i in range(3)]
    while any(r.generated.shape[0] == 0 for r in residents):
        eng.tick()                         # all three decoding
    long_req = eng.submit(_prompt(80, 9), max_new_tokens=4)
    ticks = 0
    while ticks == 0 or eng._is_prefilling(long_req):
        before = [r.generated.shape[0] for r in residents]
        calls = eng.counts["prefill_calls"]
        eng.tick()
        ticks += 1
        for r, b in zip(residents, before):
            assert r.generated.shape[0] == min(b + dchunk, 16), \
                "resident stalled while the long prompt prefilled"
        assert eng.counts["prefill_calls"] - calls <= -(-budget // pfc)
    assert ticks >= 80 // budget
    eng.run_pending()
    for i, r in enumerate(residents):
        np.testing.assert_array_equal(r.result(),
                                      _solo(tparams, _prompt(6, i), 16))
    np.testing.assert_array_equal(long_req.result(),
                                  _solo(tparams, _prompt(80, 9), 4))


@pytest.mark.parametrize("paged", [False, True])
def test_spec_with_chunked_prefill_token_exact(tparams, paged):
    """Prefilling slots sit out the spec rounds; a slot joins the tick
    after its first token, and the spec engine equals the plain chunked
    engine while a long admission prefills mid-pool."""
    kw = dict(prefill_chunk=4, tick_token_budget=6, max_new_tokens=10)
    if paged:
        kw.update(paged=True, page_size=8)

    def run(**extra):
        eng = _port(tparams, **kw, **extra)
        a = eng.submit(_prompt(6, 1), max_new_tokens=10)
        eng.tick()
        b = eng.submit(_prompt(30, 2), max_new_tokens=4)
        eng.run_pending()
        return eng, a.result(), b.result()

    _, a_ref, b_ref = run()
    eng, a, b = run(spec_decode=True, spec_k=3, draft="self")
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(b, b_ref)
    assert eng.counts["spec_drafted"] > 0


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def test_default_budget_is_decode_bill_plus_one_chunk(tparams):
    eng = _port(tparams, num_slots=3, decode_chunk=5, prefill_chunk=7)
    assert eng._tick_budget == 3 * 5 + 7


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=None, tick_token_budget=64), "tick_token_budget"),
    (dict(prefill_chunk=0), "prefill_chunk"),
    (dict(prefill_chunk=97), "prefill_chunk"),
    (dict(paged=True, page_size=0), "page_size"),
])
def test_chunked_and_paged_config_errors(tparams, kw, match):
    with pytest.raises(ValueError, match=match):
        _port(tparams, **kw)


@pytest.mark.parametrize("use", [dict(paged=True), dict(prefill_chunk=8)])
@pytest.mark.parametrize("field,value,item", [
    ("tenant_weights", {"a": 1.0}, "item 9"),
])
def test_unported_combinations_raise(mesh1, jparams, tparams, use, field,
                                     value, item):
    """Paged KV or chunked prefill with fair-share prefill (``field``,
    which raised here until ROADMAP queue A ``item`` 9b ported it): the
    weighted deficit scheduler serves two tenants on the paged chunked
    and the chunked pool as JAX's engine does, the granted prefill
    tokens by tenant and every token equal."""
    kw = {**BASE, "prefill_chunk": 8, **use, field: value,
          "tick_token_budget": 12, "pipeline": False}
    kw[field] = dict(value, b=3.0)
    reqs = [(p, "a" if i % 2 else "b") for i, p in enumerate(_mix())]
    jengine = jeng.InferenceEngine(JCFG, mesh1, jparams,
                                   jeng.EngineConfig(**kw))
    tengine = _port(tparams, **kw)
    out = []
    for eng in (jengine, tengine):
        hs = [eng.submit(p, tenant=t) for p, t in reqs]
        eng.run_pending()
        grants = {t: eng._m_qos_prefill_tokens.labels(t).value
                  for t in ("a", "b")}
        out.append(([h.result().tolist() for h in hs], grants))
    assert out[1] == out[0]
    assert out[1][1]["a"] > 0 and out[1][1]["b"] > 0
    assert sum(out[1][1].values()) == sum(p.shape[0] for p, _ in reqs) - (
        tengine.counts["prefix_shared_tokens"] if use.get("paged") else 0)


@pytest.mark.parametrize("use", [dict(paged=True), dict(prefill_chunk=8)])
def test_constrained_combinations_serve(tparams, use):
    """Paged KV or chunked prefill with a grammar table (which raised here
    before grammar constraints were ported) serves constrained and
    unconstrained requests as the contiguous one-shot engine does, token
    for token; every constrained token is a digit (this vocabulary's
    bytes 0-63) and ``[0-9]{1,3}`` stops at 3."""
    reqs = [(p, spec) for p, spec in zip(
        _mix(), ("[0-9]{1,3}", None, "[0-9]+", None, "[0-9]{1,3}", None))]

    def run(**kw):
        eng = _port(tparams, constrain_state_cap=64, **kw)
        hs = [eng.submit(p, constrain=c) for p, c in reqs]
        eng.run_pending()
        return [h.result()[p.shape[0]:] for h, (p, _) in zip(hs, reqs)]

    want = run(prefill_chunk=None)
    got = run(**{"prefill_chunk": None, **use})
    for g, w, (_, spec) in zip(got, want, reqs):
        np.testing.assert_array_equal(g, w)
        if spec is not None:
            assert set(g.tolist()) <= set(range(48, 58))
            assert g.shape[0] == (3 if spec.endswith("}") else 6)


@pytest.mark.parametrize("use", [dict(paged=True), dict(prefill_chunk=8)])
def test_pipelined_combinations_serve(tparams, use):
    """Paged KV or chunked prefill with the pipelined loop (the default,
    which raised here before the loop was ported) serves the mix as the
    synchronous loop does, token for token, and leaves nothing in
    flight."""
    kw = {"prefill_chunk": None, **use}
    want = _serve(_port(tparams, pipeline=False, **kw), _mix())
    eng = _port(tparams, pipeline=True, **kw)
    got = _serve(eng, _mix())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.counts["pipelined_ticks"] > 0 and eng.drained()


@pytest.mark.parametrize("use", [dict(paged=True), dict(prefill_chunk=8)])
@pytest.mark.parametrize("field", ["kv_quantize", "quantize"])
def test_quantized_combinations_serve(tparams, use, field):
    """Paged KV (prefix cache off) or chunked prefill with the int8 pool
    or the int8 tree serves the mix as the contiguous one-shot engine of
    the same mode does, token for token."""
    q = {field: "int8"}
    want = _serve(_port(tparams, prefill_chunk=None, **q), _mix())
    kw = {"prefill_chunk": None, **use, **q}
    if "paged" in use:
        kw.update(page_size=8, prefix_cache=False)
    eng = _port(tparams, **kw)
    got = _serve(eng, _mix())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (len(eng._slot_state) == 6) == (field == "kv_quantize")


def test_chunked_prefill_program_on_the_quantized_pool(tparams):
    """The chunked prefill program on the int8 pool: a chunk writes int8
    rows with their scales, the rest of the pool keeps value 0 and
    scale 1.0."""
    state = tsv.init_slot_state(TCFG, NS, "cpu", kv_mode="int8")
    fn = tsv.make_chunked_prefill(TCFG, 8, NS, kv_mode="int8")
    toks = np.zeros((NS, 8), np.int32)
    toks[1, :5] = _prompt(5, 3)
    clen = np.array([0, 5, 0, 0], np.int32)
    out = fn(tparams, *state, torch.from_numpy(toks),
             torch.from_numpy(clen), torch.zeros(NS, dtype=torch.int32),
             torch.ones(NS, dtype=torch.bool), 0)
    ck, ks, pos = out[0], out[2], out[4]
    assert ck.dtype == torch.int8 and pos.tolist() == [0, 5, 0, 0]
    assert (ck[:, 1, :5] != 0).any() and (ks[:, 1, :5] != 1.0).all()
    assert (ks[:, 1, 5:] == 1.0).all() and (ks[:, [0, 2, 3]] == 1.0).all()


def test_paged_prefill_takes_a_quantized_tree(tparams):
    """A quantized tree needs no program option: paged prefill over it
    equals the run over its dequantized float tree, bit for bit."""
    qtree = tqm.quantize_params(tparams, mode="int8")
    fn = tsv.make_paged_prefill(TCFG, 8, NS, 8, 12, 20)
    bt = np.zeros((NS, 12), np.int32)
    bt[0, :2] = [1, 2]
    suffix = np.zeros((NS, 8), np.int32)
    suffix[0, :7] = _prompt(7, 4)
    slen = np.array([7, 0, 0, 0], np.int32)
    args = (torch.from_numpy(bt), torch.from_numpy(suffix),
            torch.from_numpy(slen), torch.zeros(NS, dtype=torch.int32), 0)
    outs = [fn(tree, *tsv.init_paged_state(TCFG, NS, 8, 20, "cpu"), *args)
            for tree in (qtree, tqm.dequantize_params(qtree))]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_paged_state_on_the_quantized_pool():
    """init_paged_state(kv_mode="int8"): int8 pages and float32 scale
    planes [L, pages, page_size, 1] of 1.0 before pos and tok."""
    kp, vp, ks, vs, pos, tok = tsv.init_paged_state(TCFG, NS, 8, 20, "cpu",
                                                    kv_mode="int8")
    assert kp.dtype == vp.dtype == torch.int8
    assert tuple(kp.shape[:3]) == (FIELDS["n_layers"], 20, 8)
    for plane in (ks, vs):
        assert plane.dtype == torch.float32
        assert tuple(plane.shape) == (FIELDS["n_layers"], 20, 8, 1)
        assert (plane == 1.0).all()
    assert tuple(pos.shape) == tuple(tok.shape) == (NS,)


@pytest.mark.parametrize("kind", ["paged_decode_constrain",
                                  "chunked_constrain"])
def test_constrained_program_variants_serve(tparams, kind):
    """The paged decode and chunked prefill programs' constrain=True
    variants (which raised here before they were ported) with every slot
    on the all-allow row 0 return the unmasked program's outputs and pool
    bit for bit, and the states stay 0; a slot seeded to a one-token
    grammar's row can emit only that token."""
    from deeplearning4j_tpu_torch.serving.constrain import (
        ConstraintTable, compile_grammar)
    tab = ConstraintTable(8, FIELDS["vocab_size"])
    row = tab.acquire(compile_grammar("0", FIELDS["vocab_size"]))
    callow, ctrans = tab.device("cpu")
    toks = np.zeros((NS, 8), np.int32)
    toks[:, :6] = _prompt(6, 9)
    clen = np.array([6, 6, 6, 0], np.int32)
    if kind == "chunked_constrain":
        make = functools.partial(tsv.make_chunked_prefill, TCFG, 8, NS)
        pool = functools.partial(tsv.init_slot_state, TCFG, NS, "cpu")
        args = [torch.from_numpy(x) for x in (
            toks, clen, np.zeros((NS,), np.int32), np.ones((NS,), bool))]
    else:
        make = functools.partial(tsv.make_paged_decode, TCFG, 2, NS, 8, 12,
                                 49)
        pool = functools.partial(tsv.init_paged_state, TCFG, NS, 8, 49,
                                 "cpu")
        bt = (1 + np.arange(NS * 12, dtype=np.int32)).reshape(NS, 12)
        args = [torch.from_numpy(x) for x in (
            bt, np.ones((NS,), bool), np.array([2, 2, 1, 0], np.int32))]
    want_state = pool()
    want = make()(tparams, *want_state, *args, 0)
    for seeds, check in ((np.zeros(NS, bool), "row0"),
                         (np.array([1, 0, 0, 0], bool), "seeded")):
        state = pool()
        cstate = torch.zeros(NS, dtype=torch.int32)
        got = make(constrain=True)(
            tparams, *state, *args, callow, ctrans, cstate,
            torch.from_numpy(seeds), torch.full((NS,), row,
                                                dtype=torch.int32), 0)
        assert got[-1] is cstate
        if check == "row0":
            for g, w in zip(got[:-1], want):
                assert torch.equal(g, w)
            assert cstate.tolist() == [0] * NS
        else:
            # "0" is byte 48: the seeded slot's first sampled token
            first = got[len(state)].reshape(NS, -1)[0, 0]
            assert int(first) == 48 and int(cstate[0]) != row
            for g, w in zip(got[len(state):-1], want[len(state):]):
                assert torch.equal(g[1:], w[1:])

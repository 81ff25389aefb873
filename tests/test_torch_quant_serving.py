"""Port parity: quantized serving (programs and engines) against JAX's.

The JAX side runs on a 1x1 mesh through its plain reference paths
(DL4JTPU_FLASH unset) and its engine with both loops, each against the
same loop of the port's (the engine parity tests), as
tests/test_torch_serving.py does; a quantized JAX tree is placed with
`shard_quantized_serving_params`. Both sides start from one JAX
`init_params` tree (`params_from_numpy`); the port quantizes it itself
(its int8 bytes equal JAX's, tests/test_torch_quant.py).

Tolerances: pos, tok, first and emitted tokens exactly; engines
token-exact (greedy). The pools: the K/V rows come from float32 products
that the two sides sum in other orders, a few ulps apart, so the float32
row scales (absmax / 127) agree to 1e-6 relative, and an int8 value whose
row lands on a half step may round to either neighbour: values within 1
of JAX's (all but a handful equal), dequantized rows within one step of
their scale (the paged pools' scratch page 0 excluded, as in
tests/test_torch_paged.py). Prefix hits on
an int8 pool re-read the shared prefix through its quantization, so they
are held to JAX's envelope (>= 0.8 of the tokens of the int8 run without
hits, tests/test_serving_paged.py:146-165) and to JAX's own paged int8
engine, token for token.
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
from deeplearning4j_tpu.quant import kv as jkv  # noqa: E402
from deeplearning4j_tpu.quant import model as jqm  # noqa: E402
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402
from deeplearning4j_tpu.serving import paging as jpg  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.quant import core as tq  # noqa: E402
from deeplearning4j_tpu_torch.quant import kv as tkv  # noqa: E402
from deeplearning4j_tpu_torch.quant import model as tqm  # noqa: E402
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=96)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
NS = 4
PS = 8
SCALES = dict(rtol=1e-6, atol=0)
KEY = jax.random.PRNGKey(0)


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


def _trees(mesh1, jparams, tparams, quantized):
    """(JAX serving tree, port tree) for a weight mode (None: float)."""
    if quantized is None:
        return jsv.shard_serving_params(jparams, JCFG, mesh1), tparams
    jq = jqm.shard_quantized_serving_params(
        jqm.quantize_params(jparams, quantized), JCFG, mesh1, quantized)
    return jq, tqm.quantize_params(tparams, quantized)


def _tree_mode(params):
    """A tree's quantization mode (its Wout's), None when float."""
    w = params["Wout"]
    return w.mode if isinstance(w, tq.QuantizedTensor) else None


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab_size"], size=(n,)).astype(np.int32)


def _check_pool(tstate, jstate, paged=False):
    """pos, tok exactly; scales to 1e-6 relative; int8 values within 1
    (at most 1e-3 of them not equal) and the dequantized rows within one
    step of their scale."""
    t_np = [t.numpy() for t in tstate]
    j_np = [np.asarray(j) for j in jstate]
    if paged:
        t_np[:4] = [t[:, 1:] for t in t_np[:4]]
        j_np[:4] = [j[:, 1:] for j in j_np[:4]]
    for i, name in enumerate(("k", "v")):
        t, j = t_np[i].astype(np.int32), j_np[i].astype(np.int32)
        ts, js = t_np[2 + i], j_np[2 + i]
        np.testing.assert_allclose(ts, js, **SCALES, err_msg=name + "scale")
        assert np.abs(t - j).max() <= 1, name
        assert np.mean(t != j) <= 1e-3, (name, np.mean(t != j))
        deq = np.abs(t * ts - j * js)
        assert (deq <= np.maximum(ts, js) * (1 + 1e-6)).all(), name
    for name, t, j in zip(("pos", "tok"), t_np[4:], j_np[4:]):
        np.testing.assert_array_equal(t, j, err_msg=name)


def _both(jfn, tfn, jstate, tstate, jp, tp, *args, paged=False):
    """One call on each side with the same numpy arguments; the pools
    compared; returns the states and the outputs past the pool as
    numpy."""
    jout = jfn(jp, *jstate, *(jnp.asarray(a) for a in args), KEY)
    tout = tfn(tp, *tstate, *(torch.from_numpy(a) for a in args), 0)
    jstate, tstate = tuple(jout[:6]), tuple(tout[:6])
    _check_pool(tstate, jstate, paged)
    for t, j in zip(tout[6:], jout[6:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return jstate, tstate, [t.numpy() for t in tout[6:]]


def _admit(prefixes, tb):
    prompts = np.zeros((NS, tb), np.int32)
    plen = np.zeros((NS,), np.int32)
    for i, p in prefixes.items():
        prompts[i, :p.shape[0]] = p
        plen[i] = p.shape[0]
    return prompts, plen


# ---------------------------------------------------------------------------
# the programs against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [None, "int8"])
def test_quant_slot_programs_match_jax(mesh1, jparams, tparams, quantized):
    """Two admission waves into the int8 pool, then a decode chunk with an
    inactive slot and budgets ending mid-chunk, float and int8 weights."""
    jp, tp = _trees(mesh1, jparams, tparams, quantized)
    # the reference's makers take the tree's mode; the port's need none
    jkw = dict(quantized=quantized, kv_mode="int8")
    jstate = tuple(jsv.init_slot_state(JCFG, mesh1, NS, kv_mode="int8"))
    tstate = tsv.init_slot_state(TCFG, NS, "cpu", kv_mode="int8")
    assert len(tstate) == 6 and tstate[0].dtype == torch.int8
    for wave in ({0: _prompt(5, 1), 2: _prompt(12, 2)},
                 {1: _prompt(16, 3), 3: _prompt(9, 4)}):
        prompts, plen = _admit(wave, 16)
        jstate, tstate, (first,) = _both(
            jsv.make_continuous_prefill(JCFG, mesh1, 16, NS, **jkw),
            tsv.make_continuous_prefill(TCFG, 16, NS, kv_mode="int8"),
            jstate, tstate,
            jp, tp, prompts, plen)
        assert (first[plen == 0] == -1).all()
    active = np.array([True, True, True, False])
    rem = np.array([4, 2, 1, 3], np.int32)
    _, tstate, (toks,) = _both(
        jsv.make_continuous_decode(JCFG, mesh1, 4, NS, **jkw),
        tsv.make_continuous_decode(TCFG, 4, NS, kv_mode="int8"), jstate,
        tstate, jp,
        tp, active, rem)
    assert (toks[3] == -1).all() and (toks[2, 1:] == -1).all()
    # rows past the prefill bucket and the decode rows keep value 0 and
    # scale 1.0 (slot 3 was admitted with 9 tokens and never decoded)
    assert (tstate[2][:, 3, 16:] == 1.0).all()
    assert (tstate[0][:, 3, 16:] == 0).all()


def test_quant_chunked_prefill_matches_jax(mesh1, jparams, tparams):
    """Three prompts in chunks of 5 on the int8 pool (slot 2 joins a call
    late, slot 1 never advances): later chunks read the cached prefix
    through its quantization."""
    jp, tp = _trees(mesh1, jparams, tparams, None)
    jstate = tuple(jsv.init_slot_state(JCFG, mesh1, NS, kv_mode="int8"))
    tstate = tsv.init_slot_state(TCFG, NS, "cpu", kv_mode="int8")
    prompts = {0: _prompt(21, 1), 2: _prompt(10, 2), 3: _prompt(13, 3)}
    begin = {0: 0, 2: 1, 3: 0}
    jfn = jsv.make_chunked_prefill(JCFG, mesh1, 5, NS, kv_mode="int8")
    tfn = tsv.make_chunked_prefill(TCFG, 5, NS, kv_mode="int8")
    done = {i: 0 for i in prompts}
    n = 0
    while any(done[i] < p.shape[0] for i, p in prompts.items()):
        toks = np.zeros((NS, 5), np.int32)
        clen, start = np.zeros((NS,), np.int32), np.zeros((NS,), np.int32)
        last = np.zeros((NS,), bool)
        for i, p in prompts.items():
            if n < begin[i] or done[i] >= p.shape[0]:
                continue
            k = min(5, p.shape[0] - done[i])
            toks[i, :k] = p[done[i]:done[i] + k]
            clen[i], start[i] = k, done[i]
            done[i] += k
            last[i] = done[i] == p.shape[0]
        jstate, tstate, (first,) = _both(jfn, tfn, jstate, tstate, jp, tp,
                                         toks, clen, start, last)
        assert (first[~last] == -1).all()
        n += 1
    assert tstate[4].tolist() == [21, 0, 10, 13]


def _tables():
    """Block tables: slots 0 (21-token prompt) and 2 (10) with 8 decode
    rows, slot 1 (23 tokens) sharing slot 0's first 16 tokens' pages,
    slot 3 none. Returns (bt, max_pages, num_pages)."""
    mp = jpg.pages_for(FIELDS["max_len"], PS)
    bt = np.zeros((NS, mp), np.int32)
    fresh = iter(range(1, 10 ** 6))
    for i, n in ((0, 29), (2, 18)):
        k = jpg.pages_for(n, PS)
        bt[i, :k] = [next(fresh) for _ in range(k)]
    bt[1, :2] = bt[0, :2]
    k = jpg.pages_for(31, PS)
    bt[1, 2:k] = [next(fresh) for _ in range(k - 2)]
    return bt, mp, next(fresh) + 2


@pytest.mark.parametrize("quantized", [None, "int8"])
def test_quant_paged_programs_match_jax(mesh1, jparams, tparams, quantized):
    """On the paged int8 pool: a fresh prefill (slots 0 and 2), a
    prefix-hit resume at 16 over pages slot 0 wrote (slot 1; its prefix
    read through the quantized pages), then a decode chunk."""
    jp, tp = _trees(mesh1, jparams, tparams, quantized)
    jkw = dict(quantized=quantized, kv_mode="int8")
    bt, mp, npg = _tables()
    jstate = tuple(jsv.init_paged_state(JCFG, mesh1, NS, PS, npg,
                                        kv_mode="int8"))
    tstate = tsv.init_paged_state(TCFG, NS, PS, npg, "cpu", kv_mode="int8")
    assert [tuple(t.shape) for t in tstate[:4]] == \
        [tuple(j.shape) for j in jstate[:4]]
    a = _prompt(21, 1)
    b = np.concatenate([a[:16], _prompt(7, 2)])
    tb = 32
    jfn = jsv.make_paged_prefill(JCFG, mesh1, tb, NS, PS, mp, npg, **jkw)
    tfn = tsv.make_paged_prefill(TCFG, tb, NS, PS, mp, npg, kv_mode="int8")
    for tails, start in (({0: a, 2: _prompt(10, 3)}, 0), ({1: b[16:]}, 16)):
        suffix, slen = _admit(tails, tb)
        st = np.where(slen > 0, start, 0).astype(np.int32)
        jstate, tstate, _ = _both(jfn, tfn, jstate, tstate, jp, tp, bt,
                                  suffix, slen, st, paged=True)
    assert tstate[4].tolist() == [21, 23, 10, 0]
    active = np.array([True, True, True, False])
    rem = np.array([4, 2, 1, 3], np.int32)
    _both(jsv.make_paged_decode(JCFG, mesh1, 4, NS, PS, mp, npg, **jkw),
          tsv.make_paged_decode(TCFG, 4, NS, PS, mp, npg, kv_mode="int8"),
          jstate,
          tstate, jp, tp, bt, active, rem, paged=True)


@pytest.mark.parametrize("draft_quantized", [None, "int8"])
def test_quant_spec_round_matches_jax(mesh1, jparams, tparams,
                                      draft_quantized):
    """Two speculative rounds (K=4) on the int8 pool after a prefill: slot
    1's budget ends mid-window, slot 2 is poisoned, slot 3's window runs
    past S; the drafter is the target or its int8 tree."""
    jp, tp = _trees(mesh1, jparams, tparams, None)
    jd, td = _trees(mesh1, jparams, tparams, draft_quantized)
    lens = {0: 5, 1: 12, 2: 9, 3: FIELDS["max_len"] - 3}
    jstate = tuple(jsv.init_slot_state(JCFG, mesh1, NS, kv_mode="int8"))
    tstate = tsv.init_slot_state(TCFG, NS, "cpu", kv_mode="int8")
    prompts, plen = _admit({i: _prompt(n, 20 + i) for i, n in lens.items()},
                           FIELDS["max_len"])
    tb = FIELDS["max_len"]
    jstate, tstate, _ = _both(
        jsv.make_continuous_prefill(JCFG, mesh1, tb, NS, kv_mode="int8"),
        tsv.make_continuous_prefill(TCFG, tb, NS, kv_mode="int8"), jstate,
        tstate, jp, tp, prompts, plen)
    jfn = jsv.make_speculative_decode(JCFG, mesh1, 4, NS, kv_mode="int8",
                                      draft_quantized=draft_quantized)
    tfn = tsv.make_speculative_decode(TCFG, 4, NS, kv_mode="int8")
    for rem, poison in ((np.array([10, 2, 10, 10], np.int32),
                         np.array([0, 0, 1, 0], bool)),
                        (np.array([10, 1, 10, 1], np.int32),
                         np.zeros(NS, bool))):
        args = (np.ones(NS, bool), rem, poison)
        jout = jfn(jp, jd, *jstate, *(jnp.asarray(x) for x in args), KEY)
        tout = tfn(tp, td, *tstate, *(torch.from_numpy(x) for x in args), 0)
        jstate, tstate = tuple(jout[:6]), tuple(tout[:6])
        _check_pool(tstate, jstate)
        for t, j in zip(tout[6:], jout[6:]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_quant_paged_spec_round_matches_jax(mesh1, jparams, tparams):
    """A paged int8 prefill, then two speculative rounds (K=4, the int8
    drafter), windows running past a slot's pages and past S."""
    jp, tp = _trees(mesh1, jparams, tparams, None)
    jd, td = _trees(mesh1, jparams, tparams, "int8")
    mp = jpg.pages_for(FIELDS["max_len"], PS)
    lens = {0: 5, 1: 12, 2: 9, 3: FIELDS["max_len"] - 3}
    bt = np.zeros((NS, mp), np.int32)
    nxt = 1
    for i, n in lens.items():
        k = min(mp, jpg.pages_for(n + 1, PS))
        bt[i, :k] = np.arange(nxt, nxt + k)
        nxt += k
    npg = nxt + 1
    jstate = tuple(jsv.init_paged_state(JCFG, mesh1, NS, PS, npg,
                                        kv_mode="int8"))
    tstate = tsv.init_paged_state(TCFG, NS, PS, npg, "cpu", kv_mode="int8")
    tb = FIELDS["max_len"]
    suffix, slen = _admit({i: _prompt(n, 20 + i) for i, n in lens.items()},
                          tb)
    jstate, tstate, _ = _both(
        jsv.make_paged_prefill(JCFG, mesh1, tb, NS, PS, mp, npg,
                               kv_mode="int8"),
        tsv.make_paged_prefill(TCFG, tb, NS, PS, mp, npg, kv_mode="int8"),
        jstate, tstate, jp, tp, bt, suffix, slen, np.zeros((NS,), np.int32),
        paged=True)
    jfn = jsv.make_paged_speculative_decode(JCFG, mesh1, 4, NS, PS, mp, npg,
                                            kv_mode="int8",
                                            draft_quantized="int8")
    tfn = tsv.make_paged_speculative_decode(TCFG, 4, NS, PS, mp, npg,
                                            kv_mode="int8")
    for rem in (np.array([10, 2, 10, 10], np.int32),
                np.array([10, 1, 10, 1], np.int32)):
        args = (bt, np.ones(NS, bool), rem, np.zeros(NS, bool))
        jout = jfn(jp, jd, *jstate, *(jnp.asarray(x) for x in args), KEY)
        tout = tfn(tp, td, *tstate, *(torch.from_numpy(x) for x in args), 0)
        jstate, tstate = tuple(jout[:6]), tuple(tout[:6])
        _check_pool(tstate, jstate, paged=True)
        for t, j in zip(tout[6:], jout[6:]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kv_mode,pool_mode", [("int8", None),
                                               (None, "int8")],
                         ids=["quant_program_float_pool",
                              "float_program_quant_pool"])
def test_programs_refuse_the_other_pool(tparams, kv_mode, pool_mode):
    """A program made for one pool refuses the other's state."""
    fn = tsv.make_continuous_decode(TCFG, 2, NS, kv_mode=kv_mode)
    state = tsv.init_slot_state(TCFG, NS, "cpu", kv_mode=pool_mode)
    with pytest.raises(TypeError, match="pool"):
        fn(tparams, *state, torch.ones(NS, dtype=torch.bool),
           torch.ones(NS, dtype=torch.int32), 0)


def test_unknown_modes_raise():
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tsv.make_continuous_decode(TCFG, 2, NS, kv_mode="int4")
    with pytest.raises(ValueError, match="unknown quantization mode"):
        teng.InferenceEngine(TCFG, {}, teng.EngineConfig(quantize="int4"),
                             device="cpu")


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

BASE = dict(num_slots=NS, decode_chunk=2, max_new_tokens=8)


def _jax(mesh1, jparams, **kw):
    return jeng.InferenceEngine(JCFG, mesh1, jparams, jeng.EngineConfig(
        backoff_base_s=0.0, **{**BASE, **kw}))


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


def _mix():
    """Six prompts through 4 slots (a refill wave): three share an
    18-token prefix, one of them page-aligned (16 + 0: a full-prefix hit
    on resubmission)."""
    sys_prompt = _prompt(16, 30)
    return ([np.concatenate([sys_prompt, _prompt(n, 31 + n)])
             for n in (0, 5, 9)] + [_prompt(n, 40 + n) for n in (7, 25, 12)])


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


QUANT_KW = {"kv": dict(kv_quantize="int8"), "weights": dict(quantize="int8"),
            "both": dict(quantize="int8", kv_quantize="int8")}


# each engine parity test runs both loops, the same on both sides
LOOPS = pytest.mark.parametrize("pipeline", [False, True],
                                ids=["sync", "pipelined"])


@LOOPS
@pytest.mark.parametrize("which", list(QUANT_KW))
def test_quant_engine_matches_jax_engine(mesh1, jparams, tparams, which,
                                         pipeline):
    """int8 KV, int8 weights and both: every result equals the JAX
    engine's; the pool and the tree are the quantized ones."""
    kw = dict(QUANT_KW[which], pipeline=pipeline)
    want = _serve(_jax(mesh1, jparams, **kw), _mix())
    eng = _port(tparams, **kw)
    _same(_serve(eng, _mix()), want)
    assert (len(eng._slot_state) == 6) == ("kv_quantize" in kw)
    assert _tree_mode(eng._params) == kw.get("quantize")


@LOOPS
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_quant_spec_engine_matches_jax_engine(mesh1, jparams, tparams,
                                              quantize, pipeline):
    """Speculative decoding with the default drafter ("int8") on an int8
    KV pool: on a float tree (the drafter is its int8 tree) and on an
    int8 tree (the drafter shares it: every draft accepted). Results
    equal the JAX spec engine's and the port's plain int8 engine's."""
    kw = dict(kv_quantize="int8", quantize=quantize, pipeline=pipeline)
    spec = dict(spec_decode=True, spec_k=3, spec_adaptive=False)
    jengine = _jax(mesh1, jparams, **kw, **spec)
    want = _serve(jengine, _mix())
    plain = _serve(_port(tparams, **kw), _mix())
    eng = _port(tparams, **kw, **spec)
    got = _serve(eng, _mix())
    _same(got, want)
    _same(got, plain)
    c = eng.counts
    assert c["spec_rounds"] > 0 and eng.config.draft == "int8"
    assert _tree_mode(eng._draft_params) == "int8"
    counts = (c["spec_drafted"], c["spec_accepted"])
    assert counts == tuple(
        int(jengine.registry.get(name)._unlabeled().value)
        for name in ("serving_spec_drafted_tokens",
                     "serving_spec_accepted_tokens"))
    if quantize:
        # the drafter is the live tree: it drafts what the target
        # samples, so it accepts as the "self" drafter does
        assert eng._draft_params is eng._params
        selfd = _port(tparams, **kw, **{**spec, "draft": "self"})
        _serve(selfd, _mix())
        assert counts == (selfd.counts["spec_drafted"],
                          selfd.counts["spec_accepted"])


def test_paged_int8_without_prefix_cache_equals_contiguous(mesh1, jparams,
                                                           tparams):
    """int8 paged with the prefix cache off (every prompt prefilled
    fresh) equals the contiguous int8 engine and JAX's, and paged int8
    spec equals them too."""
    cont = _serve(_port(tparams, kv_quantize="int8"), _mix())
    paged = dict(kv_quantize="int8", paged=True, page_size=PS,
                 prefix_cache=False)
    _same(_serve(_port(tparams, **paged), _mix()), cont)
    _same(_serve(_jax(mesh1, jparams, **paged), _mix()), cont)
    _same(_serve(_port(tparams, spec_decode=True, spec_k=3, **paged),
                 _mix()), cont)


@pytest.mark.parametrize("chunk", [3, 11])
def test_chunked_int8_equals_one_shot(tparams, chunk):
    """int8 KV: later chunks re-read the prefix through its quantization
    as decode does, so chunked equals one-shot token for token."""
    want = _serve(_port(tparams, kv_quantize="int8"), _mix())
    _same(_serve(_port(tparams, kv_quantize="int8", prefill_chunk=chunk),
                 _mix()), want)
    _same(_serve(_port(tparams, kv_quantize="int8", prefill_chunk=chunk,
                       paged=True, page_size=PS, prefix_cache=False),
                 _mix()), want)


def test_paged_int8_prefix_hits_within_envelope(mesh1, jparams, tparams):
    """Two waves on the paged int8 pool with the prefix cache: the hit
    wave equals JAX's paged int8 engine token for token (and its hit /
    miss / shared-token counts), matches the run without hits at >= 0.8
    (JAX's envelope), copies on write with the pages' scale rows, and
    leaks no page."""
    kw = dict(kv_quantize="int8", paged=True, page_size=PS)
    jengine = _jax(mesh1, jparams, **kw)
    want = _serve(jengine, _mix(), waves=2)
    eng = _port(tparams, **kw)
    got = _serve(eng, _mix(), waves=2)
    _same(got, want)
    jc = jengine.debugz()["paged"]["prefix_cache"]
    c = eng.counts
    assert (c["prefix_hits"], c["prefix_misses"],
            c["prefix_shared_tokens"]) == \
        (jc["hits"], jc["misses"], jc["shared_tokens"])
    assert c["prefix_hits"] > 0 and c["cow_copies"] > 0
    assert c["pages_used"] == eng.prefix_cache_pages
    cold = _serve(_port(tparams, kv_quantize="int8"), _mix())
    match = np.mean([np.mean(g == w) for g, w in zip(got[len(cold):], cold)])
    assert match >= 0.8, match


def test_cow_copy_carries_scale_rows(tparams):
    """A copied page carries its values and its scale rows, all layers."""
    eng = _port(tparams, kv_quantize="int8", paged=True, page_size=PS)
    _serve(eng, [_prompt(20, 3)])
    kp, vp, ks, vs = eng._slot_state[:4]
    src = int(eng._prefix_cache.match(_prompt(20, 3))[0])
    dst = eng._allocator.alloc()
    before = eng.counts["cow_copies"]
    eng._copy_page(src, dst)
    assert eng.counts["cow_copies"] == before + 1
    for plane in (kp, vp, ks, vs):
        assert torch.equal(plane[:, dst], plane[:, src])
    assert (ks[:, src] != 1.0).all()


def test_fp8_engine_resolves_to_int8_on_the_cpu(tparams):
    """"fp8" resolves to int8 on the CPU (as JAX's does): the same pool,
    tree and tokens as the int8 engine."""
    want = _serve(_port(tparams, quantize="int8", kv_quantize="int8"),
                  _mix())
    eng = _port(tparams, quantize="fp8", kv_quantize="fp8")
    _same(_serve(eng, _mix()), want)
    assert eng._slot_state[0].dtype == torch.int8
    assert _tree_mode(eng._params) == "int8"


def test_quantize_none_is_the_float_engine(jparams, tparams):
    """quantize=None, kv_quantize=None: the float pool and tree, results
    bit-identical to the default engine's and to `generate`'s."""
    eng = _port(tparams, quantize=None, kv_quantize=None)
    got = _serve(eng, _mix())
    _same(got, _serve(_port(tparams), _mix()))
    assert len(eng._slot_state) == 4
    assert eng._slot_state[0].dtype == torch.float32
    assert _tree_mode(eng._params) is None
    p = _mix()[1]
    ref = ttf.generate(TCFG, tparams, torch.from_numpy(p[None]), 8,
                       temperature=0.0)
    np.testing.assert_array_equal(got[1], ref[0].numpy())


def test_engine_reports_param_and_pool_bytes(mesh1, tparams):
    """The at-rest bytes of the tree and the pool: JAX's analytic pool
    bytes, and the int8 engine at <= 0.6 of the float one on both."""
    feng = _port(tparams)
    qeng = _port(tparams, quantize="int8", kv_quantize="int8")
    peng = _port(tparams, kv_quantize="int8", paged=True, page_size=PS,
                 kv_pages=40)
    assert qeng.counts["param_bytes"] <= 0.6 * feng.counts["param_bytes"]
    assert qeng.counts["kv_pool_bytes"] <= 0.6 * feng.counts["kv_pool_bytes"]
    assert qeng.counts["kv_pool_bytes"] == \
        jkv.slot_pool_bytes(JCFG, NS, "int8") == \
        tkv.slot_pool_bytes(TCFG, NS, "int8")
    assert feng.counts["kv_pool_bytes"] == jkv.slot_pool_bytes(JCFG, NS)
    assert peng.counts["kv_pool_bytes"] == jkv.paged_pool_bytes(
        JCFG, NS, PS, 40, jpg.pages_for(FIELDS["max_len"], PS), "int8")
    assert qeng.counts["param_bytes"] == tqm.param_bytes(qeng._params)

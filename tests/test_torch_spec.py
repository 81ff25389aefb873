"""Port parity: speculative decoding (program, engine, controller) vs JAX.

The JAX side runs on a 1x1 mesh through its plain reference paths
(DL4JTPU_FLASH unset: `reference_decode_attention` for the draft steps,
`reference_window_attention` for the verify window), as
tests/test_torch_serving.py does; the engine tests run both loops,
the synchronous one and the pipelined one (schedule-ahead spec rounds),
each against the same loop of JAX's. Both sides
hold one JAX `init_params` tree (converted with `params_from_numpy`).
Tolerances: caches 1e-5 (the same f32 math summed in other orders); pos,
tok, emitted tokens, commit counts and drafted / accepted counts exactly
(greedy); engine results token-exact. Sampled decoding cannot match JAX
(threefry), so it is held to the port's own plain engine, token-exact.
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
from deeplearning4j_tpu.quant import model as jqm  # noqa: E402
from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402
from deeplearning4j_tpu_torch.parallel import serving as tsv  # noqa: E402
from deeplearning4j_tpu_torch.quant import model as tqm  # noqa: E402
from deeplearning4j_tpu_torch.quant.core import QuantizedTensor  # noqa
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=96)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
NS = 5
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


def _assert_state(tstate, jstate):
    for name, t, j in zip(("ck", "cv", "pos", "tok"), tstate, jstate):
        if name in ("ck", "cv"):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **CACHE,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# the speculative round program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_layers,spec_k", [(0, 4), (1, 4), (1, 2)])
def test_spec_program_matches_jax(mesh1, jparams, tparams, draft_layers,
                                  spec_k):
    """One prefill over 5 slots, then two speculative rounds. Round 1:
    slot 1's budget ends mid-window, slot 2 is poisoned, slot 3's window
    crosses S (its rows past S drop, its draft writes clip), slot 4 is
    inactive. Round 2: every slot active. Caches at 1e-5, every int
    output exactly."""
    sparams = jsv.shard_serving_params(jparams, JCFG, mesh1)
    key = jax.random.PRNGKey(0)
    tb = FIELDS["max_len"]
    lens = {0: 5, 1: 12, 2: 9, 3: tb - 3, 4: 7}
    prompts = np.zeros((NS, tb), np.int32)
    plen = np.zeros((NS,), np.int32)
    for i, n in lens.items():
        prompts[i, :n] = _prompt(n, 20 + i)
        plen[i] = n
    jstate = tuple(jsv.init_slot_state(JCFG, mesh1, NS))
    *jstate, _ = jsv.make_continuous_prefill(JCFG, mesh1, tb, NS)(
        sparams, *jstate, jnp.asarray(prompts), jnp.asarray(plen), key)
    tstate = tsv.init_slot_state(TCFG, NS, "cpu")
    *tstate, _ = tsv.make_continuous_prefill(TCFG, tb, NS)(
        tparams, *tstate, torch.from_numpy(prompts),
        torch.from_numpy(plen), 0)
    jfn = jsv.make_speculative_decode(JCFG, mesh1, spec_k, NS,
                                      draft_layers=draft_layers)
    tfn = tsv.make_speculative_decode(TCFG, spec_k, NS,
                                      draft_layers=draft_layers)
    rounds = [
        (np.array([1, 1, 1, 1, 0], bool), np.array([10, 2, 10, 10, 10],
                                                    np.int32),
         np.array([0, 0, 1, 0, 0], bool)),
        (np.ones(NS, bool), np.array([10, 1, 10, 1, 10], np.int32),
         np.zeros(NS, bool)),
    ]
    for n, (active, rem, poison) in enumerate(rounds):
        *jstate, jemit, jc, jd, ja = jfn(
            sparams, sparams, *jstate, jnp.asarray(active),
            jnp.asarray(rem), jnp.asarray(poison), key)
        *tstate, temit, tc, td, ta = tfn(
            tparams, tparams, *tstate, torch.from_numpy(active),
            torch.from_numpy(rem), torch.from_numpy(poison), 0)
        _assert_state(tstate, jstate)
        for name, t, j in (("emit", temit, jemit), ("ncommit", tc, jc),
                           ("drafted", td, jd), ("accepted", ta, ja)):
            assert t.dtype == torch.int32, name
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)
        if n == 0:    # the inactive slot commits nothing, the capped 2
            assert int(tc[4]) == 0 and (temit[4] == -1).all()
            assert int(tc[1]) <= 2


def test_spec_accept_commit_matches_jax():
    """The acceptance rule on random drafts / targets with partial
    matches, inactive slots and budgets below the window."""
    rng = np.random.default_rng(3)
    ns, k = 16, 5
    tgt = rng.integers(0, 4, size=(ns, k + 1)).astype(np.int32)
    drafts = np.where(rng.random((ns, k)) < 0.7, tgt[:, :k],
                      (tgt[:, :k] + 1) % 4).astype(np.int32)
    pos = rng.integers(0, 50, size=ns).astype(np.int32)
    tok = rng.integers(0, 4, size=ns).astype(np.int32)
    rem = rng.integers(0, 8, size=ns).astype(np.int32)
    act = (rng.random(ns) < 0.8) & (rem > 0)
    want = jsv._spec_accept_commit(k, *(jnp.asarray(x) for x in (
        drafts, tgt, pos, tok, rem, act)))
    got = tsv._spec_accept_commit(k, *(torch.from_numpy(x) for x in (
        drafts, tgt, pos, tok, rem, act)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kw", [dict(constrain=True)])
def test_spec_program_constrained_variant_serves(tparams, kw):
    """The speculative round's constrain=True variant (which raised here
    before it was ported), every slot on an all-allow row 0 of a table,
    commits the unmasked round's tokens and leaves its pool bit for bit,
    the states staying 0."""
    from deeplearning4j_tpu_torch.serving.constrain import ConstraintTable
    callow, ctrans = ConstraintTable(4, FIELDS["vocab_size"]).device("cpu")
    tb = 16
    prompts = np.zeros((NS, tb), np.int32)
    plen = np.zeros((NS,), np.int32)
    for i, n in enumerate((5, 12, 9, 7, 3)):
        prompts[i, :n] = _prompt(n, 40 + i)
        plen[i] = n
    args = [torch.from_numpy(x) for x in (
        np.ones(NS, bool), np.array([10, 2, 10, 10, 0], np.int32),
        np.array([0, 0, 1, 0, 0], bool))]
    outs = []
    for constrain in (False, True):
        state = tsv.init_slot_state(TCFG, NS, "cpu")
        *state, _ = tsv.make_continuous_prefill(TCFG, tb, NS)(
            tparams, *state, torch.from_numpy(prompts),
            torch.from_numpy(plen), 0)
        fn = tsv.make_speculative_decode(TCFG, 4, NS,
                                         **(kw if constrain else {}))
        extra = ()
        if constrain:
            cstate = torch.zeros(NS, dtype=torch.int32)
            extra = (callow, ctrans, cstate, torch.zeros(NS, dtype=bool),
                     torch.zeros(NS, dtype=torch.int32))
        out = fn(tparams, tparams, *state, *args, *extra, 0)
        if constrain:
            assert out[-1] is cstate and cstate.tolist() == [0] * NS
            out = out[:-1]
        outs.append(out)
    for g, w in zip(*outs):
        assert torch.equal(g, w)


@pytest.mark.parametrize("variant", ["quantized", "kv_mode",
                                     "draft_quantized"])
def test_spec_program_quant_variants(tparams, variant):
    """A quantized target tree, the int8 pool (the one option a program
    takes for quantization) or an int8 drafter tree: one greedy round
    commits the plain decode chunk's tokens on the same tree and pool,
    and a drafter equal to the target is accepted whole."""
    qtree = tqm.quantize_params(tparams, mode="int8")
    params = qtree if variant == "quantized" else tparams
    dparams = tparams if variant == "kv_mode" else qtree
    kv_mode = "int8" if variant == "kv_mode" else None
    tb, k = 16, 4
    prompts = np.zeros((NS, tb), np.int32)
    plen = np.zeros((NS,), np.int32)
    for i, n in enumerate((5, 12, 9, 16, 7)):
        prompts[i, :n] = _prompt(n, 30 + i)
        plen[i] = n
    state = tsv.init_slot_state(TCFG, NS, "cpu", kv_mode=kv_mode)
    *state, _ = tsv.make_continuous_prefill(TCFG, tb, NS, kv_mode=kv_mode)(
        params, *state, torch.from_numpy(prompts), torch.from_numpy(plen),
        0)
    assert len(state) == (6 if kv_mode else 4)
    active = torch.ones(NS, dtype=torch.bool)
    rem = torch.full((NS,), 10, dtype=torch.int32)
    *_, want = tsv.make_continuous_decode(TCFG, k + 1, NS, kv_mode=kv_mode)(
        params, *(t.clone() for t in state), active, rem, 0)
    out = tsv.make_speculative_decode(TCFG, k, NS, kv_mode=kv_mode)(
        params, dparams, *state, active, rem,
        torch.zeros(NS, dtype=torch.bool), 0)
    emit, ncommit = out[len(state)], out[len(state) + 1]
    assert int(ncommit.min()) >= 1
    for i in range(NS):
        n = int(ncommit[i])
        np.testing.assert_array_equal(emit[i, :n].numpy(),
                                      want[i, :n].numpy())
    if variant != "draft_quantized":
        assert (ncommit == k + 1).all()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests():
    lens = [5, 17, 8, 30, 3, 12, 9]
    news = [11, 9, 4, 14, 10, 5, 12]
    return [(_prompt(n, 10 + i), m) for i, (n, m) in
            enumerate(zip(lens, news))]


BASE = dict(num_slots=4, decode_chunk=2, max_new_tokens=14)


def _jax_engine(mesh1, jparams, **kw):
    return jeng.InferenceEngine(JCFG, mesh1, jparams, jeng.EngineConfig(
        backoff_base_s=0.0, **{**BASE, **kw}))


def _port_engine(tparams, **kw):
    return teng.InferenceEngine(TCFG, tparams,
                                teng.EngineConfig(**{**BASE, **kw}),
                                device="cpu")


def _jax_spec_counts(eng):
    return tuple(int(eng.registry.get(name)._unlabeled().value)
                 for name in ("serving_spec_drafted_tokens",
                              "serving_spec_accepted_tokens"))


# each engine parity test runs both loops, the same on both sides
LOOPS = pytest.mark.parametrize("pipeline", [False, True],
                                ids=["sync", "pipelined"])


@LOOPS
@pytest.mark.parametrize("draft", ["self", "layers:1"])
def test_spec_engine_matches_jax_engine(mesh1, jparams, tparams, draft,
                                        pipeline):
    """7 greedy requests through 4 slots (a refill wave included): every
    result equals the JAX spec engine's, and the drafted / accepted
    counts equal its metrics."""
    kw = dict(spec_decode=True, spec_k=4, draft=draft, pipeline=pipeline)
    jengine = _jax_engine(mesh1, jparams, **kw)
    tengine = _port_engine(tparams, **kw)
    jh = [jengine.submit(p, max_new_tokens=m) for p, m in _requests()]
    th = [tengine.submit(p, max_new_tokens=m) for p, m in _requests()]
    jengine.run_pending()
    tengine.run_pending()
    for j, t, (p, m) in zip(jh, th, _requests()):
        np.testing.assert_array_equal(t.result(), j.result())
        assert t.result().shape == (p.shape[0] + m,)
    c = tengine.counts
    assert c["spec_rounds"] > 0
    assert (c["spec_drafted"], c["spec_accepted"]) == \
        _jax_spec_counts(jengine)


@LOOPS
def test_adaptive_k_trajectory_matches_jax(mesh1, jparams, tparams,
                                           pipeline):
    """Adversarial traffic (an early-exit drafter of random weights
    rarely agrees with the target): the K in use after every tick, plain
    cooldown included, equals the JAX engine's, and so do the results."""
    kw = dict(spec_decode=True, spec_k=4, draft="layers:1",
              max_new_tokens=40, pipeline=pipeline)
    jengine = _jax_engine(mesh1, jparams, **kw)
    tengine = _port_engine(tparams, **kw)
    reqs = [(_prompt(n, 40 + i), 40) for i, n in enumerate((6, 11, 4, 9,
                                                             14))]
    jh = [jengine.submit(p, max_new_tokens=m) for p, m in reqs]
    th = [tengine.submit(p, max_new_tokens=m) for p, m in reqs]
    jk, tk = [], []
    while jengine.tick():
        jk.append(0 if jengine._spec_plain > 0 else jengine._spec_cur_k)
    while tengine.tick():
        tk.append(tengine.spec_k_current)
    assert tk == jk
    assert 0 in tk and min(k for k in tk if k) == 1   # fell back, probed
    for j, t in zip(jh, th):
        np.testing.assert_array_equal(t.result(), j.result())


def _run_port(tparams, reqs, **kw):
    eng = _port_engine(tparams, **kw)
    hs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    eng.run_pending()
    return eng, [h.result() for h in hs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_spec_matches_plain_engine(tparams, seed):
    """temperature 0.9, top-k 5: the committed token at index j is the
    target's position-keyed sample at j, so the speculative engine equals
    the plain one token for token while the early-exit drafter keeps the
    acceptance partial (mid-window rejections happen)."""
    reqs = [(_prompt(8, seed), 11), (_prompt(10, seed + 5), 11)]
    samp = dict(temperature=0.9, top_k=5, seed=seed)
    _, want = _run_port(tparams, reqs, **samp)
    eng, got = _run_port(tparams, reqs, spec_decode=True, spec_k=4,
                         draft="layers:1", **samp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.counts["spec_rounds"] > 0


def test_budget_cap_truncates_commit_not_exactness(tparams):
    """max_new_tokens=9 is no multiple of K+1: the last round commits
    only the remaining budget, and the result equals the plain engine's
    at exactly the budget (reference test_serving_spec.py:137)."""
    reqs = [(_prompt(8, 0), 9)]
    _, want = _run_port(tparams, reqs, max_new_tokens=9)
    eng, got = _run_port(tparams, reqs, max_new_tokens=9, spec_decode=True,
                         spec_k=4, draft="self")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape[0] == 8 + 9
    # rounds commit 5 then the 3 left (the prefill gave the first token)
    assert (eng.counts["spec_drafted"], eng.counts["spec_accepted"]) == \
        (8, 6)


# ---------------------------------------------------------------------------
# validation and drafter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=0, draft="self"), "spec_k"),
    (dict(draft="layers:0"), "out of"),
    (dict(draft="layers:3"), "out of"),
    (dict(draft="layers:x"), "malformed"),
    (dict(draft="bogus"), "unknown draft"),
])
def test_spec_config_errors_raise_value_error(tparams, kw, match):
    with pytest.raises(ValueError, match=match):
        _port_engine(tparams, spec_decode=True, **kw)


@pytest.mark.parametrize("draft", ["int8", "fp8"])
def test_quantized_drafter_builds(tparams, draft):
    """The default drafter and its fp8 sibling build (fp8 resolves to
    int8 off a capable card, as the reference's does off its
    accelerator): the drafter tree is quantized, the live tree is not,
    and the engine's results equal the plain engine's."""
    reqs = _requests()[:3]
    _, want = _run_port(tparams, reqs)
    eng, got = _run_port(tparams, reqs, spec_decode=True, spec_k=4,
                         draft=draft)
    assert eng._draft_qmode == "int8"
    assert isinstance(eng._draft_params["Wout"], QuantizedTensor)
    assert not isinstance(eng._params["Wout"], QuantizedTensor)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.counts["spec_rounds"] > 0


@pytest.mark.parametrize("draft", ["self", "layers:1", "layers:2",
                                   "layers:0", "layers:x", "nope"])
def test_draft_tree_matches_jax(mesh1, jparams, tparams, draft):
    """Same (quantized mode, draft layers) as JAX, the same tree, or the
    same ValueError."""
    try:
        _, jmode, jn = jqm.draft_tree(jparams, draft, JCFG, mesh1)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tqm.draft_tree(tparams, draft, TCFG)
        assert str(got.value) == str(e)
        return
    tree, tmode, tn = tqm.draft_tree(tparams, draft, TCFG)
    assert tree is tparams
    assert (tmode, tn) == (jmode, jn)

"""Port parity: the continuous-batching slot programs and engine vs JAX.

The JAX side runs on a 1x1 mesh (`make_mesh(MeshSpec(data=1, model=1))`)
through its plain reference paths (DL4JTPU_FLASH unset: the jnp attention
and `reference_decode_attention`): inside `shard_map` the Pallas kernels
do not trace in interpret mode on this JAX version (check_vma). The
kernels' own math is held to JAX in tests/test_torch_attention.py and
tests/test_torch_transformer.py. The JAX engine runs with
`pipeline=False`, the synchronous loop the port implements. Both sides
hold the same weights (one JAX `init_params` tree converted with
`params_from_numpy`). Tolerances: caches 1e-5; pos, tok, first tokens and
emitted tokens exactly (greedy).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from deeplearning4j_tpu_torch.serving import engine as teng  # noqa: E402

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


def _pool(prefixes, tb):
    prompts = np.zeros((NS, tb), np.int32)
    plen = np.zeros((NS,), np.int32)
    for i, p in prefixes.items():
        prompts[i, :p.shape[0]] = p
        plen[i] = p.shape[0]
    return prompts, plen


def _assert_state(tstate, jstate):
    for name, t, j in zip(("ck", "cv", "pos", "tok"), tstate, jstate):
        if name in ("ck", "cv"):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **CACHE,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


def test_slot_programs_match_jax(mesh1, jparams, tparams):
    """Two admission waves (mixed admitted / passing-through slots), then
    a decode chunk where one slot is inactive and two run out of budget
    mid-chunk: caches at 1e-5, every int output exactly."""
    sparams = jsv.shard_serving_params(jparams, JCFG, mesh1)
    key = jax.random.PRNGKey(0)
    jstate = tuple(jsv.init_slot_state(JCFG, mesh1, NS))
    tstate = tsv.init_slot_state(TCFG, NS, "cpu")
    waves = [{0: _prompt(5, 1), 2: _prompt(12, 2)},
             {1: _prompt(16, 3), 3: _prompt(9, 4)}]
    for wave in waves:
        prompts, plen = _pool(wave, 16)
        jfn = jsv.make_continuous_prefill(JCFG, mesh1, 16, NS)
        *jstate, jfirst = jfn(sparams, *jstate, jnp.asarray(prompts),
                              jnp.asarray(plen), key)
        tfn = tsv.make_continuous_prefill(TCFG, 16, NS)
        *tstate, tfirst = tfn(tparams, *tstate, torch.from_numpy(prompts),
                              torch.from_numpy(plen), 0)
        np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
        assert (tfirst.numpy()[plen == 0] == -1).all()
        _assert_state(tstate, jstate)
    active = np.array([True, True, True, False])
    rem = np.array([4, 2, 1, 3], np.int32)
    jfn = jsv.make_continuous_decode(JCFG, mesh1, 4, NS)
    *jstate, jtoks = jfn(sparams, *jstate, jnp.asarray(active),
                         jnp.asarray(rem), key)
    tfn = tsv.make_continuous_decode(TCFG, 4, NS)
    *tstate, ttoks = tfn(tparams, *tstate, torch.from_numpy(active),
                         torch.from_numpy(rem), 0)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert (ttoks.numpy()[3] == -1).all()
    assert (ttoks.numpy()[2, 1:] == -1).all()
    _assert_state(tstate, jstate)


def _requests():
    lens = [5, 17, 8, 30, 3, 12]
    news = [6, 9, 4, 7, 10, 5]
    return [(_prompt(n, 10 + i), m) for i, (n, m) in
            enumerate(zip(lens, news))]


def test_engine_matches_jax_engine_token_exact(mesh1, jparams, tparams):
    """6 greedy requests through 4 slots: the second wave refills freed
    slots; every result equals the JAX engine's."""
    jcfg = jeng.EngineConfig(pipeline=False, num_slots=NS, decode_chunk=3,
                             max_new_tokens=10, backoff_base_s=0.0)
    jengine = jeng.InferenceEngine(JCFG, mesh1, jparams, jcfg)
    tengine = teng.InferenceEngine(
        TCFG, tparams, teng.EngineConfig(num_slots=NS, decode_chunk=3,
                                         max_new_tokens=10), device="cpu")
    jh = [jengine.submit(p, max_new_tokens=m) for p, m in _requests()]
    th = [tengine.submit(p, max_new_tokens=m) for p, m in _requests()]
    jengine.run_pending()
    ticks = tengine.run_pending()
    assert tengine.counts["prefill_calls"] >= 2     # a refill wave ran
    assert ticks > 1
    for j, t, (p, m) in zip(jh, th, _requests()):
        np.testing.assert_array_equal(t.result(), j.result())
        assert t.result().shape == (p.shape[0] + m,)


def _sampled(tparams, chunk, reqs):
    eng = teng.InferenceEngine(
        TCFG, tparams, teng.EngineConfig(num_slots=NS, decode_chunk=chunk,
                                         max_new_tokens=12,
                                         temperature=0.9, top_k=16,
                                         seed=5), device="cpu")
    hs = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    eng.run_pending()
    return [h.result() for h in hs]


def test_sampled_tokens_independent_of_neighbours_and_chunk(tparams):
    """Position-keyed sampling: a request's tokens are the same alone,
    among others (other slots, second wave) and at decode_chunk 2 or 4."""
    target = (_prompt(9, 99), 12)
    solo = _sampled(tparams, 2, [target])[0]
    crowd = _requests()[:5] + [target]      # seated in the refill wave
    for chunk in (2, 4):
        np.testing.assert_array_equal(_sampled(tparams, chunk, crowd)[-1],
                                      solo)
    greedy = teng.InferenceEngine(
        TCFG, tparams, teng.EngineConfig(num_slots=NS, max_new_tokens=12),
        device="cpu")
    h = greedy.submit(*target[:1], max_new_tokens=12)
    greedy.run_pending()
    assert not np.array_equal(h.result(), solo)


def test_engine_admission_rules(tparams):
    eng = teng.InferenceEngine(
        TCFG, tparams, teng.EngineConfig(max_queue=3, degrade_queue_depth=2,
                                         degraded_max_new_tokens=2,
                                         max_new_tokens=8), device="cpu")
    a = eng.submit(_prompt(4, 1))
    eng.submit(_prompt(4, 2))
    c = eng.submit(_prompt(4, 3))          # two queued: degraded cap
    assert (a.max_new_tokens, c.max_new_tokens) == (8, 2)
    with pytest.raises(teng.OverloadError):
        eng.submit(_prompt(4, 4))
    with pytest.raises(ValueError, match="max_len"):
        teng.InferenceEngine(TCFG, tparams, device="cpu").submit(
            _prompt(90, 5), max_new_tokens=10)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(np.array([3, FIELDS["vocab_size"]], np.int32))
    eng.run_pending()
    assert a.done() and a.status == teng.RequestStatus.COMPLETED
    assert c.result().shape == (6,)


@pytest.mark.parametrize("field,value", [
    ("pipeline", True), ("paged", True), ("spec_decode", True),
    ("prefill_chunk", 8), ("quantize", "int8"), ("mode", "batch"),
    ("max_retries", 0), ("compile_cache_dir", "x"),
])
def test_unported_engine_options_raise(tparams, field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.InferenceEngine(TCFG, tparams,
                             teng.EngineConfig(**{field: value}),
                             device="cpu")

"""Port parity: models/transformer.py of deeplearning4j_tpu_torch vs JAX.

One JAX `init_params` tree (seed 0) is converted with
`models.convert.params_from_numpy`, so both sides hold the same weights.
JAX runs with DL4JTPU_FLASH=interpret, so its prefill and forward go
through the Pallas flash kernel (interpret mode); its decode attention
takes the plain reference path at this cache length (S < 128). The port
runs on the CPU with its plain twins. Tolerances: logits 1e-4 (float32
through two layers, summed in another order), caches 1e-5; greedy tokens
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import transformer as jtf  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.models.convert import \
    params_from_numpy  # noqa: E402

FIELDS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, max_len=96)
JCFG = jtf.TransformerConfig(**FIELDS)
TCFG = ttf.TransformerConfig(**FIELDS)
LOGITS = dict(rtol=0, atol=1e-4)
CACHE = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("DL4JTPU_FLASH", "interpret")


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


@pytest.fixture(scope="module")
def tparams(tree):
    return params_from_numpy(tree, device="cpu")


def _tokens(b, t, seed):
    return np.random.default_rng(seed).integers(
        0, FIELDS["vocab_size"], size=(b, t)).astype(np.int32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_params_from_numpy_round_trips_exactly(tree, tparams):
    back = {k: t.numpy() for k, t in _flat(tparams)}
    want = dict(_flat(tree))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    f32 = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32
               for _, t in _flat(f32))


def test_forward_logits_match_jax(jparams, tparams):
    toks = _tokens(2, 24, 1)
    want = jtf.forward(JCFG, jparams, jnp.asarray(toks))
    got = ttf.forward(TCFG, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_prefill_matches_jax(jparams, tparams):
    toks = _tokens(3, 16, 2)
    wl, (wk, wv) = jtf.prefill(JCFG, jparams, jnp.asarray(toks))
    gl, (gk, gv) = ttf.prefill(TCFG, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGITS)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **CACHE)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **CACHE)


def test_ten_decode_steps_match_jax(jparams, tparams):
    toks = _tokens(2, 12, 3)
    feed = _tokens(2, 10, 4)
    _, jc = jtf.prefill(JCFG, jparams, jnp.asarray(toks))
    _, tc = ttf.prefill(TCFG, tparams, torch.from_numpy(toks))
    for i in range(10):
        pos = 12 + i
        wl, jc = jtf.decode_step(JCFG, jparams, jnp.asarray(feed[:, i]), jc,
                                 pos, donate=False)
        gl, tc = ttf.decode_step(TCFG, tparams, torch.from_numpy(feed[:, i]),
                                 tc, pos)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **LOGITS,
                                   err_msg=f"step {i}")
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), **CACHE)


def test_greedy_generate_token_exact(jparams, tparams):
    prompt = _tokens(3, 8, 5)
    want = jtf.generate(JCFG, jparams, jnp.asarray(prompt), 24,
                        jax.random.PRNGKey(0), temperature=0.0)
    got = ttf.generate(TCFG, tparams, torch.from_numpy(prompt), 24,
                       temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (9, 0.5)])
def test_filter_logits_keeps_the_jax_set(top_k, top_p):
    logits = np.random.default_rng(6).normal(
        size=(6, 64)).astype(np.float32) * 2
    want = jtf._filter_logits(jnp.asarray(logits), top_k, top_p)
    got = ttf._filter_logits(torch.from_numpy(logits), top_k, top_p)
    keep = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(torch.isfinite(got).numpy(), keep)
    np.testing.assert_array_equal(got.numpy()[keep], logits[keep])
    assert keep.sum(axis=1).min() >= 1


def test_sampled_tokens_do_not_depend_on_batch_placement(tparams):
    a, b = _tokens(1, 8, 7), _tokens(1, 8, 8)
    kw = dict(temperature=1.0, top_k=20, seed=3)
    ab = ttf.generate(TCFG, tparams, torch.from_numpy(np.concatenate([a, b])),
                      16, **kw)
    ba = ttf.generate(TCFG, tparams, torch.from_numpy(np.concatenate([b, a])),
                      16, **kw)
    solo = ttf.generate(TCFG, tparams, torch.from_numpy(a), 16, **kw)
    np.testing.assert_array_equal(ab[0].numpy(), ba[1].numpy())
    np.testing.assert_array_equal(ab[1].numpy(), ba[0].numpy())
    np.testing.assert_array_equal(ab[0].numpy(), solo[0].numpy())
    other = ttf.generate(TCFG, tparams, torch.from_numpy(a), 16,
                         temperature=1.0, top_k=20, seed=4)
    assert not np.array_equal(other.numpy(), solo.numpy())


def test_sample_at_positions_depends_only_on_seed_index_logits():
    logits = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4, 64)).astype(np.float32))
    pos = torch.tensor([5, 6, 7, 8])
    full = ttf.sample_at_positions(logits, pos, 11, 0.8, 0, 1.0)
    for i in range(4):
        one = ttf.sample_at_positions(logits[i:i + 1], pos[i:i + 1], 11,
                                      0.8, 0, 1.0)
        assert int(one[0]) == int(full[i])
    draws = torch.stack([ttf.sample_at_positions(
        logits[:1], torch.tensor([j]), 11, 1.0, 0, 1.0)[0]
        for j in range(400)])
    probs = torch.softmax(logits[0], -1)
    top = int(torch.argmax(probs))
    # the most likely token is drawn about as often as its probability
    assert abs(float((draws == top).float().mean()) - float(probs[top])) \
        < 0.1


def test_unported_model_options_raise():
    """The MoE options earlier slices refused now run: an MoE config's
    init_params, loss_fn and greedy generate, which equals JAX's on the
    same tree (the MoE parity suite: tests/test_torch_moe.py)."""
    fields = {**FIELDS, "n_experts": 2}
    moe = ttf.TransformerConfig(**fields)
    assert {"router", "We1", "We2"} <= ttf.init_params(
        moe, device="cpu")["blocks"].keys()
    jp = jtf.init_params(jtf.TransformerConfig(**fields),
                         jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    toks = _tokens(2, 12, 5)
    loss = ttf.loss_fn(moe, tp, torch.from_numpy(toks),
                       torch.from_numpy(np.roll(toks, -1, axis=1)))
    assert torch.isfinite(loss)
    got = ttf.generate(moe, tp, torch.from_numpy(toks), 6, temperature=0.0)
    want = jtf.generate(jtf.TransformerConfig(**fields), jp,
                        jnp.asarray(toks), 6, jax.random.PRNGKey(0),
                        temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("field,value", [
    ("capacity_factor", 2.0), ("seq_impl", "allgather"), ("n_experts", 2),
])
def test_unported_config_fields_raise(field, value):
    """The fields this test once found unported train now: one step of
    the train step gives a finite loss. One device ignores seq_impl
    (sequence parallelism is parallel/megatron.py's), and capacity_factor
    alone leaves a dense config, as the reference does: the same
    parameters and loss as the default config."""
    cfg = ttf.TransformerConfig(**{**FIELDS, field: value})
    from deeplearning4j_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from deeplearning4j_tpu_torch.parallel.optim import init_adam_state
    params = ttf.init_params(cfg, seed=1, device="cpu")
    toks = _tokens(2, 16, 6)
    tgts = np.roll(toks, -1, axis=1)
    if field in ("capacity_factor", "seq_impl"):
        dense = ttf.init_params(TCFG, seed=1, device="cpu")
        assert all(torch.equal(params["blocks"][k], dense["blocks"][k])
                   for k in dense["blocks"])
        assert float(ttf.loss_fn(cfg, params, torch.from_numpy(toks),
                                 torch.from_numpy(tgts))) == float(
            ttf.loss_fn(TCFG, dense, torch.from_numpy(toks),
                        torch.from_numpy(tgts)))
    step = make_fsdp_train_step(cfg, device="cpu")
    _, _, loss = step(params, init_adam_state(params), toks, tgts)
    assert torch.isfinite(loss)


def test_generate_rejects_bad_requests(tparams):
    ok = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="token ids"):
        ttf.generate(TCFG, tparams, ok - 1, 2)
    with pytest.raises(ValueError, match="max_len"):
        ttf.generate(TCFG, tparams, ok, FIELDS["max_len"])
    with pytest.raises(ValueError, match="top_p"):
        ttf.generate(TCFG, tparams, ok, 2, top_p=0.0)

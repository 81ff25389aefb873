"""Port parity: the config DSL, MultiLayerNetwork and the char-RNN vs JAX.

A small GravesLSTM char-RNN (V=16, H=24, 2 layers, B=4, T=16, TBPTT 8,
RMSProp: `char_rnn_lstm` at reduced width) runs in both packages
from ONE set of weights (the JAX network's `init()`, carried across with
`set_params_from_numpy`), on one-hot inputs from numpy seeds, with
`lstm_wavefront` off (every layer through the port's fused path, the
plain twin on the CPU; JAX's lax.scan) and on (both wavefront stacks).
Everything is float32.

Tolerances: `output`, `score`, the scores of three `fit` calls and of
`fit_batched`, the parameters after them, and `rnn_time_step` within
1e-5 (the same float32 math summed in other orders); updaters,
activations and losses 1e-6. Training runs at lr 0.01 (FIT_LR), not the
configuration's 0.1: RMSProp's first step is lr * g / sqrt(0.05 g^2 +
1e-8), which moves a parameter by up to lr / sqrt(1e-8) = 1000 times
its gradient's float32 noise at lr 0.1, and at that rate this net's training
is chaotic in float32. Measured on the CPU after three fits: the port and
JAX differ by up to 0.02 in a parameter at lr 0.1 (JAX's own two LSTM
schedules, wavefront and per-layer, drift apart the same way), and by
at most 5.7e-7 at lr 0.01.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.nn import activations as jact  # noqa: E402
from deeplearning4j_tpu.nn import lossfunctions as jloss  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    TrainingConfig as JTrainingConfig)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.train import updaters as jupd  # noqa: E402

from deeplearning4j_tpu_torch.models import zoo as tzoo  # noqa: E402
from deeplearning4j_tpu_torch.models.convert import (  # noqa: E402
    network_params_from_numpy, updater_state_from_numpy)
from deeplearning4j_tpu_torch.nn import activations as tact  # noqa: E402
from deeplearning4j_tpu_torch.nn import lossfunctions as tloss  # noqa
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    MultiLayerConfiguration, TrainingConfig)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)
from deeplearning4j_tpu_torch.ops import lstm as tlstm  # noqa: E402
from deeplearning4j_tpu_torch.train import updaters as tupd  # noqa: E402

V, H, B, T, TBPTT = 16, 24, 4, 16, 8
TOL = dict(rtol=0, atol=1e-5)
TIGHT = dict(rtol=1e-6, atol=1e-6)
FIT_LR = 0.01


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _onehot(seed, n=None):
    rng = np.random.default_rng(seed)
    shape = (B, T) if n is None else (n, B, T)
    ids = rng.integers(0, V, shape)
    eye = np.eye(V, dtype=np.float32)
    return eye[ids], eye[np.roll(ids, -1, axis=-1)]


def _conf(pkg, lr=0.1):
    return pkg.char_rnn_lstm(V, hidden=H, layers=2, tbptt_length=TBPTT,
                             learning_rate=lr)


def _pair(wavefront, lr=0.1):
    """JAX and port networks holding the JAX network's weights."""
    jnet = JNet(_conf(jzoo, lr)).init()
    tnet = TNet(_conf(tzoo, lr), device="cpu").init()
    tnet.set_params_from_numpy(_np_tree(jnet.params))
    jnet.lstm_wavefront = tnet.lstm_wavefront = wavefront
    return jnet, tnet


def _assert_params(tnet, jnet, tol=TOL):
    for name, ptree in jnet.params.items():
        for k, v in ptree.items():
            np.testing.assert_allclose(tnet.params[name][k].numpy(),
                                       np.asarray(v), **tol,
                                       err_msg=f"{name}.{k}")


def test_char_rnn_json_equals_jax_and_round_trips():
    jc, tc = _conf(jzoo), _conf(tzoo)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    back = MultiLayerConfiguration.from_json(tc.to_json())
    assert back.to_json() == tc.to_json()
    assert MultiLayerConfiguration.from_yaml(tc.to_yaml()).to_json() == \
        tc.to_json()
    # a resolved configuration (n_in filled, preprocessors) too
    JNet(jc), TNet(tc, device="cpu")
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())


def test_mlp_json_equals_jax():
    assert json.loads(tzoo.mlp_mnist().to_json()) == \
        json.loads(jzoo.mlp_mnist().to_json())


@pytest.mark.parametrize("wavefront", [False, True],
                         ids=["per-layer", "wavefront"])
def test_output_and_score_match_jax(wavefront):
    jnet, tnet = _pair(wavefront)
    x, y = _onehot(0)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    assert abs(tnet.score(x, y) - jnet.score(x, y)) <= 1e-5
    for a, b in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("wavefront", [False, True],
                         ids=["per-layer", "wavefront"])
def test_three_fits_match_jax(wavefront):
    """Three fit() calls of TBPTT (two chunks each): scores and the
    parameters after them."""
    jnet, tnet = _pair(wavefront, FIT_LR)
    for s in range(3):
        x, y = _onehot(10 + s)
        jnet.fit(x, y)
        tnet.fit(x, y)
        assert abs(float(tnet.score_value) - float(jnet.score_value)) \
            <= 1e-5, s
    assert tnet.iteration_count == jnet.iteration_count == 6
    _assert_params(tnet, jnet)
    for name, ptree in jnet.updater_state.items():
        for k, slots in ptree.items():
            for slot, v in slots.items():
                np.testing.assert_allclose(
                    tnet.updater_state[name][k][slot].numpy(),
                    np.asarray(v), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("wavefront", [False, True],
                         ids=["per-layer", "wavefront"])
def test_fit_batched_matches_jax(wavefront):
    """fit_batched over a pool of 2 minibatches x 2 epochs: per-chunk
    scores (8) and the final parameters."""
    jnet, tnet = _pair(wavefront, FIT_LR)
    xs, ys = _onehot(20, n=2)
    s_j = np.asarray(jnet.fit_batched(xs, ys, epochs=2))
    s_t = tnet.fit_batched(xs, ys, epochs=2)
    assert s_t.shape == (8,) and tnet.iteration_count == 8
    np.testing.assert_allclose(s_t.numpy(), s_j, **TOL)
    _assert_params(tnet, jnet)


@pytest.mark.parametrize("wavefront", [False, True],
                         ids=["per-layer", "wavefront"])
def test_rnn_time_step_matches_jax(wavefront):
    """Ten single-step calls carry (h, c) like the JAX network's; then a
    cleared state restarts from zeros."""
    jnet, tnet = _pair(wavefront)
    x, _ = _onehot(30)
    for t in range(10):
        np.testing.assert_allclose(tnet.rnn_time_step(x[:, t]).numpy(),
                                   np.asarray(jnet.rnn_time_step(x[:, t])),
                                   **TOL)
    tnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    np.testing.assert_allclose(tnet.rnn_time_step(x[:, :3]).numpy(),
                               np.asarray(jnet.rnn_time_step(x[:, :3])),
                               **TOL)


def test_per_layer_fit_goes_through_fused_path(monkeypatch):
    """With lstm_wavefront off, each LSTM layer of a TBPTT chunk runs the
    fused dispatch (the kernel on the card): one lstm_scan per layer and
    chunk; with it on, none."""
    calls = []
    real = tlstm.lstm_scan

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)
    monkeypatch.setattr(tlstm, "lstm_scan", counting)
    _, tnet = _pair(False)
    x, y = _onehot(40)
    tnet.fit(x, y)
    assert len(calls) == 2 * (T // TBPTT)
    calls.clear()
    tnet.lstm_wavefront = True
    tnet.fit(x, y)
    assert not calls


def test_init_statistics():
    """init() on the port's own generator at the full char-RNN width:
    shapes, forget-gate bias 1.0 (the rest 0), zero peepholes, xavier
    scale std = sqrt(2 / (fan_in + fan_out)) within 3%, and the same
    weights from the same seed on every call."""
    net = TNet(tzoo.char_rnn_lstm(80, hidden=200, layers=2),
               device="cpu").init()
    p0, p1, out = (net.params[f"layer_{i}"] for i in range(3))
    assert p0["W"].shape == (80, 800) and p1["W"].shape == (200, 800)
    assert p0["RW"].shape == (200, 800) and out["W"].shape == (200, 80)
    for p, fan_in in ((p0, 80), (p1, 200)):
        b = p["b"]
        assert torch.all(b[200:400] == 1.0)
        assert torch.all(b[:200] == 0) and torch.all(b[400:] == 0)
        for k in ("pI", "pF", "pO"):
            assert torch.all(p[k] == 0)
        for k, fi in (("W", fan_in), ("RW", 200)):
            std = float(p[k].std())
            assert abs(std / (2.0 / (fi + 200)) ** 0.5 - 1) < 0.03, k
            assert abs(float(p[k].mean())) < 0.01
    again = TNet(tzoo.char_rnn_lstm(80, hidden=200, layers=2),
                 device="cpu").init()
    assert torch.equal(again.params_flat(), net.params_flat())
    assert net.num_params() == 80 * 800 + 200 * 800 * 3 + 2 * (800 + 600) \
        + 200 * 80 + 80


def test_params_and_updater_state_round_trip_exactly():
    jnet = JNet(_conf(jzoo)).init()
    x, y = _onehot(50)
    jnet.fit(x, y)
    tnet = TNet(_conf(tzoo), device="cpu")
    tnet.set_params_from_numpy(_np_tree(jnet.params))
    tnet.set_updater_state_from_numpy(_np_tree(jnet.updater_state))
    for name, ptree in jnet.params.items():
        for k, v in ptree.items():
            assert np.array_equal(tnet.params[name][k].numpy(),
                                  np.asarray(v))
    for name, ptree in jnet.updater_state.items():
        for k, slots in ptree.items():
            for slot, v in slots.items():
                got = tnet.updater_state[name][k][slot]
                assert got.dtype == torch.float32
                assert np.array_equal(got.numpy(), np.asarray(v))
    np.testing.assert_array_equal(tnet.params_flat().numpy(),
                                  np.asarray(jnet.params_flat()))
    flat = network_params_from_numpy(_np_tree(jnet.params), "cpu")
    assert set(flat) == set(jnet.params)
    st = updater_state_from_numpy(_np_tree(jnet.updater_state), "cpu")
    assert set(st["layer_0"]["RW"]) == {"h"}


@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "adagrad",
                                     "rmsprop", "adadelta", "adam",
                                     "adamax", "nadam"])
@pytest.mark.parametrize("norm", ["none", "clipl2perlayer",
                                  "renormalizel2perparamtype"])
def test_apply_updater_matches_jax(updater, norm):
    """Three updater applications on a two-layer tree, with an lr
    multiplier, a frozen layer and gradient normalization."""
    kw = dict(updater=updater, learning_rate=0.05,
              gradient_normalization=norm,
              gradient_normalization_threshold=0.5)
    jtc, ttc = JTrainingConfig(**kw), TrainingConfig(**kw)
    rng = np.random.default_rng(60)
    params = {"a": {"W": rng.normal(size=(3, 4)).astype(np.float32),
                    "b": rng.normal(size=(4,)).astype(np.float32)},
              "c": {"W": rng.normal(size=(4, 2)).astype(np.float32)}}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = network_params_from_numpy(params, "cpu")
    js, ts = jupd.init_updater_state(jtc, jp), tupd.init_updater_state(
        ttc, tp)
    mult, train = {"a": 0.5}, {"c": False}
    for it in range(3):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        jp, js = jupd.apply_updater(jtc, jp, jax.tree_util.tree_map(
            jnp.asarray, g), js, it, lr_multipliers=mult, trainable=train)
        tp, ts = tupd.apply_updater(ttc, tp, network_params_from_numpy(
            g, "cpu"), ts, it, lr_multipliers=mult, trainable=train)
    for name in params:
        for k in params[name]:
            np.testing.assert_allclose(tp[name][k].numpy(),
                                       np.asarray(jp[name][k]), **TIGHT)


@pytest.mark.parametrize("policy,extra", [
    ("none", {}), ("exponential", dict(lr_policy_decay_rate=0.9)),
    ("inverse", dict(lr_policy_decay_rate=0.1, lr_policy_power=0.75)),
    ("step", dict(lr_policy_decay_rate=0.5, lr_policy_steps=3)),
    ("poly", dict(lr_policy_power=2.0, num_iterations=20)),
    ("sigmoid", dict(lr_policy_decay_rate=0.3, lr_policy_steps=5)),
    ("schedule", dict(lr_schedule={"0": 0.1, "4": 0.01, "8": 0.001})),
])
def test_learning_rate_policies_match_jax(policy, extra):
    kw = dict(learning_rate=0.1, lr_policy=policy, **extra)
    for it in (0, 1, 4, 7, 9, 15):
        want = float(jupd.compute_learning_rate(JTrainingConfig(**kw), it))
        got = tupd.compute_learning_rate(TrainingConfig(**kw), it)
        assert abs(got - want) <= 1e-7 * max(1.0, abs(want)), (policy, it)


@pytest.mark.parametrize("name", sorted(tact.ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 41, dtype=np.float32)
    np.testing.assert_allclose(
        tact.get_activation(name)(torch.from_numpy(x)).numpy(),
        np.asarray(jact.get_activation(name)(jnp.asarray(x))), **TIGHT)


def test_unknown_activation_lists_valid_names():
    with pytest.raises(ValueError, match="Available:.*sigmoid"):
        tact.get_activation("sigmoidd")


@pytest.mark.parametrize("name", sorted(tloss.LOSS_FUNCTIONS))
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(name, masked):
    rng = np.random.default_rng(70)
    pre = rng.normal(size=(3, 5, 6)).astype(np.float32)
    lab = rng.random((3, 5, 6)).astype(np.float32)
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        lab = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (3, 5))]
    if name in ("hinge", "squared_hinge", "xent",
                "reconstruction_crossentropy"):
        lab = (lab > 0.5).astype(np.float32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if masked else None
    act = "softmax" if name in ("mcxent", "negativeloglikelihood",
                                "kl_divergence") else "sigmoid"
    want = jloss.get_loss(name)(jnp.asarray(lab), jnp.asarray(pre), act,
                                None if mask is None else jnp.asarray(mask))
    got = tloss.get_loss(name)(torch.from_numpy(lab), torch.from_numpy(pre),
                               act, None if mask is None
                               else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


def test_unported_paths_raise():
    tnet = TNet(_conf(tzoo), device="cpu").init()
    # fit_batched_cost, the guard and LossLayer are ported: they run
    cost = tnet.fit_batched_cost(np.zeros((1, B, T, V), np.float32),
                                 np.zeros((1, B, T, V), np.float32))
    assert cost["flops"] > 0 and cost["steps"] == T // TBPTT
    assert cost["flops"] == tnet.fit_batched_cost(
        np.zeros((3, B, T, V), np.float32),
        np.zeros((3, B, T, V), np.float32))["flops"]
    tnet.set_training_guard(None)
    from deeplearning4j_tpu_torch.nn.layers import LossLayer
    LossLayer()
    # layerwise pretraining is ported: a network without a pretrain
    # layer has nothing to pretrain, and its params stay as they are
    before = tnet.params_flat().clone()
    tnet.pretrain([])
    assert torch.equal(tnet.params_flat(), before)
    assert tnet._pretrain_counts == {}
    bidi = tzoo.char_rnn_lstm(V, hidden=H)
    from deeplearning4j_tpu_torch.nn.layers import GravesBidirectionalLSTM
    bidi.layers[0] = GravesBidirectionalLSTM(n_out=H, activation="tanh")
    with pytest.raises(ValueError, match="full sequence"):
        TNet(bidi, device="cpu").init().rnn_time_step(np.zeros((B, V),
                                                               np.float32))

"""Port parity: layerwise pretraining (AutoEncoder, RBM,
VariationalAutoencoder) vs the JAX package.

Every random draw of the port's pretraining layers goes through
`Layer.draw(kind, key, shape, device)`. Here that one function is handed
JAX's own draws, computed from JAX's keys in the order the port asks
for them: `jax.random.uniform(k, shape) < p` is how
`jax.random.bernoulli` draws (the AutoEncoder's corruption, the RBM's
Gibbs samples; uniforms of p's dtype), and `jax.random.normal` gives
the VAE's eps. With the
same draws and JAX's weights (`set_params_from_numpy`), the losses and
gradients, and the parameters after `pretrain` steps of a
MultiLayerNetwork and of a ComputationGraph, are held to JAX's within
1e-5 + 1e-5 |jax| in float32. The port's own draws (a hash of (key,
element)) are checked for their distribution and their determinism.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.nn.layers as jlayers  # noqa: E402
from deeplearning4j_tpu.nn.layers.feedforward import RBM as JRBM  # noqa
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402
    ComputationGraph as TGraph)
from deeplearning4j_tpu_torch.nn.layers import base as tbase  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)

TOL = dict(rtol=1e-5, atol=1e-5)
# JAX's nn.layers exports no RBM; its feedforward module holds it
jl = types.SimpleNamespace(**vars(jlayers), RBM=JRBM)


class JaxDraws:
    """Stands in for `Layer.draw`: hands out JAX's draws in order,
    checking each request's kind and shape."""

    def __init__(self):
        self.queue = []

    def add(self, kind, arr):
        self.queue.append((kind, np.asarray(arr)))

    def __call__(self, layer, kind, key, shape, device):
        want_kind, arr = self.queue.pop(0)
        assert kind == want_kind and tuple(shape) == arr.shape, \
            (kind, tuple(shape), want_kind, arr.shape)
        return torch.from_numpy(arr.copy()).to(device)


@pytest.fixture
def draws(monkeypatch):
    d = JaxDraws()
    monkeypatch.setattr(tbase.Layer, "draw",
                        lambda self, kind, key, shape, device:
                        d(self, kind, key, shape, device))
    yield d
    assert not d.queue, f"{len(d.queue)} draws left unused"


def _key(seed, it):
    return jax.random.fold_in(jax.random.PRNGKey(seed), it)


def ae_draws(d, key, shape):
    # bernoulli(key, p) draws uniforms of p's dtype: a Python float's,
    # float64 where jax_enable_x64 is on (as the test session sets it)
    d.add("uniform", jax.random.uniform(key, shape,
                                        jnp.asarray(0.5).dtype))


def rbm_draws(d, key, h_shape, v_shape, k=1, binary_visible=True):
    for _ in range(k):
        key, k1, k2 = jax.random.split(key, 3)
        d.add("uniform", jax.random.uniform(k1, h_shape, jnp.float32))
        if binary_visible:
            d.add("uniform", jax.random.uniform(k2, v_shape, jnp.float32))


def vae_draws(d, key, shape, n=1):
    for s in range(n):
        d.add("normal", jax.random.normal(jax.random.fold_in(key, s), shape,
                                          jnp.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _binary(n, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, f)) < 0.4).astype(np.float32)


LAYERS = {
    "autoencoder": lambda p: p.AutoEncoder(n_in=10, n_out=6,
                                           corruption_level=0.3,
                                           activation="sigmoid"),
    "rbm_binary_k2": lambda p: p.RBM(n_in=10, n_out=6, k=2),
    "rbm_gaussian": lambda p: p.RBM(n_in=10, n_out=6,
                                    visible_unit="gaussian"),
    "vae_gaussian_2samples": lambda p: p.VariationalAutoencoder(
        n_in=10, n_out=3, encoder_layer_sizes=(8, 7),
        decoder_layer_sizes=(7,), num_samples=2),
    "vae_composite": lambda p: p.VariationalAutoencoder(
        n_in=10, n_out=3, encoder_layer_sizes=(8,),
        decoder_layer_sizes=(8,),
        reconstruction_distribution=[(4, "bernoulli"), (3, "gaussian"),
                                     (3, "exponential")]),
}


def _queue_for(d, name, key, x, layer):
    if name == "autoencoder":
        ae_draws(d, key, x.shape)
    elif name.startswith("rbm"):
        rbm_draws(d, key, (x.shape[0], layer.n_out), x.shape, k=layer.k,
                  binary_visible=layer.visible_unit == "binary")
    else:
        vae_draws(d, key, (x.shape[0], layer.n_out), layer.num_samples)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_pretrain_loss_and_grads_match_jax(name, draws):
    jlayer, tlayer = LAYERS[name](jl), LAYERS[name](tl)
    assert jlayer.is_pretrain_layer() and tlayer.is_pretrain_layer()
    params = jlayer.init_params(jax.random.PRNGKey(3))
    x = _binary(12, 10, seed=1)
    key = _key(7, 0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlayer.pretrain_loss(p, jnp.asarray(x), key))(params)
    _queue_for(draws, name, key, x, jlayer)
    tp = {k: v.requires_grad_(True) for k, v in _t(_np(params)).items()}
    tloss = tlayer.pretrain_loss(tp, torch.from_numpy(x), 123)
    tgrads = dict(zip(tp, torch.autograd.grad(tloss, list(tp.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(g), **TOL,
                                   err_msg=f"{name} grad {k}")
    # the supervised forward (encode / hidden probabilities / latent mean)
    jy, _ = jlayer.apply(params, {}, jnp.asarray(x))
    ty, _ = tlayer.apply(_t(_np(params)), {}, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_vae_reconstruction_prob_matches_jax(draws):
    jlayer, tlayer = (LAYERS["vae_gaussian_2samples"](p) for p in (jl, tl))
    params = jlayer.init_params(jax.random.PRNGKey(4))
    x = np.random.default_rng(2).normal(size=(6, 10)).astype(np.float32)
    key = _key(1, 0)
    want = jlayer.reconstruction_prob(params, jnp.asarray(x), key,
                                      num_samples=3)
    vae_draws(draws, key, (6, 3), n=3)
    got = tlayer.reconstruction_prob(_t(_np(params)), torch.from_numpy(x),
                                     5, num_samples=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vae_composite_size_mismatch_raises():
    vae = tl.VariationalAutoencoder(
        n_in=10, n_out=2,
        reconstruction_distribution=[(4, "bernoulli"), (3, "gaussian")])
    with pytest.raises(ValueError, match="covers 7 features"):
        vae.init_params(torch.Generator().manual_seed(0))


def _mln(pkg, conf_cls, pre):
    return (conf_cls(seed=5, updater="adam", learning_rate=0.01,
                     activation="tanh")
            .list(pkg.DenseLayer(n_in=10, n_out=8),
                  pre(pkg),
                  pkg.OutputLayer(n_out=2, activation="softmax",
                                  loss_function="mcxent")))


MLN_PRE = {
    "autoencoder": (lambda p: p.AutoEncoder(n_out=5, corruption_level=0.25,
                                            activation="sigmoid")),
    "rbm": (lambda p: p.RBM(n_out=5)),
    "vae": (lambda p: p.VariationalAutoencoder(
        n_out=2, encoder_layer_sizes=(6,), decoder_layer_sizes=(6,),
        reconstruction_distribution="gaussian")),
}


@pytest.mark.parametrize("name", sorted(MLN_PRE))
def test_multilayer_pretrain_matches_jax(name, draws):
    """`pretrain` runs the pretrain layer (index 1) on the frozen dense
    layer's output: 3 steps from one array and 2 more through an
    iterable of batches, the Adam step count running on across calls."""
    jnet = JNet(_mln(jl, JConf, MLN_PRE[name])).init()
    tnet = TNet(_mln(tl, TConf, MLN_PRE[name]), device="cpu").init()
    tnet.set_params_from_numpy(_np(jnet.params))
    x = np.random.default_rng(3).random((16, 10), dtype=np.float32)
    batches = [(x[:8], None), (x[8:], None)]
    dense_w = tnet.params["layer_0"]["W"].clone()
    layer = jnet.layers[1]
    it = 0
    for data in (x, x, x, batches):
        rows = [x] if data is x else [b for b, _ in data]
        for xb in rows:
            h = np.tanh(xb @ np.asarray(jnet.params["layer_0"]["W"])
                        + np.asarray(jnet.params["layer_0"]["b"]))
            _queue_for(draws, name, _key(5, it), h, layer)
            it += 1
        if data is x:
            jnet.pretrain_layer(1, x)
        else:
            jnet.pretrain_layer(1, data)
        tnet.pretrain_layer(1, data)
        np.testing.assert_allclose(float(tnet.score_value),
                                   float(jnet.score_value), **TOL)
    for k, v in jnet.params["layer_1"].items():
        np.testing.assert_allclose(tnet.params["layer_1"][k].numpy(),
                                   np.asarray(v), **TOL,
                                   err_msg=f"{name} {k}")
    assert torch.equal(tnet.params["layer_0"]["W"], dense_w)
    assert tnet._pretrain_counts[1] == it


def _graph(pkg, conf_cls, pre):
    layer = pre(pkg)
    layer.n_in = 6          # no input types: each layer carries its n_in
    return (conf_cls(seed=3, updater="adam", learning_rate=0.01,
                     activation="tanh")
            .graph_builder().add_inputs("in")
            .add_layer("d", pkg.DenseLayer(n_in=8, n_out=6), "in")
            .add_layer("pre", layer, "d")
            .add_layer("out", pkg.OutputLayer(n_in=layer.n_out, n_out=2,
                                              activation="softmax",
                                              loss_function="mcxent"),
                       "pre")
            .set_outputs("out").build())


@pytest.mark.parametrize("name", ["rbm", "vae"])
def test_graph_pretrain_matches_jax(name, draws):
    """`ComputationGraph.pretrain` trains each pretrain vertex in
    topological order on its upstream subgraph's output."""
    jg = JGraph(_graph(jl, JConf, MLN_PRE[name])).init()
    tg = TGraph(_graph(tl, TConf, MLN_PRE[name]), device="cpu").init()
    tg.set_params_from_numpy(_np(jg.params))
    x = np.random.default_rng(4).random((12, 8), dtype=np.float32)
    layer = jg.conf.vertices["pre"].vertex
    h = np.tanh(x @ np.asarray(jg.params["d"]["W"])
                + np.asarray(jg.params["d"]["b"]))
    for it in range(3):
        _queue_for(draws, name, _key(3, it), h, layer)
        jg.pretrain(x)
        tg.pretrain(x)
        np.testing.assert_allclose(float(tg.score_value),
                                   float(jg.score_value), **TOL)
    for k, v in jg.params["pre"].items():
        np.testing.assert_allclose(tg.params["pre"][k].numpy(),
                                   np.asarray(v), **TOL, err_msg=k)
    np.testing.assert_array_equal(tg.params["d"]["W"].numpy(),
                                  np.asarray(jg.params["d"]["W"]))
    # the supervised path still trains after pretraining
    y = np.eye(2, dtype=np.float32)[np.arange(12) % 2]
    jg.fit(x, y)
    tg.fit(x, y)
    np.testing.assert_allclose(float(tg.score_value),
                               float(jg.score_value), **TOL)


def test_pretrain_layers_serialize_like_jax():
    for name, make in LAYERS.items():
        conf_j = _mln(jl, JConf, lambda p: make(p))
        conf_t = _mln(tl, TConf, lambda p: make(p))
        assert conf_j.to_json() == conf_t.to_json(), name


def test_port_draws_are_deterministic_and_distributed():
    """The port's own draws: a function of (key, shape) alone; uniform
    [0, 1) and standard normal to sampling error; different keys give
    different streams."""
    layer = tl.RBM(n_in=4, n_out=3)
    u = layer.draw("uniform", 11, (200, 300), "cpu")
    z = layer.draw("normal", 11, (200, 300), "cpu")
    assert torch.equal(u, layer.draw("uniform", 11, (200, 300), "cpu"))
    assert torch.equal(z, layer.draw("normal", 11, (200, 300), "cpu"))
    assert not torch.equal(z, layer.draw("normal", 12, (200, 300), "cpu"))
    assert u.dtype == z.dtype == torch.float32
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert torch.isfinite(z).all()
    with pytest.raises(ValueError, match="unknown draw kind"):
        layer.draw("poisson", 1, (2,), "cpu")


def test_rbm_pretrain_reduces_free_energy_gap():
    """The port's own CD-1 (its own draws and init) learns two binary
    prototypes: data's free energy falls well below noise's, the gap JAX's
    test_rbm_pretrain_reduces_free_energy_gap asks of JAX's, here after
    100 steps (seeds 1-5 give gaps of 3.2-4.0 there)."""
    rng = np.random.default_rng(0)
    protos = np.array([[1, 1, 1, 1, 0, 0, 0, 0],
                       [0, 0, 0, 0, 1, 1, 1, 1]], np.float32)
    x = protos[rng.integers(0, 2, 128)]
    x = np.abs(x - (rng.random(x.shape) < 0.05).astype(np.float32))
    conf = TConf(seed=1, updater="sgd", learning_rate=0.1).list(
        tl.RBM(n_in=8, n_out=6),
        tl.OutputLayer(n_out=2, activation="softmax",
                       loss_function="mcxent"))
    conf.set_pretrain(True)
    net = TNet(conf, device="cpu").init()
    rbm = net.layers[0]

    def fe(v):
        with torch.no_grad():
            return float(rbm._free_energy(net.params["layer_0"],
                                          torch.from_numpy(v)).mean())

    rand_v = rng.integers(0, 2, x.shape).astype(np.float32)
    gap_before = fe(rand_v) - fe(x)
    for _ in range(100):
        net.pretrain_layer(0, x)
    assert fe(rand_v) - fe(x) > gap_before + 1.0
    net.pretrain(x)                     # every pretrain layer, once more
    assert net._pretrain_counts[0] == 101


@pytest.mark.parametrize("name", sorted(MLN_PRE))
def test_check_gradients_float64_supervised_path(name):
    """The port's check_gradients on a float64 network whose hidden
    layer is a pretraining layer (its supervised forward: encode, hidden
    probabilities, latent mean)."""
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    conf = (TConf(seed=4, updater="sgd", activation="tanh",
                  dtype="float64")
            .list(tl.DenseLayer(n_in=5, n_out=6), MLN_PRE[name](tl),
                  tl.OutputLayer(n_out=3, activation="softmax")))
    net = TNet(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 5))
    y = np.eye(3)[rng.integers(0, 3, 4)]
    assert check_gradients(net, x, y, epsilon=1e-6, max_rel_error=1e-3,
                           min_abs_error=1e-8)


@pytest.mark.parametrize("name", ["autoencoder", "vae_gaussian_2samples",
                                  "vae_composite"])
def test_pretrain_loss_gradcheck_float64(name):
    """Autograd's gradient of pretrain_loss against central differences
    in float64, with the port's own draws (fixed by the key; the RBM's
    Gibbs samples are discrete in its params, so it is held to JAX's
    gradients above instead)."""
    layer = LAYERS[name](tl)
    params = {k: v.double() for k, v in layer.init_params(
        torch.Generator().manual_seed(2)).items()}
    x = torch.from_numpy(_binary(6, 10, seed=3)).double()
    flat = torch.cat([p.reshape(-1) for p in params.values()])

    def loss(w):
        out, off = {}, 0
        for k, p in params.items():
            out[k] = w[off:off + p.numel()].reshape(p.shape)
            off += p.numel()
        return layer.pretrain_loss(out, x, 41)

    w = flat.clone().requires_grad_(True)
    grad, = torch.autograd.grad(loss(w), w)
    idx = np.random.default_rng(0).choice(flat.numel(), 40, replace=False)
    eps = 1e-6
    with torch.no_grad():
        for i in idx:
            e = torch.zeros_like(flat)
            e[i] = eps
            num = (float(loss(flat + e)) - float(loss(flat - e))) / (2 * eps)
            ana = float(grad[i])
            denom = max(abs(num), abs(ana), 1e-8)
            assert abs(num - ana) / denom < 1e-4 or abs(num - ana) < 1e-8, \
                (i, num, ana)

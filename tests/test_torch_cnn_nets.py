"""Port parity: the CNN training path end to end vs the JAX package.

Three networks run in both packages from one set of weights (the JAX
network's `init()`, carried across with `set_params_from_numpy`) on the
same numpy data, in float32:

- LeNet (`zoo.lenet_mnist`) narrowed to 4 and 8 filters and a dense 32,
  Nesterov momentum: 5 steps through `fit(MnistDataSetIterator(...))` on
  the synthetic MNIST of both packages (the same arrays from the same
  seed), and 5 through `fit_batched` on a pool of the same batches;
- a two-block narrow VGG with batch norm (conv-BN-conv-pool twice, dense,
  softmax) on synthetic CIFAR-shaped images, through `fit` and
  `fit_batched` (BN running statistics compared as state);
- `zoo.text_cnn` at embedding 8, 6 filters, 3 classes, T=12, Adam.

Tolerances: the per-step scores, the parameters and the BN state after
the steps within 1e-5 + 1e-5 |jax| (the same float32 math summed in
other orders; LeNet's conv-kernel gradients are sums over 8 x 24 x 24
positions); outputs 1e-5. The configurations' JSON equals JAX's.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu.datasets import impl as jimpl  # noqa: E402
from deeplearning4j_tpu.modelimport import trained_models as jtm  # noqa
from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT  # noqa
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch.datasets import impl as timpl  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    trained_models as ttm)
from deeplearning4j_tpu_torch.models import zoo as tzoo  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT  # noqa
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)

TOL = dict(rtol=1e-5, atol=1e-5)
B, STEPS = 8, 5


@pytest.fixture(autouse=True)
def no_mnist_fetch(monkeypatch):
    """JAX's MNIST iterator fetches what its cache lacks; here both
    packages make the synthetic set and nothing is fetched."""
    monkeypatch.setattr(jimpl, "_try_download", lambda name: None)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lenet(zoo):
    conf = zoo.lenet_mnist()
    conf.layers[0].n_out = 4
    conf.layers[2].n_out = 8
    conf.layers[4].n_out = 32
    return conf


def _vgg_bn(pkg, it):
    def conv(n):
        return pkg.ConvolutionLayer(n_out=n, kernel_size=(3, 3),
                                    convolution_mode="same",
                                    activation="relu")
    layers = []
    for ch in (4, 8):
        layers += [conv(ch), pkg.BatchNormalization(decay=0.9), conv(ch),
                   pkg.SubsamplingLayer(pooling_type="max",
                                        kernel_size=(2, 2), stride=(2, 2))]
    layers += [pkg.DenseLayer(n_out=16, activation="relu"),
               pkg.OutputLayer(n_out=10, activation="softmax")]
    conf = (JConf if pkg is jl else TConf)(
        seed=7, updater="nesterovs", learning_rate=0.05, momentum=0.9,
        weight_init="relu")
    return conf.list(*layers).set_input_type(it.convolutional(12, 12, 3))


def _text_cnn(zoo):
    return zoo.text_cnn(8, 3, max_sentence_length=12, filters=6,
                        learning_rate=0.01)


def _pair(jconf, tconf):
    jnet = JNet(jconf).init()
    tnet = TNet(tconf, device="cpu").init()
    tnet.set_params_from_numpy(_np(jnet.params))
    tnet.set_state_from_numpy(_np(jnet.state))
    return jnet, tnet


def _assert_tree(got, want, what):
    for name, sub in want.items():
        for k, v in sub.items():
            np.testing.assert_allclose(got[name][k].numpy(), np.asarray(v),
                                       **TOL, err_msg=f"{what} {name}.{k}")


def _assert_nested(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_nested(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=what)


def _assert_same(jnet, tnet):
    _assert_tree(tnet.params, jnet.params, "param")
    _assert_tree(tnet.state, jnet.state, "state")


@pytest.mark.parametrize("make", [
    lambda z: z.lenet_mnist(), lambda z: z.text_cnn(50, 5),
    lambda z: z.mlp_mnist(),
    lambda z: (jtm if z is jzoo else ttm).vgg16(include_top=False,
                                                height=32, width=32)],
    ids=["lenet", "text_cnn", "mlp", "vgg16"])
def test_configuration_json_equals_jax(make):
    jc, tc = make(jzoo), make(tzoo)
    JNet(jc), TNet(tc, device="cpu")          # resolved shapes too
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())


def test_vgg16_helpers():
    img = np.random.default_rng(0).integers(0, 255, (2, 4, 4, 3))
    np.testing.assert_array_equal(ttm.vgg16_preprocess(img),
                                  jtm.vgg16_preprocess(img))
    # load_vgg16 imports a local Keras file (the trained VGG16 fixture)
    # as JAX's does, and names a missing one
    h5 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "real_vgg16_trained.h5")
    x = np.load(h5.replace(".h5", "_golden.npz"))["x"][:4]
    np.testing.assert_allclose(
        ttm.load_vgg16(h5, device="cpu").output(x).numpy(),
        np.asarray(jtm.load_vgg16(h5).output(x)), **TOL)
    with pytest.raises(FileNotFoundError):
        ttm.load_vgg16("weights.h5", device="cpu")
    # resnet50 is a ComputationGraph configuration, ported with the graph
    assert ttm.resnet50().to_json() == jtm.resnet50().to_json()


def test_lenet_fit_mnist_iterator_matches_jax():
    jnet, tnet = _pair(_lenet(jzoo), _lenet(tzoo))
    it_j = jimpl.MnistDataSetIterator(B, num_examples=B * STEPS)
    it_t = timpl.MnistDataSetIterator(B, num_examples=B * STEPS)
    assert it_j.synthetic and it_t.synthetic
    js, ts = [], []
    for bj, bt in zip(it_j, it_t):
        np.testing.assert_array_equal(bt.features, bj.features)
        jnet.fit(bj.features, bj.labels)
        tnet.fit(bt.features, bt.labels)
        js.append(float(jnet.score_value))
        ts.append(float(tnet.score_value))
    assert len(ts) == STEPS
    np.testing.assert_allclose(ts, js, **TOL)
    _assert_same(jnet, tnet)
    x = it_t.features[:B]
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), **TOL)
    # the iterator itself through fit() (one epoch) continues to agree
    jnet.fit(it_j)
    tnet.fit(it_t)
    assert tnet.epoch_count == jnet.epoch_count == 1
    assert tnet.iteration_count == jnet.iteration_count == 2 * STEPS
    _assert_same(jnet, tnet)


def test_lenet_fit_batched_matches_jax():
    jnet, tnet = _pair(_lenet(jzoo), _lenet(tzoo))
    it = timpl.MnistDataSetIterator(B, num_examples=B * STEPS)
    xs = it.features.reshape(STEPS, B, -1)
    ys = it.labels.reshape(STEPS, B, -1)
    js = np.asarray(jnet.fit_batched(xs, ys))
    ts = tnet.fit_batched(xs, ys).numpy()
    np.testing.assert_allclose(ts, js, **TOL)
    assert tnet.iteration_count == jnet.iteration_count == STEPS
    _assert_same(jnet, tnet)


@pytest.mark.parametrize("path", ["fit", "fit_batched"])
def test_narrow_vgg_with_batch_norm_matches_jax(path):
    jnet, tnet = _pair(_vgg_bn(jl, JIT), _vgg_bn(tl, TIT))
    it = timpl.CifarDataSetIterator(B, num_examples=B * 3)
    feats = it.features[:, 10:22, 10:22, :]
    xs = feats.reshape(3, B, 12, 12, 3)
    ys = it.labels.reshape(3, B, -1)
    if path == "fit":
        js, ts = [], []
        for x, y in zip(xs, ys):
            jnet.fit(x, y)
            tnet.fit(x, y)
            js.append(float(jnet.score_value))
            ts.append(float(tnet.score_value))
    else:
        js = np.asarray(jnet.fit_batched(xs, ys, epochs=2))
        ts = tnet.fit_batched(xs, ys, epochs=2).numpy()
    np.testing.assert_allclose(ts, js, **TOL)
    _assert_same(jnet, tnet)
    # BN's running statistics moved off their init
    bn = tnet.layer_names[1]
    assert float(tnet.state[bn]["var"].sub(1).abs().max()) > 1e-3
    # inference mode uses them: output and score agree
    np.testing.assert_allclose(tnet.output(xs[0]).numpy(),
                               np.asarray(jnet.output(xs[0])), **TOL)
    assert abs(tnet.score(xs[0], ys[0]) - jnet.score(xs[0], ys[0])) <= 1e-5


def test_text_cnn_matches_jax():
    jnet, tnet = _pair(_text_cnn(jzoo), _text_cnn(tzoo))
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(4, B, 12, 8)).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, B))]
    js, ts = [], []
    for x, y in zip(xs[:2], ys[:2]):
        jnet.fit(x, y)
        tnet.fit(x, y)
        js.append(float(jnet.score_value))
        ts.append(float(tnet.score_value))
    js += list(np.asarray(jnet.fit_batched(xs[2:], ys[2:])))
    ts += list(tnet.fit_batched(xs[2:], ys[2:]).numpy())
    np.testing.assert_allclose(ts, js, **TOL)
    _assert_nested(tnet.updater_state, jnet.updater_state, "updater")
    _assert_same(jnet, tnet)

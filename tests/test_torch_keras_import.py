"""Port parity: Keras import (`deeplearning4j_tpu_torch.modelimport`) vs
the JAX package's, on the CPU.

- The built-in cases of tests/test_keras_import.py (Keras-2 files written
  here with h5py: dense, conv, LSTM, a functional add, a Keras-1 Theano
  conv; the training-config output layer and its fit; the functional
  training config and enforce_training_config; config-only JSON; the
  VGG16 and ResNet-50 configurations): each imported file through both
  packages, the port's params and BN state equal to JAX's and its outputs
  within 1e-5 of JAX's and of the numpy golden at that test's tolerance.
- The eight real fixtures of tests/test_keras_real_fixtures.py (written
  and predicted by tf_keras): imported through both packages, params and
  state equal, outputs within 1e-5 of JAX's; the port also against the
  Keras goldens at the JAX tests' tolerances (1e-4 / 1e-5; the LSTM
  1e-4 / 1e-4; VGG16 through load_vgg16 1e-3 / 1e-4 with the argmax
  equal and accuracy >= 0.8). channels_first inputs are fed NHWC.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from torch_threads import one_torch_thread  # noqa: E402,F401

import deeplearning4j_tpu.modelimport as jmi  # noqa: E402
from deeplearning4j_tpu.modelimport import trained_models as jtm  # noqa

import deeplearning4j_tpu_torch.modelimport as tmi  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    trained_models as ttm)
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402
    ComputationGraph as TGraph)
from deeplearning4j_tpu_torch.nn.layers import OutputLayer  # noqa: E402

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return _np(t[0])
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t)


def _same_tree(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _same_tree(got[k], want[k], f"{where}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where}/{k}")


def _both(path, importer="import_keras_model_auto", **kw):
    """The file through both packages; params and state must be equal."""
    jnet = getattr(jmi, importer)(path, **kw)
    tnet = getattr(tmi, importer)(path, device="cpu", **kw)
    _same_tree(_np(tnet.params), _np(jnet.params), "params")
    _same_tree(_np(tnet.state), _np(jnet.state), "state")
    return jnet, tnet


def _outputs(jnet, tnet, x):
    got, want = _np(tnet.output(x)), _np(jnet.output(x))
    np.testing.assert_allclose(got, want, **TOL)
    return got


# --------------------------------------------------------------------------
# built-in cases (tests/test_keras_import.py)
# --------------------------------------------------------------------------

def _write_keras_file(path, model_config, layer_weights,
                      training_config=None):
    """The Keras-2 HDF5 layout: attrs model_config / training_config,
    group model_weights with layer_names and per-layer weight_names."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config).encode()
        if training_config is not None:
            f.attrs["training_config"] = json.dumps(training_config).encode()
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_weights], dtype="S64")
        for lname, weights in layer_weights.items():
            g = mw.create_group(lname)
            g.attrs["weight_names"] = np.array(
                [wn.encode() for wn in weights], dtype="S64")
            for wn, arr in weights.items():
                g.create_dataset(wn, data=arr)


def _softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _dense_case(tmp_path):
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(4, 8)).astype(np.float32)
    b1 = rng.normal(size=(8,)).astype(np.float32)
    w2 = rng.normal(size=(8, 3)).astype(np.float32)
    b2 = rng.normal(size=(3,)).astype(np.float32)
    mc = {"class_name": "Sequential", "keras_version": "2.1.0",
          "backend": "tensorflow", "config": [
              {"class_name": "Dense",
               "config": {"name": "dense_1", "units": 8,
                          "activation": "relu",
                          "batch_input_shape": [None, 4]}},
              {"class_name": "Dense",
               "config": {"name": "dense_2", "units": 3,
                          "activation": "softmax"}}]}
    path = str(tmp_path / "dense.h5")
    _write_keras_file(path, mc, {
        "dense_1": {"dense_1/kernel:0": w1, "dense_1/bias:0": b1},
        "dense_2": {"dense_2/kernel:0": w2, "dense_2/bias:0": b2}},
        training_config={"loss": "categorical_crossentropy"})
    x = rng.normal(size=(5, 4)).astype(np.float32)
    return path, x, _softmax(np.maximum(x @ w1 + b1, 0) @ w2 + b2), 1e-5


def _conv_case(tmp_path):
    rng = np.random.default_rng(1)
    k = rng.normal(size=(3, 3, 2, 4), scale=0.5).astype(np.float32)
    bk = rng.normal(size=(4,)).astype(np.float32)
    wd = rng.normal(size=(4, 3), scale=0.5).astype(np.float32)
    bd = rng.normal(size=(3,)).astype(np.float32)
    mc = {"class_name": "Sequential", "keras_version": "2.1.0",
          "backend": "tensorflow", "config": [
              {"class_name": "Conv2D",
               "config": {"name": "conv", "filters": 4,
                          "kernel_size": [3, 3], "strides": [1, 1],
                          "padding": "same", "activation": "relu",
                          "data_format": "channels_last",
                          "batch_input_shape": [None, 6, 6, 2]}},
              {"class_name": "GlobalAveragePooling2D",
               "config": {"name": "gap"}},
              {"class_name": "Dense",
               "config": {"name": "out", "units": 3,
                          "activation": "softmax"}}]}
    path = str(tmp_path / "conv.h5")
    _write_keras_file(path, mc, {
        "conv": {"conv/kernel:0": k, "conv/bias:0": bk},
        "out": {"out/kernel:0": wd, "out/bias:0": bd}})
    x = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    conv = np.zeros((2, 6, 6, 4), np.float32)
    for i in range(6):
        for j in range(6):
            conv[:, i, j, :] = np.tensordot(xp[:, i:i + 3, j:j + 3, :], k,
                                            axes=([1, 2, 3], [0, 1, 2]))
    want = _softmax(np.maximum(conv + bk, 0).mean(axis=(1, 2)) @ wd + bd)
    return path, x, want, 1e-4


def _lstm_case(tmp_path):
    rng = np.random.default_rng(2)
    H, F, T, B = 5, 3, 4, 2
    kernel = rng.normal(size=(F, 4 * H), scale=0.5).astype(np.float32)
    rker = rng.normal(size=(H, 4 * H), scale=0.5).astype(np.float32)
    bias = rng.normal(size=(4 * H,), scale=0.1).astype(np.float32)
    mc = {"class_name": "Sequential", "keras_version": "2.1.0",
          "backend": "tensorflow", "config": [
              {"class_name": "LSTM",
               "config": {"name": "lstm", "units": H, "activation": "tanh",
                          "recurrent_activation": "sigmoid",
                          "return_sequences": True,
                          "batch_input_shape": [None, T, F]}}]}
    path = str(tmp_path / "lstm.h5")
    _write_keras_file(path, mc, {"lstm": {
        "lstm/kernel:0": kernel, "lstm/recurrent_kernel:0": rker,
        "lstm/bias:0": bias}})
    x = rng.normal(size=(B, T, F)).astype(np.float32)

    def sig(v):
        return 1 / (1 + np.exp(-v))
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    outs = []
    for t in range(T):        # Keras gate order i, f, c, o
        zi, zf, zg, zo = np.split(x[:, t] @ kernel + h @ rker + bias, 4,
                                  axis=-1)
        c = sig(zf) * c + sig(zi) * np.tanh(zg)
        h = sig(zo) * np.tanh(c)
        outs.append(h)
    return path, x, np.stack(outs, axis=1), 1e-4


def _functional_add_case(tmp_path):
    rng = np.random.default_rng(3)
    w1 = rng.normal(size=(4, 6)).astype(np.float32)
    w2 = rng.normal(size=(4, 6)).astype(np.float32)
    wo = rng.normal(size=(6, 2)).astype(np.float32)
    z6, z2 = np.zeros(6, np.float32), np.zeros(2, np.float32)
    mc = {"class_name": "Model", "keras_version": "2.1.0",
          "backend": "tensorflow", "config": {
              "name": "model_1",
              "layers": [
                  {"class_name": "InputLayer", "name": "input_1",
                   "config": {"name": "input_1",
                              "batch_input_shape": [None, 4]},
                   "inbound_nodes": []},
                  {"class_name": "Dense", "name": "branch_a",
                   "config": {"name": "branch_a", "units": 6,
                              "activation": "tanh"},
                   "inbound_nodes": [[["input_1", 0, 0, {}]]]},
                  {"class_name": "Dense", "name": "branch_b",
                   "config": {"name": "branch_b", "units": 6,
                              "activation": "tanh"},
                   "inbound_nodes": [[["input_1", 0, 0, {}]]]},
                  {"class_name": "Add", "name": "add_1",
                   "config": {"name": "add_1"},
                   "inbound_nodes": [[["branch_a", 0, 0, {}],
                                      ["branch_b", 0, 0, {}]]]},
                  {"class_name": "Dense", "name": "out",
                   "config": {"name": "out", "units": 2,
                              "activation": "softmax"},
                   "inbound_nodes": [[["add_1", 0, 0, {}]]]}],
              "input_layers": [["input_1", 0, 0]],
              "output_layers": [["out", 0, 0]]}}
    path = str(tmp_path / "func.h5")
    _write_keras_file(path, mc, {
        "branch_a": {"branch_a/kernel:0": w1, "branch_a/bias:0": z6},
        "branch_b": {"branch_b/kernel:0": w2, "branch_b/bias:0": z6},
        "out": {"out/kernel:0": wo, "out/bias:0": z2}})
    x = rng.normal(size=(3, 4)).astype(np.float32)
    return path, x, _softmax((np.tanh(x @ w1) + np.tanh(x @ w2)) @ wo), 1e-5


def _keras1_th_case(tmp_path):
    """Keras-1 config names and a Theano OIHW kernel, permuted to HWIO."""
    rng = np.random.default_rng(4)
    k_oihw = rng.normal(size=(4, 2, 3, 3), scale=0.5).astype(np.float32)
    mc = {"class_name": "Sequential", "keras_version": "1.2.2",
          "backend": "theano", "config": [
              {"class_name": "Convolution2D",
               "config": {"name": "conv1", "nb_filter": 4, "nb_row": 3,
                          "nb_col": 3, "subsample": [1, 1],
                          "border_mode": "valid", "dim_ordering": "th",
                          "activation": "linear",
                          "batch_input_shape": [None, 2, 6, 6]}}]}
    path = str(tmp_path / "k1conv.h5")
    _write_keras_file(path, mc, {"conv1": {
        "conv1/kernel:0": k_oihw, "conv1/bias:0": np.zeros(4, np.float32)}})
    x = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)
    w = np.transpose(k_oihw, (2, 3, 1, 0))
    want = np.zeros((2, 4, 4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            want[:, i, j, :] = np.tensordot(x[:, i:i + 3, j:j + 3, :], w,
                                            axes=([1, 2, 3], [0, 1, 2]))
    return path, x, want, 1e-4


BUILTIN = {"dense": _dense_case, "conv": _conv_case, "lstm": _lstm_case,
           "functional_add": _functional_add_case,
           "keras1_th": _keras1_th_case}


@pytest.mark.parametrize("case", sorted(BUILTIN))
def test_builtin_case(tmp_path, case):
    path, x, want, tol = BUILTIN[case](tmp_path)
    jnet, tnet = _both(path)
    got = _outputs(jnet, tnet, x)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if case == "keras1_th":
        w = tnet.params["conv1"]["W"].numpy()
        assert w.shape == (3, 3, 2, 4)
    if case in ("dense", "conv", "lstm", "keras1_th"):
        importer = "import_keras_sequential_model_and_weights"
    else:
        importer = "import_keras_model_and_weights"
    net = getattr(tmi, importer)(path, device="cpu")
    np.testing.assert_array_equal(_np(net.output(x)), got)


def test_training_config_creates_output_layer_and_fits(tmp_path):
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "Dense",
         "config": {"name": "d", "units": 2, "activation": "softmax",
                    "batch_input_shape": [None, 3]}}]}
    path = str(tmp_path / "tc.h5")
    _write_keras_file(path, mc, {"d": {
        "d/kernel:0": np.eye(3, 2, dtype=np.float32),
        "d/bias:0": np.zeros(2, np.float32)}},
        training_config={"loss": "categorical_crossentropy"})
    jnet, tnet = _both(path, "import_keras_sequential_model_and_weights")
    assert isinstance(tnet.layers[-1], OutputLayer)
    assert tnet.layers[-1].loss_function == "mcxent"
    x = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.random.default_rng(1).integers(
        0, 2, 8)]
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_value,
                                   float(jnet.score_value), **TOL)
    for k in ("W", "b"):
        np.testing.assert_allclose(tnet.params["d"][k].numpy(),
                                   np.asarray(jnet.params["d"][k]), **TOL)


def test_functional_training_config_and_enforce(tmp_path):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 2)).astype(np.float32)
    mc = {"class_name": "Model", "config": {
        "name": "m",
        "layers": [
            {"class_name": "InputLayer", "name": "in",
             "config": {"name": "in", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "units": 2, "activation": "softmax"},
             "inbound_nodes": [[["in", 0, 0, {}]]]}],
        "input_layers": [["in", 0, 0]],
        "output_layers": [["out", 0, 0]]}}
    weights = {"out": {"out/kernel:0": w,
                       "out/bias:0": np.zeros(2, np.float32)}}
    path = str(tmp_path / "func_tc.h5")
    _write_keras_file(path, mc, weights,
                      training_config={"loss": "categorical_crossentropy"})
    jnet, tnet = _both(path, "import_keras_model_and_weights")
    assert isinstance(tnet.conf.vertices["out"].vertex, OutputLayer)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    jnet.fit([x], [y])
    tnet.fit([x], [y])
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               **TOL)
    path2 = str(tmp_path / "func_notc.h5")
    _write_keras_file(path2, mc, weights)
    for mod in (jmi, tmi):
        with pytest.raises(mod.InvalidKerasConfigurationException):
            kw = {"device": "cpu"} if mod is tmi else {}
            mod.import_keras_model_and_weights(
                path2, enforce_training_config=True, **kw)
    with pytest.raises(tmi.InvalidKerasConfigurationException,
                       match="Sequential"):
        tmi.import_keras_model_and_weights(
            os.path.join(FIXDIR, "real_mlp.h5"), device="cpu")


def test_config_only_json_roundtrip():
    conf = ttm.vgg16(num_classes=10, height=32, width=32)
    names = [layer.name for layer in conf.layers]
    assert names[0] == "block1_conv1" and names[-1] == "predictions"
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "Dense",
         "config": {"name": "a", "units": 4, "activation": "relu",
                    "batch_input_shape": [None, 7]}},
        {"class_name": "Dropout", "config": {"name": "dr", "rate": 0.3}},
        {"class_name": "Dense",
         "config": {"name": "b", "units": 2, "activation": "softmax"}}]}
    conf2 = tmi.import_keras_model_configuration(json.dumps(mc))
    assert isinstance(conf2, MultiLayerConfiguration)
    assert len(conf2.layers) == 3
    assert json.loads(conf2.to_json()) == json.loads(
        jmi.import_keras_model_configuration(json.dumps(mc)).to_json())


def test_vgg16_builds_and_infers_shapes():
    conf = ttm.vgg16(num_classes=10, height=64, width=64, dtype="float32")
    conf.resolve_shapes()
    assert len(conf.layers) >= 21        # 13 convs, 5 pools, 2 fc, output
    fc1 = [layer for layer in conf.layers if layer.name == "fc1"][0]
    assert fc1.n_in == 2 * 2 * 512       # 64 / 2^5 = 2


def test_resnet50_builds_and_runs_forward():
    """No preprocessor anywhere; runs forward at 32 x 32."""
    conf = ttm.resnet50(num_classes=10, height=32, width=32,
                        dtype="float32")
    assert json.loads(conf.to_json()) == json.loads(jtm.resnet50(
        num_classes=10, height=32, width=32, dtype="float32").to_json())
    graph = TGraph(conf, device="cpu").init(seed=0)
    assert graph._preprocessors == {}
    out = graph.output(np.zeros((2, 32, 32, 3), np.float32))[0]
    assert tuple(out.shape) == (2, 10)
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, rtol=1e-4)


# --------------------------------------------------------------------------
# the real tf_keras fixtures (tests/test_keras_real_fixtures.py)
# --------------------------------------------------------------------------

# name -> (importer, input feed, rtol, atol) as the JAX tests hold them
REAL = {
    "real_mlp": ("import_keras_sequential_model_and_weights", "x",
                 1e-4, 1e-5),
    "real_cnn": ("import_keras_sequential_model_and_weights", "x",
                 1e-4, 1e-5),
    "real_cnn_chfirst": ("import_keras_sequential_model_and_weights",
                         "nhwc", 1e-4, 1e-5),
    "real_lstm": ("import_keras_sequential_model_and_weights", "x",
                  1e-4, 1e-4),
    "real_functional": ("import_keras_model_and_weights", "two", 1e-4, 1e-5),
    "real_keras1_th": ("import_keras_sequential_model_and_weights", "nhwc",
                       1e-4, 1e-5),
    "real_resnet_residual": ("import_keras_model_and_weights", "img",
                             1e-4, 1e-5),
    "real_vgg16_trained": ("load_vgg16", "x", 1e-3, 1e-4),
}


def _feed(g, kind):
    if kind == "nhwc":
        return np.transpose(g["x"], (0, 2, 3, 1))
    if kind == "two":
        return {"in_a": g["xa"], "in_b": g["xb"]}
    if kind == "img":
        return {"img": g["x"]}
    return g["x"]


@pytest.mark.parametrize("name", sorted(REAL))
def test_real_fixture(name):
    importer, feed, rtol, atol = REAL[name]
    h5 = os.path.join(FIXDIR, f"{name}.h5")
    g = dict(np.load(os.path.join(FIXDIR, f"{name}_golden.npz")))
    if importer == "load_vgg16":
        jnet, tnet = jtm.load_vgg16(h5), ttm.load_vgg16(h5, device="cpu")
        _same_tree(_np(tnet.params), _np(jnet.params), "params")
    else:
        jnet, tnet = _both(h5, importer)
    x = _feed(g, feed)
    got = _outputs(jnet, tnet, x)
    np.testing.assert_allclose(got, g["y"], rtol=rtol, atol=atol)
    if name == "real_vgg16_trained":
        pred = got.argmax(1)
        np.testing.assert_array_equal(pred, g["y"].argmax(1))
        assert float((pred == g["labels"]).mean()) >= 0.8
    if name == "real_lstm":
        # the same output with the LSTM stack off the wavefront (the
        # path that launches lstm_scan on the card)
        tnet.lstm_wavefront = False
        np.testing.assert_allclose(_np(tnet.output(x)), got, **TOL)

"""Port parity: the Keras gateway server (`deeplearning4j_tpu_torch.
keras_server`) and ModelGuesser (`deeplearning4j_tpu_torch.util.
model_guesser`) vs the JAX package's.

- The HTTP round trip of tests/test_serving.py on the port's
  `KerasServer(device="cpu")`: /health, /predict on real_mlp.h5 and
  real_cnn.h5 equal to the imported network's direct `output`, and a
  2-epoch /fit on real_mlp.h5 whose scores equal JAX's entry point's
  within 1e-5; an unknown path is a 404, a bad request a 500 with the
  error.
- ModelGuesser (tests/test_serialization.py): a saved MultiLayerNetwork
  and a saved ComputationGraph restore as networks with their outputs,
  raw and zipped configuration JSON become configurations, and a zip the
  JAX package wrote is guessed and restored by the port.
"""
import json
import os
import shutil
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu import MultiLayerNetwork as JNet  # noqa: E402
from deeplearning4j_tpu.keras_server import (  # noqa: E402
    DeepLearning4jEntryPoint as JEntryPoint)
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.layers import (  # noqa: E402
    DenseLayer as JDense, OutputLayer as JOutput)
from deeplearning4j_tpu.util import write_model as jwrite  # noqa: E402

from deeplearning4j_tpu_torch.keras_server import (  # noqa: E402
    DeepLearning4jEntryPoint, KerasServer)
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    import_keras_model_auto)
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    ComputationGraphConfiguration, MultiLayerConfiguration,
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: E402
    DenseLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork)
from deeplearning4j_tpu_torch.util import (ModelGuesser,  # noqa: E402
                                           write_model)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")


@pytest.fixture()
def models(tmp_path):
    out = {}
    for name in ("real_mlp", "real_cnn"):
        out[name] = str(tmp_path / f"{name}.h5")
        shutil.copy(os.path.join(FIXDIR, f"{name}.h5"), out[name])
    return out


def _post(server, path, payload):
    req = urllib.request.Request(
        server.url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_keras_server_http_roundtrip(tmp_path, models):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 32)]
    mlp_data = str(tmp_path / "mlp.npz")
    np.savez(mlp_data, features=x, labels=y)
    cnn_x = np.load(os.path.join(FIXDIR, "real_cnn_golden.npz"))["x"]
    cnn_data = str(tmp_path / "cnn.npz")
    np.savez(cnn_data, features=cnn_x)

    server = KerasServer(port=0, device="cpu")
    try:
        with urllib.request.urlopen(server.url + "/health",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        for name, data, feats in (("real_mlp", mlp_data, x),
                                  ("real_cnn", cnn_data, cnn_x)):
            res = _post(server, "/predict", {"model_path": models[name],
                                             "data_path": data})
            got = np.load(res["output_path"])
            direct = import_keras_model_auto(models[name], device="cpu")
            np.testing.assert_array_equal(got,
                                          direct.output(feats).numpy())
        res = _post(server, "/fit", {"model_path": models["real_mlp"],
                                     "data_path": mlp_data, "epochs": 2,
                                     "batch_size": 16})
        want = JEntryPoint().fit(models["real_mlp"], mlp_data, epochs=2,
                                 batch_size=16)
        assert len(res["scores"]) == 2
        np.testing.assert_allclose(res["scores"], want["scores"],
                                   rtol=1e-5, atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/nope", {})
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/predict", {"model_path": models["real_mlp"]})
        assert e.value.code == 500
        assert "data_path" in json.loads(e.value.read())["error"]
    finally:
        server.stop()


def test_entry_point_caches_one_network_per_model(tmp_path, models):
    ep = DeepLearning4jEntryPoint(device="cpu")
    a, lock_a = ep._load(models["real_mlp"])
    b, lock_b = ep._load(models["real_mlp"])
    assert a is b and lock_a is lock_b
    assert a.device.type == "cpu"


def _mln():
    conf = (NeuralNetConfiguration(seed=42, updater="adam",
                                   learning_rate=0.05)
            .list(DenseLayer(n_in=4, n_out=8, activation="tanh"),
                  OutputLayer(n_out=3, activation="softmax",
                              loss_function="mcxent")))
    return MultiLayerNetwork(conf, device="cpu").init()


def test_model_guesser_network_and_config(tmp_path):
    net = _mln()
    x = np.random.default_rng(0).random((5, 4)).astype(np.float32)
    path = str(tmp_path / "model.zip")
    write_model(net, path)
    loaded = ModelGuesser.load_model_guess(path, device="cpu")
    assert isinstance(loaded, MultiLayerNetwork)
    np.testing.assert_array_equal(loaded.output(x).numpy(),
                                  net.output(x).numpy())
    cfg_path = tmp_path / "conf.json"
    cfg_path.write_text(net.conf.to_json())
    conf = ModelGuesser.load_config_guess(str(cfg_path))
    assert isinstance(conf, MultiLayerConfiguration)
    assert isinstance(ModelGuesser.load_model_guess(str(cfg_path)),
                      MultiLayerConfiguration)
    zipped = str(tmp_path / "conf.zip")
    with zipfile.ZipFile(zipped, "w") as zf:
        zf.writestr("configuration.json", net.conf.to_json())
    assert isinstance(ModelGuesser.load_config_guess(zipped),
                      MultiLayerConfiguration)


def test_model_guesser_graph(tmp_path):
    conf = (NeuralNetConfiguration(seed=3).graph_builder()
            .add_inputs("in")
            .set_input_types(**{"in": InputType.feed_forward(4)})
            .add_layer("h", DenseLayer(n_out=6, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=2, activation="softmax",
                                          loss_function="mcxent"), "h")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device="cpu").init()
    path = str(tmp_path / "graph.zip")
    write_model(g, path)
    loaded = ModelGuesser.load_model_guess(path, device="cpu")
    assert isinstance(loaded, ComputationGraph)
    x = np.ones((3, 4), np.float32)
    np.testing.assert_array_equal(loaded.output(x)[0].numpy(),
                                  g.output(x)[0].numpy())
    cfg = tmp_path / "graph.json"
    cfg.write_text(conf.to_json())
    assert isinstance(ModelGuesser.load_config_guess(str(cfg)),
                      ComputationGraphConfiguration)


def test_model_guesser_reads_a_jax_written_zip(tmp_path):
    jconf = (JConf(seed=42, updater="adam", learning_rate=0.05)
             .list(JDense(n_in=4, n_out=8, activation="tanh"),
                   JOutput(n_out=3, activation="softmax",
                           loss_function="mcxent")))
    jnet = JNet(jconf).init()
    path = str(tmp_path / "jax.zip")
    jwrite(jnet, path)
    loaded = ModelGuesser.load_model_guess(path, device="cpu")
    assert isinstance(loaded, MultiLayerNetwork)
    x = np.random.default_rng(1).random((5, 4)).astype(np.float32)
    np.testing.assert_allclose(loaded.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=1e-5,
                               atol=1e-5)

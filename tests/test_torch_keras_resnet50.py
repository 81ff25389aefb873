"""Full-width Keras import: tf_keras's ResNet-50 (224 x 224 x 3, 1000
classes, 177 layers, 25,636,712 parameters) through the port on the CPU.

tf_keras runs in a subprocess (TensorFlow is never loaded into the test
process, which holds torch and jax): it builds the model, sets every
BatchNormalization's moving statistics to seeded values (means near 0,
variances in [0.5, 1.5], so that inference BN is not the identity),
saves the .h5 (~103 MB) into tmp_path and writes Keras's own `predict`
of a seeded B=2 batch beside it.

- The port's HDF5 reader against h5py on every group, attribute and
  dataset of that file (bit-equal bytes).
- `import_keras_model_and_weights(..., device="cpu")` against Keras's
  `predict` within rtol 1e-4 / atol 1e-5, with the argmax equal; the
  import inserts no preprocessor.
- The checked-in tests/fixtures/torch_keras_resnet50_224.json (the card's
  full-width configuration, written by
  tests/fixtures/generate_torch_keras_resnet50_json.py) equals the
  `model_config` of the file tf_keras writes now, after `json.loads`, and
  `import_keras_model_configuration` of it builds the same graph
  configuration as the HDF5 import.

Skips where tf_keras is not installed.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    Hdf5Archive, import_keras_model_and_weights,
    import_keras_model_configuration)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_JSON = os.path.join(ROOT, "tests", "fixtures",
                           "torch_keras_resnet50_224.json")

CHILD = r"""
import os, sys
os.environ["TF_CPP_MIN_LOG_LEVEL"] = "3"
os.environ["CUDA_VISIBLE_DEVICES"] = ""
import numpy as np
import tf_keras as keras
out = sys.argv[1]
m = keras.applications.ResNet50(weights=None, input_shape=(224, 224, 3),
                                classes=1000)
rng = np.random.default_rng(0)
for layer in m.layers:
    if isinstance(layer, keras.layers.BatchNormalization):
        g, b, mean, var = layer.get_weights()
        layer.set_weights([
            g, b, rng.normal(0.0, 0.1, mean.shape).astype(np.float32),
            rng.uniform(0.5, 1.5, var.shape).astype(np.float32)])
m.save(os.path.join(out, "resnet50.h5"), save_format="h5")
x = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
y = m.predict(x, verbose=0)
np.savez(os.path.join(out, "golden.npz"), x=x, y=y,
         input_name=m.layers[0].name, params=m.count_params())
"""


@pytest.fixture(scope="module")
def keras_resnet50(tmp_path_factory):
    if importlib.util.find_spec("tf_keras") is None:
        pytest.skip("tf_keras is not installed")
    out = tmp_path_factory.mktemp("resnet50")
    env = dict(os.environ, OMP_NUM_THREADS="2", TF_NUM_INTRAOP_THREADS="2",
               TF_NUM_INTEROP_THREADS="1")
    run = subprocess.run([sys.executable, "-c", CHILD, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return str(out / "resnet50.h5"), dict(np.load(out / "golden.npz"))


def test_reader_equals_h5py_on_every_dataset(keras_resnet50):
    path, golden = keras_resnet50
    counts = [0, 0, 0]

    def walk(group, hgroup):
        assert list(group.keys()) == list(hgroup.keys())
        assert sorted(group.attrs.keys()) == sorted(hgroup.attrs.keys())
        for k in hgroup.attrs.keys():
            got, want = group.attrs[k], hgroup.attrs[k]
            assert type(got) is type(want)
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype
                assert list(got.ravel()) == list(want.ravel())
            else:
                assert got == want
            counts[2] += 1
        counts[0] += 1
        for k in hgroup.keys():
            if isinstance(hgroup[k], h5py.Group):
                walk(group[k], hgroup[k])
                continue
            got, want = group[k].read(), np.asarray(hgroup[k][()])
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k
            counts[1] += 1

    with Hdf5Archive(path) as archive, h5py.File(path, "r") as f:
        walk(archive.root, f)
        n_params = sum(int(np.prod(f[p].shape)) for p in _datasets(f))
    assert counts[1] == 320 and n_params == int(golden["params"])
    assert counts[0] > 178 and counts[2] > 178


def _datasets(f):
    out = []
    f.visititems(lambda n, o: out.append(n)
                 if isinstance(o, h5py.Dataset) else None)
    return out


def test_import_matches_keras_predict(keras_resnet50):
    path, golden = keras_resnet50
    net = import_keras_model_and_weights(path, device="cpu")
    assert net._preprocessors == {}
    n_state = sum(t.numel() for st in net.state.values()
                  for t in st.values())
    assert net.num_params() + n_state == int(golden["params"])
    out = net.output({str(golden["input_name"]): golden["x"]})[0].numpy()
    assert out.shape == (2, 1000)
    np.testing.assert_allclose(out, golden["y"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out.argmax(1), golden["y"].argmax(1))


def test_checked_in_config_equals_file(keras_resnet50):
    path, _ = keras_resnet50
    with open(CONFIG_JSON) as fh:
        checked_in = fh.read()
    with h5py.File(path, "r") as f:
        assert json.loads(checked_in) == json.loads(f.attrs["model_config"])
    conf = import_keras_model_configuration(CONFIG_JSON)
    net = import_keras_model_and_weights(path, device="cpu")
    assert json.loads(conf.to_json()) == json.loads(
        import_keras_model_configuration(checked_in).to_json())
    assert list(conf.vertices) == list(net.conf.vertices)
    assert conf.network_inputs == net.conf.network_inputs
    assert conf.network_outputs == net.conf.network_outputs

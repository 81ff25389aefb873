"""Port parity: the ImageNet label table and prediction decoding
(`deeplearning4j_tpu_torch.modelimport.labels`), the cases of
tests/test_imagenet_labels.py, fully offline on a synthetic class-index
file (the real JSON's schema, 6 classes), each result equal to the JAX
package's on the same inputs.

The port resolves the table from local sources only: with nothing local
it raises FileNotFoundError listing every path it tried, and never calls
`urllib.request.urlopen` (patched here to fail the test if it is).
"""
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import deeplearning4j_tpu.modelimport.labels as JL  # noqa: E402
import deeplearning4j_tpu_torch.modelimport.labels as TL  # noqa: E402

INDEX = {str(i): [f"n{i:08d}", name] for i, name in enumerate(
    ["tench", "goldfish", "great_white_shark", "tiger_shark",
     "hammerhead", "electric_ray"])}


def _reset(monkeypatch):
    for mod in (JL, TL):
        monkeypatch.setattr(mod.ImageNetLabels, "_labels", None)
        monkeypatch.setattr(mod.ImageNetLabels, "_wnids", None)
        monkeypatch.setattr(mod.ImageNetLabels, "_source", None)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the port must not open a URL")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)


@pytest.fixture()
def index_file(tmp_path, monkeypatch):
    p = tmp_path / "imagenet_class_index.json"
    p.write_text(json.dumps(INDEX))
    monkeypatch.delenv("DL4JTPU_IMAGENET_INDEX", raising=False)
    _reset(monkeypatch)
    yield str(p)
    for mod in (JL, TL):
        mod.ImageNetLabels._labels = None
        mod.ImageNetLabels._wnids = None
        mod.ImageNetLabels._source = None


def test_load_parses_keras_schema_in_index_order(index_file):
    labels = TL.ImageNetLabels.load(index_file)
    assert labels == JL.ImageNetLabels.load(index_file)
    assert labels[0] == "tench" and labels[5] == "electric_ray"
    assert TL.ImageNetLabels.get_label(1) == "goldfish"
    assert TL.ImageNetLabels.get_wnid(2) == "n00000002"


def test_env_var_resolution(index_file, monkeypatch):
    monkeypatch.setenv("DL4JTPU_IMAGENET_INDEX", index_file)
    assert TL.ImageNetLabels.load()[3] == "tiger_shark"


def test_explicit_missing_source_raises_not_falls_through(tmp_path,
                                                          monkeypatch):
    _reset(monkeypatch)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        TL.ImageNetLabels.load(str(tmp_path / "nope.json"))
    monkeypatch.setenv("DL4JTPU_IMAGENET_INDEX",
                       str(tmp_path / "unmounted.json"))
    with pytest.raises(FileNotFoundError, match="DL4JTPU"):
        TL.ImageNetLabels.load()


def test_nothing_local_lists_every_path_tried(tmp_path, monkeypatch):
    _reset(monkeypatch)
    monkeypatch.delenv("DL4JTPU_IMAGENET_INDEX", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    cache = str(tmp_path / ".dl4j_tpu")
    monkeypatch.setattr(TL, "_CACHE_DIR", cache)
    with pytest.raises(FileNotFoundError) as e:
        TL.ImageNetLabels.load()
    msg = str(e.value)
    for path in TL.ImageNetLabels._candidate_paths(None):
        assert repr(path) in msg, path
    assert str(tmp_path / ".keras" / "models") in msg
    assert TL.JSON_URL in msg and "DL4JTPU_IMAGENET_INDEX" in msg


def test_changed_env_var_invalidates_cached_table(index_file, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("DL4JTPU_IMAGENET_INDEX", index_file)
    assert TL.ImageNetLabels.load()[0] == "tench"
    other = tmp_path / "other_index.json"
    other.write_text(json.dumps(
        {str(i): [f"x{i:08d}", f"class_{i}"] for i in range(4)}))
    monkeypatch.setenv("DL4JTPU_IMAGENET_INDEX", str(other))
    assert TL.ImageNetLabels.load()[0] == "class_0"
    monkeypatch.delenv("DL4JTPU_IMAGENET_INDEX")
    # nothing explicit requested: the cached table still serves
    assert TL.ImageNetLabels.get_labels()[0] == "class_0"
    # an explicit path other than the cache's source re-parses
    assert TL.ImageNetLabels.load(index_file)[0] == "tench"


PREDS = np.array([[0.1, 0.6, 0.05, 0.05, 0.1, 0.1],
                  [0.7, 0.1, 0.05, 0.05, 0.05, 0.05]])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_predicted_classes_and_topk(index_file, as_tensor):
    TL.ImageNetLabels.load(index_file)
    JL.ImageNetLabels.load(index_file)
    preds = torch.from_numpy(PREDS) if as_tensor else PREDS
    got = TL.get_predicted_classes(preds)
    np.testing.assert_array_equal(got, [1, 0])
    np.testing.assert_array_equal(got, JL.get_predicted_classes(PREDS))
    picks = TL.top_k(preds, k=2)
    assert picks == JL.top_k(PREDS, k=2)
    assert picks[0][0] == (1, "goldfish", pytest.approx(0.6))
    assert picks[1][0][1] == "tench"
    assert TL.top_k(PREDS[0], k=1) == [[(1, "goldfish",
                                         pytest.approx(0.6))]]


def test_decode_predictions_reference_format(index_file):
    """'Predictions for batch [n] :' then tab-indented '%3f%, label'
    lines; the batch index only for multi-row inputs."""
    TL.ImageNetLabels.load(index_file)
    JL.ImageNetLabels.load(index_file)
    row = np.array([[0.0, 0.25, 0.75, 0.0, 0.0, 0.0]])
    one = TL.decode_predictions(row, top=2)
    assert one == JL.decode_predictions(row, top=2)
    assert one.startswith("Predictions for batch  :")
    lines = one.splitlines()
    assert lines[1] == "\t75.000000%, great_white_shark"
    assert lines[2] == "\t25.000000%, goldfish"
    two = TL.decode_predictions(torch.eye(6)[:2], top=1)
    assert two == JL.decode_predictions(np.eye(6)[:2], top=1)
    assert "Predictions for batch 0 :" in two
    assert "\t100.000000%, tench" in two

"""Port parity: evaluation and the dataset iterators vs the JAX package.

- Evaluation (with top-3 and masked sequence outputs), ROC, ROCMultiClass
  and RegressionEvaluation fed the same arrays in both packages (numpy
  in, and the port's also torch tensors): every statistic equal (the
  counts exactly, the derived floats within 1e-12) and the `stats()` text
  equal character for character; the HTML export equal.
- `_synthetic_mnist` and the iterators: the same arrays from the same
  seed, bit for bit, and the same batch order (MNIST, CIFAR, Curves,
  list / existing / multiple-epochs / sampling / moving-window
  iterators, the preprocessors).
- A trained network's `evaluate`, `evaluate_batched`, `f1_score`,
  `predict`, `score_examples` and `num_labels` against JAX's (one set of
  weights, float32: counts exactly, scores within 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.datasets import impl as jimpl  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.eval import evaluation as jev  # noqa: E402
from deeplearning4j_tpu.eval import regression as jreg  # noqa: E402
from deeplearning4j_tpu.eval import roc as jroc  # noqa: E402
from deeplearning4j_tpu.eval import tools as jtools  # noqa: E402
from deeplearning4j_tpu.eval.meta import RecordMetaData  # noqa: E402
from deeplearning4j_tpu.models import zoo as jzoo  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)

from deeplearning4j_tpu_torch.datasets import impl as timpl  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as tit  # noqa
from deeplearning4j_tpu_torch.eval import evaluation as tev  # noqa: E402
from deeplearning4j_tpu_torch.eval import regression as treg  # noqa: E402
from deeplearning4j_tpu_torch.eval import roc as troc  # noqa: E402
from deeplearning4j_tpu_torch.eval import tools as ttools  # noqa: E402
from deeplearning4j_tpu_torch.models import zoo as tzoo  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)


@pytest.fixture(autouse=True)
def no_mnist_fetch(monkeypatch):
    """JAX's MNIST iterator fetches what its cache lacks; here both
    packages make the synthetic set and nothing is fetched."""
    monkeypatch.setattr(jimpl, "_try_download", lambda name: None)


def _probs(rng, shape):
    z = rng.normal(size=shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_evaluation_matches_jax(as_tensor):
    rng = np.random.default_rng(0)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    names = ["cat", "dog", "bird", "fish", "horse"]
    j, t = jev.Evaluation(labels=names, top_n=3), \
        tev.Evaluation(labels=names, top_n=3)
    meta = [RecordMetaData(index=i, uri="mem") for i in range(12)]
    for b in range(3):
        lab = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 12)]
        pr = _probs(rng, (12, 5))
        j.eval(lab, pr, metadata=meta if b == 0 else None)
        t.eval(conv(lab), conv(pr), metadata=meta if b == 0 else None)
    # sequence outputs [B, T, C] with a mask
    lab = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 6))]
    pr = _probs(rng, (4, 6, 5))
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    j.eval_time_series(lab, pr, mask)
    t.eval_time_series(conv(lab), conv(pr), conv(mask))
    np.testing.assert_array_equal(t.confusion.matrix, j.confusion.matrix)
    assert t.stats() == j.stats()
    for m in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert getattr(t, m)() == pytest.approx(getattr(j, m)(), abs=1e-12)
    for c in range(5):
        for m in ("precision", "recall", "f1", "true_positives",
                  "false_positives", "false_negatives", "true_negatives"):
            assert getattr(t, m)(c) == pytest.approx(getattr(j, m)(c),
                                                     abs=1e-12)
    assert [(p.actual_class, p.predicted_class, p.record_meta_data.index)
            for p in t.get_prediction_errors()] == \
        [(p.actual_class, p.predicted_class, p.record_meta_data.index)
         for p in j.get_prediction_errors()]
    # merge and the HTML report
    j2, t2 = jev.Evaluation(), tev.Evaluation()
    j2.merge(j)
    t2.merge(t)
    np.testing.assert_array_equal(t2.confusion.matrix, j2.confusion.matrix)
    assert ttools.evaluation_report_html(t) == \
        jtools.evaluation_report_html(j)
    # class-index labels
    j3, t3 = jev.Evaluation(num_classes=5), tev.Evaluation(num_classes=5)
    idx = rng.integers(0, 5, 9)
    pr = _probs(rng, (9, 5))
    j3.eval(idx, pr)
    t3.eval(conv(idx), conv(pr))
    np.testing.assert_array_equal(t3.confusion.matrix, j3.confusion.matrix)


def test_roc_matches_jax():
    rng = np.random.default_rng(1)
    j, t = jroc.ROC(20), troc.ROC(20)
    jm, tm = jroc.ROCMultiClass(10), troc.ROCMultiClass(10)
    for _ in range(3):
        lab = rng.integers(0, 2, 30).astype(np.float32)
        pr = np.clip(lab * 0.3 + rng.random(30) * 0.7, 0, 1).astype(
            np.float32)
        mask = (rng.random(30) > 0.2).astype(np.float32)
        j.eval(lab, pr, mask)
        t.eval(torch.from_numpy(lab), torch.from_numpy(pr), mask)
        onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 25)]
        p4 = _probs(rng, (25, 4))
        jm.eval(onehot, p4)
        tm.eval(torch.from_numpy(onehot), torch.from_numpy(p4))
    # [N, 2] softmax outputs
    lab2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    p2 = _probs(rng, (16, 2))
    j.eval(lab2, p2)
    t.eval(lab2, torch.from_numpy(p2))
    for a in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a))
    assert t.calculate_auc() == pytest.approx(j.calculate_auc(), abs=1e-12)
    for a, b in zip(t.get_roc_curve() + t.get_precision_recall_curve(),
                    j.get_roc_curve() + j.get_precision_recall_curve()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for c in range(4):
        assert tm.calculate_auc(c) == pytest.approx(jm.calculate_auc(c),
                                                    abs=1e-12)
    assert tm.calculate_average_auc() == pytest.approx(
        jm.calculate_average_auc(), abs=1e-12)
    assert ttools.roc_chart_html(t) == jtools.roc_chart_html(j)


def test_regression_evaluation_matches_jax():
    rng = np.random.default_rng(2)
    j = jreg.RegressionEvaluation(["a", "b", "c"])
    t = treg.RegressionEvaluation(["a", "b", "c"])
    for _ in range(3):
        lab = rng.normal(size=(10, 3)).astype(np.float32)
        pr = (lab + 0.3 * rng.normal(size=(10, 3))).astype(np.float32)
        j.eval(lab, pr)
        t.eval(torch.from_numpy(lab), torch.from_numpy(pr))
    lab = rng.normal(size=(2, 5, 3)).astype(np.float32)
    pr = rng.normal(size=(2, 5, 3)).astype(np.float32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    j.eval(lab, pr, mask)
    t.eval(lab, torch.from_numpy(pr), torch.from_numpy(mask))
    assert t.n == j.n
    assert t.stats() == j.stats()
    for c in range(3):
        for m in ("mean_squared_error", "mean_absolute_error",
                  "root_mean_squared_error", "relative_squared_error",
                  "r_squared", "pearson_correlation"):
            assert getattr(t, m)(c) == pytest.approx(getattr(j, m)(c),
                                                     abs=1e-12)
    assert t.average_r_squared() == pytest.approx(j.average_r_squared(),
                                                  abs=1e-12)


@pytest.mark.parametrize("seed", [42, 43, 7])
def test_synthetic_mnist_equals_jax(seed):
    ji, jl_ = jimpl._synthetic_mnist(50, seed)
    ti, tl_ = timpl._synthetic_mnist(50, seed)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl_, jl_)


def _batches(it):
    return [(np.asarray(b.features), np.asarray(b.labels)) for b in it]


def _same_batches(a, b):
    assert len(a) == len(b) and len(a) > 0
    for (fa, la), (fb, lb) in zip(a, b):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("name,kw", [
    ("MnistDataSetIterator", dict(batch_size=32, num_examples=100)),
    ("MnistDataSetIterator", dict(batch_size=25, num_examples=50,
                                  train=False, shuffle=False)),
    ("CifarDataSetIterator", dict(batch_size=16, num_examples=40)),
    ("CurvesDataSetIterator", dict(batch_size=10, num_examples=30)),
    ("LFWDataSetIterator", dict(batch_size=8, num_examples=20, height=8,
                                width=8)),
], ids=["mnist_train", "mnist_test", "cifar", "curves", "lfw"])
def test_dataset_iterators_equal_jax(name, kw, tmp_path, monkeypatch):
    # an empty data directory: no cached files, the synthetic sets
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jimpl, "MNIST_CACHE", tmp_path / "mnist")
    monkeypatch.setattr(timpl, "MNIST_CACHE", tmp_path / "mnist")
    monkeypatch.setattr(jimpl, "_try_download", lambda n: None)
    j, t = getattr(jimpl, name)(**kw), getattr(timpl, name)(**kw)
    _same_batches(_batches(t), _batches(j))
    _same_batches(_batches(t), _batches(j))       # after a reset
    assert t.num_examples() == j.num_examples()
    assert t.input_columns() == j.input_columns()
    assert t.total_outcomes() == j.total_outcomes()


def test_mnist_reads_cached_idx_files(tmp_path, monkeypatch):
    import struct
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (12, 28, 28), dtype=np.uint8)
    labs = rng.integers(0, 10, 12).astype(np.uint8)
    d = tmp_path / "mnist"
    d.mkdir()
    (d / "train_images.idx").write_bytes(
        struct.pack(">IIII", 0x803, 12, 28, 28) + imgs.tobytes())
    (d / "train_labels.idx").write_bytes(
        struct.pack(">II", 0x801, 12) + labs.tobytes())
    monkeypatch.setattr(timpl, "MNIST_CACHE", d)
    it = timpl.MnistDataSetIterator(4, shuffle=False)
    assert not it.synthetic
    np.testing.assert_array_equal(it.features,
                                  imgs.reshape(12, -1) / np.float32(255))
    np.testing.assert_array_equal(it.labels.argmax(1), labs)


def test_iterator_wrappers_equal_jax():
    rng = np.random.default_rng(4)
    f = rng.normal(size=(20, 4, 4, 1)).astype(np.float32)
    lab = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    jd, td = jit_.DataSet(f, lab), tit.DataSet(f, lab)
    pairs = [
        (jit_.ListDataSetIterator([jd, jd], 7),
         tit.ListDataSetIterator([td, td], 7)),
        (jit_.ExistingDataSetIterator([jd, jd]),
         tit.ExistingDataSetIterator([td, td])),
        (jit_.MultipleEpochsIterator(3, jit_.BaseDatasetIterator(f, lab, 6)),
         tit.MultipleEpochsIterator(3, tit.BaseDatasetIterator(f, lab, 6))),
        (jit_.SamplingDataSetIterator(jd, 5, 4),
         tit.SamplingDataSetIterator(td, 5, 4)),
        (jit_.MovingWindowDataSetIterator(jd, 8, 2, 2),
         tit.MovingWindowDataSetIterator(td, 8, 2, 2)),
        (jit_.AsyncDataSetIterator(jit_.BaseDatasetIterator(f, lab, 9)),
         tit.AsyncDataSetIterator(tit.BaseDatasetIterator(f, lab, 9))),
        (jit_.TestDataSetIterator(jd, 6), tit.TestDataSetIterator(td, 6)),
        (jit_.AbstractDataSetIterator(zip(f, lab), 8),
         tit.AbstractDataSetIterator(zip(f, lab), 8)),
    ]
    for j, t in pairs:
        _same_batches(_batches(t), _batches(j))
    jd.shuffle(5)
    td.shuffle(5)
    np.testing.assert_array_equal(td.features, jd.features)
    for pj, pt in ((jit_.ZeroMeanPreProcessor(), tit.ZeroMeanPreProcessor()),
                   (jit_.UnitVarianceProcessor(),
                    tit.UnitVarianceProcessor()),
                   (jit_.ZeroMeanAndUnitVariancePreProcessor(),
                    tit.ZeroMeanAndUnitVariancePreProcessor()),
                   (jit_.BinomialSamplingPreProcessor(3),
                    tit.BinomialSamplingPreProcessor(3)),
                   (jit_.CombinedPreProcessor(jit_.DummyPreProcessor(),
                                              jit_.ZeroMeanPreProcessor()),
                    tit.CombinedPreProcessor(tit.DummyPreProcessor(),
                                             tit.ZeroMeanPreProcessor()))):
        np.testing.assert_array_equal(pt.pre_process(td).features,
                                      pj.pre_process(jd).features)


def test_network_evaluation_surface_matches_jax():
    jnet = JNet(jzoo.mlp_mnist(hidden=16)).init()
    tnet = TNet(tzoo.mlp_mnist(hidden=16), device="cpu").init()
    tnet.set_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jnet.params))
    it_j = jimpl.MnistDataSetIterator(20, num_examples=60)
    it_t = timpl.MnistDataSetIterator(20, num_examples=60)
    jnet.fit(it_j)
    tnet.fit(it_t)
    ej, et = jnet.evaluate(it_j), tnet.evaluate(it_t)
    np.testing.assert_array_equal(et.confusion.matrix, ej.confusion.matrix)
    assert et.stats() == ej.stats()
    xs = it_t.features.reshape(3, 20, -1)
    ys = it_t.labels.reshape(3, 20, -1)
    np.testing.assert_array_equal(tnet.evaluate_batched(xs, ys)
                                  .confusion.matrix,
                                  jnet.evaluate_batched(xs, ys)
                                  .confusion.matrix)
    x, y = xs[0], ys[0]
    np.testing.assert_array_equal(tnet.predict(x), jnet.predict(x))
    assert tnet.f1_score(x, y) == pytest.approx(jnet.f1_score(x, y),
                                                abs=1e-12)
    np.testing.assert_allclose(tnet.score_examples(x, y),
                               np.asarray(jnet.score_examples(x, y)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tnet.score_examples(x, y, add_regularization_terms=False),
        np.asarray(jnet.score_examples(x, y, False)), rtol=1e-5, atol=1e-5)
    assert tnet.num_labels() == jnet.num_labels() == 10
    rj, rt = jnet.evaluate_roc_multi_class(it_j), \
        tnet.evaluate_roc_multi_class(it_t)
    assert rt.calculate_average_auc() == pytest.approx(
        rj.calculate_average_auc(), abs=1e-12)
    np.testing.assert_allclose(tnet.output_batched(xs).numpy(),
                               np.asarray(jnet.output_batched(xs)),
                               rtol=1e-5, atol=1e-5)
    fj = jnet.feed_forward_to_layer(0, x)
    ft = tnet.feed_forward_to_layer(0, x)
    assert len(ft) == len(fj) == 1
    np.testing.assert_allclose(ft[0].numpy(), np.asarray(fj[0]), rtol=1e-5,
                               atol=1e-5)
    assert tnet.summary() == jnet.summary()


def test_rnn_previous_state_surface_matches_jax():
    """rnn_time_step's carried state read back and set, as JAX's."""
    jnet = JNet(jzoo.char_rnn_lstm(6, hidden=5, layers=2)).init()
    tnet = TNet(tzoo.char_rnn_lstm(6, hidden=5, layers=2),
                device="cpu").init()
    tnet.set_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jnet.params))
    assert tnet.rnn_get_previous_state(0) is None
    x = np.eye(6, dtype=np.float32)[[1, 4, 2]]
    jnet.rnn_time_step(x)
    tnet.rnn_time_step(x)
    for layer in (0, 1):
        for a, b in zip(tnet.rnn_get_previous_state(layer),
                        jnet.rnn_get_previous_state(layer)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
    # a cleared network seeded with layer 1's state only
    st = tnet.rnn_get_previous_state(1)
    jst = jnet.rnn_get_previous_state(1)
    tnet.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    tnet.rnn_set_previous_state(1, st)
    jnet.rnn_set_previous_state(1, jst)
    np.testing.assert_allclose(tnet.rnn_time_step(x).numpy(),
                               np.asarray(jnet.rnn_time_step(x)), rtol=1e-5,
                               atol=1e-6)

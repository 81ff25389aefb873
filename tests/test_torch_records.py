"""Port parity: record readers, their DataSet iterators, MultiDataSet,
the MultiDataSet adapter and the LFW image tree vs the JAX package.

Both packages read the same files written under ``tmp_path`` (CSV,
CSV sequences with ragged lengths, ``.npy`` image trees) and every batch
must be equal, array for array (features, labels, masks). JAX's CSV
reader may take its native C++ parse; the port parses in Python by
JAX's own fallback, and the batches are the same. A ComputationGraph
then trains on a `RecordReaderMultiDataSetIterator` and on a
`MultiDataSetIteratorAdapter` in both packages (scores and params within
1e-5 + 1e-5 |jax|, float32). Nothing is fetched: the LFW iterator reads
a local tree under ``$DL4J_TPU_DATA_DIR/lfw``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu.datasets import impl as jimpl  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.datasets import records as jrec  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch.datasets import impl as timpl  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as tit  # noqa
from deeplearning4j_tpu_torch.datasets import records as trec  # noqa
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402
    ComputationGraph as TGraph)

TOL = dict(rtol=1e-5, atol=1e-5)


def _arr(a):
    return None if a is None else np.asarray(a)


def _batches_equal(tb, jb):
    tb, jb = list(tb), list(jb)
    assert len(tb) == len(jb) > 0
    for t, j in zip(tb, jb):
        for name in ("features", "labels", "features_mask", "labels_mask"):
            a, b = _arr(getattr(t, name, None)), _arr(getattr(j, name, None))
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _csv(tmp_path, rng, n=11, f=4, k=3, header=True, delim=","):
    p = tmp_path / f"data_{n}_{delim == ','}.csv"
    rows = ["a,b,c,d,label".replace(",", delim)] if header else []
    for _ in range(n):
        vals = [f"{v:.6g}" for v in rng.normal(size=f)]
        rows.append(delim.join(vals + [str(rng.integers(0, k))]))
    p.write_text("\n".join(rows) + "\n")
    return str(p)


@pytest.mark.parametrize("mode", ["classes", "regression", "label_first",
                                  "tab_no_header"])
def test_csv_record_reader_iterator_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(0)
    delim = "\t" if mode == "tab_no_header" else ","
    path = _csv(tmp_path, rng, header=delim == ",", delim=delim)
    skip = 1 if delim == "," else 0
    kw = dict(batch_size=4)
    if mode == "classes" or mode == "tab_no_header":
        kw.update(label_index=-1, num_classes=3)
    elif mode == "regression":
        kw.update(regression=True)
    else:
        kw.update(label_index=0, num_classes=None)
    its = [pkg.RecordReaderDataSetIterator(
        pkg.CSVRecordReader(path, skip_lines=skip, delimiter=delim), **kw)
        for pkg in (trec, jrec)]
    _batches_equal(*its)
    assert its[0].total_outcomes() == its[1].total_outcomes()
    assert its[0].num_examples() == its[1].num_examples() == 11


def test_collection_reader_matches_jax():
    recs = [[0.5, 1.5, 2.0, 1], [3.0, -1.0, 0.25, 0], [1.0, 1.0, 1.0, 2]]
    its = [pkg.RecordReaderDataSetIterator(
        pkg.CollectionRecordReader(recs), batch_size=2, num_classes=3)
        for pkg in (trec, jrec)]
    _batches_equal(*its)


def test_sequence_reader_masks_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for i, t in enumerate((5, 2, 7, 1, 4)):
        p = tmp_path / f"seq{i}.csv"
        p.write_text("".join(
            ",".join([f"{v:.5g}" for v in rng.normal(size=3)]
                     + [str(rng.integers(0, 2))]) + "\n"
            for _ in range(t)))
        paths.append(str(p))
    for kw in (dict(num_classes=2), dict(regression=True)):
        its = [pkg.SequenceRecordReaderDataSetIterator(
            pkg.CSVSequenceRecordReader(paths), batch_size=2, **kw)
            for pkg in (trec, jrec)]
        _batches_equal(*its)
    b = next(iter(its[0]))
    assert b.features.shape == (2, 7, 3)
    assert b.features_mask.tolist()[1] == [1, 1, 0, 0, 0, 0, 0]


def _image_tree(root, classes=("ann", "bob", "cy"), n=(3, 2, 4), h=5, w=6,
                c=3, seed=2):
    rng = np.random.default_rng(seed)
    for cls, k in zip(classes, n):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(k):
            np.save(d / f"img{i}.npy", rng.random((h, w, c),
                                                  dtype=np.float32))
    return str(root)


def test_image_record_reader_matches_jax(tmp_path):
    root = _image_tree(tmp_path / "imgs")
    readers = []
    for pkg in (trec, jrec):
        r = pkg.ImageRecordReader(5, 6, 3)
        r.initialize(root)
        readers.append(r)
    assert readers[0].labels == readers[1].labels == ["ann", "bob", "cy"]
    its = [pkg.RecordReaderDataSetIterator(r, batch_size=4, num_classes=3)
           for pkg, r in zip((trec, jrec), readers)]
    _batches_equal(*its)
    bad = trec.ImageRecordReader(5, 5, 3)
    bad.initialize(root)
    with pytest.raises(ValueError, match="has shape"):
        next(iter(bad.records()))
    (tmp_path / "imgs" / "ann" / "photo.jpg").write_bytes(b"\xff\xd8")
    r = trec.ImageRecordReader(5, 6, 3)
    r.initialize(root)
    try:
        import PIL  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="PIL"):
            list(r.records())


def test_lfw_reads_a_local_tree(tmp_path, monkeypatch):
    """LFW over $DL4J_TPU_DATA_DIR/lfw/<person>/*.npy in both packages;
    with no tree, both make the same synthetic classes."""
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    _image_tree(tmp_path / "lfw", classes=("a_person", "b_person"),
                n=(3, 5), h=8, w=8, c=3)
    its = [pkg.LFWDataSetIterator(batch_size=3, height=8, width=8)
           for pkg in (timpl, jimpl)]
    assert its[0].synthetic is its[1].synthetic is False
    _batches_equal(*its)
    assert its[0].total_outcomes() == 2
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path / "none"))
    its = [pkg.LFWDataSetIterator(batch_size=4, num_examples=8, height=8,
                                  width=8, num_classes=3)
           for pkg in (timpl, jimpl)]
    assert its[0].synthetic is True
    _batches_equal(*its)


def _multi_readers(pkg, rng_seed=3, n=10):
    rng = np.random.default_rng(rng_seed)
    a = [[*rng.normal(size=3).round(4), int(rng.integers(0, 2))]
         for _ in range(n)]
    b = [[*rng.normal(size=2).round(4), int(rng.integers(0, 3))]
         for _ in range(n + 2)]                        # longer: cut to n
    return (pkg.RecordReaderMultiDataSetIterator.Builder(batch_size=4)
            .add_reader("a", pkg.CollectionRecordReader(a))
            .add_reader("b", pkg.CollectionRecordReader(b))
            .add_input("a", 0, 2).add_input("b", 0, -1)
            .add_output_one_hot("a", 3, 2).add_output_one_hot("b", 2, 3)
            .build())


def _mds_equal(tm, jm):
    tm, jm = list(tm), list(jm)
    assert len(tm) == len(jm) == 3
    for t, j in zip(tm, jm):
        assert isinstance(t, trec.MultiDataSet)
        assert t.num_examples() == j.num_examples()
        for a, b in zip(t.features + t.labels, j.features + j.labels):
            np.testing.assert_array_equal(a, np.asarray(b))


def multi_graph(L, C):
    return (C(seed=2, updater="adam", learning_rate=0.02,
              activation="tanh")
            .graph_builder().add_inputs("x1", "x2")
            .add_layer("h1", L.DenseLayer(n_in=3, n_out=5), "x1")
            .add_layer("h2", L.DenseLayer(n_in=3, n_out=5), "x2")
            .add_layer("o1", L.OutputLayer(n_in=5, n_out=2,
                                           activation="softmax"), "h1")
            .add_layer("o2", L.OutputLayer(n_in=5, n_out=3,
                                           activation="softmax"), "h2")
            .set_outputs("o1", "o2").build())


def test_multi_dataset_iterator_trains_a_graph_like_jax():
    tm, jm = _multi_readers(trec), _multi_readers(jrec)
    _mds_equal(tm, jm)
    jg = JGraph(multi_graph(jl, JConf)).init()
    tg = TGraph(multi_graph(tl, TConf), device="cpu").init()
    tg.set_params_from_numpy(jax.tree_util.tree_map(np.asarray, jg.params))
    for _ in range(2):                  # fit resets the iterator after
        jg.fit(jm)
        tg.fit(tm)
        np.testing.assert_allclose(float(tg.score_value),
                                   float(jg.score_value), **TOL)
    assert tg.iteration_count == jg.iteration_count == 6
    assert tg.epoch_count == 2
    np.testing.assert_allclose(tg.params_flat().numpy(),
                               np.asarray(jg.params_flat()), **TOL)


def test_multi_dataset_adapter_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 10)]
    m = np.ones((10, 1), np.float32)
    ta = tit.MultiDataSetIteratorAdapter(
        tit.BaseDatasetIterator(x, y, 4, labels_mask=m))
    ja = jit_.MultiDataSetIteratorAdapter(
        jit_.BaseDatasetIterator(x, y, 4, labels_mask=m))
    tl_, jl_ = list(ta), list(ja)
    assert len(tl_) == len(jl_) == 3
    for t, j in zip(tl_, jl_):
        assert t.features_masks is None and j.features_masks is None
        for a, b in zip(t.features + t.labels + t.labels_masks,
                        j.features + j.labels + j.labels_masks):
            np.testing.assert_array_equal(a, b)
    ta.reset()
    assert len(list(ta)) == 3

    def one_in(L, C):
        return (C(seed=2, updater="sgd", learning_rate=0.1)
                .graph_builder().add_inputs("x")
                .add_layer("o", L.OutputLayer(n_in=3, n_out=2,
                                              activation="softmax"), "x")
                .set_outputs("o").build())
    jg = JGraph(one_in(jl, JConf)).init()
    tg = TGraph(one_in(tl, TConf), device="cpu").init()
    tg.set_params_from_numpy(jax.tree_util.tree_map(np.asarray, jg.params))
    jg.fit(ja)
    tg.fit(ta)
    np.testing.assert_allclose(tg.params_flat().numpy(),
                               np.asarray(jg.params_flat()), **TOL)
    ev_t = tg.evaluate(ta)
    ev_j = jg.evaluate(ja)
    assert ev_t.accuracy() == ev_j.accuracy()

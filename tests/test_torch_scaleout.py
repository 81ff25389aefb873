"""The port's scaleout facades and stats storage
(deeplearning4j_tpu_torch/scaleout/, ui/storage.py) against JAX's
(tests/test_scaleout.py, tests/test_ui.py:26-58).

The distributed cases run on four gloo CPU ranks, started once for the
module through `MultiHostLauncher`; the rank bodies are
`torch_parallel_helpers.scaleout_job`. Every network starts from the
weights of the JAX network it is compared with, and the global batches
are the reference test's (32 and 48 rows: 8 and 12 a rank). JAX's side
is its own sharded wrapper on the 8-device CPU mesh, whose equality with
single-machine training its suite holds: the port's four ranks give the
parameters of JAX's single machine within the reference test's 1e-5.
The facades on one process (no process group) are the plain network:
the Export approach (batch files, `fit(path)`) and the graph wrapper
run there. The phase stats, their HTML export, the stats router's
`drain_to` and the storage backends' round trips run in-process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    DataSet as JDataSet, ListDataSetIterator as JListIt)
from deeplearning4j_tpu.earlystopping.config import \
    EarlyStoppingConfiguration as JESConf  # noqa: E402
from deeplearning4j_tpu.earlystopping.scorecalc import \
    DataSetLossCalculator as JLossCalc  # noqa: E402
from deeplearning4j_tpu.earlystopping.termination import \
    MaxEpochsTerminationCondition as JMaxEpochs  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import \
    NeuralNetConfiguration as JConf  # noqa: E402
from deeplearning4j_tpu.nn.layers.feedforward import \
    DenseLayer as JDense  # noqa: E402
from deeplearning4j_tpu.nn.layers.output import \
    OutputLayer as JOut  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import \
    MultiLayerNetwork as JNet  # noqa: E402
from deeplearning4j_tpu.scaleout import (  # noqa: E402
    EarlyStoppingParallelTrainer as JESPT,
    ParameterAveragingTrainingMaster as JPATM,
    SparkDl4jMultiLayer as JSpark)
from deeplearning4j_tpu.scaleout import util as jutil  # noqa: E402
from deeplearning4j_tpu.scaleout.parallel_trainer import \
    SparkEarlyStoppingTrainer as JSparkES  # noqa: E402

from deeplearning4j_tpu_torch.parallel.multihost import \
    MultiHostLauncher  # noqa: E402
from deeplearning4j_tpu_torch.scaleout import (  # noqa: E402
    DistributedComputationGraph, ParameterAveragingTrainingMaster,
    SparkTrainingStats, VanillaStatsStorageRouter, timed_phase)
from deeplearning4j_tpu_torch.scaleout import util as tutil  # noqa: E402
from deeplearning4j_tpu_torch.ui import (  # noqa: E402
    FileStatsStorage, InMemoryStatsStorage, Persistable, SqliteStatsStorage)

import torch_parallel_helpers as H  # noqa: E402

W = 4
#: the reference test's tolerance (test_sharded_vs_single_machine)
TOL = dict(rtol=1e-5, atol=1e-6)


def _jnet(seed):
    conf = JConf(seed=seed, updater="sgd", learning_rate=0.1,
                 dropout=0.0).list(
        JDense(n_in=8, n_out=16, activation="tanh"),
        JOut(n_out=3, activation="softmax", loss_function="mcxent"))
    return JNet(conf).init()


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _flat(net):
    return np.asarray(net.params_flat(), np.float64)


@pytest.fixture(scope="module")
def data():
    x64, y64 = _data(64, 0)
    x96, y96 = _data(96, 3)
    x64e, y64e = _data(64, 5)
    return dict(x64=x64, y64=y64, x96=x96, y96=y96, x64e=x64e, y64e=y64e)


@pytest.fixture(scope="module")
def jax_ref(data, devices8):
    """JAX's runs of tests/test_scaleout.py's cases (8 workers on the
    CPU mesh), and the initial weights by seed."""
    init = {s: jax.tree_util.tree_map(np.array, _jnet(s).params)
            for s in (7, 1, 9, 2)}
    out = {}
    single = _jnet(7)
    for s in range(0, 64, 32):
        single.fit(data["x64"][s:s + 32], data["y64"][s:s + 32])
    out["sharded"] = _flat(single)

    x96, y96 = data["x96"], data["y96"]
    net = _jnet(1)
    tm = (JPATM.Builder(batch_size_per_worker=6).workers(8)
          .collect_training_stats(True).build())
    JSpark(net, tm).fit(JListIt([JDataSet(x96[i:i + 48], y96[i:i + 48])
                                 for i in (0, 48)], 48))
    out["iterator"] = (_flat(net), net.iteration_count)

    xe, ye = data["x64e"], data["y64e"]
    net = _jnet(9)
    cfg = JESConf(epoch_termination_conditions=[JMaxEpochs(3)],
                  score_calculator=None)
    res = JESPT(cfg, net, JListIt([JDataSet(xe, ye)], 32),
                workers=8).fit()
    out["es_parallel"] = (_flat(net), res.total_epochs, net.iteration_count)

    net = _jnet(2)
    eb = [JDataSet(xe[i:i + 32], ye[i:i + 32]) for i in (0, 32)]
    conf = JESConf(epoch_termination_conditions=[JMaxEpochs(3)],
                   score_calculator=JLossCalc(JListIt(eb, 32)))
    dist = JSpark(net, JPATM.Builder(batch_size_per_worker=4).workers(8)
                  .build())
    res = JSparkES(conf, dist, JListIt(eb, 32)).fit()
    out["es_spark"] = (_flat(net), dict(res.score_vs_epoch),
                       res.total_epochs)
    return init, out


@pytest.fixture(scope="module")
def ranks(data, jax_ref):
    init, _ = jax_ref
    return MultiHostLauncher(W, device="cpu").run(
        H.scaleout_job, timeout=300, args=(data, init, W))


def _params(rec):
    return rec["params"] if isinstance(rec, dict) else rec


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(_params(r[key]),
                                      _params(res[0][key]))


def test_sharded_vs_single_machine_equivalence(ranks, jax_ref):
    """Identical global batches → JAX's single-machine parameters."""
    _same_on_every_rank(ranks, "sharded")
    np.testing.assert_allclose(ranks[0]["sharded"], jax_ref[1]["sharded"],
                               **TOL)


def test_training_master_iterator_and_stats(ranks, jax_ref):
    want, iters = jax_ref[1]["iterator"]
    _same_on_every_rank(ranks, "iterator")
    rec = ranks[0]["iterator"]
    assert rec["workers"] == W and rec["iterations"] == iters == 2
    np.testing.assert_allclose(rec["params"], want, **TOL)
    assert "fit" in rec["keys"] and "split" in rec["keys"]
    assert rec["stats"]["fit"]["count"] == 2
    assert rec["stats"]["fit"]["total_ms"] > 0


def test_early_stopping_parallel_trainer(ranks, jax_ref):
    want, epochs, iters = jax_ref[1]["es_parallel"]
    _same_on_every_rank(ranks, "es_parallel")
    rec = ranks[0]["es_parallel"]
    assert rec["epochs"] == epochs >= 1
    assert rec["iterations"] == iters >= 3
    np.testing.assert_allclose(rec["params"], want, **TOL)


def test_spark_early_stopping_trainer(ranks, jax_ref):
    want, scores, epochs = jax_ref[1]["es_spark"]
    _same_on_every_rank(ranks, "es_spark")
    rec = ranks[0]["es_spark"]
    assert rec["epochs"] == epochs == 3 and rec["has_best"]
    assert sorted(rec["scores"]) == sorted(scores)
    for e, s in scores.items():
        assert abs(rec["scores"][e] - s) < 1e-5
    assert rec["best_score"] == min(rec["scores"].values())
    np.testing.assert_allclose(rec["params"], want, **TOL)


# ---------------------------------------------------------------------------
# one process: the plain network
# ---------------------------------------------------------------------------

def test_export_approach_and_fit_path(tmp_path):
    """Export minibatches to files and train from the path, on one
    process (no process group: the wrapper is the plain network), as
    JAX's Export test does on its mesh; the files are JAX's format."""
    from deeplearning4j_tpu.datasets.iterators import \
        BaseDatasetIterator as JBaseIt
    from deeplearning4j_tpu.scaleout.training_master import \
        DistributedDl4jMultiLayer as JDist
    from deeplearning4j_tpu_torch.datasets.iterators import \
        BaseDatasetIterator
    from deeplearning4j_tpu_torch.nn.conf.configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.training_master import \
        DistributedDl4jMultiLayer

    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    paths = tutil.export_dataset_batches(
        BaseDatasetIterator(x, y, batch_size=24), str(tmp_path / "t"))
    jpaths = jutil.export_dataset_batches(JBaseIt(x, y, batch_size=24),
                                          str(tmp_path / "j"))
    assert [p.rsplit("/", 1)[1] for p in paths] == \
        [p.rsplit("/", 1)[1] for p in jpaths]
    for a, b in zip(tutil.PathDataSetIterator(str(tmp_path / "t")),
                    jutil.PathDataSetIterator(str(tmp_path / "j"))):
        assert np.array_equal(a.features, b.features)
        assert np.array_equal(a.labels, b.labels)
    with pytest.raises(ValueError, match="no dataset files"):
        tutil.PathDataSetIterator(str(tmp_path / "none"))

    def conf(C, D, O):
        return (C(seed=1, updater="adam", learning_rate=0.05,
                  activation="tanh")
                .list(D(n_in=4, n_out=8),
                      O(n_in=8, n_out=2, activation="softmax",
                        loss_function="mcxent")))
    jnet = JNet(conf(JConf, JDense, JOut)).init()
    net = MultiLayerNetwork(conf(NeuralNetConfiguration, DenseLayer,
                                 OutputLayer), device="cpu").init()
    net.set_params_from_numpy(jax.tree_util.tree_map(np.array,
                                                     jnet.params))
    # one process: a global batch of 24, as JAX's 2 workers x 12
    sm = DistributedDl4jMultiLayer(
        net, ParameterAveragingTrainingMaster.Builder(24).build())
    jsm = JDist(jnet, JPATM.Builder(24).workers(1).build())
    assert sm.pw.workers == 1 and sm.get_network() is net
    for _ in range(5):
        sm.fit(str(tmp_path / "t"))
        jsm.fit(str(tmp_path / "j"))
    np.testing.assert_allclose(_flat(net), _flat(jnet), rtol=1e-4,
                               atol=1e-5)
    for _ in range(20):
        sm.fit(str(tmp_path / "t"))
    assert sm.evaluate(BaseDatasetIterator(x, y, 48)).accuracy() > 0.9


def test_distributed_computation_graph_is_the_graph():
    """The graph wrapper fits lists of inputs through the graph itself
    (the reference's), on one process equal to the graph's own fit."""
    from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
        ComputationGraph
    rng = np.random.default_rng(11)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    a = ComputationGraph(H.graph_conf(), device="cpu").init()
    b = ComputationGraph(H.graph_conf(), device="cpu").init()
    assert torch.equal(a.params_flat(), b.params_flat())
    tm = ParameterAveragingTrainingMaster.Builder(16).build()
    dg = DistributedComputationGraph(a, tm)
    dg.fit(x, y)
    for s in range(0, 64, 16):
        b.fit([x[s:s + 16]], [y[s:s + 16]])
    assert torch.equal(a.params_flat(), b.params_flat())


# ---------------------------------------------------------------------------
# stats, router, storage, data utilities
# ---------------------------------------------------------------------------

def test_stats_timed_phase_and_html(tmp_path):
    from deeplearning4j_tpu_torch.observability.metrics import \
        MetricsRegistry
    reg = MetricsRegistry()
    st = SparkTrainingStats(registry=reg)
    with timed_phase(st, "broadcast"):
        pass
    with timed_phase(st, "fit"):
        pass
    st.add_time("fit", 0.0, 0.002)
    assert set(st.get_keys()) == {"broadcast", "fit"}
    assert st.total_ms("fit") >= 2.0
    d = st.as_dict()
    assert d["fit"]["count"] == 2 and d["fit"]["max_ms"] >= 2.0
    fam = reg.get("scaleout_phase_seconds")
    assert fam is not None
    html = tmp_path / "stats.html"
    st.export_stats_html(str(html))
    content = html.read_text()
    assert "Distributed training stats" in content and "fit" in content


def _record(sid="s1", tid="Update", wid="w0", ts=1.0, **extra):
    return Persistable({"session_id": sid, "type_id": tid,
                        "worker_id": wid, "timestamp": ts, **extra})


@pytest.mark.parametrize("make_storage", [
    lambda tmp: InMemoryStatsStorage(),
    lambda tmp: FileStatsStorage(str(tmp / "stats.jsonl")),
    lambda tmp: SqliteStatsStorage(str(tmp / "stats.db")),
], ids=["memory", "file", "sqlite"])
def test_storage_backends_roundtrip(make_storage, tmp_path):
    """tests/test_ui.py:26-47, on the port's storage."""
    st = make_storage(tmp_path)
    seen = []
    st.register_stats_storage_listener(lambda k, r: seen.append(k))
    st.put_static_info(_record(tid="StaticInfo", info={"a": 1}))
    st.put_update(_record(ts=1.0, iteration=0, score=2.0))
    st.put_update(_record(ts=2.0, iteration=1, score=1.5))
    assert st.list_session_ids() == ["s1"]
    assert "Update" in st.list_type_ids_for_session("s1")
    assert st.list_worker_ids_for_session("s1") == ["w0"]
    ups = st.get_all_updates_after("s1", "Update", "w0", -1)
    assert [u["score"] for u in ups] == [2.0, 1.5]
    assert st.get_all_updates_after("s1", "Update", "w0", 1.5)[0][
        "iteration"] == 1
    static = st.get_static_info("s1", "StaticInfo", "w0")
    assert static["info"] == {"a": 1}
    assert st.get_latest_update("s1", "Update", "w0")["score"] == 1.5
    assert seen == ["static", "update", "update"]
    st.close()


def test_file_storage_persists_across_reopen_and_reads_jax_files(
        tmp_path):
    """tests/test_ui.py:50-58; the JSON-lines file is the reference's
    format both ways."""
    from deeplearning4j_tpu.ui.storage import \
        FileStatsStorage as JFileStorage
    p = str(tmp_path / "stats.jsonl")
    st = FileStatsStorage(p)
    st.put_update(_record(score=3.0))
    st.close()
    st2 = FileStatsStorage(p)
    assert st2.get_latest_update("s1", "Update", "w0")["score"] == 3.0
    st2.close()
    j = JFileStorage(p)
    assert j.get_latest_update("s1", "Update", "w0")["score"] == 3.0
    j.close()


def test_vanilla_router_drains_to_storage():
    router = VanillaStatsStorageRouter()
    router.put_storage_metadata(_record(tid="Meta"))
    router.put_static_info(_record(tid="StaticInfo", info={"n": 2}))
    for i in range(3):
        router.put_update(_record(ts=float(i), iteration=i))
    st = InMemoryStatsStorage()
    kinds = []
    st.register_stats_storage_listener(lambda k, r: kinds.append(k))
    assert router.drain_to(st) == 5
    assert kinds == ["meta", "static", "update", "update", "update"]
    assert [u["iteration"] for u in st.get_all_updates_after(
        "s1", "Update", "w0", -1)] == [0, 1, 2]
    assert st.get_static_info("s1", "StaticInfo", "w0")["info"] == {"n": 2}
    assert router.drain_to(st) == 0
    assert not router.updates and not router.static_info


def test_data_utilities_match_jax(tmp_path):
    from deeplearning4j_tpu.datasets.iterators import DataSet as JDS
    from deeplearning4j_tpu_torch.datasets.iterators import DataSet
    x, y = _data(10, 4)
    pts, jpts = tutil.to_labeled_point(x, y), jutil.to_labeled_point(x, y)
    assert [(p.label, p.features.tobytes()) for p in pts] == \
        [(p.label, p.features.tobytes()) for p in jpts]
    ds, jds = tutil.from_labeled_point(pts, 3), jutil.from_labeled_point(
        jpts, 3)
    assert np.array_equal(ds.features, jds.features)
    assert np.array_equal(ds.labels, jds.labels)
    sets = [DataSet(x[i:i + 2], y[i:i + 2]) for i in range(0, 10, 2)]
    jsets = [JDS(x[i:i + 2], y[i:i + 2]) for i in range(0, 10, 2)]
    tr, te_ = tutil.split_data(sets, 0.6, seed=5)
    jtr, jte = jutil.split_data(jsets, 0.6, seed=5)
    assert [np.asarray(d.features).tobytes() for d in tr + te_] == \
        [np.asarray(d.features).tobytes() for d in jtr + jte]
    parts = tutil.repartition_balanced(x, y, 3)
    jparts = jutil.repartition_balanced(x, y, 3)
    assert [p[0].shape for p in parts] == [p[0].shape for p in jparts]
    for (a, b), (c, d) in zip(parts, jparts):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    for mult in (1, 4, 7):
        got = tutil.pad_to_multiple(x, y, mult)
        want = jutil.pad_to_multiple(x, y, mult)
        assert got[2] == want[2]
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    path = str(tmp_path / "obj.pkl")
    tutil.write_object_to_file(path, {"a": [1, 2]})
    assert jutil.read_object_from_file(path) == {"a": [1, 2]}
    assert tutil.read_object_from_file(path) == {"a": [1, 2]}

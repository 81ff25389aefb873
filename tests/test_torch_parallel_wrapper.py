"""The port's ParallelWrapper, its CLI, MagicQueue and AsyncIterator
(parallel/{wrapper,main,magicqueue}.py) against JAX
(tests/test_parallel.py:38-187).

One start of four gloo CPU ranks (module scope) runs
`torch_parallel_helpers.wrapper_job`: every network starts from the
weights of the JAX network it is compared with, and every rank trains on
its quarter of each batch with the gradients averaged. JAX's oracle is
its single-device network on the same data (the equality its own suite
holds its sharded wrapper to): fit, the uneven batch trimmed to a
multiple of the workers, fit_batched on a network and on a graph
(scores and params rtol 1e-4, atol 1e-5), output_batched (1e-6), and
the data iterator; every rank ends bit-equal. The CLI trains a saved
port model over the four ranks; rank 0's saved model must classify.
"""
import queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu import MultiLayerNetwork as JNet  # noqa: E402
from deeplearning4j_tpu import NeuralNetConfiguration as JConf  # noqa
from deeplearning4j_tpu.datasets.iterators import \
    BaseDatasetIterator as JIter  # noqa: E402
from deeplearning4j_tpu.nn.graph.computation_graph import \
    ComputationGraph as JGraph  # noqa: E402
from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer  # noqa
from deeplearning4j_tpu.parallel import magicqueue as jmq  # noqa: E402

from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa
from deeplearning4j_tpu_torch.parallel import magicqueue as tmq  # noqa
from deeplearning4j_tpu_torch.parallel.main import load_provider  # noqa
from deeplearning4j_tpu_torch.parallel.multihost import \
    MultiHostLauncher  # noqa: E402
from deeplearning4j_tpu_torch.parallel.wrapper import \
    ParallelWrapper  # noqa: E402

import torch_parallel_helpers as H  # noqa: E402

W = 4
FIT = dict(rtol=2e-4, atol=2e-5)
BATCHED = dict(rtol=1e-4, atol=1e-5)


def _jax_mlp():
    return JNet(JConf(seed=42, updater="adam", learning_rate=0.05,
                      activation="tanh")
                .list(DenseLayer(n_in=6, n_out=10),
                      OutputLayer(n_in=10, n_out=3, activation="softmax",
                                  loss_function="mcxent"))).init()


def _jax_graph():
    conf = (JConf(seed=9, updater="adam", learning_rate=0.05)
            .graph_builder()
            .add_inputs("in")
            .add_layer("h", DenseLayer(n_in=6, n_out=10, activation="tanh"),
                       "in")
            .add_layer("out", OutputLayer(n_in=10, n_out=2,
                                          activation="softmax",
                                          loss_function="mcxent"), "h")
            .set_outputs("out")
            .build())
    return JGraph(conf).init()


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _flat(net):
    return np.asarray(net.params_flat())


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(12345)
    x = rng.randn(64, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 64)]
    x_odd = rng.randn(61, 6).astype(np.float32)
    y_odd = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 61)]
    xs = rng.randn(4, 16, 6).astype(np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (4, 16))]
    gxs = rng.randn(3, 16, 6).astype(np.float32)
    gys = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (3, 16))]
    oxs = rng.randn(3, 16, 6).astype(np.float32)
    return dict(x=x, y=y, x_odd=x_odd, y_odd=y_odd, xs=xs, ys=ys, gxs=gxs,
                gys=gys, oxs=oxs)


@pytest.fixture(scope="module")
def jax_ref(data):
    """JAX's single-device networks on the same data, and their initial
    weights."""
    init = {"mlp": _np_tree(_jax_mlp().params),
            "graph": _np_tree(_jax_graph().params)}
    out = {}
    net = _jax_mlp()
    for _ in range(10):
        net.fit(data["x"], data["y"])
    out["fit"] = (_flat(net), float(net.score_value))
    net = _jax_mlp()
    net.fit(data["x_odd"][:60], data["y_odd"][:60])
    out["uneven"] = _flat(net)
    net = _jax_mlp()
    out["fit_batched"] = (np.asarray(net.fit_batched(data["xs"], data["ys"],
                                                     epochs=2)), _flat(net))
    g = _jax_graph()
    out["graph"] = (np.asarray(g.fit_batched(data["gxs"], data["gys"],
                                             epochs=2)), _flat(g))
    out["output_batched"] = np.asarray(_jax_mlp().output_batched(
        data["oxs"]))
    net = _jax_mlp()
    it = JIter(data["x"], data["y"], batch_size=32)
    for _ in range(5):
        net.fit(it)
    out["iterator"] = _flat(net)
    return init, out


@pytest.fixture(scope="module")
def ranks(data, jax_ref, tmp_path_factory):
    from deeplearning4j_tpu_torch.util.model_serializer import write_model
    init, _ = jax_ref
    d = tmp_path_factory.mktemp("pw_cli")
    net = MultiLayerNetwork(H.wrapper_conf(n_in=4, n_out=2),
                            device="cpu").init()
    write_model(net, str(d / "model.zip"))
    cli = {"src": str(d / "model.zip"), "out": str(d / "trained.zip")}
    res = MultiHostLauncher(W, device="cpu").run(
        H.wrapper_job, timeout=300, args=(data, W, init, cli))
    return res, cli


def _same_on_every_rank(res, part, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[part][key], res[0][part][key])


def test_fit_matches_single_device(ranks, jax_ref):
    res, _ = ranks
    want, score = jax_ref[1]["fit"]
    _same_on_every_rank(res, "fit", "params")
    np.testing.assert_allclose(res[0]["fit"]["params"], want, **FIT)
    assert abs(res[0]["fit"]["score"] - score) < 1e-4


def test_uneven_batch_trimmed(ranks, jax_ref):
    """61 rows over 4 workers: 60 trained on, one iteration, the
    listener told 60."""
    res, _ = ranks
    for r in res:
        assert r["uneven"]["iterations"] == 1
        assert r["uneven"]["batches"] == [60]
    _same_on_every_rank(res, "uneven", "params")
    np.testing.assert_allclose(res[0]["uneven"]["params"],
                               jax_ref[1]["uneven"], **FIT)


def test_fit_batched_matches_single_device(ranks, jax_ref):
    res, _ = ranks
    scores, params = jax_ref[1]["fit_batched"]
    rec = res[0]["fit_batched"]
    _same_on_every_rank(res, "fit_batched", "params")
    np.testing.assert_allclose(rec["scores"], scores, **BATCHED)
    np.testing.assert_allclose(rec["params"], params, **BATCHED)
    assert rec["iterations"] == 2 * 4
    assert rec["errors"] == ["batch dim 15 must divide by workers 4 "
                             "(GSPMD even sharding)"] * 2


def test_fit_batched_computation_graph(ranks, jax_ref):
    res, _ = ranks
    scores, params = jax_ref[1]["graph"]
    _same_on_every_rank(res, "graph", "params")
    np.testing.assert_allclose(res[0]["graph"]["scores"], scores, **BATCHED)
    np.testing.assert_allclose(res[0]["graph"]["params"], params, **BATCHED)


def test_output_batched_matches_single(ranks, jax_ref):
    res, _ = ranks
    for r in res:
        np.testing.assert_allclose(r["output_batched"]["out"],
                                   jax_ref[1]["output_batched"],
                                   rtol=1e-5, atol=1e-6)
        assert "must divide by workers" in r["output_batched"]["error"]


def test_wrapper_iterator(ranks, jax_ref):
    res, _ = ranks
    for r in res:
        assert r["iterator"]["iterations"] == 10
        assert r["iterator"]["score"] < 1.2
    _same_on_every_rank(res, "iterator", "params")
    np.testing.assert_allclose(res[0]["iterator"]["params"],
                               jax_ref[1]["iterator"], **FIT)


def test_wrapper_main_cli(ranks):
    """ParallelWrapperMain: load a saved model and a named iterator
    factory, train data-parallel over the ranks, rank 0 saves."""
    from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
    _, cli = ranks
    trained = ModelGuesser.load_model_guess(cli["out"], device="cpu")
    assert trained.evaluate(H.cli_iterator_provider()).accuracy() > 0.8


def test_load_provider_errors():
    with pytest.raises(ValueError, match="module:callable"):
        load_provider("no_colon_here")
    with pytest.raises(TypeError, match="not callable"):
        load_provider("numpy:pi")


def test_one_rank_wrapper_is_the_plain_network(data):
    """No process group: the wrapper's step is the network's own."""
    a = MultiLayerNetwork(H.wrapper_conf(), device="cpu").init()
    b = MultiLayerNetwork(H.wrapper_conf(), device="cpu").init()
    pw = ParallelWrapper(a)
    assert pw.workers == 1
    for _ in range(3):
        pw.fit(data["x"], data["y"])
        b.fit(data["x"], data["y"])
    assert torch.equal(a.params_flat(), b.params_flat())
    assert a.iteration_count == b.iteration_count == 3
    with pytest.raises(ValueError, match="ComputationGraph"):
        from deeplearning4j_tpu_torch.nn.graph.computation_graph import \
            ComputationGraph
        ParallelWrapper(ComputationGraph(H.graph_conf(), device="cpu")
                        .init()).output_batched(data["oxs"])


def _drive_queue(mod, num_devices=None, **kw):
    q = mod.MagicQueue(num_devices=num_devices, capacity_per_device=4,
                       **kw)
    arrays = [np.full((2, 3), i, np.float32) for i in range(6)]
    for a in arrays:
        q.put(a)
    sizes = (q.size(), [q.size(d) for d in range(q.num_devices)])
    first = q.poll(1)
    glob = q.next_global()
    try:
        q.next_global()
        short = False
    except queue.Empty:
        short = True
    rest = [q.poll_nowait(d) for d in range(q.num_devices)]
    return sizes, first, glob, short, rest, q.is_empty()


def test_magic_queue_matches_jax():
    got = _drive_queue(tmq, 3)
    want = _drive_queue(jmq, 3)
    assert got[0] == want[0] and got[3] == want[3] and got[5] == want[5]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[4], want[4]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert tmq.MagicQueue().num_devices == max(1, torch.cuda.device_count())

    class _Mesh:
        shape = {"data": 5}
    assert tmq.MagicQueue(mesh=_Mesh()).num_devices == 5


def test_async_iterator_matches_jax_and_raises():
    items = [np.arange(i, i + 3) for i in range(5)]
    got = list(tmq.AsyncIterator(iter(items), buffer_size=2))
    want = list(jmq.AsyncIterator(iter(items), buffer_size=2))
    assert [a.tolist() for a in got] == [a.tolist() for a in want]

    def broken():
        yield 1
        raise KeyError("source failed")
    it = tmq.AsyncIterator(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="source failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)

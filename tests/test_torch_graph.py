"""Port parity: ComputationGraph, its configuration and its vertices vs
the JAX package.

Each graph runs in both packages from one set of weights (the JAX
graph's `init()`, carried across with `set_params_from_numpy`) on the
same numpy data, in float32:

- the configurations' JSON equals JAX's, string for string, and each
  package reads the other's (YAML too);
- each vertex's output and `output_type` against JAX's;
- `fit` on a two-input, two-output graph (merge and element-wise
  vertices, the losses summed), `fit_batched` over two epochs with a
  listener, TBPTT `fit` / `fit_batched` on JAX's
  test_graph_fit_batched_tbptt_matches_per_chunk_fit schedule, a ragged
  TBPTT `fit` and 20 steps of `rnn_time_step`, the 2-D-label fallthrough
  (LastTimeStepVertex, masks), LBFGS through the graph's Solver, and
  `output` / `output_batched` / `evaluate_batched` / `score` /
  `score_examples`;
- the model serializer's files, read both ways, and
  `EarlyStoppingGraphTrainer`.

Tolerances: scores, parameters and outputs within 1e-5 + 1e-5 |jax|
(the same float32 math summed in other orders). Dropout is the port's
own counter hash (not JAX's draws), so the graphs compared with JAX use
none; the port's dropout keys (vertex i of the topological order draws
from fold_in(key, i)) are checked on their own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu import earlystopping as jes  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    BaseDatasetIterator as JIter)
from deeplearning4j_tpu.nn.conf import serde as jserde  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    ComputationGraphConfiguration as JGConf, NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT  # noqa
from deeplearning4j_tpu.nn.conf.preprocessors import (  # noqa: E402
    CnnToFeedForwardPreProcessor as JCnnToFF)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa
from deeplearning4j_tpu.nn.graph import vertices as jv  # noqa: E402
from deeplearning4j_tpu.train.listeners import (  # noqa: E402
    CollectScoresIterationListener as JCollect)
from deeplearning4j_tpu.util import model_serializer as jms  # noqa: E402

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch import earlystopping as tes  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    BaseDatasetIterator as TIter)
from deeplearning4j_tpu_torch.gradientcheck import (  # noqa: E402
    check_gradients)
from deeplearning4j_tpu_torch.nn.conf import serde as tserde  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    ComputationGraphConfiguration as TGConf, NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT  # noqa
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (  # noqa: E402
    CnnToFeedForwardPreProcessor as TCnnToFF)
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402
    ComputationGraph as TGraph)
from deeplearning4j_tpu_torch.nn.graph import vertices as tv  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: E402
    apply_dropout, fold_in)
from deeplearning4j_tpu_torch.train.listeners import (  # noqa: E402
    CollectScoresIterationListener as TCollect)
from deeplearning4j_tpu_torch.util import (  # noqa: E402
    model_serializer as tms)

TOL = dict(rtol=1e-5, atol=1e-5)
J = dict(L=jl, C=JConf, IT=JIT, V=jv)
T = dict(L=tl, C=TConf, IT=TIT, V=tv)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(make):
    jg = JGraph(make(**J)).init()
    tg = TGraph(make(**T), device="cpu").init()
    tg.set_params_from_numpy(_np(jg.params))
    tg.set_state_from_numpy(_np(jg.state))
    return jg, tg


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def _assert_params(tg, jg):
    assert set(tg.params) == set(jg.params)
    for v, sub in jg.params.items():
        assert set(tg.params[v]) == set(sub), v
        for k, a in sub.items():
            _close(tg.params[v][k].numpy(), a, f"{v}.{k}")
    _close(tg.params_flat().numpy(), jg.params_flat())


# ---------------------------------------------------------------------------
# graphs shared by the tests
# ---------------------------------------------------------------------------

def two_in_two_out(L, C, IT, V, l2=0.0):
    """Two inputs, a merge and an element-wise add, two output layers
    (their losses summed)."""
    return (C(seed=3, updater="adam", learning_rate=0.01,
              activation="tanh", l2=l2)
            .graph_builder().add_inputs("a", "b")
            .set_input_types(a=IT.feed_forward(4), b=IT.feed_forward(3))
            .add_layer("da", L.DenseLayer(n_out=5), "a")
            .add_layer("db", L.DenseLayer(n_out=5), "b")
            .add_vertex("m", V.MergeVertex(), "da", "db")
            .add_vertex("s", V.ElementWiseVertex(op="add"), "da", "db")
            .add_layer("h", L.DenseLayer(n_out=6), "m")
            .add_layer("out", L.OutputLayer(n_out=2, activation="softmax"),
                       "h")
            .add_layer("out2", L.OutputLayer(n_out=3, activation="softmax"),
                       "s")
            .set_outputs("out", "out2").build())


def lstm_tbptt(L, C, IT, V, F=5):
    """JAX's test_graph_fit_batched_tbptt_matches_per_chunk_fit graph."""
    return (C(seed=31, updater="rmsprop", learning_rate=0.05)
            .graph_builder().add_inputs("in")
            .add_layer("lstm", L.GravesLSTM(n_out=12, activation="tanh"),
                       "in")
            .add_layer("out", L.RnnOutputLayer(n_out=F, activation="softmax",
                                               loss_function="mcxent"),
                       "lstm")
            .set_outputs("out")
            .set_input_types(**{"in": IT.recurrent(F)})
            .backprop_type_tbptt(4, 4).build())


def lstm_ragged(L, C, IT, V):
    """JAX's test_graph_tbptt_and_rnn_time_step graph."""
    return (C(seed=1, learning_rate=0.05)
            .graph_builder().add_inputs("in")
            .add_layer("lstm", L.GravesLSTM(n_in=3, n_out=6), "in")
            .add_layer("out", L.RnnOutputLayer(n_in=6, n_out=2,
                                               activation="softmax"),
                       "lstm")
            .set_outputs("out").backprop_type_tbptt(8, 8).build())


def lstm_last_step(L, C, IT, V, tbptt=True):
    """LSTM -> LastTimeStepVertex -> dense output: 2-D labels."""
    b = (C(seed=8, updater="adam", learning_rate=0.02)
         .graph_builder().add_inputs("in")
         .set_input_types(**{"in": IT.recurrent(3)})
         .add_layer("lstm", L.GravesLSTM(n_out=7, activation="tanh"), "in")
         .add_vertex("last", V.LastTimeStepVertex(mask_input="in"), "lstm")
         .add_layer("out", L.OutputLayer(n_out=2, activation="softmax"),
                    "last")
         .set_outputs("out"))
    if tbptt:
        b.backprop_type_tbptt(4, 4)
    return b.build()


def dense_graph(L, C, IT, V, algo="stochastic_gradient_descent",
                iters=1):
    """JAX's graph of test_lbfgs_on_computation_graph."""
    return (C(seed=1, optimization_algo=algo, num_iterations=iters,
              activation="tanh", updater="adam", learning_rate=0.05)
            .graph_builder().add_inputs("in")
            .add_layer("h", L.DenseLayer(n_in=4, n_out=12), "in")
            .add_layer("out", L.OutputLayer(n_in=12, n_out=3,
                                            activation="softmax",
                                            loss_function="mcxent"), "h")
            .set_outputs("out").build())


def cnn_vertices(L, C, IT, V):
    """Convolutional inputs through a merge, a preprocessor vertex and a
    subset vertex, with the CNN -> FF preprocessor inferred."""
    return (C(seed=4, updater="nesterovs", learning_rate=0.05,
              momentum=0.9, activation="relu")
            .graph_builder().add_inputs("img")
            .set_input_types(img=IT.convolutional(6, 6, 2))
            .add_layer("c1", L.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                                convolution_mode="same"),
                       "img")
            .add_layer("c2", L.ConvolutionLayer(n_out=2, kernel_size=(1, 1)),
                       "img")
            .add_vertex("m", V.MergeVertex(), "c1", "c2")
            .add_layer("bn", L.BatchNormalization(), "m")
            .add_layer("d", L.DenseLayer(n_out=8), "bn")
            .add_vertex("sub", V.SubsetVertex(from_idx=2, to_idx=6), "d")
            .add_vertex("sc", V.ScaleVertex(scale_factor=0.5), "sub")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax"),
                       "sc")
            .set_outputs("out").build())


GRAPHS = {"two_in_two_out": two_in_two_out, "lstm_tbptt": lstm_tbptt,
          "lstm_ragged": lstm_ragged, "lstm_last_step": lstm_last_step,
          "dense": dense_graph, "cnn_vertices": cnn_vertices}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_json_matches_jax_and_reads_both_ways(name):
    jc, tc = GRAPHS[name](**J), GRAPHS[name](**T)
    js = jc.to_json()
    assert tc.to_json() == js
    assert TGConf.from_json(js).to_json() == js
    assert JGConf.from_json(tc.to_json()).to_json() == js
    assert TGConf.from_yaml(jc.to_yaml()).to_json() == js
    assert tc.topological_order() == jc.topological_order()
    # the ComputationGraph resolves the same preprocessors and n_in
    jg, tg = JGraph(jc), TGraph(tc, device="cpu")
    assert sorted(tg._preprocessors) == sorted(jg._preprocessors)
    assert tserde.to_dict(tc) == jserde.to_dict(jc)


def test_graph_builder_validates():
    with pytest.raises(ValueError, match="no inputs"):
        TConf().graph_builder().set_outputs("o").build()
    with pytest.raises(ValueError, match="no outputs"):
        TConf().graph_builder().add_inputs("i").build()
    with pytest.raises(ValueError, match="cycle"):
        (TConf().graph_builder().add_inputs("i")
         .add_vertex("a", tv.ScaleVertex(), "b")
         .add_vertex("b", tv.ScaleVertex(), "a")
         .set_outputs("b").build())


# ---------------------------------------------------------------------------
# vertices
# ---------------------------------------------------------------------------

def _pp(pkg):
    return (JCnnToFF if pkg is jv else TCnnToFF)(height=2, width=3,
                                                 channels=2)


VERTS = {
    # name: (make(pkg), input shapes, input types(IT), masks)
    "merge_ff": (lambda v: v.MergeVertex(), [(4, 3), (4, 5)],
                 lambda I: [I.feed_forward(3), I.feed_forward(5)], None),
    "merge_rnn": (lambda v: v.MergeVertex(), [(2, 5, 3), (2, 5, 2)],
                  lambda I: [I.recurrent(3, 5), I.recurrent(2, 5)], None),
    "merge_cnn": (lambda v: v.MergeVertex(), [(2, 3, 3, 2), (2, 3, 3, 4)],
                  lambda I: [I.convolutional(3, 3, 2),
                             I.convolutional(3, 3, 4)], None),
    "add": (lambda v: v.ElementWiseVertex(op="add"), [(4, 3)] * 3,
            lambda I: [I.feed_forward(3)] * 3, None),
    "subtract": (lambda v: v.ElementWiseVertex(op="subtract"),
                 [(4, 3)] * 2, lambda I: [I.feed_forward(3)] * 2, None),
    "product": (lambda v: v.ElementWiseVertex(op="product"), [(4, 3)] * 3,
                lambda I: [I.feed_forward(3)] * 3, None),
    "multiply": (lambda v: v.ElementWiseVertex(op="multiply"),
                 [(4, 3)] * 2, lambda I: [I.feed_forward(3)] * 2, None),
    "average": (lambda v: v.ElementWiseVertex(op="average"), [(4, 3)] * 3,
                lambda I: [I.feed_forward(3)] * 3, None),
    "avg": (lambda v: v.ElementWiseVertex(op="avg"), [(4, 3)] * 2,
            lambda I: [I.feed_forward(3)] * 2, None),
    "max": (lambda v: v.ElementWiseVertex(op="max"), [(4, 3)] * 3,
            lambda I: [I.feed_forward(3)] * 3, None),
    "subset_ff": (lambda v: v.SubsetVertex(from_idx=1, to_idx=3),
                  [(4, 6)], lambda I: [I.feed_forward(6)], None),
    "subset_rnn": (lambda v: v.SubsetVertex(from_idx=0, to_idx=1),
                   [(2, 4, 6)], lambda I: [I.recurrent(6, 4)], None),
    "stack": (lambda v: v.StackVertex(), [(2, 3), (3, 3)],
              lambda I: [I.feed_forward(3)] * 2, None),
    "unstack": (lambda v: v.UnstackVertex(from_idx=1, stack_size=3),
                [(6, 3)], lambda I: [I.feed_forward(3)], None),
    "scale": (lambda v: v.ScaleVertex(scale_factor=-2.5), [(4, 3)],
              lambda I: [I.feed_forward(3)], None),
    "l2": (lambda v: v.L2Vertex(), [(4, 2, 3), (4, 6)],
           lambda I: [I.feed_forward(6)] * 2, None),
    "l2_normalize": (lambda v: v.L2NormalizeVertex(), [(4, 2, 3)],
                     lambda I: [I.feed_forward(6)], None),
    "preprocessor": (lambda v: v.PreprocessorVertex(preprocessor=_pp(v)),
                     [(3, 2, 3, 2)], lambda I: [I.convolutional(2, 3, 2)],
                     None),
    "last_time_step": (lambda v: v.LastTimeStepVertex(), [(3, 5, 4)],
                       lambda I: [I.recurrent(4, 5)], None),
    "last_time_step_masked": (
        lambda v: v.LastTimeStepVertex(mask_input="in"), [(3, 5, 4)],
        lambda I: [I.recurrent(4, 5)],
        [np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                  np.float32)]),
    "duplicate_to_time_series": (
        lambda v: v.DuplicateToTimeSeriesVertex(reference_input="seq"),
        [(3, 4), (3, 6, 2)], lambda I: [I.feed_forward(4),
                                        I.recurrent(2, 6)], None),
    "reshape": (lambda v: v.ReshapeVertex(shape=(3, 2)), [(4, 6)],
                lambda I: [I.feed_forward(6)], None),
}


@pytest.mark.parametrize("name", sorted(VERTS))
def test_vertex_matches_jax(name):
    make, shapes, types, masks = VERTS[name]
    jvx, tvx = make(jv), make(tv)
    assert tserde.to_dict(tvx) == jserde.to_dict(jvx)
    rng = np.random.default_rng(len(name))
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    want = jvx.apply([jnp.asarray(x) for x in xs],
                     masks=None if masks is None
                     else [jnp.asarray(m) for m in masks])
    got = tvx.apply([torch.from_numpy(x) for x in xs],
                    masks=None if masks is None
                    else [torch.from_numpy(m) for m in masks])
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want)
    jt = jvx.output_type(types(JIT))
    tt = tvx.output_type(types(TIT))
    assert tserde.to_dict(tt) == jserde.to_dict(jt)


def test_vertex_errors():
    x = [torch.zeros(2, 3)] * 3
    with pytest.raises(ValueError, match="exactly 2"):
        tv.ElementWiseVertex(op="subtract").apply(x)
    with pytest.raises(ValueError, match="Unknown ElementWiseVertex"):
        tv.ElementWiseVertex(op="pow").apply(x)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _two_in_data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    xa = rng.random((n, 4), dtype=np.float32)
    xb = rng.random((n, 3), dtype=np.float32)
    y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return xa, xb, y1, y2


def test_graph_fit_matches_jax():
    """fit on lists, then on name -> array dicts, with L2: scores and
    params after each step."""
    jg, tg = _pair(lambda **k: two_in_two_out(l2=1e-3, **k))
    xa, xb, y1, y2 = _two_in_data()
    for step in range(4):
        if step % 2:
            feats, labs = {"a": xa, "b": xb}, {"out": y1, "out2": y2}
        else:
            feats, labs = [xa, xb], [y1, y2]
        jg.fit(feats, labs)
        tg.fit(feats, labs)
        _close(float(tg.score_value), float(jg.score_value), f"step {step}")
    _assert_params(tg, jg)
    assert tg.iteration_count == jg.iteration_count == 4
    for got, want in zip(tg.output(xa, xb), jg.output(xa, xb)):
        _close(got.numpy(), want)
    for name, want in jg.feed_forward([xa, xb]).items():
        _close(tg.feed_forward([xa, xb])[name].numpy(), want, name)
    _close(tg.score([xa, xb], [y1, y2]), jg.score([xa, xb], [y1, y2]))
    _close(tg.score_examples([xa, xb], [y1, y2]),
           jg.score_examples([xa, xb], [y1, y2]))
    _close(tg.score_examples([xa, xb], [y1, y2],
                             add_regularization_terms=False),
           jg.score_examples([xa, xb], [y1, y2],
                             add_regularization_terms=False))


def test_graph_fit_batched_matches_jax_and_per_step_fit():
    """fit_batched over a pool of 3 for 2 epochs with a listener vs
    JAX's scanned program, and vs the port's per-step fit; then
    output_batched / evaluate_batched."""
    rng = np.random.default_rng(5)
    xs = rng.random((3, 16, 6, 6, 2), dtype=np.float32)
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 16))]
    jg, tg = _pair(cnn_vertices)
    jl_, tl_ = JCollect(), TCollect()
    jg.set_listeners(jl_)
    tg.set_listeners(tl_)
    js = np.asarray(jg.fit_batched(xs, ys, epochs=2))
    ts = tg.fit_batched(xs, ys, epochs=2)
    assert tuple(ts.shape) == js.shape == (6,)
    _close(ts.numpy(), js)
    assert [i for i, _ in tl_.scores] == [i for i, _ in jl_.scores] \
        == list(range(6))
    _close([s for _, s in tl_.scores], [s for _, s in jl_.scores])
    _assert_params(tg, jg)
    for v, sub in jg.state.items():
        for k, a in sub.items():
            _close(tg.state[v][k].numpy(), a, f"state {v}.{k}")
    # the port's per-step fit over the same schedule: the same run
    ref = TGraph(cnn_vertices(**T), device="cpu").init()
    ref.set_params_from_numpy(_np(JGraph(cnn_vertices(**J)).init().params))
    for _ in range(2):
        for i in range(3):
            ref.fit(xs[i], ys[i])
    _close(ref.params_flat().numpy(), tg.params_flat().numpy())
    jo = np.asarray(jg.output_batched(xs)[0])
    to = tg.output_batched(xs)[0]
    _close(to.numpy(), jo)
    _close(np.stack([tg.output(xs[i])[0].numpy() for i in range(3)]), jo)
    jev, tev = jg.evaluate_batched(xs, ys), tg.evaluate_batched(xs, ys)
    assert tev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(tev.confusion.matrix,
                                  jev.confusion.matrix)


def test_graph_fit_batched_tbptt_matches_jax():
    """JAX's test_graph_fit_batched_tbptt_matches_per_chunk_fit schedule
    in both packages: 3 minibatches of [8, 8, 5], chunks of 4, scores per
    chunk; the port's per-minibatch fit gives the same run."""
    rng = np.random.default_rng(4)
    n_steps, batch, T, F = 3, 8, 8, 5
    xs = rng.random((n_steps, batch, T, F), dtype=np.float32)
    ys = np.eye(F, dtype=np.float32)[rng.integers(0, F, (n_steps, batch,
                                                         T))]
    jg, tg = _pair(lstm_tbptt)
    js = np.asarray(jg.fit_batched(xs, ys))
    ts = tg.fit_batched(xs, ys)
    assert tuple(ts.shape) == js.shape == (n_steps * 2,)
    _close(ts.numpy(), js)
    assert tg.iteration_count == jg.iteration_count == n_steps * 2
    _assert_params(tg, jg)
    jref, tref = _pair(lstm_tbptt)
    for i in range(n_steps):
        jref.fit(xs[i], ys[i])
        tref.fit(xs[i], ys[i])
        _close(float(tref.score_value), float(jref.score_value))
    _close(tref.params_flat().numpy(), tg.params_flat().numpy())
    _close(tref.params_flat().numpy(), jref.params_flat())
    with pytest.raises(ValueError, match="divisible"):
        tg.fit_batched(xs[:, :, :6], ys[:, :, :6])


def test_graph_ragged_tbptt_and_rnn_time_step_match_jax():
    """JAX's test_graph_tbptt_and_rnn_time_step: T=20 in chunks of 8 (3
    updates, the last chunk 4 long); then 20 steps of rnn_time_step
    against JAX's and against the full-sequence output."""
    rng = np.random.RandomState(4)
    x = rng.randn(4, 20, 3).astype(np.float32)
    y = np.tile(np.eye(2, dtype=np.float32)[rng.randint(0, 2, 4)][:, None],
                (1, 20, 1))
    jg, tg = _pair(lstm_ragged)
    jg.fit(x, y)
    tg.fit(x, y)
    assert tg.iteration_count == jg.iteration_count == 3
    _close(float(tg.score_value), float(jg.score_value))
    _assert_params(tg, jg)
    full = tg.output(x)[0].numpy()
    _close(full, jg.output(x)[0])
    jg.rnn_clear_previous_state()
    tg.rnn_clear_previous_state()
    steps = []
    for t in range(20):
        got = tg.rnn_time_step(x[:, t])[0]
        _close(got.numpy(), jg.rnn_time_step(x[:, t])[0], f"step {t}")
        steps.append(got.numpy())
    _close(np.stack(steps, 1), full)
    # a multi-step call carries on from the stored state
    tg.rnn_clear_previous_state()
    first = tg.rnn_time_step(x[:, :7])[0].numpy()
    rest = tg.rnn_time_step(x[:, 7:])[0].numpy()
    _close(np.concatenate([first, rest], 1), full)


def test_graph_last_time_step_masks_and_tbptt_fallthrough():
    """2-D labels under TBPTT fall through to standard BPTT (one update
    a minibatch), and the LSTM vertex passes its input mask on to the
    LastTimeStepVertex; non-first-order algorithms under TBPTT raise."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(5, 9, 3)).astype(np.float32)
    mask = np.ones((5, 9), np.float32)
    mask[0, 4:] = 0
    mask[3, 7:] = 0
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    jg, tg = _pair(lstm_last_step)
    for _ in range(2):
        jg.fit(x, y, mask)
        tg.fit(x, y, mask)
        _close(float(tg.score_value), float(jg.score_value))
    assert tg.iteration_count == 2
    _assert_params(tg, jg)
    _close(tg.score(x, y, mask), jg.score(x, y, mask))
    _close(tg.score_examples(x, y, mask), jg.score_examples(x, y, mask))
    assert tg.score(x, y, mask) != pytest.approx(tg.score(x, y))
    conf = lstm_ragged(**T)
    conf.training.optimization_algo = "lbfgs"
    g = TGraph(conf, device="cpu").init()
    yt = np.tile(y[:4, None], (1, 9, 1))
    with pytest.raises(ValueError, match="first-order"):
        g.fit(x[:4], yt)
    with pytest.raises(ValueError, match="first-order"):
        g.fit_batched(x[None, :4], yt[None])


def test_graph_lbfgs_solver_matches_jax():
    """LBFGS through the graph's Solver (input and label dicts): the
    per-iteration scores the listener sees and the final params."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    labels = (x.sum(axis=1) > 0).astype(np.int64)
    y = np.eye(3, dtype=np.float32)[np.minimum(labels * 2, 2)]
    jg, tg = _pair(lambda **k: dense_graph(algo="lbfgs", iters=6, **k))
    jl_, tl_ = JCollect(), TCollect()
    jg.set_listeners(jl_)
    tg.set_listeners(tl_)
    s0 = tg.score(x, y)
    jg.fit(x, y)
    tg.fit(x, y)
    assert len(tl_.scores) == len(jl_.scores) > 1
    _close([s for _, s in tl_.scores], [s for _, s in jl_.scores])
    _assert_params(tg, jg)
    assert tg.score(x, y) < 0.9 * s0


def test_graph_serializer_reads_both_ways(tmp_path):
    """A trained graph written by either package is restored by the
    other: config, params, BN state and updater state bit for bit."""
    rng = np.random.default_rng(1)
    x = rng.random((8, 6, 6, 2), dtype=np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jg, tg = _pair(cnn_vertices)
    jg.fit(x, y)
    tg.fit(x, y)
    tms.write_model(tg, str(tmp_path / "port.zip"))
    jms.write_model(jg, str(tmp_path / "jax.zip"))
    assert tms.model_type_of(str(tmp_path / "port.zip")) == \
        "ComputationGraph"
    jback = jms.restore_computation_graph(str(tmp_path / "port.zip"))
    tback = tms.restore_computation_graph(str(tmp_path / "jax.zip"),
                                          device="cpu")
    tself = tms.ModelSerializer.restore_computation_graph(
        str(tmp_path / "port.zip"), device="cpu")
    assert jback.conf.to_json() == tg.conf.to_json()
    assert tback.iteration_count == tself.iteration_count == 1
    for attr in ("params", "state", "updater_state"):
        np.testing.assert_array_equal(
            np.asarray(jax.flatten_util.ravel_pytree(
                getattr(jback, attr))[0]),
            np.concatenate([a.reshape(-1).numpy() for a in
                            _leaves(getattr(tg, attr))]), err_msg=attr)
        for a, b in zip(_leaves(getattr(tself, attr)),
                        _leaves(getattr(tg, attr))):
            assert torch.equal(a, b), attr
        for a, b in zip(_leaves(getattr(tback, attr)),
                        jax.tree_util.tree_leaves(getattr(jg, attr))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tself.output(x)[0].numpy(),
                                  tg.output(x)[0].numpy())


def _leaves(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_early_stopping_graph_trainer_matches_jax(tmp_path):
    """EarlyStoppingGraphTrainer with a file saver and a held-out loss:
    the per-epoch scores equal JAX's, and the restored best model is a
    ComputationGraph whose output is the saved one's, bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((48, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                    + (x[:, 1] > 1)]
    jg, tg = _pair(dense_graph)
    saved = {}

    class Saver(tes.LocalFileModelSaver):
        def save_best_model(self, net, score):
            saved["out"] = net.output(x)[0].clone()
            super().save_best_model(net, score)

    res = {}
    for key, es, net, it, saver in (
            ("jax", jes, jg, JIter, jes.LocalFileModelSaver(
                str(tmp_path / "j"))),
            ("port", tes, tg, TIter, Saver(str(tmp_path / "t")))):
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(4)],
            score_calculator=es.DataSetLossCalculator(
                it(x[:16], y[:16], 8)),
            model_saver=saver)
        res[key] = es.EarlyStoppingGraphTrainer(
            cfg, net, it(x, y, 16)).fit()
    assert res["port"].total_epochs == res["jax"].total_epochs == 4
    assert res["port"].best_model_epoch == res["jax"].best_model_epoch
    _close(list(res["port"].score_vs_epoch.values()),
           list(res["jax"].score_vs_epoch.values()))
    best = res["port"].best_model
    assert isinstance(best, TGraph)
    assert torch.equal(best.output(x)[0], saved["out"])


def test_graph_dropout_keyed_by_topological_index():
    """Vertex i of the topological order drops its input units with the
    key fold_in(fold_in(seed, iteration), i): the train-mode forward
    equals one built from apply_dropout with those keys."""
    def make(**_):
        return (TConf(seed=17, activation="identity", updater="sgd")
                .graph_builder().add_inputs("x")
                .add_layer("a", tl.DenseLayer(n_in=6, n_out=5,
                                              dropout=0.4), "x")
                .add_layer("b", tl.DenseLayer(n_in=5, n_out=4,
                                              dropout=0.5), "a")
                .add_layer("out", tl.OutputLayer(n_in=4, n_out=2,
                                                 activation="softmax"), "b")
                .set_outputs("out").build())
    g = TGraph(make(), device="cpu").init()
    x = torch.from_numpy(np.random.default_rng(0).random((3, 6),
                                                         dtype=np.float32))
    key = fold_in(17, 5)
    values, _ = g._forward(g.params, g.state, {"x": x}, train=True,
                           key=key)
    p = g.params
    i_a, i_b = g.topo.index("a"), g.topo.index("b")
    a = apply_dropout(x, 0.4, fold_in(key, i_a)) @ p["a"]["W"] + p["a"]["b"]
    b = apply_dropout(a, 0.5, fold_in(key, i_b)) @ p["b"]["W"] + p["b"]["b"]
    torch.testing.assert_close(values["b"], b, rtol=0, atol=0)
    again, _ = g._forward(g.params, g.state, {"x": x}, train=True, key=key)
    assert torch.equal(again["b"], values["b"])
    infer, _ = g._forward(g.params, g.state, {"x": x}, train=False,
                          key=None)
    assert not torch.equal(infer["b"], values["b"])


def test_graph_check_gradients_float64():
    """The port's check_gradients on a float64 graph through the merge,
    element-wise, subset, scale, L2-normalize and duplicate vertices."""
    conf = (TConf(seed=2, dtype="float64", activation="tanh",
                  updater="sgd")
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", tl.DenseLayer(n_in=3, n_out=4), "a")
            .add_layer("db", tl.DenseLayer(n_in=2, n_out=4), "b")
            .add_vertex("m", tv.MergeVertex(), "da", "db")
            .add_vertex("mx", tv.ElementWiseVertex(op="max"), "da", "db")
            .add_vertex("pr", tv.ElementWiseVertex(op="product"), "mx", "da")
            .add_vertex("sub", tv.SubsetVertex(from_idx=1, to_idx=6), "m")
            .add_vertex("sc", tv.ScaleVertex(scale_factor=0.7), "sub")
            .add_vertex("n", tv.L2NormalizeVertex(), "pr")
            .add_layer("o1", tl.OutputLayer(n_in=6, n_out=2,
                                            activation="softmax"), "sc")
            .add_layer("o2", tl.OutputLayer(n_in=4, n_out=3,
                                            activation="softmax"), "n")
            .set_outputs("o1", "o2").build())
    g = TGraph(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=(4, 2))}
    y = {"o1": np.eye(2)[rng.integers(0, 2, 4)],
         "o2": np.eye(3)[rng.integers(0, 3, 4)]}
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    y = {k: torch.from_numpy(v) for k, v in y.items()}
    assert check_gradients(g, x, y, epsilon=1e-6, max_rel_error=1e-3,
                           min_abs_error=1e-8)


def test_graph_conveniences():
    """predict / f1 / summary / params_flat round trip / clone / the
    classifier surface, as JAX's test_graph_classifier_conveniences."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    jg, tg = _pair(dense_graph)
    for _ in range(10):
        jg.fit(x, y)
        tg.fit(x, y)
    np.testing.assert_array_equal(tg.predict(x), jg.predict(x))
    _close(tg.f1_score(x, y), jg.f1_score(x, y))
    assert tg.summary() == jg.summary()
    assert tg.num_params() == jg.num_params()
    flat = tg.params_flat()
    c = tg.clone()
    c.set_params_flat(flat * 0.5)
    _close(c.params_flat().numpy(), 0.5 * flat.numpy())
    assert torch.equal(tg.params_flat(), flat)          # a copy
    assert c.params["h"]["W"].data_ptr() != tg.params["h"]["W"].data_ptr()
    ev_j = jg.evaluate(JIter(x, y, 8))
    ev_t = tg.evaluate(TIter(x, y, 8))
    assert ev_t.accuracy() == ev_j.accuracy()
    roc_t = tg.evaluate_roc_multi_class(TIter(x, y, 8))
    roc_j = jg.evaluate_roc_multi_class(JIter(x, y, 8))
    _close(roc_t.calculate_average_auc(), roc_j.calculate_average_auc())
    reg_t = tg.evaluate_regression(TIter(x, y, 8))
    reg_j = jg.evaluate_regression(JIter(x, y, 8))
    _close(reg_t.average_mean_squared_error(),
           reg_j.average_mean_squared_error())

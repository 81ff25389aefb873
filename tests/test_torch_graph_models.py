"""Port parity: ResNet-50 and the other graph models, and transfer
learning, vs the JAX package.

- `trained_models.resnet50()`'s JSON equals JAX's at full size (224 x
  224 x 3, 1000 classes, bf16) and at the test's size; shape inference
  inserts no preprocessor. `resnet50(num_classes=10, height=32,
  width=32, dtype="float32")` (only the input resolution cut; every
  channel count stays) runs forward in both packages from one set of
  weights (the port's init, with batch-norm statistics and affine
  parameters moved off their defaults) in inference and in training mode.
- A narrow residual graph (two bottleneck blocks, BN after every conv,
  element-wise adds, a projection shortcut) takes 3 Nesterov steps in
  both packages from JAX's weights: scores, params and BN state.
- A graph of TransformerBlock and MultiHeadAttention vertices (the flash
  kernels' path; JAX's flash in interpret mode) takes 2 SGD steps.
- A GravesLSTM graph equals the port's MultiLayerNetwork over the same
  layers and weights through TBPTT fit_batched, with lstm_wavefront off
  and on.
- Transfer learning: the MultiLayerNetwork builder (feature extractor,
  n_out_replace, remove / add layers, fine-tune overrides), the graph
  builder, and the helper's featurize path, each against JAX. New
  layers initialize with the port's own RNG; the tests carry JAX's new
  weights across after build().

Tolerances: 1e-5 + 1e-5 |jax| in float32; ResNet-50's outputs 1e-4 +
1e-4 |jax| (53 convs deep), and its training-mode softmax 1e-3 + 1e-3
|jax|: stage 5 normalizes by batch statistics over 4 values a channel
(1 x 1 at B=4), which amplifies the inputs' rounding most.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu.modelimport import trained_models as jtm  # noqa
from deeplearning4j_tpu.nn import transferlearning as jtl  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT  # noqa
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph  # noqa
from deeplearning4j_tpu.nn.graph import vertices as jv  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    trained_models as ttm)
from deeplearning4j_tpu_torch.models import zoo as tzoo  # noqa: E402
from deeplearning4j_tpu_torch.nn import (  # noqa: E402
    transferlearning as ttl)
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT  # noqa
from deeplearning4j_tpu_torch.nn.graph import (  # noqa: E402
    ComputationGraph as TGraph)
from deeplearning4j_tpu_torch.nn.graph import vertices as tv  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.misc import FrozenLayer  # noqa
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)

TOL = dict(rtol=1e-5, atol=1e-5)
J = dict(L=jl, C=JConf, IT=JIT, V=jv)
T = dict(L=tl, C=TConf, IT=TIT, V=tv)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.numpy()


def _close(got, want, what="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=what)


def _assert_trees(got, want, what, tol=TOL):
    assert set(got) == set(want), what
    for v, sub in want.items():
        assert set(got[v]) == set(sub), f"{what} {v}"
        for k, a in sub.items():
            _close(got[v][k].numpy(), a, f"{what} {v}.{k}", tol)


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------

def test_resnet50_json_matches_jax_and_has_no_preprocessor():
    for kw in ({}, dict(num_classes=10, height=32, width=32,
                        dtype="float32")):
        jc, tc = jtm.resnet50(**kw), ttm.resnet50(**kw)
        assert tc.to_json() == jc.to_json(), kw
        jg, tg = JGraph(jc), TGraph(tc, device="cpu")
        assert tg._preprocessors == {} == jg._preprocessors
        assert tg.topo == jg.topo
        assert repr(tg.resolved_types["fc1000"]) == \
            repr(jg.resolved_types["fc1000"])
    vertices = tc.vertices
    assert sum(isinstance(s.vertex, tv.ElementWiseVertex)
               for s in vertices.values()) == 16
    assert sum(isinstance(s.vertex, tl.ConvolutionLayer)
               for s in vertices.values()) == 53
    assert tc.training.updater == "nesterovs"
    assert tc.training.momentum == 0.9 and tc.training.learning_rate == 0.01
    assert ttm.resnet50().training.dtype == "bfloat16"
    with pytest.raises(FileNotFoundError):    # imports a local file
        ttm.load_vgg16("weights.h5", device="cpu")


def test_resnet50_32px_forward_matches_jax():
    kw = dict(num_classes=10, height=32, width=32, dtype="float32")
    tg = TGraph(ttm.resnet50(**kw), device="cpu").init(seed=0)
    rng = np.random.default_rng(0)
    for v, st in tg.state.items():          # BN statistics off defaults
        for k, a in st.items():
            st[k] = a + torch.from_numpy(rng.uniform(
                0.0, 0.3, a.shape).astype(np.float32))
    for v, p in tg.params.items():
        if "gamma" in p:
            p["gamma"] = p["gamma"] + torch.from_numpy(
                rng.normal(0, 0.1, p["gamma"].shape).astype(np.float32))
            p["beta"] = p["beta"] + torch.from_numpy(
                rng.normal(0, 0.1, p["beta"].shape).astype(np.float32))
    jg = JGraph(jtm.resnet50(**kw))
    jg.params = jax.tree_util.tree_map(jnp.asarray, _tnp(tg.params))
    jg.state = jax.tree_util.tree_map(jnp.asarray, _tnp(tg.state))
    jg._initialized = True
    assert tg.num_params() == sum(
        a.size for a in jax.tree_util.tree_leaves(jg.params))
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    tol = dict(rtol=1e-4, atol=1e-4)
    out = tg.output(x)[0]
    assert tuple(out.shape) == (2, 10)
    _close(out.numpy(), jg.output(x)[0], "inference", tol)
    _close(out.sum(1).numpy(), np.ones(2), "softmax rows", tol)
    # training mode: batch statistics, at a batch whose last stage
    # (1 x 1) still has 4 samples a channel
    x4 = rng.random((4, 32, 32, 3), dtype=np.float32)
    want, _ = jg._forward(jg.params, jg.state, {"input": jnp.asarray(x4)},
                          train=True, key=None)
    got, st = tg._forward(tg.params, tg.state,
                          {"input": torch.from_numpy(x4)}, train=True,
                          key=None)
    _close(got["s3b1_out"].numpy(), want["s3b1_out"], "train s3b1", tol)
    _close(got["fc1000"].numpy(), want["fc1000"], "train fc1000",
           dict(rtol=1e-3, atol=1e-3))


def narrow_residual(L, C, IT, V):
    """Stem conv + BN/relu, two bottleneck blocks (the first with a
    projection shortcut and stride 2), global average pool, softmax:
    ResNet-50's structure at widths 4 / 8 / 16."""
    b = (C(seed=6, learning_rate=0.05, updater="nesterovs", momentum=0.9,
           weight_init="relu", activation="identity")
         .graph_builder().add_inputs("input")
         .set_input_types(input=IT.convolutional(8, 8, 3)))

    def conv(name, n, k, s, src):
        b.add_layer(name, L.ConvolutionLayer(
            n_out=n, kernel_size=(k, k), stride=(s, s),
            convolution_mode="same", activation="identity"), src)
        return name

    def bn(name, src, relu):
        b.add_layer(name, L.BatchNormalization(
            activation="relu" if relu else "identity", decay=0.9), src)
        return name

    prev = bn("bn1", conv("conv1", 8, 3, 1, "input"), True)
    for i, (stride, proj) in enumerate(((2, True), (1, False))):
        n = f"b{i}"
        x = bn(f"{n}_bn1", conv(f"{n}_c1", 4, 1, stride, prev), True)
        x = bn(f"{n}_bn2", conv(f"{n}_c2", 4, 3, 1, x), True)
        x = bn(f"{n}_bn3", conv(f"{n}_c3", 16, 1, 1, x), False)
        sc = (bn(f"{n}_bnp", conv(f"{n}_proj", 16, 1, stride, prev), False)
              if proj else prev)
        b.add_vertex(f"{n}_add", V.ElementWiseVertex(op="add"), x, sc)
        b.add_layer(f"{n}_out", L.ActivationLayer(activation="relu"),
                    f"{n}_add")
        prev = f"{n}_out"
    b.add_layer("avg_pool", L.GlobalPoolingLayer(pooling_type="avg"), prev)
    b.add_layer("fc", L.OutputLayer(n_out=5, activation="softmax",
                                    loss_function="mcxent"), "avg_pool")
    return b.set_outputs("fc").build()


def _pair(make):
    jg = JGraph(make(**J)).init()
    tg = TGraph(make(**T), device="cpu").init()
    tg.set_params_from_numpy(_np(jg.params))
    tg.set_state_from_numpy(_np(jg.state))
    return jg, tg


def test_narrow_residual_train_steps_match_jax():
    jg, tg = _pair(narrow_residual)
    assert tg.conf.to_json() == jg.conf.to_json()
    assert tg._preprocessors == {} == jg._preprocessors
    rng = np.random.default_rng(2)
    x = rng.random((6, 8, 8, 3), dtype=np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    for step in range(3):
        jg.fit(x, y)
        tg.fit(x, y)
        _close(float(tg.score_value), float(jg.score_value), f"step {step}")
    _assert_trees(tg.params, jg.params, "params")
    _assert_trees(tg.state, jg.state, "BN state")
    _close(tg.output(x)[0].numpy(), jg.output(x)[0])


def attention_graph(L, C, IT, V):
    # plain SGD: the key bias's gradient is zero up to rounding (softmax
    # ignores a per-row constant), which Adam would scale up to +-lr
    return (C(seed=12, updater="sgd", learning_rate=0.1)
            .graph_builder().add_inputs("seq")
            .set_input_types(seq=IT.recurrent(16, 12))
            .add_layer("blk", L.TransformerBlock(n_heads=2, causal=True,
                                                 mlp_ratio=2), "seq")
            .add_layer("mha", L.MultiHeadAttention(n_heads=4, causal=False),
                       "seq")
            .add_vertex("sum", V.ElementWiseVertex(op="add"), "blk", "mha")
            .add_layer("out", L.RnnOutputLayer(n_out=6,
                                               activation="softmax"),
                       "sum")
            .set_outputs("out").build())


def test_attention_vertices_match_jax(monkeypatch):
    monkeypatch.setenv("DL4JTPU_FLASH", "interpret")
    jg, tg = _pair(attention_graph)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 16)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (2, 12))]
    for _ in range(2):
        jg.fit(x, y)
        tg.fit(x, y)
        _close(float(tg.score_value), float(jg.score_value))
    _assert_trees(tg.params, jg.params, "params")
    _close(tg.output(x)[0].numpy(), jg.output(x)[0])


def lstm_graph(L, C, IT, V):
    """The char-RNN's layers (two GravesLSTM, an RnnOutputLayer) as a
    graph, TBPTT 8."""
    return (C(seed=12345, updater="rmsprop", learning_rate=0.01,
              rms_decay=0.95)
            .graph_builder().add_inputs("chars")
            .set_input_types(chars=IT.recurrent(11))
            .add_layer("layer_0", L.GravesLSTM(n_out=9, activation="tanh"),
                       "chars")
            .add_layer("layer_1", L.GravesLSTM(n_out=9, activation="tanh"),
                       "layer_0")
            .add_layer("layer_2", L.RnnOutputLayer(n_out=11,
                                                   activation="softmax",
                                                   loss_function="mcxent"),
                       "layer_1")
            .set_outputs("layer_2").backprop_type_tbptt(8, 8).build())


@pytest.mark.parametrize("wavefront", [False, True])
def test_lstm_graph_equals_multilayer_network(wavefront):
    """The graph (no wavefront: each GravesLSTM vertex scans alone) and
    the MultiLayerNetwork over the same layers and weights give the same
    TBPTT fit_batched run."""
    net = TNet(tzoo.char_rnn_lstm(11, hidden=9, layers=2, tbptt_length=8,
                                  learning_rate=0.01), device="cpu").init()
    net.lstm_wavefront = wavefront
    g = TGraph(lstm_graph(**T), device="cpu").init()
    g.set_params_from_numpy(_tnp(net.params))
    rng = np.random.default_rng(4)
    eye = np.eye(11, dtype=np.float32)
    ids = rng.integers(0, 11, (2, 3, 16))
    xs, ys = eye[ids], eye[np.roll(ids, -1, axis=2)]
    sg = g.fit_batched(xs, ys, epochs=2)
    sn = net.fit_batched(xs, ys, epochs=2)
    assert tuple(sg.shape) == tuple(sn.shape) == (8,)
    _close(sg.numpy(), sn.numpy())
    _close(g.params_flat().numpy(), net.params_flat().numpy())
    g.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    for t in range(4):
        _close(g.rnn_time_step(xs[0, :, t])[0].numpy(),
               net.rnn_time_step(xs[0, :, t]).numpy())


# ---------------------------------------------------------------------------
# transfer learning
# ---------------------------------------------------------------------------

def _mln(L, C):
    return (C(seed=5, updater="sgd", learning_rate=0.1)
            .list(L.DenseLayer(n_in=4, n_out=10, activation="tanh"),
                  L.DenseLayer(n_out=8, activation="tanh"),
                  L.OutputLayer(n_out=3, activation="softmax",
                                loss_function="mcxent")))


def _mln_pair():
    jn = JNet(_mln(jl, JConf)).init()
    tn = TNet(_mln(tl, TConf), device="cpu").init()
    tn.set_params_from_numpy(_np(jn.params))
    return jn, tn


def _data(n=16, seed=0, n_in=4, k=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, n_in).astype(np.float32),
            np.eye(k, dtype=np.float32)[rng.randint(0, k, n)])


BUILDS = {
    "feature_extractor": lambda m, s: (m.TransferLearning.Builder(s)
                                       .set_feature_extractor(1)),
    "n_out_replace": lambda m, s: (m.TransferLearning.Builder(s)
                                   .n_out_replace(1, 20,
                                                  weight_init="xavier")),
    "remove_and_add": lambda m, s: (
        m.TransferLearning.Builder(s).remove_output_layer()
        .add_layer((jl if m is jtl else tl).OutputLayer(
            n_out=7, activation="softmax", loss_function="mcxent"))),
    "fine_tune_frozen": lambda m, s: (
        m.TransferLearning.Builder(s)
        .fine_tune_configuration(m.FineTuneConfiguration(
            learning_rate=0.01, updater="adam", l2=1e-3))
        .set_feature_extractor(0)),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_transfer_learning_builder_matches_jax(name):
    jsrc, tsrc = _mln_pair()
    jnew = BUILDS[name](jtl, jsrc).build()
    tnew = BUILDS[name](ttl, tsrc).build()
    assert tnew.conf.to_json() == jnew.conf.to_json()
    assert [type(layer).__name__ for layer in tnew.layers] == \
        [type(layer).__name__ for layer in jnew.layers]
    # retained layers are the source's; new ones got the port's init
    for name_, sub in tsrc.params.items():
        if name_ in jnew.params and np.asarray(
                jnew.params[name_]["W"]).shape == tuple(sub["W"].shape) \
                and np.array_equal(np.asarray(jnew.params[name_]["W"]),
                                   np.asarray(jsrc.params[name_]["W"])):
            assert torch.equal(tnew.params[name_]["W"], sub["W"])
    tnew.set_params_from_numpy(_np(jnew.params))    # JAX's new weights
    k = tnew.layers[-1].n_out
    x, y = _data(k=k)
    frozen = {n: p["W"].clone() for n, p, layer in zip(
        tnew.params, tnew.params.values(), tnew.layers)
        if isinstance(layer, FrozenLayer)}
    for _ in range(3):
        jnew.fit(x, y)
        tnew.fit(x, y)
        _close(float(tnew.score_value), float(jnew.score_value))
    _assert_trees(tnew.params, jnew.params, name)
    for n, w in frozen.items():
        assert torch.equal(tnew.params[n]["W"], w), n


def test_transfer_learning_helper_matches_jax():
    jsrc, tsrc = _mln_pair()
    jh = jtl.TransferLearningHelper(jsrc, frozen_until=1)
    th = ttl.TransferLearningHelper(tsrc, frozen_until=1)
    x, y = _data(seed=1)
    jf, tf = jh.featurize(x), th.featurize(x)
    assert tuple(tf.shape) == (16, 8)
    _close(tf.numpy(), jf)
    _close(th.output_from_featurized(tf).numpy(), th.net.output(x).numpy())
    for _ in range(3):
        jh.fit_featurized(np.asarray(jf), y)
        th.fit_featurized(tf, y)
    _assert_trees(th.net.params, jh.net.params, "composite")
    _close(th.output_from_featurized(tf).numpy(),
           jh.output_from_featurized(jf))
    assert th.unfrozen_graph() is th._tail
    with pytest.raises(ValueError, match="no frozen layers"):
        ttl.TransferLearningHelper(tsrc)


def _tl_graph(L, C, IT, V):
    """JAX's test_graph_transfer_learning_builder graph."""
    return (C(seed=5, updater="adam", learning_rate=0.01,
              activation="tanh")
            .graph_builder().add_inputs("in")
            .add_layer("f1", L.DenseLayer(n_in=4, n_out=10), "in")
            .add_layer("f2", L.DenseLayer(n_in=10, n_out=8), "f1")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=3,
                                            activation="softmax",
                                            loss_function="mcxent"), "f2")
            .set_outputs("out").build())


def test_graph_transfer_learning_builder_matches_jax():
    jsrc, tsrc = _pair(_tl_graph)

    def build(m, L, src):
        return (m.TransferLearning.GraphBuilder(src)
                .fine_tune_configuration(m.FineTuneConfiguration(
                    learning_rate=0.005))
                .set_feature_extractor("f2")
                .remove_vertex_and_connections("out")
                .add_layer("out2", L.OutputLayer(n_in=8, n_out=5,
                                                 activation="softmax",
                                                 loss_function="mcxent"),
                           "f2")
                .set_outputs("out2").build())

    jnew, tnew = build(jtl, jl, jsrc), build(ttl, tl, tsrc)
    assert tnew.conf.to_json() == jnew.conf.to_json()
    assert isinstance(tnew.conf.vertices["f1"].vertex, FrozenLayer)
    assert torch.equal(tnew.params["f1"]["W"], tsrc.params["f1"]["W"])
    assert tnew.params["f1"]["W"].data_ptr() != \
        tsrc.params["f1"]["W"].data_ptr()               # a copy
    tnew.set_params_from_numpy(_np(jnew.params))
    x, y = _data(n=32, seed=0, k=5)
    w_f1 = tnew.params["f1"]["W"].clone()
    for _ in range(5):
        jnew.fit(x, y)
        tnew.fit(x, y)
        _close(float(tnew.score_value), float(jnew.score_value))
    _assert_trees(tnew.params, jnew.params, "graph transfer")
    assert torch.equal(tnew.params["f1"]["W"], w_f1)


def test_graph_transfer_learning_on_residual_head():
    """The chip run's ResNet-50 surgery on the narrow residual graph:
    freeze up to avg_pool, replace fc with n_out=4; after 3 steps the
    frozen params (and BN state) are bit-equal and the head moved."""
    tsrc = TGraph(narrow_residual(**T), device="cpu").init()
    new = (ttl.TransferLearning.GraphBuilder(tsrc)
           .set_feature_extractor("avg_pool")
           .n_out_replace("fc", 4).build())
    frozen = [n for n, s in new.conf.vertices.items()
              if isinstance(s.vertex, FrozenLayer)]
    assert len(frozen) == 19 and "fc" not in frozen
    before = {n: {k: v.clone() for k, v in new.params[n].items()}
              for n in new.params}
    st_before = {n: {k: v.clone() for k, v in new.state[n].items()}
                 for n in new.state}
    rng = np.random.default_rng(5)
    x = rng.random((6, 8, 8, 3), dtype=np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    for _ in range(3):
        new.fit(x, y)
    for n in frozen:
        for k, v in before[n].items():
            assert torch.equal(new.params[n][k], v), (n, k)
        for k, v in st_before[n].items():
            assert torch.equal(new.state[n][k], v), (n, k)
    assert not torch.equal(new.params["fc"]["W"], before["fc"]["W"])
    assert tuple(new.output(x)[0].shape) == (6, 4)

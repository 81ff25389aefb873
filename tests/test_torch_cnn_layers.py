"""Port parity: the DSL's convolution, pooling, normalization, utility,
output, embedding and attention layers vs the JAX package.

Each case builds the same layer in both packages (the same fields), runs
JAX's `update_input_type` and `init_params` and carries its params and
state across as tensors, then holds the port's forward output, its new
state and the gradients of ``sum(y * r)`` (a fixed random r) with
respect to every parameter and the input to JAX's on the same numpy
input, in float32 within 1e-5 + 1e-5 |jax| (the same float32 math summed
in another order; the gradients of a sum over a batch reach ~20, where
one float32 ulp is 2e-6). The attention layers run JAX's flash kernel in
interpret mode (``DL4JTPU_FLASH=interpret``), as
tests/test_torch_attention.py does;
with a key mask both take the plain math. Dropout draws from the port's
own generator (not `jax.random`), so it is held to itself: the same seed
drops the same units, the kept ones scaled by 1/keep.

The second half runs the port's own `check_gradients` in float64 on a
small network of each family (central differences at eps 1e-6 against
autograd, relative error under 1e-3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT  # noqa
from deeplearning4j_tpu.nn.layers import convolution as jconv  # noqa: E402

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch.gradientcheck import check_gradients  # noqa
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT  # noqa
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv  # noqa
from deeplearning4j_tpu_torch.nn.layers.base import fold_in  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)

TOL = dict(rtol=1e-5, atol=1e-5)


def cnn(h, w, c):
    return ("convolutional", (h, w, c))


def rnn(f, t):
    return ("recurrent", (f, t))


def ff(n):
    return ("feed_forward", (n,))


def _itype(pkg, spec):
    kind, args = spec
    return getattr(pkg, kind)(*args)


def _shape(spec, b):
    kind, args = spec
    if kind == "convolutional":
        return (b,) + tuple(args)
    if kind == "recurrent":
        return (b, args[1], args[0])
    return (b, args[0])


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype))


def _pair(name, kw, spec, seed=0):
    """The layer in both packages, JAX's params and state (numpy)."""
    j, t = getattr(jl, name)(**kw), getattr(tl, name)(**kw)
    j.update_input_type(_itype(JIT, spec))
    t.update_input_type(_itype(TIT, spec))
    p = jax.tree_util.tree_map(np.asarray,
                               j.init_params(jax.random.PRNGKey(seed)))
    s = jax.tree_util.tree_map(np.asarray, j.init_state())
    return j, t, p, s


def _run(j, t, p, s, x, *, train=False, mask=None, seed=1):
    """Forward, state and gradients of sum(y * r) in both packages."""
    r = None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    floating = np.asarray(x).dtype.kind == "f"

    def jf(pp, xx):
        y, ns = j.apply(pp, s, xx, train=train, key=None, mask=jm)
        return jnp.sum(y * r), (y, ns)

    y0, _ = j.apply(p, s, jnp.asarray(x), train=train, key=None, mask=jm)
    r = np.random.default_rng(seed).normal(size=y0.shape).astype(
        np.float32)
    argn = (0, 1) if floating else 0
    (_, (jy, jns)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=argn, has_aux=True))(p, jnp.asarray(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(floating)
    ty, tns = t.apply(tp, {k: _t(v) for k, v in s.items()}, tx,
                      train=train, key=None, mask=tm)
    leaves = list(tp.values()) + ([tx] if floating else [])
    tg = torch.autograd.grad((ty * _t(r)).sum(), leaves,
                             allow_unused=True) if leaves else []
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    for k in jns:
        np.testing.assert_allclose(tns[k].detach().numpy(),
                                   np.asarray(jns[k]), **TOL, err_msg=k)
    jpg = jg[0] if floating else jg
    for (k, _), g in zip(p.items(), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jpg[k]), **TOL,
                                   err_msg=f"grad {k}")
    if floating:
        np.testing.assert_allclose(tg[-1].numpy(), np.asarray(jg[1]), **TOL,
                                   err_msg="grad x")
    return ty, tns


def _x(spec, b=3, seed=2, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(
        size=_shape(spec, b))).astype(np.float32)


CONV = {
    "truncate_pad1": ("ConvolutionLayer", dict(
        n_out=3, kernel_size=(3, 3), padding=(1, 1), activation="relu"),
        cnn(9, 9, 2)),
    "strict_s2": ("ConvolutionLayer", dict(
        n_out=3, kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="strict", activation="tanh"), cnn(9, 9, 2)),
    "same_s1": ("ConvolutionLayer", dict(
        n_out=3, kernel_size=(3, 3), convolution_mode="same"),
        cnn(9, 9, 2)),
    "same_s2_even_kernel": ("ConvolutionLayer", dict(
        n_out=3, kernel_size=(2, 4), stride=(2, 2),
        convolution_mode="same", activation="sigmoid"), cnn(9, 8, 2)),
    "dilated_truncate": ("ConvolutionLayer", dict(
        n_out=3, kernel_size=(3, 3), dilation=(2, 2)), cnn(9, 9, 2)),
    "dilated_same_s2": ("ConvolutionLayer", dict(
        n_out=3, kernel_size=(3, 2), stride=(2, 1), dilation=(2, 2),
        convolution_mode="same"), cnn(9, 9, 2)),
    "conv1d_pad1": ("Convolution1DLayer", dict(
        n_out=4, kernel_size=3, padding=1, activation="relu"), rnn(3, 10)),
    "conv1d_same_s2_even": ("Convolution1DLayer", dict(
        n_out=4, kernel_size=4, stride=2, convolution_mode="same"),
        rnn(3, 9)),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_matches_jax(case):
    name, kw, spec = CONV[case]
    j, t, p, s = _pair(name, kw, spec)
    y, _ = _run(j, t, p, s, _x(spec))
    # the shape inference agrees with the run
    out = t.update_input_type(_itype(TIT, spec))
    want = _shape(("convolutional", (out.height, out.width, out.channels))
                  if name == "ConvolutionLayer" else
                  ("recurrent", (out.size, out.time_series_length)), 3)
    assert tuple(y.shape) == want


def test_strict_mode_raises_as_jax():
    for pkg in (jconv, tconv):
        with pytest.raises(ValueError, match="Strict"):
            pkg.conv_out_size(10, 3, 2, 0, "strict")
        assert pkg.conv_out_size(10, 3, 2, 0, "truncate") == 4
        assert pkg.conv_out_size(10, 3, 2, 0, "same") == 5


POOL_MODES = {
    "same_k3_s2": dict(kernel_size=(3, 3), stride=(2, 2),
                       convolution_mode="same"),
    "truncate_k2_s2": dict(kernel_size=(2, 2), stride=(2, 2)),
    "truncate_k3_s2_pad1": dict(kernel_size=(3, 3), stride=(2, 2),
                                padding=(1, 1)),
}


@pytest.mark.parametrize("mode", sorted(POOL_MODES))
@pytest.mark.parametrize("ptype", ["max", "avg", "pnorm"])
def test_pooling_matches_jax(ptype, mode):
    # 9 x 8: 'same' pads 9 symmetrically and 8 by (0, 1); negative inputs
    # tell pnorm's |x| apart from lp_pool's x
    spec = cnn(9, 8, 2)
    kw = dict(POOL_MODES[mode], pooling_type=ptype, pnorm=3)
    j, t, p, s = _pair("SubsamplingLayer", kw, spec)
    _run(j, t, p, s, _x(spec, scale=2.0))


@pytest.mark.parametrize("ptype", ["max", "avg", "pnorm"])
def test_pooling_1d_matches_jax(ptype):
    spec = rnn(3, 9)
    kw = dict(kernel_size=2, stride=1, convolution_mode="same",
              pooling_type=ptype, pnorm=3)
    j, t, p, s = _pair("Subsampling1DLayer", kw, spec)
    _run(j, t, p, s, _x(spec, scale=2.0))


@pytest.mark.parametrize("padding", [(1, 2), (1, 0, 2, 3)])
def test_zero_padding_matches_jax(padding):
    spec = cnn(4, 5, 2)
    j, t, p, s = _pair("ZeroPaddingLayer", dict(padding=padding), spec)
    _run(j, t, p, s, _x(spec))


@pytest.mark.parametrize("lock", [False, True], ids=["params", "locked"])
@pytest.mark.parametrize("spec", [ff(6), cnn(3, 4, 3), rnn(4, 5)],
                         ids=["ff", "cnn", "rnn"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(train, spec, lock):
    kw = dict(decay=0.8, eps=1e-3, lock_gamma_beta=lock, gamma=1.5,
              beta=-0.25, activation="relu" if lock else None)
    j, t, p, s = _pair("BatchNormalization", kw, spec)
    rng = np.random.default_rng(5)
    if not lock:                    # non-default params and statistics
        p = {k: (v + rng.normal(size=v.shape)).astype(np.float32)
             for k, v in p.items()}
    s = {"mean": rng.normal(size=s["mean"].shape).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)}
    # an odd batch: the biased and unbiased variances differ
    x = _x(spec, b=5, scale=3.0) + 1.0
    _, ns = _run(j, t, p, s, x, train=train)
    if train:                       # decay*old + (1-decay)*biased batch var
        axes = tuple(range(x.ndim - 1))
        np.testing.assert_allclose(
            ns["var"].numpy(), 0.8 * s["var"] + 0.2 * x.var(axis=axes),
            rtol=1e-5, atol=1e-5)
    assert (p == {}) == lock


@pytest.mark.parametrize("n", [3, 5])
def test_local_response_norm_matches_jax(n):
    spec = cnn(3, 3, 7)
    j, t, p, s = _pair("LocalResponseNormalization",
                       dict(n=n, k=1.5, alpha=0.05, beta=0.75), spec)
    _run(j, t, p, s, _x(spec, scale=2.0))


def test_activation_layer_matches_jax():
    spec = cnn(3, 3, 2)
    j, t, p, s = _pair("ActivationLayer", dict(activation="tanh"), spec)
    _run(j, t, p, s, _x(spec))


@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
@pytest.mark.parametrize("spec", [rnn(4, 6), cnn(3, 4, 5)],
                         ids=["rnn_masked", "cnn"])
def test_global_pooling_matches_jax(spec, ptype):
    j, t, p, s = _pair("GlobalPoolingLayer",
                       dict(pooling_type=ptype, pnorm=3), spec)
    mask = None
    if spec[0] == "recurrent":
        mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1],
                         [1, 0, 0, 0, 0, 0]], np.float32)
    _run(j, t, p, s, _x(spec), mask=mask)


def test_dropout_layer_same_seed_same_units():
    t = tl.DropoutLayer(rate=0.3)
    t.update_input_type(TIT.convolutional(8, 8, 4))
    x = torch.from_numpy(_x(cnn(8, 8, 4), b=4)) + 5.0     # no zero inputs
    key = fold_in(12345, 3)
    a, _ = t.apply({}, {}, x, train=True, key=key)
    b, _ = t.apply({}, {}, x, train=True, key=key)
    c, _ = t.apply({}, {}, x, train=True, key=fold_in(12345, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.7, rtol=0, atol=1e-6)
    assert abs(float(kept.float().mean()) - 0.7) < 0.05
    d, _ = t.apply({}, {}, x, train=False, key=key)
    assert torch.equal(d, x)
    # the JAX layer's contract: eval passes through, train keeps the
    # expectation
    j = jl.DropoutLayer(rate=0.3)
    jy, _ = j.apply({}, {}, jnp.asarray(x.numpy()), train=False)
    np.testing.assert_array_equal(np.asarray(jy), d.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_loss_layer_matches_jax(masked):
    spec = rnn(5, 4)
    j, t, p, s = _pair("LossLayer", dict(loss_function="mcxent",
                                         activation="softmax"), spec)
    x = _x(spec)
    lab = np.eye(5, dtype=np.float32)[
        np.random.default_rng(3).integers(0, 5, (3, 4))]
    mask = (np.random.default_rng(4).random((3, 4)) > 0.3).astype(
        np.float32) if masked else None
    _run(j, t, p, s, x)
    jloss, jg = jax.value_and_grad(lambda xx: j.loss(
        {}, xx, jnp.asarray(lab), None if mask is None
        else jnp.asarray(mask)))(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    tloss = t.loss({}, tx, _t(lab), None if mask is None else _t(mask))
    tg, = torch.autograd.grad(tloss, tx)
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_center_loss_output_layer_matches_jax():
    spec = ff(6)
    j, t, p, s = _pair("CenterLossOutputLayer",
                       dict(n_out=4, alpha=0.3, lambda_=0.5,
                            activation="softmax"), spec)
    rng = np.random.default_rng(6)
    s = {"centers": rng.normal(size=(4, 6)).astype(np.float32)}
    x = _x(spec, b=5)
    lab = np.eye(4, dtype=np.float32)[[0, 2, 2, 0, 1]]   # class 3 unseen
    _run(j, t, p, s, x)

    def jf(pp, xx):
        return j.loss(pp, xx, jnp.asarray(lab), None,
                      jax.tree_util.tree_map(jnp.asarray, s))

    jloss, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(p,
                                                                 jnp.asarray(x))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    tloss = t.loss(tp, tx, _t(lab), None, {k: _t(v) for k, v in s.items()})
    g = torch.autograd.grad(tloss, [tp["W"], tp["b"], tx])
    assert abs(tloss.item() - float(jloss)) <= 1e-5
    for got, want in zip(g, (jgp["W"], jgp["b"], jgx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jc = j.update_centers(s, jnp.asarray(x), jnp.asarray(lab))["centers"]
    tc = t.update_centers({k: _t(v) for k, v in s.items()}, _t(x),
                          _t(lab))["centers"]
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(tc.numpy()[3], s["centers"][3])


@pytest.mark.parametrize("form", ["indices", "column", "onehot"])
def test_embedding_layer_matches_jax(form):
    spec = ff(7)
    j, t, p, s = _pair("EmbeddingLayer", dict(n_out=5, activation="tanh"),
                       spec)
    idx = np.random.default_rng(7).integers(0, 7, 6)
    x = {"indices": idx.astype(np.int64),
         "column": idx[:, None].astype(np.int64),
         "onehot": np.eye(7, dtype=np.float32)[idx]}[form]
    _run(j, t, p, s, x)


ATTN = {
    "mha_causal": ("MultiHeadAttention", dict(n_heads=2, causal=True)),
    "mha_full": ("MultiHeadAttention", dict(n_heads=2, n_out=16)),
    "block_causal": ("TransformerBlock", dict(n_heads=2, mlp_ratio=2)),
    "block_full": ("TransformerBlock", dict(n_heads=4, causal=False)),
}


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "masked"])
@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention_layers_match_jax(case, masked, monkeypatch):
    monkeypatch.setenv("DL4JTPU_FLASH", "interpret")
    name, kw = ATTN[case]
    spec = rnn(16, 16)
    j, t, p, s = _pair(name, kw, spec)
    rng = np.random.default_rng(8)
    p = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
         for k, v in p.items()}                       # non-zero biases
    mask = None
    if masked:
        mask = np.ones((2, 16), np.float32)
        mask[0, 11:] = 0
    _run(j, t, p, s, _x(spec, b=2), mask=mask)


def test_layer_norm_layer_matches_jax():
    spec = rnn(6, 4)
    j, t, p, s = _pair("LayerNormalization", dict(eps=1e-4), spec)
    p = {k: v + 0.5 for k, v in p.items()}
    _run(j, t, p, s, _x(spec, scale=2.0))


# ---------------------------------------------------------------------------
# the port's check_gradients, float64, one small network per family
# ---------------------------------------------------------------------------

def _f64_net(layers, itype, seed=3):
    conf = (NeuralNetConfiguration(seed=seed, updater="sgd",
                                   learning_rate=0.1, dtype="float64",
                                   weight_init="xavier")
            .list(*layers).set_input_type(itype))
    return TNet(conf, device="cpu").init()


GRAD_NETS = {
    "conv_pool_bn": lambda: ([
        tl.ConvolutionLayer(n_out=3, kernel_size=(3, 2), stride=(2, 2),
                            convolution_mode="same", activation="tanh"),
        tl.BatchNormalization(),
        tl.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                            stride=(1, 1)),
        tl.OutputLayer(n_out=3, activation="softmax")],
        TIT.convolutional(7, 6, 2), (4, 7, 6, 2), 3),
    "lrn_pad_pnorm_loss": lambda: ([
        tl.ZeroPaddingLayer(padding=(1, 0, 0, 1)),
        tl.ConvolutionLayer(n_out=5, kernel_size=(2, 2), dilation=(1, 2),
                            activation="sigmoid"),
        tl.LocalResponseNormalization(n=3, alpha=0.1),
        tl.SubsamplingLayer(pooling_type="pnorm", pnorm=3,
                            kernel_size=(2, 2), stride=(2, 2)),
        tl.DenseLayer(n_out=3, activation="identity"),
        tl.LossLayer(loss_function="mcxent", activation="softmax")],
        TIT.convolutional(5, 6, 2), (3, 5, 6, 2), 3),
    "conv1d_global_pool": lambda: ([
        tl.Convolution1DLayer(n_out=4, kernel_size=3, stride=2,
                              convolution_mode="same", activation="tanh"),
        tl.Subsampling1DLayer(pooling_type="avg", kernel_size=2, stride=1),
        tl.GlobalPoolingLayer(pooling_type="pnorm", pnorm=3),
        tl.OutputLayer(n_out=2, activation="softmax")],
        TIT.recurrent(3, 9), (3, 9, 3), 2),
    "embedding_center_loss": lambda: ([
        tl.EmbeddingLayer(n_in=6, n_out=5, activation="tanh"),
        tl.DropoutLayer(rate=0.5),
        tl.ActivationLayer(activation="softsign"),
        tl.CenterLossOutputLayer(n_out=3, lambda_=0.3,
                                 activation="softmax")],
        TIT.feed_forward(6), "indices", 3),
    "attention": lambda: ([
        tl.MultiHeadAttention(n_out=8, n_heads=2, causal=True),
        tl.TransformerBlock(n_heads=2, mlp_ratio=2),
        tl.LayerNormalization(),
        tl.RnnOutputLayer(n_out=3, activation="softmax")],
        TIT.recurrent(8, 5), (2, 5, 8), 3),
}


@pytest.mark.parametrize("family", sorted(GRAD_NETS))
def test_check_gradients_float64(family):
    layers, itype, xshape, n_cls = GRAD_NETS[family]()
    net = _f64_net(layers, itype)
    rng = np.random.default_rng(9)
    if xshape == "indices":
        x = rng.integers(0, 6, (5, 1)).astype(np.int64)
        y = np.eye(n_cls)[rng.integers(0, n_cls, 5)]
    else:
        x = rng.normal(size=xshape)
        lead = xshape[:2] if family == "attention" else xshape[:1]
        y = np.eye(n_cls)[rng.integers(0, n_cls, lead)]
    if family == "embedding_center_loss":
        # centers away from zero, so the center term has a gradient
        name = net.layer_names[-1]
        net.state[name]["centers"] = torch.from_numpy(
            rng.normal(size=(3, 5)))
    assert net.dtype == torch.float64
    assert check_gradients(net, x, y, epsilon=1e-6, max_rel_error=1e-3,
                           max_params_to_check=None)
    # a broken gradient is caught: the same check on a scaled loss fails
    orig = net._loss_fn

    def skewed(params, state, xx, yy, key, mask, train=True):
        s, ns = orig(params, state, xx, yy, key, mask, train)
        w = next(p["W"] for p in params.values() if "W" in p)
        return s + (w.detach() - w).sum() * 1e-2, ns

    net._loss_fn = skewed
    assert not check_gradients(net, x, y, max_params_to_check=None)

"""Port parity: the fused LSTM scan and the recurrent layers vs JAX.

Inputs come from numpy with fixed seeds; layer weights are the JAX
layer's own `init_params` (with random peepholes), converted to torch.
The port runs on the CPU, where `ops.lstm.lstm_scan` takes its plain twin
`lstm_scan_reference`; on the card the same dispatch launches
csrc/lstm_scan.cu (held to the twin in tests/test_torch_kernels.py).

Tolerances, each stated with its test: the twin against the Pallas
kernel in interpret mode and against the JAX scan path 2e-5 (the same
float32 math, the recurrent product summed in another order over up to
12 steps); `LSTMCore` gradients 1e-4 (the reverse loop's products and the
parameter sums over T*B rows taken in another order than `_core_bwd`'s
`lax.scan`); layers and the wavefront stack 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplearning4j_tpu.nn.layers import recurrent as jrec  # noqa: E402
from deeplearning4j_tpu.ops import lstm as jlstm  # noqa: E402

from deeplearning4j_tpu_torch.nn.layers import recurrent as trec  # noqa
from deeplearning4j_tpu_torch.ops import lstm as tlstm  # noqa: E402

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _core_inputs(t, b, h, seed=0):
    """xw_t [T,B,4H], h0, c0, RW, b, pI, pF, pO as float32 numpy."""
    return [_np((t, b, 4 * h), seed), _np((b, h), seed + 1, 0.5),
            _np((b, h), seed + 2, 0.5), _np((h, 4 * h), seed + 3, h ** -0.5),
            _np((4 * h,), seed + 4, 0.3), _np((h,), seed + 5, 0.3),
            _np((h,), seed + 6, 0.3), _np((h,), seed + 7, 0.3)]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_reference_matches_pallas_interpret(reverse):
    """The plain twin against the Pallas kernel itself (interpret mode) at
    B=8, T=12, H=128 with random peepholes; reverse flips xw_t, as
    fused_lstm_scan does."""
    args = _core_inputs(12, 8, 128)
    if reverse:
        args[0] = np.ascontiguousarray(args[0][::-1])
    want = jlstm._forward(*[jnp.asarray(a) for a in args], interpret=True)
    got = tlstm.lstm_scan_reference(*[_t(a) for a in args])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


def _layer_pair(cls, n_in, n_out, seed=0, **kw):
    """The same layer in both packages, JAX-initialised params (random
    peepholes where the layer has them) converted to torch."""
    jl = getattr(jrec, cls)(n_in=n_in, n_out=n_out, activation="tanh", **kw)
    tl = getattr(trec, cls)(n_in=n_in, n_out=n_out, activation="tanh", **kw)
    jp = jl.init_params(jax.random.PRNGKey(seed))
    for i, k in enumerate(sorted(jp)):
        if k.endswith(("pI", "pF", "pO")):
            jp[k] = jnp.asarray(_np(jp[k].shape, 100 + seed + i, 0.3))
    tp = {k: _t(v) for k, v in jp.items()}
    return jl, tl, jp, tp


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_path_matches_jax_scan_at_odd_shape(reverse):
    """B=5, H=24 (the TPU gate hdim % 128 rejects it, so JAX takes its
    lax.scan path; the port's eligibility takes the fused path)."""
    jl, tl, jp, tp = _layer_pair("GravesLSTM", 7, 24)
    x = _np((5, 9, 7), 1)
    carry = (_np((5, 24), 2, 0.5), _np((5, 24), 3, 0.5))
    assert tlstm.fused_lstm_available(_t(x), 24, None, "sigmoid", "tanh")
    assert not jlstm.fused_lstm_available(jnp.asarray(x), 24, None,
                                          "sigmoid", "tanh")
    ys_j, (h_j, c_j) = jl.scan_sequence(
        jp, jnp.asarray(x), carry=tuple(map(jnp.asarray, carry)),
        reverse=reverse)
    ys_t, (h_t, c_t) = tl.scan_sequence(
        tp, _t(x), carry=tuple(map(_t, carry)), reverse=reverse)
    for g, w in ((ys_t, ys_j), (h_t, h_j), (c_t, c_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_core_grads_match_jax(reverse, monkeypatch):
    """Gradients of a loss of fused_lstm_scan's outputs and final carry
    with respect to x, h0, c0 and every parameter (W, RW, b, pI, pF, pO),
    against jax.grad through the JAX package's fused_lstm_scan (Pallas
    forward in interpret mode, `_core_bwd` backward)."""
    monkeypatch.setenv("DL4JTPU_FUSED_LSTM", "interpret")
    b, t, f, h = 8, 6, 5, 128
    names = ("W", "RW", "b", "pI", "pF", "pO")
    vals = [_np((f, 4 * h), 10, 0.3), _np((h, 4 * h), 11, h ** -0.5),
            _np((4 * h,), 12, 0.3), _np((h,), 13, 0.3), _np((h,), 14, 0.3),
            _np((h,), 15, 0.3)]
    x, h0, c0 = _np((b, t, f), 16), _np((b, h), 17, 0.5), _np((b, h), 18,
                                                             0.5)
    wy, wh, wc = _np((b, t, h), 19), _np((b, h), 20), _np((b, h), 21)

    def jloss(xx, hh, cc, *ps):
        ys, (hf, cf) = jlstm.fused_lstm_scan(dict(zip(names, ps)), xx,
                                             (hh, cc), reverse=reverse)
        return jnp.sum(ys * wy) + jnp.sum(hf * wh) + jnp.sum(cf * wc)

    want = jax.grad(jloss, argnums=tuple(range(9)))(
        *[jnp.asarray(a) for a in (x, h0, c0, *vals)])
    leaves = [_t(a).requires_grad_(True) for a in (x, h0, c0, *vals)]
    ys, (hf, cf) = tlstm.fused_lstm_scan(dict(zip(names, leaves[3:])),
                                         leaves[0], (leaves[1], leaves[2]),
                                         reverse=reverse)
    loss = (ys * _t(wy)).sum() + (hf * _t(wh)).sum() + (cf * _t(wc)).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


@pytest.mark.parametrize("cls,kw", [
    ("LSTM", {}), ("GravesLSTM", {}),
    ("GravesBidirectionalLSTM", {"mode": "add"}),
    ("GravesBidirectionalLSTM", {"mode": "concat"}),
], ids=["lstm", "graves", "bidi-add", "bidi-concat"])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_apply_matches_jax(cls, kw, masked):
    """Each recurrent layer's apply (and its gradient through a weighted
    sum) against JAX. Unmasked sequences take the port's fused path; a
    mask sends both packages to the plain per-step loop."""
    jl, tl, jp, tp = _layer_pair(cls, 6, 20, seed=3, **kw)
    x = _np((4, 7, 6), 30)
    mask = None
    if masked:
        mask = (np.random.default_rng(31).random((4, 7)) > 0.3).astype(
            np.float32)
    y_j, _ = jl.apply(jp, {}, jnp.asarray(x),
                      mask=None if mask is None else jnp.asarray(mask))
    wy = _np(y_j.shape, 32)
    names = sorted(jp)

    def jloss(*ps):
        y, _ = jl.apply(dict(zip(names, ps)), {}, jnp.asarray(x),
                        mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y * wy)

    g_j = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *[jp[k] for k in names])
    leaves = {k: tp[k].clone().requires_grad_(True) for k in names}
    y_t, _ = tl.apply(leaves, {}, _t(x),
                      mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **FWD)
    g_t = torch.autograd.grad((y_t * _t(wy)).sum(),
                              [leaves[k] for k in names])
    for k, g, w in zip(names, g_t, g_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD,
                                   err_msg=k)


def test_step_matches_jax():
    """LSTM.step, the single-timestep cell, against JAX."""
    jl, tl, jp, tp = _layer_pair("GravesLSTM", 6, 20, seed=4)
    x = _np((3, 6), 40)
    carry = (_np((3, 20), 41, 0.5), _np((3, 20), 42, 0.5))
    (h_j, c_j), y_j = jl.step(jp, tuple(map(jnp.asarray, carry)),
                              jnp.asarray(x))
    (h_t, c_t), y_t = tl.step(tp, tuple(map(_t, carry)), _t(x))
    for g, w in ((h_t, h_j), (c_t, c_j), (y_t, y_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


@pytest.mark.parametrize("with_carries", [False, True])
def test_wavefront_stack_matches_jax(with_carries):
    """wavefront_scan_stack over three stacked layers (LSTM, Graves,
    Graves) against JAX: outputs and every layer's final carry."""
    specs = [("LSTM", 5, 16), ("GravesLSTM", 16, 12),
             ("GravesLSTM", 12, 16)]
    pairs = [_layer_pair(c, i, o, seed=5 + n)
             for n, (c, i, o) in enumerate(specs)]
    x = _np((3, 8, 5), 50)
    carries = None
    if with_carries:
        carries = [(_np((3, o), 51 + n, 0.5), _np((3, o), 61 + n, 0.5))
                   for n, (_, _, o) in enumerate(specs)]
    y_j, fin_j = jrec.wavefront_scan_stack(
        [p[0] for p in pairs], [p[2] for p in pairs], jnp.asarray(x),
        carries=None if carries is None
        else [tuple(map(jnp.asarray, c)) for c in carries])
    y_t, fin_t = trec.wavefront_scan_stack(
        [p[1] for p in pairs], [p[3] for p in pairs], _t(x),
        carries=None if carries is None
        else [tuple(map(_t, c)) for c in carries])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **FWD)
    for (ht, ct), (hj, cj) in zip(fin_t, fin_j):
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **FWD)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **FWD)


def test_wavefront_eligibility_matches_jax():
    """wavefront_eligible_run picks the same runs as JAX: a bidirectional
    layer breaks a run, a mask or enabled=False disables it."""
    def stack(pkg):
        return [pkg.GravesLSTM(n_in=4, n_out=4), pkg.GravesLSTM(n_in=4,
                                                                n_out=4),
                pkg.GravesBidirectionalLSTM(n_in=4, n_out=4),
                pkg.LSTM(n_in=4, n_out=4), pkg.LSTM(n_in=4, n_out=4)]
    names = [f"l{i}" for i in range(5)]
    for start in range(5):
        for mask, enabled in ((None, True), (np.ones(2), True),
                              (None, False)):
            kw = dict(train=True, mask=mask, carries=None,
                      preprocessors={}, enabled=enabled)
            assert trec.wavefront_eligible_run(stack(trec), names, start,
                                               **kw) == \
                jrec.wavefront_eligible_run(stack(jrec), names, start, **kw)


def test_eligibility_gates():
    """The port keeps the semantic gates and drops the TPU shape gates."""
    x = torch.zeros(3, 5, 7)
    ok = tlstm.fused_lstm_available
    assert ok(x, 200, None, "sigmoid", "tanh")         # H % 128 != 0
    assert ok(x.bfloat16(), 37, None, "sigmoid", None)
    assert not ok(x, 200, torch.ones(3, 5), "sigmoid", "tanh")
    assert not ok(x, 200, None, "hardsigmoid", "tanh")
    assert not ok(x, 200, None, "sigmoid", "relu")
    assert not ok(x.double(), 200, None, "sigmoid", "tanh")


def test_lstm_core_returns_input_dtype_and_f32_reserve():
    """bf16 inputs: outputs and final carries in bf16 (the reserve stays
    float32 inside), gradients in each input's dtype."""
    args = [_t(a) for a in _core_inputs(4, 3, 8, seed=70)]
    args[0] = args[0].bfloat16()
    args = [a.requires_grad_(True) for a in args]
    ys, hf, cf = tlstm.LSTMCore.apply(*args)
    assert ys.dtype == hf.dtype == cf.dtype == torch.bfloat16
    hs, cs, gates = tlstm.lstm_scan(*[a.detach() for a in args])
    assert hs.dtype == cs.dtype == gates.dtype == torch.float32
    assert torch.equal(ys, hs.bfloat16()) and torch.equal(hf, ys[-1])
    grads = torch.autograd.grad(ys.float().sum() + cf.float().sum(), args)
    assert [g.dtype for g in grads] == [a.dtype for a in args]


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the twin: a CPU tensor raises."""
    args = [_t(a) for a in _core_inputs(2, 2, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        tlstm.lstm_scan_cuda(*args)


# -- the "tc" kernel's arithmetic and its dispatch --------------------------
# The "tc" kernel (csrc/lstm_scan_tc.cuh) forms h.RW as three exact bf16
# parts of h times the bf16 RW; `lstm_scan_split_reference` is that
# arithmetic on the CPU. It is held to the kernel's own gate, 1e-5 +
# 1e-5 |plain| on hs, cs and gates, against the Pallas kernel (interpret
# mode) and the plain twin at the char-RNN's H=200 over T=64 steps.

SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _char_rnn_core(layer, t=64, b=4, h=200, v=80, seed=0):
    """lstm_scan inputs at the char-RNN's layer-1 (one-hot V=80 input) or
    layer-2 (a tanh H=200 input) scale; RW, like every weight, holds bf16
    values (the bf16 network's), passed as float32."""
    rng = np.random.default_rng(seed)
    f = v if layer == 1 else h
    if layer == 1:
        x = np.eye(v, dtype=np.float32)[rng.integers(0, v, (t, b))]
    else:
        x = np.tanh(rng.normal(size=(t, b, f))).astype(np.float32)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    w = bf(rng.normal(size=(f, 4 * h)) * (2.0 / (f + h)) ** 0.5)
    rw = bf(rng.normal(size=(h, 4 * h)) * h ** -0.5)
    rest = [bf(rng.normal(size=(n,)) * 0.3) for n in (4 * h, h, h, h)]
    h0, c0 = (bf(rng.normal(size=(b, h)) * 0.5) for _ in range(2))
    xw = torch.matmul(torch.from_numpy(x), w)
    return [xw, h0, c0, rw] + rest


@pytest.mark.parametrize("layer", [1, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_split_reference_matches_pallas_interpret(layer, reverse):
    """The split twin against JAX's `_forward(..., interpret=True)` and the
    plain twin at T=64, H=200, B=4."""
    args = _char_rnn_core(layer, seed=layer)
    if reverse:
        args[0] = args[0].flip(0).contiguous()
    want = jlstm._forward(*[jnp.asarray(a.numpy()) for a in args],
                          interpret=True)
    got = tlstm.lstm_scan_split_reference(*args)
    plain = tlstm.lstm_scan_reference(*args)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SPLIT_TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), **SPLIT_TOL)


def test_split_parts_sum_to_h_exactly():
    """hi + mid + lo == h in float64 for float32 h over 40 binades, and
    each part is a bf16 value: the three products with a bf16 RW are exact
    in float32."""
    rng = np.random.default_rng(3)
    h = (rng.normal(size=4096) * 2.0 ** rng.integers(-20, 20, 4096)).astype(
        np.float32)
    parts = tlstm._split3(torch.from_numpy(h))
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, torch.from_numpy(h).double())


def test_split_reference_refuses_a_float32_rw():
    args = [_t(a) for a in _core_inputs(2, 2, 8, seed=90)]
    with pytest.raises(ValueError, match="bfloat16"):
        tlstm.lstm_scan_split_reference(*args)


@pytest.mark.parametrize("w_dtype,b,t,h,want", [
    (torch.bfloat16, 1024, 64, 200, "tc"),     # the char-RNN's shape
    (torch.bfloat16, 1, 1, 200, "tc"),         # sampling: one row tile
    (torch.bfloat16, 5, 7, 37, "tc"),
    (torch.bfloat16, 33, 64, 256, "tc"),
    (torch.bfloat16, 1024, 64, 352, "tc"),     # the card test's largest
    (torch.bfloat16, 16, 1, 351, "tc"),
    (torch.bfloat16, 1, 1, 1, "tc"),
    (torch.bfloat16, 1024, 64, 353, "simt"),   # past the kernel's MAX_H
    (torch.bfloat16, 1024, 64, 356, "simt"),
    (torch.bfloat16, 3, 2, 1100, "simt"),      # the card test's large H
    (torch.float32, 1024, 64, 200, "simt"),
    (torch.float32, 1, 1, 37, "simt"),
])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_lstm_variant_picks_by_dtype_and_shape(x_dtype, w_dtype, b, t, h,
                                               want):
    assert tlstm._lstm_variant(x_dtype, w_dtype, b, t, h) == want


def test_tc_max_h_is_the_kernel_headers():
    """`_lstm_variant`'s largest "tc" H is csrc/lstm_scan_tc.cuh's MAX_H,
    the H up to which the header's static_assert holds that a cluster
    fits."""
    import re
    from pathlib import Path
    src = (Path(tlstm.__file__).resolve().parent.parent / "csrc" /
           "lstm_scan_tc.cuh").read_text()
    assert re.findall(r"constexpr int MAX_H = (\d+);", src) == [
        str(tlstm._TC_MAX_H)]
    assert "static_assert(takes_every_h()" in src

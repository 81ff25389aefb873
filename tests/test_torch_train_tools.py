"""Port parity: the Solver, the TrainingGuard, the listeners and the
checkpoint listener vs the JAX package.

- Solvers: LBFGS, conjugate gradient and line gradient descent on a small
  MLP (20 -> 8 relu -> 3 softmax, float32, one set of weights, one
  full batch), 4 iterations a `fit` call, two calls: the per-iteration
  scores (CollectScoresIterationListener) within 1e-5 + 1e-5 |jax| and
  the parameters within 1e-4 + 1e-4 |jax| (a line search compares float32
  scores, so the accepted steps are the same; the parameters sit at the
  end of up to 8 steps of a quasi-Newton recursion summed in another
  order). On a float64 Rosenbrock function the bare solver classes give
  JAX's score history within 1e-10. The flat vector is JAX's
  `ravel_pytree` order (checked on a 12-layer net, where "layer_10" sorts
  before "layer_2").
- Guard: a guarded `fit` over good, NaN and good batches skips the NaN
  one (the tree bit-equal to before it) and ends where JAX's does; three
  NaN batches raise DivergenceError; the registry's series names and
  values equal JAX's.
- Listeners: every training listener of both packages on the same fit
  (3 `fit` steps, a 2-epoch `fit_batched`), their records equal JAX's
  (scores within 1e-5; counts exactly; the parameter / update means of
  ParamAndGradientIterationListener within 1e-4 relative: its file holds
  6 significant digits). The checkpoint listener's steps restore in
  both packages, bit for bit.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.observability.metrics import (  # noqa: E402
    MetricsRegistry as JReg)
from deeplearning4j_tpu.train import guard as jguard  # noqa: E402
from deeplearning4j_tpu.train import listeners as jlis  # noqa: E402
from deeplearning4j_tpu.train import solvers as jsol  # noqa: E402
from deeplearning4j_tpu.util import checkpointing as jck  # noqa: E402

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)
from deeplearning4j_tpu_torch.observability.metrics import (  # noqa: E402
    MetricsRegistry as TReg)
from deeplearning4j_tpu_torch.train import guard as tguard  # noqa: E402
from deeplearning4j_tpu_torch.train import listeners as tlis  # noqa: E402
from deeplearning4j_tpu_torch.train import solvers as tsol  # noqa: E402
from deeplearning4j_tpu_torch.util import checkpointing as tck  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(pkg, conf_cls, algo="stochastic_gradient_descent", iters=1,
         updater="nesterovs", hidden=(8,)):
    layers = [pkg.DenseLayer(n_out=h, activation="relu") for h in hidden]
    layers[0].n_in = 20
    layers.append(pkg.OutputLayer(n_out=3, activation="softmax"))
    return conf_cls(seed=5, updater=updater, learning_rate=0.05,
                    momentum=0.9, optimization_algo=algo,
                    num_iterations=iters).list(*layers)


def _pair(algo="stochastic_gradient_descent", iters=1, hidden=(8,)):
    jnet = JNet(_mlp(jl, JConf, algo, iters, hidden=hidden)).init()
    tnet = TNet(_mlp(tl, TConf, algo, iters, hidden=hidden),
                device="cpu").init()
    tnet.set_params_from_numpy(_np(jnet.params))
    return jnet, tnet


def _data(seed=0, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 20)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _assert_params(tnet, jnet, tol=TOL):
    for name, sub in jnet.params.items():
        for k, v in sub.items():
            np.testing.assert_allclose(tnet.params[name][k].numpy(),
                                       np.asarray(v), **tol,
                                       err_msg=f"{name}.{k}")


def _samples(reg):
    out = {}
    for fam in reg.collect():
        for labels, child in fam.collect():
            v = child.value
            out[(fam.name, tuple(labels))] = float(v() if callable(v)
                                                   else v)
    return out


def test_params_flat_is_ravel_pytree_order():
    jnet, tnet = _pair(hidden=(4,) * 11)
    assert "layer_10" in tnet.params
    flat, _ = ravel_pytree(jnet.params)
    np.testing.assert_array_equal(tnet.params_flat().numpy(),
                                  np.asarray(flat))
    back = tnet.params_flat() * 2
    tnet.set_params_flat(back)
    np.testing.assert_array_equal(tnet.params_flat().numpy(),
                                  2 * np.asarray(flat))
    assert tnet.num_params() == jnet.num_params()


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_solver_fit_matches_jax(algo):
    jnet, tnet = _pair(algo, iters=4)
    jc, tc = jlis.CollectScoresIterationListener(), \
        tlis.CollectScoresIterationListener()
    jnet.set_listeners(jc)
    tnet.set_listeners(tc)
    x, y = _data()
    for _ in range(2):
        jnet.fit(x, y)
        tnet.fit(x, y)
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores]
    assert len(tc.scores) >= 4
    np.testing.assert_allclose([s for _, s in tc.scores],
                               [s for _, s in jc.scores], **TOL)
    assert tc.scores[-1][1] < tc.scores[0][1]
    _assert_params(tnet, jnet, dict(rtol=1e-4, atol=1e-4))
    assert abs(float(tnet.score_value) - float(jnet.score_value)) <= 1e-5


def test_solver_rejects_tbptt_and_fit_batched():
    conf = _mlp(tl, TConf, "lbfgs")
    net = TNet(conf, device="cpu").init()
    x, y = _data()
    with pytest.raises(ValueError, match="Solver"):
        net.fit_batched(x[None], y[None])
    conf = (TConf(optimization_algo="lbfgs")
            .list(tl.GravesLSTM(n_in=3, n_out=4),
                  tl.RnnOutputLayer(n_out=3)))
    conf.backprop_type_tbptt(2, 2)
    net = TNet(conf, device="cpu").init()
    with pytest.raises(ValueError, match="first-order"):
        net.fit(np.zeros((2, 4, 3), np.float32),
                np.zeros((2, 4, 3), np.float32))


def _rosenbrock_pair():
    def jvg(w):
        return jax.value_and_grad(
            lambda v: (1 - v[0]) ** 2 + 100 * (v[1] - v[0] ** 2) ** 2)(w)

    def tvg(w):
        w = w.detach().requires_grad_(True)
        s = (1 - w[0]) ** 2 + 100 * (w[1] - w[0] ** 2) ** 2
        g, = torch.autograd.grad(s, w)
        return s.detach(), g

    return jvg, tvg


@pytest.mark.parametrize("cls", ["LBFGS", "ConjugateGradient",
                                 "LineGradientDescent",
                                 "StochasticGradientDescent"])
def test_solver_classes_on_rosenbrock_match_jax(cls):
    jvg, tvg = _rosenbrock_pair()
    kw = dict(max_iterations=12, learning_rate=1e-3) \
        if cls == "StochasticGradientDescent" else dict(max_iterations=12)
    js = getattr(jsol, cls)(jvg, **kw)
    ts = getattr(tsol, cls)(tvg, **kw)
    w0 = np.array([-1.2, 1.0])
    jw, jscore = js.optimize(jnp.asarray(w0))
    tw, tscore = ts.optimize(torch.tensor(w0, dtype=torch.float64))
    np.testing.assert_allclose(ts.score_history, js.score_history,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-10,
                               atol=1e-10)


def test_terminations_and_line_search_match_jax():
    g = np.array([3.0, -4.0])
    for pkg, arr in ((jsol, jnp.asarray), (tsol, torch.tensor)):
        assert pkg.EpsTermination().terminate(1.0, 1.0 + 1e-7)
        assert not pkg.EpsTermination().terminate(1.0, 2.0)
        assert pkg.Norm2Termination(6.0).terminate(0, 0, arr(g))
        assert not pkg.Norm2Termination(5.0).terminate(0, 0, arr(g))
        assert pkg.ZeroDirection().terminate(0, 0, arr(np.zeros(2)))
    f_j = lambda w: float(jnp.sum(w ** 2))  # noqa: E731
    f_t = lambda w: float((w ** 2).sum())   # noqa: E731
    w = np.array([1.0, 2.0])
    js = jsol.backtrack_line_search(f_j, jnp.asarray(w), 5.0,
                                    jnp.asarray(2 * w), jnp.asarray(-4 * w))
    ts = tsol.backtrack_line_search(f_t, torch.tensor(w), 5.0,
                                    torch.tensor(2 * w), torch.tensor(-4 * w))
    assert ts[0] == js[0] and ts[2] == pytest.approx(js[2], abs=1e-12)


def _guard_pair():
    jr, tr = JReg(), TReg()
    return (jguard.TrainingGuard(warmup_steps=1, max_consecutive=3,
                                 registry=jr),
            tguard.TrainingGuard(warmup_steps=1, max_consecutive=3,
                                 registry=tr), jr, tr)


def test_guarded_fit_skips_nan_batch_and_matches_jax():
    jnet, tnet = _pair()
    jg, tg, jr, tr = _guard_pair()
    jnet.set_training_guard(jg)
    tnet.set_training_guard(tg)
    good, _ = _data(1)
    _, y = _data(1)
    bad = good.copy()
    bad[3, 5] = np.nan
    for i, x in enumerate((good, bad, good)):
        before = {k: {n: p.clone() for n, p in v.items()}
                  for k, v in tnet.params.items()}
        jnet.fit(x, y)
        tnet.fit(x, y)
        if i == 1:              # SKIP: the tree is the pre-step tree
            for k in before:
                for n in before[k]:
                    assert torch.equal(tnet.params[k][n], before[k][n])
            assert not math.isfinite(tnet.last_grad_norm)
    assert tnet.iteration_count == jnet.iteration_count == 3
    assert tg.last_reason is None and tg.accepted_steps == 2
    _assert_params(tnet, jnet)
    assert abs(tnet.last_grad_norm - jnet.last_grad_norm) <= 1e-4
    js, ts = _samples(jr), _samples(tr)
    assert set(ts) == set(js)
    for k in js:
        assert ts[k] == pytest.approx(js[k], rel=1e-5), k


def test_guard_rollback_raises_and_guard_policy_matches_jax():
    jnet, tnet = _pair()
    jg, tg, jr, tr = _guard_pair()
    tnet.set_training_guard(tg)
    x, y = _data(2)
    x[0, 0] = np.inf
    tnet.fit(x[:8], y[:8])
    tnet.fit(x[:8], y[:8])
    with pytest.raises(tguard.DivergenceError, match="diverged"):
        tnet.fit(x[:8], y[:8])
    assert tg.rollbacks == 1
    # the policy alone, over one score stream: the same verdicts
    jg2, tg2, jr2, tr2 = _guard_pair()
    stream = [2.0, 1.9, float("nan"), 1.8, 9.0, 9.5, 1.7, float("inf"),
              float("nan"), float("nan"), 1.6]
    assert [tg2.update(s, 1.0) for s in stream] == \
        [jg2.update(s, 1.0) for s in stream]
    assert _samples(tr2) == pytest.approx(_samples(jr2))
    assert issubclass(tguard.DivergenceError, RuntimeError)
    assert tguard.StepTimeout(3, 1.0, 2.0) == tguard.StepTimeout(3, 1.0, 2.0)
    # the listener form
    tlst = tguard.TrainingGuardListener(max_consecutive=2)
    tlst.iteration_done(None, 0, float("nan"))
    with pytest.raises(tguard.DivergenceError):
        tlst.iteration_done(None, 1, float("nan"))
    # backoff halves the global rate
    assert tg.apply_lr_backoff(tnet) == pytest.approx(0.025)


def _listeners(pkg, reg, path):
    return [pkg.ScoreIterationListener(2, registry=reg),
            pkg.PerformanceListener(frequency=2, report=True, registry=reg),
            pkg.CollectScoresIterationListener(1),
            pkg.ComposableIterationListener(
                pkg.CollectScoresIterationListener(2)),
            pkg.NanScoreGuardListener(raise_on_invalid=False),
            pkg.ParamAndGradientIterationListener(
                iterations=2, file_path=path, print_to_log=False)]


def test_listeners_records_match_jax(tmp_path):
    jnet, tnet = _pair()
    jr, tr = JReg(), TReg()
    jls = _listeners(jlis, jr, str(tmp_path / "jax.tsv"))
    tls = _listeners(tlis, tr, str(tmp_path / "port.tsv"))
    jnet.set_listeners(*jls)
    tnet.set_listeners(*tls)
    x, y = _data(3, n=24)
    for i in range(3):
        jnet.fit(x[8 * i:8 * i + 8], y[8 * i:8 * i + 8])
        tnet.fit(x[8 * i:8 * i + 8], y[8 * i:8 * i + 8])
    xs, ys = x.reshape(3, 8, 20), y.reshape(3, 8, 3)
    jnet.fit_batched(xs, ys, epochs=2)
    tnet.fit_batched(xs, ys, epochs=2)
    assert tnet.iteration_count == jnet.iteration_count == 9
    for jlst, tlst in zip(jls, tls):
        for attr in ("scores",):
            if hasattr(jlst, attr):
                assert [i for i, _ in getattr(tlst, attr)] == \
                    [i for i, _ in getattr(jlst, attr)]
                np.testing.assert_allclose(
                    [s for _, s in getattr(tlst, attr)],
                    [s for _, s in getattr(jlst, attr)], **TOL)
    jc, tc = jls[3].listeners[0], tls[3].listeners[0]
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores] == \
        [0, 2, 4, 6, 8]
    assert tls[4].tripped_at is None and jls[4].tripped_at is None
    js, ts = _samples(jr), _samples(tr)
    assert set(ts) == set(js)
    for k in ("training_iterations", "training_samples"):
        assert ts[(k, ())] == js[(k, ())] == {"training_iterations": 9,
                                              "training_samples": 72}[k]
    assert ts[("training_score", ())] == pytest.approx(
        js[("training_score", ())], abs=1e-5)
    jrows = (tmp_path / "jax.tsv").read_text().splitlines()
    trows = (tmp_path / "port.tsv").read_text().splitlines()
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 6
    for tr_, jr_ in zip(trows[1:], jrows[1:]):
        tv = [float(v) for v in tr_.split("\t")]
        jv = [float(v) for v in jr_.split("\t")]
        assert tv[0] == jv[0]
        np.testing.assert_allclose(tv[1:], jv[1:], rtol=1e-4, atol=1e-6,
                                   equal_nan=True)
    # a NaN score trips the guard listener in both
    for pkg in (jlis, tlis):
        nan = pkg.NanScoreGuardListener()
        with pytest.raises(FloatingPointError):
            nan.iteration_done(None, 5, float("nan"))
        assert nan.tripped_at == 5


def test_profiler_listener_writes_a_trace(tmp_path):
    _, tnet = _pair()
    prof = tlis.ProfilerListener(str(tmp_path / "prof"), start_iteration=1,
                                 num_iterations=2)
    tnet.set_listeners(prof)
    x, y = _data(4)
    for _ in range(4):
        tnet.fit(x, y)
    assert prof.trace_path and os.path.getsize(prof.trace_path) > 0


def test_checkpoint_listener_and_save_restore_cross_package(tmp_path):
    jnet, tnet = _pair()
    mgr = tck.CheckpointManager(tmp_path / "ck", registry=TReg())
    tnet.set_listeners(tck.CheckpointListener(mgr, frequency=2))
    x, y = _data(5)
    for _ in range(5):
        tnet.fit(x, y)
    assert mgr.all_steps() == [2, 4]
    # JAX restores the port's step 4 ...
    jmgr = jck.CheckpointManager(str(tmp_path / "ck"), use_orbax=False)
    assert jmgr.restore(jnet) == 4
    assert jnet.iteration_count == 4
    # ... and the port restores it as well, onto a fresh network
    fresh = TNet(_mlp(tl, TConf), device="cpu").init()
    assert mgr.restore(fresh) == 4 and fresh.iteration_count == 4
    _assert_params(fresh, jnet, dict(rtol=0, atol=0))
    # the port restores what JAX saves
    jnet.fit(x, y)
    jmgr.save(jnet, step=9)
    assert mgr.restore(fresh) == 9
    _assert_params(fresh, jnet, dict(rtol=0, atol=0))
    for name, sub in jnet.updater_state.items():
        for k, slots in sub.items():
            for slot, v in slots.items():
                np.testing.assert_array_equal(
                    fresh.updater_state[name][k][slot].numpy(),
                    np.asarray(v))

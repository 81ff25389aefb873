"""Port parity: the model serializer and early stopping vs the JAX
package.

- Serializer: a MultiLayerNetwork with batch norm, trained a few Nesterov
  steps, written by JAX is restored by the port and the other way round:
  configuration, params, layer state (BN statistics), updater state and
  counters bit-equal, outputs within 1e-5 (float32). The same for a
  bfloat16 network, whose arrays travel as uint16 bit views with the
  ``__dtypes__`` sidecar (the port reads them without ml_dtypes): bits
  equal.
- Early stopping: `EarlyStoppingTrainer` on the same MLP, data and
  conditions in both packages (score calculator on a held-out iterator,
  max epochs + score-improvement patience, an iteration condition), the
  port with the in-memory and the local-file saver, JAX with its
  local-file saver (its in-memory saver's clone shares buffers that its
  next donating step deletes): the termination reason and
  details, the best epoch and the epoch count equal JAX's, the per-epoch
  scores within 1e-5, and the restored best model's output within 1e-5
  of JAX's (and bit-equal to the port's network at that epoch).
"""
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

import deeplearning4j_tpu.nn.layers as jl  # noqa: E402
from deeplearning4j_tpu import earlystopping as jes  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jit_  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT  # noqa
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.util import model_serializer as jms  # noqa: E402

import deeplearning4j_tpu_torch.nn.layers as tl  # noqa: E402
from deeplearning4j_tpu_torch import earlystopping as tes  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as tit  # noqa
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT  # noqa
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)
from deeplearning4j_tpu_torch.util import model_serializer as tms  # noqa

TOL = dict(rtol=1e-5, atol=1e-5)


def _conf(pkg, conf_cls, it, dtype="float32"):
    return conf_cls(seed=3, updater="nesterovs", learning_rate=0.05,
                    momentum=0.9, dtype=dtype).list(
        pkg.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                             convolution_mode="same", activation="relu"),
        pkg.BatchNormalization(),
        pkg.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
        pkg.DenseLayer(n_out=6, activation="tanh"),
        pkg.OutputLayer(n_out=3, activation="softmax")
    ).set_input_type(it.convolutional(6, 6, 2))


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _host(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_bit_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_trees_bit_equal(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_array_equal(_host(got), _bits(want), err_msg=what)


def _assert_nets_bit_equal(tnet, jnet):
    for tree in ("params", "state", "updater_state"):
        _assert_trees_bit_equal(getattr(tnet, tree), getattr(jnet, tree),
                                tree)
    assert tnet.iteration_count == jnet.iteration_count
    assert tnet.epoch_count == jnet.epoch_count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_written_model_restores_in_port(dtype, tmp_path):
    jnet = JNet(_conf(jl, JConf, JIT, dtype)).init()
    x, y = _data()
    for _ in range(3):
        jnet.fit(x, y)
    path = str(tmp_path / "jax.zip")
    jms.write_model(jnet, path)
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
    assert {"configuration.json", "metadata.json", "coefficients.npz",
            "layerState.npz", "updaterState.npz"} <= names
    assert tms.model_type_of(path) == "MultiLayerNetwork"
    tnet = tms.restore_multi_layer_network(path, device="cpu")
    assert json.loads(tnet.conf.to_json()) == json.loads(
        jnet.conf.to_json())
    _assert_nets_bit_equal(tnet, jnet)
    if dtype == "float32":
        np.testing.assert_allclose(tnet.output(x).numpy(),
                                   np.asarray(jnet.output(x)), **TOL)
        # training resumes where JAX's does
        jnet.fit(x, y)
        tnet.fit(x, y)
        assert abs(float(tnet.score_value) - float(jnet.score_value)) \
            <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_written_model_restores_in_jax(dtype, tmp_path):
    tnet = TNet(_conf(tl, TConf, TIT, dtype), device="cpu").init()
    x, y = _data(1)
    for _ in range(3):
        tnet.fit(x, y)
    tnet.epoch_count = 2
    path = str(tmp_path / "port.zip")
    tms.ModelSerializer.write_model(tnet, path)
    jnet = jms.restore_multi_layer_network(path)
    _assert_nets_bit_equal(tnet, jnet)
    back = tms.restore_multi_layer_network(path, device="cpu")
    _assert_nets_bit_equal(back, jnet)
    if dtype == "float32":
        np.testing.assert_allclose(tnet.output(x).numpy(),
                                   np.asarray(jnet.output(x)), **TOL)
    else:
        assert back.params["layer_0"]["W"].dtype == torch.bfloat16
    no_upd = str(tmp_path / "noupd.zip")
    tms.write_model(tnet, no_upd, save_updater=False)
    with zipfile.ZipFile(no_upd) as zf:
        assert "updaterState.npz" not in zf.namelist()
    # a MultiLayerNetwork's file is not a ComputationGraph's (JAX raises
    # the same)
    with pytest.raises(ValueError, match="ComputationGraphConfiguration"):
        tms.restore_computation_graph(path, device="cpu")


def _es_conf(pkg, conf_cls):
    return conf_cls(seed=11, updater="nesterovs", learning_rate=0.3,
                    momentum=0.9).list(
        pkg.DenseLayer(n_in=10, n_out=8, activation="tanh"),
        pkg.OutputLayer(n_out=3, activation="softmax"))


def _es_data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 10)).astype(np.float32)
    w = rng.normal(size=(10, 3))
    y = np.eye(3, dtype=np.float32)[(x @ w).argmax(1)]
    # held-out labels are noisier than the training ones: the held-out
    # loss turns up after a few epochs and the patience stops the run
    yv = y[48:].copy()
    yv[::3] = np.roll(yv[::3], 1, axis=1)
    return x[:48], y[:48], x[48:], yv


def _es_run(pkg, es, its, conf_cls, saver, iteration_conditions=()):
    x, y, xv, yv = _es_data()
    net = (JNet(_es_conf(pkg, conf_cls)).init() if pkg is jl else
           TNet(_es_conf(pkg, conf_cls), device="cpu").init())
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[
            es.MaxEpochsTerminationCondition(12),
            es.ScoreImprovementEpochTerminationCondition(2)],
        iteration_termination_conditions=list(iteration_conditions),
        score_calculator=es.DataSetLossCalculator(
            its.BaseDatasetIterator(xv, yv, 8)),
        model_saver=saver, save_last_model=True)
    trainer = es.EarlyStoppingTrainer(cfg, net,
                                      its.BaseDatasetIterator(x, y, 16))
    return net, trainer


@pytest.mark.parametrize("saver", ["memory", "file"])
def test_early_stopping_matches_jax(saver, tmp_path):
    jx, _, _, _ = _es_data()
    # JAX's side keeps its best model in files: its in-memory saver's
    # clone shares buffers that the next (donating) jitted step deletes
    jnet, jtr = _es_run(jl, jes, jit_, JConf,
                        jes.LocalFileModelSaver(str(tmp_path / "j")))
    tnet, ttr = _es_run(tl, tes, tit, TConf,
                        tes.InMemoryModelSaver() if saver == "memory"
                        else tes.LocalFileModelSaver(str(tmp_path / "t")))
    # the port starts from JAX's weights
    tnet.set_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jnet.params))
    jr, tr = jtr.fit(), ttr.fit()
    assert tr.termination_reason == jr.termination_reason == \
        "EpochTerminationCondition"
    assert tr.termination_details == jr.termination_details
    assert tr.best_model_epoch == jr.best_model_epoch
    assert tr.total_epochs == jr.total_epochs < 12
    assert sorted(tr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    np.testing.assert_allclose(
        [tr.score_vs_epoch[e] for e in sorted(tr.score_vs_epoch)],
        [jr.score_vs_epoch[e] for e in sorted(jr.score_vs_epoch)], **TOL)
    assert tr.best_model_score == pytest.approx(jr.best_model_score,
                                                abs=1e-5)
    np.testing.assert_allclose(tr.best_model.output(jx).numpy(),
                               np.asarray(jr.best_model.output(jx)), **TOL)
    # the best model is the network as it was at its epoch, not as it ended
    assert not torch.equal(tr.best_model.output(jx), tnet.output(jx))
    latest = ttr.config.model_saver.get_latest_model()
    assert torch.equal(latest.output(jx), tnet.output(jx))


def test_early_stopping_iteration_condition_matches_jax():
    conds = {
        "jax": [jes.MaxScoreIterationTerminationCondition(0.9),
                jes.InvalidScoreIterationTerminationCondition()],
        "port": [tes.MaxScoreIterationTerminationCondition(0.9),
                 tes.InvalidScoreIterationTerminationCondition()]}
    jnet, jtr = _es_run(jl, jes, jit_, JConf, jes.InMemoryModelSaver(),
                        conds["jax"])
    tnet, ttr = _es_run(tl, tes, tit, TConf, tes.InMemoryModelSaver(),
                        conds["port"])
    tnet.set_params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jnet.params))
    jr, tr = jtr.fit(), ttr.fit()
    assert tr.termination_reason == jr.termination_reason == \
        "IterationTerminationCondition"
    assert tr.termination_details == jr.termination_details
    assert tr.total_epochs == jr.total_epochs
    assert tnet.iteration_count == jnet.iteration_count

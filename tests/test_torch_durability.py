"""Port parity: the training durability tools (`FaultTolerantTrainer`,
`PreemptionHandler`, `StepWatchdog`, async checkpoints) vs the JAX
package.

Each schedule of the JAX package's tests/test_durability.py (NaN
injection under the guard, rollback with LR back-off, a crash mid-write,
a torn write, simulated and real preemption, the async writer drained
under SIGTERM, spaced and persistent faults, the watchdog) runs in both
packages from one set of weights on the same data; the port must take
the same checkpoint steps, iteration counts, restarts, injections and
guard decisions, and end with JAX's parameters within 1e-5 + 1e-5 |jax|
(float32). A preempted run resumed from its checkpoint ends with
parameters bit-equal to an uninterrupted run's (sync and async
checkpoints), in a fresh network and trainer.
"""
import os
import signal
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from deeplearning4j_tpu import observability as jobs  # noqa: E402
from deeplearning4j_tpu.datasets import iterators as jits  # noqa: E402
from deeplearning4j_tpu.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as JConf)
from deeplearning4j_tpu.nn.layers import (  # noqa: E402
    DenseLayer as JDense, OutputLayer as JOut)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet)
from deeplearning4j_tpu.parallel import failure as jfail  # noqa: E402
from deeplearning4j_tpu.train import guard as jguard  # noqa: E402

from deeplearning4j_tpu_torch import observability as tobs  # noqa: E402
from deeplearning4j_tpu_torch.datasets import iterators as tits  # noqa
from deeplearning4j_tpu_torch.nn.conf.configuration import (  # noqa: E402
    NeuralNetConfiguration as TConf)
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: E402
    DenseLayer as TDense, OutputLayer as TOut)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as TNet)
from deeplearning4j_tpu_torch.parallel import failure as tfail  # noqa
from deeplearning4j_tpu_torch.train import guard as tguard  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
JAX = types.SimpleNamespace(fail=jfail, guard=jguard, obs=jobs, it=jits,
                            port=False)
PORT = types.SimpleNamespace(fail=tfail, guard=tguard, obs=tobs, it=tits,
                             port=True)
_JAX_INIT = {}


def _conf(pkg, seed, lr):
    C, D, O = ((TConf, TDense, TOut) if pkg.port else (JConf, JDense, JOut))
    return C(seed=seed, updater="adam", learning_rate=lr).list(
        D(n_in=6, n_out=12, activation="tanh"),
        O(n_out=2, activation="softmax", loss_function="mcxent"))


def _net(pkg, seed=1, lr=0.01):
    """JAX's network, or the port's carrying JAX's initial weights."""
    if (seed, lr) not in _JAX_INIT:
        _JAX_INIT[seed, lr] = jax.tree_util.tree_map(
            np.asarray, JNet(_conf(JAX, seed, lr)).init().params)
    if not pkg.port:
        return JNet(_conf(JAX, seed, lr)).init()
    net = TNet(_conf(PORT, seed, lr), device="cpu").init()
    net.set_params_from_numpy(_JAX_INIT[seed, lr])
    return net


def _data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y


def _iter(pkg, x, y, batch=16):
    return pkg.it.BaseDatasetIterator(x, y, batch)


def _flat(net):
    return (net.params_flat().numpy() if isinstance(net, TNet)
            else np.asarray(net.params_flat()))


def _both(run, tmp_path):
    """``run(pkg, dir)`` in both packages: (jax record, port record)."""
    return (run(JAX, str(tmp_path / "jax")),
            run(PORT, str(tmp_path / "port")))


def _same(rj, rt):
    assert set(rj) == set(rt)
    for k, v in rj.items():
        if k == "params":
            np.testing.assert_allclose(rt[k], v, **TOL)
        elif isinstance(v, float):
            np.testing.assert_allclose(rt[k], v, **TOL, err_msg=k)
        else:
            assert rt[k] == v, (k, rt[k], v)


# ---------------------------------------------------------------------------
# the schedules of tests/test_durability.py, in both packages
# ---------------------------------------------------------------------------

def test_nan_injection_skipped_and_run_converges(tmp_path):
    def run(pkg, d):
        x, y = _data(96, seed=2)
        reg = pkg.obs.MetricsRegistry()
        guard = pkg.guard.TrainingGuard(registry=reg)
        inj = pkg.fail.FaultInjector(nan_at=[3])
        net = _net(pkg, seed=3)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, checkpoint_frequency=2, fault_injector=inj,
            use_orbax=False, guard=guard, registry=reg)
        assert tr.fit(_iter(pkg, x, y), epochs=2) is True
        text = pkg.obs.prometheus_text(reg)
        assert 'training_guard_events_total{action="skip"} 1' in text
        return dict(done=True, nans=inj.nans_injected,
                    iters=net.iteration_count, skips=guard.skipped_steps
                    if hasattr(guard, "skipped_steps") else None,
                    accepted=guard.accepted_steps,
                    steps=tr.manager.all_steps(),
                    score=float(net.score(x, y)), params=_flat(net))
    _same(*_both(run, tmp_path))


def test_consecutive_nans_roll_back_with_lr_backoff(tmp_path):
    def run(pkg, d):
        x, y = _data(96, seed=4)
        guard = pkg.guard.TrainingGuard(
            max_consecutive=2, lr_backoff=0.5,
            registry=pkg.obs.MetricsRegistry())
        inj = pkg.fail.FaultInjector(nan_at=[4, 5])
        net = _net(pkg, seed=5)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, checkpoint_frequency=2, fault_injector=inj,
            use_orbax=False, guard=guard, max_restarts=3,
            registry=pkg.obs.MetricsRegistry())
        assert tr.fit(_iter(pkg, x, y), epochs=2) is True
        return dict(rollbacks=guard.rollbacks, restarts=tr.restarts,
                    consecutive=tr.consecutive_failures,
                    lr=net.conf.training.learning_rate,
                    iters=net.iteration_count,
                    steps=tr.manager.all_steps(), params=_flat(net))
    rj, rt = _both(run, tmp_path)
    assert rt["rollbacks"] == rt["restarts"] == 1
    assert rt["lr"] == pytest.approx(0.005)
    _same(rj, rt)


def test_crash_mid_write_resumes_from_previous_verified_step(tmp_path):
    def run(pkg, d):
        x, y = _data(96, seed=6)
        inj = pkg.fail.FaultInjector(crash_write_at=[4])
        net = _net(pkg, seed=7)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, checkpoint_frequency=2, fault_injector=inj,
            use_orbax=False, max_restarts=0,
            registry=pkg.obs.MetricsRegistry())
        with pytest.raises(pkg.fail.TrainingFailure,
                           match="crash during checkpoint"):
            tr.fit(_iter(pkg, x, y), epochs=2)
        orphan = os.path.exists(os.path.join(d, "step_4.tmp"))
        latest = tr.manager.latest_step()
        net2 = _net(pkg, seed=8)
        tr2 = pkg.fail.FaultTolerantTrainer(
            net2, d, checkpoint_frequency=2, use_orbax=False,
            registry=pkg.obs.MetricsRegistry())
        swept = not os.path.exists(os.path.join(d, "step_4.tmp"))
        assert tr2.fit(_iter(pkg, x, y), epochs=2) is True
        return dict(orphan=orphan, latest=latest, swept=swept,
                    iters=net2.iteration_count,
                    steps=tr2.manager.all_steps(), params=_flat(net2))
    rj, rt = _both(run, tmp_path)
    assert rt["orphan"] and rt["swept"] and rt["latest"] == 2
    _same(rj, rt)


def test_torn_write_falls_back_to_previous_verified_step(tmp_path):
    def run(pkg, d):
        x, y = _data(96, seed=8)
        inj = pkg.fail.FaultInjector(torn_write_at=[4])
        net = _net(pkg, seed=9)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, checkpoint_frequency=2, fault_injector=inj,
            use_orbax=False, registry=pkg.obs.MetricsRegistry())
        assert tr.fit(_iter(pkg, x, y), epochs=1) is True
        mgr = tr.manager
        net2 = _net(pkg, seed=10)
        restored = mgr.restore(net2)
        return dict(torn=inj.writes_torn, v4=mgr.verify_step(4),
                    v2=mgr.verify_step(2), restored=restored,
                    steps=mgr.all_steps(), params=_flat(net2))
    rj, rt = _both(run, tmp_path)
    assert rt["torn"] == 1 and not rt["v4"] and rt["v2"]
    assert rt["restored"] not in (None, 4)
    _same(rj, rt)


def test_simulated_preemption_mid_epoch_is_resumable(tmp_path):
    def run(pkg, d):
        x, y = _data(96, seed=10)
        ph = pkg.fail.PreemptionHandler(registry=pkg.obs.MetricsRegistry())
        inj = pkg.fail.FaultInjector(preempt_at=[4])
        net = _net(pkg, seed=11)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, checkpoint_frequency=100, fault_injector=inj,
            use_orbax=False, preemption=ph,
            registry=pkg.obs.MetricsRegistry())
        first = tr.fit(_iter(pkg, x, y), epochs=2)
        stop = net.iteration_count
        latest = tr.manager.latest_step()
        ph.clear()
        second = tr.fit(_iter(pkg, x, y), epochs=1)
        return dict(first=first, second=second, preempted=tr.preempted,
                    stop=stop, latest=latest, iters=net.iteration_count,
                    params=_flat(net))
    rj, rt = _both(run, tmp_path)
    assert rt["first"] is False and rt["second"] is True
    assert rt["latest"] == rt["stop"] == 4 and rt["iters"] > 4
    _same(rj, rt)


@pytest.mark.parametrize("async_save", [False, True],
                         ids=["sync", "async"])
def test_preempted_run_resumes_bit_equal_to_uninterrupted(tmp_path,
                                                          async_save):
    """Preempted at iteration 4 (a checkpoint and a stop), then resumed
    by a fresh network and trainer over the batches not yet taken: the
    final parameters, updater state and counters are the uninterrupted
    run's, bit for bit."""
    x, y = _data(96, seed=12)
    plain = _net(PORT, seed=13)
    tfail.FaultTolerantTrainer(
        plain, str(tmp_path / "plain"), checkpoint_frequency=100,
        async_save=async_save,
        registry=tobs.MetricsRegistry()).fit(_iter(PORT, x, y))
    net = _net(PORT, seed=13)
    ph = tfail.PreemptionHandler(registry=tobs.MetricsRegistry())
    tr = tfail.FaultTolerantTrainer(
        net, str(tmp_path / "pre"), checkpoint_frequency=2,
        fault_injector=tfail.FaultInjector(preempt_at=[4]),
        preemption=ph, async_save=async_save,
        registry=tobs.MetricsRegistry())
    assert tr.fit(_iter(PORT, x, y)) is False
    assert tr.manager.latest_step() == 4 and tr.manager.verify_step(4)
    resumed = _net(PORT, seed=99)                # other weights: restored
    tr2 = tfail.FaultTolerantTrainer(
        resumed, str(tmp_path / "pre"), checkpoint_frequency=2,
        async_save=async_save, registry=tobs.MetricsRegistry())
    assert tr2.fit(_iter(PORT, x[64:], y[64:])) is True
    assert resumed.iteration_count == plain.iteration_count == 6
    for attr in ("params", "updater_state"):
        a = getattr(resumed, attr)
        b = getattr(plain, attr)
        for layer in b:
            for k in b[layer]:
                got, want = a[layer][k], b[layer][k]
                if isinstance(want, dict):
                    for s in want:
                        assert torch.equal(got[s], want[s]), (attr, k, s)
                else:
                    assert torch.equal(got, want), (attr, layer, k)
    assert tr2.manager.all_steps()[-1] == 6


@pytest.mark.skipif(os.name != "posix",
                    reason="raise_signal/SIGTERM semantics need posix")
def test_real_sigterm_checkpoints_and_stops(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")

    def run(pkg, d):
        x, y = _data(96, seed=12)
        net = _net(pkg, seed=13)
        it = _SignalingIterator(_iter(pkg, x, y))
        with pkg.fail.PreemptionHandler(
                registry=pkg.obs.MetricsRegistry()) as ph:
            installed = ph.installed
            tr = pkg.fail.FaultTolerantTrainer(
                net, d, checkpoint_frequency=100, use_orbax=False,
                preemption=ph, registry=pkg.obs.MetricsRegistry())
            first = tr.fit(it, epochs=2)
            stop = net.iteration_count
            latest = tr.manager.latest_step()
            ph.clear()
            second = tr.fit(_iter(pkg, x, y), epochs=1)
        return dict(installed=installed, first=first, second=second,
                    signals=ph.signals_seen, stop=stop, latest=latest,
                    uninstalled=not ph.installed,
                    iters=net.iteration_count, params=_flat(net))
    rj, rt = _both(run, tmp_path)
    assert rt["first"] is False and rt["signals"] == 1
    _same(rj, rt)


class _SignalingIterator:
    """Raises a real SIGTERM in-process on batch 3."""

    def __init__(self, inner):
        self.inner = inner
        self.count = 0

    def __iter__(self):
        for b in self.inner:
            self.count += 1
            if self.count == 3:
                signal.raise_signal(signal.SIGTERM)
            yield b

    def reset(self):
        self.inner.reset()


def test_preemption_handler_flag_only_off_main_thread():
    ph = tfail.PreemptionHandler(registry=tobs.MetricsRegistry())
    out = {}
    t = threading.Thread(target=lambda: out.update(handler=ph.install()))
    t.start()
    t.join()
    assert out["handler"] is ph and not ph.installed
    ph.request_stop()
    assert ph.stop_requested()
    ph.clear()
    assert not ph.stop_requested()


def test_watchdog_flags_step_exceeding_deadline():
    hung = []
    reg = tobs.MetricsRegistry()
    wd = tfail.StepWatchdog(0.05, on_hung=lambda i, e: hung.append(i),
                            registry=reg).start()
    try:
        wd.arm(7)
        time.sleep(0.2)
        wd.disarm()
    finally:
        wd.stop()
    assert wd.hung_iterations == [7] and hung == [7]
    assert reg.get("watchdog_hung_steps_total").value == 1
    assert reg.get("watchdog_step_deadline_seconds").value == 0.05
    quiet = tfail.StepWatchdog(0.5, poll_s=0.01,
                               registry=tobs.MetricsRegistry()).start()
    try:
        for i in range(5):
            quiet.arm(i)
            time.sleep(0.01)
            quiet.disarm()
    finally:
        quiet.stop()
    assert quiet.hung_iterations == []
    with pytest.raises(ValueError, match="deadline_s"):
        tfail.StepWatchdog(0)


def test_watchdog_injected_clock_escalates_typed_timeout():
    now = [100.0]
    escalated = []
    wd = tfail.StepWatchdog(5.0, clock=lambda: now[0],
                            escalate=escalated.append,
                            registry=tobs.MetricsRegistry())
    wd.arm(3)
    now[0] = 104.9
    assert wd.check() is None and escalated == []
    now[0] = 105.5
    t = wd.check()
    assert isinstance(t, tguard.StepTimeout)
    assert t.iteration == 3 and t.deadline_s == 5.0
    assert t.elapsed_s == pytest.approx(5.5)
    assert escalated == [t] and wd.timeouts == [t]
    now[0] = 200.0
    assert wd.check() is None and len(escalated) == 1
    wd.arm(4)
    now[0] = 206.0
    assert wd.check().iteration == 4
    assert wd.hung_iterations == [3, 4]
    wd.arm(5)
    wd.disarm()
    now[0] = 999.0
    assert wd.check() is None


@pytest.mark.skipif(os.name != "posix",
                    reason="raise_signal/SIGTERM semantics need posix")
def test_sigterm_during_inflight_async_write_drains_before_publish(
        tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers need the main thread")

    def run(pkg, d):
        x, y = _data(96, seed=14)
        net = _net(pkg, seed=15)
        inj = pkg.fail.FaultInjector(write_delay_s=0.2)
        reg = pkg.obs.MetricsRegistry()
        with pkg.fail.PreemptionHandler(registry=reg) as ph:
            tr = pkg.fail.FaultTolerantTrainer(
                net, d, checkpoint_frequency=2, fault_injector=inj,
                use_orbax=False, async_save=True, preemption=ph,
                registry=reg)
            first = tr.fit(_SignalingIterator(_iter(pkg, x, y)), epochs=2)
            stop = net.iteration_count
            mgr = tr.manager
            rec = dict(first=first, preempted=tr.preempted,
                       signals=ph.signals_seen,
                       inflight=mgr._inflight is None,
                       latest=mgr.latest_step() == stop,
                       verified=mgr.verify_step(stop),
                       staging=len(list(
                           __import__("pathlib").Path(d).glob(
                               "step_*.tmp"))),
                       pending=reg.get("checkpoint_async_pending").value,
                       async_saves=reg.get(
                           "checkpoint_saves_total").labels(
                               "async").value)
            ph.clear()
            rec["second"] = tr.fit(_iter(pkg, x, y), epochs=1)
            rec["iters"] = net.iteration_count
            rec["params"] = _flat(net)
        return rec
    rj, rt = _both(run, tmp_path)
    assert rt["first"] is False and rt["inflight"] and rt["verified"]
    assert rt["pending"] == 0 and rt["staging"] == 0
    _same(rj, rt)


def test_trainer_arms_watchdog_around_steps(tmp_path):
    x, y = _data(32)
    net = _net(PORT)
    tr = tfail.FaultTolerantTrainer(net, str(tmp_path / "ckpt"),
                                    checkpoint_frequency=100,
                                    use_orbax=False, step_deadline_s=30.0,
                                    registry=tobs.MetricsRegistry())
    assert tr.fit(_iter(PORT, x, y), epochs=1) is True


def test_spaced_transient_faults_do_not_exhaust_budget(tmp_path):
    def run(pkg, d):
        x, y = _data(96, seed=14)
        inj = pkg.fail.FaultInjector(fail_at=[2, 5, 9])
        net = _net(pkg, seed=15)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, checkpoint_frequency=2, max_restarts=2,
            fault_injector=inj, use_orbax=False,
            registry=pkg.obs.MetricsRegistry())
        assert tr.fit(_iter(pkg, x, y), epochs=2) is True
        return dict(injected=inj.injected, restarts=tr.restarts,
                    consecutive=tr.consecutive_failures,
                    iters=net.iteration_count,
                    steps=tr.manager.all_steps(), params=_flat(net))
    rj, rt = _both(run, tmp_path)
    assert rt["injected"] == rt["restarts"] == 3
    _same(rj, rt)


def test_persistent_fault_still_exhausts_consecutive_budget(tmp_path):
    def run(pkg, d):
        x, y = _data(32)
        net = _net(pkg)
        inj = pkg.fail.FaultInjector(fail_at=[1], persistent=True)
        tr = pkg.fail.FaultTolerantTrainer(
            net, d, max_restarts=2, fault_injector=inj, use_orbax=False,
            registry=pkg.obs.MetricsRegistry())
        with pytest.raises(RuntimeError):
            tr.fit(_iter(pkg, x, y))
        return dict(consecutive=tr.consecutive_failures,
                    restarts=tr.restarts, iters=net.iteration_count)
    rj, rt = _both(run, tmp_path)
    assert rt["consecutive"] == 3
    _same(rj, rt)


def test_async_checkpoint_manager_surfaces_writer_error(tmp_path):
    """An async write that dies on its thread surfaces at the next save
    (and the pending gauge is back to 0); a graph checkpoints too."""
    from deeplearning4j_tpu_torch.util.checkpointing import \
        CheckpointManager
    reg = tobs.MetricsRegistry()
    mgr = CheckpointManager(tmp_path / "c", async_save=True,
                            fault_injector=tfail.FaultInjector(
                                crash_write_at=[1]),
                            registry=reg)
    net = _net(PORT)
    net.iteration_count = 1
    mgr.save(net)
    mgr._await_inflight()
    assert reg.get("checkpoint_async_pending").value == 0
    net.iteration_count = 2
    with pytest.raises(RuntimeError, match="previous async checkpoint"):
        mgr.save(net)
    mgr.save(net)
    mgr.wait()
    assert mgr.all_steps() == [2] and mgr.verify_step(2)
    # the snapshot is taken before save() returns: a later change to
    # the tree does not reach the written step
    before = net.params["layer_0"]["W"].clone()
    net.iteration_count = 3
    mgr.save(net)
    net.params["layer_0"]["W"].add_(1.0)
    mgr.wait()
    back = _net(PORT)
    assert mgr.restore(back, step=3) == 3
    assert torch.equal(back.params["layer_0"]["W"], before)

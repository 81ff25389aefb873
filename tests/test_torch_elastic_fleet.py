"""The port's elastic coordinator over REAL worker processes
(deeplearning4j_tpu_torch/train/elastic_worker.py) on the CPU: the
counterparts of JAX's four process tests (tests/test_elastic_training.py
:179-330), each held BIT-EXACT to the port's own membership-free
`reference_run` wherever JAX holds its run to its own oracle:

- SIGKILL one of three workers at step 3, a replacement at step 5;
- shrink 3→2 then grow 2→3 through `remove_worker` / `add_worker`
  (JAX's drives the same trajectory with kill / join knobs; both are
  run);
- a slowed worker drops to loose sync and resyncs, zero lost steps;
- a SIGSTOPped worker is evicted and the checkpoint replay restores
  exactness.

Also: the flight recorder's typed actions, each worker's `state_bytes`
against the analytic 1/N shard, every hello's ``jax_loaded`` false and
CPU device, `ElasticTrainingMaster.fit` ≡ the oracle, and a worker
asked for ``"cuda"`` where there is none exits with its error instead
of running on the CPU. The loose-sync timings keep JAX's ratios
(step_timeout 0.15 s against a 0.5 s slowdown). Workers compute with
one intra-op thread (``OMP_NUM_THREADS=1`` in their environment);
every blocking wait is bounded and `helpers.child_killing_watchdog`
kills the workers if a test wedges.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from helpers import child_killing_watchdog  # noqa: E402

from deeplearning4j_tpu_torch.models.transformer import \
    TransformerConfig  # noqa: E402
from deeplearning4j_tpu_torch.observability.events import \
    FlightRecorder  # noqa: E402
from deeplearning4j_tpu_torch.observability.metrics import \
    MetricsRegistry  # noqa: E402
from deeplearning4j_tpu_torch.parallel.failure import \
    ElasticFaultInjector  # noqa: E402
from deeplearning4j_tpu_torch.parallel.fsdp import \
    zero1_partition  # noqa: E402
from deeplearning4j_tpu_torch.train.elastic import (  # noqa: E402
    ElasticConfig, ElasticCoordinator, _WorkerProc, reference_run)

CFG = TransformerConfig(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                        max_len=16)
HARD_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _ecfg(tmp_path, **kw):
    base = dict(checkpoint_dir=str(tmp_path / "ckpt"), num_workers=3,
                microbatches_per_step=6, microbatch_size=2, seq_len=8,
                checkpoint_every=1)
    base.update(kw)
    return ElasticConfig(**base)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The membership-free run every strict arm is held to (the data,
    microbatches and Adam knobs are those of `_ecfg`; checkpointing and
    timing knobs do not enter it)."""
    d = tmp_path_factory.mktemp("oracle")
    return reference_run(CFG, _ecfg(d), 8, device="cpu")


def _coordinator(tmp_path, register, injector=None, registry=None,
                 recorder=None, **kw):
    co = ElasticCoordinator(CFG, _ecfg(tmp_path, **kw),
                            fault_injector=injector, registry=registry,
                            recorder=recorder, device="cpu")
    register(co)
    return co


def _acts(rec):
    return [e.data.get("action") for e in rec.recent(kind="elastic")]


def _analytic_state_bytes(n, k):
    return sorted(3 * 4 * (hi - lo) for lo, hi in zero1_partition(n, k))


def _pongs(co, timeout_s=30.0):
    for w in co.workers.values():
        w.send({"op": "ping"})
    out = {}
    deadline = time.perf_counter() + timeout_s
    while len(out) < len(co.workers) and time.perf_counter() < deadline:
        for wid, w in co.workers.items():
            m = w.take(lambda x: x.get("ev") == "pong")
            if m is not None:
                out[wid] = m
        time.sleep(0.01)
    assert len(out) == len(co.workers)
    return out


@pytest.mark.multiproc
def test_kill_and_rejoin_bit_reproducible(tmp_path, oracle):
    rec = FlightRecorder(capacity=256)
    with child_killing_watchdog(HARD_TIMEOUT_S) as register:
        co = _coordinator(
            tmp_path, register, recorder=rec, checkpoint_every=2,
            injector=ElasticFaultInjector(kill_at={3: 1}, join_at={5: 3}))
        with co:
            out = co.run(8)
            pongs = _pongs(co)
            hellos = {wid: w.hello for wid, w in co.workers.items()}
            # the killed worker's pipe writer ended with it
            writers = sorted(t.name for t in threading.enumerate()
                             if t.name.startswith("elastic-writer-"))
    assert writers == [f"elastic-writer-{w}" for w in sorted(hellos)]
    assert out["losses"] == oracle["losses"]
    assert np.array_equal(out["params"], oracle["params"])
    assert out["workers"] == 3 and out["resizes"] == 2
    assert out["replayed_steps"] > 0
    acts = _acts(rec)
    assert "kill_detected" in acts and "replay" in acts
    assert acts.count("resize") == 2 and acts.count("join") == 4
    n = out["n_params"]
    assert sorted(out["worker_state_bytes"].values()) == \
        _analytic_state_bytes(n, 3)
    assert sum(out["worker_state_bytes"].values()) == 3 * 4 * n
    assert sorted(hellos) == [0, 2, 3]
    for wid, h in hellos.items():
        assert h["jax_loaded"] is False and h["device"] == "cpu"
        assert h["worker"] == wid and h["kernels"]["nvcc_runs"] == {}
        # the same shard bytes from the worker's own tensors; the CPU
        # runs the plain twins, so no flash kernel launched
        assert pongs[wid]["state_bytes"] == out["worker_state_bytes"][wid]
        assert pongs[wid]["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
        assert pongs[wid]["grad_calls"] >= 1
    # the coordinator's side of the wire was counted
    assert co.wire["sent_bytes"] > 0 and co.wire["recv_bytes"] > 0


@pytest.mark.multiproc
@pytest.mark.parametrize("how", ["injector", "remove_add"])
def test_shrink_then_grow_bit_reproducible(tmp_path, oracle, how):
    """Shrink 3→2 then grow 2→3: resharding is a pure function of the
    membership's size, so the trajectory stays bit-equal to the
    oracle."""
    with child_killing_watchdog(HARD_TIMEOUT_S) as register:
        if how == "injector":
            co = _coordinator(tmp_path, register,
                              injector=ElasticFaultInjector(
                                  kill_at={2: 0}, join_at={5: 9}))
            with co:
                out = co.run(8)
        else:
            co = _coordinator(tmp_path, register)
            with co:
                co.run(2)
                co.remove_worker(0)
                co.run(5)
                assert len(co.workers) == 2
                co.add_worker(9)
                out = co.run(8)
    assert out["losses"] == oracle["losses"]
    assert np.array_equal(out["params"], oracle["params"])
    assert out["workers"] == 3 and out["resizes"] == 2
    assert sorted(out["worker_state_bytes"].values()) == \
        _analytic_state_bytes(out["n_params"], 3)


@pytest.mark.multiproc
def test_loose_sync_engages_and_recovers(tmp_path):
    rec = FlightRecorder(capacity=256)
    reg = MetricsRegistry()
    with child_killing_watchdog(HARD_TIMEOUT_S) as register:
        co = _coordinator(
            tmp_path, register, recorder=rec, registry=reg,
            injector=ElasticFaultInjector(
                slow_at={2: (1, 0.5), 6: (1, 0.0)}),
            step_timeout_s=0.15, sync_every=1, stale_bound=30)
        with co:
            out = co.run(10)
    acts = _acts(rec)
    assert "loose_enter" in acts and "resync" in acts
    assert acts.index("loose_enter") < acts.index("resync")
    assert "evict" not in acts
    assert len(out["losses"]) == 10          # zero lost steps
    assert np.isfinite(out["final_loss"])
    assert out["workers"] == 3
    assert reg.get("training_elastic_stale_steps_total").value > 0
    assert reg.get("training_elastic_workers").value == 3


@pytest.mark.multiproc
def test_hang_evicts_and_restores_bit_exactness(tmp_path, oracle):
    rec = FlightRecorder(capacity=256)
    with child_killing_watchdog(HARD_TIMEOUT_S) as register:
        co = _coordinator(
            tmp_path, register, recorder=rec,
            injector=ElasticFaultInjector(hang_at={3: 2}),
            step_timeout_s=0.15, sync_every=1, stale_bound=2)
        with co:
            out = co.run(8)
            debug = co.debugz()
    assert out["losses"] == oracle["losses"]
    assert np.array_equal(out["params"], oracle["params"])
    assert out["workers"] == 2 and out["replayed_steps"] > 0
    acts = _acts(rec)
    assert acts.count("evict") == 1
    assert "replay" in acts
    assert debug["workers"] == [0, 1] and debug["loose"] == []
    assert sorted(out["worker_state_bytes"].values()) == \
        _analytic_state_bytes(out["n_params"], 2)


@pytest.mark.multiproc
def test_elastic_training_master_fit_is_the_oracle(tmp_path, oracle):
    from deeplearning4j_tpu_torch.scaleout.training_master import \
        ElasticTrainingMaster
    tm = (ElasticTrainingMaster.Builder(str(tmp_path / "tm"))
          .workers(3).microbatches_per_step(6).microbatch_size(2)
          .build())
    tm.seq_len = 8
    tm.device = "cpu"
    with pytest.raises(NotImplementedError):
        tm.configure(None)
    out = tm.fit(CFG, 8)
    assert out["losses"] == oracle["losses"]
    assert np.array_equal(out["params"], oracle["params"])
    assert out["workers"] == 3 and out["resizes"] == 0
    with pytest.raises(ValueError, match="checkpoint_dir"):
        ElasticTrainingMaster().elastic_config()


@pytest.mark.multiproc
def test_worker_asked_for_cuda_without_one_exits(tmp_path):
    """No CPU fallback: a worker whose spec names the card, on a machine
    without one, exits with its error before its hello."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    co = ElasticCoordinator(CFG, _ecfg(tmp_path), device="cpu")
    spec = co._worker_spec(0)
    spec["device"] = "cuda"
    w = _WorkerProc(0, spec)
    try:
        with pytest.raises(RuntimeError, match="died during startup") as e:
            w.wait_hello(120.0)
        assert "CUDA" in str(e.value)
        assert w.proc.returncode != 0 and not w.hello
    finally:
        w.kill()

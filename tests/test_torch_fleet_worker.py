"""The port's fleet across a real process boundary, on the CPU.

`SubprocessReplica` spawns ``python -m
deeplearning4j_tpu_torch.serving.fleet_worker`` (the reference's pipe
protocol, key for key; tests/test_serving_fleet.py:635-707 is the
reference's version of these tests). Every spec says ``"device": "cpu"``:
a worker without it runs on the card, and raises where there is none.
Four workers start at once for the module (two plain, two paged) and
every test is hard-bounded by `helpers.child_killing_watchdog`, which
SIGKILLs them if it fires; they are closed at the end either way.

- Served over the pipe and probed over real HTTP, the results equal an
  in-process port engine built from the same seed; the hello reports the
  device and that ``jax`` is not in the worker's ``sys.modules``.
- A tiered router over a subprocess prefill tier and a subprocess decode
  tier moves every handoff as a kvwire frame through the pipes
  (``serving_kvwire_frames{direction,outcome}``, bytes counted), token-
  equal to one paged engine.
- SIGSTOP (a hang) is detected by the no-progress detector and failed
  over; SIGKILL mid-decode fails over from the last streamed committed
  prefix, token-exact, and under ``max_restarts=0`` the dead replica
  stays dead.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    EngineConfig, FleetConfig, InferenceEngine, Router, SubprocessReplica,
    TieredRouter)
from helpers import child_killing_watchdog  # noqa: E402
from torch_fleet_helpers import FIELDS, prompt  # noqa: E402

#: Hard wall for anything that could block on a child process.
HARD_TIMEOUT_S = 150.0
ENGINE = dict(decode_chunk=2, max_new_tokens=12, backoff_base_s=0.0,
              max_batch_size=2)
PAGED = dict(ENGINE, paged=True, page_size=4)
SPEC = {"cfg": FIELDS, "engine": ENGINE, "params_seed": 0,
        "progress_interval_s": 0.01, "device": "cpu"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_all(specs):
    """Start every worker at once (each start is a torch import)."""
    out, errs = [None] * len(specs), []

    def start(i, spec):
        try:
            out[i] = SubprocessReplica(i, spec,
                                       startup_timeout_s=HARD_TIMEOUT_S)
        except Exception as e:       # reported below, after the joins
            errs.append(e)
    ts = [threading.Thread(target=start, args=(i, s))
          for i, s in enumerate(specs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(HARD_TIMEOUT_S)
    return out, errs


@pytest.fixture(scope="module")
def workers():
    with child_killing_watchdog(4 * HARD_TIMEOUT_S) as register:
        reps, errs = _spawn_all([SPEC, SPEC, dict(SPEC, engine=PAGED),
                                 dict(SPEC, engine=PAGED)])
        for rep in reps:
            if rep is not None:
                register(rep)
        assert not errs, errs
        yield reps


@pytest.fixture(scope="module")
def want():
    """In-process port engines from the same seed: the oracle."""
    cfg = ttf.TransformerConfig(**FIELDS)
    params = ttf.init_params(cfg, 0, device="cpu")
    out = {}
    for name, ec in (("plain", ENGINE), ("paged", PAGED)):
        eng = InferenceEngine(cfg, params, EngineConfig(**ec),
                              device="cpu")
        res = []
        for i in range(4):
            h = eng.submit(prompt(8, i), max_new_tokens=12)
            eng.run_pending()
            res.append(h.result(0))
        out[name] = res
    return out


def _bounded(r, what):
    deadline = time.monotonic() + HARD_TIMEOUT_S / 2
    while r.pending():
        assert time.monotonic() < deadline, f"{what}: fleet did not drain"
        if not r.tick():
            time.sleep(0.002)


@pytest.mark.multiproc
def test_subprocess_fleet_serves_and_probes_over_http(workers, want):
    reps = workers[:2]
    for rep in reps:
        assert rep.hello["jax_loaded"] is False
        assert rep.hello["device"] == "cpu"
        assert rep.hello["kernels"]["nvcc_runs"] == {}
        assert rep.wire_version == 1 and rep.capacity == 2
    r = Router(replicas=reps,
               config=FleetConfig(max_restarts=0, hang_min_s=30.0))
    hs = [r.submit(prompt(8, i), max_new_tokens=12) for i in range(4)]
    _bounded(r, "serve")
    for h, w in zip(hs, want["plain"]):
        np.testing.assert_array_equal(h.result(0), w)
    body = reps[0].probe()
    assert body["ready"] is True and body["num_slots"] == 2
    assert all(row["kind"] == "subprocess"
               for row in r.debugz()["replicas"])
    # the federated scrape: counters summed across the workers' own
    # /metrics.json, gauges kept per replica
    snap = r.federate()
    assert sum(s["value"] for s in
               snap["serving_requests_completed"]["samples"]) == 4
    assert {str(s["labels"].get("replica")) for s in
            snap["serving_kv_pool_bytes"]["samples"]} == {"0", "1"}


@pytest.mark.multiproc
def test_cross_process_tiered_handoff_over_kvwire(workers, want):
    r = TieredRouter(replicas=workers[2:], tiers=["prefill", "decode"])
    hs = [r.submit(prompt(8, i), max_new_tokens=12) for i in range(4)]
    _bounded(r, "tiered")
    for h, w in zip(hs, want["paged"]):
        np.testing.assert_array_equal(h.result(0), w)
        kinds = [(e.data.get("direction"), e.data.get("outcome"))
                 for e in h.trace.events if e.kind == "kvwire"]
        assert kinds == [("export", "ok"), ("adopt", "ok")]
    assert r.stats["handoffs_ok"] == 4
    m = r._kvwire_metrics()
    assert m["frames"].labels("export", "ok").value == 4
    assert m["frames"].labels("adopt", "ok").value == 4
    assert m["bytes"].value > 0
    assert workers[2].held_handles() == []


@pytest.mark.multiproc
def test_subprocess_sigstop_hang_detected(workers, want):
    """SIGSTOP freezes a worker mid-decode: probes time out and the pipe
    goes silent; the no-progress detector declares it hung, SIGKILLs it
    and fails its requests over to the other worker, token-exact.
    ``hang_min_s`` stays above a live worker's longest quiet spell (the
    first call of a new prefill shape on a loaded CPU took ~0.5 s)."""
    reps = workers[2:]
    r = Router(replicas=reps,
               config=FleetConfig(max_restarts=0, hang_ticks=2,
                                  hang_min_s=3.0))
    hs = [r.submit(prompt(8, i), max_new_tokens=12) for i in range(4)]
    deadline = time.monotonic() + HARD_TIMEOUT_S / 2
    while not any(row["replica"] == 3 and row["outstanding"] > 0
                  for row in r.debugz()["replicas"]):
        assert time.monotonic() < deadline
        r.tick()
    reps[1].set_hung(True)
    _bounded(r, "hang")
    for h, w in zip(hs, want["paged"]):
        np.testing.assert_array_equal(h.result(0), w)
    assert r.stats["failovers"] >= 1
    assert {row["replica"]: row["state"]
            for row in r.debugz()["replicas"]}[3] == "dead"
    assert not reps[1].alive()


@pytest.mark.multiproc
def test_subprocess_sigkill_failover_token_exact(workers, want):
    reps = workers[:2]
    r = Router(replicas=reps,
               config=FleetConfig(max_restarts=0, hang_min_s=30.0))
    hs = [r.submit(prompt(8, i), max_new_tokens=12) for i in range(4)]
    deadline = time.monotonic() + HARD_TIMEOUT_S / 2
    while not any(row["replica"] == 0 and row["outstanding"] > 0
                  for row in r.debugz()["replicas"]):
        assert time.monotonic() < deadline
        r.tick()
    reps[0].kill()
    _bounded(r, "sigkill")
    assert [h.status for h in hs] == ["completed"] * 4
    for h, w in zip(hs, want["plain"]):
        np.testing.assert_array_equal(h.result(0), w)
    assert r.stats["failovers"] >= 1
    for _ in range(5):
        r.tick()
    assert {row["replica"]: row["state"]
            for row in r.debugz()["replicas"]}[0] == "dead"
    r.close()


@pytest.mark.multiproc
def test_worker_without_device_does_not_fall_back_to_cpu():
    """No ``"device"`` means the card: with no card the parent refuses
    the spec before spawning, and a worker started by hand exits with
    the engine's error instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = {k: v for k, v in SPEC.items() if k != "device"}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubprocessReplica(0, spec, startup_timeout_s=30.0)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m",
         "deeplearning4j_tpu_torch.serving.fleet_worker"],
        input=json.dumps(spec) + "\n", capture_output=True, text=True,
        env=env, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ev": "hello"' not in proc.stdout

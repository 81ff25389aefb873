"""Training listeners (port of deeplearning4j_tpu/train/listeners.py).

The same listeners, hooks and metric names as the JAX package. They run
on the host between steps and receive the step's score (a float, or a
0-d tensor on the device where the network does not read it back: a
listener that needs the number calls ``float`` on it). `ProfilerListener`
writes a `torch.profiler` trace (Chrome trace JSON) where JAX wrote a
`jax.profiler` one.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.observability.metrics import default_registry

log = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    def iteration_done(self, model, iteration: int, score: float) -> None:
        raise NotImplementedError

    # TrainingListener extension points (reference TrainingListener.java)
    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass

    def on_forward_pass(self, model, activations) -> None:
        pass

    def on_gradient_calculation(self, model) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Log score every N iterations (reference:
    ScoreIterationListener.java) AND publish it: every call sets the
    `training_score` gauge in the metrics registry (process default
    unless injected), so the score series is scrapeable at /metrics
    instead of only greppable from stdout."""

    def __init__(self, print_iterations: int = 10, registry=None):
        self.print_iterations = max(1, print_iterations)
        reg = registry if registry is not None else default_registry()
        self._m_score = reg.gauge(
            "training_score", "Last score a training listener saw")

    def iteration_done(self, model, iteration, score):
        self._m_score.set(float(score))
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, score)


class PerformanceListener(IterationListener):
    """Samples/sec + batches/sec (reference: PerformanceListener.java),
    published to the metrics registry as well as the log: per-call
    `training_iterations` / `training_samples` counters, and
    `training_samples_per_second` / `training_batches_per_second`
    gauges refreshed each time a reporting window closes."""

    def __init__(self, frequency: int = 1, report: bool = True,
                 registry=None):
        self.frequency = max(1, frequency)
        self.report = report
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self._samples_since = 0
        self.last_samples_per_sec = 0.0
        self.last_batches_per_sec = 0.0
        reg = registry if registry is not None else default_registry()
        self._m_iterations = reg.counter(
            "training_iterations", "Iterations seen by "
            "PerformanceListener (serving: batches)")
        self._m_samples = reg.counter(
            "training_samples", "Samples counted via record_batch")
        self._m_samples_rate = reg.gauge(
            "training_samples_per_second",
            "Throughput over the last reporting window")
        self._m_batches_rate = reg.gauge(
            "training_batches_per_second",
            "Batch rate over the last reporting window")

    def record_batch(self, batch_size: int):
        self._samples_since += batch_size
        self._m_samples.inc(batch_size)

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        self._m_iterations.inc()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0
            return
        if (iteration - self._last_iter) >= self.frequency:
            dt = now - self._last_time
            batches = iteration - self._last_iter
            self.last_batches_per_sec = batches / dt if dt > 0 else 0.0
            self.last_samples_per_sec = (self._samples_since / dt
                                         if dt > 0 else 0.0)
            self._m_samples_rate.set(self.last_samples_per_sec)
            self._m_batches_rate.set(self.last_batches_per_sec)
            if self.report:
                log.info("iteration %d: %.1f samples/sec, %.2f batches/sec, "
                         "score %s", iteration, self.last_samples_per_sec,
                         self.last_batches_per_sec, score)
            self._last_time = now
            self._last_iter = iteration
            self._samples_since = 0


class CollectScoresIterationListener(IterationListener):
    """Store (iteration, score) pairs (reference:
    CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, score):
        for l in self.listeners:
            l.iteration_done(model, iteration, score)


class ProfilerListener(IterationListener):
    """Capture a `torch.profiler` trace (CPU and, where there is one, CUDA
    activity) for a window of iterations; it is written to
    ``<log_dir>/trace_<start>.json``, which chrome://tracing and Perfetto
    open."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 num_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.stop_iteration = start_iteration + num_iterations
        self._active = False
        self._prof = None
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration, score):
        import os

        import torch
        if iteration == self.start_iteration and not self._active:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._active = True
            log.info("profiler trace started → %s", self.log_dir)
        elif iteration >= self.stop_iteration and self._active:
            self._prof.__exit__(None, None, None)
            self._active = False
            os.makedirs(self.log_dir, exist_ok=True)
            self.trace_path = os.path.join(
                self.log_dir, f"trace_{self.start_iteration}.json")
            self._prof.export_chrome_trace(self.trace_path)
            log.info("profiler trace stopped")


class NanScoreGuardListener(IterationListener):
    """Raise (or warn) on NaN/Inf scores — the divergence tripwire
    (SURVEY.md §5.2: the reference's numerics safety net is offline
    gradient checks plus InvalidScoreIterationTerminationCondition; this
    is the always-on in-loop variant)."""

    def __init__(self, raise_on_invalid: bool = True):
        self.raise_on_invalid = raise_on_invalid
        self.tripped_at: Optional[int] = None

    def iteration_done(self, model, iteration, score):
        import math
        if math.isnan(score) or math.isinf(score):
            self.tripped_at = iteration
            msg = (f"invalid score {score} at iteration {iteration} — "
                   "training diverged")
            if self.raise_on_invalid:
                raise FloatingPointError(msg)
            log.warning(msg)


class EngineHealthListener(IterationListener):
    """Serving-side health telemetry riding the standard listener
    protocol: `serving.InferenceEngine.set_listeners()` calls
    `iteration_done(engine, batch_index, batch_latency_s)` after every
    batch, so the whole training listener suite (PerformanceListener
    gets batches/sec via `record_batch`, CollectScores collects
    latencies) works on the serving path unchanged. This listener
    additionally snapshots `engine.health()` — breaker state, queue
    depth, shed/quarantine counters, weights version — into a bounded
    ring so an operator (or test) can audit degradation windows."""

    def __init__(self, frequency: int = 1, capacity: int = 256):
        self.frequency = max(1, frequency)
        self.capacity = max(1, capacity)
        self.snapshots: List[dict] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency != 0:
            return
        snap = {"iteration": int(iteration),
                "latency_s": float(score)}
        if hasattr(model, "health"):
            snap.update(model.health())
        self.snapshots.append(snap)
        del self.snapshots[:-self.capacity]


class ParamAndGradientIterationListener(IterationListener):
    """Per-iteration parameter and update statistics, tab-delimited to a
    file and/or the log (reference: optimize/listeners/
    ParamAndGradientIterationListener.java — writes mean magnitudes of
    params and gradients every N iterations).

    The gradient column reports the per-step parameter delta (update =
    -lr·transformed-gradient), as the JAX package's does. Columns:
    iteration, score, parameter |mean|, update |mean|, their ratio.
    """

    def __init__(self, iterations: int = 1,
                 file_path: Optional[str] = None,
                 print_to_log: bool = True,
                 print_header: bool = True,
                 print_mean: bool = True):
        self.iterations = max(1, iterations)
        self.file_path = file_path
        self.print_to_log = print_to_log
        self.print_header = print_header
        self.print_mean = print_mean
        self._prev_flat = None
        self._header_written = False

    def _write(self, line: str) -> None:
        if self.file_path:
            with open(self.file_path, "a") as f:
                f.write(line + "\n")
        if self.print_to_log:
            log.info("%s", line)

    def iteration_done(self, model, iteration, score):
        # _prev_flat refreshes EVERY iteration so that with
        # iterations=N the logged delta is the last single step, not an
        # N-step cumulative drift
        flat = model.params_flat()
        if iteration % self.iterations != 0:
            self._prev_flat = flat
            return
        if not self._header_written and self.print_header:
            self._write("iteration\tscore\tparamMeanAbs\tupdateMeanAbs"
                        "\tupdateParamRatio")
            self._header_written = True
        p_mean = float(flat.abs().mean())
        if self._prev_flat is not None \
                and self._prev_flat.shape == flat.shape:
            u_mean = float((flat - self._prev_flat).abs().mean())
        else:
            u_mean = float("nan")
        ratio = u_mean / p_mean if p_mean > 0 else float("nan")
        self._write(f"{iteration}\t{float(score):.6g}\t{p_mean:.6g}"
                    f"\t{u_mean:.6g}\t{ratio:.6g}")
        self._prev_flat = flat

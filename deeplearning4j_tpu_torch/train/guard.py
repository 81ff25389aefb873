"""Divergence guard for training loops (port of
deeplearning4j_tpu/train/guard.py; the same policy, counters and names).

The reference's numerics safety net is offline gradient checks plus
`InvalidScoreIterationTerminationCondition` (SURVEY.md §5.2) — both
blind to the failure mode that actually kills long runs: a restore
loop that happily re-diverges because nothing distinguishes "this
batch was bad" from "the trajectory is gone". `TrainingGuard` is the
in-loop policy:

- **Non-finite tripwire.** A NaN/Inf post-step score or global
  grad-norm is a bad step, always.
- **Spike detection.** A finite score more than ``spike_factor``×
  the exponential moving average (after ``warmup_steps`` accepted
  steps) is a bad step — the silent-divergence precursor a pure
  NaN check misses.
- **Escalation.** One bad step → SKIP (drop the update, keep going:
  transient bad batch). ``max_consecutive`` bad steps in a row →
  ROLLBACK (restore last checkpoint and back the learning rate off by
  ``lr_backoff`` — the trajectory itself is bad).

Integration points:

- `MultiLayerNetwork.set_training_guard(guard)` switches `fit` to a
  guarded train step that (a) also returns the global grad-norm,
  (b) discards non-finite updates on the device, and (c) keeps the
  pre-step tree, so a SKIP commits nothing.
- A caller's checkpoint policy catches the `DivergenceError` a
  ROLLBACK raises, restores the last checkpoint, and applies the LR
  backoff (`apply_lr_backoff`).
- `TrainingGuardListener` rides the plain listener stream for loops
  that don't use the guarded step: detect-and-abort only (a listener
  fires after the update is already applied, so it cannot skip).

Every decision lands in `training_guard_events_total{action=...}`.
"""
from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.train.listeners import IterationListener

log = logging.getLogger("deeplearning4j_tpu_torch")


class DivergenceError(RuntimeError):
    """Raised when the guard escalates to rollback: the current
    trajectory is diverging (K consecutive bad steps). RuntimeError
    subclass so checkpoint-restore wrappers
    catch it on their normal recovery path."""


@dataclass(frozen=True)
class StepTimeout:
    """Typed escalation payload from a step watchdog: one step exceeded
    its wall-clock deadline. Handed to
    the watchdog's ``escalate`` callback so policy layers (the elastic
    coordinator's loose-sync downgrade, a preemption handler's
    checkpoint-and-exit) can react to the *event*, not a log line.

    ``elapsed_s`` is measured at flag time — the step is still running
    (or wedged), so it only grows after this snapshot."""
    iteration: int
    deadline_s: float
    elapsed_s: float


class TrainingGuard:
    """Per-step accept/skip/rollback policy over (score, grad_norm).

    ``update()`` returns one of ACCEPT / SKIP / ROLLBACK; the caller
    owns the mechanics (discarding the update on SKIP, restoring a
    checkpoint on ROLLBACK). Scores are assumed to be losses
    (bounded below, positive in steady state) — the EMA spike test is
    one-sided."""

    ACCEPT = "accept"
    SKIP = "skip"
    ROLLBACK = "rollback"

    def __init__(self, ema_beta: float = 0.98,
                 spike_factor: float = 4.0,
                 warmup_steps: int = 10,
                 max_consecutive: int = 3,
                 lr_backoff: float = 0.5,
                 registry=None):
        if not 0.0 < ema_beta < 1.0:
            raise ValueError(f"ema_beta must be in (0, 1), got {ema_beta}")
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must exceed 1 (a spike is a "
                             f"score ABOVE trend), got {spike_factor}")
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError(f"lr_backoff must be in (0, 1], got "
                             f"{lr_backoff}")
        self.ema_beta = ema_beta
        self.spike_factor = spike_factor
        self.warmup_steps = max(0, int(warmup_steps))
        self.max_consecutive = max(1, int(max_consecutive))
        self.lr_backoff = lr_backoff
        self.score_ema: Optional[float] = None
        self.accepted_steps = 0
        self.consecutive_bad = 0
        self.rollbacks = 0
        self.last_reason: Optional[str] = None
        reg = registry if registry is not None else default_registry()
        self._m_events = reg.counter(
            "training_guard_events_total",
            "Guard decisions per action (accept/skip/rollback)",
            labelnames=("action",))
        self._m_ema = reg.gauge(
            "training_guard_score_ema",
            "Guard's EMA of accepted post-step scores")

    # ------------------------------------------------------------------
    def _is_bad(self, score: float, grad_norm: Optional[float]) -> \
            Optional[str]:
        if not math.isfinite(score):
            return "non_finite_score"
        if grad_norm is not None and not math.isfinite(grad_norm):
            return "non_finite_grad_norm"
        if (self.score_ema is not None
                and self.accepted_steps >= self.warmup_steps
                and self.score_ema > 0
                and score > self.spike_factor * self.score_ema):
            return "score_spike"
        return None

    def update(self, score: float,
               grad_norm: Optional[float] = None) -> str:
        """Judge one completed step; returns ACCEPT, SKIP or ROLLBACK.
        ROLLBACK resets the consecutive counter (the caller is about to
        restore a known-good trajectory) and arms the LR backoff."""
        reason = self._is_bad(float(score), None if grad_norm is None
                              else float(grad_norm))
        self.last_reason = reason
        if reason is None:
            self.consecutive_bad = 0
            self.accepted_steps += 1
            s = float(score)
            self.score_ema = (s if self.score_ema is None else
                              self.ema_beta * self.score_ema
                              + (1.0 - self.ema_beta) * s)
            self._m_ema.set(self.score_ema)
            self._m_events.labels(self.ACCEPT).inc()
            return self.ACCEPT
        self.consecutive_bad += 1
        if self.consecutive_bad >= self.max_consecutive:
            self.consecutive_bad = 0
            self.rollbacks += 1
            self._m_events.labels(self.ROLLBACK).inc()
            log.warning("guard: %d consecutive bad steps (%s) — "
                        "rollback #%d", self.max_consecutive, reason,
                        self.rollbacks)
            return self.ROLLBACK
        self._m_events.labels(self.SKIP).inc()
        log.warning("guard: bad step (%s, score=%s) — skipped "
                    "(%d/%d consecutive)", reason, score,
                    self.consecutive_bad, self.max_consecutive)
        return self.SKIP

    def apply_lr_backoff(self, net) -> float:
        """Scale the global learning rate down by ``lr_backoff`` (the
        eager step reads it each call). Returns the new LR. Called after a
        rollback restore; per-layer explicit LRs keep their absolute
        values (they opted out of the global rate)."""
        tc = net.conf.training
        tc.learning_rate *= self.lr_backoff
        log.warning("guard: learning rate backed off to %g",
                    tc.learning_rate)
        return tc.learning_rate


class TrainingGuardListener(IterationListener):
    """Guard policy on the plain listener stream (`net.set_listeners`):
    for fit loops that don't install the guarded step. A listener runs
    AFTER the update is applied, so SKIP degrades to detect-and-log;
    ROLLBACK raises DivergenceError (abort, or recover in an outer
    checkpoint-restoring wrapper)."""

    def __init__(self, guard: Optional[TrainingGuard] = None, **kw):
        self.guard = guard if guard is not None else TrainingGuard(**kw)

    def iteration_done(self, model, iteration, score):
        action = self.guard.update(float(score))
        if action == TrainingGuard.ROLLBACK:
            raise DivergenceError(
                f"training diverged at iteration {iteration}: "
                f"{self.guard.max_consecutive} consecutive bad steps "
                f"(last: {self.guard.last_reason}, score={score})")

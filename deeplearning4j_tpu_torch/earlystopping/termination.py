"""(Port of deeplearning4j_tpu/earlystopping/termination.py, the same code.)

Early-stopping termination conditions.

Parity with the reference (reference:
deeplearning4j-nn/.../earlystopping/termination/ — MaxEpochsTermination-
Condition, MaxTimeIterationTerminationCondition, ScoreImprovementEpoch-
TerminationCondition, BestScoreEpochTerminationCondition, MaxScoreIteration-
TerminationCondition, InvalidScoreIterationTerminationCondition).

Epoch conditions are consulted after each epoch's score calculation;
iteration conditions after every minibatch.
"""
from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    # conditions that only consult the epoch counter / wall clock set this
    # False so the trainer runs them even on epochs where no score was
    # computed (evaluate_every_n_epochs > 1)
    requires_score: bool = True

    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, last_score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    requires_score = False

    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs

    def __repr__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) score improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best_score = math.inf
        self.epochs_without = 0

    def initialize(self) -> None:
        self.best_score = math.inf
        self.epochs_without = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if self.best_score - score > self.min_improvement:
            self.best_score = score
            self.epochs_without = 0
            return False
        self.epochs_without += 1
        return self.epochs_without >= self.patience

    def __repr__(self):
        return (f"ScoreImprovementEpochTerminationCondition("
                f"{self.patience}, {self.min_improvement})")


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score reaches a target value."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.best_expected_score

    def __repr__(self):
        return (f"BestScoreEpochTerminationCondition("
                f"{self.best_expected_score})")


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_time_seconds: float):
        self.max_time_seconds = max_time_seconds
        self._start = None

    def initialize(self) -> None:
        self._start = time.monotonic()

    def terminate(self, last_score: float) -> bool:
        if self._start is None:
            self.initialize()
        return time.monotonic() - self._start >= self.max_time_seconds

    def __repr__(self):
        return (f"MaxTimeIterationTerminationCondition("
                f"{self.max_time_seconds}s)")


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate if the score explodes above a ceiling."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, last_score: float) -> bool:
        return last_score > self.max_score

    def __repr__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate on NaN/Inf score."""

    def terminate(self, last_score: float) -> bool:
        return math.isnan(last_score) or math.isinf(last_score)

    def __repr__(self):
        return "InvalidScoreIterationTerminationCondition()"

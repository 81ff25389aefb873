"""(Port of deeplearning4j_tpu/earlystopping/config.py, the same code.)

Early-stopping configuration + result.

Parity with the reference (reference:
deeplearning4j-nn/.../earlystopping/EarlyStoppingConfiguration.java,
EarlyStoppingResult.java).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.earlystopping.saver import (EarlyStoppingModelSaver,
                                                    InMemoryModelSaver)


@dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[Any] = field(default_factory=list)
    iteration_termination_conditions: List[Any] = field(default_factory=list)
    score_calculator: Optional[Any] = None
    model_saver: EarlyStoppingModelSaver = field(
        default_factory=InMemoryModelSaver)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1


@dataclass
class EarlyStoppingResult:
    termination_reason: str  # 'EpochTerminationCondition' |
    #                          'IterationTerminationCondition' | 'Error'
    termination_details: str
    score_vs_epoch: Dict[int, float]
    best_model_epoch: int
    best_model_score: float
    total_epochs: int
    best_model: Any

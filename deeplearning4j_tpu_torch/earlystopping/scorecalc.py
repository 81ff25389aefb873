"""(Port of deeplearning4j_tpu/earlystopping/scorecalc.py, the same code.)

Score calculators for early stopping.

Parity with the reference (reference:
deeplearning4j-nn/.../earlystopping/scorecalc/DataSetLossCalculator.java,
DataSetLossCalculatorCG.java): average model loss over a held-out iterator.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.nn.multilayer import _unpack_batch


class ScoreCalculator:
    def calculate_score(self, net) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Mean loss over an evaluation iterator, weighted by batch size."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        total = 0.0
        n = 0
        for batch in self.iterator:
            feats, labels, fmask, lmask = _unpack_batch(batch)
            batch_n = int(feats.shape[0])
            mask = lmask if lmask is not None else fmask
            total += net.score(feats, labels, mask) * batch_n
            n += batch_n
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        return total / n if (self.average and n) else total

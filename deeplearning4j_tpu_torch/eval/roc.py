"""ROC / AUC evaluation, binary and one-vs-all (port of
deeplearning4j_tpu/eval/roc.py): ``threshold_steps + 1`` evenly spaced
thresholds accumulate TP / FP / FN / TN counts per batch (one [S, N]
comparison on the predictions' device); AUC by the trapezoid rule over
the resulting curve.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.eval.evaluation import as_tensor, host_array

Tensor = torch.Tensor


def _counts_at_thresholds(labels: Tensor, probs: Tensor,
                          thresholds: Tensor):
    """labels / probs: [N]; thresholds: [S]. Returns (tp, fp, fn, tn)
    [S]."""
    pred = probs[None, :] >= thresholds[:, None]              # [S, N]
    pos = labels[None, :] > 0.5
    tp = (pred & pos).sum(1)
    fp = (pred & ~pos).sum(1)
    fn = (~pred & pos).sum(1)
    tn = (~pred & ~pos).sum(1)
    return tp, fp, fn, tn


class ROC:
    """Binary ROC. ``eval`` takes labels/probabilities for the positive
    class ([N] or [N, 1] or [N, 2] one-hot/softmax)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = threshold_steps
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        s = threshold_steps + 1
        self.tp = np.zeros(s, np.int64)
        self.fp = np.zeros(s, np.int64)
        self.fn = np.zeros(s, np.int64)
        self.tn = np.zeros(s, np.int64)

    def eval(self, labels, predictions, mask: Optional[np.ndarray] = None
             ) -> None:
        predictions = as_tensor(predictions)
        labels = as_tensor(labels, predictions.device)
        if predictions.ndim == 2 and predictions.shape[-1] == 2:
            predictions = predictions[:, 1]
            labels = labels[:, 1] if labels.ndim == 2 else labels
        labels = labels.reshape(-1)
        predictions = predictions.reshape(-1)
        if mask is not None:
            keep = as_tensor(mask, predictions.device).reshape(-1) > 0
            labels = labels[keep]
            predictions = predictions[keep]
        counts = _counts_at_thresholds(
            labels.float(), predictions.float(),
            torch.as_tensor(self.thresholds, dtype=torch.float32,
                            device=predictions.device))
        for acc, c in zip((self.tp, self.fp, self.fn, self.tn), counts):
            acc += host_array(c).astype(np.int64)

    def get_roc_curve(self):
        """Returns (fpr, tpr) arrays ordered by increasing threshold."""
        tpr = self.tp / np.maximum(self.tp + self.fn, 1)
        fpr = self.fp / np.maximum(self.fp + self.tn, 1)
        return fpr, tpr

    def get_precision_recall_curve(self):
        prec = self.tp / np.maximum(self.tp + self.fp, 1)
        rec = self.tp / np.maximum(self.tp + self.fn, 1)
        return rec, prec

    def calculate_auc(self) -> float:
        fpr, tpr = self.get_roc_curve()
        # sort by (fpr, tpr): ties in fpr must order by ascending tpr or
        # a (fpr_min, tpr=0) point (threshold above every probability)
        # lands next to (1, 1) and the trapezoid collapses toward 0.5
        # for perfectly-separated extreme probabilities
        order = np.lexsort((tpr, fpr))
        x = np.concatenate([[0.0], fpr[order], [1.0]])
        y = np.concatenate([[0.0], tpr[order], [1.0]])
        return float(np.trapezoid(y, x))


class ROCMultiClass:
    """One-vs-all ROC per class (reference: eval/ROCMultiClass.java)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = threshold_steps
        self.per_class: dict = {}

    def eval(self, labels, predictions, mask=None) -> None:
        labels = host_array(labels)
        predictions = host_array(predictions)
        c = predictions.shape[-1]
        for i in range(c):
            roc = self.per_class.setdefault(i, ROC(self.threshold_steps))
            lab = labels[:, i] if labels.ndim == 2 else (labels == i)
            roc.eval(lab.astype(np.float32), predictions[:, i], mask)

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        if not self.per_class:
            return 0.0
        return float(np.mean([r.calculate_auc()
                              for r in self.per_class.values()]))

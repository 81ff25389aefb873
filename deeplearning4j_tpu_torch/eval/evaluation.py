"""Classification evaluation: accuracy / precision / recall / F1, the
confusion matrix, top-N accuracy (port of
deeplearning4j_tpu/eval/evaluation.py).

A batch's confusion counts are one `torch.bincount` over
``actual * C + predicted`` on the predictions' device; only the small
[C, C] matrix lives on the host. `stats()` prints the JAX package's text.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def host_array(x) -> np.ndarray:
    """A numpy array of a tensor on any device (bfloat16 as float32) or
    of anything numpy takes."""
    if isinstance(x, Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device=None) -> Tensor:
    """A tensor of ``x`` (moved to ``device`` when given)."""
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


def _confusion_update(labels: Tensor, predictions: Tensor,
                      num_classes: int,
                      mask: Optional[Tensor] = None) -> Tensor:
    """A [C, C] confusion-count matrix for one batch (rows actual, cols
    predicted)."""
    idx = (labels * num_classes + predictions).reshape(-1)
    weights = None if mask is None else mask.reshape(-1).to(torch.float32)
    counts = torch.bincount(idx, weights=weights,
                            minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


class ConfusionMatrix:
    """Accumulating [actual, predicted] count matrix."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, batch_matrix) -> None:
        self.matrix += np.asarray(batch_matrix, dtype=np.int64)

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())


class Evaluation:
    """Accumulates classification metrics over batches."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.top_n_total = 0
        self.predictions: List = []  # Prediction records (eval/meta)

    # ------------------------------------------------------------------ eval
    def eval_time_series(self, labels, predictions, mask=None) -> None:
        """Sequence-output convenience (reference:
        Evaluation.evalTimeSeries — eval() already flattens [B,T,C] with
        the mask applied; this is the parity name)."""
        self.eval(labels, predictions, mask=mask)

    def eval(self, labels, predictions, mask=None, metadata=None) -> None:
        """Accumulate one batch. ``labels`` one-hot (or class indices),
        ``predictions`` probabilities/scores [B, C] (reference:
        Evaluation.eval:194). Sequence outputs [B, T, C] are flattened with
        the mask applied."""
        predictions = as_tensor(predictions)
        labels = as_tensor(labels, predictions.device)
        if mask is not None:
            mask = as_tensor(mask, predictions.device)
        seq_T = None
        if predictions.ndim == 3:  # [B, T, C] sequence output
            seq_T = predictions.shape[1]
            c = predictions.shape[-1]
            predictions = predictions.reshape(-1, c)
            labels = labels.reshape(-1, c) if labels.ndim == 3 \
                else labels.reshape(-1)
            if mask is not None:
                mask = mask.reshape(-1)
        c = predictions.shape[-1]
        if self.num_classes is None:
            self.num_classes = c
            self.confusion = ConfusionMatrix(c)
        elif self.confusion is None:
            self.confusion = ConfusionMatrix(self.num_classes)
        lab_idx = labels.argmax(-1) if labels.ndim > 1 \
            else labels.long()
        pred_idx = predictions.argmax(-1)
        cm = _confusion_update(lab_idx.long(), pred_idx.long(),
                               self.num_classes, mask)
        self.confusion.add(host_array(cm))
        if metadata is not None:
            # per-record provenance tracking (reference: eval(...,
            # List<RecordMetaData>) overload, Evaluation.java:218).
            # Sequence outputs: metadata is per-record, rows are per
            # timestep — map row i back to record i // T; masked
            # timesteps are excluded (matching the confusion matrix).
            from deeplearning4j_tpu_torch.eval.meta import Prediction
            la = host_array(lab_idx)
            pa = host_array(pred_idx)
            ma = None if mask is None else host_array(mask).reshape(-1)
            for i in range(la.shape[0]):
                rec = i // seq_T if seq_T is not None else i
                if rec >= len(metadata):
                    break
                if ma is not None and ma[i] <= 0:
                    continue
                self.predictions.append(
                    Prediction(int(la[i]), int(pa[i]), metadata[rec]))
        if self.top_n > 1:
            topk = torch.argsort(predictions, dim=-1,
                                 stable=True)[:, -self.top_n:]
            hit = (topk == lab_idx[:, None]).any(-1)
            if mask is not None:
                m = mask.reshape(-1) > 0
                self.top_n_correct += int((hit & m).sum())
                self.top_n_total += int(m.sum())
            else:
                self.top_n_correct += int(hit.sum())
                self.top_n_total += int(hit.shape[0])

    # ------------------------------------------------- eval/meta queries
    def get_prediction_errors(self) -> List:
        """Misclassified records with provenance (reference:
        Evaluation.getPredictionErrors())."""
        return [p for p in self.predictions
                if p.actual_class != p.predicted_class]

    def get_predictions_by_actual_class(self, cls: int) -> List:
        return [p for p in self.predictions if p.actual_class == cls]

    def get_predictions_by_predicted_class(self, cls: int) -> List:
        return [p for p in self.predictions if p.predicted_class == cls]

    def get_predictions(self, actual: int, predicted: int) -> List:
        """Records with a specific (actual, predicted) pair (reference:
        Evaluation.getPredictions(actual, predicted))."""
        return [p for p in self.predictions
                if p.actual_class == actual
                and p.predicted_class == predicted]

    # --------------------------------------------------------------- metrics
    def _m(self) -> np.ndarray:
        if self.confusion is None:
            raise ValueError("No batches evaluated yet")
        return self.confusion.matrix

    def accuracy(self) -> float:
        m = self._m()
        total = m.sum()
        return float(np.trace(m) / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        if self.top_n_total == 0:
            return self.accuracy()
        return self.top_n_correct / self.top_n_total

    def true_positives(self, cls: int) -> int:
        return int(self._m()[cls, cls])

    def false_positives(self, cls: int) -> int:
        m = self._m()
        return int(m[:, cls].sum() - m[cls, cls])

    def false_negatives(self, cls: int) -> int:
        m = self._m()
        return int(m[cls].sum() - m[cls, cls])

    def true_negatives(self, cls: int) -> int:
        m = self._m()
        return int(m.sum() - m[cls].sum() - m[:, cls].sum() + m[cls, cls])

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.true_positives(cls) + self.false_positives(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.precision(i) for i in range(self.num_classes)
                if self._m()[:, i].sum() + self._m()[i].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self.true_positives(cls) + self.false_negatives(cls)
            return self.true_positives(cls) / denom if denom else 0.0
        vals = [self.recall(i) for i in range(self.num_classes)
                if self._m()[i].sum() + self._m()[:, i].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        """Pretty-printed summary (reference: Evaluation.stats())."""
        m = self._m()
        names = self.label_names or [str(i) for i in range(self.num_classes)]
        lines = ["=" * 60,
                 f"Examples: {int(m.sum())}",
                 f"Accuracy:  {self.accuracy():.4f}",
                 f"Precision: {self.precision():.4f}",
                 f"Recall:    {self.recall():.4f}",
                 f"F1 Score:  {self.f1():.4f}"]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} Accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines.append("=" * 60)
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        header = "      " + " ".join(f"{n[:5]:>6}" for n in names)
        lines.append(header)
        for i, row in enumerate(m):
            lines.append(f"{names[i][:5]:>5} "
                         + " ".join(f"{int(v):>6}" for v in row))
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> None:
        """Merge another Evaluation (the reference's spark-side merge)."""
        if other.confusion is None:
            return
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.add(other.confusion.matrix)
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total

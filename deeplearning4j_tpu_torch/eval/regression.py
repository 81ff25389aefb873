"""Regression evaluation: MSE, MAE, RMSE, RSE, R², correlation per column
(port of deeplearning4j_tpu/eval/regression.py, which is numpy: the same
code, taking tensors on any device as well).

Parity with the reference's RegressionEvaluation (reference:
deeplearning4j-nn/.../eval/RegressionEvaluation.java). Accumulates sufficient
statistics (sums, sums of squares, cross products) so batches stream without
storing predictions.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import host_array


class RegressionEvaluation:
    def __init__(self, column_names: Optional[List[str]] = None):
        self.column_names = column_names
        self.n = 0
        self._init = False

    def _ensure(self, cols: int):
        if self._init:
            return
        z = lambda: np.zeros(cols, np.float64)  # noqa: E731
        self.sum_err_sq = z()
        self.sum_abs_err = z()
        self.sum_labels = z()
        self.sum_labels_sq = z()
        self.sum_pred = z()
        self.sum_pred_sq = z()
        self.sum_label_pred = z()
        self.cols = cols
        if self.column_names is None:
            self.column_names = [f"col_{i}" for i in range(cols)]
        self._init = True

    def eval(self, labels, predictions, mask=None) -> None:
        labels = host_array(labels).astype(np.float64)
        predictions = host_array(predictions).astype(np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = host_array(mask).reshape(-1) > 0
                labels, predictions = labels[m], predictions[m]
        elif mask is not None:
            m = host_array(mask).reshape(-1) > 0
            labels, predictions = labels[m], predictions[m]
        if labels.ndim == 1:
            labels = labels[:, None]
            predictions = predictions[:, None]
        self._ensure(labels.shape[1])
        err = labels - predictions
        self.n += labels.shape[0]
        self.sum_err_sq += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_labels += labels.sum(0)
        self.sum_labels_sq += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_pred_sq += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_err_sq[col] / self.n)

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.n)

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        mean_label = self.sum_labels[col] / self.n
        total = self.sum_labels_sq[col] - 2 * mean_label \
            * self.sum_labels[col] + self.n * mean_label ** 2
        return float(self.sum_err_sq[col] / max(total, 1e-12))

    def r_squared(self, col: int) -> float:
        return 1.0 - self.relative_squared_error(col)

    def pearson_correlation(self, col: int) -> float:
        n = self.n
        num = n * self.sum_label_pred[col] \
            - self.sum_labels[col] * self.sum_pred[col]
        den_l = n * self.sum_labels_sq[col] - self.sum_labels[col] ** 2
        den_p = n * self.sum_pred_sq[col] - self.sum_pred[col] ** 2
        den = np.sqrt(max(den_l, 0.0)) * np.sqrt(max(den_p, 0.0))
        return float(num / max(den, 1e-12))

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err_sq / self.n))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self.sum_abs_err / self.n))

    def average_r_squared(self) -> float:
        return float(np.mean([self.r_squared(i) for i in range(self.cols)]))

    def stats(self) -> str:
        lines = [f"{'column':>10} {'MSE':>12} {'MAE':>12} {'RMSE':>12} "
                 f"{'RSE':>12} {'R^2':>12}"]
        for i in range(self.cols):
            lines.append(
                f"{self.column_names[i]:>10} {self.mean_squared_error(i):>12.6f} "
                f"{self.mean_absolute_error(i):>12.6f} "
                f"{self.root_mean_squared_error(i):>12.6f} "
                f"{self.relative_squared_error(i):>12.6f} "
                f"{self.r_squared(i):>12.6f}")
        return "\n".join(lines)

"""Distributed-data interop + split/repartition helpers (port of
deeplearning4j_tpu/scaleout/util.py, a copy on the port's `DataSet`).

Parity with the reference's Spark utility pair (reference:
dl4j-spark/.../util/MLLibUtil.java — conversions between MLlib
Vector/LabeledPoint and INDArray/DataSet (toVector, toLabeledPoint,
fromLabeledPoint with one-hot label expansion); util/SparkUtils.java —
splitData/randomSplit, repartitionBalancedIfRequired (equal-size
partitions for even worker load), writeObjectToFile/readObjectFromFile,
checkKryoConfiguration). Spark RDDs/MLlib types don't exist here; the
equivalents operate on numpy arrays and `DataSet` lists — the host-side
currency that feeds the data-parallel step — and balanced
"repartition" becomes exact per-rank batch slicing for a mesh's data
axis.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import DataSet


@dataclass
class LabeledPoint:
    """label + dense feature vector (MLlib LabeledPoint stand-in)."""
    label: float
    features: np.ndarray


def to_labeled_point(features: np.ndarray, labels: np.ndarray
                     ) -> List[LabeledPoint]:
    """DataSet arrays → labeled points; one-hot labels collapse to the
    class index (`MLLibUtil.toLabeledPoint`)."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    if labels.ndim == 2 and labels.shape[1] > 1:
        labels = labels.argmax(1)
    labels = labels.reshape(-1)
    return [LabeledPoint(float(l), f) for f, l in zip(features, labels)]


def from_labeled_point(points: Sequence[LabeledPoint], num_classes: int
                       ) -> DataSet:
    """Labeled points → DataSet with one-hot labels
    (`MLLibUtil.fromLabeledPoint` + FeatureUtil.toOutcomeVector)."""
    feats = np.stack([np.asarray(p.features) for p in points])
    idx = np.asarray([int(p.label) for p in points])
    labels = np.eye(num_classes, dtype=feats.dtype)[idx]
    return DataSet(feats, labels)


def split_data(datasets: Sequence[DataSet], fraction: float,
               seed: int = 123) -> Tuple[List[DataSet], List[DataSet]]:
    """Random train/held-out split of a batch list
    (`SparkUtils.splitData` / randomSplit)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(datasets))
    n_train = int(round(len(datasets) * fraction))
    train = [datasets[i] for i in order[:n_train]]
    rest = [datasets[i] for i in order[n_train:]]
    return train, rest


def repartition_balanced(features: np.ndarray, labels: np.ndarray,
                         num_partitions: int
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split arrays into `num_partitions` near-equal shards (sizes
    differ by ≤1) — the even-worker-load guarantee of
    `SparkUtils.repartitionBalancedIfRequired`, exact here because we
    slice instead of shuffling an RDD."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    idx = np.array_split(np.arange(features.shape[0]), num_partitions)
    return [(features[i], labels[i]) for i in idx]


def pad_to_multiple(features: np.ndarray, labels: np.ndarray,
                    multiple: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad the batch axis up to a multiple (repeating the last row) so
    a global batch divides a mesh data axis; returns (f, l,
    n_real_rows). The sharded-fit equivalent of the reference's
    repartitioning-to-worker-count concern."""
    n = features.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return features, labels, n
    pad_f = np.repeat(features[-1:], rem, axis=0)
    pad_l = np.repeat(labels[-1:], rem, axis=0)
    return (np.concatenate([features, pad_f], 0),
            np.concatenate([labels, pad_l], 0), n)


def write_object_to_file(path: str, obj) -> None:
    """Pickle an object to a file (`SparkUtils.writeObjectToFile`)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def read_object_from_file(path: str):
    """(`SparkUtils.readObjectFromFile`)"""
    with open(path, "rb") as f:
        return pickle.load(f)


def export_dataset_batches(iterator, directory: str,
                           prefix: str = "dataset") -> List[str]:
    """Write every batch as one npz file (reference: the Export training
    approach — BatchAndExportDataSetsFunction writes batched DataSet
    files to HDFS, ParameterAveragingTrainingMaster.java:101; here plain
    files, same role). Returns the written paths."""
    import os
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, batch in enumerate(iterator):
        feats = np.asarray(batch.features)
        labels = np.asarray(batch.labels)
        payload = {"features": feats, "labels": labels}
        fm = getattr(batch, "features_mask", None)
        lm = getattr(batch, "labels_mask", None)
        if fm is not None:
            payload["features_mask"] = np.asarray(fm)
        if lm is not None:
            payload["labels_mask"] = np.asarray(lm)
        p = os.path.join(directory, f"{prefix}_{i:09d}.npz")
        np.savez(p, **payload)
        paths.append(p)
    if hasattr(iterator, "reset"):
        iterator.reset()
    return paths


class PathDataSetIterator:
    """Iterate DataSet batch files written by export_dataset_batches
    (reference: fit(String path) + ExecuteWorkerPathFlatMap — workers
    stream minibatch files by path instead of serialized RDDs)."""

    def __init__(self, path_or_paths):
        import glob
        import os
        if isinstance(path_or_paths, str):
            if os.path.isdir(path_or_paths):
                self.paths = sorted(glob.glob(
                    os.path.join(glob.escape(path_or_paths), "*.npz")))
            else:
                self.paths = sorted(glob.glob(path_or_paths))
        else:
            self.paths = list(path_or_paths)
        if not self.paths:
            raise ValueError(f"no dataset files at {path_or_paths!r}")
        self._idx = 0

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._idx >= len(self.paths):
            raise StopIteration
        with np.load(self.paths[self._idx]) as z:
            ds = DataSet(z["features"], z["labels"],
                         z["features_mask"] if "features_mask" in z
                         else None,
                         z["labels_mask"] if "labels_mask" in z else None)
        self._idx += 1
        return ds

    def reset(self) -> None:
        self._idx = 0

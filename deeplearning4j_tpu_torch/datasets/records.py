"""Record readers and DataSet conversion (port of
deeplearning4j_tpu/datasets/records.py: numpy only).

Readers (collection, CSV, CSV sequence, image tree) yield records;
`RecordReaderDataSetIterator` and `SequenceRecordReaderDataSetIterator`
turn them into (padded, masked) minibatches, and
`RecordReaderMultiDataSetIterator` joins several readers into
`MultiDataSet`s for a ComputationGraph. CSV is parsed in Python (the JAX
package's fallback; its native C++ parse is ROADMAP queue A, item 16).
`ImageRecordReader` reads ``.npy`` arrays; other image files need PIL,
and without it the reader raises, as JAX's does. Nothing is fetched.
"""
from __future__ import annotations

import csv
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import (BaseDatasetIterator,
                                                   DataSet)


class RecordReader:
    """One record = a list of values (reference: DataVec RecordReader)."""

    def records(self) -> Iterator[List]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (reference: DataVec CollectionRecordReader)."""

    def __init__(self, collection: Iterable[Sequence]):
        self._records = [list(r) for r in collection]

    def records(self) -> Iterator[List]:
        return iter(self._records)


class CSVRecordReader(RecordReader):
    """CSV file, one record per line (reference: DataVec CSVRecordReader
    (skipNumLines, delimiter))."""

    def __init__(self, path: str, skip_lines: int = 0,
                 delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def records(self) -> Iterator[List]:
        with open(self.path, newline="") as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield row


class CSVSequenceRecordReader(RecordReader):
    """One sequence per file: rows are time steps (reference: DataVec
    CSVSequenceRecordReader). Initialized with a list of file paths; each
    `records()` element is a [T, F] list-of-rows."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def records(self) -> Iterator[List[List]]:
        for p in self.paths:
            rows = []
            with open(p, newline="") as f:
                reader = csv.reader(f, delimiter=self.delimiter)
                for i, row in enumerate(reader):
                    if i < self.skip_lines or not row:
                        continue
                    rows.append(row)
            yield rows


class ImageRecordReader(RecordReader):
    """Images under class-named directories → (pixels..., label-index)
    records (reference: DataVec ImageRecordReader + ParentPathLabelGenerator).
    Reads .npy arrays or raw image files if PIL is available; directory
    names define the label order (sorted)."""

    def __init__(self, height: int, width: int, channels: int = 1):
        self.height = height
        self.width = width
        self.channels = channels
        self.labels: List[str] = []
        self._files: List[Tuple[str, int]] = []

    def initialize(self, root: str) -> None:
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.labels = classes
        self._files = []
        for ci, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                self._files.append((os.path.join(cdir, fn), ci))

    def _load(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            arr = np.load(path)
        else:
            try:
                from PIL import Image
                img = Image.open(path)
                if self.channels == 1:
                    img = img.convert("L")
                else:
                    img = img.convert("RGB")
                img = img.resize((self.width, self.height))
                arr = np.asarray(img, np.float32) / 255.0
            except ImportError as e:
                raise RuntimeError(
                    "reading non-.npy images requires PIL") from e
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape != (self.height, self.width, self.channels):
            raise ValueError(f"image {path} has shape {arr.shape}, want "
                             f"{(self.height, self.width, self.channels)}")
        return arr

    def records(self) -> Iterator[List]:
        for path, ci in self._files:
            yield [self._load(path), ci]


class RecordReaderDataSetIterator(BaseDatasetIterator):
    """records → (features, one-hot labels) minibatches (reference:
    datasets/datavec/RecordReaderDataSetIterator.java: label_index,
    num_classes; regression mode when num_classes is None)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        feats, labels = [], []
        for rec in reader.records():
            vals = list(rec)
            if label_index == -1:
                li = len(vals) - 1
            else:
                li = label_index
            label = vals.pop(li)
            if len(vals) == 1 and isinstance(vals[0], np.ndarray):
                feats.append(vals[0])  # image record
            else:
                feats.append(np.asarray([float(v) for v in vals],
                                        np.float32))
            labels.append(label)
        f = np.stack(feats)
        if regression or num_classes is None:
            l = np.asarray([[float(v)] for v in labels], np.float32)
        else:
            idx = np.asarray([int(float(v)) for v in labels])
            l = np.eye(num_classes, dtype=np.float32)[idx]
        super().__init__(f, l, batch_size)


class SequenceRecordReaderDataSetIterator(BaseDatasetIterator):
    """Sequences → padded+masked [B, T, F] batches (reference:
    SequenceRecordReaderDataSetIterator with ALIGN_END-style masking)."""

    def __init__(self, reader: CSVSequenceRecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        seq_feats, seq_labels, lengths = [], [], []
        for rows in reader.records():
            fs, ls = [], []
            for row in rows:
                vals = list(row)
                li = len(vals) - 1 if label_index == -1 else label_index
                label = vals.pop(li)
                fs.append([float(v) for v in vals])
                ls.append(label)
            seq_feats.append(np.asarray(fs, np.float32))
            seq_labels.append(ls)
            lengths.append(len(fs))
        T = max(lengths)
        B = len(seq_feats)
        F = seq_feats[0].shape[1]
        feats = np.zeros((B, T, F), np.float32)
        fmask = np.zeros((B, T), np.float32)
        if regression or num_classes is None:
            labels = np.zeros((B, T, 1), np.float32)
            for i, (sf, sl) in enumerate(zip(seq_feats, seq_labels)):
                t = len(sf)
                feats[i, :t] = sf
                fmask[i, :t] = 1
                labels[i, :t, 0] = [float(v) for v in sl]
        else:
            labels = np.zeros((B, T, num_classes), np.float32)
            eye = np.eye(num_classes, dtype=np.float32)
            for i, (sf, sl) in enumerate(zip(seq_feats, seq_labels)):
                t = len(sf)
                feats[i, :t] = sf
                fmask[i, :t] = 1
                labels[i, :t] = eye[[int(float(v)) for v in sl]]
        super().__init__(feats, labels, batch_size,
                         features_mask=fmask, labels_mask=fmask.copy())


class MultiDataSet:
    """Multiple feature/label arrays (reference: ND4J MultiDataSet used by
    ComputationGraph.fit(MultiDataSetIterator))."""

    def __init__(self, features: Sequence[np.ndarray],
                 labels: Sequence[np.ndarray],
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(l) for l in labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


class RecordReaderMultiDataSetIterator:
    """Join several readers into MultiDataSets (reference:
    RecordReaderMultiDataSetIterator.Builder: addReader, addInput,
    addOutputOneHot)."""

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self._readers = {}
            self._inputs = []   # (reader_name, col_from, col_to)
            self._outputs = []  # (reader_name, col, num_classes)

        def add_reader(self, name: str, reader: RecordReader):
            self._readers[name] = reader
            return self

        def add_input(self, name: str, col_from: int = 0,
                      col_to: int = -1):
            self._inputs.append((name, col_from, col_to))
            return self

        def add_output_one_hot(self, name: str, col: int,
                               num_classes: int):
            self._outputs.append((name, col, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        self._b = builder
        tables = {name: [ [float(v) for v in rec] for rec in r.records()]
                  for name, r in builder._readers.items()}
        n = min(len(t) for t in tables.values())
        feats = []
        for name, c0, c1 in builder._inputs:
            t = np.asarray(tables[name], np.float32)[:n]
            end = t.shape[1] if c1 == -1 else c1 + 1
            feats.append(t[:, c0:end])
        labels = []
        for name, col, k in builder._outputs:
            t = np.asarray(tables[name], np.float32)[:n]
            labels.append(np.eye(k, dtype=np.float32)[
                t[:, col].astype(int)])
        self._feats = feats
        self._labels = labels
        self._cursor = 0

    def __iter__(self):
        self._cursor = 0
        return self

    def __next__(self) -> MultiDataSet:
        n = self._feats[0].shape[0]
        if self._cursor >= n:
            raise StopIteration
        sl = slice(self._cursor, self._cursor + self._b.batch_size)
        self._cursor += self._b.batch_size
        return MultiDataSet([f[sl] for f in self._feats],
                            [l[sl] for l in self._labels])

    def reset(self):
        self._cursor = 0

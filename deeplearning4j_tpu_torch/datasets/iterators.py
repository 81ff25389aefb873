"""DataSet container + iterator utilities (port of
deeplearning4j_tpu/datasets/iterators.py: numpy only, the same code).

Parity with the reference's data layer (reference: ND4J `DataSet` +
`DataSetIterator` interface consumed at
deeplearning4j-nn/.../nn/multilayer/MultiLayerNetwork.java:947, and the
wrappers in deeplearning4j-nn/.../datasets/iterator/: AsyncDataSetIterator
(background prefetch thread + queue), MultipleEpochsIterator,
ExistingDataSetIterator).

AsyncDataSetIterator overlaps host-side batch preparation with device
execution — the same role as the reference's prefetch thread; kernel
launches are already asynchronous, so one worker + small queue suffices
to keep the card fed.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.observability.metrics import default_registry


@dataclass
class DataSet:
    """features/labels (+ optional masks), mirroring ND4J DataSet."""
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(np.asarray(self.features).shape[0])

    def split_test_and_train(self, n_train: int):
        f, l = np.asarray(self.features), np.asarray(self.labels)
        train = DataSet(f[:n_train], l[:n_train])
        test = DataSet(f[n_train:], l[n_train:])
        return train, test

    def shuffle(self, seed: int = 123) -> None:
        rng = np.random.RandomState(seed)
        perm = rng.permutation(self.num_examples())
        self.features = np.asarray(self.features)[perm]
        self.labels = np.asarray(self.labels)[perm]
        if self.features_mask is not None:
            self.features_mask = np.asarray(self.features_mask)[perm]
        if self.labels_mask is not None:
            self.labels_mask = np.asarray(self.labels_mask)[perm]


class BaseDatasetIterator:
    """Iterate minibatches over in-memory arrays."""

    def __init__(self, features, labels, batch_size: int,
                 features_mask=None, labels_mask=None,
                 drop_last: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = None if features_mask is None \
            else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None \
            else np.asarray(labels_mask)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._cursor = 0

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        n = self.features.shape[0]
        if self._cursor >= n:
            raise StopIteration
        end = min(self._cursor + self.batch_size, n)
        if self.drop_last and end - self._cursor < self.batch_size:
            raise StopIteration
        sl = slice(self._cursor, end)
        self._cursor = end
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])

    def reset(self) -> None:
        self._cursor = 0

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def input_columns(self) -> int:
        return int(np.prod(self.features.shape[1:]))

    def total_outcomes(self) -> int:
        return int(self.labels.shape[-1])


class ListDataSetIterator(BaseDatasetIterator):
    """From a list of DataSets (reference: ListDataSetIterator)."""

    def __init__(self, datasets: List[DataSet], batch_size: int):
        feats = np.concatenate([np.asarray(d.features) for d in datasets])
        labs = np.concatenate([np.asarray(d.labels) for d in datasets])
        super().__init__(feats, labs, batch_size)


class ExistingDataSetIterator:
    """Wrap any iterable of DataSets (reference:
    ExistingDataSetIterator.java)."""

    def __init__(self, iterable: Iterable[DataSet]):
        self._iterable = list(iterable)
        self._it: Optional[Iterator] = None

    def __iter__(self):
        self._it = iter(self._iterable)
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._iterable)
        return next(self._it)

    def reset(self):
        self._it = None


class AsyncDataSetIterator:
    """Background-thread prefetch (reference:
    datasets/iterator/AsyncDataSetIterator.java — used automatically by
    MultiLayerNetwork.fit at MultiLayerNetwork.java:951).

    Observability: publishes `prefetch_queue_depth`,
    `prefetch_consumer_wait_last_seconds` (how long the training loop
    just blocked on the queue — the "is the input pipeline the
    bottleneck?" signal) and `prefetch_producer_stall_last_seconds`
    gauges, plus cumulative wait/stall-seconds and batch counters, to
    the process default registry (injectable via `registry`)."""

    _SENTINEL = object()

    def __init__(self, base, queue_size: int = 2, registry=None):
        self.base = base
        self.queue_size = queue_size
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        reg = registry if registry is not None else default_registry()
        self._m_depth = reg.gauge(
            "prefetch_queue_depth", "Prefetched batches waiting")
        self._m_wait_last = reg.gauge(
            "prefetch_consumer_wait_last_seconds",
            "Consumer's most recent block on the prefetch queue")
        self._m_stall_last = reg.gauge(
            "prefetch_producer_stall_last_seconds",
            "Producer's most recent block on a full queue")
        self._m_wait = reg.counter(
            "prefetch_consumer_wait_seconds",
            "Total consumer time blocked on the prefetch queue")
        self._m_stall = reg.counter(
            "prefetch_producer_stall_seconds",
            "Total producer time blocked on a full queue")
        self._m_batches = reg.counter(
            "prefetch_batches", "Batches delivered through prefetch")

    def _worker(self, q: queue.Queue):
        try:
            for item in self.base:
                t0 = time.perf_counter()
                q.put(item)
                stall = time.perf_counter() - t0
                self._m_stall_last.set(stall)
                self._m_stall.inc(stall)
        except BaseException as e:  # propagate to consumer
            self._error = e
        finally:
            q.put(self._SENTINEL)

    def _join_worker(self):
        """Drain + join a still-alive producer so re-iteration (or
        reset) can never leak a second producer feeding a stale queue
        — the worker may be blocked in `put` on the old queue."""
        if self._thread is not None and self._thread.is_alive():
            while True:
                if self._queue.get() is self._SENTINEL:
                    break
            self._thread.join(timeout=5)
        self._thread = None

    def __iter__(self):
        self._join_worker()
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._thread = threading.Thread(target=self._worker,
                                        args=(self._queue,),
                                        daemon=True)
        self._thread.start()
        return self

    def __next__(self):
        if self._queue is None:
            iter(self)
        t0 = time.perf_counter()
        item = self._queue.get()
        wait = time.perf_counter() - t0
        self._m_wait_last.set(wait)
        self._m_wait.inc(wait)
        self._m_depth.set(self._queue.qsize())
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        self._m_batches.inc()
        return item

    def reset(self):
        self._join_worker()
        if hasattr(self.base, "reset"):
            self.base.reset()
        self._queue = None
        self._thread = None


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """Background-thread prefetch over a MultiDataSetIterator (reference:
    datasets/iterator/AsyncMultiDataSetIterator.java — wrapped by
    ComputationGraph.fit(MultiDataSetIterator)). The queue machinery is
    payload-agnostic, so this shares AsyncDataSetIterator's worker."""


class MultipleEpochsIterator:
    """Repeat a base iterator for N epochs (reference:
    MultipleEpochsIterator.java)."""

    def __init__(self, num_epochs: int, base):
        self.num_epochs = num_epochs
        self.base = base

    def __iter__(self):
        def gen():
            for _ in range(self.num_epochs):
                for item in self.base:
                    yield item
                if hasattr(self.base, "reset"):
                    self.base.reset()
        return gen()

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()


class SamplingDataSetIterator:
    """Random with-replacement minibatch sampler (reference:
    deeplearning4j-nn/.../datasets/iterator/SamplingDataSetIterator.java)."""

    def __init__(self, dataset: DataSet, batch_size: int,
                 total_batches: int, seed: int = 123):
        self.dataset = dataset
        self.batch_size = batch_size
        self.total_batches = total_batches
        self._rng = np.random.RandomState(seed)
        self._count = 0

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._count >= self.total_batches:
            raise StopIteration
        self._count += 1
        idx = self._rng.randint(0, self.dataset.num_examples(),
                                self.batch_size)
        f = np.asarray(self.dataset.features)[idx]
        l = np.asarray(self.dataset.labels)[idx]
        return DataSet(f, l)

    def reset(self) -> None:
        self._count = 0


class ViewIterator:
    """Fixed-batch view over one DataSet (reference:
    deeplearning4j-nn/.../datasets/iterator/ViewIterator.java)."""

    def __init__(self, dataset: DataSet, batch_size: int):
        self._inner = BaseDatasetIterator(dataset.features, dataset.labels,
                                          batch_size,
                                          dataset.features_mask,
                                          dataset.labels_mask)

    def __iter__(self):
        return iter(self._inner)

    def __next__(self):
        return next(self._inner)

    def reset(self):
        self._inner.reset()


class IteratorDataSetIterator:
    """Wrap any python iterable of DataSets (reference:
    datasets/iterator/IteratorDataSetIterator.java). One-shot sources
    (generators/iterators) cannot be reset — a second epoch raises, as
    the reference reports resetSupported()==false, rather than silently
    yielding nothing."""

    def __init__(self, iterable):
        self._factory = iterable
        self._one_shot = (not callable(iterable)
                          and iter(iterable) is iterable)
        self._consumed = False
        self._it = None

    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if self._it is None:
            self.reset()
        return next(self._it)

    def reset(self):
        it = self._factory
        if self._one_shot:
            if self._consumed:
                raise ValueError(
                    "reset not supported: the wrapped source is a "
                    "one-shot iterator (pass a list or a factory "
                    "callable for multi-epoch use)")
            self._consumed = True
            self._it = it
            return
        self._it = iter(it() if callable(it) else it)


class ReconstructionDataSetIterator:
    """Wrap an iterator so labels == features, for unsupervised training
    (reference: datasets/iterator/ReconstructionDataSetIterator.java)."""

    def __init__(self, inner):
        self._inner = inner

    def __iter__(self):
        self._inner.reset()
        return self

    def __next__(self) -> DataSet:
        ds = next(self._inner)
        return DataSet(ds.features, np.asarray(ds.features).copy())

    def reset(self):
        self._inner.reset()


class MovingWindowDataSetIterator:
    """Slide a (height, width) window over each image, emitting window
    batches (reference: iterator/MovingWindowBaseDataSetIterator.java +
    util/MovingWindowMatrix.java)."""

    def __init__(self, dataset: DataSet, batch_size: int, window_h: int,
                 window_w: int, stride_h: Optional[int] = None,
                 stride_w: Optional[int] = None):
        feats = np.asarray(dataset.features)
        labels = np.asarray(dataset.labels)
        if feats.ndim != 4:
            raise ValueError("MovingWindow needs [B, H, W, C] features")
        sh = stride_h or window_h
        sw = stride_w or window_w
        wins, labs = [], []
        _, H, W, _ = feats.shape
        for top in range(0, H - window_h + 1, sh):
            for left in range(0, W - window_w + 1, sw):
                wins.append(feats[:, top:top + window_h,
                                  left:left + window_w, :])
                labs.append(labels)
        self._inner = BaseDatasetIterator(np.concatenate(wins),
                                          np.concatenate(labs), batch_size)

    def __iter__(self):
        return iter(self._inner)

    def __next__(self):
        return next(self._inner)

    def reset(self):
        self._inner.reset()


class AbstractDataSetIterator(BaseDatasetIterator):
    """Minibatch iterator over an iterable of (features, labels) pairs
    (reference: datasets/iterator/AbstractDataSetIterator.java and its
    element-typed subclasses Floats/Doubles/INDArrayDataSetIterator —
    numpy erases the element-type distinction, so the three are
    aliases)."""

    def __init__(self, pairs, batch_size: int):
        pairs = list(pairs)
        if not pairs:
            super().__init__(np.zeros((0, 0)), np.zeros((0, 0)),
                             batch_size)
            return
        feats, labs = zip(*pairs)
        super().__init__(np.stack([np.asarray(f) for f in feats]),
                         np.stack([np.asarray(l) for l in labs]),
                         batch_size)


# reference parity aliases (FloatsDataSetIterator.java,
# DoublesDataSetIterator.java, INDArrayDataSetIterator.java)
FloatsDataSetIterator = AbstractDataSetIterator
DoublesDataSetIterator = AbstractDataSetIterator
INDArrayDataSetIterator = AbstractDataSetIterator


class DummyPreProcessor:
    """No-op DataSet preprocessor (reference:
    datasets/iterator/DummyPreProcessor.java)."""

    def pre_process(self, dataset: DataSet) -> DataSet:
        return dataset


class ZeroMeanPreProcessor:
    """Subtract the per-batch feature mean (reference:
    datasets/.../ZeroMeanPrePreProcessor.java)."""

    def pre_process(self, dataset: DataSet) -> DataSet:
        f = np.asarray(dataset.features, np.float32)
        return DataSet(f - f.mean(axis=0, keepdims=True), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)


class UnitVarianceProcessor:
    """Divide features by their per-column std (reference:
    datasets/.../UnitVarianceProcessor.java)."""

    def pre_process(self, dataset: DataSet) -> DataSet:
        f = np.asarray(dataset.features, np.float32)
        std = f.std(axis=0, keepdims=True)
        return DataSet(f / np.where(std > 0, std, 1.0), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)


class ZeroMeanAndUnitVariancePreProcessor:
    """Standardize features per batch (reference:
    datasets/.../ZeroMeanAndUnitVariancePreProcessor.java)."""

    def pre_process(self, dataset: DataSet) -> DataSet:
        f = np.asarray(dataset.features, np.float32)
        f = f - f.mean(axis=0, keepdims=True)
        std = f.std(axis=0, keepdims=True)
        return DataSet(f / np.where(std > 0, std, 1.0), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)


class BinomialSamplingPreProcessor:
    """Sample binary features from probabilities (reference:
    datasets/.../BinomialSamplingPreProcessor.java — used for RBM
    binary visible units)."""

    def __init__(self, seed: int = 123):
        self._rng = np.random.RandomState(seed)

    def pre_process(self, dataset: DataSet) -> DataSet:
        f = np.clip(np.asarray(dataset.features, np.float32), 0.0, 1.0)
        return DataSet((self._rng.uniform(size=f.shape) < f
                        ).astype(np.float32), dataset.labels,
                       dataset.features_mask, dataset.labels_mask)


class TestDataSetIterator(BaseDatasetIterator):
    """Split one DataSet into batches — the reference's lightweight test
    iterator (reference: datasets/test/TestDataSetIterator.java);
    inherits the full iterator surface (num_examples/input_columns/
    total_outcomes/reset)."""

    def __init__(self, dataset: DataSet, batch_size: int = 10):
        super().__init__(dataset.features, dataset.labels, batch_size,
                         dataset.features_mask, dataset.labels_mask)


class CombinedPreProcessor:
    """Chain DataSet preprocessors in order (reference:
    datasets/iterator/CombinedPreProcessor.java — Builder.addPreProcessor
    ordering)."""

    def __init__(self, *preprocessors):
        self._pre = list(preprocessors)

    def pre_process(self, dataset: DataSet) -> DataSet:
        for p in self._pre:
            out = p.pre_process(dataset)
            dataset = dataset if out is None else out
        return dataset


class IteratorMultiDataSetIterator(IteratorDataSetIterator):
    """Wrap any python iterable of MultiDataSets (reference:
    datasets/iterator/IteratorMultiDataSetIterator.java). The wrapper is
    payload-agnostic, so this shares IteratorDataSetIterator."""


class SingletonMultiDataSetIterator:
    """Yield one fixed MultiDataSet per epoch (reference:
    datasets/iterator/impl/SingletonMultiDataSetIterator.java)."""

    def __init__(self, mds):
        self.mds = mds
        self._done = False

    def __iter__(self):
        self.reset()
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        self._done = True
        return self.mds

    def reset(self):
        self._done = False


class MultiDataSetIteratorAdapter:
    """Present a DataSetIterator as a MultiDataSetIterator (reference:
    datasets/iterator/impl/MultiDataSetIteratorAdapter.java)."""

    def __init__(self, base):
        self.base = base

    def __iter__(self):
        from deeplearning4j_tpu_torch.datasets.records import MultiDataSet
        for ds in self.base:
            yield MultiDataSet(
                features=[ds.features], labels=[ds.labels],
                features_masks=(None if ds.features_mask is None
                                else [ds.features_mask]),
                labels_masks=(None if ds.labels_mask is None
                              else [ds.labels_mask]))

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

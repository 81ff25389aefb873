"""Device-affinity-aware minibatch queue (port of
deeplearning4j_tpu/parallel/magicqueue.py).

Parity with the reference (reference: deeplearning4j-core/.../
parallelism/MagicQueue.java:26 — a BlockingQueue<DataSet> that
partitions incoming batches into per-device internal queues, so each
multi-GPU Trainer thread polls batches pinned to its own device;
parallelism/AsyncIterator.java — background iterator thread feeding
it). Both are host-side.

Device affinity is by ordinal: one bucket a device, the count from the
``mesh`` ('data' ranks) when one is given, else the visible CUDA cards
(1 without a card). Alongside the reference-shaped `put` / `poll(device)`
API, `next_global()` takes one batch from every bucket and stacks them:
the global batch `ParallelWrapper` splits over its ranks.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, List, Optional

import numpy as np


class MagicQueue:
    """Round-robin partitioned blocking queue (`MagicQueue.java:26`)."""

    def __init__(self, num_devices: Optional[int] = None,
                 capacity_per_device: int = 8, mesh=None):
        if num_devices is None:
            if mesh is not None:
                num_devices = int(mesh.shape["data"])
            else:
                import torch
                num_devices = max(1, torch.cuda.device_count())
        self.num_devices = num_devices
        self._buckets: List[queue.Queue] = [
            queue.Queue(maxsize=capacity_per_device)
            for _ in range(num_devices)]
        self._next = 0
        self._lock = threading.Lock()

    def put(self, item, timeout: Optional[float] = None) -> None:
        """Add a batch; it lands in the next device bucket
        (round-robin interleave, `MagicQueue.java` put/add path)."""
        with self._lock:
            idx = self._next
            self._next = (self._next + 1) % self.num_devices
        self._buckets[idx].put(item, timeout=timeout)

    add = put

    def poll(self, device: int = 0, timeout: Optional[float] = None):
        """Take the next batch for `device`; None on timeout
        (`MagicQueue.java` poll — consumer thread pinned to a device)."""
        try:
            return self._buckets[device].get(
                block=timeout is not None, timeout=timeout)
        except queue.Empty:
            return None

    def poll_nowait(self, device: int = 0):
        try:
            return self._buckets[device].get_nowait()
        except queue.Empty:
            return None

    def size(self, device: Optional[int] = None) -> int:
        """Per-device depth, or (device=None) the min across buckets —
        the number of complete all-device rounds available (matches the
        reference's size() semantics of 'batches per trainer')."""
        if device is not None:
            return self._buckets[device].qsize()
        return min(b.qsize() for b in self._buckets)

    def is_empty(self) -> bool:
        return all(b.empty() for b in self._buckets)

    def next_global(self, timeout: Optional[float] = None):
        """Take one batch from every device bucket and stack features/
        labels along the batch axis — the global batch a data-parallel
        step consumes (no reference analog).

        All-or-nothing: if any bucket can't supply a batch (immediately
        with the default timeout=None, else within `timeout` seconds),
        already-dequeued batches are returned to their buckets and
        queue.Empty is raised — a partial tail-of-epoch round is never
        silently dropped and never deadlocks the training loop."""
        items = []
        try:
            for d in range(self.num_devices):
                items.append(self._buckets[d].get(
                    block=timeout is not None, timeout=timeout))
        except queue.Empty:
            for d, item in enumerate(items):
                self._buckets[d].put_nowait(item)
            raise
        first = items[0]
        if hasattr(first, "features"):
            feats = np.concatenate([np.asarray(i.features) for i in items], 0)
            labels = np.concatenate([np.asarray(i.labels) for i in items], 0)
            return type(first)(feats, labels)
        return np.concatenate([np.asarray(i) for i in items], 0)


class AsyncIterator:
    """Background-thread iterator feeding a bounded queue
    (`parallelism/AsyncIterator.java` — decouples host-side data prep
    from the training loop)."""

    _DONE = object()

    def __init__(self, base: Iterable, buffer_size: int = 8):
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._exc: Optional[BaseException] = None

        def worker():
            try:
                for item in base:
                    self._queue.put(item)
            except BaseException as e:  # propagate to consumer
                self._exc = e
            finally:
                self._queue.put(self._DONE)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_finished", False):
            raise StopIteration
        item = self._queue.get()
        if item is self._DONE:
            self._finished = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

"""Worker→driver stats routing (port of
deeplearning4j_tpu/scaleout/listeners.py).

Parity with the reference (reference: dl4j-spark/.../impl/listeners/
VanillaStatsStorageRouter.java:20 — a StatsStorageRouter that buffers
Persistable stats records emitted by listeners running inside Spark
executors, so the driver can collect them after the job and push them
into real StatsStorage; core api/storage/impl/
RemoteUIStatsStorageRouter.java — the HTTP variant posting records to a
remote UI server).

Here "workers" are host threads / processes driving data-parallel
steps; the vanilla router buffers in memory exactly like the reference,
and `drain_to` replays the buffer into any `StatsStorageRouter` (e.g.
`ui.storage.InMemoryStatsStorage`). The HTTP router waits for the UI
server (ROADMAP item 15).
"""
from __future__ import annotations

import threading
from typing import List

from deeplearning4j_tpu_torch.ui.storage import Persistable, StatsStorageRouter


class VanillaStatsStorageRouter(StatsStorageRouter):
    """Buffering router (`VanillaStatsStorageRouter.java:20`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.static_info: List[Persistable] = []
        self.updates: List[Persistable] = []
        self.storage_metadata: List[Persistable] = []

    def put_static_info(self, record: Persistable) -> None:
        with self._lock:
            self.static_info.append(record)

    def put_update(self, record: Persistable) -> None:
        with self._lock:
            self.updates.append(record)

    def put_storage_metadata(self, record: Persistable) -> None:
        with self._lock:
            self.storage_metadata.append(record)

    def drain_to(self, target: StatsStorageRouter) -> int:
        """Replay everything buffered into `target` (the driver-side
        collection step the reference does after executeTraining);
        returns the number of records moved."""
        with self._lock:
            static, ups, meta = (self.static_info, self.updates,
                                 self.storage_metadata)
            self.static_info, self.updates, self.storage_metadata = [], [], []
        for r in meta:
            target.put_storage_metadata(r)
        for r in static:
            target.put_static_info(r)
        for r in ups:
            target.put_update(r)
        return len(static) + len(ups) + len(meta)

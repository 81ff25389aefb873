"""Training statistics storage of the PyTorch/CUDA port (the storage
half of deeplearning4j_tpu/ui): `Persistable`, the router and storage
interfaces and the in-memory, file and sqlite backends. The UI server,
the stats listener, the components and the remote router are ROADMAP
item 15."""
from deeplearning4j_tpu_torch.ui.storage import (
    FileStatsStorage, InMemoryStatsStorage, Persistable, SqliteStatsStorage,
    StatsStorage, StatsStorageRouter)

__all__ = [
    "Persistable", "StatsStorage", "StatsStorageRouter",
    "InMemoryStatsStorage", "FileStatsStorage", "SqliteStatsStorage",
]

"""Stats storage: persistence + routing for training statistics (port
of deeplearning4j_tpu/ui/storage.py, the storage classes, :27-268).

Pure Python (json, sqlite3), copied so that the port imports nothing of
the JAX package. Records are JSON dicts addressed by (session_id,
type_id, worker_id, timestamp); static info once per session/worker,
updates many. Backends: in memory, a JSON-lines file (reloaded on
open), sqlite. `scaleout.listeners.VanillaStatsStorageRouter` buffers
records for them. The reference's HTTP router
(`RemoteUIStatsStorageRouter`) comes with the UI server (ROADMAP item
15).
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Callable, Dict, List, Optional, Tuple


class Persistable(dict):
    """One record: a JSON-serializable dict with addressing metadata
    (reference: api/storage/Persistable.java)."""

    @property
    def session_id(self) -> str:
        return self["session_id"]

    @property
    def type_id(self) -> str:
        return self["type_id"]

    @property
    def worker_id(self) -> str:
        return self["worker_id"]

    @property
    def timestamp(self) -> float:
        return self.get("timestamp", 0.0)


class StatsStorageRouter:
    """Write-side interface (reference: StatsStorageRouter.java)."""

    def put_static_info(self, record: Persistable) -> None:
        raise NotImplementedError

    def put_update(self, record: Persistable) -> None:
        raise NotImplementedError

    def put_storage_metadata(self, record: Persistable) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read+write storage (reference: StatsStorage.java:30). Listeners
    get callbacks on new sessions/records (reference:
    StatsStorageListener)."""

    def __init__(self):
        self._listeners: List[Callable[[str, Persistable], None]] = []
        self._lock = threading.Lock()

    # -- write -------------------------------------------------------------
    def put_static_info(self, record: Persistable) -> None:
        self._store("static", record)
        self._notify("static", record)

    def put_update(self, record: Persistable) -> None:
        self._store("update", record)
        self._notify("update", record)

    def put_storage_metadata(self, record: Persistable) -> None:
        self._store("meta", record)
        self._notify("meta", record)

    def _store(self, kind: str, record: Persistable) -> None:
        raise NotImplementedError

    # -- read --------------------------------------------------------------
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_type_ids_for_session(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def list_worker_ids_for_session(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def get_all_updates_after(self, session_id: str, type_id: str,
                              worker_id: str, timestamp: float
                              ) -> List[Persistable]:
        raise NotImplementedError

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: str) -> Optional[Persistable]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str, type_id: str,
                          worker_id: str) -> Optional[Persistable]:
        ups = self.get_all_updates_after(session_id, type_id, worker_id,
                                         -1.0)
        return ups[-1] if ups else None

    # -- listeners ---------------------------------------------------------
    def register_stats_storage_listener(
            self, fn: Callable[[str, Persistable], None]) -> None:
        self._listeners.append(fn)

    def _notify(self, kind: str, record: Persistable) -> None:
        for fn in list(self._listeners):
            fn(kind, record)

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """Reference: ui/storage/InMemoryStatsStorage.java."""

    def __init__(self):
        super().__init__()
        self._static: Dict[Tuple[str, str, str], Persistable] = {}
        self._updates: Dict[Tuple[str, str, str], List[Persistable]] = {}
        self._meta: List[Persistable] = []

    def _store(self, kind: str, record: Persistable) -> None:
        key = (record.session_id, record.type_id, record.worker_id)
        with self._lock:
            if kind == "static":
                self._static[key] = record
            elif kind == "update":
                self._updates.setdefault(key, []).append(record)
            else:
                self._meta.append(record)

    def list_session_ids(self) -> List[str]:
        with self._lock:
            keys = set(self._static) | set(self._updates)
            return sorted({k[0] for k in keys})

    def list_type_ids_for_session(self, session_id: str) -> List[str]:
        with self._lock:
            keys = set(self._static) | set(self._updates)
            return sorted({k[1] for k in keys if k[0] == session_id})

    def list_worker_ids_for_session(self, session_id: str) -> List[str]:
        with self._lock:
            keys = set(self._static) | set(self._updates)
            return sorted({k[2] for k in keys if k[0] == session_id})

    def get_all_updates_after(self, session_id, type_id, worker_id,
                              timestamp) -> List[Persistable]:
        with self._lock:
            ups = self._updates.get((session_id, type_id, worker_id), [])
            return [u for u in ups if u.timestamp > timestamp]

    def get_static_info(self, session_id, type_id, worker_id):
        with self._lock:
            return self._static.get((session_id, type_id, worker_id))


class FileStatsStorage(StatsStorage):
    """JSON-lines file storage, durable across processes (reference:
    ui/storage/FileStatsStorage.java — MapDB there). Appends records;
    reloads on open."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._mem = InMemoryStatsStorage()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    obj = json.loads(line)
                    self._mem._store(obj.pop("_kind"),
                                     Persistable(obj))
        self._fh = open(path, "a")

    def _store(self, kind: str, record: Persistable) -> None:
        self._mem._store(kind, record)
        with self._lock:
            self._fh.write(json.dumps({"_kind": kind, **record}) + "\n")
            self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    # reads delegate
    def list_session_ids(self):
        return self._mem.list_session_ids()

    def list_type_ids_for_session(self, s):
        return self._mem.list_type_ids_for_session(s)

    def list_worker_ids_for_session(self, s):
        return self._mem.list_worker_ids_for_session(s)

    def get_all_updates_after(self, s, t, w, ts):
        return self._mem.get_all_updates_after(s, t, w, ts)

    def get_static_info(self, s, t, w):
        return self._mem.get_static_info(s, t, w)


class SqliteStatsStorage(StatsStorage):
    """SQLite-backed storage (reference: ui/storage/sqlite/
    J7FileStatsStorage.java)."""

    def __init__(self, path: str):
        super().__init__()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS records ("
            "kind TEXT, session_id TEXT, type_id TEXT, worker_id TEXT,"
            "timestamp REAL, payload TEXT)")
        self._conn.commit()

    def _store(self, kind: str, record: Persistable) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO records VALUES (?,?,?,?,?,?)",
                (kind, record.session_id, record.type_id, record.worker_id,
                 record.timestamp, json.dumps(record)))
            self._conn.commit()

    def list_session_ids(self):
        cur = self._conn.execute("SELECT DISTINCT session_id FROM records")
        return sorted(r[0] for r in cur.fetchall())

    def list_type_ids_for_session(self, s):
        cur = self._conn.execute(
            "SELECT DISTINCT type_id FROM records WHERE session_id=?", (s,))
        return sorted(r[0] for r in cur.fetchall())

    def list_worker_ids_for_session(self, s):
        cur = self._conn.execute(
            "SELECT DISTINCT worker_id FROM records WHERE session_id=?",
            (s,))
        return sorted(r[0] for r in cur.fetchall())

    def get_all_updates_after(self, s, t, w, ts):
        cur = self._conn.execute(
            "SELECT payload FROM records WHERE kind='update' AND "
            "session_id=? AND type_id=? AND worker_id=? AND timestamp>? "
            "ORDER BY timestamp", (s, t, w, ts))
        return [Persistable(json.loads(r[0])) for r in cur.fetchall()]

    def get_static_info(self, s, t, w):
        cur = self._conn.execute(
            "SELECT payload FROM records WHERE kind='static' AND "
            "session_id=? AND type_id=? AND worker_id=? "
            "ORDER BY timestamp DESC LIMIT 1", (s, t, w))
        row = cur.fetchone()
        return Persistable(json.loads(row[0])) if row else None

    def close(self) -> None:
        self._conn.close()

"""Persistent compile cache of the port: built kernel libraries and the
manifests of the engine's programs.

Port of deeplearning4j_tpu/serving/compile_cache.py. The reference
serializes each compiled XLA executable (`jax.experimental.
serialize_executable`) so that a restarted replica loads its closed
program set instead of compiling it. Torch has no such artifact: a CUDA
graph cannot be saved, and `torch.compile` / AOTInductor would change
the eager path's bf16 rounding. What a fresh port process really pays
before its first token is

1. nvcc building ``csrc/*.cu`` (`ops._build`; tens of seconds for the
   serving sources), and
2. the first eager call and the capture of each program key
   (`serving.graphs`), which no file can replace.

So the cache holds two kinds of entry:

- **library entries**: the bytes of one built ``csrc/<name>.cu``
  library, keyed by ``ops._build._digest(name)`` (the source, the shared
  headers and the nvcc flags) and this cache's environment salt. Given
  a cache (`ops._build.ensure_built(..., cache=)`; the engine passes its
  ``compile_cache_dir``'s), a library missing from the build directory
  comes from here before nvcc is asked (`fetch_library`), and a library
  nvcc built is published here (`publish_library`). The CRC is checked
  before the bytes are written (one ``os.replace``) into the build
  directory and before any dlopen: a torn library is never loaded.
  These entries are the only ones that save time.
- **program entries**: one per (program, geometry) key the engine
  resolves, the key of its in-memory program cache. Its payload is the
  manifest of the libraries the program launches (name and digest), a
  copy of the engine's fixed table; loading it does no work and saves
  none. It is kept so that the port's resolutions carry the reference's
  ``source`` labels: a key resolves from the cache
  (``serving_compiles{source="aot_cache"}``) when its manifest is present
  and equal to the table and every library it names came from here. On
  the CPU a program launches no library, so there ``"aot_cache"`` means
  only that the manifest was present. The first call and, on the card,
  the capture still run (`InferenceEngine.warmup` runs them before
  traffic).

Durability (as the reference's and `util.checkpointing`'s):

- **Atomic publish.** An entry is staged as ``<key>.bin<staging
  suffix>``, fsynced, then published with one `os.replace`. Orphaned
  staging files are swept at construction.
- **Checksummed reads.** Every entry carries a magic, a format version,
  its kind, its payload length and a CRC32 of the payload; a corrupt,
  truncated or foreign entry fails closed: `load` returns None and
  deletes it, so the caller's rebuild publishes a clean one.
- **Versioned keys.** The environment salt is a key input: torch's
  version and its CUDA version, nvcc's ``--version`` line where nvcc
  exists, the device's name and compute capability ("cpu" on the CPU),
  the format version and the caller's salt. A library built for another
  card or runtime misses; it never loads.

`CompileCache.available()` is True: no runtime of the port lacks this
mechanism. Methods never raise for cache-side problems: a failed load
returns None, a failed store returns False.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("deeplearning4j_tpu_torch")

_MAGIC = b"DL4JTCC\x00"
FORMAT_VERSION = 1
KIND_LIBRARY = 1
KIND_PROGRAM = 2
# magic, format version, entry kind, reserved, payload length, CRC32
_HEADER = struct.Struct("<8sHBBQI")
_STAGING_SUFFIX = ".cc-tmp"

_NVCC_LINE: List[Optional[str]] = []


def _fsync_path(path: Path) -> None:
    """Best-effort fsync (some filesystems refuse directory fsync)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _nvcc_version_line() -> Optional[str]:
    """The last line of ``nvcc --version`` (its release and build), or
    None where there is no nvcc; asked once a process."""
    if not _NVCC_LINE:
        line = None
        try:
            import subprocess

            from deeplearning4j_tpu_torch.ops._build import nvcc_path
            out = subprocess.run([nvcc_path(), "--version"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout.strip().splitlines()
            line = out[-1] if out else None
        except Exception:
            line = None
        _NVCC_LINE.append(line)
    return _NVCC_LINE[0]


def environment_salt(device=None) -> tuple:
    """The runtime identity a built library is valid under: torch's
    version and CUDA version, nvcc's version line (None without nvcc) and
    the device's name and compute capability, ("cpu",) on the CPU."""
    import torch

    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        ident = (torch.cuda.get_device_name(dev),
                 tuple(torch.cuda.get_device_capability(dev)))
    else:
        ident = ("cpu",)
    return (torch.__version__, torch.version.cuda, _nvcc_version_line(),
            ident)


def default_device():
    """The device a cache keys its entries for when none is given: the
    current CUDA device where there is one, else the CPU."""
    import torch

    return torch.device("cuda") if torch.cuda.is_available() \
        else torch.device("cpu")


class CompileCache:
    """On-disk cache of built kernel libraries and program manifests.

    ``directory`` is created on demand and its orphaned staging files
    are swept; ``salt`` joins every key; ``device`` is the device whose
    name and capability the keys carry (default `default_device`). All
    methods are thread-safe. ``hits``, ``misses``, ``corrupt``,
    ``stores`` and ``store_failures`` count what `stats` reports."""

    def __init__(self, directory, *, salt: str = "", device=None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.salt = str(salt)
        self.device = default_device() if device is None else device
        self._env: Optional[tuple] = None
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.stores = 0
        self.store_failures = 0
        self._sweep_staging()

    @staticmethod
    def available() -> bool:
        return True

    # -- keys ---------------------------------------------------------------
    def environment(self) -> tuple:
        if self._env is None:
            self._env = environment_salt(self.device)
        return self._env

    def _key(self, prefix: str, ident) -> str:
        full = (ident, self.environment(), FORMAT_VERSION, self.salt)
        digest = hashlib.sha256(repr(full).encode()).hexdigest()[:32]
        return f"{prefix}-{digest}"

    def library_key(self, name: str, digest: str) -> str:
        """The key of source ``name``'s library built from sources and
        flags of digest ``digest`` (`ops._build._digest`)."""
        return self._key(f"lib-{name}", ("library", name, digest))

    def entry_key(self, program: str, fields: tuple) -> str:
        """The key of one program entry: its name and the geometry tuple
        the engine's in-memory program cache keys it by."""
        return self._key(program, ("program", program, fields))

    def path(self, key: str) -> Path:
        return self.directory / f"{key}.bin"

    # -- load / store -------------------------------------------------------
    def load(self, key: str, kind: int) -> Optional[bytes]:
        """The payload of entry ``key``, checked, or None on a miss; a
        corrupt, truncated or foreign entry (or one of another kind) is
        deleted and counted, and None returned."""
        p = self.path(key)
        try:
            blob = p.read_bytes()
        except OSError:
            with self._lock:
                self.misses += 1
            return None
        try:
            if len(blob) < _HEADER.size:
                raise ValueError("shorter than its header")
            magic, ver, k, _, n, crc = _HEADER.unpack_from(blob)
            if magic != _MAGIC:
                raise ValueError("bad magic")
            if ver != FORMAT_VERSION:
                raise ValueError(f"format version {ver}")
            if k != kind:
                raise ValueError(f"entry kind {k}, wanted {kind}")
            payload = blob[_HEADER.size:]
            if len(payload) != n:
                raise ValueError(f"payload of {len(payload)} bytes, "
                                 f"header says {n}")
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError("payload CRC mismatch")
        except ValueError as e:
            log.warning("compile cache: corrupt entry %s (%s); deleted",
                        p.name, e)
            with self._lock:
                self.corrupt += 1
                self.misses += 1
            try:
                p.unlink()
            except OSError:
                pass
            return None
        with self._lock:
            self.hits += 1
        return payload

    def store(self, key: str, kind: int, payload: bytes) -> bool:
        """Publish ``payload`` as entry ``key`` atomically; False when
        the write fails."""
        payload = bytes(payload)
        blob = _HEADER.pack(_MAGIC, FORMAT_VERSION, kind, 0, len(payload),
                            zlib.crc32(payload) & 0xFFFFFFFF) + payload
        tmp = self.directory / (f"{key}.bin{_STAGING_SUFFIX}-"
                                f"{os.getpid()}-{threading.get_ident()}")
        try:
            tmp.write_bytes(blob)
            _fsync_path(tmp)
            os.replace(tmp, self.path(key))
            _fsync_path(self.directory)
        except OSError as e:
            log.warning("compile cache: store of %s failed (%s)", key, e)
            try:
                tmp.unlink()
            except OSError:
                pass
            with self._lock:
                self.store_failures += 1
            return False
        with self._lock:
            self.stores += 1
        return True

    def fetch_library(self, name: str, digest: str, out) -> bool:
        """Write source ``name``'s library of digest ``digest`` from this
        cache to ``out``, checked first, then staged beside it and put in
        place with one ``os.replace``; False on a miss or a corrupt entry
        (deleted)."""
        blob = self.load(self.library_key(name, digest), KIND_LIBRARY)
        if blob is None:
            return False
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.cache.tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, out)
        return True

    def publish_library(self, name: str, digest: str, built) -> bool:
        """Store the built library file ``built`` of source ``name`` where
        this cache has no entry for it yet; False when it had one or the
        write failed."""
        key = self.library_key(name, digest)
        if self.path(key).exists():
            return False
        return self.store(key, KIND_LIBRARY, Path(built).read_bytes())

    def load_manifest(self, key: str) -> Optional[List[Tuple[str, str]]]:
        """A program entry's library manifest [(name, digest)], or None
        on a miss or a corrupt entry (deleted)."""
        payload = self.load(key, KIND_PROGRAM)
        if payload is None:
            return None
        try:
            doc = json.loads(payload.decode())
            return [(str(n), str(d)) for n, d in doc["libraries"]]
        except (ValueError, KeyError, TypeError) as e:
            log.warning("compile cache: unreadable manifest %s (%s); "
                        "deleted", key, e)
            with self._lock:
                self.corrupt += 1
            try:
                self.path(key).unlink()
            except OSError:
                pass
            return None

    def store_manifest(self, key: str, program: str,
                       libraries: Sequence[Tuple[str, str]]) -> bool:
        doc = {"program": program,
               "libraries": [[n, d] for n, d in libraries]}
        return self.store(key, KIND_PROGRAM,
                          json.dumps(doc, sort_keys=True).encode())

    # -- hygiene / introspection -------------------------------------------
    def _sweep_staging(self) -> None:
        """Remove staging files a mid-write kill left: anything still
        carrying the staging suffix was never published."""
        try:
            for p in self.directory.iterdir():
                if _STAGING_SUFFIX in p.name:
                    log.warning("compile cache: sweeping orphaned "
                                "staging file %s", p)
                    try:
                        p.unlink()
                    except OSError:
                        pass
        except OSError:
            pass

    def entries(self) -> list:
        try:
            return sorted(p.name for p in self.directory.glob("*.bin"))
        except OSError:
            return []

    def nbytes(self) -> int:
        try:
            return sum(p.stat().st_size
                       for p in self.directory.glob("*.bin"))
        except OSError:
            return 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"directory": str(self.directory),
                    "entries": len(self.entries()),
                    "bytes": self.nbytes(),
                    "hits": self.hits, "misses": self.misses,
                    "corrupt": self.corrupt, "stores": self.stores,
                    "store_failures": self.store_failures}


def sweep_stray_caches(root=None, prefix: str = "dl4j-aot-",
                       max_age_s: float = 0.0) -> int:
    """Remove stray cache directories (or files) named ``prefix*`` under
    ``root`` (default: the system temp dir), older than ``max_age_s``
    where that is set. Returns the number removed."""
    import shutil
    import tempfile

    root = Path(root or tempfile.gettempdir())
    now = time.time()
    removed = 0
    try:
        candidates = list(root.glob(prefix + "*"))
    except OSError:
        return 0
    for p in candidates:
        try:
            if max_age_s and now - p.stat().st_mtime < max_age_s:
                continue
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink()
            removed += 1
        except OSError:
            continue
    return removed

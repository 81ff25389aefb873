"""Checkpoints of parameter trees in the reference's npz layout.

Port of the npz path of deeplearning4j_tpu/util/checkpointing.py (that
module imports JAX and orbax, so it is ported, not copied). The on-disk
format is the reference's, byte for byte in what it records, so a step
written by either side is read by the other:

- ``<root>/step_<N>/arrays.npz`` holds one array per leaf, named
  ``"<payload>|<key path>"`` (``tree|blocks/Wq``: dict keys in sorted
  order, sequence indices, ``.field`` for a named tuple's fields, as
  JAX's `tree_flatten_with_path` names them); ``dtypes.json`` maps the
  leaves numpy cannot hold (bfloat16, float8_e4m3fn) to their dtype
  name, and those leaves are stored as the same-width unsigned integer
  (their bits intact).
- ``manifest.json`` records a CRC32, shape and dtype per stored array.
  `verify_step` checks every one; a restore checks each array it reads
  and refuses a dtype the manifest does not record.
- **Atomic publication.** A step is written into ``step_<N>.tmp``,
  every file fsynced, then published with one `os.replace` and a fsync
  of the root; `all_steps` never sees a half-written step. Staging
  directories left by a writer killed mid-write are swept when a manager
  opens the directory.
- ``meta_<N>.json`` (``save_tree(meta=...)``) is published atomically
  beside its step.

`restore_tree` with ``step=None`` reads the newest step that verifies,
falling back past a corrupt or torn one (logged); an explicit step
fails hard.

Series (``registry=``, the process-wide registry by default), the
reference's: ``checkpoint_write_seconds``,
``checkpoint_save_stall_seconds``, ``checkpoint_saves_total{mode}``,
``checkpoint_verify_failures_total`` and ``checkpoint_async_pending``.

``async_save=True`` moves the write (CRC, fsync, rename) to one
background thread: `save()` pays only the snapshot of the tree into host
memory (copies, so a later step cannot change what is written), then
returns; at most one write is in flight (the next save joins it first),
``checkpoint_async_pending`` is 1 while it runs, and the next save,
`wait()` or a restore raises what the thread raised.

A directory orbax wrote (step directories named by their number, orbax
metadata files) is refused with `CheckpointFormatError`: the port reads
and writes the npz layout only. `save(net)` / `restore(net)` checkpoint
a `MultiLayerNetwork` or a `ComputationGraph` (params, layer state,
updater state and its counters), as the reference's do, and
`CheckpointListener` calls `save` every N iterations on the listener
stream.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.train.listeners import IterationListener

log = logging.getLogger("deeplearning4j_tpu_torch")

MANIFEST_VERSION = 1
_TMP_SUFFIX = ".tmp"

# same-width unsigned container for the dtypes numpy cannot hold
_UINT_OF_WIDTH = {1: np.uint8, 2: np.uint16, 4: np.uint32}
# torch dtypes stored through a container -> the reference's dtype name
_EXOTIC = {torch.bfloat16: "bfloat16"}
if hasattr(torch, "float8_e4m3fn"):
    _EXOTIC[torch.float8_e4m3fn] = "float8_e4m3fn"
_EXOTIC_TORCH = {v: k for k, v in _EXOTIC.items()}
# the reference's orbax layout: step directories named by their number,
# and orbax's metadata files
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt",
                  "_sharding")


class CheckpointCorruptError(RuntimeError):
    """A step directory failed checksum or structure verification."""


class CheckpointFormatError(ValueError):
    """The directory holds a checkpoint layout the port cannot read (one
    written by orbax)."""


def _fsync_path(path: Path) -> None:
    """fsync a file or directory; best-effort where the filesystem
    refuses directory descriptors."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def flatten_with_names(tree, prefix: str) -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` of ``tree`` in JAX's flattening order, each
    leaf named ``prefix + "|" + "/".join(path)`` as the reference's
    checkpoints name them: dict keys sorted, list and tuple indices, a
    named tuple's fields as ``.field``; None is an empty subtree."""
    out: List[Tuple[str, Any]] = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + [str(k)])
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), path + [f".{f}"])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + [str(i)])
        else:
            out.append((prefix + "|" + "/".join(path), x))

    walk(tree, [])
    return out


def _rebuild(template, values: Dict[int, Any], counter: List[int]):
    """``template``'s structure with its leaves replaced, in flattening
    order, by ``values[0], values[1], ...``."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {}
        for k in sorted(template):
            out[k] = _rebuild(template[k], values, counter)
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), values,
                                         counter)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, values, counter)
                              for v in template)
    i = counter[0]
    counter[0] += 1
    return values[i]


def _host_array(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the numpy array the npz stores, and its exotic dtype
    name (None for a dtype numpy holds)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = _EXOTIC.get(t.dtype)
        if name is not None:
            width = t.element_size()
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[width]
            return (t.view(ints).numpy().view(_UINT_OF_WIDTH[width]),
                    name)
        return t.numpy(), None
    a = np.asarray(leaf)
    if not hasattr(np, a.dtype.name):     # an ml_dtypes array
        return a.view(_UINT_OF_WIDTH[a.dtype.itemsize]), a.dtype.name
    return a, None


def _to_tensor(a: np.ndarray, exotic: Optional[str]) -> torch.Tensor:
    """A stored array as a tensor: an exotic dtype's container viewed
    back as that dtype, bits unchanged."""
    a = np.array(a, copy=True, order="C")
    if exotic is None:
        return torch.from_numpy(a)
    dt = _EXOTIC_TORCH.get(exotic)
    if dt is None:
        raise CheckpointCorruptError(
            f"stored dtype {exotic!r} has no torch counterpart")
    ints = {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
    return torch.from_numpy(a.view(ints)).view(dt)


def _leaf_device(leaf, device):
    if device is not None:
        return torch.device(device)
    dev = getattr(leaf, "device", None)
    if isinstance(dev, torch.device) and dev.type != "meta":
        return dev
    return torch.device("cpu")


class CheckpointManager:
    """Save and restore parameter trees under ``<directory>/step_<N>/``
    in the reference's npz layout (module docstring), keeping the newest
    ``max_to_keep`` steps.

    ``use_orbax`` keeps the reference's signature: only None and False
    are accepted (the port has no orbax). ``fault_injector`` receives
    `on_checkpoint_write(step, staging_dir)` before publication and
    `on_checkpoint_published(step, final_dir)` after (the crash and
    torn-write hooks of `parallel.failure.FaultInjector`)."""

    def __init__(self, directory, max_to_keep: int = 3,
                 use_orbax: Optional[bool] = None, async_save: bool = False,
                 fault_injector=None, registry=None):
        if use_orbax:
            raise CheckpointFormatError(
                "use_orbax=True: the port reads and writes the npz "
                "checkpoint layout only")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._refuse_orbax_layout()
        self.max_to_keep = max_to_keep
        self.use_orbax = False
        self.async_save = bool(async_save)
        self.fault_injector = fault_injector
        reg = registry if registry is not None else default_registry()
        self._m_write = reg.histogram(
            "checkpoint_write_seconds",
            "Disk time of one checkpoint write (CRC+fsync+rename)")
        self._m_stall = reg.histogram(
            "checkpoint_save_stall_seconds",
            "Time save() blocked its caller (async: snapshot only)")
        self._m_saves = reg.counter(
            "checkpoint_saves_total", "Completed checkpoint saves",
            labelnames=("mode",))
        self._m_verify_fail = reg.counter(
            "checkpoint_verify_failures_total",
            "Array checksum / structure verification failures on read")
        self._m_pending = reg.gauge(
            "checkpoint_async_pending",
            "Async checkpoint writes currently in flight")
        # one background writer; at most ONE write in flight
        self._executor: Optional[ThreadPoolExecutor] = None
        self._inflight: Optional[Future] = None
        self._async_error: Optional[BaseException] = None
        self._sweep_orphans()

    def _refuse_orbax_layout(self) -> None:
        """An orbax-written directory: numbered step directories, or
        orbax's metadata files, and no npz step."""
        if any(self.directory.glob("step_*/arrays.npz")):
            return
        for p in self.directory.iterdir():
            orbax = (p.is_dir() and p.name.isdigit()) or \
                p.name in _ORBAX_MARKERS or any(
                    (p / m).exists() for m in _ORBAX_MARKERS)
            if orbax:
                raise CheckpointFormatError(
                    f"{self.directory} holds an orbax checkpoint "
                    f"({p.name!r}); the port reads the npz layout only "
                    "(step_<N>/arrays.npz + manifest.json): write the "
                    "tree with CheckpointManager(use_orbax=False)")

    def _sweep_orphans(self) -> None:
        """Remove ``step_<N>.tmp`` staging directories a writer killed
        mid-write left: a completed write has been renamed away."""
        for p in self.directory.glob(f"step_*{_TMP_SUFFIX}"):
            log.warning("sweeping orphaned checkpoint staging dir %s "
                        "(previous writer died mid-write)", p.name)
            shutil.rmtree(p, ignore_errors=True)

    # -- save ----------------------------------------------------------------
    def _write_payload(self, payload: Dict, step: int,
                       meta: Optional[Dict] = None) -> None:
        with self._m_stall.time():
            flat: Dict[str, np.ndarray] = {}
            exotic: Dict[str, str] = {}
            for k, tree in payload.items():
                for name, leaf in flatten_with_names(tree, k):
                    a, ex = _host_array(leaf)
                    if ex is not None:
                        exotic[name] = ex
                    # the host snapshot: a copy, never a view of a live
                    # CPU tensor the next step may replace in place
                    flat[name] = np.array(a, copy=True) \
                        if self.async_save else a
            if not self.async_save:
                self._write_npz(flat, exotic, int(step), meta)
                return
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt-writer")
            if self._inflight is not None:     # bound: 1 write in flight
                self._await_inflight()
            self._surface_async_error()
            self._m_pending.set(1)
            self._inflight = self._executor.submit(
                self._write_npz, flat, exotic, int(step), meta)

    def _write_npz(self, flat: Dict[str, np.ndarray],
                   exotic: Dict[str, str], step: int,
                   meta: Optional[Dict]) -> None:
        """CRC, stage, fsync and publish one step."""
        with self._m_write.time():
            manifest = {
                "version": MANIFEST_VERSION,
                "step": step,
                "arrays": {
                    name: {"crc32": _crc(a), "shape": list(a.shape),
                           "dtype": str(a.dtype),
                           "stored_dtype": exotic.get(name)}
                    for name, a in flat.items()},
            }
            final = self.directory / f"step_{step}"
            tmp = self.directory / f"step_{step}{_TMP_SUFFIX}"
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **flat)
            (tmp / "dtypes.json").write_text(json.dumps(exotic))
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            for f in ("arrays.npz", "dtypes.json", "manifest.json"):
                _fsync_path(tmp / f)
            _fsync_path(tmp)
            inj = self.fault_injector
            if inj is not None and hasattr(inj, "on_checkpoint_write"):
                inj.on_checkpoint_write(step, tmp)
            if final.exists():
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            _fsync_path(self.directory)
            if inj is not None and hasattr(inj, "on_checkpoint_published"):
                inj.on_checkpoint_published(step, final)
            if meta is not None:
                self._write_meta(meta, step)
            self._retain()
        self._m_saves.labels("async" if self.async_save else "sync").inc()

    # -- async bookkeeping ---------------------------------------------------
    def _await_inflight(self) -> None:
        fut, self._inflight = self._inflight, None
        if fut is None:
            return
        try:
            fut.result()
        except BaseException as e:   # surfaced on the next save / wait
            self._async_error = e
        finally:
            self._m_pending.set(0)

    def _surface_async_error(self) -> None:
        if self._async_error is not None:
            e, self._async_error = self._async_error, None
            raise RuntimeError(
                "previous async checkpoint write failed") from e

    def wait(self) -> None:
        """Join any in-flight async write; raises if it (or a previous
        one) failed. Call at step-loop exit and before reading back."""
        self._await_inflight()
        self._surface_async_error()

    def _write_meta(self, meta: Dict, step: int) -> None:
        final = self.directory / f"meta_{step}.json"
        tmp = self.directory / f"meta_{step}.json{_TMP_SUFFIX}"
        tmp.write_text(json.dumps(meta))
        _fsync_path(tmp)
        os.replace(tmp, final)

    def _retain(self) -> None:
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)
            try:
                (self.directory / f"meta_{s}.json").unlink()
            except FileNotFoundError:
                pass

    def save(self, net, step: Optional[int] = None) -> int:
        """Checkpoint a network's params, layer state and updater state
        as step ``step`` (default: its iteration count), with its
        counters in the step's meta."""
        step = int(net.iteration_count if step is None else step)
        payload = {"params": net.params, "state": net.state,
                   "updater_state": net.updater_state}
        meta = {"step": step,
                "iteration_count": int(net.iteration_count),
                "epoch_count": int(net.epoch_count)}
        self._write_payload(payload, step, meta=meta)
        return step

    def restore(self, net, step: Optional[int] = None):
        """Restore a network in place from ``step`` (None: the newest
        step that verifies, falling back past a corrupt one); returns the
        step, or None when there is none. Updater state takes the
        network's own dtypes."""
        self.wait()
        template = {"params": net.params, "state": net.state,
                    "updater_state": net.updater_state}
        restored, step = self._resolve_readable(template, step, None)
        if restored is None:
            return None
        net.params = restored["params"]
        net.state = restored["state"]
        net.updater_state = _cast_like(net.updater_state,
                                       restored["updater_state"])
        meta = self.read_meta(step)
        if meta is not None:
            net.iteration_count = meta.get("iteration_count", step)
            net.epoch_count = meta.get("epoch_count", 0)
        return step

    def save_tree(self, tree, step: int,
                  meta: Optional[Dict] = None) -> int:
        """Checkpoint a tree of tensors (or numpy arrays) as step
        ``step``; ``meta`` (a JSON dict) is published beside it."""
        self._write_payload({"tree": tree}, int(step), meta=meta)
        return int(step)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.directory.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_meta(self, step: int) -> Optional[Dict]:
        """The meta dict published with ``step``, or None."""
        p = self.directory / f"meta_{int(step)}.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def _load_manifest(self, step: int) -> Optional[Dict]:
        p = self.directory / f"step_{step}" / "manifest.json"
        if not p.exists():      # a step from before manifests
            return None
        return json.loads(p.read_text())

    def verify_step(self, step: int) -> bool:
        """Every manifest array present in arrays.npz with its CRC32 and
        dtype, and nothing extra (a step without a manifest verifies by
        being readable). A failure counts in
        ``checkpoint_verify_failures_total``."""
        d = self.directory / f"step_{step}"
        try:
            manifest = self._load_manifest(int(step))
            with np.load(d / "arrays.npz") as data:
                if manifest is None:
                    for name in data.files:
                        data[name]
                    return True
                arrays = manifest["arrays"]
                if set(arrays) != set(data.files):
                    raise CheckpointCorruptError(
                        f"step {step}: manifest lists {len(arrays)} "
                        f"arrays, npz holds {len(data.files)}")
                for name, m in arrays.items():
                    a = data[name]
                    if str(a.dtype) != m["dtype"]:
                        raise CheckpointCorruptError(
                            f"step {step}: dtype mismatch for {name!r} "
                            f"(manifest {m['dtype']}, stored {a.dtype})")
                    if _crc(a) != m["crc32"]:
                        raise CheckpointCorruptError(
                            f"step {step}: checksum mismatch for "
                            f"{name!r}")
            return True
        except Exception as e:
            self._m_verify_fail.inc()
            log.warning("checkpoint step_%s failed verification: %s",
                        step, e)
            return False

    def _read_payload(self, template: Dict, step: int, device) -> Dict:
        d = self.directory / f"step_{step}"
        manifest = self._load_manifest(step)
        man = manifest["arrays"] if manifest else None
        exotic: Dict[str, str] = {}
        if (d / "dtypes.json").exists():
            exotic = json.loads((d / "dtypes.json").read_text())
        restored = {}
        with np.load(d / "arrays.npz") as data:
            for k, tree in template.items():
                vals = {}
                for j, (name, leaf) in enumerate(
                        flatten_with_names(tree, k)):
                    if man is not None and name not in man:
                        raise CheckpointCorruptError(
                            f"checkpoint tree-structure mismatch: "
                            f"template leaf {name!r} is not in step "
                            f"{step}'s manifest ({len(man)} arrays: "
                            f"{sorted(man)[:4]}...)")
                    try:
                        a = data[name]
                    except KeyError:
                        raise CheckpointCorruptError(
                            f"checkpoint tree-structure mismatch: "
                            f"template leaf {name!r} is not stored in "
                            f"step {step}")
                    if man is not None and str(a.dtype) != \
                            man[name]["dtype"]:
                        self._m_verify_fail.inc()
                        raise CheckpointCorruptError(
                            f"dtype mismatch for {name!r} in step {step}: "
                            f"manifest records {man[name]['dtype']}, "
                            f"stored array reads back as {a.dtype}")
                    if man is not None and _crc(a) != man[name]["crc32"]:
                        self._m_verify_fail.inc()
                        raise CheckpointCorruptError(
                            f"checksum mismatch for {name!r} in step "
                            f"{step} (torn or corrupted write)")
                    shape = tuple(getattr(leaf, "shape", a.shape))
                    if tuple(a.shape) != shape:
                        raise CheckpointCorruptError(
                            f"checkpoint tree-structure mismatch: "
                            f"{name!r} is {tuple(a.shape)} in step "
                            f"{step}, the template's is {shape}")
                    vals[j] = _to_tensor(a, exotic.get(name)).to(
                        _leaf_device(leaf, device))
                restored[k] = _rebuild(tree, vals, [0])
        return restored

    def _resolve_readable(self, template: Dict, step: Optional[int],
                          device):
        """The requested step, or with ``step`` None the newest one that
        reads and verifies: a corrupt, partial or torn step logs a
        warning and falls back to the previous one. Returns (payload,
        step), or (None, None) when there is no step."""
        steps = ([int(step)] if step is not None
                 else list(reversed(self.all_steps())))
        last_err: Optional[BaseException] = None
        for s in steps:
            try:
                return self._read_payload(template, s, device), s
            except Exception as e:
                if step is not None:
                    raise
                last_err = e
                log.warning("checkpoint step_%d unreadable (%s); falling "
                            "back to previous step", s, e)
        if last_err is not None:
            raise RuntimeError(
                f"no readable checkpoint under {self.directory}"
            ) from last_err
        return None, None

    def restore_tree(self, template, step: Optional[int] = None,
                     with_step: bool = False, device=None):
        """Restore a tree saved by `save_tree` (by either side) in
        ``template``'s structure: every leaf a tensor with the stored
        dtype and bits, on ``device``, else on its template leaf's device
        (a meta or non-tensor leaf: the CPU). Returns None when there is
        no step; ``with_step=True`` returns ``(tree, step)``."""
        self.wait()
        payload, got = self._resolve_readable({"tree": template}, step,
                                              device)
        if payload is None:
            return (None, None) if with_step else None
        out = payload["tree"]
        return (out, got) if with_step else out


def _cast_like(skeleton, got):
    if isinstance(skeleton, dict):
        return {k: _cast_like(v, got[k]) for k, v in skeleton.items()}
    if isinstance(skeleton, torch.Tensor):
        return got.to(skeleton.dtype)
    return got


class CheckpointListener(IterationListener):
    """Checkpoint the network every ``frequency`` iterations (the
    reference's CheckpointListener, on the listener stream)."""

    def __init__(self, manager: CheckpointManager, frequency: int = 100):
        self.manager = manager
        self.frequency = max(1, frequency)

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration > 0 and iteration % self.frequency == 0:
            self.manager.save(model, step=iteration)
            log.info("checkpointed at iteration %d", iteration)

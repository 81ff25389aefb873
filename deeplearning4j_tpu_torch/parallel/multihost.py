"""Multi-process runtime: the process group every parallel module runs on
(port of deeplearning4j_tpu/parallel/multihost.py).

The reference joins JAX's distributed runtime (one coordinator, N
processes, `jax.devices()` spanning the job). The port joins a
`torch.distributed` process group: one process a rank, each driving one
device, with a TCP rendezvous at the coordinator's address.

`initialize_multihost` takes its arguments from the standard variables
when they are not given (``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), as the reference's take ``JAX_*``.
`MultiHostLauncher` spawns N local processes that join one group, run a
function, and return every rank's result: the reference's local[N]
trick, and how the port's tests and chip_smoke.py start their ranks.

**The backend rule** (`choose_backend`): NCCL when every rank has a card
of its own; gloo for CPU ranks and for ranks that share one card (NCCL
refuses two ranks on one device). On gloo, the collectives it does not
take on CUDA tensors go through pinned host buffers
(`parallel.collectives.HOST_STAGED`). The launcher prints the rule it
applied.
"""
from __future__ import annotations

import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch._device import resolve_device

# this process's rank device, set by initialize_multihost
_DEVICE: Optional[torch.device] = None


def choose_backend(device: Union[str, torch.device], n_ranks: int,
                   n_cards: Optional[int] = None) -> str:
    """"nccl" when the ranks are on CUDA and each has a card of its own,
    else "gloo" (CPU ranks, or ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    return "nccl" if n_cards >= n_ranks else "gloo"


def backend_rule(device, n_ranks: int, n_cards: Optional[int] = None
                 ) -> str:
    """One line naming the backend `choose_backend` picks and why."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"backend=gloo: {n_ranks} CPU ranks"
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    b = choose_backend(dev, n_ranks, n_cards)
    why = ("every rank has a card of its own" if b == "nccl" else
           f"{n_ranks} ranks share {n_cards} card(s); NCCL refuses two "
           "ranks on one device")
    return f"backend={b}: {why}"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids: Optional[Sequence[int]] = None,
                         *, device=None, backend: Optional[str] = None,
                         timeout_s: float = 300.0) -> None:
    """Join the process group. ``coordinator_address`` ("host:port")
    defaults to ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to
    ``WORLD_SIZE``, ``process_id`` to ``RANK``. The rank's device is
    CUDA unless ``device="cpu"``: card ``local_device_ids[0]`` when
    given, else ``process_id % device_count``. ``backend`` defaults to
    `choose_backend` over the job's ranks."""
    global _DEVICE
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError("no coordinator address: pass one or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if num_processes is None or process_id is None:
        raise ValueError("pass num_processes and process_id or set "
                         "WORLD_SIZE and RANK")
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = (int(local_device_ids[0]) if local_device_ids
               else process_id % torch.cuda.device_count())
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    if backend is None:
        backend = choose_backend(dev, num_processes)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev


def rank_device() -> Optional[torch.device]:
    """The device `initialize_multihost` gave this rank (None before)."""
    return _DEVICE


def process_info() -> Dict[str, Any]:
    """This process's place in the job: index, count, its device and
    backend (one device a process; ``cards`` counts the visible cards)."""
    joined = dist.is_available() and dist.is_initialized()
    return {"process_index": dist.get_rank() if joined else 0,
            "process_count": dist.get_world_size() if joined else 1,
            "local_device_count": 1,
            "global_device_count": dist.get_world_size() if joined else 1,
            "cards": torch.cuda.device_count(),
            "device": str(_DEVICE) if _DEVICE is not None else None,
            "backend": dist.get_backend() if joined else None}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fn_ref(fn: Union[str, Callable]):
    """(module name, attribute path, directory to put on sys.path) of a
    module-level function, or of a "module:attr" string. A function of a
    script run as __main__ is named by the script's file stem."""
    if isinstance(fn, str):
        mod, attr = fn.split(":", 1)
        return mod, attr, ""
    mod = fn.__module__
    path = getattr(sys.modules.get(mod), "__file__", None)
    if mod == "__main__":
        if path is None:
            raise ValueError("a function of an interactive __main__ cannot "
                             "run in a child process")
        mod = Path(path).stem
    if "<locals>" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__} is not a module-level "
                         "function")
    return mod, fn.__qualname__, str(Path(path).resolve().parent) \
        if path else ""


_RANK_MAIN = textwrap.dedent("""
    import importlib, pickle, sys
    spec_path, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    for p in reversed(spec["path"]):
        if p and p not in sys.path:
            sys.path.insert(0, p)
    from deeplearning4j_tpu_torch.parallel.multihost import \\
        initialize_multihost
    initialize_multihost(spec["coordinator"], spec["n"], rank,
                         device=spec["device"], backend=spec["backend"],
                         timeout_s=spec["timeout"])
    obj = importlib.import_module(spec["module"])
    for part in spec["attr"].split("."):
        obj = getattr(obj, part)
    result = obj(*spec["args"], **spec["kwargs"])
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)
""")


class MultiHostLauncher:
    """Spawn ``num_processes`` local Python processes that join one
    process group and each run ``fn(*args, **kwargs)``, collecting every
    rank's return value in rank order.

    ``fn`` is a module-level function (or "module:attr"); the children
    import it by name, so they import what its module imports and
    nothing of the parent's state. ``device`` "cpu" gives CPU ranks
    (gloo); CUDA (the default) puts rank r on card r % device_count,
    with the backend from `choose_backend` (``backend`` overrides it).
    ``devices_per_process`` is the reference's argument: one device a
    process is all a torch rank drives, so it must be 1."""

    def __init__(self, num_processes: int = 2,
                 devices_per_process: int = 1, port: int = 0, *,
                 device=None, backend: Optional[str] = None,
                 verbose: bool = True):
        if devices_per_process != 1:
            raise ValueError("a torch rank drives one device: "
                             "devices_per_process must be 1")
        self.num_processes = num_processes
        self.devices_per_process = 1
        self.device = str(resolve_device(device))
        self.backend = backend or choose_backend(self.device,
                                                 num_processes)
        self.rule = backend_rule(self.device, num_processes)
        self.coordinator = f"127.0.0.1:{port or free_port()}"
        self.verbose = verbose
        # each rank's stderr tail of the last run
        self.stderr: List[str] = []

    def run(self, fn: Union[str, Callable], timeout: float = 300.0,
            args: Sequence = (), kwargs: Optional[dict] = None,
            ) -> List[Any]:
        """Run ``fn`` on every rank; every rank's result in rank order.
        Raises RuntimeError naming each rank that failed (its exit code
        and stderr tail) or outlived ``timeout`` seconds; on the first
        failure the other ranks are given a few seconds, then killed."""
        mod, attr, fn_dir = _fn_ref(fn)
        if self.verbose:
            print(f"multihost: {self.num_processes} ranks on "
                  f"{self.device}, {self.rule}", flush=True)
        with tempfile.TemporaryDirectory() as td:
            root = str(Path(__file__).resolve().parents[2])
            spec = {"coordinator": self.coordinator,
                    "n": self.num_processes, "device": self.device,
                    "backend": self.backend, "timeout": timeout,
                    "module": mod, "attr": attr, "path": [fn_dir, root],
                    "args": tuple(args), "kwargs": dict(kwargs or {})}
            spec_path = Path(td) / "spec.pkl"
            spec_path.write_bytes(pickle.dumps(spec))
            script = Path(td) / "rank_main.py"
            script.write_text(_RANK_MAIN)
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [root] + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
            outs, procs, errs = [], [], []
            for r in range(self.num_processes):
                outs.append(Path(td) / f"out_{r}.pkl")
                errs.append(open(Path(td) / f"err_{r}.txt", "w+b"))
                procs.append(subprocess.Popen(
                    [sys.executable, str(script), str(spec_path), str(r),
                     str(outs[r])], env=env, stdout=errs[r],
                    stderr=subprocess.STDOUT))
            failed = self._wait(procs, timeout)
            self.stderr = []
            for f in errs:
                f.seek(0)
                self.stderr.append(f.read().decode(errors="replace")[-4000:])
                f.close()
            problems = []
            for r, p in enumerate(procs):
                why = failed.get(r)
                if why is None and p.returncode != 0:
                    why = f"rc={p.returncode}"
                if why is None and not outs[r].exists():
                    why = "no result"
                if why is not None:
                    problems.append(f"rank {r}: {why}\n{self.stderr[r]}")
            if problems:
                raise RuntimeError("multi-process launch failed:\n"
                                   + "\n".join(problems))
            return [pickle.loads(o.read_bytes()) for o in outs]

    @staticmethod
    def _wait(procs, timeout: float) -> Dict[int, str]:
        """Wait for every process; on the first nonzero exit give the rest
        5 s, then kill them; kill all at the deadline. Returns rank ->
        reason for the ranks that were killed."""
        deadline = time.monotonic() + timeout
        failed: Dict[int, str] = {}
        grace = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return failed
            now = time.monotonic()
            if grace is None and any(c not in (None, 0) for c in codes):
                grace = now + 5.0
            if now > deadline or (grace is not None and now > grace):
                why = ("timeout" if now > deadline else
                       "killed after another rank failed")
                for r, p in enumerate(procs):
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                        failed[r] = why
                return failed
            time.sleep(0.02)

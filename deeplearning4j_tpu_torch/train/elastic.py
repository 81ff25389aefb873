"""Elastic data-parallel training: workers join and leave mid-run with
deterministic resume (port of deeplearning4j_tpu/train/elastic.py).

An `ElasticCoordinator` runs N REAL worker processes
(`train/elastic_worker.py`, spawned over the fleet's JSON-lines pipe
pattern) and owns three things:

- **Membership.** Workers are detected dead via pipe EOF / process exit
  at every barrier; `parallel.failure.ElasticFaultInjector`'s kill /
  hang / slow / join knobs drive the churn deterministically.
- **ZeRO-1 sharded updater state** (arXiv 2004.13336, on
  `parallel.fsdp` and `parallel.optim`): parameters, Adam m and v
  flatten into one contiguous float32 vector (`flatten_tree`, leaves in
  sorted-key order, so a JAX flat vector is the port's with no
  conversion); each worker owns ONE contiguous ``(lo, hi)`` shard
  (`zero1_partition`) and is the only process holding that shard's
  optimizer moments, on its own device: per-worker updater bytes are
  ~1/N of replicated. Workers send back their updated param slice; the
  coordinator reassembles the full vector and broadcasts it with the
  next step's grads request.
- **Deterministic resume.** Every membership change resolves at a resize
  barrier on the next step boundary. Joins (and any change with all
  shards reachable) gather and publish a checksummed checkpoint
  (`util.checkpointing`) and reshard from it; a LOST shard (SIGKILL,
  eviction) restores the last published verified checkpoint, rewinds
  the step counter and replays the data cursor. A batch is a pure
  function of ``(step, microbatch)`` (`data_batch`), gradients reduce in
  fixed microbatch order on the host, and the Adam update is elementwise
  (slice-wise == full vector, bit for bit), so the run after a resize is
  bit-identical to an uninterrupted one whatever the membership
  trajectory: `reference_run` is the membership-free oracle.

Degraded mode, SparkNet-style loose sync (arXiv 1511.06051): a worker
that misses ``sync_every`` step barriers (`StepWatchdog`'s `StepTimeout`
escalation) drops to loose sync: its microbatches are recomputed in the
coordinator, its shard updates queue on its pipe, and the coordinator
broadcasts its last-known param slice (bounded staleness,
`training_elastic_stale_steps_total`). When the queue drains it resyncs
(`training_elastic_resync_seconds`); past ``stale_bound`` pending
updates it is evicted, and the evict path's checkpoint restore discards
the loose steps, restoring bit-exactness. No checkpoint is taken while a
worker is loose.

Devices: the coordinator's in-process fallback, `reference_run` and every
worker compute on the card unless the caller passes ``device="cpu"``;
there is no CPU fallback. Gradients go through `models.transformer.
loss_fn` with `torch.autograd` (the flash kernels on the card) under
`torch.use_deterministic_algorithms(True)`, and every worker is started
with ``CUBLAS_WORKSPACE_CONFIG`` set, so the same microbatch gives the
same bits in every process on the card. The wire is the reference's,
byte for byte: JSON lines, float32 as base64; `ElasticCoordinator.wire` counts its bytes and seconds on the
coordinator's side.

All `training_elastic_*` series register lazily (constructing a
coordinator, or calling `register_elastic_metrics`), so the elastic-off
scrape stays byte-identical; every transition is a typed ``elastic``
flight-recorder event.
"""
from __future__ import annotations

import base64
import contextlib
import json as _json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass
from queue import Empty, Queue
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.observability.events import FlightRecorder
from deeplearning4j_tpu_torch.observability.metrics import default_registry
from deeplearning4j_tpu_torch.parallel.failure import (ElasticFaultInjector,
                                                       StepWatchdog)
from deeplearning4j_tpu_torch.parallel.fsdp import (_sorted_leaves,
                                                    flatten_tree,
                                                    param_shapes,
                                                    unflatten_tree,
                                                    zero1_partition)
from deeplearning4j_tpu_torch.parallel.optim import adam_update_tree
from deeplearning4j_tpu_torch.util.checkpointing import CheckpointManager

log = logging.getLogger("deeplearning4j_tpu_torch")

#: the cuBLAS workspace setting that makes its GEMMs deterministic; every
#: worker starts with it, and a coordinator on the card sets it before
#: its first GEMM when the caller has not
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


# ---------------------------------------------------------------------------
# wire helpers (float32 raw bytes as base64 — the fleet pipe idiom)
# ---------------------------------------------------------------------------

def enc_array(a: np.ndarray) -> str:
    """float32 raw bytes -> base64 text (one JSON-safe pipe field)."""
    return base64.b64encode(
        np.ascontiguousarray(a, dtype=np.float32).tobytes()).decode("ascii")


def dec_array(s: str) -> np.ndarray:
    """Inverse of `enc_array` (owns its buffer — mutable)."""
    return np.frombuffer(base64.b64decode(s), dtype=np.float32).copy()


# ---------------------------------------------------------------------------
# the deterministic data cursor + shared step math
# ---------------------------------------------------------------------------

def data_batch(vocab_size: int, seq_len: int, microbatch_size: int,
               step: int, microbatch: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The elastic data cursor: one (tokens, targets) microbatch as a
    PURE function of ``(step, microbatch)`` — no RNG, no file state.
    Replaying a step range after a lossy resize regenerates the exact
    bytes the lost run saw."""
    base = np.arange(int(seq_len) + 1, dtype=np.int64)[None, :]
    rows = np.arange(int(microbatch_size), dtype=np.int64)[:, None]
    toks = (base * (2 * int(microbatch) + 3) + rows * 7919
            + int(step) * 104729 + int(seed) * 1299709) % int(vocab_size)
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def set_deterministic(mode: bool) -> None:
    """`torch.use_deterministic_algorithms(mode)` without the inductor
    config that function imports (seconds at a worker's start; the port
    compiles nothing with the inductor)."""
    torch._C._set_deterministic_algorithms(bool(mode))


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on for the block, the previous setting
    restored after (the flag is process-wide)."""
    prev = torch.are_deterministic_algorithms_enabled()
    set_deterministic(True)
    try:
        yield
    finally:
        set_deterministic(prev)


def _leaves_to(tree, dev: torch.device) -> dict:
    """A float tree (numpy arrays or tensors) as fresh float32 leaf
    tensors on ``dev`` that require grad, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: _leaves_to(tree[k], dev) for k in sorted(tree)}
    t = torch.as_tensor(tree, dtype=torch.float32).to(dev)
    return t.detach().clone().requires_grad_()


def _rebuild_like(template, leaves: List):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(template)


def make_grad_fn(cfg, device=None):
    """``vg(params, tokens, targets) -> (loss, grads)``: the transformer
    loss and its gradient tree by `torch.autograd` on ``device`` (the
    card unless "cpu"), deterministic algorithms on. ``params`` is a
    tree of float32 arrays or tensors (`unflatten_tree`'s output); the
    loss is a float32 scalar tensor, the gradients float32 tensors on
    the device in the tree's structure. The same function runs in every
    worker and in the coordinator (reference and loose-sync fallback)."""
    from deeplearning4j_tpu_torch.models.transformer import loss_fn
    dev = resolve_device(device)
    if dev.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG",
                              CUBLAS_WORKSPACE_CONFIG)

    def vg(params, tokens, targets):
        tok = torch.as_tensor(np.asarray(tokens)).to(dev)
        tgt = torch.as_tensor(np.asarray(targets)).to(dev)
        with deterministic(), torch.enable_grad():
            live = _leaves_to(params, dev)
            leaves = _sorted_leaves(live)
            loss = loss_fn(cfg, live, tok, tgt)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach().to(torch.float32), _rebuild_like(live,
                                                              list(grads))
    vg.device = dev
    return vg


def param_template(cfg):
    """Abstract param tree (shapes only, the unflatten target): meta
    float32 tensors in `models.transformer.init_params`' layout, whose
    leaves in `parallel.fsdp._sorted_leaves` order have the keys and
    shapes of the reference's `jax.eval_shape` template."""
    def leaf(t):
        if isinstance(t, dict):
            return {k: leaf(v) for k, v in t.items()}
        return torch.empty(t, dtype=torch.float32, device="meta")
    return leaf(param_shapes(cfg))


def init_flat_params(cfg, params_seed: int = 0) -> np.ndarray:
    """Deterministic flat float32 init vector for ``params_seed``: the
    port's seeded `init_params` (values differ from JAX's init)."""
    from deeplearning4j_tpu_torch.models.transformer import init_params
    return flatten_tree(init_params(cfg, int(params_seed), device="cpu"))


def reduce_grads(grads_in_mb_order: List[np.ndarray]) -> np.ndarray:
    """Fixed-order float32 mean on the host — coordinator and oracle
    accumulate microbatch grads in INDEX order, so the reduction is
    stable across memberships."""
    g = np.zeros_like(grads_in_mb_order[0])
    for gi in grads_in_mb_order:
        g = g + gi
    return g / np.float32(len(grads_in_mb_order))


def reduce_losses(losses_in_mb_order: List[float]) -> float:
    """Fixed-order mean of per-microbatch losses (float64 over the
    pipe — exact for float32 values)."""
    return float(sum(losses_in_mb_order) / len(losses_in_mb_order))


def apply_adam_slice(p, g, m, v, t: int, *, learning_rate: float,
                     b1: float, b2: float, eps: float):
    """One Adam update on a contiguous shard via
    `parallel.optim.adam_update_tree` (elementwise, on the device the
    shard lives on; ``t`` as float32): slice-wise application is
    bit-identical to the full vector, so shard boundaries never
    influence values — the ZeRO-1 resharding invariant. Tensors in,
    tensors out on their device; numpy in, float32 numpy out (the CPU)."""
    as_np = isinstance(p, np.ndarray)
    ts = [torch.from_numpy(np.array(x, dtype=np.float32))
          if isinstance(x, np.ndarray) else x for x in (p, g, m, v)]
    dev = ts[0].device
    ts = [x.to(dev, torch.float32) for x in ts]
    out = adam_update_tree(*ts, np.float32(t), learning_rate=learning_rate,
                           b1=b1, b2=b2, eps=eps)
    if as_np:
        return tuple(x.numpy() for x in out)
    return out


# ---------------------------------------------------------------------------
# config + metrics + events
# ---------------------------------------------------------------------------

@dataclass
class ElasticConfig:
    """Knobs of one elastic training run. ``checkpoint_dir`` is
    required — the published checkpoint IS the resize substrate."""
    checkpoint_dir: str
    num_workers: int = 3
    microbatches_per_step: int = 6
    microbatch_size: int = 4
    seq_len: int = 8
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    data_seed: int = 0
    params_seed: int = 0
    checkpoint_every: int = 2
    step_timeout_s: float = 30.0     # barrier deadline (StepWatchdog)
    sync_every: int = 2              # barrier misses before loose sync
    stale_bound: int = 4             # pending loose updates before evict
    barrier_timeout_s: float = 10.0  # gather/adopt resize barriers
    startup_timeout_s: float = 120.0
    drain_timeout_s: float = 30.0    # end-of-run loose drain bound
    max_to_keep: int = 5


def register_elastic_metrics(registry=None) -> Dict[str, object]:
    """Lazily register the `training_elastic_*` family (get-or-create)
    — called from the coordinator constructor, never at import, so an
    elastic-off process scrapes byte-identically."""
    reg = registry if registry is not None else default_registry()
    return {
        "workers": reg.gauge(
            "training_elastic_workers",
            "Live elastic training workers"),
        "resizes": reg.counter(
            "training_elastic_resizes_total",
            "Membership resize barriers, by trigger",
            labelnames=("reason",)),
        "stale": reg.counter(
            "training_elastic_stale_steps_total",
            "Shard updates applied loose (stale broadcast slice)"),
        "resync": reg.histogram(
            "training_elastic_resync_seconds",
            "Time from loose-sync entry to caught-up resync"),
        "replayed": reg.counter(
            "training_elastic_replayed_steps_total",
            "Steps replayed from checkpoint after a lossy resize"),
    }


class _MembershipChanged(Exception):
    """Internal control flow: the current step/barrier aborted because
    membership moved (death, eviction, join); the run loop resolves it
    at a resize barrier."""

    def __init__(self, reason: str, wid: Optional[int] = None):
        super().__init__(f"{reason} (worker {wid})")
        self.reason = reason
        self.wid = wid


# ---------------------------------------------------------------------------
# one worker process
# ---------------------------------------------------------------------------

class _WorkerProc:
    """One elastic worker behind stdin/stdout JSON-lines pipes, with a
    reader thread feeding a queue (EOF => dead — the fleet's
    SubprocessReplica recipe). Writes go through a writer thread, so a
    worker that stops reading (SIGSTOPped, or slowed) queues its commands
    in this process instead of blocking the coordinator in a full pipe:
    `send` returns once the line is queued. The constructor starts the
    process and sends its spec; `wait_hello` waits for it to be ready, so
    several workers can start at once. ``wire`` (shared with the
    coordinator) counts the bytes and seconds of JSON on the pipe."""

    def __init__(self, wid: int, spec: dict, wire: Optional[dict] = None):
        self.wid = int(wid)
        self.wire = wire if wire is not None else _new_wire()
        self.hello: dict = {}
        #: seconds from the spawn to the hello
        self.hello_s: Optional[float] = None
        self._spawned_at = time.perf_counter()
        env = dict(os.environ)
        env.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                          else []))
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "deeplearning4j_tpu_torch.train.elastic_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=env)
        self.dead = threading.Event()
        self.queue: Queue = Queue()
        self.inbox: List[dict] = []
        self._outbox: Queue = Queue()
        # the child's last stderr lines: why a worker died before hello
        self.stderr_tail: deque = deque(maxlen=40)
        self._reader = threading.Thread(target=self._read,
                                        name=f"elastic-reader-{wid}",
                                        daemon=True)
        self._reader.start()
        threading.Thread(target=self._read_stderr,
                         name=f"elastic-stderr-{wid}", daemon=True).start()
        self._writer = threading.Thread(target=self._write,
                                        name=f"elastic-writer-{wid}",
                                        daemon=True)
        self._writer.start()
        self.send(spec)

    def _read(self) -> None:
        try:
            for line in self.proc.stdout:
                t0 = time.perf_counter()
                try:
                    msg = _json.loads(line)
                except ValueError:
                    continue
                with self.wire["lock"]:
                    self.wire["recv_bytes"] += len(line)
                    self.wire["parse_s"] += time.perf_counter() - t0
                self.queue.put(msg)
        except Exception:
            pass
        self.dead.set()

    def _read_stderr(self) -> None:
        try:
            for line in self.proc.stderr:
                self.stderr_tail.append(line.decode(errors="replace")
                                        .rstrip())
        except Exception:
            pass

    def _write(self) -> None:
        while True:
            data = self._outbox.get()
            if data is None:
                return
            t0 = time.perf_counter()
            try:
                self.proc.stdin.write(data)
                self.proc.stdin.flush()
            except (BrokenPipeError, OSError, ValueError):
                self.dead.set()
                return
            with self.wire["lock"]:
                self.wire["write_s"] += time.perf_counter() - t0

    def send(self, obj: dict) -> bool:
        """Queue one JSON line for the worker; False once it is dead."""
        if self.dead.is_set():
            return False
        t0 = time.perf_counter()
        data = (_json.dumps(obj) + "\n").encode()
        self._outbox.put(data)
        with self.wire["lock"]:
            self.wire["sent_bytes"] += len(data)
            self.wire["send_s"] += time.perf_counter() - t0
        return True

    def alive(self) -> bool:
        return self.proc.poll() is None and not self.dead.is_set()

    def _pump(self, epoch: Optional[int]) -> None:
        while True:
            try:
                m = self.queue.get_nowait()
            except Empty:
                return
            e = m.get("epoch")
            if epoch is not None and e is not None and e != epoch:
                continue               # stale-epoch response: drop
            self.inbox.append(m)

    def take(self, pred: Callable[[dict], bool],
             epoch: Optional[int] = None) -> Optional[dict]:
        self._pump(epoch)
        for i, m in enumerate(self.inbox):
            if pred(m):
                return self.inbox.pop(i)
        return None

    def take_all(self, pred: Callable[[dict], bool],
                 epoch: Optional[int] = None) -> List[dict]:
        self._pump(epoch)
        out = [m for m in self.inbox if pred(m)]
        self.inbox = [m for m in self.inbox if not pred(m)]
        return out

    def wait_hello(self, timeout_s: float) -> dict:
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            m = self.take(lambda x: x.get("ev") == "hello")
            if m is not None:
                self.hello = m
                self.hello_s = time.perf_counter() - self._spawned_at
                return m
            if not self.alive():
                self.proc.wait(timeout=10)
                raise RuntimeError(
                    f"elastic worker {self.wid} died during startup (rc "
                    f"{self.proc.returncode}): "
                    + " | ".join(list(self.stderr_tail)[-6:]))
            time.sleep(0.01)
        raise RuntimeError(f"elastic worker {self.wid} startup timeout")

    def pause(self) -> None:
        try:
            os.kill(self.proc.pid, signal.SIGSTOP)
        except (OSError, ProcessLookupError):  # pragma: no cover
            pass

    def kill(self) -> None:
        try:
            self.proc.kill()
            self.proc.wait(timeout=10)
        except Exception:  # pragma: no cover
            pass
        self.dead.set()
        self._stop_writer()

    def _stop_writer(self) -> None:
        # the writer drains what is queued (a dead pipe refuses it) and
        # ends at the None
        self._outbox.put(None)
        self._writer.join(timeout=5)

    def close(self) -> None:
        if self.alive():
            self.send({"op": "stop"})
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.kill()
        else:
            self.kill()
        self._stop_writer()
        try:
            self.proc.stdin.close()
        except Exception:  # pragma: no cover
            pass


def _new_wire() -> dict:
    return {"lock": threading.Lock(), "sent_bytes": 0, "recv_bytes": 0,
            "send_s": 0.0, "write_s": 0.0, "parse_s": 0.0, "encode_s": 0.0,
            "decode_s": 0.0}


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------

class ElasticCoordinator:
    """Membership + ZeRO-1 sharding + deterministic resume over N real
    worker processes. `start()`, `run(num_steps)` -> summary dict,
    `close()` (or use as a context manager). ``device``: where the
    workers and the coordinator's own fallback compute (the card unless
    "cpu"; workers get it in their spec, and without it use the card)."""

    def __init__(self, cfg, ecfg: ElasticConfig, *,
                 fault_injector: Optional[ElasticFaultInjector] = None,
                 registry=None, recorder: Optional[FlightRecorder] = None,
                 device=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = resolve_device(device)
        self._device_arg = None if device is None else str(device)
        self.fault_injector = fault_injector
        self.registry = (registry if registry is not None
                         else default_registry())
        self.recorder = (recorder if recorder is not None
                         else FlightRecorder(capacity=4096))
        self.metrics = register_elastic_metrics(self.registry)
        self.manager = CheckpointManager(
            ecfg.checkpoint_dir, max_to_keep=ecfg.max_to_keep,
            use_orbax=False, registry=self.registry)
        self.workers: Dict[int, _WorkerProc] = {}
        self.shards: List[Tuple[int, int, int]] = []   # (wid, lo, hi)
        self.loose: Set[int] = set()
        self.loose_since: Dict[int, float] = {}
        self.pending: Dict[int, int] = {}
        self.miss: Dict[int, int] = {}
        self.worker_state_bytes: Dict[int, int] = {}
        self._pending_joins: List[_WorkerProc] = []
        self.step = 0
        self.epoch = 0
        self.losses: Dict[int, float] = {}
        self.replayed_steps = 0
        self.resizes = 0
        self._next_wid = 0
        self._resize_failed = False
        self.params: Optional[np.ndarray] = None
        self._template = None
        self._vg = None
        #: the pipe's bytes and seconds on this side: JSON text sent and
        #: received, json.dumps (send_s), the writer threads' pipe writes
        #: (write_s, overlapping across workers), json.loads (parse_s),
        #: base64 encode and decode of the float32 vectors
        self.wire = _new_wire()
        self._timeout_event = threading.Event()
        self.watchdog = StepWatchdog(
            ecfg.step_timeout_s,
            escalate=lambda st: self._timeout_event.set(),
            registry=self.registry)
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "ElasticCoordinator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _worker_spec(self, wid: int) -> dict:
        e = self.ecfg
        spec = {"cfg": asdict(self.cfg), "worker_id": int(wid),
                "vocab_size": int(self.cfg.vocab_size),
                "seq_len": int(e.seq_len),
                "microbatch_size": int(e.microbatch_size),
                "data_seed": int(e.data_seed),
                "learning_rate": float(e.learning_rate),
                "b1": float(e.b1), "b2": float(e.b2),
                "eps": float(e.eps)}
        if self._device_arg is not None:
            spec["device"] = self._device_arg
        return spec

    def _prebuild(self) -> None:
        """Card workers: the flash kernels' libraries built here, before
        any worker starts, so workers load them and run no nvcc."""
        if self.device.type == "cuda":
            from deeplearning4j_tpu_torch.ops import _build
            _build.ensure_built("flash_fwd", "flash_bwd")

    def _launch(self, wid: int) -> _WorkerProc:
        return _WorkerProc(wid, self._worker_spec(wid), self.wire)

    def _spawn(self, wid: int) -> _WorkerProc:
        w = self._launch(wid)
        try:
            w.wait_hello(self.ecfg.startup_timeout_s)
        except BaseException:
            w.kill()
            raise
        return w

    def start(self) -> "ElasticCoordinator":
        if self._started:
            return self
        self._prebuild()
        self._template = param_template(self.cfg)
        self.params = init_flat_params(self.cfg, self.ecfg.params_seed)
        n = int(self.params.size)
        m = np.zeros(n, dtype=np.float32)
        v = np.zeros(n, dtype=np.float32)
        # every worker starts at once; each is admitted on its hello
        started = []
        try:
            for _ in range(int(self.ecfg.num_workers)):
                wid = self._next_wid
                self._next_wid += 1
                started.append(self._launch(wid))
            for w in started:
                w.wait_hello(self.ecfg.startup_timeout_s)
                self.workers[w.wid] = w
                self.recorder.record("elastic", action="join",
                                     worker=w.wid, step=self.step)
        except BaseException:
            for w in started:
                w.kill()
            self.workers.clear()
            raise
        # baseline checkpoint: a kill BEFORE the first periodic save
        # must still have a published verified step to restore from
        self._save_checkpoint(self.params, m, v)
        self._partition_and_adopt(self.params, m, v)
        self.metrics["workers"].set(len(self.workers))
        if self.fault_injector is not None:
            # run the in-coordinator fallback once up front: its first
            # call's set-up inside a straggler step would stall the very
            # barrier that is timing the straggler
            self._local_grad(0, 0)
        self.watchdog.start()
        self._started = True
        return self

    def kill(self) -> None:
        """SIGKILL every worker process (a wedged fleet must die fast)."""
        for w in list(self.workers.values()) + self._pending_joins:
            try:
                w.kill()
            except Exception:  # pragma: no cover
                pass

    def close(self) -> None:
        self.watchdog.stop()
        ws = list(self.workers.values()) + self._pending_joins
        for w in ws:           # every worker stops at once
            if w.alive():
                w.send({"op": "stop"})
        for w in ws:
            try:
                w.close()
            except Exception:  # pragma: no cover
                pass
        self.workers.clear()
        self._pending_joins = []
        self.manager.wait()
        self._started = False

    # -- the wire's float32 fields -------------------------------------------
    def _enc(self, a: np.ndarray) -> str:
        t0 = time.perf_counter()
        s = enc_array(a)
        with self.wire["lock"]:
            self.wire["encode_s"] += time.perf_counter() - t0
        return s

    def _dec(self, s) -> np.ndarray:
        t0 = time.perf_counter()
        a = dec_array(s)
        with self.wire["lock"]:
            self.wire["decode_s"] += time.perf_counter() - t0
        return a

    # -- checkpoint / reshard ---------------------------------------------
    def _save_checkpoint(self, p: np.ndarray, m: np.ndarray,
                         v: np.ndarray) -> None:
        self.manager.save_tree(
            {"p": p, "m": m, "v": v}, self.step,
            meta={"step": int(self.step),
                  "workers": sorted(self.workers),
                  "data_seed": int(self.ecfg.data_seed),
                  "n_params": int(p.size)})
        self.manager.wait()

    def _restore_checkpoint(self) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        n = int(self.params.size)
        template = {k: torch.empty(n, dtype=torch.float32, device="meta")
                    for k in ("p", "m", "v")}
        tree, ck_step = self.manager.restore_tree(template,
                                                  with_step=True,
                                                  device="cpu")
        if tree is None:
            raise RuntimeError("elastic resize: no restorable "
                               "checkpoint published")
        replayed = self.step - int(ck_step)
        if replayed > 0:
            self.metrics["replayed"].inc(replayed)
            self.replayed_steps += replayed
            self.recorder.record("elastic", action="replay",
                                 from_step=int(ck_step),
                                 to_step=int(self.step))
            log.warning("elastic: rewinding %d -> %d (replaying %d "
                        "steps from checkpoint)", self.step, ck_step,
                        replayed)
        self.step = int(ck_step)
        return tuple(tree[k].numpy().astype(np.float32, copy=True)
                     for k in ("p", "m", "v"))

    def _collect_sync(self, wids: Set[int], ev: str,
                      timeout_s: float) -> Dict[int, dict]:
        """Resize-barrier collection (gather/adopt): every worker in
        ``wids`` must answer ``ev`` within ``timeout_s`` or it is
        killed and the resize restarts lossy."""
        got: Dict[int, dict] = {}
        remaining = set(wids)
        deadline = time.perf_counter() + timeout_s
        while remaining:
            for wid in list(remaining):
                w = self.workers.get(wid)
                if w is None or not w.alive():
                    raise _MembershipChanged("worker_lost", wid)
                msg = w.take(lambda x: x.get("ev") == ev,
                             epoch=self.epoch)
                if msg is not None:
                    got[wid] = msg
                    remaining.discard(wid)
            if not remaining:
                break
            if time.perf_counter() > deadline:
                wid = sorted(remaining)[0]
                log.error("elastic: worker %d missed the %s resize "
                          "barrier (%.1fs) — killing it", wid, ev,
                          timeout_s)
                self._kill_worker(wid, "barrier_timeout")
                raise _MembershipChanged("barrier_timeout", wid)
            time.sleep(0.002)
        return got

    def _gather(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All-shards gather from live strict workers into full
        (p, m, v) host vectors — the lossless-resize path."""
        owners = set()
        for wid, lo, hi in self.shards:
            if wid not in self.workers:
                raise _MembershipChanged("shard_owner_gone", wid)
            self.workers[wid].send({"op": "export_shard",
                                    "epoch": self.epoch})
            owners.add(wid)
        got = self._collect_sync(owners, "shard",
                                 self.ecfg.barrier_timeout_s)
        n = int(self.params.size)
        p = np.zeros(n, np.float32)
        m = np.zeros(n, np.float32)
        v = np.zeros(n, np.float32)
        for wid, lo, hi in self.shards:
            msg = got[wid]
            if int(msg["lo"]) != lo or int(msg["hi"]) != hi:
                raise _MembershipChanged("shard_bounds_mismatch", wid)
            p[lo:hi] = self._dec(msg["p"])
            m[lo:hi] = self._dec(msg["m"])
            v[lo:hi] = self._dec(msg["v"])
        return p, m, v

    def _partition_and_adopt(self, p: np.ndarray, m: np.ndarray,
                             v: np.ndarray) -> None:
        wids = sorted(self.workers)
        bounds = zero1_partition(int(p.size), len(wids))
        self.shards = [(wid, lo, hi)
                       for wid, (lo, hi) in zip(wids, bounds)]
        for wid, lo, hi in self.shards:
            ok = self.workers[wid].send(
                {"op": "adopt_shard", "epoch": self.epoch,
                 "lo": lo, "hi": hi, "p": self._enc(p[lo:hi]),
                 "m": self._enc(m[lo:hi]), "v": self._enc(v[lo:hi])})
            if not ok:
                raise _MembershipChanged("pipe_broken", wid)
        got = self._collect_sync(set(wids), "adopted",
                                 self.ecfg.barrier_timeout_s)
        for wid, msg in got.items():
            self.worker_state_bytes[wid] = int(msg["state_bytes"])

    def _kill_worker(self, wid: int, why: str) -> None:
        w = self.workers.get(wid)
        if w is None:
            return
        self.recorder.record("elastic", action="evict", worker=wid,
                             step=self.step, reason=why)
        w.kill()

    def _resize(self, reason: str) -> None:
        while True:
            try:
                self._do_resize(reason)
                return
            except _MembershipChanged as mc:
                reason = mc.reason

    def _do_resize(self, reason: str) -> None:
        self.epoch += 1
        # loose workers cannot join a consistent barrier: evict them
        for wid in sorted(self.loose):
            self._kill_worker(wid, "loose_at_resize")
        owners = {wid for wid, _, _ in self.shards}
        lost_shard = bool(self.loose & owners)
        self.loose.clear()
        self.loose_since.clear()
        for wid in sorted(self.workers):
            if not self.workers[wid].alive():
                if wid in owners:
                    lost_shard = True
                self.recorder.record("elastic", action="kill_detected",
                                     worker=wid, step=self.step)
                self.workers[wid].kill()
                del self.workers[wid]
                self.worker_state_bytes.pop(wid, None)
        for w in self._pending_joins:
            self.workers[w.wid] = w
            self.recorder.record("elastic", action="join",
                                 worker=w.wid, step=self.step)
        self._pending_joins = []
        if not self.workers:
            raise RuntimeError("elastic: no live workers left")
        if lost_shard or self._resize_failed:
            p, m, v = self._restore_checkpoint()
        else:
            p, m, v = self._gather()
            # resharding always proceeds from a PUBLISHED checkpoint:
            # publish the barrier state, then cut the new shards
            self._save_checkpoint(p, m, v)
        self.params = p
        self._resize_failed = True
        self._partition_and_adopt(p, m, v)
        self._resize_failed = False
        self.pending = {wid: 0 for wid in self.workers}
        self.miss = {wid: 0 for wid in self.workers}
        self.resizes += 1
        self.metrics["resizes"].labels(reason).inc()
        self.metrics["workers"].set(len(self.workers))
        self.recorder.record("elastic", action="resize",
                             step=self.step, reason=reason,
                             workers=len(self.workers))
        log.info("elastic: resize (%s) -> %d workers at step %d",
                 reason, len(self.workers), self.step)

    # -- loose-sync bookkeeping -------------------------------------------
    def _note_miss(self, wid: int) -> None:
        self.miss[wid] = self.miss.get(wid, 0) + 1
        if wid not in self.loose \
                and self.miss[wid] >= self.ecfg.sync_every:
            self.loose.add(wid)
            self.loose_since[wid] = time.perf_counter()
            self.recorder.record("elastic", action="loose_enter",
                                 worker=wid, step=self.step,
                                 pending=self.pending.get(wid, 0))
            log.warning("elastic: worker %d dropped to loose sync at "
                        "step %d (%d barrier misses)", wid, self.step,
                        self.miss[wid])

    def _pump_updates(self) -> None:
        """Apply every queued `updated` response (late strict answers
        AND loose backlog drains) in arrival order; resync any loose
        worker whose pending queue hit zero."""
        for wid in sorted(self.workers):
            w = self.workers[wid]
            for msg in w.take_all(
                    lambda x: x.get("ev") == "updated",
                    epoch=self.epoch):
                lo, hi = int(msg["lo"]), int(msg["hi"])
                self.params[lo:hi] = self._dec(msg["p"])
                self.pending[wid] = max(0,
                                        self.pending.get(wid, 0) - 1)
        for wid in sorted(self.loose):
            if self.pending.get(wid, 0) == 0:
                self.loose.discard(wid)
                self.miss[wid] = 0
                dt = time.perf_counter() - self.loose_since.pop(
                    wid, time.perf_counter())
                self.metrics["resync"].observe(dt)
                self.recorder.record("elastic", action="resync",
                                     worker=wid, step=self.step,
                                     pending=0)
                log.info("elastic: worker %d resynced after %.3fs "
                         "loose", wid, dt)

    def _check_evict(self) -> None:
        for wid in sorted(self.loose):
            if self.pending.get(wid, 0) > self.ecfg.stale_bound:
                log.warning("elastic: evicting worker %d (%d pending "
                            "> stale_bound %d)", wid,
                            self.pending[wid], self.ecfg.stale_bound)
                self._kill_worker(wid, "stale_bound")
                # leave the loose set now: the resize detects the dead
                # owner itself (one evict event, not two)
                self.loose.discard(wid)
                self.loose_since.pop(wid, None)
                raise _MembershipChanged("evict", wid)

    # -- the step ----------------------------------------------------------
    def _local_grad(self, step: int, mb: int) -> Tuple[np.ndarray, float]:
        """In-coordinator microbatch gradient on the coordinator's
        device — the guaranteed-progress fallback for a loose/missing
        worker's assignment. The same grad function and inputs as a
        worker's."""
        if self._vg is None:
            self._vg = make_grad_fn(self.cfg, self.device)
        tok, tgt = data_batch(self.cfg.vocab_size, self.ecfg.seq_len,
                              self.ecfg.microbatch_size, step, mb,
                              self.ecfg.data_seed)
        loss, gtree = self._vg(
            unflatten_tree(self.params, self._template), tok, tgt)
        return flatten_tree(gtree), float(loss)

    def _collect_step(self, wids: Set[int], ev: str, step: int,
                      on_msg: Callable[[int, dict], None]) -> Set[int]:
        """Step-barrier collection under the StepWatchdog: returns the
        workers that MISSED the barrier (timeout escalation); a dead
        worker aborts the step into a resize."""
        remaining = set(wids)
        if not remaining:
            return remaining
        self._timeout_event.clear()
        self.watchdog.arm(step)
        hard = (time.perf_counter()
                + 4.0 * self.ecfg.step_timeout_s + 1.0)
        try:
            while remaining:
                progress = False
                for wid in list(remaining):
                    w = self.workers.get(wid)
                    if w is None or not w.alive():
                        raise _MembershipChanged("worker_lost", wid)
                    msg = w.take(
                        lambda x: (x.get("ev") == ev
                                   and x.get("step") == step),
                        epoch=self.epoch)
                    if msg is not None:
                        on_msg(wid, msg)
                        remaining.discard(wid)
                        progress = True
                if not remaining:
                    break
                if self._timeout_event.is_set() \
                        or time.perf_counter() > hard:
                    break
                if not progress:
                    time.sleep(0.002)
        finally:
            self.watchdog.disarm()
        return remaining

    def _train_step(self) -> float:
        step = self.step
        self._pump_updates()
        self._check_evict()
        strict = [wid for wid in sorted(self.workers)
                  if wid not in self.loose]
        if not strict:
            raise _MembershipChanged("no_strict_workers")
        M = int(self.ecfg.microbatches_per_step)
        assign: Dict[int, List[int]] = {}
        for i in range(M):
            assign.setdefault(strict[i % len(strict)], []).append(i)
        pb = self._enc(self.params)
        for wid, mbs in assign.items():
            if not self.workers[wid].send(
                    {"op": "grads", "epoch": self.epoch, "step": step,
                     "mbs": mbs, "params": pb}):
                raise _MembershipChanged("pipe_broken", wid)
        got: Dict[int, Tuple[np.ndarray, float]] = {}

        def _on_grads(wid: int, msg: dict) -> None:
            for mb, g64, lv in zip(msg["mbs"], msg["g"], msg["loss"]):
                got[int(mb)] = (self._dec(g64), float(lv))

        missed = self._collect_step(set(assign), "grads", step,
                                    _on_grads)
        for wid in sorted(missed):
            self._note_miss(wid)
        for wid in set(assign) - missed:
            self.miss[wid] = 0
        # loose + missed assignments: guaranteed progress in-process
        for mb in range(M):
            if mb not in got:
                got[mb] = self._local_grad(step, mb)
        g = reduce_grads([got[mb][0] for mb in range(M)])
        loss = reduce_losses([got[mb][1] for mb in range(M)])
        # update phase: every shard owner gets its grad slice; strict
        # owners are a barrier, loose owners queue (bounded staleness)
        barrier: Set[int] = set()
        for wid, lo, hi in self.shards:
            w = self.workers.get(wid)
            if w is None:
                raise _MembershipChanged("shard_owner_gone", wid)
            if not w.send({"op": "update", "epoch": self.epoch,
                           "step": step, "t": step + 1,
                           "grad": self._enc(g[lo:hi])}):
                raise _MembershipChanged("pipe_broken", wid)
            self.pending[wid] = self.pending.get(wid, 0) + 1
            if wid in self.loose or wid in missed:
                self.metrics["stale"].inc()
            else:
                barrier.add(wid)

        def _on_updated(wid: int, msg: dict) -> None:
            lo, hi = int(msg["lo"]), int(msg["hi"])
            self.params[lo:hi] = self._dec(msg["p"])
            self.pending[wid] = max(0, self.pending.get(wid, 0) - 1)

        missed2 = self._collect_step(barrier, "updated", step,
                                     _on_updated)
        for wid in sorted(missed2):
            self._note_miss(wid)
            self.metrics["stale"].inc()
        return loss

    # -- injections + run loop --------------------------------------------
    def _apply_injections(self) -> None:
        fi = self.fault_injector
        if fi is None:
            return
        wid = fi.check_kill(self.step)
        if wid is not None and wid in self.workers:
            log.warning("elastic: injected SIGKILL of worker %d at "
                        "step %d", wid, self.step)
            self.workers[wid].kill()
        wid = fi.check_hang(self.step)
        if wid is not None and wid in self.workers:
            log.warning("elastic: injected SIGSTOP of worker %d at "
                        "step %d", wid, self.step)
            self.workers[wid].pause()
        v = fi.check_slow(self.step)
        if v is not None:
            swid, secs = v
            if swid in self.workers:
                self.workers[swid].send({"op": "slow",
                                         "epoch": self.epoch,
                                         "seconds": secs})
        wid = fi.check_join(self.step)
        if wid is not None:
            if wid in self.workers:
                log.warning("elastic: join of worker %d ignored "
                            "(already live)", wid)
            else:
                self._next_wid = max(self._next_wid, wid + 1)
                self._pending_joins.append(self._spawn(wid))

    def _membership_dirty(self) -> Optional[str]:
        if self._pending_joins:
            return "join"
        for wid in sorted(self.workers):
            if wid not in self.loose \
                    and not self.workers[wid].alive():
                return "kill_detected"
        return None

    def add_worker(self, wid: Optional[int] = None) -> int:
        """Spawn + stage a join; it is admitted at the next resize
        barrier (the next run-loop iteration)."""
        if wid is None:
            wid = self._next_wid
        self._next_wid = max(self._next_wid, int(wid) + 1)
        self._pending_joins.append(self._spawn(int(wid)))
        return int(wid)

    def remove_worker(self, wid: int) -> None:
        """Graceful leave: the worker is killed and the next barrier
        reshards without it (its shard is restored from the last
        published checkpoint — same path as a crash, so the result is
        bit-identical either way)."""
        self._kill_worker(int(wid), "leave")

    def _maybe_checkpoint(self) -> None:
        if self.loose:
            return          # no consistent gather while loose
        if self.step % max(1, int(self.ecfg.checkpoint_every)) != 0:
            return
        p, m, v = self._gather()
        self._save_checkpoint(p, m, v)

    def run(self, num_steps: int) -> Dict[str, object]:
        """Train up to global step ``num_steps`` through any membership
        trajectory; returns the summary (final flat params, per-step
        losses — bit-identical to `reference_run` for every strict
        trajectory)."""
        if not self._started:
            self.start()
        num_steps = int(num_steps)
        t0 = time.perf_counter()
        while True:
            while self.step < num_steps:
                self._apply_injections()
                why = self._membership_dirty()
                if why is not None:
                    self._resize(why)
                    continue
                try:
                    loss = self._train_step()
                    self.losses[self.step] = loss
                    self.step += 1
                    self._maybe_checkpoint()
                except _MembershipChanged as mc:
                    self._resize(mc.reason)
            if not self.loose:
                break
            # end-of-run drain: let stragglers flush their queues so
            # the final params include every update; a worker that
            # cannot drain is evicted and the tail replays strictly
            deadline = time.perf_counter() + self.ecfg.drain_timeout_s
            while self.loose and time.perf_counter() < deadline:
                self._pump_updates()
                time.sleep(0.005)
            if self.loose:
                for wid in sorted(self.loose):
                    self._kill_worker(wid, "drain_timeout")
                    self.loose.discard(wid)
                    self.loose_since.pop(wid, None)
                self._resize("evict")
        elapsed = time.perf_counter() - t0
        return {
            "steps": num_steps,
            "losses": [self.losses[i] for i in range(num_steps)],
            "final_loss": self.losses[num_steps - 1],
            "params": self.params.copy(),
            "n_params": int(self.params.size),
            "workers": len(self.workers),
            "resizes": self.resizes,
            "replayed_steps": self.replayed_steps,
            "worker_state_bytes": dict(self.worker_state_bytes),
            "elapsed_s": elapsed,
        }

    def debugz(self) -> Dict[str, object]:
        return {
            "step": self.step,
            "epoch": self.epoch,
            "workers": sorted(self.workers),
            "shards": [list(s) for s in self.shards],
            "loose": sorted(self.loose),
            "pending": dict(self.pending),
            "miss": dict(self.miss),
            "worker_state_bytes": dict(self.worker_state_bytes),
            "resizes": self.resizes,
            "replayed_steps": self.replayed_steps,
        }


# ---------------------------------------------------------------------------
# the membership-free oracle
# ---------------------------------------------------------------------------

def reference_run(cfg, ecfg: ElasticConfig, num_steps: int,
                  device=None) -> Dict[str, object]:
    """Single-process oracle on ``device`` (the card unless "cpu"): the
    same math (same data cursor, same grad function, same fixed-order
    host reduction, same elementwise Adam via `apply_adam_slice` on the
    FULL vector, on the device) with no processes, no sharding, no
    membership. Every strict elastic trajectory — uninterrupted,
    kill+rejoin, shrink+grow, hang+evict — must match its output
    bit-for-bit."""
    vg = make_grad_fn(cfg, device)
    dev = vg.device
    template = param_template(cfg)
    p = init_flat_params(cfg, ecfg.params_seed)
    pt = torch.from_numpy(p.copy()).to(dev)
    mt = torch.zeros_like(pt)
    vt = torch.zeros_like(pt)
    M = int(ecfg.microbatches_per_step)
    losses: List[float] = []
    for step in range(int(num_steps)):
        grads: List[np.ndarray] = []
        mb_losses: List[float] = []
        for mb in range(M):
            tok, tgt = data_batch(cfg.vocab_size, ecfg.seq_len,
                                  ecfg.microbatch_size, step, mb,
                                  ecfg.data_seed)
            loss, gtree = vg(unflatten_tree(p, template), tok, tgt)
            grads.append(flatten_tree(gtree))
            mb_losses.append(float(loss))
        g = reduce_grads(grads)
        losses.append(reduce_losses(mb_losses))
        pt, mt, vt = apply_adam_slice(
            pt, torch.from_numpy(g).to(dev), mt, vt, step + 1,
            learning_rate=ecfg.learning_rate, b1=ecfg.b1, b2=ecfg.b2,
            eps=ecfg.eps)
        p = pt.to("cpu").numpy().copy()
    return {"steps": int(num_steps), "losses": losses,
            "final_loss": losses[-1], "params": p,
            "n_params": int(p.size)}

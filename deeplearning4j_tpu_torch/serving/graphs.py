"""CUDA graphs of the engine's per-tick slot programs.

The reference dispatches a whole decode chunk or speculative round as one
compiled executable per (program, size) key (a closed program set,
tests/test_serving_spec_pipeline.py:167). A torch program launches each
kernel from Python, so on the card the engine replays each such program
as a CUDA graph instead: one graph per key, captured on first use and
replayed for every later call.

What makes a slot program capturable: its geometry is fixed per key; the
pool (caches, ``pos``, ``tok``) is the engine's persistent slot state,
updated in place, so its addresses never change; the weight trees are
fixed; the sampling seed is a Python int. A masked program (grammar
constraints) also holds the per-slot DFA states, a pool tensor updated
in place, and the constraint table, whose two tensors the table rewrites
in place when its grammars change, so a graph captured before a grammar
arrived masks with its rows. The per-call inputs (``bt``, ``active``,
``rem``, ``poison``, and a masked program's seeds ``cseed``,
``cseedval``) are copied into static buffers before each replay, on the
stream the replay then runs on, and the outputs are the graph's static
tensors, which the caller copies off before the next replay of any
graph (the engine enqueues those copies right after the replay, on the
same stream).

Capture: the first call of a key runs eagerly, as the call it is (the
kernels build and load, cuBLAS sets up); the graph is then captured on a
side stream into one private memory pool shared by every graph of the
engine, with the cyclic garbage collector run first and held off during
the capture (a graph it frees mid-capture invalidates the capture). A kernel wrapper's launch counter counts where the wrapper
launches: the eager call and the capture (which launches into the
graph). A replay runs the captured kernels without calling a wrapper,
so it adds to no counter; the engine's ``serving_graph_replays_total``
(``counts["graph_replays"]``) counts replays on the host, outside the
graph,
and what a replay ran on the device is measured from the device's own
trace (chip_smoke.py's profiled ticks). The engine's program cache
drops a key's graph when it evicts the key (`drop`). A failed capture or replay
raises; there is no eager fallback. A failed capture raises
`GraphCaptureError`, which is not a RuntimeError, so the engine's guard
does not retry it: an error mid-capture (out of memory, say) can leave
the caching allocator failing every later allocation, and a retry would
turn a healthy engine's one failure into preemptions and quarantines.
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch


class GraphCaptureError(Exception):
    """A slot program's CUDA graph capture failed (the cause chained)."""


class _Graph:
    """One captured program: its fixed arguments (weights and pool, by
    identity), static input buffers and outputs."""

    def __init__(self, graph, fixed, static_in, static_out):
        self.graph = graph
        self.fixed = fixed
        self.static_in = static_in
        self.static_out = static_out


class SlotGraphs:
    """The CUDA graphs of one engine's slot programs, keyed by (kind,
    size). ``captures`` and ``replays`` are the engine's counters of
    captures and replays, ``pool_bytes`` its gauge of the device memory
    the captures reserved for their pool (registry instruments)."""

    def __init__(self, device: torch.device, captures, replays,
                 pool_bytes):
        self.device = device
        self._captures = captures
        self._replays = replays
        self._pool_bytes = pool_bytes
        self._graphs: Dict[Tuple[str, int], _Graph] = {}
        self._pool = None
        self._stream = None

    def keys(self) -> List[Tuple[str, int]]:
        """The captured (kind, size) keys, in capture order."""
        return list(self._graphs)

    def drop(self, key: Tuple[str, int]) -> Optional[_Graph]:
        """Forget ``key``'s graph (its next call runs eagerly and
        captures again); returns it, or None. The caller keeps it alive
        until the device has run any replay of it already queued."""
        return self._graphs.pop(key, None)

    def call(self, key: Tuple[str, int], fn: Callable, fixed: tuple,
             dyn: tuple, seed: int) -> tuple:
        """``fn(*fixed, *dyn, seed)``: eagerly on the key's first call
        (then captured), else by replaying the key's graph with ``dyn``
        copied into its input buffers. ``fixed`` must be the objects the
        graph was captured on."""
        g = self._graphs.get(key)
        if g is None:
            out = fn(*fixed, *dyn, seed)
            try:
                g = self._capture(fn, fixed, dyn, seed)
            except RuntimeError as e:
                raise GraphCaptureError(
                    f"capture of slot program {key} failed: {e}") from e
            self._graphs[key] = g
            return out
        if len(fixed) != len(g.fixed) or \
                any(a is not b for a, b in zip(fixed, g.fixed)):
            raise RuntimeError(f"slot program {key} called on other weights "
                               "or another pool than it was captured on")
        for buf, x in zip(g.static_in, dyn):
            buf.copy_(x, non_blocking=True)
        g.graph.replay()
        self._replays.inc()
        return g.static_out

    def _capture(self, fn: Callable, fixed: tuple, dyn: tuple,
                 seed: int) -> _Graph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        static_in = tuple(x.clone() for x in dyn)
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        # a graph freed inside a capture (a dropped engine's, reached by
        # the cyclic collector) resets its executable and invalidates the
        # capture: collect first, and hold the collector off until the
        # capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    out = fn(*fixed, *static_in, seed)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(self._stream)
        state = [x for x in fixed if isinstance(x, torch.Tensor)]
        if any(a is not b for a, b in zip(out, state)):
            raise RuntimeError("a captured slot program must return its pool "
                               "tensors themselves (updated in place)")
        self._captures.inc()
        self._pool_bytes.inc(
            torch.cuda.memory_reserved(self.device) - reserved)
        return _Graph(graph, fixed, static_in, tuple(out))

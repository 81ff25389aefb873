"""Nestable trace spans: wall-time histograms + profiler annotations.

`span(name)` is the one tracing primitive: it records the block's wall
time (monotonic `perf_counter`) into the `trace_span_seconds{span=...}`
histogram of a registry, under the slash-joined qualified name of the
enclosing span stack ("fit" inside "epoch" records as "epoch/fit"), and
forwards the same qualified name to `torch.profiler.record_function`
(so the span appears as a host event in a `torch.profiler` trace) and,
once CUDA is initialised, to an NVTX range
(`torch.cuda.nvtx.range_push` / `range_pop`), where the reference
forwards it to `jax.profiler.TraceAnnotation`.

The span stack is thread-local: concurrent threads nest independently.
"""
from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch

from deeplearning4j_tpu_torch.observability.metrics import default_registry

_now = time.perf_counter
_tls = threading.local()

_SPAN_HELP = ("Wall time of observability.tracing spans, labeled by "
              "slash-qualified span name")


def current_span() -> Optional[str]:
    """Qualified name of the innermost active span on this thread."""
    stack = getattr(_tls, "stack", None)
    return "/".join(stack) if stack else None


def _nvtx_on() -> bool:
    """NVTX ranges only where CUDA is up: the first CUDA call must not
    come from a span (nor fail on a CPU-only build)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextmanager
def span(name: str, registry=None):
    """Time a block into `trace_span_seconds{span=<qualified name>}`.

    Nestable; yields the qualified name. `registry=None` publishes to
    the process default registry; pass a `MetricsRegistry` for
    isolation or `NULL_REGISTRY` to disable recording (the annotations
    still fire so profiler traces keep their span markers).
    """
    reg = registry if registry is not None else default_registry()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(str(name))
    qual = "/".join(stack)
    annot = torch.profiler.record_function(qual)
    annot.__enter__()
    nvtx = _nvtx_on()
    if nvtx:
        torch.cuda.nvtx.range_push(qual)
    t0 = _now()
    try:
        yield qual
    finally:
        dt = _now() - t0
        if nvtx:
            torch.cuda.nvtx.range_pop()
        annot.__exit__(None, None, None)
        stack.pop()
        reg.histogram("trace_span_seconds", _SPAN_HELP,
                      labelnames=("span",)).labels(qual).observe(dt)


def traced(name: Optional[str] = None, registry=None):
    """Decorator form of `span` (span name defaults to the function's
    qualified name)."""
    def deco(fn):
        span_name = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(span_name, registry=registry):
                return fn(*args, **kwargs)
        return wrapper
    return deco

"""Thread-safe labeled metrics: Counter / Gauge / Histogram + registry.

The one instrumentation substrate every subsystem publishes into
(the reference's StatsListener→StatsStorage→UI pipeline plus
the throughput-monitoring emphasis of SparkNet/Dragon-Alpha argue for
a single dialect). Design constraints, in order:

- **Near-zero hot-path cost.** An increment is one dict-free attribute
  walk plus one fine-grained `threading.Lock` around a float add
  (~1 µs); the serving engine's decode path adds a handful of these
  per *batch*, against milliseconds-to-seconds of compiled decode.
  Metrics that would need locking on every read (queue depth, breaker
  state) are pull-model instead: `Gauge.set_function` reads the live
  value only when a scrape/snapshot happens.
- **Exact under concurrency.** Every mutable cell carries its own
  lock, so 8 threads hammering one counter lose no updates
  (tests/test_observability.py hammers exactly that).
- **Monotonic timing.** `Histogram.time()` uses `time.perf_counter`,
  never `time.time`, so latency series survive wall-clock steps.
- **Injectable.** A process-default registry (`default_registry()`)
  for the common one-process case, plus freely constructible
  `MetricsRegistry` instances for per-engine isolation, and
  `NULL_REGISTRY` whose instruments are no-ops — the "bare" arm of the
  instrumented-vs-bare comparison (chip_smoke.py phase 3h).

Exposition (Prometheus text / JSON / HTTP) lives in
`observability/export.py`; span-based tracing in
`observability/tracing.py`.
"""
from __future__ import annotations

import bisect
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_now = time.perf_counter

# Prometheus-style latency buckets (seconds): sub-ms dispatch overheads
# through multi-second compiled programs.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

# Compiled-call latency buckets (seconds) for serving prefill / decode
# chunk histograms: those calls run milliseconds (chip) to tens of
# seconds (CPU containers, cold traffic), so DEFAULT_BUCKETS — five of
# whose fourteen edges sit below 10 ms — would pile every observation
# into the top few cells. These trade the sub-ms resolution away for
# an upper range that still separates a 10 s call from a 60 s one.
DECODE_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Timer:
    """Context manager timing a block on the monotonic clock into an
    `observe` callback (Histogram.time / NullHistogram.time)."""

    __slots__ = ("_observe", "_t0")

    def __init__(self, observe: Callable[[float], None]):
        self._observe = observe
        self._t0 = 0.0

    def __enter__(self) -> "_Timer":
        self._t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        self._observe(_now() - self._t0)


class CounterChild:
    """One labeled (or the unlabeled) counter cell."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class GaugeChild:
    """One gauge cell: set/inc/dec, or a pull-model `set_function`
    callback evaluated at read time (zero hot-path cost)."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._value = float(value)     # single store: atomic under GIL

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        return float(fn()) if fn is not None else self._value


class HistogramChild:
    """Fixed-bucket histogram cell; bucket bounds are inclusive upper
    edges (Prometheus `le` semantics)."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # + overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def time(self) -> _Timer:
        return _Timer(self.observe)

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count) — taken
        under the lock so the three are mutually consistent."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, acc = [], 0
        for n in counts:
            acc += n
            cum.append(acc)
        return cum, s, c

    @property
    def value(self) -> float:        # uniform read surface: the sum
        return self._sum


class _MetricFamily:
    """Shared labeled-children machinery for the three metric kinds."""

    kind = "untyped"
    _child_args: tuple = ()

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for l in labelnames:
            if not _LABEL_RE.match(l):
                raise ValueError(f"invalid label name {l!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        """Get-or-create the child for one label-value combination
        (positional in `labelnames` order, or by keyword)."""
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "keyword, not both")
            try:
                values = tuple(kv[l] for l in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}")
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{len(values)} value(s)")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values,
                                                  self._make_child())
        return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; call "
                ".labels(...) first")
        return self._children[()]

    def collect(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_MetricFamily):
    kind = "counter"

    def _make_child(self) -> CounterChild:
        return CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Gauge(_MetricFamily):
    kind = "gauge"

    def _make_child(self) -> GaugeChild:
        return GaugeChild()

    def set(self, value: float) -> None:
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._unlabeled().set_function(fn)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Histogram(_MetricFamily):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _make_child(self) -> HistogramChild:
        return HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._unlabeled().observe(value)

    def time(self) -> _Timer:
        return self._unlabeled().time()


class MetricsRegistry:
    """Get-or-create home for metric families. Re-requesting a name is
    idempotent when kind + labelnames match (listeners constructed
    repeatedly against the process default registry must not fight);
    a kind or label mismatch is a hard error — two subsystems silently
    sharing one name with different shapes is the bug this catches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _MetricFamily] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _MetricFamily:
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if type(m) is not cls or m.labelnames != labelnames:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}; requested {cls.kind} with "
                f"{labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_MetricFamily]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]


class _NullInstrument:
    """No-op stand-in for every instrument kind; `labels` returns
    itself so call chains cost one attribute lookup and nothing else."""

    kind = "null"
    labelnames: Tuple[str, ...] = ()
    value = 0.0
    help = ""

    def labels(self, *a, **k) -> "_NullInstrument":
        return self

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def set_function(self, fn) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def time(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def collect(self):
        return []


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Registry whose instruments do nothing — instrumentation can be
    disabled by injection (the benchmark's "bare" arm) instead of by
    `if` guards at every call site."""

    def counter(self, name, help="", labelnames=()) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name, help="", labelnames=()) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def get(self, name):
        return None

    def collect(self) -> list:
        return []


NULL_REGISTRY = NullRegistry()

_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry: what an exporter scrapes when every
    subsystem publishes into the shared substrate."""
    return _DEFAULT_REGISTRY

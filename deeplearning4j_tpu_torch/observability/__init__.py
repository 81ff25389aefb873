"""Unified observability of the port: metrics registry + trace spans +
exposition, the counterpart of deeplearning4j_tpu/observability/ under
the same names.

- `metrics` — thread-safe `MetricsRegistry` of labeled
  `Counter`/`Gauge`/`Histogram` (fixed buckets, per-cell locks,
  monotonic `perf_counter` timers); a process default registry plus
  injectable instances; `NULL_REGISTRY` to disable by injection.
- `tracing` — nestable `span(name)` context managers recording
  wall-time histograms and forwarding to `torch.profiler.record_function`
  and, on a CUDA device, NVTX ranges.
- `export` — Prometheus text exposition + JSON snapshot, served by the
  stdlib `MetricsServer` (`/metrics`, `/metrics.json`, `/healthz`,
  `/readyz`, `/debugz`, `/slo`, `/timeline.json`, `/profilez`).
- `events` — the per-request flight recorder: a bounded thread-safe
  ring of typed lifecycle events plus `RequestTrace`
  (`RequestHandle.trace`); `NULL_RECORDER` disables by injection.
- `slo` — `SLOTracker`: TTFT / TPOT / e2e / queue-age histograms and
  goodput derived from the traces, with a windowed `report()`.
- `timeline` — Chrome/Perfetto `trace_event` JSON export of the
  recorder: one lane per serving slot plus a queue lane.
- `stitch`, `federation` — distributed-trace stitching and metrics
  federation across replicas (host-only; the fleet router consumes
  them).
- `profiling` — `EngineProfiler` (per-program analytic cost table from
  `program_cost`, per-tick device-time attribution, live `serving_mfu`,
  roofline classification against `util.flops`' card peaks),
  `TenantMeter` (per-tenant FLOP/byte metering with a top-N + "other"
  cardinality bound) and `ProfileCapture` (single-flight
  `/profilez?seconds=N` torch.profiler capture).

Publisher: `serving.InferenceEngine` (its `registry`, `recorder`, `slo`
and `profiler`). Nothing here imports JAX.
"""
from deeplearning4j_tpu_torch.observability.metrics import (  # noqa: F401
    DECODE_LATENCY_BUCKETS, DEFAULT_BUCKETS, Counter, Gauge, Histogram,
    MetricsRegistry, NULL_REGISTRY, NullRegistry, default_registry)
from deeplearning4j_tpu_torch.observability.tracing import (  # noqa: F401
    current_span, span, traced)
from deeplearning4j_tpu_torch.observability.export import (  # noqa: F401
    CONTENT_TYPE_LATEST, MetricsServer, json_snapshot, probe_response,
    prometheus_text, snapshot_prometheus_text)
from deeplearning4j_tpu_torch.observability.events import (  # noqa: F401
    EVENT_KINDS, Event, FlightRecorder, NULL_RECORDER, NULL_TRACE,
    NullRecorder, RequestTrace, TERMINAL_KINDS)
from deeplearning4j_tpu_torch.observability.slo import (  # noqa: F401
    NULL_SLO, SLOTracker, TPOT_BUCKETS)
from deeplearning4j_tpu_torch.observability.timeline import (  # noqa: F401
    timeline_json, trace_events)
from deeplearning4j_tpu_torch.observability.stitch import (  # noqa: F401
    SPAN_NAMES, StitchedTrace, fleet_timeline_json, router_lane_events,
    stitch)
from deeplearning4j_tpu_torch.observability.federation import (  # noqa
    DEFAULT_SERIES_BUDGET, check_cardinality, merge_snapshots,
    series_cardinality)
from deeplearning4j_tpu_torch.observability.profiling import (  # noqa
    DEFAULT_TENANT, EngineProfiler, NULL_PROFILER, NullProfiler,
    OTHER_TENANT, ProfileCapture, TenantMeter, program_cost, roofline)

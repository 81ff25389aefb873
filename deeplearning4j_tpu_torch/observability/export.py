"""Exposition: Prometheus text format, JSON snapshot, HTTP exporter.

`prometheus_text(registry)` renders the text exposition format
(version 0.0.4) an external Prometheus/victoria/grafana-agent scraper
parses: HELP/TYPE headers, label escaping, counters suffixed `_total`,
histograms as cumulative `_bucket{le=...}` series plus `_sum`/`_count`.

`MetricsServer` is the tiny stdlib exporter: `/metrics` (text format),
`/metrics.json` (the JSON snapshot), and `/healthz` + `/readyz` backed
by pluggable callables — wire `InferenceEngine.health` / `.ready`
straight in. The same three endpoints also mount on the training
dashboard (`ui/server.UIServer.attach_metrics`), so one port can serve
charts AND scrapes.

Serving introspection: three more pluggable JSON endpoints —
`/debugz` (`debug=engine.debugz`: slot table, queue ages, breaker
state, recent flight-recorder events), `/slo`
(`slo=engine.slo_report`: the windowed TTFT/TPOT/goodput report), and
`/timeline.json` (`timeline=engine.timeline`: Chrome/Perfetto
trace_event export, one lane per slot plus the queue lane). Each 404s
when its callable isn't wired. A scraper that hangs up mid-response
(half-closed socket, curl ctrl-C) is swallowed in `_send` — client
disconnects must never traceback-spam or destabilize the exporter's
daemon thread.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import urlparse

from deeplearning4j_tpu_torch.observability.metrics import (
    Histogram, default_registry)

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames, labelvalues, extra: str = "") -> str:
    parts = [f'{n}="{_escape_label_value(str(v))}"'
             for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry=None) -> str:
    """Render a registry in the Prometheus text exposition format."""
    reg = registry if registry is not None else default_registry()
    lines = []
    for fam in reg.collect():
        name = fam.name
        if fam.kind == "counter" and not name.endswith("_total"):
            name = name + "_total"
        lines.append(f"# HELP {name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for labelvalues, child in fam.collect():
            if isinstance(fam, Histogram):
                cum, total, count = child.snapshot()
                edges = [*fam.buckets, float("inf")]
                for edge, c in zip(edges, cum):
                    le = f'le="{_fmt(edge)}"'
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(fam.labelnames, labelvalues, le)}"
                        f" {c}")
                base = _label_str(fam.labelnames, labelvalues)
                lines.append(f"{name}_sum{base} {_fmt(total)}")
                lines.append(f"{name}_count{base} {count}")
            else:
                lines.append(
                    f"{name}{_label_str(fam.labelnames, labelvalues)}"
                    f" {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def snapshot_prometheus_text(snap: Dict[str, dict]) -> str:
    """Render a JSON-schema snapshot (the `json_snapshot` shape — also
    what `observability.federation.merge_snapshots` produces) in the
    Prometheus text exposition format. This is how a fleet router's
    FEDERATED view serves `/metrics`: the merged samples
    exist only as a snapshot, never as live instrument objects, so the
    registry-walking `prometheus_text` cannot render them."""
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        kind = fam.get("kind", "untyped")
        out_name = (name + "_total"
                    if kind == "counter" and not name.endswith("_total")
                    else name)
        lines.append(f"# HELP {out_name} "
                     f"{_escape_help(fam.get('help', ''))}")
        lines.append(f"# TYPE {out_name} {kind}")
        for s in fam.get("samples", ()):
            labels = s.get("labels") or {}
            lnames, lvals = list(labels), list(labels.values())
            if kind == "histogram" or "buckets" in s:
                for edge, c in (s.get("buckets") or {}).items():
                    le = f'le="{edge}"'
                    lines.append(
                        f"{out_name}_bucket"
                        f"{_label_str(lnames, lvals, le)} {int(c)}")
                base = _label_str(lnames, lvals)
                lines.append(f"{out_name}_sum{base} "
                             f"{_fmt(float(s.get('sum', 0.0)))}")
                lines.append(f"{out_name}_count{base} "
                             f"{int(s.get('count', 0))}")
            else:
                lines.append(
                    f"{out_name}{_label_str(lnames, lvals)} "
                    f"{_fmt(float(s.get('value', 0.0)))}")
    return "\n".join(lines) + "\n"


def json_snapshot(registry=None) -> Dict[str, dict]:
    """Machine-readable snapshot: {name: {kind, help, samples: [...]}}.
    Histogram samples carry cumulative buckets + sum + count."""
    reg = registry if registry is not None else default_registry()
    out: Dict[str, dict] = {}
    for fam in reg.collect():
        samples = []
        for labelvalues, child in fam.collect():
            labels = dict(zip(fam.labelnames, labelvalues))
            if isinstance(fam, Histogram):
                cum, total, count = child.snapshot()
                samples.append({"labels": labels,
                                "buckets": dict(zip(
                                    [_fmt(b) for b in fam.buckets]
                                    + ["+Inf"], cum)),
                                "sum": total, "count": count})
            else:
                samples.append({"labels": labels,
                                "value": child.value})
        out[fam.name] = {"kind": fam.kind, "help": fam.help,
                         "samples": samples}
    return out


def probe_response(fn: Optional[Callable[[], object]]):
    """(status_code, body_dict) for a health/readiness callable.

    Contract: no callable → 200 (the process answering IS the
    liveness signal); a dict result reports 200/503 from its "ready"
    key (default True) and is echoed in the body; any other result is
    truth-tested; a raising callable is 503 with the error."""
    if fn is None:
        return 200, {"ok": True}
    try:
        res = fn()
    except Exception as e:
        return 503, {"ok": False, "error": f"{type(e).__name__}: {e}"}
    if isinstance(res, dict):
        ok = bool(res.get("ready", True))
        return (200 if ok else 503), {"ok": ok, **res}
    return (200, {"ok": True}) if res else (503, {"ok": False})


class _MetricsHandler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-metrics/1.0"
    registry = None                  # injected via subclass attrs
    health_fn: Optional[Callable] = None
    ready_fn: Optional[Callable] = None
    debug_fn: Optional[Callable] = None
    slo_fn: Optional[Callable] = None
    timeline_fn: Optional[Callable] = None
    snapshot_fn: Optional[Callable] = None   # federated view override
    profilez_fn: Optional[Callable] = None   # on-demand capture

    def log_message(self, *args) -> None:   # silence request logging
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        # a client that hung up mid-scrape (half-closed socket, curl
        # ctrl-C) raises on the write; that is the CLIENT's problem —
        # swallowing it here keeps the daemon thread from spewing
        # tracebacks via socketserver.handle_error and keeps the
        # exporter serving the next scrape
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            try:
                self.close_connection = True
            except Exception:
                pass

    def _send_callable_json(self, fn: Optional[Callable]) -> None:
        """One pluggable JSON endpoint: 404 when unwired, 500 (with
        the error in the body) when the callable raises — an
        introspection endpoint must never kill the exporter."""
        if fn is None:
            self._send(404, b'{"error": "not wired"}',
                       "application/json")
            return
        try:
            body = json.dumps(fn()).encode()
        except Exception as e:
            self._send(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode(),
                "application/json")
            return
        self._send(200, body, "application/json")

    def do_GET(self) -> None:
        # class-attribute access: plain-function callables stored on
        # the subclass must NOT descriptor-bind to the handler instance
        cls = type(self)
        path = urlparse(self.path).path
        if path == "/metrics":
            # snapshot override: a router serving its
            # FEDERATED fleet view builds the merged snapshot per
            # scrape; a failing federation must 500, never kill the
            # exporter thread
            if cls.snapshot_fn is not None:
                try:
                    body = snapshot_prometheus_text(
                        cls.snapshot_fn()).encode()
                except Exception as e:
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
                    return
                self._send(200, body, CONTENT_TYPE_LATEST)
                return
            self._send(200, prometheus_text(cls.registry).encode(),
                       CONTENT_TYPE_LATEST)
        elif path == "/metrics.json":
            if cls.snapshot_fn is not None:
                self._send_callable_json(cls.snapshot_fn)
                return
            self._send(200, json.dumps(
                json_snapshot(cls.registry)).encode(),
                "application/json")
        elif path == "/healthz":
            code, body = probe_response(cls.health_fn)
            self._send(code, json.dumps(body).encode(),
                       "application/json")
        elif path == "/readyz":
            code, body = probe_response(cls.ready_fn or cls.health_fn)
            self._send(code, json.dumps(body).encode(),
                       "application/json")
        elif path == "/debugz":
            self._send_callable_json(cls.debug_fn)
        elif path == "/slo":
            self._send_callable_json(cls.slo_fn)
        elif path == "/timeline.json":
            self._send_callable_json(cls.timeline_fn)
        elif path == "/profilez":
            # on-demand profiler capture:
            # GET /profilez?seconds=N starts one bounded torch.profiler
            # trace. The callable owns the status semantics — it
            # returns (code, body): 200 started, 503 unsupported/busy
            # (single-flight), 400 bad seconds — because "cannot
            # capture right now" is an HTTP condition, not a server
            # error
            if cls.profilez_fn is None:
                self._send(404, b'{"error": "not wired"}',
                           "application/json")
                return
            from urllib.parse import parse_qs
            qs = parse_qs(urlparse(self.path).query)
            seconds = (qs.get("seconds") or ["1.0"])[0]
            try:
                code, body = cls.profilez_fn(seconds)
                self._send(int(code), json.dumps(body).encode(),
                           "application/json")
            except Exception as e:
                self._send(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")
        else:
            self._send(404, b'{"error": "not found"}',
                       "application/json")


class MetricsServer:
    """Stdlib HTTP exporter over one registry.

    >>> srv = MetricsServer(registry, port=0, health=engine.health,
    ...                     ready=engine.ready)
    >>> # curl http://127.0.0.1:<srv.port>/metrics
    >>> srv.stop()

    `port=0` binds an ephemeral port (read it back from `.port`).
    The server thread is a daemon; `stop()` shuts it down cleanly.

    Serving introspection (optional callables; each endpoint 404s
    when unwired):

    >>> srv = MetricsServer(engine.registry, health=engine.health,
    ...                     ready=engine.ready, debug=engine.debugz,
    ...                     slo=engine.slo_report,
    ...                     timeline=engine.timeline)
    >>> # curl .../debugz  .../slo  .../timeline.json

    ``snapshot`` overrides what `/metrics` and `/metrics.json` serve:
    a callable returning a JSON-schema snapshot (the `json_snapshot`
    shape) rendered per scrape — wire `Router.federate` here and the
    router's port serves the whole FLEET's merged series.

    ``profilez`` wires `GET /profilez?seconds=N`: a
    callable taking the seconds value and returning ``(status, body)``
    — wire `engine.profilez` (single-flight bounded `torch.profiler`
    capture, 503 when unsupported or already capturing) or
    `Router.profilez` for the fleet-fanned version.
    """

    def __init__(self, registry=None, port: int = 0,
                 health: Optional[Callable] = None,
                 ready: Optional[Callable] = None,
                 debug: Optional[Callable] = None,
                 slo: Optional[Callable] = None,
                 timeline: Optional[Callable] = None,
                 snapshot: Optional[Callable] = None,
                 profilez: Optional[Callable] = None):
        self.registry = (registry if registry is not None
                         else default_registry())
        handler = type("BoundMetricsHandler", (_MetricsHandler,),
                       {"registry": self.registry, "health_fn": health,
                        "ready_fn": ready, "debug_fn": debug,
                        "slo_fn": slo, "timeline_fn": timeline,
                        "snapshot_fn": snapshot,
                        "profilez_fn": profilez})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-exporter")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

"""Continuous profiling & cost attribution for the serving engine.

The port's counterpart of deeplearning4j_tpu/observability/profiling.py,
three instruments in one:

- **Per-program device accounting** (`EngineProfiler`). Every serving
  program call carries its analytic cost (FLOPs + bytes of that
  invocation, `program_cost`); the tick loop attributes each tick's
  device-busy interval to the programs dispatched that tick,
  proportionally to their FLOPs, yielding
  ``serving_program_device_seconds_total{program}``,
  ``serving_program_flops_total{program}`` /
  ``serving_program_bytes_total{program}``, achieved FLOP/s and
  bytes/s, a live ``serving_mfu`` gauge (windowed achieved FLOP/s over
  the card's peak, `util.flops`: 0 when the peak is unknown, e.g. on
  the CPU), and a per-program ROOFLINE classification: arithmetic
  intensity (FLOPs/byte) against the card's ridge point (peak FLOP/s ÷
  peak bytes/s).
- **Per-tenant cost metering** (`TenantMeter`). ``submit(tenant=...)``
  threads a tenant label through the request lifecycle; every token a
  request actually COMPUTES (prefilled prompt tokens, prefix-cache hits
  excluded, plus committed decode tokens) bills ``tokens x the
  per-token analytic cost`` of the program call that computed them into
  ``serving_request_cost_flops_total{tenant}`` /
  ``serving_request_cost_bytes_total{tenant}`` /
  ``serving_tenant_tokens_total{tenant,kind}``. The first ``top_n``
  distinct tenants get their own label, everyone later folds into
  ``"other"``. Per-request bills accumulate on the handle
  (``handle.cost_flops``), so ``sum(per-request bills) == the
  counter``.
- **On-demand capture** (`ProfileCapture`). ``/profilez?seconds=N``
  (`observability.export.MetricsServer`) runs one bounded
  ``torch.profiler`` capture (CPU and CUDA activities) into a
  configured directory and writes its Chrome trace there —
  single-flight (a second capture while one runs gets 503), 503 with no
  directory and 503 while another ``torch.profiler`` session is active
  in the process (Kineto allows one; the other session is left as it
  was).

The cost source. The reference reads XLA's cost analysis of each
compiled program (``cost_from_compiled``); PyTorch has none, and
``torch.utils.flop_counter.FlopCounterMode`` cannot see the port's
hand-written kernels. `program_cost` is the analytic count of one slot
program call instead, from the host data the engine holds at dispatch:
the geometry, each slot's position on the device and the tokens the
call advances. A count sized to ``max_len``, as a fixed-shape compiled
program's would be, would overstate a decode chunk's bytes severalfold
(the decode kernels read only up to each slot's position).

Disable-by-injection mirrors the rest of the observability substrate:
`NULL_PROFILER` makes every call a no-op.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("deeplearning4j_tpu_torch")

_perf = time.perf_counter

#: Tenant label under which every tenant past the top-N bound is
#: aggregated — the scrape-side cardinality backstop.
OTHER_TENANT = "other"

#: Default tenant label for requests submitted without ``tenant=`` —
#: unattributed traffic is still metered, just not per-customer.
DEFAULT_TENANT = "default"


def roofline(flops: float, bytes_: float,
             peak_flops: Optional[float],
             peak_bytes_per_s: Optional[float]) -> dict:
    """Roofline classification of one program: arithmetic intensity
    (FLOPs per byte accessed) against the chip's ridge point
    (peak FLOP/s ÷ peak bytes/s). Left of the ridge the roofline's
    slanted (bandwidth) roof binds — memory-bound; right of it the
    flat (compute) roof does. "unknown" when either peak is unknown
    (CPU containers) or the program has no byte estimate."""
    intensity = (flops / bytes_) if bytes_ and bytes_ > 0 else None
    ridge = (peak_flops / peak_bytes_per_s
             if peak_flops and peak_bytes_per_s else None)
    if intensity is None or ridge is None:
        bound = "unknown"
    elif intensity >= ridge:
        bound = "compute"
    else:
        bound = "memory"
    return {"intensity_flops_per_byte": (round(intensity, 3)
                                         if intensity is not None
                                         else None),
            "ridge_flops_per_byte": (round(ridge, 3)
                                     if ridge is not None else None),
            "bound": bound}


# ---------------------------------------------------------------------------
# the analytic cost of one slot program call
# ---------------------------------------------------------------------------

def tree_bytes(params, cfg) -> Dict[str, float]:
    """At-rest bytes of a parameter tree as `program_cost` reads them:
    ``layer`` (one block's tensors: the blocks are stacked over the
    layers), ``head`` (final norm and output matrix) and ``embed_row``
    (one token embedding row and one position row), at their stored
    dtype (a quantized tensor's values and scales)."""
    from deeplearning4j_tpu_torch.quant.model import param_bytes
    head = sum(param_bytes(params[k]) for k in ("lnfg", "lnfb", "Wout"))
    return {"layer": param_bytes(params["blocks"]) / cfg.n_layers,
            "head": float(head),
            "embed_row": (param_bytes(params["embed"]) / cfg.vocab_size
                          + param_bytes(params["pos"]) / cfg.max_len)}


def kv_row_bytes(cfg, kv_mode=None) -> float:
    """Bytes of one K (or V) row of one layer in the pool: D values at
    the pool's dtype, plus the float32 row scale of a quantized pool."""
    import torch
    if kv_mode is not None:
        return cfg.d_model * 1 + 4
    return cfg.d_model * torch.empty(
        (), dtype=cfg.cache_torch_dtype()).element_size()


def _mlp_flops(cfg, n: int) -> float:
    """Matmul FLOPs of one layer's MLP over one call of ``n`` tokens:
    dense, or the MoE router and the experts' two batched products over
    every capacity place (cap = max(1, int(capacity_factor * n / E)),
    `models.transformer.moe_route`), which is what the products run."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.n_experts > 0:
        e = cfg.n_experts
        cap = max(1, int(cfg.capacity_factor * n / e))
        return 2.0 * n * d * e + 4.0 * e * cap * d * f
    return 4.0 * n * d * f


def _linear_flops(cfg, n: int, layers: int, heads: int) -> float:
    """Matmul FLOPs outside attention of ``layers`` blocks over one call
    of ``n`` tokens (four projections and the MLP), plus the output
    head over ``heads`` rows."""
    d = cfg.d_model
    per_layer = 8.0 * n * d * d + _mlp_flops(cfg, n)
    return layers * per_layer + 2.0 * heads * d * cfg.vocab_size


def program_cost(cfg, kind: str, size: int, num_slots: int, ctx, lens, *,
                 kv_mode=None, weights: Optional[dict] = None,
                 draft: Optional[dict] = None, draft_layers: int = 0,
                 page_size: int = 0, max_pages: int = 0) -> dict:
    """The analytic cost of one call of the slot program ``kind`` (a
    `serving.engine` program kind, with or without its ``"_c"`` masked
    suffix: the mask adds no matmul) at ``size`` (bucket, chunk length,
    decode chunk or K) over ``num_slots`` slots.

    ``ctx`` [Ns] and ``lens`` [Ns] are what the host knows at dispatch:
    for a prefill, each slot's start position and the tokens it writes
    (0 for a slot the call passes over); for a decode chunk or a spec
    round, each slot's position on the device and its active steps
    (a spec round: 1 for an active slot). ``weights`` / ``draft`` are
    `tree_bytes` of the live and the draft tree (zeros when None);
    ``page_size`` and ``max_pages`` give a paged pool's gathered view.

    FLOPs: the four projections, the MLP (dense, or MoE router and
    expert products at every capacity place) and the output head, as
    the program runs them on every slot row; and the attention, at the
    rows each kernel or einsum reads (causal over the bucket for the
    one-shot flash prefill; over the whole cache or gathered view for
    the chunked and paged prefill's two-piece einsums; over each slot's
    prefix, position by position, for decode, draft and verify rows).
    Bytes: each matmul's weights at their stored dtype once per use
    (every decode step, draft step and verify row), and the KV rows read
    and written at the pool's dtype, with a paged call's gathers (the
    pages read and the view written, each layer; a paged prefill's
    einsums then read the whole view, decode its rows). Activations
    are not counted. Returns {"flops", "bytes", "linear_flops",
    "attn_flops", "weight_bytes", "kv_bytes"}."""
    base = kind[:-2] if kind.endswith("_c") else kind
    paged = base.startswith("paged_")
    base = base.removeprefix("paged_")
    ns, d, L = int(num_slots), cfg.d_model, cfg.n_layers
    ctx = np.asarray(ctx, np.int64).reshape(ns)
    lens = np.asarray(lens, np.int64).reshape(ns)
    w = weights or {"layer": 0.0, "head": 0.0, "embed_row": 0.0}
    kvb = 2.0 * kv_row_bytes(cfg, kv_mode)          # a K row and a V row
    s = max_pages * page_size if paged else cfg.max_len
    # a paged call gathers each layer's view of every slot's pages (read
    # the pages, write the view) before its attention reads the view
    view = ns * s * kvb
    gather = 2.0 * view if paged else 0.0

    def wbytes(tree, layers, steps, tokens):
        return steps * (layers * tree["layer"] + tree["head"]
                        + tokens * tree["embed_row"])

    if base in ("prefill", "chunked_prefill"):
        t = int(size)
        lin = _linear_flops(cfg, ns * t, L, ns)
        wb = wbytes(w, L, 1, ns * t)
        if base == "prefill" and not paged:
            attn = L * 4.0 * d * ns * t * (t + 1) / 2
            kv = L * int((lens > 0).sum()) * t * kvb
        else:
            attn = L * 4.0 * d * ns * t * (s + t)
            written = ns * t if paged else int(lens.sum())
            kv = L * (written * kvb + gather + view)
        return _cost(lin, attn, wb, kv)

    smax = s - 1
    if base == "decode":
        c = int(size)
        t = np.arange(c)[None, :]
        rows = np.minimum(ctx[:, None] + np.minimum(t, lens[:, None]),
                          smax) + 1                  # [Ns, C]
        lin = c * _linear_flops(cfg, ns, L, ns)
        attn = L * 4.0 * d * float(rows.sum())
        wb = wbytes(w, L, c, ns)
        kv = L * (float(rows.sum()) * kvb + c * ns * kvb + c * gather)
        return _cost(lin, attn, wb, kv)

    if base != "spec":
        raise ValueError(f"unknown program kind {kind!r}")
    k = int(size)
    nd = draft_layers if draft_layers > 0 else L
    dw = draft or w
    act = lens > 0
    # draft step t attends each active slot's prefix through pos + t
    t = np.arange(k)[None, :]
    drows = np.minimum(ctx[:, None] + np.where(act[:, None], t, 0),
                       smax) + 1                     # [Ns, K]
    # verify row t attends pos + t (every slot: the window kernel runs
    # over the pool), and reads the window's rows once a layer
    t1 = np.arange(k + 1)[None, :]
    vrows = np.minimum(ctx[:, None] + t1, smax) + 1  # [Ns, K+1]
    lin = (k * _linear_flops(cfg, ns, nd, ns)
           + (k + 1) * _linear_flops(cfg, ns, L, ns))
    attn = 4.0 * d * (nd * float(drows.sum()) + L * float(vrows.sum()))
    wb = wbytes(dw, nd, k, ns) + wbytes(w, L, k + 1, ns)
    kv = (nd * (float(drows.sum()) * kvb + k * ns * kvb + k * gather)
          + L * (float(vrows[:, -1].sum()) * kvb + (k + 1) * ns * kvb
                 + gather))
    return _cost(lin, attn, wb, kv)


def _cost(lin: float, attn: float, wb: float, kv: float) -> dict:
    return {"flops": lin + attn, "bytes": wb + kv, "linear_flops": lin,
            "attn_flops": attn, "weight_bytes": wb, "kv_bytes": kv}


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------

class TenantMeter:
    """Per-tenant analytic cost counters with a top-N + "other"
    cardinality bound.

    Prometheus counter children are immutable once created, so the
    bound is enforced at label-assignment time: the first ``top_n``
    distinct tenant ids seen get their own label; every later id maps
    to ``"other"``. Host-side per-tenant totals are kept for the SAME
    bounded id set (ranking and reports never resurrect a folded
    tenant), so a hostile stream of unique ids costs one dict entry —
    the "other" row — not one series each.
    """

    def __init__(self, registry, top_n: int = 8):
        self.top_n = max(1, int(top_n))
        self._lock = threading.Lock()
        self._labels: Dict[str, str] = {}
        self._totals: Dict[str, dict] = {}
        self._folded = 0
        self._m_flops = registry.counter(
            "serving_request_cost_flops",
            "Analytic FLOPs billed to requests, by tenant (tokens "
            "actually computed x the per-token XLA cost of the "
            "program that computed them; prefix-cache hits and "
            "migrated KV bill only the tokens recomputed)",
            labelnames=("tenant",))
        self._m_bytes = registry.counter(
            "serving_request_cost_bytes",
            "Analytic bytes accessed billed to requests, by tenant",
            labelnames=("tenant",))
        self._m_tokens = registry.counter(
            "serving_tenant_tokens",
            "Tokens computed for requests, by tenant and kind "
            "(prefill = prompt tokens this engine prefilled, decode "
            "= committed generated tokens)",
            labelnames=("tenant", "kind"))

    def label_for(self, tenant: Optional[str]) -> str:
        t = DEFAULT_TENANT if tenant is None else str(tenant)
        with self._lock:
            lab = self._labels.get(t)
            if lab is None:
                if len(self._labels) < self.top_n:
                    lab = t
                else:
                    lab = OTHER_TENANT
                    self._folded += 1
                self._labels[t] = lab
            return lab

    def bill(self, tenant: Optional[str], flops: float, bytes_: float,
             tokens: int, kind: str) -> str:
        """Record one bill; returns the (bounded) label used."""
        lab = self.label_for(tenant)
        if flops:
            self._m_flops.labels(lab).inc(flops)
        if bytes_:
            self._m_bytes.labels(lab).inc(bytes_)
        if tokens:
            self._m_tokens.labels(lab, kind).inc(tokens)
        with self._lock:
            cell = self._totals.setdefault(
                lab, {"flops": 0.0, "bytes": 0.0,
                      "prefill_tokens": 0, "decode_tokens": 0})
            cell["flops"] += flops
            cell["bytes"] += bytes_
            cell[f"{kind}_tokens"] = (cell.get(f"{kind}_tokens", 0)
                                      + int(tokens))
        return lab

    def report(self) -> dict:
        """Per-tenant bill ranked by FLOPs, plus the fold accounting
        (how many distinct ids landed in "other")."""
        with self._lock:
            totals = {t: dict(v) for t, v in self._totals.items()}
            distinct = len(self._labels)
            folded = self._folded
        ranked = sorted(totals.items(),
                        key=lambda kv: -kv[1]["flops"])
        return {"top_n": self.top_n,
                "distinct_tenants_seen": distinct,
                "bills_folded_to_other": folded,
                "tenants": {t: {
                    "flops": v["flops"], "bytes": v["bytes"],
                    "prefill_tokens": v["prefill_tokens"],
                    "decode_tokens": v["decode_tokens"]}
                    for t, v in ranked}}


def _entry() -> dict:
    return {"flops": 0.0, "bytes": 0.0, "tokens": 0, "invocations": 0,
            "device_seconds": 0.0, "flops_total": 0.0,
            "bytes_total": 0.0}


class EngineProfiler:
    """Per-engine device accounting: program cost table, per-tick
    device-time attribution, live MFU, roofline report, and the tenant
    meter. One instance per engine (injected like recorder/slo);
    enabled is True — `NULL_PROFILER` is the off switch.

    ``peak_flops`` / ``peak_bytes_per_s`` default to the card's entries
    in `util.flops` for ``device`` (None on the CPU → MFU reports 0 and
    rooflines read "unknown"); tests inject synthetic peaks to pin
    classifications.

    A program's cost is per invocation (`program_cost` of that call's
    host data), so ``dispatched(label, cost)`` carries it; the table
    keeps the last call's cost as the label's per-invocation figure
    and the exact totals beside it. With the same cost at every call
    (the reference's fixed-shape programs) the arithmetic is the
    reference's."""

    enabled = True

    def __init__(self, registry, *,
                 peak_flops: Optional[float] = None,
                 peak_bytes_per_s: Optional[float] = None,
                 tenant_top_n: int = 8,
                 window_s: float = 60.0,
                 device=None):
        from deeplearning4j_tpu_torch.util.flops import (
            chip_peak_bytes_per_s, chip_peak_flops)
        self.registry = registry
        if peak_flops is None:
            peak_flops = chip_peak_flops(device)
        if peak_bytes_per_s is None:
            peak_bytes_per_s = chip_peak_bytes_per_s(device)
        self.peak_flops = peak_flops
        self.peak_bytes_per_s = peak_bytes_per_s
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        # program -> per-invocation cost (the last call's), the tokens
        # one invocation computes, and the totals
        self._table: Dict[str, dict] = {}
        # open tick state: (label, cost) dispatched since tick_begin
        # (None = no open tick: such dispatches are not attributed);
        # _last_labels backs commit-only drain ticks (see tick_end)
        self._tick_labels: Optional[List[tuple]] = None
        self._last_labels: List[tuple] = []
        self._window: deque = deque(maxlen=4096)   # (t, flops, bytes,
        #                                             busy_s)
        self.meter = TenantMeter(registry, top_n=tenant_top_n)
        self._m_invocations = registry.counter(
            "serving_program_invocations",
            "Compiled-program dispatches, by program",
            labelnames=("program",))
        self._m_device_seconds = registry.counter(
            "serving_program_device_seconds",
            "Device-busy seconds attributed to each program "
            "(tick busy intervals split across the tick's dispatches "
            "proportionally to their analytic FLOPs)",
            labelnames=("program",))
        self._m_flops = registry.counter(
            "serving_program_flops",
            "Analytic FLOPs dispatched, by program (XLA cost "
            "analysis x invocations)", labelnames=("program",))
        self._m_bytes = registry.counter(
            "serving_program_bytes",
            "Analytic bytes accessed dispatched, by program",
            labelnames=("program",))
        registry.gauge(
            "serving_mfu",
            "Model-FLOPs utilization over the recent window: achieved "
            "analytic FLOP/s / chip peak (0 when the chip peak is "
            "unknown, e.g. CPU)").set_function(lambda: self.mfu())
        registry.gauge(
            "serving_achieved_flops_per_second",
            "Analytic FLOP/s achieved over the recent window"
            ).set_function(lambda: self.achieved()[0])
        registry.gauge(
            "serving_achieved_bytes_per_second",
            "Analytic bytes/s accessed over the recent window"
            ).set_function(lambda: self.achieved()[1])

    # -- cost table ----------------------------------------------------
    def record_program(self, label: str, cost: Optional[dict],
                       tokens: Optional[int]) -> None:
        """Install (or refresh) one program's per-invocation cost.
        Idempotent; a rate-less entry still counts invocations and
        device seconds."""
        with self._lock:
            ent = self._table.setdefault(label, _entry())
            if cost:
                ent["flops"] = float(cost.get("flops", 0.0))
                ent["bytes"] = float(cost.get("bytes", 0.0))
            if tokens:
                ent["tokens"] = int(tokens)

    def has_program(self, label: str) -> bool:
        with self._lock:
            return label in self._table

    def token_cost(self, label: Optional[str]) -> Tuple[float, float]:
        """(flops, bytes) one token costs under ``label``'s program —
        per-invocation cost over the tokens one invocation computes.
        (0, 0) for unknown programs."""
        if label is None:
            return 0.0, 0.0
        with self._lock:
            ent = self._table.get(label)
            if ent is None or not ent["tokens"]:
                return 0.0, 0.0
            return (ent["flops"] / ent["tokens"],
                    ent["bytes"] / ent["tokens"])

    # -- per-tick attribution ------------------------------------------
    def tick_begin(self) -> None:
        self._tick_labels = []

    def dispatched(self, label: str, cost: Optional[dict] = None) -> None:
        """One program dispatch, with this invocation's cost (None: the
        table's). Only attributed when a tick is open."""
        if self._tick_labels is not None:
            self._tick_labels.append((label, cost))

    def tick_end(self, busy_s: float) -> None:
        """Close the tick: attribute its device-busy interval across
        the dispatched programs proportionally to their analytic
        FLOPs (equal split when no program has a rate), advance the
        per-program counters, and push the tick into the MFU
        window. A commit-only tick (the pipelined loop's drain tail:
        it waits on the PREVIOUS tick's dispatches without issuing new
        ones) attributes its busy interval to the previous tick's
        dispatches — attribution conserves the engine's busy total."""
        labels, self._tick_labels = self._tick_labels, None
        busy_s = max(0.0, float(busy_s))
        if not labels:
            if busy_s <= 0.0 or not self._last_labels:
                return
            labels = list(self._last_labels)
            dispatched = False
        else:
            self._last_labels = list(labels)
            dispatched = True
        with self._lock:
            costs = []
            for lab, cost in labels:
                ent = self._table.setdefault(lab, _entry())
                c = cost or ent
                costs.append((lab, ent, float(c.get("flops", 0.0)),
                              float(c.get("bytes", 0.0))))
            weights = [max(0.0, f) for _, _, f, _ in costs]
            total_w = sum(weights)
            if total_w <= 0:
                weights = [1.0] * len(costs)
                total_w = float(len(costs))
            tick_flops = tick_bytes = 0.0
            for (lab, ent, fl, by), w in zip(costs, weights):
                share = busy_s * w / total_w
                ent["device_seconds"] += share
                if share:
                    self._m_device_seconds.labels(lab).inc(share)
                if not dispatched:
                    continue     # drain tail: time only, no new work
                ent["invocations"] += 1
                ent["flops_total"] += fl
                ent["bytes_total"] += by
                tick_flops += fl
                tick_bytes += by
                self._m_invocations.labels(lab).inc()
                if fl:
                    self._m_flops.labels(lab).inc(fl)
                if by:
                    self._m_bytes.labels(lab).inc(by)
        self._window.append((_perf(), tick_flops, tick_bytes, busy_s))

    # -- derived rates -------------------------------------------------
    def achieved(self, window_s: Optional[float] = None
                 ) -> Tuple[float, float]:
        """(FLOP/s, bytes/s) achieved over the recent window —
        analytic work dispatched over wall time elapsed."""
        w = self.window_s if window_s is None else float(window_s)
        now = _perf()
        pts = [p for p in self._window if now - p[0] <= w]
        if not pts:
            return 0.0, 0.0
        elapsed = max(now - pts[0][0], 1e-9)
        return (sum(p[1] for p in pts) / elapsed,
                sum(p[2] for p in pts) / elapsed)

    def mfu(self, window_s: Optional[float] = None) -> float:
        """Live MFU: windowed achieved FLOP/s over the chip peak. 0.0
        when the peak is unknown (the gauge must still scrape)."""
        if not self.peak_flops:
            return 0.0
        return self.achieved(window_s)[0] / self.peak_flops

    # -- tenant billing ------------------------------------------------
    def bill_tokens(self, handle, label: Optional[str], tokens: int,
                    kind: str, rate: Optional[Tuple[float, float]] = None
                    ) -> None:
        """Bill ``tokens`` computed under ``label``'s program to the
        handle's tenant, at ``rate`` (the (flops, bytes) a token of the
        call that computed them cost; None: the table's `token_cost`),
        and accumulate the same amounts on the handle (sum of
        per-request bills == the counters)."""
        if tokens <= 0:
            return
        fl_rate, by_rate = rate if rate is not None \
            else self.token_cost(label)
        flops = fl_rate * tokens
        bytes_ = by_rate * tokens
        tenant = getattr(handle, "tenant", None)
        self.meter.bill(tenant, flops, bytes_, tokens, kind)
        handle.cost_flops = getattr(handle, "cost_flops", 0.0) + flops
        handle.cost_bytes = getattr(handle, "cost_bytes", 0.0) + bytes_

    # -- reports -------------------------------------------------------
    def program_report(self) -> dict:
        """The per-program accounting table: per-invocation analytic
        cost (the mean over its calls), totals, achieved rates, and the
        roofline verdict."""
        with self._lock:
            table = {l: dict(v) for l, v in self._table.items()}
        out = {}
        for lab, ent in sorted(table.items()):
            dev = ent["device_seconds"]
            inv = ent["invocations"]
            fl = ent["flops_total"] / inv if inv else ent["flops"]
            by = ent["bytes_total"] / inv if inv else ent["bytes"]
            row = {"flops_per_invocation": fl,
                   "bytes_per_invocation": by,
                   "tokens_per_invocation": ent["tokens"],
                   "invocations": inv,
                   "device_seconds": dev,
                   "flops_total": ent["flops_total"],
                   "bytes_total": ent["bytes_total"],
                   "achieved_flops_per_s": (
                       round(ent["flops_total"] / dev, 1)
                       if dev > 0 else None),
                   "achieved_bytes_per_s": (
                       round(ent["bytes_total"] / dev, 1)
                       if dev > 0 else None)}
            row.update(roofline(fl, by, self.peak_flops,
                                self.peak_bytes_per_s))
            out[lab] = row
        return out

    def report(self) -> dict:
        """The `profile_report()` body: peaks, live MFU, achieved
        rates, per-program rooflines, per-tenant bills."""
        fl, by = self.achieved()
        return {"peak_flops": self.peak_flops,
                "peak_bytes_per_s": self.peak_bytes_per_s,
                "ridge_flops_per_byte": (
                    round(self.peak_flops / self.peak_bytes_per_s, 3)
                    if self.peak_flops and self.peak_bytes_per_s
                    else None),
                "mfu": round(self.mfu(), 6),
                "achieved_flops_per_s": round(fl, 1),
                "achieved_bytes_per_s": round(by, 1),
                "programs": self.program_report(),
                "tenant_costs": self.meter.report()}


class NullProfiler:
    """No-op twin: disable profiling by injection, never by if-guards
    at the call sites."""

    enabled = False
    peak_flops = None
    peak_bytes_per_s = None

    def record_program(self, label, cost, tokens) -> None:
        pass

    def has_program(self, label) -> bool:
        return True          # suppress costing work at call sites

    def token_cost(self, label):
        return 0.0, 0.0

    def tick_begin(self) -> None:
        pass

    def dispatched(self, label, cost=None) -> None:
        pass

    def tick_end(self, busy_s) -> None:
        pass

    def achieved(self, window_s=None):
        return 0.0, 0.0

    def mfu(self, window_s=None) -> float:
        return 0.0

    def bill_tokens(self, handle, label, tokens, kind, rate=None) -> None:
        pass

    def program_report(self) -> dict:
        return {}

    def report(self) -> dict:
        return {"enabled": False}


NULL_PROFILER = NullProfiler()


def _other_profiler_active() -> bool:
    """Whether a torch.profiler session is running anywhere in the
    process (the profile context's process-wide flag) or on this
    thread."""
    import torch
    from torch.autograd import profiler as ap
    if getattr(ap, "_is_profiler_enabled", False):
        return True
    return bool(torch._C._autograd._profiler_enabled())


class ProfileCapture:
    """Single-flight on-demand `torch.profiler` capture — the
    ``/profilez?seconds=N`` endpoint's backend.

    ``capture(seconds)`` starts one bounded capture (CPU and, with a
    card, CUDA activities) on a daemon thread, which stops it after
    ``seconds`` (bounded by ``max_seconds``) and writes its Chrome
    trace into the directory as ``profilez-<pid>-<n>.json``. It returns
    ``(http_status, body_dict)``:

    - 200: capture started;
    - 503: unsupported (no directory configured), BUSY (one capture at
      a time: `active` stays true until the trace is written), or
      another torch.profiler session is active in the process (Kineto
      runs one at a time; that session is left untouched);
    - 400: unparseable/non-positive seconds.
    """

    def __init__(self, directory: Optional[str],
                 max_seconds: float = 60.0):
        self.directory = str(directory) if directory else None
        self.max_seconds = float(max_seconds)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.captures = 0

    @property
    def active(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def capture(self, seconds: float) -> Tuple[int, dict]:
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            return 400, {"error": f"unparseable seconds {seconds!r}"}
        if seconds <= 0:
            return 400, {"error": "seconds must be > 0"}
        seconds = min(seconds, self.max_seconds)
        if self.directory is None:
            return 503, {"error": "profiler capture unsupported: no "
                                  "profile_dir configured"}
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return 503, {"error": "capture already in progress"}
            if _other_profiler_active():
                return 503, {"error": "another torch.profiler session "
                                      "is active in this process"}
            self.captures += 1
            n = self.captures
            path = os.path.join(self.directory,
                                f"profilez-{os.getpid()}-{n}.json")
            started = threading.Event()
            failed: List[BaseException] = []
            self._thread = threading.Thread(
                target=self._run, args=(seconds, path, started, failed),
                daemon=True, name="profilez-capture")
            self._thread.start()
        started.wait()
        if failed:
            return 503, {"error": f"profiler start failed: "
                                  f"{type(failed[0]).__name__}: "
                                  f"{failed[0]}"}
        return 200, {"started": True, "seconds": seconds,
                     "directory": self.directory, "capture": n}

    def _run(self, seconds: float, path: str, started: threading.Event,
             failed: list) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:
            failed.append(e)
            started.set()
            return
        started.set()
        time.sleep(seconds)
        try:
            prof.stop()
            os.makedirs(self.directory, exist_ok=True)
            prof.export_chrome_trace(path)
        except Exception:
            log.exception("profiler capture failed")

"""Distributed-training phase statistics + HTML timeline export (port of
deeplearning4j_tpu/scaleout/stats.py, a copy on the port's metrics
registry).

Parity with the reference's stats suite (reference:
dl4j-spark/.../impl/paramavg/stats/ParameterAveragingTrainingMasterStats.java
(broadcast/fit/aggregate timings), api/stats/CommonSparkTrainingStats.java,
stats/StatsUtils.java:exportStatsAsHtml — an HTML timeline of training
phases). Phases here: 'split' (batch prep), 'fit' (the data-parallel
step, its gradient all-reduce included), plus any caller-defined
phase.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

from deeplearning4j_tpu_torch.observability.metrics import default_registry


class SparkTrainingStats:
    """Accumulates (phase → list of (start, duration_ms)) timings
    (reference: CommonSparkTrainingStats). Every `add_time` also
    publishes the duration into the `scaleout_phase_seconds{phase=...}`
    histogram of the metrics registry (process default unless
    injected), so phase timings are scrapeable alongside the HTML
    timeline export."""

    def __init__(self, registry=None):
        self.timings: Dict[str, List[Tuple[float, float]]] = \
            defaultdict(list)
        self._t0 = time.time()
        reg = registry if registry is not None else default_registry()
        self._m_phase = reg.histogram(
            "scaleout_phase_seconds",
            "Distributed-training phase wall time",
            labelnames=("phase",))

    def add_time(self, phase: str, start: float, duration_s: float) -> None:
        self.timings[phase].append((start, duration_s * 1000.0))
        self._m_phase.labels(phase).observe(duration_s)

    def get_keys(self) -> List[str]:
        return sorted(self.timings)

    def get_value(self, phase: str) -> List[float]:
        """Durations (ms) for a phase."""
        return [d for _, d in self.timings[phase]]

    def total_ms(self, phase: str) -> float:
        return sum(self.get_value(phase))

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for phase in self.get_keys():
            vals = self.get_value(phase)
            out[phase] = {
                "count": len(vals),
                "total_ms": sum(vals),
                "mean_ms": sum(vals) / len(vals) if vals else 0.0,
                "max_ms": max(vals) if vals else 0.0,
            }
        return out

    def export_stats_html(self, path: str) -> None:
        """Reference: StatsUtils.exportStatsAsHtml — self-contained HTML
        timeline + summary table."""
        rows = []
        t0 = min((s for ph in self.timings.values() for s, _ in ph),
                 default=self._t0)
        for phase, entries in sorted(self.timings.items()):
            for start, dur_ms in entries:
                rows.append({"phase": phase,
                             "start_ms": (start - t0) * 1000.0,
                             "duration_ms": dur_ms})
        summary = self.as_dict()
        html = f"""<!DOCTYPE html><html><head>
<title>Training stats</title><style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: 4px 10px; }}
 .bar {{ position: absolute; height: 14px; background: #36c;
         opacity: 0.7; }}
 #timeline {{ position: relative; height: {20 * len(summary) + 20}px;
              border: 1px solid #ccc; margin-top: 1em; }}
</style></head><body>
<h1>Distributed training stats</h1>
<table><tr><th>Phase</th><th>Count</th><th>Total ms</th><th>Mean ms</th>
<th>Max ms</th></tr>
{"".join(f"<tr><td>{p}</td><td>{v['count']}</td>"
         f"<td>{v['total_ms']:.1f}</td><td>{v['mean_ms']:.2f}</td>"
         f"<td>{v['max_ms']:.2f}</td></tr>" for p, v in summary.items())}
</table>
<div id="timeline"></div>
<script>
const rows = {json.dumps(rows)};
const phases = {json.dumps(sorted(self.timings))};
const tl = document.getElementById('timeline');
const tmax = Math.max(1, ...rows.map(r => r.start_ms + r.duration_ms));
rows.forEach(r => {{
  const d = document.createElement('div');
  d.className = 'bar';
  d.style.left = (100 * r.start_ms / tmax) + '%';
  d.style.width = Math.max(0.2, 100 * r.duration_ms / tmax) + '%';
  d.style.top = (4 + 20 * phases.indexOf(r.phase)) + 'px';
  d.title = r.phase + ': ' + r.duration_ms.toFixed(2) + ' ms';
  tl.appendChild(d);
}});
</script></body></html>"""
        with open(path, "w") as f:
            f.write(html)


@contextmanager
def timed_phase(stats: SparkTrainingStats, phase: str):
    # wall-clock start stays for the HTML timeline's display axis; the
    # DURATION is measured on the monotonic clock so rate/phase metrics
    # survive wall-clock steps (NTP slew, manual resets)
    start = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.add_time(phase, start, time.perf_counter() - t0)

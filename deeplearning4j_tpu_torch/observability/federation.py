"""Metrics federation: N per-replica registries, ONE fleet scrape.

Every engine replica owns a private `MetricsRegistry` (per-engine
counts stay exact), which made "how is the fleet doing" a question
answered by scraping N ports by hand. `merge_snapshots`
folds per-replica JSON snapshots (`export.json_snapshot` for
in-process replicas, the worker's ``/metrics.json`` body for
subprocess ones — the schema is identical by construction) into one
snapshot a router serves from its own ``/metrics``:

- **counters** are SUMMED across replicas under an added ``tier``
  label — the federated ``serving_requests_completed_total{tier=
  "decode"}`` equals the sum of the decode replicas' counters, row for
  row, which is what a fleet-level alert should fire on;
- **histograms** merge bucket-exact: identical bucket edges (same
  code, same buckets) sum cumulative-count-wise — cumulative sums are
  linear — plus summed ``_sum``/``_count``; a replica exposing
  DIFFERENT edges for the same family is skipped with a warning
  rather than silently mis-merged;
- **gauges** stay PER-REPLICA under added ``tier`` + ``replica``
  labels: summing slot-occupancy fractions across replicas is
  meaningless, and the per-replica values are exactly what capacity
  debugging needs.

The label conventions (``tier=`` on everything, ``replica=`` on
gauges only) keep the federated exposition lint-clean and
duplicate-free: merged counter/histogram rows are unique by
(labels + tier), gauge rows by (labels + tier + replica). A kind
mismatch between parts (version-skewed replica) keeps the first
kind and skips the offender — federation must degrade, never take the
fleet scrape down. `check_cardinality` is the guard that fails a
scrape whose label combinations exceed a sane budget before a
downstream Prometheus does. Stdlib-only.
"""
from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Tuple

log = logging.getLogger("deeplearning4j_tpu_torch")

#: default per-family series budget for `check_cardinality`: generous
#: for a fleet of tens of replicas x a handful of label values, tight
#: enough that an unbounded label (request ids, raw prompts) trips it
DEFAULT_SERIES_BUDGET = 256


def merge_snapshots(parts: Iterable[Tuple[dict, dict]],
                    tier_label: str = "tier",
                    replica_label: str = "replica"
                    ) -> Dict[str, dict]:
    """Merge ``(meta, snapshot)`` parts into one federated snapshot.

    ``meta`` carries the part's identity labels, e.g.
    ``{"tier": "decode", "replica": 3}``; ``snapshot`` is the
    `json_snapshot` schema (``{name: {kind, help, samples}}``).
    Returns the same schema, ready for
    `export.snapshot_prometheus_text` or a ``/metrics.json`` body.
    """
    out: Dict[str, dict] = {}
    index: Dict[str, dict] = {}
    for meta, snap in parts:
        tier = str(meta.get(tier_label, "fleet"))
        rep = str(meta.get(replica_label, ""))
        for name, fam in (snap or {}).items():
            kind = fam.get("kind", "untyped")
            dst = out.get(name)
            if dst is None:
                dst = out[name] = {"kind": kind,
                                   "help": fam.get("help", ""),
                                   "samples": []}
                index[name] = {}
            elif dst["kind"] != kind:
                log.warning(
                    "federation: %s is %s here but %s from "
                    "tier=%s replica=%s — skipping the mismatched "
                    "part", name, dst["kind"], kind, tier, rep)
                continue
            idx = index[name]
            for s in fam.get("samples", ()):
                labels = dict(s.get("labels") or {})
                # never clobber a label the series already carries
                # (the router's own serving_tier_* gauges are tier-
                # labeled at the source): the source's value is the
                # truthful one
                labels.setdefault(tier_label, tier)
                if kind == "gauge":
                    labels.setdefault(replica_label, rep)
                    dst["samples"].append(
                        {"labels": labels,
                         "value": float(s.get("value", 0.0))})
                    continue
                key = tuple(sorted(labels.items()))
                cur = idx.get(key)
                if kind == "histogram":
                    bk = dict(s.get("buckets") or {})
                    if cur is None:
                        cur = {"labels": labels, "buckets": bk,
                               "sum": float(s.get("sum", 0.0)),
                               "count": int(s.get("count", 0))}
                        idx[key] = cur
                        dst["samples"].append(cur)
                    elif list(cur["buckets"]) != list(bk):
                        log.warning(
                            "federation: %s bucket edges differ at "
                            "tier=%s replica=%s — skipping that "
                            "replica's cell", name, tier, rep)
                    else:
                        for edge, c in bk.items():
                            cur["buckets"][edge] += c
                        cur["sum"] += float(s.get("sum", 0.0))
                        cur["count"] += int(s.get("count", 0))
                else:                        # counter (and untyped)
                    if cur is None:
                        cur = {"labels": labels, "value": 0.0}
                        idx[key] = cur
                        dst["samples"].append(cur)
                    cur["value"] += float(s.get("value", 0.0))
    return out


def series_cardinality(snap: Dict[str, dict]) -> Dict[str, int]:
    """Label-combination count per family of a snapshot."""
    return {name: len(fam.get("samples", ()))
            for name, fam in snap.items()}


def check_cardinality(snap: Dict[str, dict],
                      budget: int = DEFAULT_SERIES_BUDGET
                      ) -> List[str]:
    """Raise ``ValueError`` when any family's series count exceeds
    ``budget`` — the fleet-scrape guard against an unbounded label
    sneaking into a hot family. Returns the checked family names."""
    offenders = {n: c for n, c in series_cardinality(snap).items()
                 if c > budget}
    if offenders:
        raise ValueError(
            "federated series over the cardinality budget "
            f"({budget}): " + ", ".join(
                f"{n}={c}" for n, c in sorted(offenders.items())))
    return sorted(snap)

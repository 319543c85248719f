"""Shared Prometheus registry for the operator process (the port's own
copy of ``tpu_operator/metrics/registry.py``): the operator's metrics
live on one dedicated CollectorRegistry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from prometheus_client import CollectorRegistry, generate_latest

REGISTRY = CollectorRegistry()


def render_prometheus() -> str:
    return generate_latest(REGISTRY).decode("utf-8")


def histogram_buckets(name: str, labels: Optional[Dict[str, str]] = None,
                      registry: CollectorRegistry = REGISTRY
                      ) -> Dict[float, float]:
    """Cumulative bucket counts of one histogram child, keyed by upper
    bound (+Inf included). Snapshot-diff two of these to get the bucket
    increments of a measured interval (bench.py's percentile rider)."""
    labels = labels or {}
    out: Dict[float, float] = {}
    for family in registry.collect():
        if family.name != name:
            continue
        for sample in family.samples:
            if not sample.name.endswith("_bucket"):
                continue
            sl = dict(sample.labels)
            le = sl.pop("le")
            if sl != labels:
                continue
            out[float(le)] = sample.value
    return out


def quantiles_from_buckets(buckets: Dict[float, float],
                           qs: Sequence[float]) -> Optional[List[float]]:
    """Prometheus histogram_quantile(): linear interpolation within the
    bucket holding the target rank; the +Inf bucket reports its lower
    bound (the highest finite upper bound). None when the histogram saw
    no observations."""
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    out: List[float] = []
    for q in qs:
        rank = q * total
        prev_bound, prev_count = 0.0, 0.0
        value = bounds[-1]
        for b in bounds:
            count = buckets[b]
            if count >= rank:
                if b == float("inf"):
                    # off the histogram's scale: best answer is the
                    # highest finite bound (Prometheus semantics)
                    value = prev_bound if len(bounds) > 1 else 0.0
                elif count == prev_count:
                    value = b
                else:
                    value = prev_bound + (b - prev_bound) * (
                        (rank - prev_count) / (count - prev_count))
                break
            prev_bound, prev_count = b, count
        out.append(value)
    return out

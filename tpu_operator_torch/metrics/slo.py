"""Declarative SLOs with multi-window burn-rate evaluation.

The third layer of the causal lineage plane: the traces and timelines
say *why* something happened; the SLO engine says whether the control
plane is *meeting its promises* — convergence latency, health-lane
queue time, migration success, placement latency — using nothing but
the histogram buckets and counters the operator already exports.

The math is the SRE-workbook burn-rate model: an SLO with objective
``o`` has error budget ``1 - o``; with error rate ``e`` over a window,
the burn rate is ``e / (1 - o)`` (burn 1.0 = spending budget exactly
as fast as the period allows). An SLO *breaches* when every configured
window burns past its threshold — the fast window catches a cliff, the
slow window keeps one blip from paging.

There is no TSDB here: the engine keeps a bounded ring of cumulative
snapshots (one per :meth:`SLOEngine.evaluate` call) and diffs the ring
at each window's edge, which is exactly the increase() a Prometheus
rule would compute. Results are exported as ``gpu_operator_slo_*``
gauges and served at ``/debug/slo``.

The port's own copy of ``tpu_operator/metrics/slo.py``: the same SLOs
over the port's series (``tpu_operator_*`` -> ``gpu_operator_*``, the
controller ``tpuclusterpolicy`` -> ``gpuclusterpolicy``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .registry import REGISTRY, histogram_buckets

__all__ = ["Window", "SLOSpec", "SLOEngine", "SLO_ENGINE",
           "burn_verdict", "DEFAULT_SLOS"]

#: SRE-workbook multi-window defaults: a fast window that notices a
#: cliff within minutes and a slow window that filters blips. The burn
#: thresholds are the classic 2%-of-budget-in-1h / 10%-in-6h pair
#: rescaled to these windows.
DEFAULT_WINDOWS = (
    ("fast", 300.0, 14.4),
    ("slow", 3600.0, 6.0),
)


@dataclass(frozen=True)
class Window:
    name: str
    seconds: float
    burn_threshold: float


@dataclass(frozen=True)
class SLOSpec:
    """One declarative SLO over series the registry already holds.

    ``sli="latency"`` counts an observation good when it lands in a
    histogram bucket at or under ``threshold_s`` (bucket-edge
    resolution, same as a Prometheus recording rule on ``le``);
    ``sli="ratio"`` splits one counter's label values into good and bad
    event classes."""

    name: str
    description: str
    objective: float
    sli: str  # "latency" | "ratio"
    # latency SLI
    histogram: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()
    threshold_s: float = 0.0
    # ratio SLI
    counter: str = ""
    label: str = ""
    good: Tuple[str, ...] = ()
    bad: Tuple[str, ...] = ()
    windows: Tuple[Tuple[str, float, float], ...] = field(
        default=DEFAULT_WINDOWS)


def burn_verdict(good: float, bad: float, objective: float,
                 threshold: float) -> dict:
    """The burn-rate formula on one (good, bad) event split — shared by
    the windowed engine and any deterministic SLI feed (a test's counts).
    With no events at all the SLO is trivially met (burn 0)."""
    total = good + bad
    budget = max(1e-9, 1.0 - objective)
    error_rate = (bad / total) if total else 0.0
    burn = error_rate / budget
    return {
        "good": round(good, 6),
        "bad": round(bad, 6),
        "error_rate": round(error_rate, 6),
        "burn_rate": round(burn, 6),
        "budget_remaining": round(max(0.0, 1.0 - burn), 6),
        "breached": bool(total and burn >= threshold),
    }


# -- default SLO set ---------------------------------------------------------

DEFAULT_SLOS: Tuple[SLOSpec, ...] = (
    SLOSpec(
        name="convergence-latency",
        description="99% of GPUClusterPolicy reconciles complete "
                    "within 1s (the edge-triggered convergence promise)",
        objective=0.99, sli="latency",
        histogram="gpu_operator_reconcile_duration_seconds",
        labels=(("controller", "gpuclusterpolicy"),),
        threshold_s=1.0),
    SLOSpec(
        name="health-lane-queue",
        description="99% of health-lane dequeues wait under 250ms — a "
                    "node-health event never pools behind bulk churn",
        objective=0.99, sli="latency",
        histogram="gpu_operator_workqueue_lane_queue_time_seconds",
        labels=(("lane", "health"),),
        threshold_s=0.25),
    SLOSpec(
        name="migration-success",
        description="90% of elastic slice migration/resize attempts "
                    "complete (no timeout/abort)",
        objective=0.90, sli="ratio",
        counter="gpu_operator_slice_migrations_total",
        label="outcome", good=("migrated", "resized"),
        bad=("timeout", "aborted")),
    SLOSpec(
        name="placement-latency",
        description="99% of placement scoring passes finish within 1s "
                    "at fleet scale",
        objective=0.99, sli="latency",
        histogram="gpu_operator_placement_latency_seconds",
        threshold_s=1.0),
    SLOSpec(
        name="slice-goodput",
        description="90% of acked workload steps land at or above the "
                    "generation-ideal goodput bar (degraded cards burn "
                    "this budget)",
        objective=0.90, sli="ratio",
        counter="gpu_operator_slice_goodput_steps_total",
        label="quality", good=("good",), bad=("degraded",)),
)


class SLOEngine:
    """Windowed burn-rate evaluation over the process registry.

    Each :meth:`evaluate` call appends one cumulative (good, bad)
    snapshot per SLO to a bounded ring, diffs the ring at every window
    edge, exports the ``gpu_operator_slo_*`` gauges, and returns the
    report dict ``/debug/slo`` serves. Callers drive the cadence (the
    manager's health server evaluates on scrape/debug hits); the ring
    caps history at ``max_samples`` snapshots."""

    def __init__(self, specs: Tuple[SLOSpec, ...] = DEFAULT_SLOS,
                 registry=REGISTRY,
                 clock: Callable[[], float] = time.monotonic,
                 max_samples: int = 720):
        self.specs = tuple(specs)
        self.registry = registry
        self.clock = clock
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=max_samples)

    # -- cumulative SLI totals ----------------------------------------------

    def _counter_totals(self, spec: SLOSpec) -> Tuple[float, float]:
        want_good, want_bad = 0.0, 0.0
        base = spec.counter[:-len("_total")] \
            if spec.counter.endswith("_total") else spec.counter
        for family in self.registry.collect():
            if family.name != base:
                continue
            for sample in family.samples:
                if not sample.name.endswith("_total"):
                    continue
                val = sample.labels.get(spec.label)
                if val in spec.good:
                    want_good += sample.value
                elif val in spec.bad:
                    want_bad += sample.value
        return want_good, want_bad

    def _latency_totals(self, spec: SLOSpec) -> Tuple[float, float]:
        buckets = histogram_buckets(spec.histogram, dict(spec.labels),
                                    registry=self.registry)
        if not buckets:
            return 0.0, 0.0
        bounds = sorted(buckets)
        total = buckets[bounds[-1]]
        # good = observations in buckets at or under the threshold
        # (bucket-edge resolution: the smallest bound >= threshold)
        good = 0.0
        for b in bounds:
            if b >= spec.threshold_s:
                good = buckets[b]
                break
        return good, max(0.0, total - good)

    def _totals(self, spec: SLOSpec) -> Tuple[float, float]:
        if spec.sli == "ratio":
            return self._counter_totals(spec)
        return self._latency_totals(spec)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, extra_window_s: Optional[float] = None) -> dict:
        """Snapshot, diff each window edge, export gauges, and return
        the /debug/slo report. ``extra_window_s`` adds one ad-hoc
        window (the ``?window=`` query param) to the report without
        touching the gauges."""
        from .operator_metrics import OPERATOR_METRICS

        now = self.clock()
        totals = {spec.name: self._totals(spec) for spec in self.specs}
        with self._lock:
            self._samples.append((now, totals))
            samples = list(self._samples)

        def window_counts(name: str, seconds: float) -> Tuple[float, float]:
            """increase() over the window: current totals minus the
            newest snapshot at/older than the window edge (zero baseline
            when history is shorter than the window)."""
            edge = now - seconds
            base: Tuple[float, float] = (0.0, 0.0)
            for t, snap in samples:
                if t <= edge:
                    base = snap.get(name, (0.0, 0.0))
                else:
                    break
            cur = totals[name]
            return (max(0.0, cur[0] - base[0]),
                    max(0.0, cur[1] - base[1]))

        slos: List[dict] = []
        for spec in self.specs:
            windows = {}
            breached = True
            for wname, seconds, threshold in spec.windows:
                g, b = window_counts(spec.name, seconds)
                v = burn_verdict(g, b, spec.objective, threshold)
                v["seconds"] = seconds
                v["threshold"] = threshold
                windows[wname] = v
                breached = breached and v["breached"]
                OPERATOR_METRICS.slo_burn_rate.labels(
                    slo=spec.name, window=wname).set(v["burn_rate"])
            total_v = burn_verdict(*totals[spec.name], spec.objective,
                                   threshold=float("inf"))
            if extra_window_s is not None:
                g, b = window_counts(spec.name, extra_window_s)
                windows["query"] = burn_verdict(
                    g, b, spec.objective,
                    spec.windows[0][2] if spec.windows else 1.0)
                windows["query"]["seconds"] = extra_window_s
            OPERATOR_METRICS.slo_budget_remaining.labels(
                slo=spec.name).set(total_v["budget_remaining"])
            OPERATOR_METRICS.slo_breached.labels(
                slo=spec.name).set(1 if breached else 0)
            slos.append({
                "name": spec.name,
                "description": spec.description,
                "objective": spec.objective,
                "sli": spec.sli,
                "breached": breached,
                "budget_remaining": total_v["budget_remaining"],
                "total": {"good": total_v["good"], "bad": total_v["bad"],
                          "error_rate": total_v["error_rate"]},
                "windows": windows,
            })
        return {"evaluated_at": round(now, 3), "slos": slos}

    def reset(self, clock: Optional[Callable[[], float]] = None) -> None:
        with self._lock:
            self._samples.clear()
        if clock is not None:
            self.clock = clock


#: process-wide engine over the shared registry; mutated in place
#: (reset()), never rebound — same contract as TRACER/TIMELINE.
SLO_ENGINE = SLOEngine()

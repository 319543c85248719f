"""Fleet telemetry rollup: the card-to-control-plane loop.

The port's counterpart of ``tpu_operator/metrics/fleet.py``. The on-node
health engine (health_engine.py) publishes a compact, schema-stamped
digest of its cards into the node's ``gpu.graft.dev/health-digest``
annotation on a jittered cadence. This module is the operator-side
consumer:

- **fold**: :class:`FleetTelemetry` registers on the informer cache's
  ``add_delta_listener`` hook and folds each digest as its watch event
  arrives: O(delta), never a poll. The same fold drives the
  ``gpu_operator_fleet_*`` gauges per domain and generation.
- **score**: a hysteresis scorer condemns a node only after
  ``CONDEMN_AFTER`` *consecutive* FAIL digests and absolves it only
  after ``ABSOLVE_AFTER`` consecutive OK digests. Streaks advance per
  digest *publish* (the digest's ``seq``), not per watch delivery, so a
  lease-annotation echo can't double-count a sample. A card that flaps
  FAIL/OK never sustains a streak and therefore never condemns.
- **goodput**: per placed slice, acked workload steps (the
  ``status.migration.ackedStep`` counter the elastic protocol already
  maintains) are rated against the generation-ideal step rate; steps
  land on the ``slice_goodput_steps_total{quality=good|degraded}``
  counter that feeds the ``slice-goodput`` burn-rate SLO.

The GPU node model, where the reference reads GKE's TPU labels: a node
counts when ``labels.is_gpu_node`` says so, its cards are
``gke-accelerator-count`` else ``nvidia.com/gpu`` allocatable (as
placement's ``_node_chips`` reads them), and its generation is the
hardware table's key for ``gpu.product``, else for GKE's accelerator
label. The rollup's domain is GKE's nodepool, else
``{generation}-{gpu.topology}``: a rollup key, not placement's NVLink
domain (an ``mnnvl`` nodepool is both; a single-host pool's domain is
one host in placement and the whole pool here). The goodput bar is keyed
by the port's generations; a request's generation is read from its
``status.pool`` (``nvidia-h100-80gb-hbm3-nvswitch-8``) through the same
table, where the reference takes the pool name's first segment.

The condemned verdict is *published* as the ``GPUTelemetryHealthy``
node condition by controllers/telemetry_controller.py; the placement
engine and eviction path react to the condition, never to this module's
in-memory state: a restarted operator re-earns every condemnation from
fresh streaks instead of trusting a stale ledger.

:func:`rollup_nodes` is the pure aggregation shared by the live
``/debug/fleet`` endpoint, ``gpuop-cfg status``/``top``, and
must-gather's ``fleet/fleet.json``: one formula, four surfaces.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Set

from ..api import labels as L
from ..runtime.objects import (
    annotations_of,
    get_nested,
    labels_of,
    name_of,
    namespace_of,
)
from ..workloads.hardware import chip_spec_for
from .health_engine import parse_digest
from .operator_metrics import OPERATOR_METRICS

ROLLUP_SCHEMA_VERSION = 1

# hysteresis: consecutive FAIL digests before a node is condemned, and
# consecutive OK digests before a condemned node is absolved. A WARN
# digest resets both streaks - it neither condemns nor absolves.
CONDEMN_AFTER = 3
ABSOLVE_AFTER = 2

# steps per wall-second a healthy slice sustains on the reference
# workload, per generation: the goodput denominator. The elastic shim
# acks 3 steps per 20-second tick, so every bar is at most 0.15 and a
# full-speed slice of any generation rates at or above 1.0x its bar.
# Keyed by the port's generations as build_cluster's mix maps the
# reference's: v4 -> a100-sxm, v5p -> h100-sxm and gb200 (the v5e
# pool's 0.12 becomes an H100 pool's 0.15)
IDEAL_STEPS_PER_S = {"a100-sxm": 0.10, "h100-sxm": 0.15, "gb200": 0.15}
DEFAULT_IDEAL_STEPS_PER_S = 0.15
# below this fraction of the generation-ideal rate, acked steps count
# as degraded - the bad half of the slice-goodput SLO's ratio SLI
GOODPUT_DEGRADED_RATIO = 0.5

# gauge re-export cadence: the digest fold itself is O(delta), but the
# rollup behind the fleet gauges is O(fleet), so exporting on every
# delta would turn a publish storm into O(fleet^2) work. Bounding the
# export keeps ingest overhead flat (run_telemetry_bench's <5% bar);
# snapshot() always recomputes fresh regardless.
EXPORT_MIN_INTERVAL_S = 5.0


def ideal_steps_per_s(generation: str) -> float:
    return IDEAL_STEPS_PER_S.get(generation, DEFAULT_IDEAL_STEPS_PER_S)


def node_condemned(node: dict) -> bool:
    """True when the node carries the telemetry condition at status
    False - the published form of the scorer's verdict."""
    for c in get_nested(node, "status", "conditions", default=[]) or []:
        if c.get("type") == L.TELEMETRY_CONDITION:
            return c.get("status") == "False"
    return False


def _generation_of(name: str) -> str:
    spec = chip_spec_for(name)
    return spec.generation if spec is not None else ""


def node_generation(node: dict) -> str:
    """The hardware table's key for a node's card: ``gpu.product``
    first, GKE's accelerator label second, ``"gpu"`` for neither."""
    nl = labels_of(node)
    return (_generation_of(nl.get(L.GPU_PRODUCT, ""))
            or L.accelerator_generation(nl.get(L.GKE_ACCELERATOR, ""))
            or "gpu")


def domain_of(node: dict) -> str:
    """The rollup's domain key for a node: the GKE nodepool (one pool
    per NVLink domain on multi-host ``mnnvl`` shapes), else the
    generation-topology pair single-host pools group under."""
    nl = labels_of(node)
    pool = nl.get(L.GKE_NODEPOOL)
    if pool:
        return pool
    topo = nl.get(L.GPU_TOPOLOGY, "") or "any"
    return f"{node_generation(node)}-{topo}"


def _node_chip_count(node: dict) -> int:
    nl = labels_of(node)
    raw = nl.get(L.GKE_ACCELERATOR_COUNT) or get_nested(
        node, "status", "allocatable", L.GPU_RESOURCE, default="") or "0"
    try:
        return int(str(raw))
    except ValueError:
        return 0


def rollup_nodes(nodes: Iterable[dict],
                 condemned: Optional[Set[str]] = None,
                 digests: Optional[Dict[str, dict]] = None) -> Dict:
    """Aggregate node health digests per domain / generation.

    Pure in its inputs: the live plane feeds its folded store, the CLI
    and must-gather feed a node LIST or dump - byte-identical rollups
    either way. ``condemned`` overrides the per-node condition read
    (the live scorer knows before the condition lands); ``digests``
    supplies already-parsed digests keyed by node name so the live
    plane's export cadence never re-parses the whole fleet."""
    domains: Dict[str, Dict] = {}
    totals = {"nodes": 0, "reporting": 0, "silent": 0, "condemned": 0,
              "chips": 0, "degraded_chips": 0}
    for node in nodes:
        if not L.is_gpu_node(node):
            continue
        name = name_of(node)
        gen = node_generation(node)
        dom = domains.setdefault(domain_of(node), {
            "generation": gen, "nodes": 0, "reporting": 0, "chips": 0,
            "degraded_chips": 0, "condemned": 0,
            "_duty": [], "_hbm": [], "_temp": []})
        totals["nodes"] += 1
        dom["nodes"] += 1
        chips = _node_chip_count(node)
        totals["chips"] += chips
        dom["chips"] += chips
        if (name in condemned) if condemned is not None \
                else node_condemned(node):
            totals["condemned"] += 1
            dom["condemned"] += 1
        digest = digests.get(name) if digests is not None \
            else parse_digest(annotations_of(node).get(L.HEALTH_DIGEST))
        if digest is None:
            totals["silent"] += 1
            continue
        totals["reporting"] += 1
        dom["reporting"] += 1
        grades = digest.get("grades") or {}
        bad = sum(1 for g in grades.values() if g in ("warn", "fail"))
        totals["degraded_chips"] += bad
        dom["degraded_chips"] += bad
        dom["_duty"].append(float(digest.get("duty_pct", 0.0)))
        dom["_hbm"].append(float(digest.get("hbm_free_frac", 1.0)))
        dom["_temp"].append(float(digest.get("temp_max_c", 0.0)))
    for dom in domains.values():
        duty = dom.pop("_duty")
        hbm = dom.pop("_hbm")
        temp = dom.pop("_temp")
        dom["duty_cycle_pct"] = round(sum(duty) / len(duty), 1) \
            if duty else 0.0
        dom["hbm_headroom_frac"] = round(min(hbm), 4) if hbm else 1.0
        dom["temp_max_c"] = round(max(temp), 1) if temp else 0.0
    worst = ""
    reporting = [(d, e) for d, e in domains.items() if e["reporting"]]
    if reporting:
        worst = min(reporting,
                    key=lambda de: (-de[1]["degraded_chips"],
                                    de[1]["hbm_headroom_frac"],
                                    de[0]))[0]
    return {"schema": ROLLUP_SCHEMA_VERSION,
            "domains": {d: domains[d] for d in sorted(domains)},
            "totals": totals,
            "worst_domain": worst}


class FleetTelemetry:
    """O(delta) digest fold + hysteresis scorer + per-slice goodput.

    ``attach(client)`` registers delta listeners for Nodes and
    SliceRequests on a :class:`CachedClient` and seeds from one LIST;
    thereafter every fold rides a watch event. Without the hook (plain
    client) ``resync(nodes)`` feeds a listing through the same fold.
    """

    def __init__(self, metrics=OPERATOR_METRICS,
                 condemn_after: int = CONDEMN_AFTER,
                 absolve_after: int = ABSOLVE_AFTER,
                 now=time.monotonic):
        self.metrics = metrics
        self.condemn_after = int(condemn_after)
        self.absolve_after = int(absolve_after)
        self.now = now
        self._lock = threading.RLock()
        self._nodes: Dict[str, dict] = {}      # GPU nodes, latest object
        self._raw: Dict[str, object] = {}      # node -> last raw digest
        self._digests: Dict[str, dict] = {}    # node -> parsed digest
        self._seq: Dict[str, object] = {}      # node -> last folded seq
        self._fail_streak: Dict[str, int] = {}
        self._ok_streak: Dict[str, int] = {}
        self._condemned: Set[str] = set()
        # request key -> [acked_step, observed_at, goodput_ratio]
        self._goodput: Dict[str, list] = {}
        self._cancels: List = []
        self.export_interval = EXPORT_MIN_INTERVAL_S
        self._export_at: Optional[float] = None

    # -- wiring --------------------------------------------------------------

    def attach(self, client) -> bool:
        reg = getattr(client, "add_delta_listener", None)
        if not callable(reg):
            return False
        # register BEFORE seeding: deltas racing the list re-fold the
        # same digest seq, which the fold dedupes
        self._cancels.append(reg("v1", "Node", self.on_node_delta))
        self._cancels.append(reg("gpu.graft.dev/v1alpha1", "SliceRequest",
                                 self.on_request_delta))
        for node in client.list("v1", "Node"):
            self.on_node_delta("ADDED", node)
        for cr in client.list("gpu.graft.dev/v1alpha1", "SliceRequest"):
            self.on_request_delta("ADDED", cr)
        return True

    def detach(self) -> None:
        cancels, self._cancels = self._cancels, []
        for cancel in cancels:
            try:
                cancel()
            except Exception:
                pass

    def resync(self, nodes: Iterable[dict]) -> None:
        """List-feed fallback for clients without the delta hook."""
        seen = set()
        for node in nodes:
            seen.add(name_of(node))
            self.on_node_delta("MODIFIED", node)
        with self._lock:
            for name in [n for n in self._nodes if n not in seen]:
                self._forget(name)
            self._maybe_export()

    # -- digest fold ---------------------------------------------------------

    def on_node_delta(self, event_type: str, node: dict) -> None:
        name = name_of(node)
        with self._lock:
            if str(event_type).upper() == "DELETED":
                self._forget(name)
                self._maybe_export()
                return
            if not L.is_gpu_node(node):
                return
            self._nodes[name] = node
            raw = annotations_of(node).get(L.HEALTH_DIGEST)
            if raw != self._raw.get(name):
                # parse only when the wire string changed - the common
                # delta on a real fleet is a lease echo, not a publish
                self._raw[name] = raw
                digest = parse_digest(raw)
                if digest is None:
                    self._digests.pop(name, None)
                else:
                    self._digests[name] = digest
                    if digest.get("seq") != self._seq.get(name):
                        # a new publish, not a watch echo: exactly one
                        # streak advance per digest seq
                        self._seq[name] = digest.get("seq")
                        self._advance(name, str(digest.get("status", "")))
            self._maybe_export()

    def _forget(self, name: str) -> None:
        self._nodes.pop(name, None)
        self._raw.pop(name, None)
        self._digests.pop(name, None)
        self._seq.pop(name, None)
        self._fail_streak.pop(name, None)
        self._ok_streak.pop(name, None)
        self._condemned.discard(name)

    def _advance(self, name: str, status: str) -> None:
        if status == "fail":
            self._fail_streak[name] = self._fail_streak.get(name, 0) + 1
            self._ok_streak.pop(name, None)
            if self._fail_streak[name] >= self.condemn_after:
                self._condemned.add(name)
        elif status == "ok":
            self._ok_streak[name] = self._ok_streak.get(name, 0) + 1
            self._fail_streak.pop(name, None)
            if name in self._condemned \
                    and self._ok_streak[name] >= self.absolve_after:
                self._condemned.discard(name)
        else:
            # warn (or unknown): neither consecutive-FAIL nor
            # consecutive-OK - both streaks restart
            self._fail_streak.pop(name, None)
            self._ok_streak.pop(name, None)

    def is_condemned(self, node_name: str) -> bool:
        with self._lock:
            return node_name in self._condemned

    def condemned(self) -> List[str]:
        with self._lock:
            return sorted(self._condemned)

    def fail_streak(self, node_name: str) -> int:
        with self._lock:
            return self._fail_streak.get(node_name, 0)

    def digest_of(self, node_name: str) -> Optional[dict]:
        """The node's last folded digest (a copy), or None."""
        with self._lock:
            digest = self._digests.get(node_name)
            return dict(digest) if digest is not None else None

    # -- goodput -------------------------------------------------------------

    def on_request_delta(self, event_type: str, cr: dict) -> None:
        key = f"{namespace_of(cr) or 'default'}/{name_of(cr)}"
        with self._lock:
            if str(event_type).upper() == "DELETED":
                self._goodput.pop(key, None)
                return
            # the continuously-advancing counter is the workload's
            # durable-checkpoint progress; migration acks only move
            # during a handshake but still count as acked work
            acked = get_nested(cr, "status", "progress",
                               "checkpointedStep", default=None)
            if acked is None:
                acked = get_nested(cr, "status", "migration", "ackedStep",
                                   default=None)
            if acked is None:
                return
            try:
                acked = int(acked)
            except (TypeError, ValueError):
                return
            pool = str(get_nested(cr, "status", "pool", default="") or "")
            gen = _generation_of(pool)
            t = self.now()
            prev = self._goodput.get(key)
            if prev is None:
                self._goodput[key] = [acked, t, None, gen]
                return
            prev[3] = gen or prev[3]
            if acked <= prev[0] or t <= prev[1]:
                return
            steps, dt = acked - prev[0], t - prev[1]
            ratio = (steps / dt) / ideal_steps_per_s(prev[3])
            quality = "good" if ratio >= GOODPUT_DEGRADED_RATIO \
                else "degraded"
            self.metrics.slice_goodput_steps.labels(
                quality=quality).inc(steps)
            self.metrics.fleet_slice_goodput_ratio.labels(
                request=key).set(round(ratio, 4))
            self._goodput[key] = [acked, t, round(ratio, 4), prev[3]]

    # -- export --------------------------------------------------------------

    def _maybe_export(self) -> None:
        """Export the fleet gauges at most once per ``export_interval``
        - the O(fleet) rollup must not ride every O(delta) fold."""
        t = self.now()
        if self._export_at is not None \
                and t - self._export_at < self.export_interval:
            return
        self._export_at = t
        self._export()

    def _export(self) -> None:
        roll = rollup_nodes(self._nodes.values(),
                            condemned=self._condemned,
                            digests=self._digests)
        for dom, entry in roll["domains"].items():
            gen = entry["generation"]
            self.metrics.fleet_duty_cycle_pct.labels(
                domain=dom, generation=gen).set(entry["duty_cycle_pct"])
            self.metrics.fleet_hbm_headroom_fraction.labels(
                domain=dom, generation=gen).set(
                    entry["hbm_headroom_frac"])
            self.metrics.fleet_degraded_chips.labels(
                domain=dom, generation=gen).set(entry["degraded_chips"])
        totals = roll["totals"]
        self.metrics.fleet_digest_nodes.labels(
            state="reporting").set(totals["reporting"])
        self.metrics.fleet_digest_nodes.labels(
            state="silent").set(totals["silent"])
        self.metrics.fleet_digest_nodes.labels(
            state="condemned").set(totals["condemned"])

    def snapshot(self) -> Dict:
        """The ``/debug/fleet`` payload: the rollup plus scorer state
        and per-slice goodput - everything ``gpuop-cfg top`` renders."""
        with self._lock:
            roll = rollup_nodes(self._nodes.values(),
                                condemned=self._condemned,
                                digests=self._digests)
            roll["scorer"] = {
                "condemn_after": self.condemn_after,
                "absolve_after": self.absolve_after,
                "condemned": sorted(self._condemned),
                "fail_streaks": {n: s for n, s in sorted(
                    self._fail_streak.items()) if s},
            }
            slices = {}
            for key, (acked, _t, ratio, gen) in sorted(
                    self._goodput.items()):
                slices[key] = {"acked_steps": acked,
                               "goodput_ratio": ratio,
                               "generation": gen}
            roll["slices"] = slices
            rated = [(v["goodput_ratio"], k) for k, v in slices.items()
                     if v["goodput_ratio"] is not None]
            roll["worst_slices"] = [k for _r, k in sorted(rated)[:5]]
            return roll

    def reset(self, now=None) -> None:
        """Fresh state (chaos/bench isolation): detach listeners, drop
        every streak and goodput ledger, optionally rebase the clock."""
        self.detach()
        with self._lock:
            self._nodes.clear()
            self._raw.clear()
            self._digests.clear()
            self._seq.clear()
            self._fail_streak.clear()
            self._ok_streak.clear()
            self._condemned.clear()
            self._goodput.clear()
            self._export_at = None
            if now is not None:
                self.now = now


#: process-wide instance the Manager attaches and /debug/fleet serves;
#: mutated in place (never rebound) so every importer sees one ledger
FLEET_TELEMETRY = FleetTelemetry()

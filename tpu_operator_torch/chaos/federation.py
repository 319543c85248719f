"""Federation chaos: N cells, one router, seeded partitions.

The port's copy of ``tpu_operator/chaos/federation.py``. Each cell is
the port's ``build_cluster`` mix; the process-wide ``TRACER`` and
``TIMELINE`` are handed back as they were found (``runner.recorders_saved``).

Runs the federation plane (federation/ + runtime/multicell.py) the way
chaos/runner.py runs a single cell: a deterministic synchronous loop
over a virtual clock, a seeded :class:`FaultPlan`, invariant checkers
folding every observation, and a JSON verdict that is byte-identical
per seed. Three scenarios:

- ``cell-partition`` — one cell drops off the global plane; the breaker
  must open (no request ever routed to an Open cell), bound slices ride
  out the window untouched, and past the condemnation horizon they
  migrate cross-cell with no acked work lost. A router crash lands
  mid-window and the rebuilt-from-snapshot router must carry on
  (restart-coherent: the crash-stripped rerun settles byte-identically).
- ``stale-digest`` — a cell stays reachable but its digest publisher
  wedges; the router must age-discount the frozen digest instead of
  trusting its last words.
- ``split-brain-router`` — a shadow router forked from the primary's
  snapshot receives the same digests in seeded-permuted order; every
  decision is compared, and any divergence is a violation (arrival-
  order independence, run as chaos).

Each cell's own control plane (placement reconciler, workload shims)
talks to its apiserver directly — a partition cuts the GLOBAL plane off
from the cell, not the cell off from itself. Only the harness's view
(:class:`_PartitionGate`) fails, which is exactly the asymmetry that
makes "partition is not death" worth testing.
"""

from __future__ import annotations

import json
import logging
import random
from dataclasses import asdict
from typing import Dict, List, Optional

from ..api import labels as L
from ..api.slicerequest import (
    KIND_SLICE_REQUEST,
    MIG_TERMINAL,
    PHASE_PLACED,
    PHASE_UNSCHEDULABLE,
    V1ALPHA1,
)
from ..benchmarks.controlplane import build_cluster
from ..controllers.placement_controller import PlacementReconciler
from ..controllers.slices import migration_of, request_key
from ..federation.digest import cell_digest
from ..federation.router import CELL_OPEN, GlobalRouter
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime import Request
from ..runtime.client import (
    ApiError,
    Client,
    ListOptions,
    ServerUnavailableError,
)
from ..runtime.fake import simulate_kubelet
from ..runtime.multicell import Cell, MultiCellHarness
from ..runtime.objects import get_nested, name_of, namespace_of
from ..runtime.timeline import TIMELINE
from ..workloads.elastic import ElasticWorkload
from .faults import (
    CELL_PARTITION_END,
    CELL_PARTITION_START,
    DIGEST_STALE_END,
    DIGEST_STALE_START,
    ROUTER_CRASH,
    ROUTER_SPLIT,
    SLICE_REQUEST,
    FaultPlan,
    VirtualClock,
)
from .invariants import CrossCellWorkChecker, settled_state_digest

logger = logging.getLogger("tpu_operator_torch.chaos.federation")

NAMESPACE = "default"
N_CELLS = 4
STEP_DT = 20.0
DEFAULT_STEPS = 12
SOAK_PASS_BUDGET = 80

#: Router tuning for the chaos timescale (STEP_DT-second ticks): two
#: failed contacts open a breaker, the condemnation horizon is three
#: ticks, and the first backoff probe lands well after the horizon — so
#: a partition window reliably walks a cell through Suspect → Open →
#: condemned → (heal) → probed-Healthy inside one run.
ROUTER_TUNING = dict(
    failure_threshold=2,
    probe_base_s=6 * STEP_DT,
    probe_cap_s=30 * STEP_DT,
    digest_half_life_s=2 * STEP_DT,
    condemnation_horizon_s=3 * STEP_DT,
)


class _PartitionGate(Client):
    """The global plane's view of one cell's apiserver: a pass-through
    that raises 503 on every verb while the cell is partitioned. The
    cell's own reconciler and shims hold the raw client — only the
    federation harness looks through this gate."""

    def __init__(self, inner: Client):
        self.inner = inner
        self.blocked = False

    def _gate(self) -> None:
        if self.blocked:
            raise ServerUnavailableError(
                "cell partitioned from the global plane")

    def get(self, api_version, kind, name, namespace=None):
        self._gate()
        return self.inner.get(api_version, kind, name, namespace)

    def list(self, api_version, kind, opts=None):
        self._gate()
        return self.inner.list(api_version, kind, opts)

    def create(self, obj):
        self._gate()
        return self.inner.create(obj)

    def update(self, obj):
        self._gate()
        return self.inner.update(obj)

    def update_status(self, obj):
        self._gate()
        return self.inner.update_status(obj)

    def patch(self, api_version, kind, name, patch, namespace=None):
        self._gate()
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def delete(self, api_version, kind, name, namespace=None):
        self._gate()
        return self.inner.delete(api_version, kind, name, namespace)

    def watch(self, api_version, kind, handler, since_rv=None):
        self._gate()
        return self.inner.watch(api_version, kind, handler, since_rv)


class _RouterAudit:
    """Wraps the primary router (and the split-brain shadow, when one is
    forked) so every decision is audited at the decision site: a route
    onto an Open cell or a primary/shadow divergence is recorded as a
    violation the moment it happens, with the breaker state in hand."""

    def __init__(self, primary: GlobalRouter,
                 checker: CrossCellWorkChecker):
        self.primary = primary
        self.shadow: Optional[GlobalRouter] = None
        self.checker = checker
        self.step = 0

    def route(self, chips, generation=None, locality=None):
        decision = self.primary.route(chips, generation=generation,
                                      locality=locality)
        if self.shadow is not None:
            mirror = self.shadow.route(chips, generation=generation,
                                       locality=locality)
            if mirror != decision:
                self.checker.record(
                    "split-brain-router", self.step,
                    f"primary decided {decision}, shadow (permuted "
                    f"digest order) decided {mirror}")
        if decision is not None and self.primary.cells[
                decision["cell"]].state == CELL_OPEN:
            self.checker.record(
                "no-route-to-open", self.step,
                f"routed {chips} chips to Open cell "
                f"{decision['cell']}")
        return decision

    def record_failure(self, cell: str) -> None:
        self.primary.record_failure(cell)
        if self.shadow is not None:
            self.shadow.record_failure(cell)

    def record_success(self, cell: str) -> None:
        self.primary.record_success(cell)
        if self.shadow is not None:
            self.shadow.record_success(cell)

    def __getattr__(self, name):
        return getattr(self.primary, name)


def _record(injected: Dict[str, int], kind: str) -> None:
    injected[kind] = injected.get(kind, 0) + 1
    OPERATOR_METRICS.chaos_faults_injected.labels(kind=kind).inc()


def _settled_state(fakes: Dict[str, Client], pending: list) -> dict:
    """The restart-coherent comparison object: where every request
    ended up, at what size, in which phase — and nothing volatile
    (no step counters, no timestamps, no resourceVersions)."""
    cells: dict = {}
    for cell_name in sorted(fakes):
        rows = {}
        for cr in fakes[cell_name].list(
                V1ALPHA1, KIND_SLICE_REQUEST,
                ListOptions(namespace=NAMESPACE)):
            mig = migration_of(cr)
            rows[request_key(cr)] = {
                "phase": get_nested(cr, "status", "phase") or "Pending",
                "chips": get_nested(cr, "status", "chips", default=0)
                or 0,
                "nodes": sorted(get_nested(cr, "status", "nodes",
                                           default=[]) or []),
                "migration": mig.get("phase") or "",
                "from": mig.get("from") or "",
            }
        cells[cell_name] = rows
    return {"cells": cells,
            "unrouted": sorted(
                f"{namespace_of(cr) or 'default'}/{name_of(cr)}"
                for cr in pending)}


def run_federation_scenario(scenario: str, nodes: int = 100,
                            seed: int = 0,
                            steps: Optional[int] = None) -> dict:
    """Run one federation scenario and return its JSON verdict. Same
    contract as ``chaos.runner.run_scenario``: deterministic per
    (scenario, seed, nodes, steps), ``ok`` = converged with zero
    invariant violations."""
    from ..runtime.tracing import TRACER
    from .runner import recorders_saved

    steps = int(steps or DEFAULT_STEPS)
    root = logging.getLogger("tpu_operator_torch")
    prev_level = root.level
    root.setLevel(logging.CRITICAL)
    try:
        with recorders_saved():
            clock = VirtualClock()
            TRACER.reset(clock=clock, enabled=False)
            TIMELINE.reset(clock=clock, enabled=True)
            out = _run_impl(scenario, nodes, seed, steps, clock)
        if scenario == "cell-partition":
            # restart-coherent: the same seed with ONLY the router crash
            # stripped must settle byte-identically — a crash changing
            # which cell any slice ended up in is the bug class this pins
            with recorders_saved():
                clock2 = VirtualClock()
                TRACER.reset(clock=clock2, enabled=False)
                TIMELINE.reset(clock=clock2, enabled=True)
                base = _run_impl(scenario, nodes, seed, steps, clock2,
                                 strip_crashes=True)
    finally:
        root.setLevel(prev_level)
    if scenario == "cell-partition":
        coherent = (base["converged"]
                    and base["settled_digest"] == out["settled_digest"])
        out["restart_coherent"] = {
            "ok": bool(out["converged"] and coherent),
            "digest": out["settled_digest"],
            "baseline_digest": base["settled_digest"],
            "baseline_converged": base["converged"],
        }
        if not (out["converged"] and coherent):
            out["violations"].append({
                "invariant": "restart-coherent", "step": steps,
                "detail": "crash-stripped rerun settled differently"})
            out["ok"] = False
    return out


def _run_impl(scenario: str, nodes: int, seed: int, steps: int,
              clock: VirtualClock, strip_crashes: bool = False) -> dict:
    per_cell = max(8, nodes // N_CELLS)
    cell_names = [f"cell-{i}" for i in range(N_CELLS)]
    fakes: Dict[str, Client] = {}
    gates: Dict[str, _PartitionGate] = {}
    cells: Dict[str, Cell] = {}
    recons: Dict[str, PlacementReconciler] = {}
    for name in cell_names:
        fake = build_cluster(n_gpu=per_cell)
        fakes[name] = fake
        gates[name] = _PartitionGate(fake)
        recons[name] = PlacementReconciler(
            fake, namespace=NAMESPACE, preemption=False, now=clock,
            cell=name)
        cells[name] = Cell(name, gates[name], reconciler=recons[name],
                           namespace=NAMESPACE)

    checker = CrossCellWorkChecker(namespace=NAMESPACE)
    audit = _RouterAudit(
        GlobalRouter(cell_names, now=clock, **ROUTER_TUNING), checker)
    harness = MultiCellHarness(
        audit, cells, now=clock,
        shim_factory=lambda cell, name, ns, store: ElasticWorkload(
            fakes[cell.name], name, ns, clock=clock, store=store))

    plan = FaultPlan.build(scenario, seed, cell_names, steps)
    injected: Dict[str, int] = {}
    stale: set = set()
    shadow_rng = random.Random(f"split:{scenario}:{seed}")
    last_snap: Optional[dict] = None
    router_crashes = 0

    def contact_pass() -> None:
        tick_digests: List[dict] = []
        for name in audit.primary.cells_to_contact():
            gate = gates[name]
            try:
                # the list IS the probe: a partitioned cell fails here
                gate.list("v1", "Node")
            except ApiError:
                audit.record_failure(name)
                continue
            audit.record_success(name)
            if name in stale:
                digest = harness._last_digest.get(name)  # frozen
            else:
                harness._seq[name] += 1
                digest = cell_digest(cells[name].fleet_index(), name,
                                     harness._seq[name], clock())
                harness._last_digest[name] = digest
            if digest is not None:
                audit.primary.observe_digest(digest)
                tick_digests.append(digest)
        if audit.shadow is not None:
            # the split-brain half: same digest SET, permuted arrival
            permuted = list(tick_digests)
            shadow_rng.shuffle(permuted)
            for digest in permuted:
                audit.shadow.observe_digest(digest)
        audit.primary.export_metrics()

    harness._last_digest = {}

    def cell_pass() -> None:
        for name in sorted(cells):
            fake, recon, cell = fakes[name], recons[name], cells[name]
            for cr in sorted(fake.list(V1ALPHA1, KIND_SLICE_REQUEST,
                                       ListOptions(namespace=NAMESPACE)),
                             key=request_key):
                recon.reconcile(Request(name=name_of(cr),
                                        namespace=namespace_of(cr)))
            simulate_kubelet(fake, ready=True)
            # adopt shims for freshly placed elastic requests (unless
            # the key's shim already lives somewhere — a mid-migration
            # twin must wait for the store to be carried over)
            owned = {k for c in cells.values() for k in c.shims}
            for cr in sorted(fake.list(V1ALPHA1, KIND_SLICE_REQUEST,
                                       ListOptions(namespace=NAMESPACE)),
                             key=request_key):
                key = request_key(cr)
                if (get_nested(cr, "status", "phase") == PHASE_PLACED
                        and name_of(cr).startswith("freq-")
                        and key not in owned):
                    cell.shims[key] = ElasticWorkload(
                        fake, name_of(cr), NAMESPACE, clock=clock)
                    owned.add(key)
        for name in sorted(cells):
            for key in sorted(cells[name].shims):
                cells[name].shims[key].tick()

    def apply_fault(fault) -> None:
        nonlocal last_snap, router_crashes
        if fault.kind == SLICE_REQUEST:
            req_name, _, affinity = fault.arg.partition("@")
            body = {
                "apiVersion": V1ALPHA1, "kind": KIND_SLICE_REQUEST,
                "metadata": {"name": req_name, "namespace": NAMESPACE},
                "spec": {"chips": int(fault.count)},
            }
            if affinity:
                body["metadata"]["annotations"] = {
                    L.CELL_AFFINITY: affinity}
            harness.submit(body)
            _record(injected, fault.kind)
        elif fault.kind == CELL_PARTITION_START:
            gates[fault.arg].blocked = True
            _record(injected, fault.kind)
        elif fault.kind == CELL_PARTITION_END:
            gates[fault.arg].blocked = False
            _record(injected, fault.kind)
        elif fault.kind == DIGEST_STALE_START:
            stale.add(fault.arg)
            _record(injected, fault.kind)
        elif fault.kind == DIGEST_STALE_END:
            stale.discard(fault.arg)
            _record(injected, fault.kind)
        elif fault.kind == ROUTER_CRASH:
            if strip_crashes:
                return
            router_crashes += 1
            _record(injected, fault.kind)
            # the router process dies; its successor warm-restores
            # breaker ledgers + digests from the durable snapshot and
            # re-derives in-flight migrations from the requests' own
            # status — nothing else survives
            audit.primary = GlobalRouter.restore(
                last_snap or {}, cell_names, now=clock, **ROUTER_TUNING)
            harness.recover_migrations()
        elif fault.kind == ROUTER_SPLIT:
            _record(injected, fault.kind)
            audit.shadow = GlobalRouter.restore(
                json.loads(json.dumps(audit.primary.snapshot())),
                cell_names, now=clock, **ROUTER_TUNING)

    def tick(step: int) -> None:
        audit.step = step
        contact_pass()
        harness.route_pass()
        cell_pass()
        harness.migration_pass()
        checker.observe(step, fakes)

    for step in range(steps):
        for fault in plan.for_step(step):
            apply_fault(fault)
        tick(step)
        # the durable router snapshot rides the end of every tick —
        # JSON-roundtripped so a crash restore sees exactly what a
        # process restart would read off disk
        last_snap = json.loads(json.dumps(audit.primary.snapshot(),
                                          sort_keys=True))
        clock.advance(STEP_DT)

    def converged() -> bool:
        if harness.pending or harness.migrations:
            return False
        for cell_name in sorted(fakes):
            for cr in fakes[cell_name].list(
                    V1ALPHA1, KIND_SLICE_REQUEST,
                    ListOptions(namespace=NAMESPACE)):
                if get_nested(cr, "status", "phase") not in (
                        PHASE_PLACED, PHASE_UNSCHEDULABLE):
                    return False
                if migration_of(cr).get("phase", "") not in MIG_TERMINAL:
                    return False
        return True

    soak = 0
    while not converged() and soak < SOAK_PASS_BUDGET:
        soak += 1
        tick(steps + soak - 1)
        last_snap = json.loads(json.dumps(audit.primary.snapshot(),
                                          sort_keys=True))
        clock.advance(STEP_DT)

    settled = _settled_state(fakes, harness.pending)
    is_converged = converged()
    cells_block = {}
    for name in sorted(cells):
        rows = [cr for cr in fakes[name].list(
            V1ALPHA1, KIND_SLICE_REQUEST,
            ListOptions(namespace=NAMESPACE))]
        cells_block[name] = {
            "nodes": per_cell,
            "requests": len(rows),
            "placed": sum(1 for cr in rows if get_nested(
                cr, "status", "phase") == PHASE_PLACED),
            "state": audit.primary.cells[name].state,
        }
    migrated_keys = sorted(
        k for cell in fakes.values()
        for cr in cell.list(V1ALPHA1, KIND_SLICE_REQUEST,
                            ListOptions(namespace=NAMESPACE))
        if str(migration_of(cr).get("from") or "").startswith("cell/")
        for k in (request_key(cr),))
    out = {
        "scenario": scenario,
        "seed": seed,
        "nodes": nodes,
        "steps": steps,
        "cells": cells_block,
        "schedule": [asdict(f) for f in plan.faults],
        "faults_injected": dict(sorted(injected.items())),
        "converged": is_converged,
        "soak_passes": soak,
        "convergence_virtual_s": clock.t,
        "router": audit.primary.report(),
        "router_crashes": router_crashes,
        "cross_cell_migrated": migrated_keys,
        "timelines": {k: TIMELINE.timeline("SliceRequest", k)
                      for k in migrated_keys},
        "violations": checker.to_list(),
        "settled_state": settled,
        "settled_digest": settled_state_digest(settled),
    }
    out["ok"] = bool(is_converged and not out["violations"])
    return out

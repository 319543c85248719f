"""GPUClusterPolicy reconciler — the main loop.

The port's counterpart of ``tpu_operator/controllers/
clusterpolicy_controller.py`` (``reconcile``/``_reconcile``, :119-356;
ClusterPolicyReconciler analog): singleton enforcement (oldest CR wins,
duplicates -> ``ignored``), node labelling, state drive, coarse status +
conditions, 5 s requeue while operands converge, 45 s poll while no GPU
nodes exist. ``setup_controller`` registers its watches with the manager
(SetupWithManager analog); a direct ``reconcile(Request(name))`` call
(tests, benchmarks) opens its own trace root.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

from ..api import conditions
from ..api.clusterpolicy import (
    KIND_CLUSTER_POLICY,
    STATE_IGNORED,
    STATE_NOT_READY,
    STATE_READY,
    V1,
    GPUClusterPolicySpec,
)
from ..api import labels as L
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.client import WatchEvent
from ..runtime.manager import (
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
    enqueue_owner,
    generation_changed,
    label_changed,
)
from ..runtime.workqueue import LANE_HEALTH
from ..runtime.objects import get_nested, name_of, set_nested, thaw_obj
from ..state.state import SyncStatus
from .state_manager import StateManager

log = logging.getLogger("tpu_operator_torch.clusterpolicy")

REQUEUE_NOT_READY_S = 5.0    # clusterpolicy_controller.go:165,193
REQUEUE_NO_GPU_NODES_S = 45.0  # :199 (NFD-missing poll analog)


class ClusterPolicyReconciler(Reconciler):
    name = "gpuclusterpolicy"
    primary_kind = KIND_CLUSTER_POLICY

    def __init__(self, client, namespace: Optional[str] = None,
                 state_manager: Optional[StateManager] = None,
                 recorder=None):
        from ..runtime.events import EventRecorder

        self.client = client
        self.namespace = namespace or os.environ.get(
            "OPERATOR_NAMESPACE", "gpu-operator")
        self.state_manager = state_manager or StateManager(
            client=client, namespace=self.namespace)
        self.recorder = recorder or EventRecorder(client,
                                                  namespace=self.namespace)
        # BASELINE target #1: install -> all-operands-Ready wall time.
        # First-observation is within watch latency of `kubectl apply`,
        # so this measures the same budget the reference's e2e asserts
        # (tests/e2e/gpu_operator_test.go:83-88) without trusting clock
        # skew on creationTimestamp.
        self._first_seen: dict = {}
        self._ready_recorded: set = set()
        # full (untruncated) slice rows from the previous pass, for
        # transition-only Events: the CR's status copy is MAX_ROWS-capped,
        # so diffing against it would blind events for slices past the cap
        self._prev_slices: dict = {}
        # which CR last wrote the slice gauges: deleting an *ignored*
        # duplicate must not zero the gauges the active CR exports
        self._slices_exporter: Optional[str] = None

    # -- wiring (SetupWithManager analog, clusterpolicy_controller.go:355) --

    def setup_controller(self, controller: Controller, manager: Manager):
        controller.watch(V1, KIND_CLUSTER_POLICY, predicate=generation_changed)
        # node events: GPU labels appearing/changing re-trigger every
        # policy — health lane, so a node flapping in mid-rollout is
        # examined before the bulk operand churn queued behind it. GKE
        # names no GPU topology, so feature discovery's gpu.topology
        # stands where the reference watches GKE's TPU topology label;
        # the card count label feeds gpu.chips, so it is watched too.
        controller.watch(
            "v1", "Node",
            predicate=label_changed(L.GKE_ACCELERATOR,
                                    L.GKE_ACCELERATOR_COUNT, L.GPU_TOPOLOGY,
                                    L.WORKLOAD_CONFIG, L.SLICE_CONFIG,
                                    L.DEPLOY_PREFIX + "*"),
            mapper=self._enqueue_all_policies,
            lane=LANE_HEALTH)
        # owned DaemonSets feed readiness back into the loop
        controller.watch("apps/v1", "DaemonSet",
                         mapper=enqueue_owner(V1, KIND_CLUSTER_POLICY))
        # operand watch fan-out: every extra (apiVersion, kind) the
        # states declare (State.watch_sources) edge-triggers a re-sync —
        # a validator pod flipping Ready re-enqueues the policy NOW
        # instead of after the 5 s not-ready requeue. Event storms
        # collapse in the workqueue's pending-key coalescing.
        watched = {(V1, KIND_CLUSTER_POLICY), ("v1", "Node"),
                   ("apps/v1", "DaemonSet")}
        for api_version, kind in self.state_manager.watch_sources():
            if (api_version, kind) in watched:
                continue
            watched.add((api_version, kind))
            controller.watch(api_version, kind,
                             mapper=self._enqueue_all_policies)

    def _enqueue_all_policies(self, event: WatchEvent) -> Iterable[Request]:
        # runs on every matching node event; with the informer-backed
        # CachedClient (the default wiring) this LIST never leaves the
        # process, so a node-label storm costs no apiserver traffic
        for cr in self.client.list(V1, KIND_CLUSTER_POLICY):
            yield Request(name=name_of(cr))

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, request: Request) -> Result:
        import time as _time

        from ..runtime.tracing import TRACER

        started = _time.perf_counter()
        try:
            # direct-driven runs (benchmarks, tests) get their trace root
            # here; under a Controller worker the trace is already open
            # and this is a passthrough
            with TRACER.trace(self.name, str(request)):
                return self._reconcile(request)
        finally:
            elapsed = _time.perf_counter() - started
            OPERATOR_METRICS.reconcile_duration.set(elapsed)
            # sole observation point of the per-controller duration
            # histogram: exactly one sample per reconcile on both the
            # worker-driven and direct-driven paths
            OPERATOR_METRICS.reconcile_duration_by_controller.labels(
                controller=self.name).observe(elapsed)

    def _reconcile(self, request: Request) -> Result:
        import time as _time

        live = self.client.get_or_none(V1, KIND_CLUSTER_POLICY, request.name)
        if live is None:
            self._first_seen.pop(request.name, None)
            self._ready_recorded.discard(request.name)
            self._prev_slices.pop(request.name, None)
            # a deleted policy exports no slices: stale non-zero gauges
            # would keep GPUSliceNotValidated firing against an
            # uninstalled operator (or a frozen healthy snapshot would
            # mask a later failure). Only the CR that last wrote the
            # gauges resets them — deleting an ignored duplicate while
            # the active CR keeps exporting must not blank its values.
            if self._slices_exporter in (None, request.name):
                OPERATOR_METRICS.slices_total.set(0)
                OPERATOR_METRICS.slices_validated.set(0)
                self._slices_exporter = None
            return Result()
        # the cached read is a shared frozen snapshot; the reconcile
        # mutates status in place, so work on a private thawed copy and
        # keep ``live`` for the status-write skip in conditions
        cr = thaw_obj(live)
        if request.name not in self._first_seen:
            self._first_seen[request.name] = _time.monotonic()
            if get_nested(cr, "status", "state") is not None or \
                    get_nested(cr, "status", "conditions"):
                # any prior status means a previous operator process
                # already observed this CR: this observation is a
                # restart, not an install. Recording restart->ready
                # (near-zero for an already-ready CR, or a rebased
                # partial figure for a mid-install restart) would
                # overwrite the genuine install figure.
                self._ready_recorded.add(request.name)

        # singleton: the oldest CR by (creationTimestamp, name) wins
        all_crs = self.client.list(V1, KIND_CLUSTER_POLICY)
        all_crs.sort(key=lambda c: (
            get_nested(c, "metadata", "creationTimestamp", default=""),
            name_of(c)))
        if all_crs and name_of(all_crs[0]) != request.name:
            self._set_state(cr, STATE_IGNORED)
            OPERATOR_METRICS.policy_state.labels(policy=request.name).set(2)
            conditions.set_error(
                self.client, cr, "DuplicateResource",
                f"only one {KIND_CLUSTER_POLICY} is allowed; "
                f"{name_of(all_crs[0])!r} is active", live=live)
            return Result()

        spec = GPUClusterPolicySpec.from_obj(cr)

        # PSA labels must land before any privileged operand pod is created
        # (state_manager.go:846-854 ordering); disable strips them again
        self.state_manager.ensure_namespace_psa(spec.psa.is_enabled())

        # defaultWorkload only routes unlabeled nodes when the sandbox
        # plane is on (reference: getWorkloadConfig falls back to
        # defaultGPUWorkloadConfig only under sandboxWorkloads.enabled)
        sandbox = spec.sandbox_workloads
        default_workload = (sandbox.default_workload or "container") \
            if sandbox.is_enabled() else "container"
        # per-node upgrade opt-in rides the same node pass/patch (reference
        # gates it off under the sandbox plane, state_manager.go:442-444)
        gpu_nodes = self.state_manager.label_gpu_nodes(
            default_workload, sandbox_enabled=sandbox.is_enabled(),
            upgrade_annotation=bool(spec.upgrade_policy.auto_upgrade)
            and not sandbox.is_enabled())
        OPERATOR_METRICS.gpu_nodes.set(gpu_nodes)
        if gpu_nodes == 0:
            self._set_state(cr, STATE_NOT_READY)
            OPERATOR_METRICS.reconcile_status.set(0)
            OPERATOR_METRICS.policy_state.labels(policy=request.name).set(1)
            # no GPU nodes -> no slices; freezing prior values would
            # mask a later real failure behind a healthy snapshot
            OPERATOR_METRICS.slices_total.set(0)
            OPERATOR_METRICS.slices_validated.set(0)
            self._slices_exporter = request.name
            conditions.set_not_ready(
                self.client, cr, "NoGPUNodes",
                "no nodes with nvidia- cloud.google.com/gke-accelerator "
                "labels or nvidia.com/gpu capacity found", live=live)
            OPERATOR_METRICS.reconcile_total.inc()
            return Result(requeue_after=REQUEUE_NO_GPU_NODES_S)

        extra = {"gpudriver_crd_mode": self._gpudriver_crd_mode()}
        results = self.state_manager.sync(cr, spec, extra)
        # cluster facts ride the same status write the conditions make
        # (clusterinfo.go's role: surfaced state, not just internal use)
        if self.state_manager.last_cluster_facts:
            set_nested(cr, self.state_manager.last_cluster_facts,
                       "status", "clusterInfo")

        # per-slice readiness rows (grouped multi-host readiness): one
        # row per slice of a multi-host pool, validated only when
        # every host's validator pod is Ready. One node LIST serves this,
        # the pool gauge, and the chip totals below.
        from .slices import MAX_ROWS, slice_status

        nodes = self.client.list("v1", "Node")
        # previous FULL {id: validated} map from this process; after a
        # restart fall back to the CR's persisted (capped) copy — slices
        # past the cap then miss at most one transition, not all of them
        prev_ok = self._prev_slices.get(request.name)
        if prev_ok is None:
            prev_ok = {r.get("id"): bool(r.get("validated")) for r in
                       get_nested(cr, "status", "slices",
                                  default=[]) or []}
        slices = slice_status(self.client, self.namespace, nodes=nodes)
        # transition-only Events pair with the GPUSliceNotValidated
        # alert: kubectl describe shows WHEN a slice lost (or regained)
        # a host's validation, not just that it is currently degraded
        for row in slices:
            prev = prev_ok.get(row["id"])
            if prev is not None and prev != row["validated"]:
                self.recorder.event(
                    cr,
                    "Normal" if row["validated"] else "Warning",
                    "SliceValidated" if row["validated"]
                    else "SliceNotValidated",
                    f"slice {row['id']}: {row['hostsValidated']}/"
                    f"{row['hosts']} hosts validated")
        self._prev_slices[request.name] = {
            r["id"]: r["validated"] for r in slices}
        # the status-size cap applies only to the CR copy; the gauges
        # and transition Events consume every slice so truncation cannot
        # blind the not-validated alert or its history
        set_nested(cr, slices[:MAX_ROWS], "status", "slices")
        # surfaced alongside the capped rows so a large fleet can tell the
        # list was cut (the gauges above still count every slice)
        set_nested(cr, len(slices) > MAX_ROWS, "status", "slicesTruncated")
        OPERATOR_METRICS.slices_total.set(len(slices))
        OPERATOR_METRICS.slices_validated.set(
            sum(1 for s in slices if s["validated"]))
        self._slices_exporter = request.name

        not_ready = {n: r for n, r in results.items() if not r.ready}
        errors = {n: r for n, r in results.items()
                  if r.status == SyncStatus.ERROR}
        for state_name, r in results.items():
            OPERATOR_METRICS.operand_ready.labels(state=state_name).set(
                1 if r.ready else 0)
        OPERATOR_METRICS.reconcile_total.inc()

        if errors or not_ready:
            OPERATOR_METRICS.reconcile_status.set(0)
            OPERATOR_METRICS.policy_state.labels(policy=request.name).set(1)
        if errors:
            self._set_state(cr, STATE_NOT_READY)
            conditions.set_error(
                self.client, cr, conditions.REASON_ERROR,
                "; ".join(f"{n}: {r.message}" for n, r in errors.items()),
                live=live)
            OPERATOR_METRICS.reconcile_failures.inc()
            return Result(requeue_after=REQUEUE_NOT_READY_S)
        if not_ready:
            self._set_state(cr, STATE_NOT_READY)
            conditions.set_not_ready(
                self.client, cr, conditions.REASON_OPERANDS_NOT_READY,
                "; ".join(f"{n}: {r.message}" for n, r in not_ready.items()),
                live=live)
            return Result(requeue_after=REQUEUE_NOT_READY_S)

        self._set_state(cr, STATE_READY)
        conditions.set_ready(self.client, cr,
                             f"all {len(results)} states ready "
                             f"on {gpu_nodes} GPU node(s)", live=live)
        from ..state.nodepool import get_node_pools

        OPERATOR_METRICS.reconcile_status.set(1)
        OPERATOR_METRICS.reconcile_last_success.set(_time.time())
        OPERATOR_METRICS.policy_state.labels(policy=request.name).set(0)
        pools = get_node_pools(nodes)
        OPERATOR_METRICS.node_pools.set(len(pools))
        from .nodeinfo import attributes_of

        OPERATOR_METRICS.gpu_chips_cluster_total.set(
            sum(a.chip_count for n in nodes
                if (a := attributes_of(n)).is_gpu))
        if request.name not in self._ready_recorded:
            self._ready_recorded.add(request.name)
            elapsed = _time.monotonic() - self._first_seen[request.name]
            OPERATOR_METRICS.install_to_ready.labels(
                policy=request.name).set(elapsed)
            log.info("policy %s install->ready in %.1fs", request.name,
                     elapsed)
        log.info("policy %s ready (%d states, %d GPU nodes)",
                 request.name, len(results), gpu_nodes)
        return Result()

    def _gpudriver_crd_mode(self) -> bool:
        """When GPUDriver CRs exist, they own driver rollout and the
        policy's gpu-driver state stands down (state_manager.go:951-961
        skip-and-clean analog)."""
        from ..api.gpudriver import KIND_GPU_DRIVER, V1ALPHA1
        try:
            return len(self.client.list(V1ALPHA1, KIND_GPU_DRIVER)) > 0
        except Exception:
            return False

    def _set_state(self, cr: dict, state: str) -> None:
        prev = get_nested(cr, "status", "state", default=None)
        if prev != state:
            from ..runtime.timeline import TIMELINE

            if TIMELINE.enabled:
                TIMELINE.record(KIND_CLUSTER_POLICY, name_of(cr), "state",
                                {"controller": self.name,
                                 "from": prev or "new", "to": state})
            # transition-only: a 5s not-ready requeue must not flood
            # Events (the recorder would dedup-count, but even counting
            # is noise for a non-transition)
            self.recorder.event(
                cr, "Normal" if state == STATE_READY else "Warning",
                "StateChanged",
                f"GPUClusterPolicy state: {prev or 'new'} -> {state}")
        set_nested(cr, state, "status", "state")
        set_nested(cr, self.namespace, "status", "namespace")

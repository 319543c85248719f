"""Rolling driver upgrade orchestration.

The port's counterpart of ``tpu_operator/controllers/upgrade_controller.py``
and the UpgradeReconciler analog (controllers/upgrade_controller.go:81-353 +
the vendored NVIDIA/k8s-operator-libs/pkg/upgrade state machine): because
driver DaemonSets roll with ``OnDelete``, nothing upgrades until this
controller walks each node through a safety FSM persisted in the
``gpu.graft.dev/upgrade.state`` node label:

    upgrade-required -> cordon-required -> migrate-required ->
    drain-required -> pod-restart-required -> validation-required ->
    uncordon-required -> done   (drain/validation deadlines branch to
    `failed`, retried with backoff)

Two behaviors the reference's per-node walk never needed:

- **Pool-grouped upgrades.** The hosts of a multi-host pool (an
  ``mnnvl`` pool, whose NVLink domain spans hosts) must never run mixed
  driver versions: the FSM's unit of progress is an *upgrade unit* — all
  hosts of one slice of such a pool (keyed by product x topology x
  gke-nodepool, ``state/nodepool.py``'s ``slices_of``), or a single host
  elsewhere. Every node of a unit transitions together, and
  upgradePolicy.maxParallelUpgrades counts units, not nodes.
- **Eviction-based drain with a failure path.** Drain goes through the
  Eviction API (client.evict), which PodDisruptionBudgets can block; the
  drain deadline (drainTimeoutSeconds) then either falls back to pod
  deletion (drainForce) or fails the unit. Validation likewise times out
  (validationTimeoutSeconds) into `failed` — reachable, alertable via
  gpu_operator_upgrade_state_nodes{state="failed"}, and retried after
  failedRetryBackoffSeconds (upgrade_controller.go:157-187 drain-spec
  semantics).

The migrate stage asks ``controllers/slices.py``'s ``SliceMigrator``
whether the unit may drain: a Placed SliceRequest bound to the unit is
checkpointed by its workload and rebound onto replacement capacity first
(the elastic handshake), or degrades to the hard drain past
migrationTimeoutSeconds.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import labels as L
from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1, GPUClusterPolicySpec
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime import (
    Controller,
    EvictionBlockedError,
    Manager,
    Reconciler,
    Request,
    Result,
    WatchEvent,
    any_event,
    generation_changed,
)
from ..runtime.client import ListOptions, NotFoundError
from ..runtime.objects import get_nested, labels_of, name_of, namespace_of
from ..state.nodepool import get_node_pools
from ..utils.hash import object_hash
from .slices import VALIDATOR_APPS

log = logging.getLogger("tpu_operator_torch.upgrade")

REQUEUE_PERIODIC_S = 120.0  # upgrade_controller.go:59,197
REQUEUE_ACTIVE_S = 5.0

STATE_DONE = "done"
STATE_UPGRADE_REQUIRED = "upgrade-required"
STATE_CORDON = "cordon-required"
# elastic-slice stage between cordon and drain: placed slices on the
# unit get the slice-intent handshake (checkpoint → rebind onto
# replacement capacity) before their pods are evicted; past
# migrationTimeoutSeconds the unit degrades to the plain hard drain
STATE_MIGRATE = "migrate-required"
STATE_DRAIN = "drain-required"
STATE_POD_RESTART = "pod-restart-required"
STATE_VALIDATION = "validation-required"
STATE_UNCORDON = "uncordon-required"
STATE_FAILED = "failed"

# states that count against the parallel-upgrade budget
IN_PROGRESS_STATES = {STATE_CORDON, STATE_MIGRATE, STATE_DRAIN,
                      STATE_POD_RESTART, STATE_VALIDATION, STATE_UNCORDON}

# stage ordering used to heal a unit whose members diverged (a wiped
# label, an operator restart mid-transition): the unit resumes from the
# EARLIEST stage any member is in
_STAGE_ORDER = [STATE_UPGRADE_REQUIRED, STATE_CORDON, STATE_MIGRATE,
                STATE_DRAIN, STATE_POD_RESTART, STATE_VALIDATION,
                STATE_UNCORDON, STATE_DONE]


def desired_revision(client, ds: dict) -> str:
    """Current pod-template revision for a DaemonSet: the newest owned
    ControllerRevision when the control plane maintains them, else a local
    template hash (which is exactly what the fake kubelet stamps)."""
    try:
        revs = [r for r in client.list("apps/v1", "ControllerRevision",
                                       ListOptions(namespace=namespace_of(ds)))
                if any(ref.get("uid") == get_nested(ds, "metadata", "uid")
                       for ref in get_nested(r, "metadata", "ownerReferences",
                                             default=[]) or [])]
    except NotFoundError:
        revs = []
    if revs:
        newest = max(revs, key=lambda r: r.get("revision", 0))
        return get_nested(newest, "metadata", "labels",
                          "controller-revision-hash",
                          default=name_of(newest).rsplit("-", 1)[-1])
    return object_hash(get_nested(ds, "spec", "template", default={}))


@dataclass
class _Member:
    """One node's view within an upgrade unit."""

    node: dict
    pod: Optional[dict]          # its driver pod (None = nothing to upgrade)
    want: Optional[str]          # desired driver revision
    have: Optional[str]          # running driver revision
    pod_ready: bool

    @property
    def name(self) -> str:
        return name_of(self.node)

    @property
    def state(self) -> Optional[str]:
        return labels_of(self.node).get(L.UPGRADE_STATE)

    @property
    def at_new_revision(self) -> bool:
        return self.pod is None or self.have == self.want


class UpgradeReconciler(Reconciler):
    name = "gpu-upgrade"
    primary_kind = "GPUClusterPolicy"  # requests name the owning policy

    def __init__(self, client, namespace: str = "gpu-operator",
                 now=time.time, recorder=None):
        from ..runtime.events import EventRecorder

        self.client = client
        self.namespace = namespace
        self.now = now  # injectable clock for deadline tests
        # node Events on every FSM transition (the reference's upgrade
        # lib does the same, drain_manager.go:105-129): kubectl describe
        # node is where operators look first when a node misbehaves
        self.recorder = recorder or EventRecorder(client,
                                                  namespace=namespace)

    def setup_controller(self, controller: Controller, manager: Manager):
        from ..runtime import label_changed

        controller.watch(V1, KIND_CLUSTER_POLICY, predicate=generation_changed,
                         mapper=self._enqueue_policy)
        controller.watch("apps/v1", "DaemonSet", predicate=any_event,
                         mapper=self._enqueue_policy)
        # edge triggers for the FSM's two wait states: a driver/validator
        # pod landing (or turning Ready) unblocks pod-restart-required /
        # validation-required immediately, and an upgrade-state label
        # flip on any node lets the budget admit the next unit in the
        # same tick — instead of burning a REQUEUE_ACTIVE_S poll per hop
        controller.watch("v1", "Pod", predicate=any_event,
                         mapper=self._enqueue_policy)
        controller.watch("v1", "Node",
                         predicate=label_changed(L.UPGRADE_STATE),
                         mapper=self._enqueue_policy)

    def _enqueue_policy(self, event: WatchEvent):
        for cr in self.client.list(V1, KIND_CLUSTER_POLICY):
            yield Request(name=name_of(cr))

    # -- helpers -----------------------------------------------------------

    def _driver_daemonsets(self) -> List[dict]:
        return self.client.list(
            "apps/v1", "DaemonSet",
            ListOptions(namespace=self.namespace,
                        label_selector={"gpu.graft.dev/component":
                                        "gpu-driver"}))

    def _driver_pods_by_node(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for pod in self.client.list(
                "v1", "Pod",
                ListOptions(namespace=self.namespace,
                            label_selector={"gpu.graft.dev/component":
                                            "gpu-driver"})):
            if get_nested(pod, "metadata", "deletionTimestamp"):
                # a Terminating old-revision pod must not shadow its
                # replacement in the one-pod-per-node map
                continue
            node = get_nested(pod, "spec", "nodeName")
            if node:
                out[node] = pod
        return out

    VALIDATOR_APPS = VALIDATOR_APPS

    def _validator_pods_by_node(self) -> Dict[str, List[dict]]:
        """node -> its validation-gate pods — operator-validator on
        container nodes, isolated-validator on isolated/virtual nodes
        (the reference validates upgrades via its
        app=nvidia-operator-validator pods, cmd/gpu-operator/main.go:151).
        One LIST per app per reconcile; Terminating pods are excluded —
        a dying validator's Ready=True is the OLD proof, not a
        re-validation against the new driver."""
        out: Dict[str, List[dict]] = {}
        for app in self.VALIDATOR_APPS:
            for pod in self.client.list(
                    "v1", "Pod",
                    ListOptions(namespace=self.namespace,
                                label_selector={"app": app})):
                if get_nested(pod, "metadata", "deletionTimestamp"):
                    continue
                node = get_nested(pod, "spec", "nodeName")
                if node:
                    out.setdefault(node, []).append(pod)
        return out

    def _validator_ds_exists(self) -> bool:
        """Whether any validation-gate DaemonSet is deployed at all — with
        the validator state disabled there are no gate pods to wait for
        and upgrade validation falls back to driver-pod readiness."""
        return any(
            get_nested(ds, "metadata", "labels", "app") in self.VALIDATOR_APPS
            for ds in self.client.list(
                "apps/v1", "DaemonSet",
                ListOptions(namespace=self.namespace)))

    @staticmethod
    def _pod_ready(pod: dict) -> bool:
        from ..runtime.objects import pod_ready

        return pod_ready(pod)

    @staticmethod
    def _drainable(pod: dict, names: tuple) -> bool:
        """True when this pod holds GPU cards and must leave before a
        driver swap — the reference's gpuPodSpecFilter (main.go:198-209):
        prefix-matched resource requests (isolated nvidia.com/gpu-isolated
        and fractional nvidia.com/vgpu consumers count too), completed
        pods / daemon pods / the driver itself excluded."""
        if get_nested(pod, "metadata", "deletionTimestamp"):
            return False
        # completed pods hold no cards (main.go:209 phase filter)
        if get_nested(pod, "status", "phase",
                      default="Running") in ("Succeeded", "Failed"):
            return False
        if labels_of(pod).get(L.UPGRADE_SKIP_DRAIN) == "true":
            return False
        if labels_of(pod).get("gpu.graft.dev/component") == "gpu-driver":
            return False
        # daemon pods are not drained (kubectl drain --ignore-daemonsets)
        owners = get_nested(pod, "metadata", "ownerReferences",
                            default=[]) or []
        if any(o.get("kind") == "DaemonSet" for o in owners):
            return False
        requests = {}
        for ctr in get_nested(pod, "spec", "containers", default=[]) or []:
            requests.update(get_nested(ctr, "resources", "requests",
                                       default={}) or {})
        return any(str(r).startswith(n) for r in requests for n in names)

    def _gpu_workload_pods_by_node(
            self, resource_names: Optional[tuple] = None,
    ) -> Dict[str, List[dict]]:
        """node -> pods consuming GPU resources — the drain set (the
        reference drains with a GPU-pod selector, main.go:105-117). One
        cluster-wide LIST per reconcile, not one per draining node.
        ``resource_names`` carries the policy's configured plugin
        resource names (shared/isolated/vGPU can all be renamed); the
        defaults always apply too."""
        names = tuple(resource_names or ()) + (L.GPU_RESOURCE,
                                               L.VGPU_RESOURCE)
        out: Dict[str, List[dict]] = {}
        for pod in self.client.list("v1", "Pod"):
            node_name = get_nested(pod, "spec", "nodeName")
            if node_name and self._drainable(pod, names):
                out.setdefault(node_name, []).append(pod)
        return out

    def _gpu_workload_pods_on(self, node_name: str,
                              resource_names: Optional[tuple] = None,
    ) -> Optional[List[dict]]:
        """Index fast path for the drain set: when the client is a
        CachedClient, its pod-by-node index answers "which pods hold
        cards on THIS node" in O(pods-on-node) — no cluster-wide scan.
        Returns None when the client has no such index (the caller falls
        back to :meth:`_gpu_workload_pods_by_node`)."""
        index = getattr(self.client, "index", None)
        if index is None or not self.client.has_index("v1", "Pod", "by-node"):
            return None
        names = tuple(resource_names or ()) + (L.GPU_RESOURCE,
                                               L.VGPU_RESOURCE)
        return [pod for pod in index("v1", "Pod", "by-node", node_name)
                if self._drainable(pod, names)]

    # -- node label/annotation writes --------------------------------------

    def _set_node_state(self, node: dict, state: Optional[str]) -> None:
        self.client.patch("v1", "Node", name_of(node),
                          {"metadata": {"labels": {L.UPGRADE_STATE: state}}})

    def _annotate(self, node: dict, **kv) -> None:
        self.client.patch("v1", "Node", name_of(node),
                          {"metadata": {"annotations": dict(kv)}})

    def _cordon(self, node: dict, on: bool) -> None:
        self.client.patch("v1", "Node", name_of(node),
                          {"spec": {"unschedulable": True if on else None}})

    def _release_node(self, node: dict) -> None:
        """Strip a node's FSM label/annotations and undo any cordon the
        FSM applied — a node paused mid-rollout (after STATE_CORDON,
        before STATE_UNCORDON) must not be left unschedulable forever."""
        state = labels_of(node).get(L.UPGRADE_STATE)
        # any FSM-owned state may hold a cordon (failed units stay
        # cordoned; a retrying unit can sit in upgrade-required cordoned
        # while the budget is full) — DONE already uncordoned
        if state not in (None, STATE_DONE) and get_nested(
                node, "spec", "unschedulable", default=False):
            self._cordon(node, False)
        self._annotate(node, **{L.UPGRADE_STAGE_STARTED: None,
                                L.UPGRADE_FAILED_AT: None,
                                L.UPGRADE_FAILED_REASON: None})
        self._set_node_state(node, None)

    def remove_upgrade_state_labels(self) -> None:
        """Auto-upgrade disabled: strip FSM labels (+ leftover cordons)
        (removeNodeUpgradeStateLabels analog, upgrade_controller.go:103-121)."""
        for node in self.client.list("v1", "Node"):
            if L.UPGRADE_STATE in labels_of(node):
                self._release_node(node)

    # -- unit machinery ----------------------------------------------------

    def _upgrade_units(self, nodes: Dict[str, dict]) -> List[List[str]]:
        """Partition eligible nodes into upgrade units: every host of a
        multi-host pool's slice moves as one unit (slice identity = product x
        topology x gke-nodepool, the same grouping topology/manager.py
        uses for grouped slice-config agreement); single-host nodes are
        their own unit."""
        from ..state.nodepool import slices_of

        units: List[List[str]] = []
        grouped = set()
        for pool in get_node_pools(list(nodes.values())):
            if pool.multi_host:
                by_slice = slices_of(pool, nodes)
                for _, members in sorted(by_slice.items()):
                    units.append(sorted(members))
            else:
                for node_name in pool.nodes:
                    units.append([node_name])
            grouped.update(pool.nodes)
        # nodes outside any GPU pool (no accelerator label) can still run
        # a driver pod in odd setups; treat them as singleton units
        for name in sorted(set(nodes) - grouped):
            units.append([name])
        units.sort(key=lambda u: u[0])
        return units

    def _unit_state(self, members: List[_Member]) -> Optional[str]:
        """Aggregate FSM state of a unit: failed dominates; otherwise the
        earliest stage any member is in (heals divergence after partial
        writes/restarts)."""
        states = [m.state for m in members]
        if any(s == STATE_FAILED for s in states):
            return STATE_FAILED
        present = [s for s in states if s in _STAGE_ORDER]
        if not present:
            return None
        return min(present, key=_STAGE_ORDER.index)

    def _set_unit_state(self, members: List[_Member], state: str) -> None:
        from ..runtime.timeline import TIMELINE
        from ..runtime.tracing import TRACER

        if TIMELINE.enabled:
            TIMELINE.record("UpgradeUnit", members[0].name, "fsm:" + state,
                            {"controller": self.name,
                             "nodes": len(members)})
        with TRACER.span("fsm:" + state, unit=members[0].name,
                         nodes=len(members)):
            for m in members:
                if m.state != state:
                    self._set_node_state(m.node, state)
                    # keep the in-pass snapshot truthful: the divergence
                    # heal can move a member BACKWARD, and the later
                    # same-pass forward transitions compare against
                    # m.state — a stale label would make them skip the
                    # write and leave the unit split again
                    refreshed = self.client.get_or_none(
                        "v1", "Node", m.name)
                    if refreshed is not None:
                        m.node = refreshed

    def _stage_started(self, members: List[_Member]) -> Optional[float]:
        stamps = []
        for m in members:
            v = (get_nested(m.node, "metadata", "annotations",
                            default={}) or {}).get(L.UPGRADE_STAGE_STARTED)
            try:
                stamps.append(float(v))
            except (TypeError, ValueError):
                pass
        return min(stamps) if stamps else None

    def _stamp_stage(self, members: List[_Member]) -> None:
        stamp = str(self.now())
        for m in members:
            self._annotate(m.node, **{L.UPGRADE_STAGE_STARTED: stamp})

    def _fail_unit(self, members: List[_Member], reason: str) -> None:
        from ..runtime.timeline import TIMELINE
        from ..runtime.tracing import TRACER

        if TIMELINE.enabled:
            TIMELINE.record("UpgradeUnit", members[0].name, "fsm:failed",
                            {"controller": self.name, "reason": reason})
        stamp = str(self.now())
        log.error("upgrade unit [%s] failed: %s",
                  ",".join(m.name for m in members), reason)
        TRACER.tag("upgrade_failed_unit", members[0].name)
        TRACER.tag("upgrade_failed_reason", reason)
        for m in members:
            self._annotate(m.node, **{L.UPGRADE_FAILED_AT: stamp,
                                      L.UPGRADE_FAILED_REASON: reason,
                                      L.UPGRADE_STAGE_STARTED: None})
            self.recorder.event(m.node, "Warning", "DriverUpgradeFailed",
                                reason)
        self._set_unit_state(members, STATE_FAILED)
        OPERATOR_METRICS.driver_upgrades_failed.inc()

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, request: Request) -> Result:
        import time as _time

        from ..runtime.tracing import TRACER

        started = _time.perf_counter()
        try:
            # trace root for direct-driven runs (rollout bench, chaos
            # runner); passthrough under a Controller worker
            with TRACER.trace(self.name, str(request)):
                return self._reconcile(request)
        finally:
            OPERATOR_METRICS.reconcile_duration_by_controller.labels(
                controller=self.name).observe(_time.perf_counter() - started)

    def _reconcile(self, request: Request) -> Result:
        cr = self.client.get_or_none(V1, KIND_CLUSTER_POLICY, request.name)
        if cr is None:
            return Result()
        spec = GPUClusterPolicySpec.from_obj(cr)
        policy = spec.upgrade_policy
        # CR-level pause without spec surgery: annotating the policy CR
        # with gpu.graft.dev/driver-upgrade-enabled != "true" halts the
        # rollout exactly like autoUpgrade: false
        cr_gate = (get_nested(cr, "metadata", "annotations",
                              default={}) or {}).get(L.DRIVER_UPGRADE_ENABLED)
        if (not policy.auto_upgrade
                or spec.sandbox_workloads.is_enabled()  # sandbox gate,
                # upgrade_controller.go:103-121: rollouts are container-
                # plane only; isolated/virtual nodes must not be drained
                or (cr_gate is not None and cr_gate != "true")):
            self.remove_upgrade_state_labels()
            return Result()

        daemonsets = self._driver_daemonsets()
        if not daemonsets:
            return Result(requeue_after=REQUEUE_PERIODIC_S)

        nodes = {name_of(n): n for n in self.client.list("v1", "Node")}
        revisions = {name_of(ds): desired_revision(self.client, ds)
                     for ds in daemonsets}
        driver_pods = self._driver_pods_by_node()
        validator_pods = self._validator_pods_by_node()
        validator_gate_deployed = self._validator_ds_exists()

        drain_timeout = (policy.drain_timeout_seconds
                         if policy.drain_timeout_seconds is not None else 300)
        validation_timeout = (policy.validation_timeout_seconds
                              if policy.validation_timeout_seconds is not None
                              else 300)
        retry_backoff = (policy.failed_retry_backoff_seconds
                         if policy.failed_retry_backoff_seconds is not None
                         else 60)
        migration_timeout = (policy.migration_timeout_seconds
                             if policy.migration_timeout_seconds is not None
                             else 120)

        # eligible = opted-in nodes (per-node pause: the policy reconciler
        # stamps this annotation "true" on GPU nodes while autoUpgrade is
        # on; any other explicit value excludes the node without touching
        # the CR — driverAutoUpgradeAnnotationKey contract,
        # state_manager.go:423-477. Absent = eligible, so the controller
        # also works driven standalone.)
        opted_out = set()
        for node_name, node in nodes.items():
            anns = get_nested(node, "metadata", "annotations",
                              default={}) or {}
            optin = anns.get(L.DRIVER_UPGRADE_ENABLED)
            if optin is not None and optin != "true":
                opted_out.add(node_name)
                if labels_of(node).get(L.UPGRADE_STATE):
                    self._release_node(node)

        def member_of(node_name: str) -> _Member:
            node = nodes[node_name]
            pod = driver_pods.get(node_name)
            want = have = None
            pod_ready = False
            if pod is not None:
                ds_name = next((o.get("name") for o in
                                get_nested(pod, "metadata", "ownerReferences",
                                           default=[]) or []
                                if o.get("kind") == "DaemonSet"), None)
                want = revisions.get(ds_name)
                have = labels_of(pod).get("controller-revision-hash")
                pod_ready = self._pod_ready(pod)
                if want is None:
                    pod = None  # not one of ours; nothing to upgrade
            return _Member(node=node, pod=pod, want=want, have=have,
                           pod_ready=pod_ready)

        # units are partitioned over ALL nodes first: an opted-out host
        # must take its whole multi-host slice out of the rollout, not
        # shrink the unit — half a slice upgrading alone is exactly the
        # mixed-driver-versions state the unit mechanism prevents
        units = []
        for unit_names in self._upgrade_units(nodes):
            if any(n in opted_out for n in unit_names):
                for n in unit_names:
                    if n not in opted_out and labels_of(
                            nodes[n]).get(L.UPGRADE_STATE):
                        self._release_node(nodes[n])
                continue
            units.append([member_of(n) for n in unit_names])
        # drop units with nothing to upgrade-manage at all
        units = [u for u in units
                 if any(m.pod is not None for m in u)
                 or any(m.state for m in u)]

        # at most one cluster-wide pod LIST per reconcile, and only when
        # something is actually draining; with a CachedClient the by-node
        # pod index answers per node in O(pods-on-node) instead
        workload_pods: Optional[Dict[str, List[dict]]] = None

        # the configured plugin resource names: renamed shared/
        # isolated/vGPU resources must still land in the drain set
        dp = spec.device_plugin
        iso = spec.isolated_device_plugin
        drain_resource_names = tuple(n for n in (
            dp.resource_name if dp else None,
            iso.resource_name if iso else None,
            iso.vgpu_resource_name if iso else None) if n)

        def drain_pods_on(node_name: str) -> List[dict]:
            nonlocal workload_pods
            indexed = self._gpu_workload_pods_on(
                node_name, resource_names=drain_resource_names)
            if indexed is not None:
                return indexed
            if workload_pods is None:
                workload_pods = self._gpu_workload_pods_by_node(
                    resource_names=drain_resource_names)
            return workload_pods.get(node_name, [])

        budget = max(1, policy.max_parallel_upgrades or 1)
        in_progress_units = sum(
            1 for u in units if self._unit_state(u) in IN_PROGRESS_STATES)

        node_states: Dict[str, str] = {}

        def record(members: List[_Member], state: str) -> None:
            for m in members:
                node_states[m.name] = state

        for members in units:
            state = self._unit_state(members)
            needs = any(not m.at_new_revision for m in members)

            if state in IN_PROGRESS_STATES or state == STATE_UPGRADE_REQUIRED:
                # divergence heal on EVERY pass, not only on the next
                # transition: a member whose stage label was wiped (or
                # that crashed ahead of its siblings) re-syncs to the
                # unit's aggregate earliest stage even while the unit is
                # just waiting (e.g. parked in validation). No-op — and
                # zero writes — when the members already agree.
                self._set_unit_state(members, state)

            if state == STATE_FAILED:
                # retry with backoff: failed -> upgrade-required
                failed_ats = []
                for m in members:
                    v = (get_nested(m.node, "metadata", "annotations",
                                    default={}) or {}).get(L.UPGRADE_FAILED_AT)
                    try:
                        failed_ats.append(float(v))
                    except (TypeError, ValueError):
                        pass
                failed_at = max(failed_ats) if failed_ats else 0.0
                if self.now() - failed_at >= retry_backoff:
                    log.info("retrying failed upgrade unit [%s]",
                             ",".join(m.name for m in members))
                    for m in members:
                        self._annotate(m.node,
                                       **{L.UPGRADE_FAILED_AT: None,
                                          L.UPGRADE_FAILED_REASON: None})
                    state = STATE_UPGRADE_REQUIRED
                    self._set_unit_state(members, state)
                else:
                    record(members, STATE_FAILED)
                    continue

            if not needs and state in (None, STATE_DONE):
                for m in members:
                    if m.state is not None and m.state != STATE_DONE:
                        self._set_node_state(m.node, STATE_DONE)
                record(members, STATE_DONE)
                continue

            # FSM advance (multiple safe steps per pass), unit-atomic
            if state in (None, STATE_DONE) and needs:
                state = STATE_UPGRADE_REQUIRED
                self._set_unit_state(members, state)
            if state == STATE_UPGRADE_REQUIRED:
                if in_progress_units >= budget:
                    record(members, state)
                    continue
                in_progress_units += 1
                state = STATE_CORDON
                self._set_unit_state(members, state)
            if state == STATE_CORDON:
                for m in members:
                    self._cordon(m.node, True)
                    self.recorder.event(
                        m.node, "Normal", "DriverUpgradeStarted",
                        "Node cordoned; scheduling drain of the node")
                self._stamp_stage(members)
                state = STATE_MIGRATE
                self._set_unit_state(members, state)
            if state == STATE_MIGRATE:
                proceed = True
                if migration_timeout > 0:
                    started = self._stage_started(members)
                    if started is None:
                        self._stamp_stage(members)
                        started = self.now()
                    from .slices import SliceMigrator

                    migrator = SliceMigrator(self.client, now=self.now)
                    proceed = migrator.ready_to_drain(
                        [m.name for m in members],
                        started + migration_timeout)
                if proceed:
                    # fresh stamp: the drain deadline must not be
                    # pre-consumed by however long the handshake took
                    self._stamp_stage(members)
                    state = STATE_DRAIN
                    self._set_unit_state(members, state)
                else:
                    record(members, state)
                    continue
            if state == STATE_DRAIN:
                remaining = 0
                blocked: List[str] = []
                if policy.drain_enable in (None, True):
                    for m in members:
                        for victim in drain_pods_on(m.name):
                            try:
                                self.client.evict(name_of(victim),
                                                  namespace_of(victim) or None)
                                log.info("evicted pod %s/%s from %s",
                                         namespace_of(victim),
                                         name_of(victim), m.name)
                            except EvictionBlockedError as e:
                                remaining += 1
                                blocked.append(str(e))
                            except NotFoundError:
                                pass
                if remaining == 0:
                    state = STATE_POD_RESTART
                    self._set_unit_state(members, state)
                else:
                    started = self._stage_started(members)
                    if started is None:
                        # no stamp (pre-existing label from an older
                        # operator, or a recreated Node object): persist
                        # one so the deadline actually elapses
                        self._stamp_stage(members)
                        started = self.now()
                    if self.now() - started > drain_timeout:
                        if policy.drain_force:
                            # deadline passed and the policy says go:
                            # bypass the budget via direct deletion
                            for m in members:
                                for victim in drain_pods_on(m.name):
                                    try:
                                        self.client.delete(
                                            "v1", "Pod", name_of(victim),
                                            namespace_of(victim) or None)
                                    except NotFoundError:
                                        pass
                            log.warning(
                                "drain deadline passed on unit [%s]; "
                                "force-deleted remaining GPU pods",
                                ",".join(m.name for m in members))
                            for m in members:
                                self.recorder.event(
                                    m.node, "Warning", "DrainForced",
                                    f"Drain deadline ({drain_timeout}s) "
                                    f"passed; remaining GPU pods deleted")
                            state = STATE_POD_RESTART
                            self._set_unit_state(members, state)
                        else:
                            self._fail_unit(
                                members,
                                f"drain timed out after {drain_timeout}s: "
                                + "; ".join(blocked[:3]))
                            record(members, STATE_FAILED)
                            continue
                    else:
                        record(members, state)
                        continue
            if state == STATE_POD_RESTART:
                # the validator pods restart WITH the driver: their
                # initContainers re-prove the node against the new driver
                # (the driver-manager preflight closed every gate), which
                # is what STATE_VALIDATION then waits on
                for m in members:
                    victims = ([m.pod] if m.pod is not None else []) \
                        + validator_pods.get(m.name, [])
                    for v in victims:
                        try:
                            self.client.delete("v1", "Pod", name_of(v),
                                               namespace_of(v) or None)
                        except NotFoundError:
                            pass
                log.info("restarting driver + validator pods on unit [%s]",
                         ",".join(m.name for m in members))
                self._stamp_stage(members)
                state = STATE_VALIDATION
                self._set_unit_state(members, state)
                record(members, state)
                continue  # must wait for kubelet to recreate
            if state == STATE_VALIDATION:
                def validated(m: _Member) -> bool:
                    # mid-restart a member has NO driver pod; that is not
                    # "nothing to upgrade", it is "new revision unproven"
                    # — without this the unit could uncordon before the
                    # kubelet ever recreates the driver
                    if m.pod is None:
                        return False
                    validators = validator_pods.get(m.name, [])
                    validators_ok = all(self._pod_ready(p)
                                        for p in validators) \
                        and (bool(validators) or not validator_gate_deployed)
                    return m.have == m.want and m.pod_ready and validators_ok

                if all(validated(m) for m in members):
                    state = STATE_UNCORDON
                    self._set_unit_state(members, state)
                else:
                    started = self._stage_started(members)
                    if started is None:
                        self._stamp_stage(members)
                        started = self.now()
                    if self.now() - started > validation_timeout:
                        unproven = [m.name for m in members
                                    if not validated(m)]
                        self._fail_unit(
                            members,
                            f"validation timed out after "
                            f"{validation_timeout}s on: "
                            + ",".join(unproven))
                        record(members, STATE_FAILED)
                    else:
                        record(members, state)
                    continue
            if state == STATE_UNCORDON:
                for m in members:
                    self._cordon(m.node, False)
                    self._annotate(m.node,
                                   **{L.UPGRADE_STAGE_STARTED: None})
                    self._set_node_state(m.node, STATE_DONE)
                    self.recorder.event(
                        m.node, "Normal", "DriverUpgradeComplete",
                        "New driver revision validated; node uncordoned")
                    OPERATOR_METRICS.driver_upgrades_done.inc()
                log.info("upgrade unit [%s] complete",
                         ",".join(m.name for m in members))
                record(members, STATE_DONE)
                continue
            record(members, state or STATE_DONE)

        pending = [n for n, s in node_states.items()
                   if s not in (STATE_DONE,)]
        # unit state after this pass = the recorded state of any member
        # (the unit loop keeps them in lockstep); the member dicts
        # themselves are pre-pass snapshots
        OPERATOR_METRICS.upgrade_units_in_progress.set(
            sum(1 for u in units
                if node_states.get(u[0].name) in IN_PROGRESS_STATES))
        OPERATOR_METRICS.driver_upgrades_in_progress.set(
            sum(1 for s in node_states.values() if s in IN_PROGRESS_STATES))
        OPERATOR_METRICS.driver_upgrades_pending.set(
            sum(1 for s in node_states.values()
                if s == STATE_UPGRADE_REQUIRED))
        for fsm_state in (STATE_DONE, STATE_UPGRADE_REQUIRED, STATE_CORDON,
                          STATE_DRAIN, STATE_POD_RESTART, STATE_VALIDATION,
                          STATE_UNCORDON, STATE_FAILED):
            OPERATOR_METRICS.upgrade_state_nodes.labels(state=fsm_state).set(
                sum(1 for s in node_states.values() if s == fsm_state))
        if pending:
            return Result(requeue_after=REQUEUE_ACTIVE_S)
        return Result(requeue_after=REQUEUE_PERIODIC_S)

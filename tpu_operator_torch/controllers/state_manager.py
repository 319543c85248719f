"""Node discovery/labelling + ordered state drive.

The port's counterpart of ``tpu_operator/controllers/state_manager.py``
(the ClusterPolicyController core, state_manager.go analog): discovers GPU
nodes from GKE's ``nvidia-`` accelerator label or their ``nvidia.com/gpu``
capacity, stamps presence, generation, card count and the per-state deploy
labels routed by workload config, and drives the ordered operand states
each reconcile — over the dependency DAG, or the serial walk under
``OPERATOR_DAG=0``. Operand *startup* ordering is enforced on-node by the
validation barrier, not by pausing between states.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import labels as L
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..api.clusterpolicy import GPUClusterPolicySpec
from ..runtime.client import Client
from ..runtime.objects import get_nested, label_delta, labels_of, name_of
from ..state.operands import build_states
from ..state.scheduler import DAG_GATE, DagPlan, SyncJournal, run_plan
from ..state.state import State, SyncContext, SyncResult, SyncStatus
from .clusterinfo import ClusterInfo

log = logging.getLogger("tpu_operator_torch.state_manager")


is_gpu_node = L.is_gpu_node


def desired_node_labels(node: dict,
                        default_config: str = "container",
                        sandbox_enabled: bool = True) -> Dict[str, Optional[str]]:
    """Labels this operator wants on a GPU node; None means remove.

    ``default_config`` is the workload config assumed when the node
    carries no gpu.graft.dev/workload.config label — it comes from
    sandboxWorkloads.defaultWorkload (getWorkloadConfig analog,
    state_manager.go: defaultGPUWorkloadConfig). With the sandbox plane
    off, isolated/virtual labels collapse to container routing (the
    reference returns 'container' for every node when sandboxWorkloads
    is disabled) — otherwise a labeled node would be routed to states
    that are gated off, ending up with no device plugin at all."""
    nl = labels_of(node)
    out: Dict[str, Optional[str]] = {}
    if not is_gpu_node(node):
        # strip everything we ever stamped (removeAllGPUStateLabels analog)
        for k in list(nl):
            if k.startswith(L.DEPLOY_PREFIX) or k in (
                    L.PRESENT, L.GPU_GENERATION, L.GPU_CHIP_COUNT,
                    L.WORKLOAD_CONFIG):
                out[k] = None
        return out
    out[L.PRESENT] = "true"
    accel = nl.get(L.GKE_ACCELERATOR, "")
    if accel:
        out[L.GPU_GENERATION] = L.accelerator_generation(accel)
    chips = nl.get(L.GKE_ACCELERATOR_COUNT) or str(
        get_nested(node, "status", "allocatable", L.GPU_RESOURCE, default="") or "")
    if chips:
        out[L.GPU_CHIP_COUNT] = chips
    config = nl.get(L.WORKLOAD_CONFIG, default_config)
    if config not in L.WORKLOAD_STATE_SETS:
        log.warning("node %s: unknown workload config %r, using 'container'",
                    name_of(node), config)
        config = "container"
    if config != "container" and not sandbox_enabled:
        log.info("node %s: workload config %r but sandbox plane is "
                 "disabled; routing as 'container'", name_of(node), config)
        config = "container"
    wanted_states = set(L.WORKLOAD_STATE_SETS[config])
    for state in L.ALL_DEPLOY_STATES:
        key = L.deploy_label(state)
        if state in wanted_states:
            out[key] = "true"
        elif key in nl:
            out[key] = None
    return out


def _upgrade_annotation_delta(node: dict, enabled: bool) -> Dict[str, Optional[str]]:
    """Annotation merge-patch for one GPU node's auto-upgrade opt-in.

    Enabled fills in only an ABSENT annotation ("true"); an operator's
    explicit non-"true" value is a per-node pause and must survive
    reconciles (unlike the reference, which force-overwrites and so offers
    no node-level pause). Disabled unwinds only the "true" this reconciler
    stamps, so an explicit pause also survives a global disable→re-enable
    cycle."""
    anns = get_nested(node, "metadata", "annotations", default={}) or {}
    have = anns.get(L.DRIVER_UPGRADE_ENABLED)
    if enabled and have is None:
        return {L.DRIVER_UPGRADE_ENABLED: "true"}
    if not enabled and have == "true":
        return {L.DRIVER_UPGRADE_ENABLED: None}  # merge-patch null deletes
    return {}


@dataclass
class StateManager:
    client: Client
    namespace: str
    states: List[State] = field(default_factory=build_states)
    # clusterinfo facts captured by the last sync() pass; the controller
    # publishes them on the CR's status.clusterInfo
    last_cluster_facts: Dict = field(default_factory=dict)
    # start/done interleaving evidence for the chaos plane's dag-order
    # invariant (state/scheduler.py SyncJournal)
    journal: SyncJournal = field(default_factory=SyncJournal)

    def __post_init__(self) -> None:
        # compile the DAG here so a cyclic or dangling requires() graph
        # fails operator startup with a named cycle, not the Nth
        # reconcile with a wedged queue
        self.plan = DagPlan.build(self.states)
        self._pass_id = 0

    def watch_sources(self) -> List[tuple]:
        """Distinct (api_version, kind) pairs the states declare as
        re-sync triggers, declaration order preserved — the controller
        fans these out into real watches so operand-object events
        edge-trigger targeted reconciles instead of waiting out the
        requeue interval."""
        out: List[tuple] = []
        for state in self.states:
            for src in state.watch_sources():
                if src not in out:
                    out.append(src)
        return out

    def label_gpu_nodes(self, default_config: str = "container",
                        sandbox_enabled: bool = True,
                        upgrade_annotation: Optional[bool] = None) -> int:
        """Stamp discovery + deploy labels on every node; returns the GPU
        node count (labelGPUNodes analog — one LIST + at most one patch
        per drifted node). When ``upgrade_annotation`` is set, the driver
        auto-upgrade annotation rides the same pass/patch
        (applyDriverAutoUpgradeAnnotation analog, state_manager.go:423-477,
        without the reference's second node LIST)."""
        count = 0
        # the per-reconcile node LIST the informer cache absorbs: behind
        # a CachedClient this pass costs the apiserver only the drift
        # patches, so a no-drift steady pass is read-free at any N
        for node in self.client.list("v1", "Node"):
            gpu = is_gpu_node(node)
            want = desired_node_labels(node, default_config, sandbox_enabled)
            if gpu:
                count += 1
            body: dict = {}
            delta = label_delta(labels_of(node), want)
            if delta:
                body = {"metadata": {"labels": delta}}
            if upgrade_annotation is not None and gpu:
                ann = _upgrade_annotation_delta(node, upgrade_annotation)
                if ann:
                    body.setdefault("metadata", {})["annotations"] = ann
            if body:
                self.client.patch("v1", "Node", name_of(node), body)
                log.info("updated node %s: %s", name_of(node), body)
        return count

    def detect_runtime(self) -> str:
        """Container runtime from GPU-node status only (getRuntime analog,
        state_manager.go:714-751). The majority/fallback discipline lives
        in ClusterInfo.facts(); this is the standalone accessor."""
        return ClusterInfo(self.client).facts()["containerRuntime"]

    def ensure_namespace_psa(self, enabled: bool) -> None:
        """Stamp pod-security.kubernetes.io/{enforce,audit,warn}=privileged
        on the operand namespace so privileged operand pods (driver
        installer, validator, device plugin) admit on PSA-enforcing
        clusters (setPodSecurityLabelsForNamespace analog,
        state_manager.go:600-648). Disabling strips exactly the
        "privileged" values this reconciler stamps — a cluster admin's own
        different PSA levels are never touched."""
        ns = self.client.get_or_none("v1", "Namespace", self.namespace)
        if ns is None:
            if not enabled:
                return
            self.client.create({
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": self.namespace}})
            ns = {"metadata": {"name": self.namespace}}
        have = labels_of(ns)
        if enabled:
            delta = {L.PSA_LABEL_PREFIX + mode: L.PSA_LEVEL_PRIVILEGED
                     for mode in L.PSA_MODES
                     if have.get(L.PSA_LABEL_PREFIX + mode)
                     != L.PSA_LEVEL_PRIVILEGED}
        else:
            delta = {L.PSA_LABEL_PREFIX + mode: None for mode in L.PSA_MODES
                     if have.get(L.PSA_LABEL_PREFIX + mode)
                     == L.PSA_LEVEL_PRIVILEGED}
        if delta:
            self.client.patch("v1", "Namespace", self.namespace,
                              {"metadata": {"labels": delta}})
            log.info("pod security admission labels on namespace %s: %s",
                     self.namespace, delta)

    def sync(self, policy: dict, spec: GPUClusterPolicySpec,
             extra: Optional[dict] = None) -> Dict[str, SyncResult]:
        """Drive every state once; returns per-state results (step() loop
        analog, clusterpolicy_controller.go:155-179).

        With the DAG gate on (default) the states run wave-by-wave per
        the compiled plan — concurrently in production, sequentially in
        seeded order under the chaos runner's virtual mode. With
        OPERATOR_DAG=0 / --serial-states the original serial walk runs
        verbatim. Every path returns the results keyed in declaration
        order, so condition messages joined over the dict are identical
        whatever order the waves completed in."""
        # one facts() pass covers runtime detection too; the dict rides
        # the context (states may template on it) and is kept for the
        # controller's status.clusterInfo write
        facts = ClusterInfo(self.client).facts()
        self.last_cluster_facts = facts
        ctx = SyncContext(client=self.client, policy=policy, spec=spec,
                          namespace=self.namespace,
                          cluster={"runtime": facts["containerRuntime"],
                                   **facts},
                          extra=extra or {})
        if DAG_GATE.enabled:
            results = self._sync_dag(ctx)
        else:
            results = self._sync_serial(ctx)
        return {state.name: results[state.name] for state in self.states}

    def _run_state(self, state: State, ctx: SyncContext,
                   span) -> SyncResult:
        """One state's sync under its ``state:<name>`` span; a broken
        state must not wedge the rest, and its wall time lands on the
        operand_sync_duration gauge either way."""
        start = time.perf_counter()
        # the span wraps the swallowing try: the exception never
        # escapes, so the error is recorded on the span by hand
        with span as sp:
            try:
                result = state.sync(ctx)
                if sp is not None:
                    sp.tags["status"] = result.status.value
                return result
            except Exception as e:
                log.exception("state %s sync failed", state.name)
                if sp is not None:
                    sp.error = f"{type(e).__name__}: {e}"
                return SyncResult(SyncStatus.ERROR, str(e))
            finally:
                OPERATOR_METRICS.operand_sync_duration.labels(
                    state=state.name).set(time.perf_counter() - start)

    def _sync_serial(self, ctx: SyncContext) -> Dict[str, SyncResult]:
        """The pre-DAG walk, kept exactly: one state at a time in
        declaration order (the kill switch's contract)."""
        from ..runtime.tracing import TRACER

        return {state.name: self._run_state(
                    state, ctx, TRACER.span("state:" + state.name))
                for state in self.states}

    def _sync_dag(self, ctx: SyncContext) -> Dict[str, SyncResult]:
        """Wave-parallel walk of the compiled plan. Per-state behavior
        (swallowing try, span tagging, duration gauge) matches the
        serial loop; only the execution order differs. Results land in a
        plain dict — every worker writes a distinct key, and the waves
        join before anyone reads."""
        from ..runtime.tracing import TRACER

        by_name = {state.name: state for state in self.states}
        self._pass_id += 1
        results: Dict[str, SyncResult] = {}
        # the dispatching thread's innermost span: worker threads hang
        # their state spans under it (their own stacks are empty)
        handle = TRACER.current()

        def run_one(name: str) -> None:
            results[name] = self._run_state(
                by_name[name], ctx,
                TRACER.span_under(handle, "state:" + name))

        run_plan(self.plan, run_one, journal=self.journal,
                 pass_id=self._pass_id, rng=DAG_GATE.virtual_rng)
        return results

"""GPUDriver reconciler — per-node-pool driver rollout (engine B path).

The port's counterpart of ``tpu_operator/controllers/tpudriver_controller.py``,
mirroring NVIDIADriverReconciler (controllers/nvidiadriver_controller.go:
75-408 + internal/state/driver.go:106-692): validates the CR against
sibling CRs, partitions the CR's nodes into (product x topology) pools
(``state/nodepool.py``), renders one driver DaemonSet per pool from the
same manifest dir the GPUClusterPolicy's driver state uses
(``state-gpu-driver``), cleans up stale pool DaemonSets, and reports
aggregate readiness through status + conditions.
"""

from __future__ import annotations

import logging

from ..api import conditions
from ..api.clusterpolicy import (
    KIND_CLUSTER_POLICY,
    STATE_NOT_READY,
    STATE_READY,
    V1,
    GPUClusterPolicySpec,
)
from ..api.gpudriver import KIND_GPU_DRIVER, V1ALPHA1, GPUDriverSpec
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..render import Renderer
from ..runtime.manager import (
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
    enqueue_owner,
    generation_changed,
)
from ..runtime.objects import name_of, set_nested, thaw_obj
from ..state.nodepool import get_node_pools
from ..state.operands import (
    MANIFESTS_ROOT,
    apply_common_config,
    common_data,
    operator_init_image,
    resolve_image,
    template_kinds,
)
from ..state.skel import apply_objects, objects_ready
from ..state.state import SyncContext
from .validation import ValidationError, validate_node_selectors

log = logging.getLogger("tpu_operator_torch.gpudriver")

REQUEUE_NOT_READY_S = 5.0  # nvidiadriver_controller.go:175-206 analog
STATE_DIR = "state-gpu-driver"


class GPUDriverReconciler(Reconciler):
    name = "gpudriver"

    def __init__(self, client, namespace: str = "gpu-operator",
                 manifests_root=None):
        self.client = client
        self.namespace = namespace
        self.manifests_root = manifests_root or MANIFESTS_ROOT

    def setup_controller(self, controller: Controller, manager: Manager):
        controller.watch(V1ALPHA1, KIND_GPU_DRIVER,
                         predicate=generation_changed)
        controller.watch("apps/v1", "DaemonSet",
                         mapper=enqueue_owner(V1ALPHA1, KIND_GPU_DRIVER))
        # driver-pod phase flips decide per-pool readiness; edge-trigger
        # them instead of waiting for the 5s not-ready requeue
        controller.watch("v1", "Pod", mapper=self._enqueue_all_drivers)

    def _enqueue_all_drivers(self, event):
        # the informer-backed cache serves this LIST in-process, so a
        # pod churn storm costs no apiserver traffic
        for cr in self.client.list(V1ALPHA1, KIND_GPU_DRIVER):
            yield Request(name=name_of(cr))

    def _state_label(self, cr_name: str) -> str:
        return f"gpu-driver-{cr_name}"

    def reconcile(self, request: Request) -> Result:
        import time as _time

        from ..runtime.tracing import TRACER

        started = _time.perf_counter()
        try:
            # trace root for direct-driven runs; passthrough when the
            # Controller worker already opened the trace at dequeue
            with TRACER.trace(self.name, str(request)):
                return self._reconcile(request)
        finally:
            # sole observation point of the per-controller duration
            # histogram (one sample per reconcile, every drive path)
            OPERATOR_METRICS.reconcile_duration_by_controller.labels(
                controller=self.name).observe(_time.perf_counter() - started)

    def _reconcile(self, request: Request) -> Result:
        live = self.client.get_or_none(V1ALPHA1, KIND_GPU_DRIVER, request.name)
        if live is None:
            # deleted: owned DaemonSets go with it via ownerRef GC
            return Result()
        # cached reads are shared frozen snapshots; status is written in
        # place below, so reconcile a private thawed copy and keep
        # ``live`` for the conditions status-write skip
        cr = thaw_obj(live)

        # a GPUClusterPolicy must exist to supply stack-wide defaults
        # (nvidiadriver_controller.go:80-125)
        policies = self.client.list(V1, KIND_CLUSTER_POLICY)
        if not policies:
            # state first, conditions second: set_* writes status once —
            # a trailing second write would 409 by construction (the
            # server bumped rv on the first)
            set_nested(cr, STATE_NOT_READY, "status", "state")
            conditions.set_error(self.client, cr, "MissingClusterPolicy",
                                 "no GPUClusterPolicy found; create one first",
                                 live=live)
            return Result(requeue_after=REQUEUE_NOT_READY_S)
        policy_spec = GPUClusterPolicySpec.from_obj(policies[0])

        try:
            validate_node_selectors(self.client, cr)
        except ValidationError as e:
            set_nested(cr, STATE_NOT_READY, "status", "state")
            conditions.set_error(self.client, cr, "Conflict", str(e),
                                 live=live)
            return Result()  # user must fix the CR; no requeue loop

        spec = GPUDriverSpec.from_obj(cr)
        # full-cluster node LIST every reconcile: served from the informer
        # store when the manager runs a CachedClient, so pool partitioning
        # stays O(nodes) in-process instead of an apiserver round trip
        nodes = self.client.list("v1", "Node")
        pools = get_node_pools(nodes, restrict=spec.node_selector)

        ctx = SyncContext(client=self.client, policy=cr, spec=policy_spec,
                          namespace=self.namespace)
        renderer = Renderer(self.manifests_root / STATE_DIR)
        desired = []
        for pool in pools:
            data = common_data(ctx, policy_spec.driver, "gpu-driver",
                               "gpu-driver-installer")
            data["Image"] = resolve_image("gpu-driver", spec,
                                          "gpu-driver-installer")
            data["InitContainerImage"] = (
                operator_init_image(ctx, data["Image"]) or data["Image"])
            data["UpdateStrategy"] = "OnDelete"
            data["InstallDir"] = spec.install_dir or "/usr/local/nvidia/lib64"
            data["DriverVersion"] = spec.driver_version or ""
            data["Name"] = f"gpu-driver-{pool.name}"
            data["NodeSelector"] = {**data["NodeSelector"],
                                    data["DeployLabel"]: "true",
                                    **pool.selector}
            desired.extend(apply_common_config(
                renderer.render_objects(data), data))

        state_label = self._state_label(request.name)
        applied = apply_objects(
            self.client, cr, state_label, desired, self.namespace,
            sweep_kinds=template_kinds(str(self.manifests_root / STATE_DIR)))
        if not pools:
            set_nested(cr, STATE_NOT_READY, "status", "state")
            conditions.set_not_ready(self.client, cr, "NoMatchingNodes",
                                     "nodeSelector matches no GPU nodes",
                                     live=live)
            return Result(requeue_after=REQUEUE_NOT_READY_S)

        ok, msg = objects_ready(self.client, applied)
        if not ok:
            set_nested(cr, STATE_NOT_READY, "status", "state")
            conditions.set_not_ready(
                self.client, cr,
                conditions.REASON_OPERANDS_NOT_READY, msg, live=live)
            return Result(requeue_after=REQUEUE_NOT_READY_S)

        set_nested(cr, STATE_READY, "status", "state")
        conditions.set_ready(
            self.client, cr,
            f"driver ready on {len(pools)} pool(s): "
            + ", ".join(p.name for p in pools), live=live)
        log.info("GPUDriver %s ready across pools %s", request.name,
                 [p.name for p in pools])
        return Result()

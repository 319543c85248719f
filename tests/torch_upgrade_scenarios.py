"""The scenarios of ``test_torch_upgrade.py`` and
``test_torch_upgrade_drain.py``: the port's driver-upgrade FSM against
the JAX package's, on the scenarios
of ``test_upgrade.py`` (the FSM walk, the parallel budget, slice units
moving together and healing to the earliest stage, the eviction drain
with PodDisruptionBudgets, deadlines into ``failed`` and the retry after
backoff, per-node and per-CR pauses, the sandbox gate, events, the
driver-CR path, the drain set, restarts mid-upgrade), each run on both
packages' own ``FakeClient`` over clusters mapped one to one: a TPU v5p
host of 4 chips <-> an H100 host of 4 cards on NVSwitch, a 2-host v5p
slice <-> a 2-host GB200 ``mnnvl`` pool (multi-host), ``google.com/tpu*``
<-> ``nvidia.com/gpu*``. Node names are the same on both sides.

Each scenario gives a transcript of what it observed, then what the
reconciler did as it happened: every upgrade-state label it wrote, node
by node in order (a spy between the reconciler and its client), every
eviction it asked for, the Events on the cluster and the upgrade gauges
and counters. The reference's transcript, under ``torch_naming.py``'s
map, equals the port's (``agrees``)."""

import torch_naming as N
from tpu_operator.api import labels as RL
from tpu_operator.api.clusterpolicy import KIND_CLUSTER_POLICY as RKIND
from tpu_operator.api.clusterpolicy import V1 as RV1
from tpu_operator.api.clusterpolicy import new_cluster_policy as rnew_policy
from tpu_operator.api.tpudriver import V1ALPHA1 as RV1ALPHA1
from tpu_operator.api.tpudriver import new_tpu_driver
from tpu_operator.controllers import upgrade_controller as rup
from tpu_operator.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler as RPolicyReconciler)
from tpu_operator.controllers.tpudriver_controller import TPUDriverReconciler
from tpu_operator.metrics.operator_metrics import OPERATOR_METRICS as RMETRICS
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import ListOptions as RListOptions
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime.client import EvictionBlockedError as REvictionBlocked
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.clusterpolicy import (KIND_CLUSTER_POLICY, V1,
                                                  new_cluster_policy)
from tpu_operator_torch.api.gpudriver import V1ALPHA1, new_gpu_driver
from tpu_operator_torch.controllers import upgrade_controller as up
from tpu_operator_torch.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler)
from tpu_operator_torch.controllers.gpudriver_controller import (
    GPUDriverReconciler)
from tpu_operator_torch.metrics.operator_metrics import OPERATOR_METRICS
from tpu_operator_torch.runtime.client import EvictionBlockedError, ListOptions
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Request
from tpu_operator_torch.runtime.objects import get_nested, labels_of, thaw_obj

SINGLE = {
    True: {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
           RL.GKE_TPU_TOPOLOGY: "2x2x1", RL.GKE_ACCELERATOR_COUNT: "4"},
    False: {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
            L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
            L.GPU_TOPOLOGY: "nvswitch-4", L.GKE_ACCELERATOR_COUNT: "4"},
}
SLICE = {  # one 2-host slice of a multi-host pool, sharing a gke-nodepool
    True: {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
           RL.GKE_TPU_TOPOLOGY: "2x2x2", RL.GKE_NODEPOOL: "pool-slice-a",
           RL.GKE_ACCELERATOR_COUNT: "4"},
    False: {L.GKE_ACCELERATOR: "nvidia-gb200", L.GPU_PRODUCT: "NVIDIA-GB200",
            L.GPU_TOPOLOGY: "mnnvl-4", L.GKE_NODEPOOL: "pool-slice-a",
            L.GKE_ACCELERATOR_COUNT: "4"},
}
RESOURCES = {"google.com/tpu": "nvidia.com/gpu",
             "google.com/tpu-isolated": "nvidia.com/gpu-isolated",
             "google.com/vtpu": "nvidia.com/vgpu",
             "example.com/tpu-dedicated": "example.com/gpu-dedicated"}
GAUGE_STATES = ("done", "upgrade-required", "cordon-required",
                "drain-required", "pod-restart-required",
                "validation-required", "uncordon-required", "failed")


def m(value):
    """A reference observation in the port's words."""
    if isinstance(value, str):
        if value in RESOURCES:
            return RESOURCES[value]
        value = N.name(value).replace("TPUClusterPolicy state",
                                      "GPUClusterPolicy state")
        for a, b in N.UPGRADE_TEXT:
            value = value.replace(a, b)
        return value
    if isinstance(value, dict):
        return {m(k): m(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(m(v) for v in value)
    return value


class Spy:
    """Between the upgrade reconciler and its client: records each
    upgrade-state label the reconciler writes and each eviction it asks
    for, in order, then passes the call on."""

    def __init__(self, inner, state_label):
        self.inner = inner
        self.state_label = state_label
        self.stages = {}
        self.evictions = []

    def patch(self, api_version, kind, name, patch, namespace=None):
        labels = (patch.get("metadata") or {}).get("labels") or {}
        if kind == "Node" and self.state_label in labels:
            self.stages.setdefault(name, []).append(labels[self.state_label])
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def evict(self, name, namespace=None):
        self.evictions.append(f"{namespace}/{name}")
        return self.inner.evict(name, namespace)

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


class Side:
    """One package's cluster, reconcilers and vocabulary."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.c = RFake() if ref else FakeClient()
        self.L = RL if ref else L
        self.up = rup if ref else up
        self.ns = "tpu-operator" if ref else "gpu-operator"
        self.policy_name = "tpu-cluster-policy" if ref else \
            "gpu-cluster-policy"
        self.v1, self.kind = (RV1, RKIND) if ref else (V1, KIND_CLUSTER_POLICY)
        self.driver_field = "libtpu" if ref else "driver"
        self.component = ({"tpu.graft.dev/component": "libtpu-driver"} if ref
                          else {"gpu.graft.dev/component": "gpu-driver"})
        self.metrics = RMETRICS if ref else OPERATOR_METRICS
        self.spy = Spy(self.c, self.L.UPGRADE_STATE)
        self.prec = None
        self.counters0 = self.counters()

    # -- the cluster -------------------------------------------------------

    def res(self, name):
        return name if self.ref else RESOURCES[name]

    def node(self, name, labels, extra=None, alloc=True):
        self.c.add_node(name, labels={**labels[self.ref], **(extra or {})},
                        allocatable={self.res("google.com/tpu"): "4"}
                        if alloc else None)

    def converge(self, upgrade_policy, extra_spec=None):
        spec = {"upgradePolicy": upgrade_policy, **(extra_spec or {})}
        new = rnew_policy if self.ref else new_cluster_policy
        self.c.create(new(spec=spec if self.ref else N.spec(spec)))
        self.reconcile_policy()
        self.c.simulate_kubelet(ready=True)
        self.reconcile_policy()

    def reconcile_policy(self):
        if self.prec is None:
            cls = RPolicyReconciler if self.ref else ClusterPolicyReconciler
            self.prec = cls(client=self.c, namespace=self.ns)
        self.prec.reconcile(self.request())

    def request(self, name=None):
        return (RRequest if self.ref else Request)(
            name=name or self.policy_name)

    def edit_policy(self, fn):
        cr = thaw_obj(self.c.get(self.v1, self.kind, self.policy_name))
        fn(cr)
        self.c.update(cr)

    def change_driver_spec(self):
        """The driver's template changes; OnDelete keeps the old pods."""
        def bump(cr):
            cr.setdefault("spec", {})[self.driver_field] = {
                "installDir": "/opt/new-driver"}
        self.edit_policy(bump)
        self.reconcile_policy()
        self.c.simulate_kubelet(ready=True)

    def workload_pod(self, name, node, resource="google.com/tpu",
                     labels=None, ready=None, phase="Running"):
        status = {"phase": phase}
        if ready is not None:
            status["conditions"] = [{"type": "Ready",
                                     "status": "True" if ready else "False"}]
        self.c.create({"apiVersion": "v1", "kind": "Pod",
                       "metadata": {"name": name, "namespace": "default",
                                    "labels": labels or {}},
                       "spec": {"nodeName": node, "containers": [{
                           "name": "t", "resources": {"requests": {
                               self.res(resource): "4"
                               if resource == "google.com/tpu" else "1"}}}]},
                       "status": status})

    def pdb(self, match, min_available=1):
        self.c.create({"apiVersion": "policy/v1",
                       "kind": "PodDisruptionBudget",
                       "metadata": {"name": "guard", "namespace": "default"},
                       "spec": {"selector": {"matchLabels": match},
                                "minAvailable": min_available}})

    # -- the reconciler ----------------------------------------------------

    def upgrader(self, clock=None):
        kw = {"now": lambda: clock[0]} if clock is not None else {}
        return self.up.UpgradeReconciler(client=self.spy, namespace=self.ns,
                                         **kw)

    def reconcile(self, rec):
        return rec.reconcile(self.request()).requeue_after

    # -- observations ------------------------------------------------------

    def state(self, name):
        return labels_of(self.c.get("v1", "Node", name)).get(
            self.L.UPGRADE_STATE)

    def states(self):
        return {n["metadata"]["name"]: labels_of(n).get(self.L.UPGRADE_STATE)
                for n in self.c.list("v1", "Node")}

    def cordoned(self, name):
        return bool(get_nested(self.c.get("v1", "Node", name), "spec",
                               "unschedulable", default=False))

    def annotations(self, name):
        return dict(self.c.get("v1", "Node", name)["metadata"].get(
            "annotations") or {})

    def failed_reason(self, name):
        return self.annotations(name).get(self.L.UPGRADE_FAILED_REASON)

    def pod_exists(self, name, ns="default"):
        return self.c.get_or_none("v1", "Pod", name, ns) is not None

    def driver_pods(self):
        return self.c.list("v1", "Pod", (RListOptions if self.ref
                                         else ListOptions)(
            label_selector=self.component))

    def driver_hash(self, node):
        return [labels_of(p)["controller-revision-hash"]
                for p in self.driver_pods()
                if get_nested(p, "spec", "nodeName") == node]

    def unready_validators(self, rec, node):
        for pod in rec._validator_pods_by_node().get(node, []):
            pod = thaw_obj(pod)
            for cond in get_nested(pod, "status", "conditions",
                                   default=[]) or []:
                if cond.get("type") == "Ready":
                    cond["status"] = "False"
            self.c.update(pod)

    def counters(self):
        return [self.metrics.driver_upgrades_done._value.get(),
                self.metrics.driver_upgrades_failed._value.get()]

    def record(self):
        """What the reconciler did, as it happened, and the gauges."""
        events = sorted(
            (e["involvedObject"]["name"], e["reason"], e["type"],
             e["message"], e.get("count", 1))
            for e in self.c.list("v1", "Event"))
        mt = self.metrics
        gauges = {s: mt.upgrade_state_nodes.labels(state=s)._value.get()
                  for s in GAUGE_STATES}
        gauges["units_in_progress"] = mt.upgrade_units_in_progress._value.get()
        gauges["in_progress"] = mt.driver_upgrades_in_progress._value.get()
        gauges["pending"] = mt.driver_upgrades_pending._value.get()
        done, failed = self.counters()
        return {"stages": self.spy.stages, "evictions": self.spy.evictions,
                "events": events, "gauges": gauges,
                "done": done - self.counters0[0],
                "failed": failed - self.counters0[1]}


def converged(s, n_nodes=2, auto_upgrade=True):
    for i in range(n_nodes):
        s.node(f"node-{i}", SINGLE)
    s.converge({"autoUpgrade": auto_upgrade, "maxParallelUpgrades": 1})


def mixed(s, max_parallel=1):
    s.node("slice-h0", SLICE)
    s.node("slice-h1", SLICE)
    s.node("z-single-0", SINGLE)
    s.converge({"autoUpgrade": True, "maxParallelUpgrades": max_parallel})


# --- TestUpgradeFSM ---------------------------------------------------------

def s_noop_when_current(s):
    converged(s)
    return [s.reconcile(s.upgrader()), s.states()]


def s_auto_upgrade_off_strips_labels(s):
    converged(s, auto_upgrade=False)
    s.c.patch("v1", "Node", "node-0", {"metadata": {"labels": {
        s.L.UPGRADE_STATE: "upgrade-required"}}})
    s.reconcile(s.upgrader())
    return s.states()


def s_single_node_full_upgrade_cycle(s):
    converged(s, n_nodes=1)
    rec = s.upgrader()
    s.change_driver_spec()
    old = s.driver_hash("node-0")
    out = [s.reconcile(rec), s.states(), s.cordoned("node-0"),
           len(s.driver_pods())]
    s.c.simulate_kubelet(ready=True)
    out += [s.driver_hash("node-0") != old, s.reconcile(rec), s.states(),
            s.cordoned("node-0")]
    return out


def s_validation_waits_for_validator_pods(s):
    converged(s, n_nodes=1)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    out = [len(rec._validator_pods_by_node().get("node-0", []))]
    s.c.simulate_kubelet(ready=True)
    s.unready_validators(rec, "node-0")
    s.reconcile(rec)
    out.append(s.state("node-0"))
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    return out + [s.state("node-0")]


def s_parallel_budget_respected(s):
    converged(s, n_nodes=3)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    return s.states()


def s_drain_evicts_workloads_but_respects_skip_label(s):
    converged(s, n_nodes=1)
    s.workload_pod("train-job", "node-0")
    s.workload_pod("sacred-job", "node-0",
                   labels={s.L.UPGRADE_SKIP_DRAIN: "true"})
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    return [s.pod_exists("train-job"), s.pod_exists("sacred-job")]


def s_eventual_full_fleet_upgrade(s):
    converged(s, n_nodes=3)
    rec = s.upgrader()
    s.change_driver_spec()
    for _ in range(12):
        s.reconcile(rec)
        s.c.simulate_kubelet(ready=True)
    return [s.states(), [s.cordoned(f"node-{i}") for i in range(3)]]


# --- TestSliceGroupedUpgrades ----------------------------------------------

def s_slice_hosts_move_together(s):
    mixed(s)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    out = [s.states(), s.cordoned("slice-h0"), s.cordoned("slice-h1"),
           sorted(get_nested(p, "spec", "nodeName")
                  for p in s.driver_pods())]
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    out.append(s.states())
    for _ in range(4):
        s.reconcile(rec)
        s.c.simulate_kubelet(ready=True)
    return out + [s.states()]


def s_slice_never_half_validated(s):
    mixed(s)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    s.c.simulate_kubelet(ready=True)
    s.unready_validators(rec, "slice-h1")
    s.reconcile(rec)
    return [s.states(), s.cordoned("slice-h0")]


def s_budget_counts_units_not_nodes(s):
    mixed(s, max_parallel=1)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    return s.states()


def s_healing_diverged_member_label(s):
    mixed(s)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    s.c.patch("v1", "Node", "slice-h1",
              {"metadata": {"labels": {s.L.UPGRADE_STATE: None}}})
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    return s.states()


def s_wiped_state_and_stamp_heal_without_losing_the_unit(s):
    clock = [5000.0]
    mixed(s)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    out = [s.states()]
    s.c.patch("v1", "Node", "slice-h1",
              {"metadata": {"labels": {s.L.UPGRADE_STATE: None},
                            "annotations": {
                                s.L.UPGRADE_STAGE_STARTED: None}}})
    s.unready_validators(rec, "slice-h0")
    s.reconcile(rec)
    out.append(s.states())
    clock[0] += 301
    s.reconcile(rec)
    return out + [s.states(), s.failed_reason("slice-h1")]


def s_diverged_members_resync_to_earliest_stage(s):
    mixed(s)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    s.c.patch("v1", "Node", "slice-h1",
              {"metadata": {"labels": {s.L.UPGRADE_STATE: "drain-required"}}})
    s.reconcile(rec)
    out = [s.states()]
    s.c.simulate_kubelet(ready=True)
    for _ in range(4):
        s.reconcile(rec)
        s.c.simulate_kubelet(ready=True)
    return out + [s.states()]


# --- TestEvictionDrain -------------------------------------------------------

def guarded(s, clock, policy_edit=None):
    converged(s, n_nodes=1)
    if policy_edit:
        s.edit_policy(policy_edit)
    s.workload_pod("guarded", "node-0", labels={"app": "guarded"},
                   ready=True)
    s.pdb({"app": "guarded"})
    rec = s.upgrader(clock)
    s.change_driver_spec()
    return rec


def s_pdb_blocks_drain_until_timeout_then_failed(s):
    clock = [1000.0]
    rec = guarded(s, clock)
    s.reconcile(rec)
    out = [s.states(), s.pod_exists("guarded"), s.cordoned("node-0")]
    clock[0] += 301
    s.reconcile(rec)
    return out + [s.states(), s.failed_reason("node-0"),
                  s.pod_exists("guarded")]


def s_drain_force_deletes_at_deadline(s):
    clock = [1000.0]

    def force(cr):
        cr["spec"]["upgradePolicy"]["drainForce"] = True
    rec = guarded(s, clock, force)
    s.reconcile(rec)
    out = [s.states()]
    clock[0] += 301
    s.reconcile(rec)
    return out + [s.pod_exists("guarded"), s.states()]


def s_eviction_proceeds_when_pdb_has_headroom(s):
    converged(s, n_nodes=1)
    s.workload_pod("a", "node-0", labels={"app": "multi"}, ready=True)
    s.node("other", SINGLE, alloc=False)
    s.workload_pod("b", "other", labels={"app": "multi"}, ready=True)
    s.pdb({"app": "multi"})
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    return [s.pod_exists("a"), s.pod_exists("b")]


def s_drain_respects_custom_timeout(s):
    clock = [0.0]

    def timeout(cr):
        cr["spec"]["upgradePolicy"]["drainTimeoutSeconds"] = 10
    rec = guarded(s, clock, timeout)
    s.reconcile(rec)
    out = [s.states()]
    clock[0] += 11
    s.reconcile(rec)
    return out + [s.states()]


# --- TestUpgradeFailureSemantics ---------------------------------------------

def s_validation_timeout_drives_node_to_failed(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    out = [s.states()]
    clock[0] += 100
    s.reconcile(rec)
    out.append(s.states())
    clock[0] += 250
    s.reconcile(rec)
    return out + [s.states(), s.failed_reason("node-0")]


def s_failed_node_retries_after_backoff_and_recovers(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    clock[0] += 301
    s.reconcile(rec)
    out = [s.states()]
    clock[0] += 10
    s.reconcile(rec)
    out.append(s.states())
    clock[0] += 60
    s.reconcile(rec)
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    return out + [s.states(),
                  s.L.UPGRADE_FAILED_REASON in s.annotations("node-0")]


def s_upgrade_units_metric_counts_slices_once(s):
    mixed(s)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    return s.states()


def s_failed_state_surfaced_in_metrics(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    clock[0] += 301
    s.reconcile(rec)
    return s.states()


def s_whole_slice_fails_and_retries_together(s):
    clock = [5000.0]
    mixed(s)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    clock[0] += 301
    s.reconcile(rec)
    out = [s.states()]
    clock[0] += 61
    s.reconcile(rec)
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    return out + [s.states()]


# --- TestReviewRegressions ---------------------------------------------------

def s_validation_waits_for_driver_pod_recreation(s):
    converged(s, n_nodes=1)

    def no_validator(cr):
        cr["spec"]["validator"] = {"enabled": False}
    s.edit_policy(no_validator)
    s.reconcile_policy()
    s.c.simulate_kubelet(ready=True)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    s.reconcile(rec)
    out = [s.states(), s.cordoned("node-0")]
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    return out + [s.states()]


def s_opted_out_host_excludes_whole_slice(s):
    mixed(s)
    s.c.patch("v1", "Node", "slice-h1", {"metadata": {"annotations": {
        s.L.DRIVER_UPGRADE_ENABLED: "false"}}})
    rec = s.upgrader()
    s.change_driver_spec()
    for _ in range(6):
        s.reconcile(rec)
        s.c.simulate_kubelet(ready=True)
    hashes = {h for n in ("slice-h0", "slice-h1") for h in s.driver_hash(n)}
    return [s.states(), len(hashes)]


def s_pdb_match_expressions_blocks_eviction(s):
    s.workload_pod("guarded", "n0", labels={"app": "guarded"}, ready=True)
    s.c.create({"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
                "metadata": {"name": "guard", "namespace": "default"},
                "spec": {"selector": {"matchExpressions": [
                    {"key": "app", "operator": "In", "values": ["guarded"]}]},
                    "minAvailable": 1}})
    try:
        s.c.evict("guarded", "default")
        return "evicted"
    except (REvictionBlocked if s.ref else EvictionBlockedError) as e:
        return ["blocked", e.code]


def s_terminating_driver_pod_does_not_shadow_replacement(s):
    converged(s, n_nodes=1)
    rec = s.upgrader()
    [pod] = s.driver_pods()
    s.c.patch("v1", "Pod", pod["metadata"]["name"],
              {"metadata": {"deletionTimestamp": "2026-01-01T00:00:00Z"}},
              pod["metadata"]["namespace"])
    return rec._driver_pods_by_node()


# --- TestFailureReleaseAndHealing --------------------------------------------

def s_disabling_upgrade_uncordons_failed_node(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    clock[0] += 301
    s.reconcile(rec)
    out = [s.states(), s.cordoned("node-0")]

    def off(cr):
        cr["spec"]["upgradePolicy"]["autoUpgrade"] = False
    s.edit_policy(off)
    s.reconcile(rec)
    return out + [s.states(), s.cordoned("node-0")]


def s_unstamped_drain_state_still_times_out(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    s.workload_pod("guarded", "node-0", labels={"app": "guarded"},
                   ready=True)
    s.pdb({"app": "guarded"})
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.c.patch("v1", "Node", "node-0",
              {"metadata": {"labels": {s.L.UPGRADE_STATE: "drain-required"}},
               "spec": {"unschedulable": True}})
    s.reconcile(rec)
    out = [s.states()]
    clock[0] += 301
    s.reconcile(rec)
    return out + [s.states()]


# --- TestPerNodeUpgradeOptOut ------------------------------------------------

def s_annotation_pause_excludes_node(s):
    converged(s, n_nodes=2)
    s.c.patch("v1", "Node", "node-0", {"metadata": {"annotations": {
        s.L.DRIVER_UPGRADE_ENABLED: "false"}}})
    s.change_driver_spec()
    rec = s.upgrader()
    for _ in range(8):
        s.reconcile(rec)
        s.c.simulate_kubelet(ready=True)
    return s.states()


def s_pause_mid_rollout_strips_fsm_label(s):
    converged(s, n_nodes=1)
    s.change_driver_spec()
    rec = s.upgrader()
    s.reconcile(rec)
    out = [s.states()]
    s.c.patch("v1", "Node", "node-0", {"metadata": {"annotations": {
        s.L.DRIVER_UPGRADE_ENABLED: "paused"}}})
    s.reconcile(rec)
    return out + [s.states(), s.cordoned("node-0")]


def s_cr_annotation_pauses_whole_rollout(s):
    converged(s, n_nodes=1)
    s.change_driver_spec()

    def pause(cr):
        cr.setdefault("metadata", {}).setdefault("annotations", {})[
            s.L.DRIVER_UPGRADE_ENABLED] = "false"
    s.edit_policy(pause)
    s.reconcile(s.upgrader())
    return s.states()


def s_node_pause_survives_policy_reconcile(s):
    converged(s, n_nodes=1)
    s.c.patch("v1", "Node", "node-0", {"metadata": {"annotations": {
        s.L.DRIVER_UPGRADE_ENABLED: "false"}}})
    s.reconcile_policy()
    return s.annotations("node-0").get(s.L.DRIVER_UPGRADE_ENABLED)


def s_node_pause_survives_global_disable_cycle(s):
    converged(s, n_nodes=2)
    s.c.patch("v1", "Node", "node-0", {"metadata": {"annotations": {
        s.L.DRIVER_UPGRADE_ENABLED: "false"}}})
    out = []
    for on in (False, True):
        def flip(cr, on=on):
            cr["spec"]["upgradePolicy"] = {"autoUpgrade": on}
        s.edit_policy(flip)
        s.reconcile_policy()
        out.append([s.annotations(f"node-{i}").get(
            s.L.DRIVER_UPGRADE_ENABLED) for i in range(2)])
    return out


def s_sandbox_plane_halts_rollout(s):
    converged(s, n_nodes=1)
    s.change_driver_spec()

    def sandbox(cr):
        cr["spec"]["sandboxWorkloads"] = {"enabled": True}
    s.edit_policy(sandbox)
    s.reconcile(s.upgrader())
    return s.states()


# --- TestUpgradeEvents -------------------------------------------------------

def s_full_walk_emits_start_and_complete(s):
    converged(s, n_nodes=1)
    rec = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec)
    s.c.simulate_kubelet(ready=True)
    s.reconcile(rec)
    return s.states()


def s_validation_timeout_emits_failure_warning(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    rec = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec)
    clock[0] += 10_000
    s.reconcile(rec)
    return s.states()


# --- TestTPUDriverCRUpgradePath ------------------------------------------------

def s_driver_cr_rendered_ds_rolls_through_fsm(s):
    s.node("node-0", SINGLE, extra={
        s.L.deploy_label("libtpu-driver" if s.ref else "gpu-driver"): "true"})
    s.converge({"autoUpgrade": True, "maxParallelUpgrades": 1},
               extra_spec={"libtpu": {"enabled": False}})
    av = RV1ALPHA1 if s.ref else V1ALPHA1
    kind = "TPUDriver" if s.ref else "GPUDriver"
    s.c.create((new_tpu_driver if s.ref else new_gpu_driver)("pool-a"))
    drec = (TPUDriverReconciler if s.ref else GPUDriverReconciler)(
        client=s.c, namespace=s.ns)
    req = (RRequest if s.ref else Request)(name="pool-a")
    drec.reconcile(req)
    s.c.simulate_kubelet(ready=True)
    drec.reconcile(req)
    cr = thaw_obj(s.c.get(av, kind, "pool-a"))
    out = [cr["status"]["state"]]
    cr["spec"] = {"installDir": "/opt/new-flavor"}
    s.c.update(cr)
    drec.reconcile(req)
    s.c.simulate_kubelet(ready=True)
    urec = s.upgrader()
    s.reconcile(urec)
    out += [s.states(), s.cordoned("node-0")]
    s.c.simulate_kubelet(ready=True)
    s.reconcile(urec)
    return out + [s.states(), s.cordoned("node-0")]


# --- TestIsolatedPlaneDrain --------------------------------------------------

def drain_set(s, rec):
    fn = rec._tpu_workload_pods_by_node if s.ref else \
        rec._gpu_workload_pods_by_node
    return {n: sorted(p["metadata"]["name"] for p in pods)
            for n, pods in fn().items()}


def s_isolated_and_vgpu_pods_are_drained_too(s):
    converged(s, n_nodes=1)
    rec = s.upgrader()
    s.workload_pod("shared", "node-0", ready=True)
    s.workload_pod("isolated-wl", "node-0", "google.com/tpu-isolated")
    s.workload_pod("vtpu-wl", "node-0", "google.com/vtpu")
    s.c.create({"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "cpu-only", "namespace": "default"},
                "spec": {"nodeName": "node-0", "containers": [{
                    "name": "c", "resources": {"requests": {"cpu": "1"}}}]},
                "status": {"phase": "Running"}})
    return drain_set(s, rec)


def s_completed_pods_not_in_drain_set(s):
    converged(s, n_nodes=1)
    rec = s.upgrader()
    s.workload_pod("done-job", "node-0", phase="Succeeded")
    return drain_set(s, rec)


def s_renamed_plugin_resources_still_drained(s):
    converged(s, n_nodes=1)

    def rename(cr):
        cr["spec"]["isolatedDevicePlugin"] = {
            "resourceName": s.res("example.com/tpu-dedicated")}
    s.edit_policy(rename)
    rec = s.upgrader()
    s.workload_pod("renamed-wl", "node-0", "example.com/tpu-dedicated")
    s.change_driver_spec()
    s.reconcile(rec)
    return s.pod_exists("renamed-wl")


# --- TestOperatorRestartMidUpgrade -------------------------------------------

def s_fresh_instance_resumes_validation_without_redrain(s):
    converged(s, n_nodes=3)
    rec1 = s.upgrader()
    s.change_driver_spec()
    s.reconcile(rec1)
    [node] = [n for n, st in s.states().items()
              if st == "validation-required"]
    s.c.simulate_kubelet(ready=True)
    [pod] = [p for p in s.driver_pods()
             if get_nested(p, "spec", "nodeName") == node]
    rv = pod["metadata"]["resourceVersion"]
    rec2 = s.upgrader()
    s.reconcile(rec2)
    [after] = [p for p in s.driver_pods()
               if get_nested(p, "spec", "nodeName") == node]
    out = [node, s.states(), s.cordoned(node),
           after["metadata"]["resourceVersion"] == rv]
    s.reconcile(rec2)
    return out + [s.states()]


def s_drain_deadline_survives_restart(s):
    clock = [1000.0]
    rec1 = guarded(s, clock)
    s.reconcile(rec1)
    out = [s.states()]
    clock[0] += 301.0
    s.reconcile(s.upgrader(clock))
    return out + [s.states(), s.failed_reason("node-0")]


def s_validation_deadline_survives_restart(s):
    clock = [5000.0]
    converged(s, n_nodes=1)
    rec1 = s.upgrader(clock)
    s.change_driver_spec()
    s.reconcile(rec1)
    out = [s.states()]
    clock[0] += 301.0
    s.reconcile(s.upgrader(clock))
    return out + [s.states(), s.failed_reason("node-0")]


# the FSM's walk, units, failures and events; then the drain, the pauses
# and the restarts (one test file each, to keep a file's run short)
FSM = {f.__name__[2:]: f for f in (
    s_noop_when_current, s_auto_upgrade_off_strips_labels,
    s_single_node_full_upgrade_cycle, s_validation_waits_for_validator_pods,
    s_parallel_budget_respected,
    s_eventual_full_fleet_upgrade, s_slice_hosts_move_together,
    s_slice_never_half_validated, s_budget_counts_units_not_nodes,
    s_healing_diverged_member_label,
    s_wiped_state_and_stamp_heal_without_losing_the_unit,
    s_diverged_members_resync_to_earliest_stage,
    s_validation_timeout_drives_node_to_failed,
    s_failed_node_retries_after_backoff_and_recovers,
    s_upgrade_units_metric_counts_slices_once,
    s_failed_state_surfaced_in_metrics,
    s_whole_slice_fails_and_retries_together,
    s_full_walk_emits_start_and_complete,
    s_validation_timeout_emits_failure_warning)}
DRAIN = {f.__name__[2:]: f for f in (
    s_drain_evicts_workloads_but_respects_skip_label,
    s_pdb_blocks_drain_until_timeout_then_failed,
    s_drain_force_deletes_at_deadline,
    s_eviction_proceeds_when_pdb_has_headroom,
    s_drain_respects_custom_timeout,
    s_validation_waits_for_driver_pod_recreation,
    s_opted_out_host_excludes_whole_slice,
    s_pdb_match_expressions_blocks_eviction,
    s_terminating_driver_pod_does_not_shadow_replacement,
    s_disabling_upgrade_uncordons_failed_node,
    s_unstamped_drain_state_still_times_out,
    s_annotation_pause_excludes_node, s_pause_mid_rollout_strips_fsm_label,
    s_cr_annotation_pauses_whole_rollout,
    s_node_pause_survives_policy_reconcile,
    s_node_pause_survives_global_disable_cycle,
    s_sandbox_plane_halts_rollout,
    s_driver_cr_rendered_ds_rolls_through_fsm,
    s_isolated_and_vgpu_pods_are_drained_too,
    s_completed_pods_not_in_drain_set,
    s_renamed_plugin_resources_still_drained,
    s_fresh_instance_resumes_validation_without_redrain,
    s_drain_deadline_survives_restart,
    s_validation_deadline_survives_restart)}


def run(scenario, ref):
    s = Side(ref)
    observed = SCENARIOS[scenario](s)
    return {"observed": observed, **s.record()}

SCENARIOS = {**FSM, **DRAIN}


def run(scenario, ref):
    s = Side(ref)
    observed = SCENARIOS[scenario](s)
    return {"observed": observed, **s.record()}


def agrees(scenario):
    """The reference's transcript, mapped, and the port's."""
    ref = m(run(scenario, ref=True))
    ref["events"] = sorted(ref["events"])  # in the port's names' order
    return ref, run(scenario, ref=False)

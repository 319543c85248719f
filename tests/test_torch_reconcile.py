"""The port's GPUClusterPolicy reconcile against the JAX package's
TPUClusterPolicy reconcile: each on its own package's FakeClient, over
clusters mapped one to one (a TPU v5p host of 4 chips <-> an H100 host of
4 cards, a CPU node <-> a CPU node). Pass by pass the policy's state, its
conditions' types, statuses and reasons, the requeue, the DaemonSets (by
the name map of ``torch_naming.py``) and the node labels the operator
stamps are equal. Covers the cases of ``test_reconcile.py``'s
TestNodeLabelling and TestReconcile, and the DAG against the serial walk
(``OPERATOR_DAG=0``)."""

import pytest

import torch_naming as N
from tpu_operator.api import labels as RL
from tpu_operator.api.clusterpolicy import new_cluster_policy as rnew
from tpu_operator.api.clusterpolicy import KIND_CLUSTER_POLICY as RKIND
from tpu_operator.api.clusterpolicy import V1 as RV1
from tpu_operator.controllers import state_manager as rsm
from tpu_operator.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler as RReconciler)
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Request as RRequest
from tpu_operator.state import scheduler as rsched
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.clusterpolicy import (KIND_CLUSTER_POLICY, V1,
                                                  new_cluster_policy)
from tpu_operator_torch.controllers import state_manager as sm
from tpu_operator_torch.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler)
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Request
from tpu_operator_torch.state import scheduler

# the cluster map: a GKE TPU v5p host of 4 chips <-> a GKE H100 host of 4
# cards; the generation each side stamps
REF_GPU_LABELS = {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
                  RL.GKE_TPU_TOPOLOGY: "2x2x1",
                  RL.GKE_ACCELERATOR_COUNT: "4"}
GPU_LABELS = {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
              L.GKE_ACCELERATOR_COUNT: "4"}
GENERATIONS = {"v5p": "h100-sxm"}
# the condition reasons the reconcilers name
REASONS = {"NoTPUNodes": "NoGPUNodes"}


class Side:
    """One package's cluster, reconciler and vocabulary."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.c = RFake() if ref else FakeClient()
        self.ns = "tpu-operator" if ref else "gpu-operator"
        self.policy_name = "tpu-cluster-policy" if ref else \
            "gpu-cluster-policy"
        self.v1, self.kind = (RV1, RKIND) if ref else (V1, KIND_CLUSTER_POLICY)
        self.rec = None

    def add_accel_node(self, name, extra=None):
        labels = dict(REF_GPU_LABELS if self.ref else GPU_LABELS)
        labels.update(extra or {})
        res = "google.com/tpu" if self.ref else L.GPU_RESOURCE
        self.c.add_node(name, labels=labels, allocatable={res: "4"})

    def policy(self, name=None, spec=None, created=None):
        new = rnew if self.ref else new_cluster_policy
        cr = new(name or self.policy_name,
                 spec=(spec if self.ref else N.spec(spec)) if spec else None)
        if created:
            cr["metadata"]["creationTimestamp"] = created
        self.c.create(cr)

    def strip_node(self, name):
        """The node loses its accelerator (a pool recreated)."""
        from tpu_operator_torch.runtime.objects import thaw_obj

        node = thaw_obj(self.c.get("v1", "Node", name))
        for k in (REF_GPU_LABELS if self.ref else GPU_LABELS):
            node["metadata"]["labels"].pop(k, None)
        node["status"]["allocatable"] = {}
        self.c.update(node)

    def set_spec(self, spec, name=None):
        from tpu_operator_torch.runtime.objects import thaw_obj

        cr = thaw_obj(self.c.get(self.v1, self.kind, name or self.policy_name))
        cr["spec"] = spec if self.ref else N.spec(spec)
        self.c.update(cr)

    def reconcile(self, name=None):
        if self.rec is None:
            cls = RReconciler if self.ref else ClusterPolicyReconciler
            self.rec = cls(client=self.c, namespace=self.ns)
        req = (RRequest if self.ref else Request)(
            name=name or self.policy_name)
        return self.rec.reconcile(req)

    def observe(self, result, name=None):
        """What the pass left, in the port's names."""
        m = N.name if self.ref else (lambda v: v)
        cr = self.c.get(self.v1, self.kind, name or self.policy_name)
        st = cr.get("status") or {}
        conds = [(c["type"], c["status"],
                  REASONS.get(c["reason"], c["reason"]) if self.ref
                  else c["reason"]) for c in st.get("conditions") or []]
        dss = sorted(m(d["metadata"]["name"])
                     for d in self.c.list("apps/v1", "DaemonSet"))
        nodes = {}
        inputs = set(REF_GPU_LABELS if self.ref else GPU_LABELS)
        for node in self.c.list("v1", "Node"):
            labels = {}
            for k, v in (node["metadata"].get("labels") or {}).items():
                if k in inputs:
                    continue
                if self.ref:
                    k, v = N.name(k), GENERATIONS.get(v, N.name(v))
                labels[k] = v
            anns = {m(k): v for k, v in
                    (node["metadata"].get("annotations") or {}).items()}
            nodes[node["metadata"]["name"]] = (labels, anns)
        ns = self.c.get_or_none("v1", "Namespace", self.ns) or {}
        return {"state": st.get("state"), "conditions": conds,
                "requeue_after": result.requeue_after,
                "requeue": result.requeue, "daemonsets": dss,
                "nodes": nodes, "clusterInfo": bool(st.get("clusterInfo")),
                "namespace_labels": (ns.get("metadata") or {}).get("labels")}


def make(ref, n_gpu=1, n_cpu=1):
    s = Side(ref)
    for i in range(n_gpu):
        s.add_accel_node(f"acc-{i}")
    for i in range(n_cpu):
        s.c.add_node(f"cpu-{i}")
    return s



# a scenario: actions on a side, and "pass" for a reconcile that is observed
SCENARIOS = {
    "full-convergence": [lambda s: s.policy(), "pass",
                         lambda s: s.c.simulate_kubelet(ready=True), "pass",
                         "pass"],
    "no-gpu-nodes": [lambda s: s.policy(), "pass", "pass"],
    "stale-revision": [lambda s: s.policy(), "pass",
                       lambda s: s.c.simulate_kubelet(ready=True,
                                                      stale_hash=True),
                       "pass"],
    "disabled-operand": [lambda s: s.policy(), "pass",
                         lambda s: s.set_spec(
                             {"metricsExporter": {"enabled": False}}),
                         "pass"],
    "spec-change": [lambda s: s.policy(), "pass",
                    lambda s: s.set_spec(
                        {"libtpu": {"installDir": "/opt/custom"}}),
                    "pass"],
    "sandbox-virtual": [lambda s: s.policy(spec={"sandboxWorkloads": {
        "enabled": True, "defaultWorkload": "virtual"}}), "pass",
        lambda s: s.c.simulate_kubelet(ready=True), "pass"],
    "psa-and-upgrade": [lambda s: s.policy(spec={
        "psa": {"enabled": True}, "upgradePolicy": {"autoUpgrade": True}}),
        "pass", lambda s: s.set_spec({}), "pass"],
    "node-loses-accelerator": [lambda s: s.policy(), "pass",
                               lambda s: s.strip_node("acc-0"), "pass"],
    "two-gpu-nodes": [lambda s: s.add_accel_node("acc-1"),
                      lambda s: s.policy(), "pass",
                      lambda s: s.c.simulate_kubelet(ready=True), "pass"],
}


def play(ref, scenario):
    s = make(ref, n_gpu=0 if scenario == "no-gpu-nodes" else 1, n_cpu=1)
    passes = []
    for step in SCENARIOS[scenario]:
        if step == "pass":
            passes.append(s.observe(s.reconcile()))
        else:
            step(s)
    return s, passes


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_passes_match_the_reference(scenario):
    _, ref = play(True, scenario)
    _, ours = play(False, scenario)
    assert ours == ref


def test_first_pass_is_not_ready_then_ready():
    s, passes = play(False, "full-convergence")
    first, ready = passes[0], passes[1]
    assert (first["state"], first["requeue_after"]) == ("notReady", 5.0)
    assert ("Ready", "False", "OperandsNotReady") in first["conditions"]
    assert ready["state"] == "ready" and ready["requeue_after"] == 0.0
    assert ("Ready", "True", "Reconciled") in ready["conditions"]
    assert {"gpu-driver-daemonset", "gpu-operator-validator",
            "gpu-device-plugin-daemonset"} <= set(first["daemonsets"])
    node, _ = first["nodes"]["acc-0"]
    assert (node[L.PRESENT], node[L.GPU_GENERATION], node[L.GPU_CHIP_COUNT]) \
        == ("true", "h100-sxm", "4")
    assert {k for k, v in node.items() if k.startswith(L.DEPLOY_PREFIX)} == {
        L.deploy_label(st) for st in L.CONTAINER_WORKLOAD_STATES}
    assert first["nodes"]["cpu-0"] == ({}, {})


def test_no_gpu_nodes_polls_45s():
    _, passes = play(False, "no-gpu-nodes")
    assert passes[0]["requeue_after"] == 45.0
    assert ("Ready", "False", "NoGPUNodes") in passes[0]["conditions"]


def test_singleton_duplicate_ignored():
    out = []
    for ref in (True, False):
        s = make(ref)
        s.policy("first")
        s.policy("zz-second", created="2099-01-01T00:00:00Z")
        s.reconcile("zz-second")
        cr = s.c.get(s.v1, s.kind, "zz-second")
        out.append((cr["status"]["state"],
                    [(c["type"], c["status"], c["reason"])
                     for c in cr["status"]["conditions"]]))
    assert out[0] == out[1]
    assert out[1][0] == "ignored"


def test_hash_skip_rewrites_nothing():
    """A steady pass leaves every object's resourceVersion as it was."""
    for ref in (True, False):
        s = make(ref)
        s.policy()
        s.reconcile()
        s.c.simulate_kubelet(ready=True)
        s.reconcile()
        before = {(d["kind"], d["metadata"]["name"]):
                  d["metadata"]["resourceVersion"]
                  for kind in ("DaemonSet", "ServiceAccount")
                  for d in s.c.list("apps/v1" if kind == "DaemonSet"
                                    else "v1", kind)}
        s.c.reset_verb_counts()
        s.reconcile()
        after = {(d["kind"], d["metadata"]["name"]):
                 d["metadata"]["resourceVersion"]
                 for kind in ("DaemonSet", "ServiceAccount")
                 for d in s.c.list("apps/v1" if kind == "DaemonSet"
                                   else "v1", kind)}
        assert after == before
        verbs = s.c.reset_verb_counts()
        assert not {"create", "update", "patch", "delete",
                    "update_status"} & set(verbs), verbs


def test_owner_references_and_hash_annotations():
    s = make(False)
    s.policy()
    s.reconcile()
    ds = s.c.get("apps/v1", "DaemonSet", "gpu-driver-daemonset",
                 "gpu-operator")
    assert ds["metadata"]["ownerReferences"][0]["kind"] == KIND_CLUSTER_POLICY
    anns = ds["metadata"]["annotations"]
    assert anns[L.SPEC_HASH] == anns[L.LAST_APPLIED_HASH]
    assert ds["metadata"]["labels"][L.STATE_LABEL] == "gpu-driver"


@pytest.mark.parametrize("serial", [False, True], ids=["dag", "serial"])
def test_dag_and_serial_walk_match_the_reference(serial):
    gates = (rsched.DAG_GATE, scheduler.DAG_GATE)
    before = [g.enabled for g in gates]
    try:
        for g in gates:
            g.enabled = not serial
        _, ref = play(True, "full-convergence")
        _, ours = play(False, "full-convergence")
    finally:
        for g, was in zip(gates, before):
            g.enabled = was
    assert ours == ref


def test_serial_walk_equals_the_dag():
    gate = scheduler.DAG_GATE
    was = gate.enabled
    try:
        gate.enabled = False
        _, serial = play(False, "full-convergence")
        gate.enabled = True
        _, dag = play(False, "full-convergence")
    finally:
        gate.enabled = was
    assert serial == dag


# -- node labelling, function by function ------------------------------------


NODE_CASES = {
    "container": ({}, "container", True),
    "isolated": ({"workload.config": "isolated"}, "container", True),
    "virtual": ({"workload.config": "virtual"}, "container", True),
    "virtual-sandbox-off": ({"workload.config": "virtual"}, "container",
                            False),
    "unknown-config": ({"workload.config": "bogus"}, "container", True),
    "default-virtual": ({}, "virtual", True),
}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_desired_node_labels_match_the_reference(case):
    extra, default, sandbox = NODE_CASES[case]
    rnode, node = make(True), make(False)
    rnode.add_accel_node("n", {RL.DOMAIN + "/" + k: v
                               for k, v in extra.items()})
    node.add_accel_node("n", {L.DOMAIN + "/" + k: v
                              for k, v in extra.items()})
    want_ref = rsm.desired_node_labels(rnode.c.get("v1", "Node", "n"),
                                       default, sandbox)
    want = sm.desired_node_labels(node.c.get("v1", "Node", "n"), default,
                                  sandbox)
    assert want == {N.name(k): GENERATIONS.get(v, N.name(v))
                    for k, v in want_ref.items()}


def test_gpu_node_detection():
    def node(labels=None, alloc=None):
        return {"metadata": {"labels": labels or {}},
                "status": {"allocatable": alloc or {}}}

    assert L.is_gpu_node(node({L.GKE_ACCELERATOR: "nvidia-h100-80gb"}))
    assert L.is_gpu_node(node(alloc={L.GPU_RESOURCE: "8"}))
    assert not L.is_gpu_node(node({L.GKE_ACCELERATOR: "tpu-v5p-slice"}))
    assert not L.is_gpu_node(node())
    assert sm.is_gpu_node is L.is_gpu_node


def test_label_gpu_nodes_counts_and_strips():
    s = make(False, n_gpu=2)
    mgr = sm.StateManager(client=s.c, namespace="gpu-operator")
    assert mgr.label_gpu_nodes() == 2
    s.strip_node("acc-0")
    assert mgr.label_gpu_nodes() == 1
    labels = s.c.get("v1", "Node", "acc-0")["metadata"]["labels"]
    assert not any(k.startswith(L.DOMAIN) for k in labels)


def test_cluster_facts_match_the_reference():
    from tpu_operator.controllers.clusterinfo import ClusterInfo as RInfo
    from tpu_operator_torch.controllers.clusterinfo import ClusterInfo

    rs, ps = make(True, n_gpu=2), make(False, n_gpu=2)
    ref, ours = RInfo(rs.c).facts(), ClusterInfo(ps.c).facts()
    assert ours["containerRuntime"] == ref["containerRuntime"]
    assert ours["gpuGenerations"] == {
        GENERATIONS[k]: v for k, v in ref["tpuGenerations"].items()}
    # GKE names no GPU topology; feature discovery's label is absent here
    assert ours["gpuTopologies"] == {"unknown": 2}

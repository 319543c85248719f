"""The port's GPUDriver CRD and controller against the JAX package's
TPUDriver: the scenarios of ``test_tpudriver.py`` (pools, the restrict
selector, CPU nodes, disjoint and overlapping selectors, one DaemonSet a
pool with the pool's selector and OnDelete, stale pool cleanup, the
conflict condition, the missing policy, the policy's driver state
standing down in CRD mode), each run on both packages' own
``FakeClient`` over clusters mapped one to one: a TPU v5p host of 4
chips <-> an H100 host of 4 cards on NVSwitch, a v5e host of 8 <-> an
A100 host of 8. Each scenario's transcript, the reference's under the
name map of ``torch_naming.py``, is equal."""

import pytest

import torch_naming as N
from tpu_operator.api import labels as RL
from tpu_operator.api.clusterpolicy import new_cluster_policy as rnew_policy
from tpu_operator.api.conditions import get_condition as rget_condition
from tpu_operator.api.tpudriver import KIND_TPU_DRIVER, TPUDriverSpec
from tpu_operator.api.tpudriver import V1ALPHA1 as RV1ALPHA1
from tpu_operator.api.tpudriver import new_tpu_driver
from tpu_operator.controllers import validation as rvalidation
from tpu_operator.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler as RPolicyReconciler)
from tpu_operator.controllers.tpudriver_controller import TPUDriverReconciler
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Request as RRequest
from tpu_operator.state import nodepool as rnodepool
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.api.conditions import get_condition
from tpu_operator_torch.api.gpudriver import (KIND_GPU_DRIVER, V1ALPHA1,
                                              GPUDriverSpec, new_gpu_driver)
from tpu_operator_torch.controllers import validation
from tpu_operator_torch.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler)
from tpu_operator_torch.controllers.gpudriver_controller import (
    GPUDriverReconciler)
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Request
from tpu_operator_torch.state import nodepool

# the cluster map, pool by pool
POOLS = {"v5p-2x2x1": "nvidia-h100-80gb-hbm3-nvswitch-4",
         "v5e-2x4": "nvidia-a100-sxm4-80gb-nvswitch-8"}
REF_NODES = {
    "a": ({RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
           RL.GKE_TPU_TOPOLOGY: "2x2x1", RL.GKE_ACCELERATOR_COUNT: "4"},
          {"google.com/tpu": "4"}),
    "e": ({RL.GKE_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
           RL.GKE_TPU_TOPOLOGY: "2x4"}, {"google.com/tpu": "8"}),
}
PORT_NODES = {
    "a": ({L.GKE_ACCELERATOR: "nvidia-h100-80gb",
           L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
           L.GPU_TOPOLOGY: "nvswitch-4", L.GKE_ACCELERATOR_COUNT: "4"},
          {L.GPU_RESOURCE: "4"}),
    "e": ({L.GKE_ACCELERATOR: "nvidia-a100-80gb",
           L.GPU_PRODUCT: "NVIDIA-A100-SXM4-80GB",
           L.GPU_TOPOLOGY: "nvswitch-8"}, {L.GPU_RESOURCE: "8"}),
}
# the pool-key values of the map
VALUES = {"tpu-v5p-slice": "NVIDIA-H100-80GB-HBM3", "2x2x1": "nvswitch-4",
          "tpu-v5-lite-podslice": "NVIDIA-A100-SXM4-80GB", "2x4": "nvswitch-8"}


def m(value):
    """A reference name in the port's words: pools, per-pool DaemonSets,
    the pool key's labels and values, then the general rule."""
    if isinstance(value, str):
        if value in POOLS:
            return POOLS[value]
        pre, post = N.DRIVER_DS_PREFIX
        if value.startswith(pre):
            return post + POOLS[value[len(pre):]]
        spre, spost = N.DRIVER_STATE_PREFIX
        if value.startswith(spre) and value not in N.EXACT:
            return spost + value[len(spre):]
        if value in N.POOL_KEY:
            return N.POOL_KEY[value]
        if value in VALUES:
            return VALUES[value]
        return N.name(value).replace("TPUDriver", "GPUDriver").replace(
            "TPUClusterPolicy", "GPUClusterPolicy").replace(
            "TPU nodes", "GPU nodes")
    if isinstance(value, dict):
        return {m(k): m(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(m(v) for v in value)
    return value


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.c = RFake() if ref else FakeClient()
        self.ns = "tpu-operator" if ref else "gpu-operator"
        self.av = RV1ALPHA1 if ref else V1ALPHA1
        self.kind = KIND_TPU_DRIVER if ref else KIND_GPU_DRIVER
        self.policy_name = "tpu-cluster-policy" if ref else \
            "gpu-cluster-policy"
        self.policy_ds = "tpu-libtpu-driver-daemonset" if ref else \
            "gpu-driver-daemonset"
        self.topology = RL.GKE_TPU_TOPOLOGY if ref else L.GPU_TOPOLOGY
        self.topology_a = "2x2x1" if ref else "nvswitch-4"
        self.rec = None

    def node(self, kind, name, extra=None):
        labels, alloc = (REF_NODES if self.ref else PORT_NODES)[kind]
        self.c.add_node(name, labels={**labels, **(extra or {})},
                        allocatable=dict(alloc))

    def pools(self, restrict=None):
        mod = rnodepool if self.ref else nodepool
        return [(p.name, p.nodes) for p in mod.get_node_pools(
            self.c.list("v1", "Node"), restrict=restrict)]

    def driver(self, name, spec=None):
        new = new_tpu_driver if self.ref else new_gpu_driver
        return self.c.create(new(name, spec))

    def policy(self):
        self.c.create((rnew_policy if self.ref else new_cluster_policy)())

    def validate(self, cr):
        mod = rvalidation if self.ref else validation
        try:
            mod.validate_node_selectors(self.c, cr)
            return "ok"
        except mod.ValidationError as e:
            return ["ValidationError", "disjoint" in str(e)]

    def reconcile(self, name):
        if self.rec is None:
            cls = TPUDriverReconciler if self.ref else GPUDriverReconciler
            self.rec = cls(client=self.c, namespace=self.ns)
        res = self.rec.reconcile((RRequest if self.ref else Request)(
            name=name))
        return [res.requeue, res.requeue_after]

    def reconcile_policy(self):
        cls = RPolicyReconciler if self.ref else ClusterPolicyReconciler
        cls(client=self.c, namespace=self.ns).reconcile(
            (RRequest if self.ref else Request)(name=self.policy_name))

    def daemonsets(self):
        return sorted(d["metadata"]["name"]
                      for d in self.c.list("apps/v1", "DaemonSet"))

    def ds(self, name):
        d = self.c.get("apps/v1", "DaemonSet", name, self.ns)
        tmpl = d["spec"]["template"]["spec"]
        return {"nodeSelector": tmpl["nodeSelector"],
                "updateStrategy": d["spec"]["updateStrategy"]["type"],
                "state": d["metadata"]["labels"].get(
                    (RL if self.ref else L).STATE_LABEL)}

    def status(self, name):
        cr = self.c.get(self.av, self.kind, name)
        st = cr.get("status") or {}
        get = rget_condition if self.ref else get_condition
        conds = {}
        for t in ("Ready", "Error"):
            c = get(cr, t)
            if c is not None:
                conds[t] = [c["status"], c["reason"],
                            "disjoint" in c.get("message", "")]
        return [st.get("state"), conds]


def s_pools(s):
    s.node("a", "a")
    s.node("a", "b")
    s.node("e", "e0")
    return s.pools()


def s_restrict(s):
    s.node("a", "a", {"pool": "x"})
    s.node("e", "e0")
    return s.pools(restrict={"pool": "x"})


def s_cpu_nodes_ignored(s):
    s.c.add_node("cpu-0")
    return s.pools()


def s_disjoint_selectors(s):
    s.node("a", "a", {"pool": "x"})
    s.node("e", "e", {"pool": "y"})
    s.driver("dx", {"nodeSelector": {"pool": "x"}})
    return s.validate(s.driver("dy", {"nodeSelector": {"pool": "y"}}))


def s_overlap(s):
    s.node("a", "a")
    s.driver("d1", {"nodeSelector": {}})
    return s.validate(s.driver("d2", {
        "nodeSelector": {s.topology: s.topology_a}}))


def setup(s):
    s.node("a", "a")
    s.node("e", "e0")
    s.policy()


def s_per_pool_daemonsets(s):
    setup(s)
    s.driver("flavors")
    out = [s.reconcile("flavors"), s.daemonsets(), s.status("flavors")]
    s.c.simulate_kubelet(ready=True)
    out += [s.reconcile("flavors"), s.status("flavors")]
    return out


def s_pool_selector_on_daemonset(s):
    setup(s)
    s.driver("flavors")
    s.reconcile("flavors")
    pre = N.DRIVER_DS_PREFIX[0] if s.ref else N.DRIVER_DS_PREFIX[1]
    pool = "v5p-2x2x1" if s.ref else POOLS["v5p-2x2x1"]
    return s.ds(pre + pool)


def s_stale_pool_cleanup(s):
    setup(s)
    s.driver("flavors")
    s.reconcile("flavors")
    before = s.daemonsets()
    s.c.delete("v1", "Node", "e0")
    s.reconcile("flavors")
    return [before, s.daemonsets()]


def s_conflict(s):
    setup(s)
    s.driver("one")
    s.driver("two")
    return [s.reconcile("two"), s.status("two"), s.daemonsets()]


def s_requires_policy(s):
    s.node("a", "a")
    s.driver("solo")
    return [s.reconcile("solo"), s.status("solo")]


def s_no_matching_nodes(s):
    setup(s)
    s.driver("none", {"nodeSelector": {"pool": "absent"}})
    return [s.reconcile("none"), s.status("none"), s.daemonsets()]


def s_stands_down_in_crd_mode(s):
    setup(s)
    s.reconcile_policy()
    before = s.policy_ds in s.daemonsets()
    s.driver("flavors")
    s.reconcile_policy()
    return [before, s.policy_ds in s.daemonsets()]


def s_deleted_cr(s):
    setup(s)
    return s.reconcile("gone")


SCENARIOS = {f.__name__[2:]: f for f in (
    s_pools, s_restrict, s_cpu_nodes_ignored, s_disjoint_selectors,
    s_overlap, s_per_pool_daemonsets, s_pool_selector_on_daemonset,
    s_stale_pool_cleanup, s_conflict, s_requires_policy,
    s_no_matching_nodes, s_stands_down_in_crd_mode, s_deleted_cr)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_agrees(scenario):
    ref = m(SCENARIOS[scenario](Side(ref=True)))
    port = SCENARIOS[scenario](Side(ref=False))
    assert port == ref


def test_scenarios_say_what_they_are_named_for():
    s = Side(ref=False)
    assert SCENARIOS["pools"](s) == [
        ("nvidia-a100-sxm4-80gb-nvswitch-8", ["e0"]),
        ("nvidia-h100-80gb-hbm3-nvswitch-4", ["a", "b"])]
    first, dss, status, again, ready = SCENARIOS["per_pool_daemonsets"](
        Side(ref=False))
    assert first == [False, 5.0] and again == [False, 0.0]
    assert {"gpu-driver-nvidia-h100-80gb-hbm3-nvswitch-4",
            "gpu-driver-nvidia-a100-sxm4-80gb-nvswitch-8"} <= set(dss)
    assert status[0] == "notReady" and ready[0] == "ready"
    assert ready[1]["Ready"][0] == "True"
    sel = SCENARIOS["pool_selector_on_daemonset"](Side(ref=False))
    assert sel["nodeSelector"][L.GPU_PRODUCT] == "NVIDIA-H100-80GB-HBM3"
    assert sel["nodeSelector"][L.GPU_TOPOLOGY] == "nvswitch-4"
    assert sel["nodeSelector"][L.deploy_label("gpu-driver")] == "true"
    assert sel["updateStrategy"] == "OnDelete"
    conflict = SCENARIOS["conflict"](Side(ref=False))
    assert conflict[1][1]["Error"][0] == "True" and \
        conflict[1][1]["Error"][2]
    assert SCENARIOS["requires_policy"](Side(ref=False))[1][1]["Error"][1] \
        == "MissingClusterPolicy"
    assert SCENARIOS["stands_down_in_crd_mode"](Side(ref=False)) == [
        True, False]


def test_spec_maps_by_the_rule():
    """GPUDriverSpec is TPUDriverSpec under the rule: the same wire
    fields but the renamed one, the defaults of DRIVER_SPEC_DEFAULTS."""
    ref = TPUDriverSpec().to_obj()
    port = GPUDriverSpec().to_obj()
    renamed = {N.DRIVER_SPEC_FIELDS.get(k, k): v for k, v in ref.items()}
    for field, (rv, pv) in N.DRIVER_SPEC_DEFAULTS.items():
        assert ref.get(field) == rv
        assert port.get(N.DRIVER_SPEC_FIELDS.get(field, field)) == pv
        renamed.pop(N.DRIVER_SPEC_FIELDS.get(field, field), None)
        port.pop(N.DRIVER_SPEC_FIELDS.get(field, field), None)
    assert port == renamed
    import dataclasses

    from tpu_operator_torch.api.convert import wire_name
    rfields = {wire_name(f) for f in dataclasses.fields(TPUDriverSpec)}
    pfields = {wire_name(f) for f in dataclasses.fields(GPUDriverSpec)}
    assert pfields == {N.DRIVER_SPEC_FIELDS.get(f, f) for f in rfields}
    spec = GPUDriverSpec.from_obj(new_gpu_driver("x", {
        "driverVersion": "580.1", "upgradePolicy": {"drainForce": True}}))
    assert spec.driver_version == "580.1"
    assert spec.upgrade_policy.drain_force is True
    assert new_gpu_driver("x")["apiVersion"] == N.name(
        new_tpu_driver("x")["apiVersion"])

"""The port's SliceRequest placement reconciler
(``controllers/placement_controller.py``) against the JAX package's, on
fleets mapped one to one (``torch_placement_fleets``): each scenario
runs on both packages' own FakeClient and records, after every step,
what each reconcile returned, every request's status and every node's
lease; the reference's transcript, under the naming rule (pools, domain
ids, reasons), equals the port's. The scenarios are the reference's
outcomes: Placed, Unschedulable with its backoff, the gang pass, the
drain events (node gone, lease stolen, product pin broken, telemetry
condemnation), priority preemption, deletion, and the shrink/grow resize
handshake over the elastic shim, the direct shard handoff included. The
Node watch's facet and the requeue replay have tests of their own."""

import pytest

import torch_naming as N
import torch_placement_fleets as F
from tpu_operator.api import labels as RL
from tpu_operator.api import slicerequest as rsr
from tpu_operator.controllers import placement_controller as rpc
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime.client import WatchEvent as RWatchEvent
from tpu_operator.topology import placement as rp
from tpu_operator.workloads import elastic as relastic
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api import slicerequest as sr
from tpu_operator_torch.controllers import placement_controller as pc
from tpu_operator_torch.runtime.client import WatchEvent
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Request
from tpu_operator_torch.runtime.objects import (annotations_of, get_nested,
                                                thaw_obj)
from tpu_operator_torch.topology import placement as p
from tpu_operator_torch.workloads import elastic


class Side:
    def __init__(self, ref: bool, preemption=False, **fleet):
        self.ref = ref
        self.mod, self.L = (rsr, RL) if ref else (sr, L)
        self.c = RFake() if ref else FakeClient()
        F.add_nodes(self.c, ref, **fleet)
        self.t = [1000.0]
        self.rec = (rpc if ref else pc).PlacementReconciler(
            client=self.c, namespace="default", preemption=preemption,
            now=lambda: self.t[0])
        self.names = []
        self.product = F.FAST[0 if ref else 2]
        self.label = (RL.GKE_TPU_ACCELERATOR if ref else L.GPU_PRODUCT)

    def create(self, name, **spec):
        if "accelerator" in spec:
            spec["accelerator"] = self.product
        self.c.create(self.mod.new_slice_request(name, spec,
                                                 namespace="default"))
        self.names.append(name)

    def reconcile(self, name):
        res = self.rec.reconcile((RRequest if self.ref else Request)(
            name=name, namespace="default"))
        return (res.requeue, res.requeue_after)

    def get(self, name):
        return self.c.get_or_none(self.mod.V1ALPHA1,
                                  self.mod.KIND_SLICE_REQUEST, name,
                                  "default")

    def patch_node(self, name, patch):
        self.c.patch("v1", "Node", name, patch)

    def shim(self, name, **kw):
        cls = (relastic if self.ref else elastic).ElasticWorkload
        return cls(self.c, name, "default", clock=lambda: self.t[0], **kw)

    def state(self):
        reqs = {}
        for name in self.names:
            cr = self.get(name)
            reqs[name] = None if cr is None else {
                "status": thaw_obj(cr.get("status") or {}),
                "intent": {k.rpartition("/")[2]: v for k, v in
                           annotations_of(cr).items()}}
        leases = {}
        for node in self.c.list("v1", "Node"):
            owner = annotations_of(node).get(self.L.PLACED_BY)
            if owner:
                leases[node["metadata"]["name"]] = owner
        return {"requests": reqs, "leases": leases}


def port_words(tree, pools, slices):
    """A reference transcript in the port's words."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "pool" and isinstance(v, str):
                v = pools.get(v, v)
            elif k == "sliceId" and isinstance(v, str):
                v = slices.get(v, v)
            elif k in ("reason", "lastEvictionReason") and \
                    isinstance(v, str):
                v = F.text(v, pools).replace(F.FAST[0], F.FAST[2])
            out[k] = port_words(v, pools, slices)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(port_words(v, pools, slices) for v in tree)
    if isinstance(tree, str):
        return N.name(tree)
    return tree


def run(scenario, fleet=None, preemption=False):
    fleet = fleet or {}
    out = []
    for ref in (True, False):
        s = Side(ref, preemption=preemption, **fleet)
        out.append(list(scenario(s)))
    rnodes = F.node_objects(True, **fleet)
    pnodes = F.node_objects(False, **fleet)
    rf, pf = rp.FleetState(rnodes), p.FleetState(pnodes)
    return port_words(out[0], F.pool_map(rf, pf), F.slice_map(rf, pf)), \
        out[1]


def sc_placed_and_unschedulable(s):
    s.create("small", chips=4)
    yield s.reconcile("small"), s.state()
    s.create("wide", chips=16)
    yield s.reconcile("wide"), s.state()
    s.create("huge", chips=64)
    yield s.reconcile("huge"), s.state()
    s.t[0] += 30
    yield s.reconcile("huge"), s.state()
    s.create("pinned", chips=8, accelerator=True)
    yield s.reconcile("pinned"), s.state()
    # a steady pass over a sound binding writes nothing new
    yield s.reconcile("small"), s.state()


def sc_gang_pass(s):
    for i, chips in enumerate((8, 4, 16, 4, 8)):
        s.create(f"g{i}", chips=chips, priority=i % 3)
    yield s.reconcile("g0"), s.state()
    for i in range(1, 5):
        yield s.reconcile(f"g{i}"), s.state()


def sc_drain_events(s):
    for name, chips in (("a", 4), ("b", 8), ("c", 4), ("d", 4)):
        s.create(name, chips=chips, accelerator=True)
        s.reconcile(name)
    yield s.state()
    nodes = {n: get_nested(s.get(n), "status", "nodes") for n in "abcd"}
    s.c.delete("v1", "Node", nodes["a"][0])
    yield s.reconcile("a"), s.state()
    s.patch_node(nodes["b"][0], {"metadata": {"annotations": {
        s.L.PLACED_BY: "default/thief"}}})
    yield s.reconcile("b"), s.state()
    s.patch_node(nodes["c"][0], {"metadata": {"labels": {
        s.label: "something-else"}}})
    yield s.reconcile("c"), s.state()
    node = thaw_obj(s.c.get("v1", "Node", nodes["d"][0]))
    node["status"]["conditions"].append(
        {"type": s.L.TELEMETRY_CONDITION, "status": "False"})
    s.c.update_status(node)
    yield s.reconcile("d"), s.state()
    s.c.delete(s.mod.V1ALPHA1, s.mod.KIND_SLICE_REQUEST, "a", "default")
    yield s.reconcile("a"), s.state()


def sc_priority_preemption(s):
    for name in ("low-1", "low-2", "low-3"):
        s.create(name, chips=8, priority=0)
        s.reconcile(name)
    yield s.state()
    s.create("high", chips=8, priority=5)
    yield s.reconcile("high"), s.state()
    s.create("huge", chips=64, priority=9)
    yield s.reconcile("huge"), s.state()
    for name in ("low-1", "low-2", "low-3"):
        yield s.reconcile(name), s.state()


def sc_resize(s):
    s.create("job", chips=8)
    s.reconcile("job")
    w = s.shim("job", state_bytes=16 << 20)
    for _ in range(3):
        w.tick()
        s.t[0] += 5
    yield s.state()
    cr = thaw_obj(s.get("job"))
    cr["spec"]["chips"] = 4
    s.c.update(cr)
    yield s.reconcile("job"), s.state()
    w.tick()
    yield (w.step, w.max_acked), s.state()
    yield s.reconcile("job"), s.state()
    w.tick()
    yield (w.step, w.last_reshard), s.state()
    cr = thaw_obj(s.get("job"))
    cr["spec"]["chips"] = 8
    s.c.update(cr)
    yield s.reconcile("job"), s.state()
    # nobody acks this one: past the deadline the binding is kept
    s.t[0] += 200
    yield s.reconcile("job"), s.state()
    yield s.reconcile("job"), s.state()


def sc_resize_non_elastic(s):
    s.create("job", chips=8)
    s.reconcile("job")
    s.c.patch(s.mod.V1ALPHA1, s.mod.KIND_SLICE_REQUEST, "job",
              {"metadata": {"annotations": {s.L.SLICE_ELASTIC: "false"}}},
              namespace="default")
    cr = thaw_obj(s.get("job"))
    cr["spec"]["chips"] = 4
    s.c.update(cr)
    yield s.reconcile("job"), s.state()
    yield s.reconcile("job"), s.state()


SCENARIOS = {
    "placed_and_unschedulable": (sc_placed_and_unschedulable, {}, False),
    "gang_pass": (sc_gang_pass, {}, False),
    "drain_events": (sc_drain_events, {}, False),
    "priority_preemption": (sc_priority_preemption,
                            {"singles": 2, "slices": ("pa",), "hosts": 2},
                            True),
    "resize": (sc_resize, {"singles": 0, "slices": ("pa", "pb")}, False),
    "resize_non_elastic": (sc_resize_non_elastic, {}, False),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_agrees(name):
    scenario, fleet, preemption = SCENARIOS[name]
    want, got = run(scenario, fleet, preemption)
    assert got == want


def test_scenarios_say_what_they_are_named_for():
    _, got = run(sc_placed_and_unschedulable)
    phases = {k: (v or {}).get("status", {}).get("phase")
              for k, v in got[-1][1]["requests"].items()}
    assert phases == {"small": "Placed", "wide": "Placed",
                      "huge": "Unschedulable", "pinned": "Placed"}
    huge = got[3][1]["requests"]["huge"]["status"]
    assert huge["requeueAttempts"] == 2
    assert "largest NVLink domain offers 16 chips" in huge["reason"]
    _, got = run(*SCENARIOS["drain_events"][:2])
    reasons = [step[1]["requests"][n]["status"].get("lastEvictionReason")
               for step, n in zip(got[1:5], "abcd")]
    assert reasons[0].endswith("removed")
    assert reasons[1] == f"lease on node {reasons[1].split()[3]} taken by " \
        "default/thief"
    assert "no longer matches accelerator pin 'NVIDIA-GB200'" in reasons[2]
    assert reasons[3].endswith("condemned by telemetry")
    assert got[-1][1]["requests"]["a"] is None
    _, got = run(*SCENARIOS["resize"][:2])
    mig = got[3][1]["requests"]["job"]["status"]["migration"]
    assert (mig["phase"], mig["path"]) == ("Resharding", "sharded-handoff")
    assert got[4][1]["requests"]["job"]["status"]["migration"]["phase"] == \
        "Resumed"
    assert got[-1][1]["requests"]["job"]["status"]["migration"][
        "reason"] == "resize deadline exceeded; binding kept"


@pytest.mark.parametrize("change, fires", [
    ({"labels": {L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}}, True),
    ({"labels": {L.GPU_TOPOLOGY: "nvswitch-8"}}, True),
    ({"labels": {L.GKE_NODEPOOL: "other"}}, True),
    ({"annotations": {L.PLACED_BY: "ns/x"}}, True),
    ({"labels": {"example.com/unrelated": "1"}}, False),
])
def test_node_watch_fires_on_the_pool_facets(change, fires):
    [node] = F.node_objects(False, singles=1, slices=())
    new = thaw_obj(node)
    for k, v in change.items():
        new["metadata"].setdefault(k, {}).update(v)
    assert pc._node_placement_changed(WatchEvent("MODIFIED", new),
                                      node) is fires
    # the reference's facet, on its own node under the same kind of edit
    [rnode] = F.node_objects(True, singles=1, slices=())
    rnew = thaw_obj(rnode)
    rchange = {"labels": {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice"}} \
        if fires else {"labels": {"example.com/unrelated": "1"}}
    for k, v in rchange.items():
        rnew["metadata"].setdefault(k, {}).update(v)
    assert rpc._node_placement_changed(RWatchEvent("MODIFIED", rnew),
                                       rnode) is fires


def test_requeue_replay_and_backoff_agree():
    reqs = [{"metadata": {"name": f"r{i}", "namespace": "ns"},
             "status": {"phase": "Unschedulable", "requeueAttempts": i}}
            for i in range(4)]
    rec = pc.PlacementReconciler(client=FakeClient(), namespace="default")
    rrec = rpc.PlacementReconciler(client=RFake(), namespace="default")
    assert rec.seed_requeue_state(reqs) == rrec.seed_requeue_state(reqs)
    assert rec._unsched_attempts == rrec._unsched_attempts
    for attempt in range(6):
        assert pc.unschedulable_backoff("ns/r", attempt) == \
            rpc.unschedulable_backoff("ns/r", attempt)
    assert pc.PlacementReconciler.name == N.name(
        rpc.PlacementReconciler.name) == "sliceplacement"


def test_fleet_gauges_follow_the_rule():
    from tpu_operator_torch.metrics.registry import render_prometheus

    s = Side(False)
    s.create("job", chips=8)
    s.reconcile("job")
    text = render_prometheus()
    assert 'gpu_operator_fleet_chips{accelerator="gb200",state="placed"}' \
        in text
    assert N.metric("tpu_operator_placement_decisions_total") in text

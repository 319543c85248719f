"""The port's fair-share admission (``scheduling/quota.py``) against the
JAX package's: the quota tree's water-filled shares, class resolution,
the priority/age baseline, the batch orders of the three policies, the
deficit clocks and preemption budgets, config loading from the GPUQuota
CRD or the gpu-operator-quota ConfigMap (the reference's TPUQuota and
tpu-operator-quota), the quota report, and the controller's starvation
rescue (budgeted elastic preemption) and ``/debug/quota`` — each equal
in both packages on seeded inputs or fleets mapped one to one
(``torch_placement_fleets``)."""

import json

import numpy as np
import pytest

import torch_naming as N
import torch_placement_fleets as F
from tpu_operator.api import labels as RL
from tpu_operator.api import slicerequest as rsr
from tpu_operator.controllers import placement_controller as rpc
from tpu_operator.controllers import slices as rslices
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime.manager import Manager as RManager
from tpu_operator.scheduling import quota as rq
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api import slicerequest as sr
from tpu_operator_torch.controllers import placement_controller as pc
from tpu_operator_torch.controllers import slices
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Manager, Request
from tpu_operator_torch.runtime.objects import get_nested
from tpu_operator_torch.scheduling import quota as q


def random_rows(rng):
    names = ["a", "b", "c", "d", "e"]
    rows = []
    for i, name in enumerate(names[:int(rng.integers(2, 6))]):
        row = {"name": name, "weight": float(rng.integers(0, 5))}
        if i >= 2 and rng.random() < 0.5:
            row["parent"] = names[int(rng.integers(0, 2))]
        if rng.random() < 0.4:
            row["minChips"] = int(rng.integers(0, 40))
        if rng.random() < 0.4:
            row["maxChips"] = int(rng.integers(0, 60))
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_shares_agree(seed):
    rng = np.random.default_rng(seed)
    rows = random_rows(rng)
    tree, rtree = (q.QuotaTree.from_config({"classes": rows}),
                   rq.QuotaTree.from_config({"classes": rows}))
    assert tree.leaf_names() == rtree.leaf_names()
    for _ in range(10):
        demand = {n: int(rng.integers(0, 80)) for n in tree.leaf_names()}
        capacity = int(rng.integers(0, 200))
        assert tree.shares(capacity, demand) == rtree.shares(capacity,
                                                             demand)


def request(mod, labels, name, cls=None, chips=4, priority=0, ns="default",
            stamp=None):
    cr = mod.new_slice_request(name, {"chips": chips, "priority": priority},
                               namespace=ns)
    if cls is not None:
        cr["metadata"]["annotations"] = {labels.QUOTA_CLASS: cls}
    if stamp is not None:
        cr["metadata"]["creationTimestamp"] = stamp
    return cr


def test_class_of_and_the_baseline_order_agree():
    rows = [{"name": "prod"}, {"name": "team-x"}]
    tree, rtree = (q.QuotaTree.from_config({"classes": rows}),
                   rq.QuotaTree.from_config({"classes": rows}))
    cases = [("prod", "default"), (None, "team-x"), ("nope", "nowhere"),
             (None, "default")]
    for cls, ns in cases:
        assert tree.class_of(request(sr, L, "r", cls, ns=ns)) == \
            rtree.class_of(request(rsr, RL, "r", cls, ns=ns))
    stamps = ["2024-01-01T00:00:01.5Z", "2024-01-01T00:00:01+00:00",
              "garbage", "", "2024-01-01T00:00:01.25Z"]
    for stamp in stamps:
        cr = request(sr, L, "r", stamp=stamp)
        assert q.created_epoch(cr) == rq.created_epoch(cr)
        spec = sr.SliceRequestSpec.from_obj(cr)
        assert q.baseline_key("ns/r", cr, spec) == rq.baseline_key(
            "ns/r", cr, spec)
    with pytest.raises(ValueError, match="cycle"):
        q.QuotaTree.from_config({"classes": [{"name": "a", "parent": "b"},
                                             {"name": "b", "parent": "a"}]})


@pytest.mark.parametrize("policy", list(q.POLICIES))
def test_order_batch_agrees(policy):
    rng = np.random.default_rng(len(policy))
    rows = [{"name": "prod", "weight": 6}, {"name": "batch", "weight": 3},
            {"name": "research", "weight": 1}]
    tree, rtree = (q.QuotaTree.from_config({"classes": rows}),
                   rq.QuotaTree.from_config({"classes": rows}))
    items, ritems = [], []
    for i in range(30):
        cls = ["prod", "batch", "research"][int(rng.integers(0, 3))]
        chips = int(rng.choice([4, 8, 16]))
        prio = int(rng.integers(0, 3))
        stamp = f"2024-01-01T00:00:{i:02d}Z"
        cr = request(sr, L, f"r{i:02d}", cls, chips, prio, stamp=stamp)
        rcr = request(rsr, RL, f"r{i:02d}", cls, chips, prio, stamp=stamp)
        items.append((f"default/r{i:02d}", cr, None,
                      sr.SliceRequestSpec.from_obj(cr)))
        ritems.append((f"default/r{i:02d}", rcr, None,
                       rsr.SliceRequestSpec.from_obj(rcr)))
    usage = {"prod": 8, "batch": 40}
    tflops = {"prod": 8 * 989.0, "batch": 40 * 989.0}
    got = q.order_batch(items, policy, tree, usage=usage,
                        usage_tflops=tflops, dominant_tflops=989.0)
    want = rq.order_batch(ritems, policy, rtree, usage=usage,
                          usage_tflops=tflops, dominant_tflops=989.0)
    assert [k for k, *_ in got] == [k for k, *_ in want]
    if policy == q.POLICY_BASELINE:
        assert [k for k, *_ in got] == [k for k, *_ in items]


def test_admission_state_agrees_and_round_trips():
    rows = [{"name": "prod", "minChips": 16, "preemptTokens": 2,
             "preemptWindowSeconds": 30},
            {"name": "batch", "preemptTokens": 1}]
    tree, rtree = (q.QuotaTree.from_config({"classes": rows}),
                   rq.QuotaTree.from_config({"classes": rows}))
    st, rst = q.AdmissionState(), rq.AdmissionState()
    trace, rtrace = [], []
    for t, (use, queued) in enumerate([(0, 8), (4, 8), (16, 0), (0, 4),
                                       (2, 30)]):
        now = 100.0 + 10 * t
        trace.append(st.observe(tree, {"prod": use}, {"prod": queued}, now))
        rtrace.append(rst.observe(rtree, {"prod": use}, {"prod": queued},
                                  now))
        trace.append(st.take_token(tree.get("prod"), now))
        rtrace.append(rst.take_token(rtree.get("prod"), now))
    assert trace == rtrace and st.to_dict() == rst.to_dict()
    assert q.AdmissionState.from_dict(json.loads(json.dumps(
        st.to_dict()))).to_dict() == st.to_dict()
    assert q.AdmissionState.from_dict({"tokens": {"x": "bad"}}).tokens == {}


def test_config_loads_from_the_renamed_crd_and_configmap():
    assert (q.KIND_GPU_QUOTA, q.QUOTA_CONFIGMAP, q.V1ALPHA1) == (
        N.name(rq.KIND_TPU_QUOTA), N.name(rq.QUOTA_CONFIGMAP),
        N.name(rq.V1ALPHA1))
    doc = {"classes": [{"name": "prod", "weight": 2}]}
    c = FakeClient()
    assert q.QuotaTree.load(c, "gpu-operator") is None
    c.create({"apiVersion": "v1", "kind": "ConfigMap",
              "metadata": {"name": q.QUOTA_CONFIGMAP,
                           "namespace": "gpu-operator"},
              "data": {q.QUOTA_CONFIG_KEY: json.dumps(doc)}})
    assert q.QuotaTree.load(c, "gpu-operator").leaf_names() == [
        "default", "prod"]
    c.create({"apiVersion": q.V1ALPHA1, "kind": q.KIND_GPU_QUOTA,
              "metadata": {"name": "fleet", "namespace": "gpu-operator"},
              "spec": {"classes": [{"name": "crd-wins"}]}})
    assert q.QuotaTree.load(c, "gpu-operator").leaf_names() == [
        "crd-wins", "default"]
    bad = FakeClient()
    bad.create({"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": q.QUOTA_CONFIGMAP,
                             "namespace": "gpu-operator"},
                "data": {q.QUOTA_CONFIG_KEY: "{not json"}})
    assert q.QuotaTree.load(bad, "gpu-operator") is None


def clusters(**kw):
    rc, c = RFake(), FakeClient()
    F.add_nodes(rc, True, **kw)
    F.add_nodes(c, False, **kw)
    return rc, c


def test_quota_report_agrees():
    rows = [{"name": "prod", "weight": 3, "minChips": 8,
             "starvationBoundSeconds": 60}, {"name": "batch"}]
    rc, c = clusters()
    for i, (cls, chips, placed) in enumerate([("prod", 8, True),
                                              ("batch", 4, False),
                                              ("batch", 16, False)]):
        for mod, labels, client in ((rsr, RL, rc), (sr, L, c)):
            cr = request(mod, labels, f"r{i}", cls, chips)
            if placed:
                cr["status"] = {"phase": "Placed", "chips": chips}
            client.create(cr)
    tree, rtree = (q.QuotaTree.from_config({"classes": rows}),
                   rq.QuotaTree.from_config({"classes": rows}))
    st, rst = q.AdmissionState(), rq.AdmissionState()
    for now in (100.0, 130.0):
        got = q.quota_report(c, "default", tree=tree, state=st,
                             policy="finish-time", now=lambda: now)
        want = rq.quota_report(rc, "default", tree=rtree, state=rst,
                               policy="finish-time", now=lambda: now)
        assert got == want
    assert got["capacityChips"] == 56
    assert q.quota_report(c, "default") == {
        "configured": False, "classes": [], "breached": [],
        "policy": q.ADMISSION_GATE.policy}


# --- the controller's starvation rescue ------------------------------------

RESCUE_ROWS = {
    "one-shape-matched-intent": [
        {"name": "prod", "weight": 6, "minChips": 8,
         "starvationBoundSeconds": 240},
        {"name": "batch", "weight": 1, "preemptTokens": 2}],
    "exempt-class": [
        {"name": "prod", "weight": 6, "minChips": 8,
         "starvationBoundSeconds": 240},
        {"name": "batch", "weight": 1}],
    "victim-floor": [
        {"name": "prod", "weight": 6, "minChips": 8,
         "starvationBoundSeconds": 240},
        {"name": "batch", "weight": 1, "minChips": 16, "preemptTokens": 4}],
}


def rescue(ref: bool, rows, non_elastic=False):
    """Two batch slices fill a fleet of two 2-host domains, then a prod
    request with a min-guarantee arrives: what each request ends as and
    what the rescue did."""
    mod, labels = (rsr, RL) if ref else (sr, L)
    client = RFake() if ref else FakeClient()
    F.add_nodes(client, ref, singles=0, slices=("pa", "pb"), hosts=2)
    clock = [1000.0]
    tree = (rq if ref else q).QuotaTree.from_config({"classes": rows})
    rec = (rpc if ref else pc).PlacementReconciler(
        client=client, namespace="default", quota=tree,
        admission_policy="finish-time", now=lambda: clock[0])
    escalated = []
    rec._escalate_fn = lambda req, cause=None: escalated.append(
        (str(req), getattr(cause, "reason", None)))
    for name, cls in (("batch-a", "batch"), ("batch-b", "batch"),
                      ("prod-1", "prod")):
        client.create(request(mod, labels, name, cls, chips=8))
        if non_elastic and cls == "batch":
            client.patch(mod.V1ALPHA1, mod.KIND_SLICE_REQUEST, name,
                         {"metadata": {"annotations": {
                             labels.SLICE_ELASTIC: "false"}}},
                         namespace="default")
        clock[0] += 1.0
        rec.reconcile((RRequest if ref else Request)(name=name,
                                                     namespace="default"))
    out = {}
    for name in ("batch-a", "batch-b", "prod-1"):
        cr = client.get(mod.V1ALPHA1, mod.KIND_SLICE_REQUEST, name,
                        "default")
        mig = (rslices if ref else slices).migration_of(cr)
        out[name] = (get_nested(cr, "status", "phase"),
                     get_nested(cr, "status", "nodes"),
                     get_nested(cr, "status", "reason"),
                     {k: mig.get(k) for k in ("phase", "intent",
                                              "preemptedFor", "from")})
    out["tokens"] = {n: rec._admission.remaining(tree.get(n), clock[0])
                     for n in tree.leaf_names()}
    out["escalated"] = escalated
    return out


@pytest.mark.parametrize("case", sorted(RESCUE_ROWS) + ["non-elastic"])
def test_starvation_rescue_agrees(case):
    rows = RESCUE_ROWS.get(case, RESCUE_ROWS["one-shape-matched-intent"])
    kw = {"non_elastic": case == "non-elastic"}
    got, want = rescue(False, rows, **kw), rescue(True, rows, **kw)
    for name in ("batch-a", "batch-b", "prod-1"):
        phase, nodes, reason, mig = want[name]
        want[name] = (phase, nodes, reason and F.text(reason, {}), mig)
    assert got == want
    intents = [n for n in ("batch-a", "batch-b") if got[n][3]["intent"]]
    if case == "one-shape-matched-intent":
        assert len(intents) == 1 and got["tokens"]["batch"] == 1.0
        assert got[intents[0]][3]["preemptedFor"] == "prod"
    else:
        assert intents == []
    assert ("default/prod-1", "admission-starvation") in got["escalated"]


def test_no_config_is_the_legacy_pass_byte_for_byte():
    def drive(policy):
        c = FakeClient()
        F.add_nodes(c, False, singles=2, slices=("pa", "pb"), hosts=2)
        rec = pc.PlacementReconciler(client=c, namespace="default",
                                     admission_policy=policy,
                                     now=lambda: 1000.0)
        for i, (chips, prio) in enumerate(((8, 0), (4, 2), (8, 1), (4, 0),
                                           (8, 2))):
            c.create(request(sr, L, f"r{i}", None, chips, prio,
                             stamp=f"2024-01-01T00:00:{i:02d}Z"))
        for i in range(5):
            rec.reconcile(Request(name=f"r{i}", namespace="default"))
        return json.dumps([c.get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST, f"r{i}",
                                 "default").get("status")
                           for i in range(5)], sort_keys=True)

    assert drive(None) == drive(q.POLICY_BASELINE) == drive(
        q.POLICY_FINISH_TIME)


def debug_quota(ref: bool, with_admission: bool):
    import urllib.request

    client = RFake() if ref else FakeClient()
    F.add_nodes(client, ref, singles=2, slices=())
    mgr = (RManager if ref else Manager)(client, namespace="default",
                                         health_port=0)
    if with_admission:
        rows = [{"name": "prod", "weight": 3, "minChips": 4},
                {"name": "batch", "weight": 1}]
        tree = (rq if ref else q).QuotaTree.from_config({"classes": rows})
        mgr.add_reconciler((rpc if ref else pc).PlacementReconciler(
            client=client, namespace="default", quota=tree,
            admission_policy="finish-time", now=lambda: 1000.0))
    mgr.start()
    try:
        url = f"http://127.0.0.1:{mgr._http.server_address[1]}/debug/quota"
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            return resp.status, json.loads(resp.read())
    finally:
        mgr.stop()


@pytest.mark.parametrize("with_admission", [False, True])
def test_debug_quota_agrees(with_admission):
    got = debug_quota(False, with_admission)
    assert got == debug_quota(True, with_admission)
    if with_admission:
        assert got[1]["capacityChips"] == 8
        assert "deficitSeconds" in got[1]["classes"][0]

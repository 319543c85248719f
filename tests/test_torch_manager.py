"""The port's Manager against the JAX package's: each package's manager,
with its ClusterPolicy controller over its own FakeClient behind the
informer cache and the tracing client, drives its policy to ``ready`` by
watch events alone (no ``reconcile()`` call): the same state sequence,
the same DaemonSets and node labels through ``torch_naming``'s name map,
the same ``state:<name>`` spans in the ready reconcile, and a steady pass
that writes nothing. Leader election over both FakeClients under one
stepped clock makes the same Lease transitions, and the health server's
``/debug/*`` bodies agree through the name map."""

import datetime
import json
import time
import types
import urllib.error
import urllib.request

import pytest

import torch_naming as N
from tpu_operator.api import labels as RL
from tpu_operator.api.clusterpolicy import KIND_CLUSTER_POLICY as RKIND
from tpu_operator.api.clusterpolicy import V1 as RV1
from tpu_operator.api.clusterpolicy import new_cluster_policy as rnew
from tpu_operator.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler as RReconciler)
from tpu_operator.runtime import CachedClient as RCached
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Manager as RManager
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime import TracingClient as RTracing
from tpu_operator.runtime import leaderelection as rle
from tpu_operator.runtime import timeline as rtl
from tpu_operator.runtime import tracing as rtr
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.clusterpolicy import (KIND_CLUSTER_POLICY, V1,
                                                  new_cluster_policy)
from tpu_operator_torch.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler)
from tpu_operator_torch.runtime import (CachedClient, FakeClient, Manager,
                                        Request, TracingClient)
from tpu_operator_torch.runtime import leaderelection as le
from tpu_operator_torch.runtime import timeline as tl
from tpu_operator_torch.runtime import tracing as tr

from conftest import load_factor

WRITES = ("create", "update", "update_status", "patch", "delete")
REF_NODE = {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
            RL.GKE_TPU_TOPOLOGY: "2x2x1", RL.GKE_ACCELERATOR_COUNT: "4"}
PORT_NODE = {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
             L.GKE_ACCELERATOR_COUNT: "4"}


def wait_until(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout * load_factor()
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class Side:
    """One package's cluster, cached and traced client, and manager."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.fake = RFake() if ref else FakeClient()
        self.v1, self.kind = (RV1, RKIND) if ref else (V1, KIND_CLUSTER_POLICY)
        self.policy = "tpu-cluster-policy" if ref else "gpu-cluster-policy"
        self.ns = "tpu-operator" if ref else "gpu-operator"
        self.tracer, self.timeline = (rtr.TRACER, rtl.TIMELINE) if ref \
            else (tr.TRACER, tl.TIMELINE)
        self.fake.add_node("accel-0", labels=REF_NODE if ref else PORT_NODE,
                           allocatable={("google.com/tpu" if ref
                                         else L.GPU_RESOURCE): "4"})
        self.fake.add_node("cpu-0")
        self.fake.create(rnew() if ref else new_cluster_policy())
        cached = (RCached if ref else CachedClient)(self.fake)
        self.api = (RTracing if ref else TracingClient)(cached)
        self.mgr = (RManager if ref else Manager)(
            self.api, namespace=self.ns, health_port=0, leader_elect=True,
            snapshot_dir="")
        rec = (RReconciler if ref else ClusterPolicyReconciler)(
            client=self.api, namespace=self.ns)
        self.ctrl = self.mgr.add_reconciler(rec, workers=2)
        # every write the apiserver side takes, by verb and kind
        self.writes = []
        for verb in WRITES:
            setattr(self.fake, verb, self._recorded(verb))

    def _recorded(self, verb):
        inner = getattr(self.fake, verb)

        def write(*args, **kw):
            obj = args[0] if verb in ("create", "update", "update_status") \
                else {"kind": args[1]}
            self.writes.append((verb, obj.get("kind")))
            return inner(*args, **kw)
        return write

    def state(self):
        cr = self.fake.get(self.v1, self.kind, self.policy)
        return (cr.get("status") or {}).get("state")

    def get(self, path: str):
        port = self.mgr._http.server_address[1]
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


@pytest.fixture(scope="module")
def sides():
    from tpu_operator.metrics.fleet import FLEET_TELEMETRY as RFLEET
    from tpu_operator_torch.metrics.fleet import FLEET_TELEMETRY

    for t, tlm in ((rtr.TRACER, rtl.TIMELINE), (tr.TRACER, tl.TIMELINE)):
        t.reset(enabled=True)
        tlm.reset(enabled=True)
    # the process-wide folds may hold an earlier test's nodes
    RFLEET.reset()
    FLEET_TELEMETRY.reset()
    pair = [Side(True), Side(False)]
    for s in pair:
        s.mgr.start()
    try:
        for s in pair:
            wait_until(lambda: s.state() == "notReady",
                       f"{s.policy} notReady")
            s.fake.simulate_kubelet(ready=True)
        for s in pair:
            wait_until(lambda: s.state() == "ready", f"{s.policy} ready")
            assert s.mgr.wait_idle(timeout=20.0 * load_factor(),
                                   horizon=0.5)
        yield pair
    finally:
        for s in pair:
            s.mgr.stop()


def test_state_sequence_agrees(sides):
    seqs = []
    for s in sides:
        events = s.timeline.timeline(s.kind, s.policy)
        seqs.append([(e["detail"]["from"], e["detail"]["to"])
                     for e in events if e["event"] == "state"])
        kinds = {e["event"] for e in events}
        assert {"enqueue", "reconcile", "state"} <= kinds
    assert seqs[0] == seqs[1] == [("new", "notReady"), ("notReady", "ready")]


def test_objects_agree_through_the_name_map(sides):
    ref, port = sides
    rds = sorted(N.name(d["metadata"]["name"])
                 for d in ref.fake.list("apps/v1", "DaemonSet"))
    pds = sorted(d["metadata"]["name"]
                 for d in port.fake.list("apps/v1", "DaemonSet"))
    assert rds == pds and len(pds) > 5
    rlab = {N.name(k): N.name(v) for k, v in ref.fake.get(
        "v1", "Node", "accel-0")["metadata"]["labels"].items()
        if k.startswith("tpu.graft.dev/")}
    plab = {k: v for k, v in port.fake.get(
        "v1", "Node", "accel-0")["metadata"]["labels"].items()
        if k.startswith("gpu.graft.dev/")}
    rlab[L.GPU_GENERATION] = "h100-sxm"  # v5p <-> h100-sxm
    assert rlab == plab
    for s in sides:  # the CPU node is left alone
        labels = s.fake.get("v1", "Node", "cpu-0")["metadata"].get(
            "labels") or {}
        assert not any(k.endswith(".graft.dev/present") for k in labels)


def ready_trace(s):
    """The reconcile that moved the policy to ready: the oldest trace
    whose every state span says ready or disabled."""
    for t in reversed(s.tracer.traces(controller=s.ctrl.name)):
        spans = {c["name"]: c.get("tags", {}).get("status")
                 for c in t["root"].get("children", [])
                 if c["name"].startswith("state:")}
        if spans and set(spans.values()) <= {"ready", "disabled"}:
            return t, spans
    raise AssertionError("no ready reconcile traced")


def test_ready_reconcile_spans_agree(sides):
    (rt, rspans), (pt, pspans) = (ready_trace(s) for s in sides)
    mapped = {"state:" + N.STATES.get(k[6:], k[6:]): v
              for k, v in rspans.items()}
    assert mapped == pspans and len(pspans) == 15
    for t in (rt, pt):
        reasons = {c["reason"] for c in t.get("causes", [])}
        assert reasons & {"watch:MODIFIED", "requeue-after"}, t["causes"]
        assert t["queue_wait_s"] is not None and t["outcome"] == "ok"
    # every client verb of the port's ready pass read the cache
    verbs = [c for sp in pt["root"]["children"]
             for c in sp.get("children", []) if c["name"] == "client:get"]
    assert verbs and {c["tags"]["source"] for c in verbs} == {"cache"}


def test_steady_pass_writes_nothing(sides):
    out = []
    for s in sides:
        before = s.ctrl.reconcile_total
        s.fake.reset_verb_counts()
        del s.writes[:]
        s.ctrl.enqueue((RRequest if s.ref else Request)(name=s.policy))
        wait_until(lambda: s.ctrl.reconcile_total > before, "a steady pass")
        assert s.mgr.wait_idle(timeout=20.0 * load_factor(), horizon=0.5)
        verbs = s.fake.reset_verb_counts()
        # the elector renews its Lease every 5 s; nothing else is written
        out.append([w for w in s.writes if w != ("update", "Lease")])
        out.append({v: n for v, n in verbs.items() if v in ("get", "list")})
        assert s.state() == "ready"
    assert out == [[], {}, [], {}]


def test_metrics_count_every_reconcile(sides):
    _, port = sides
    code, body = port.get("/metrics")
    assert code == 200
    text = body.decode()
    line = next(ln for ln in text.splitlines() if ln.startswith(
        'gpu_operator_reconcile_duration_seconds_count{controller='
        '"gpuclusterpolicy"}'))
    assert float(line.split()[-1]) >= port.ctrl.reconcile_total > 0


def test_debug_bodies_agree(sides):
    ref, port = sides
    for path in ("/healthz", "/readyz", "/debug/quota", "/debug/cells"):
        assert port.get(path) == ref.get(path)
        assert port.get(path)[0] == 200
    bodies = []
    for s in sides:
        code, cache = s.get("/debug/cache")
        cache = json.loads(cache)
        assert code == 200 and cache["cached"] and cache["cache_reads"] > 0
        code, snapshot = s.get("/debug/snapshot")
        assert code == 200
        code, timeline = s.get(f"/debug/timeline?kind={s.kind}&name="
                               f"{s.policy}")
        timeline = json.loads(timeline)
        code, slo = s.get("/debug/slo?window=60")
        slo = json.loads(slo)
        code, traces = s.get(f"/debug/traces?controller={s.ctrl.name}"
                             "&limit=2")
        traces = json.loads(traces)
        assert code == 200 and traces["count"] == 2
        bodies.append({
            "kinds": {k: v["objects"] for k, v in cache["kinds"].items()},
            "snapshot": json.loads(snapshot),
            "timeline": [(e["event"], e.get("detail", {}).get("to"))
                         for e in timeline["events"] if e["event"] == "state"],
            "slo": [(x["name"], sorted(x["windows"])) for x in slo["slos"]],
            "bad": [s.get(p)[0] for p in ("/debug/timeline?kind=&name=x",
                                          "/debug/traces?min_ms=x",
                                          "/debug/slo?window=-1", "/nope")],
        })
    rb, pb = bodies
    rb["kinds"] = {"/".join(N.name(p) for p in k.rpartition("/")[::2]): v
                   for k, v in rb["kinds"].items()}
    for b in (rb, pb):  # the snapshot plane is off in both
        assert b["snapshot"]["enabled"] is False
    assert pb == rb
    assert ("state", "ready") in pb["timeline"]
    assert pb["bad"] == [400, 400, 400, 404]
    # both managers attach the fleet fold at start
    (code, fleet), (rcode, rfleet) = (s.get("/debug/fleet") for s in (port,
                                                                      ref))
    assert code == rcode == 200
    assert json.loads(fleet)["totals"] == json.loads(rfleet)["totals"]


def test_node_watch_labels_through_the_name_map():
    """The policy's Node watch fires on the port's counterparts of the
    reference's labels (torch_naming.NODE_WATCH), and on GKE's card
    count besides."""
    import inspect

    from tpu_operator.controllers import clusterpolicy_controller as rcp
    from tpu_operator_torch.controllers import clusterpolicy_controller as cp

    ref_src = inspect.getsource(rcp.ClusterPolicyReconciler.setup_controller)
    src = inspect.getsource(cp.ClusterPolicyReconciler.setup_controller)
    for ref_key, key in N.NODE_WATCH.items():
        rname = next(n for n in dir(RL) if getattr(RL, n) == ref_key)
        pname = next(n for n in dir(L) if getattr(L, n) == key)
        assert f"L.{rname}" in ref_src and f"L.{pname}" in src
    for key in N.NODE_WATCH_ADDED:
        pname = next(n for n in dir(L) if getattr(L, n) == key)
        assert f"L.{pname}" in src
    assert N.name(RReconciler.name) == ClusterPolicyReconciler.name


def test_lease_held(sides):
    for s in sides:
        lease = s.fake.get("coordination.k8s.io/v1", "Lease", s.ns, s.ns)
        assert lease["spec"]["holderIdentity"] == s.mgr.elector.identity
        assert s.mgr.elector.is_leader
    assert sides[1].ns == "gpu-operator"


class _SteppedDateTime(datetime.datetime):
    offset = 0.0

    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc) \
            + datetime.timedelta(seconds=cls.offset)


def lease_transitions(mod, fake_cls, monkeypatch) -> list:
    clock = type("Clock", (_SteppedDateTime,), {"offset": 0.0})
    monkeypatch.setattr(mod, "datetime", types.SimpleNamespace(
        datetime=clock, timezone=datetime.timezone))
    c = fake_cls()
    a = mod.LeaderElector(c, identity="a", lease_duration_s=15.0)
    b = mod.LeaderElector(c, identity="b", lease_duration_s=15.0)
    out = []

    def step(who, elector, advance=0.0):
        clock.offset += advance
        held = elector.try_acquire_or_renew()
        lease = c.get_or_none("coordination.k8s.io/v1", "Lease",
                              a.name, a.namespace)
        spec = (lease or {}).get("spec") or {}
        out.append((who, held, spec.get("holderIdentity"),
                    spec.get("renewTime"), spec.get("acquireTime"),
                    spec.get("leaseDurationSeconds")))

    step("a", a)            # create
    step("b", b)            # held by a
    step("a", a, 10.0)      # renew
    step("b", b, 10.0)      # 10 s since a's renew: still held
    step("b", b, 20.0)      # expired: b takes over
    step("a", a)            # a has lost it
    b.is_leader = True
    b.stop(release=True)    # release deletes the lease
    step("a", a, 1.0)       # a creates it again
    return out


def test_leader_election_agrees_under_a_stepped_clock(monkeypatch):
    ref = lease_transitions(rle, RFake, monkeypatch)
    port = lease_transitions(le, FakeClient, monkeypatch)
    assert port == ref
    assert [(w, h, who) for w, h, who, *_ in port] == [
        ("a", True, "a"), ("b", False, "a"), ("a", True, "a"),
        ("b", False, "a"), ("b", True, "b"), ("a", False, "b"),
        ("a", True, "a")]
    assert le.LeaderElector(FakeClient()).name == "gpu-operator"


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_restart_restores_with_a_controller_registered(ref, tmp_path):
    """C4: a manager wired as the operator's CLI wires it (controllers
    registered before start) restores its snapshot in the port; the
    reference's registers the watches in add_reconciler, its cache then
    refuses the seed, and the restart starts cold."""
    outcomes, writes = [], []
    fake = RFake() if ref else FakeClient()
    fake.add_node("accel-0", labels=REF_NODE if ref else PORT_NODE,
                  allocatable={("google.com/tpu" if ref
                                else L.GPU_RESOURCE): "4"})
    fake.create(rnew() if ref else new_cluster_policy())
    for _ in range(2):
        api = (RTracing if ref else TracingClient)(
            (RCached if ref else CachedClient)(fake))
        mgr = (RManager if ref else Manager)(api, snapshot_dir=str(tmp_path))
        ctrl = mgr.add_reconciler((RReconciler if ref else
                                   ClusterPolicyReconciler)(client=api))
        mgr.start()
        try:
            wait_until(lambda: ctrl.reconcile_total >= 1, "a reconcile")
            assert mgr.wait_idle(timeout=20.0 * load_factor(), horizon=0.5)
            fake.simulate_kubelet(ready=True)
            outcomes.append(mgr.last_restore["outcome"])
        finally:
            mgr.stop()
        writes.append(fake.reset_verb_counts())
    assert outcomes == (["missing", "failed"] if ref
                        else ["missing", "restored"])
    # the restored informers resume their watches from the snapshot
    assert ref or writes[1].get("watch", 0) > 0

"""Fleet telemetry in the port (``metrics/fleet.py``,
``controllers/telemetry_controller.py``, the Manager's fold and
``/debug/fleet``) against the JAX package's.

The same seeded digest streams go through both packages' folds, on
fleets mapped one to one (a GKE TPU v5e host of 4 chips <-> a GKE H100
host of 4 cards, the same nodepool); the condemned and absolved sets
must be equal after every event, and the rollups equal under the
domain and generation maps below. The goodput formulas are held with
the same bar injected on both sides (the bars' tables differ by
generation, ROADMAP.md "Declared differences"). Equality throughout:
no figure here is timing.
"""

import json
import random
import urllib.request

import pytest
from prometheus_client import CollectorRegistry

import torch_naming as N
from tpu_operator.api import labels as RL
from tpu_operator.metrics import fleet as rfleet
from tpu_operator.metrics import health_engine as rhe
from tpu_operator.metrics.operator_metrics import OperatorMetrics as ROM
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.metrics import fleet
from tpu_operator_torch.metrics import health_engine as he
from tpu_operator_torch.metrics.operator_metrics import OperatorMetrics

# (reference accelerator, topology) <-> (GKE accelerator, product, topology)
FLEET = {
    ("tpu-v5e-slice", "2x4"):
        ("nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3", "nvswitch-4"),
    ("tpu-v4-podslice", "2x2x1"):
        ("nvidia-a100-80gb", "NVIDIA-A100-SXM4-80GB", "nvswitch-4"),
    ("tpu-v5p-slice", "4x4x4"):
        ("nvidia-gb200", "NVIDIA-GB200", "mnnvl-4"),
}
# the rollup's keys a pool without a nodepool groups under, and the
# generation each carries
DOMAINS = {"v5e-2x4": "h100-sxm-nvswitch-4", "v4-2x2x1": "a100-sxm-nvswitch-4",
           "v5p-4x4x4": "gb200-mnnvl-4"}
GENERATIONS = {"v5e": "h100-sxm", "v4": "a100-sxm", "v5p": "gb200"}


def digest(status, seq, chips=4, **over):
    d = {"v": 1, "status": status,
         "grades": {f"c{i}": ("fail" if status == "fail" and i == 0 else
                              "warn" if status == "warn" and i == 1 else "ok")
                    for i in range(chips)},
         "duty_pct": 40.0 + seq % 7, "hbm_free_frac": 0.3 + (seq % 5) / 100,
         "temp_max_c": 50.0 + seq % 11, "gen": "g", "seq": seq}
    d.update(over)
    return d


def nodes(name, pool_key=("tpu-v5e-slice", "2x4"), dig=None, nodepool="pool-a",
          condition=None):
    """One node in both packages' terms: (reference, port)."""
    accel, topo = pool_key
    gaccel, product, gtopo = FLEET[pool_key]
    ref = {"metadata": {"name": name, "labels": {
        RL.GKE_TPU_ACCELERATOR: accel, RL.GKE_TPU_TOPOLOGY: topo,
        RL.GKE_ACCELERATOR_COUNT: "4"}, "annotations": {}}}
    port = {"metadata": {"name": name, "labels": {
        L.GKE_ACCELERATOR: gaccel, L.GPU_PRODUCT: product,
        L.GPU_TOPOLOGY: gtopo, L.GKE_ACCELERATOR_COUNT: "4"},
        "annotations": {}}}
    for obj, lab, key in ((ref, RL, RL.HEALTH_DIGEST), (port, L,
                                                         L.HEALTH_DIGEST)):
        if nodepool:
            obj["metadata"]["labels"][lab.GKE_NODEPOOL] = nodepool
        if dig is not None:
            obj["metadata"]["annotations"][key] = he.digest_annotation(dig)
        if condition is not None:
            obj["status"] = {"conditions": [
                {"type": lab.TELEMETRY_CONDITION, "status": condition}]}
    return ref, port


def folds():
    clock = [0.0]
    ref = rfleet.FleetTelemetry(metrics=ROM(registry=CollectorRegistry()),
                                now=lambda: clock[0])
    port = fleet.FleetTelemetry(
        metrics=OperatorMetrics(registry=CollectorRegistry()),
        now=lambda: clock[0])
    return ref, port, clock


def test_constants_and_the_bar_table():
    for name in ("CONDEMN_AFTER", "ABSOLVE_AFTER", "GOODPUT_DEGRADED_RATIO",
                 "DEFAULT_IDEAL_STEPS_PER_S", "EXPORT_MIN_INTERVAL_S",
                 "ROLLUP_SCHEMA_VERSION"):
        assert getattr(fleet, name) == getattr(rfleet, name), name
    # the reference's rule: every bar <= 0.15, keyed by the port's
    # generations as build_cluster's mix maps the reference's
    assert fleet.IDEAL_STEPS_PER_S == {"a100-sxm": 0.10, "h100-sxm": 0.15,
                                       "gb200": 0.15}
    for ref_gen, gen in GENERATIONS.items():
        if ref_gen != "v5e":  # v5e's 0.12 becomes an H100 pool's 0.15
            assert fleet.ideal_steps_per_s(gen) == \
                rfleet.ideal_steps_per_s(ref_gen)
    assert max(fleet.IDEAL_STEPS_PER_S.values()) <= 0.15
    assert fleet.ideal_steps_per_s("unknown") == 0.15
    assert L.TELEMETRY_CONDITION == N.PLACEMENT[RL.TELEMETRY_CONDITION]


STREAMS = {
    "fail-x2": ["fail", "fail"],
    "fail-x3": ["fail", "fail", "fail"],
    "fail-x3-then-ok-x2": ["fail"] * 3 + ["ok"] * 2,
    "fail-x3-then-ok-warn-ok": ["fail"] * 3 + ["ok", "warn", "ok"],
    "flap": ["fail", "fail", "ok"] * 4,
    "warn-resets": ["fail", "fail", "warn", "fail", "fail", "warn", "fail"],
    "ok-only": ["ok"] * 5,
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_scripted_streams_condemn_and_absolve_alike(stream):
    ref, port, _ = folds()
    for seq, status in enumerate(STREAMS[stream], 1):
        r, p = nodes("n0", dig=digest(status, seq))
        ref.on_node_delta("MODIFIED", r)
        port.on_node_delta("MODIFIED", p)
        # a watch echo of the same publish: no second streak step
        ref.on_node_delta("MODIFIED", r)
        port.on_node_delta("MODIFIED", p)
        assert port.condemned() == ref.condemned()
        assert port.fail_streak("n0") == ref.fail_streak("n0")
    want = {"fail-x2": [], "fail-x3": ["n0"], "fail-x3-then-ok-x2": [],
            "fail-x3-then-ok-warn-ok": ["n0"], "flap": [],
            "warn-resets": [], "ok-only": []}[stream]
    assert port.condemned() == want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_streams_with_echoes_fold_alike(seed):
    """Eight nodes over three pools, 400 events: publishes drawn from
    ok/warn/fail, re-sent echoes of a node's last publish (a seq not
    advanced), stale seqs, deletes and malformed annotations."""
    rng = random.Random(seed)
    ref, port, clock = folds()
    pools = sorted(FLEET)
    last = {}
    seqs = {}
    for _ in range(400):
        clock[0] += rng.random()
        i = rng.randrange(8)
        name = f"n{i}"
        pk = pools[i % len(pools)]
        roll = rng.random()
        if roll < 0.05:
            ev = ("DELETED", *nodes(name, pk, nodepool=""))
            last.pop(name, None)
        elif roll < 0.25 and name in last:
            ev = ("MODIFIED", *last[name])           # echo
        elif roll < 0.30:
            r, p = nodes(name, pk)
            r["metadata"]["annotations"][RL.HEALTH_DIGEST] = "{not json"
            p["metadata"]["annotations"][L.HEALTH_DIGEST] = "{not json"
            ev = ("MODIFIED", r, p)
        else:
            seqs[name] = seqs.get(name, 0) + 1
            status = rng.choice(["fail", "fail", "ok", "ok", "warn"])
            pair = nodes(name, pk, dig=digest(status, seqs[name]),
                         nodepool="" if i % 2 else f"pool-{i % 3}")
            last[name] = pair
            ev = ("MODIFIED", *pair)
        kind, r, p = ev
        ref.on_node_delta(kind, r)
        port.on_node_delta(kind, p)
        assert port.condemned() == ref.condemned()
    assert [port.fail_streak(f"n{i}") for i in range(8)] == \
        [ref.fail_streak(f"n{i}") for i in range(8)]
    rs, ps = ref.snapshot(), port.snapshot()
    assert ps["scorer"] == rs["scorer"]
    assert ps["totals"] == rs["totals"]


def _map_rollup(roll):
    """A reference rollup in the port's domain and generation keys."""
    out = json.loads(json.dumps(roll))
    out["domains"] = {DOMAINS.get(d, d): dict(e, generation=GENERATIONS.get(
        e["generation"], e["generation"])) for d, e in roll["domains"].items()}
    out["domains"] = {d: out["domains"][d] for d in sorted(out["domains"])}
    out["worst_domain"] = DOMAINS.get(roll["worst_domain"],
                                      roll["worst_domain"])
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_rollup_nodes_totals_and_domains_agree(seed):
    rng = random.Random(seed)
    ref_nodes, port_nodes, condemned = [], [], set()
    pools = sorted(FLEET)
    for i in range(30):
        status = rng.choice(["ok", "warn", "fail", None])
        cond = rng.choice([None, "True", "False"])
        r, p = nodes(f"n{i:02d}", pools[i % 3],
                     dig=digest(status, i) if status else None,
                     nodepool="" if i % 4 else f"pool-{i % 2}",
                     condition=cond)
        ref_nodes.append(r)
        port_nodes.append(p)
        if rng.random() < 0.2:
            condemned.add(f"n{i:02d}")
    # a CPU node counts on neither side
    ref_nodes.append({"metadata": {"name": "cpu-0"}})
    port_nodes.append({"metadata": {"name": "cpu-0"}})
    for kw in ({}, {"condemned": condemned}):
        ref = rfleet.rollup_nodes(ref_nodes, **kw)
        port = fleet.rollup_nodes(port_nodes, **kw)
        assert port == _map_rollup(ref)
        assert port["totals"]["nodes"] == 30
    # a node without GKE's count reads nvidia.com/gpu allocatable
    bare = {"metadata": {"name": "b"},
            "status": {"allocatable": {L.GPU_RESOURCE: "8"}}}
    assert fleet.rollup_nodes([bare])["totals"]["chips"] == 8
    assert fleet.domain_of(bare) == "gpu-any"


def test_goodput_formulas_with_one_bar(monkeypatch):
    monkeypatch.setattr(rfleet, "ideal_steps_per_s", lambda gen: 0.12)
    monkeypatch.setattr(fleet, "ideal_steps_per_s", lambda gen: 0.12)
    ref, port, clock = folds()
    rng = random.Random(7)
    acked = [0.0] * 6
    for _ in range(15):
        clock[0] += 20.0 + rng.random()
        for i in range(6):
            acked[i] += rng.choice([0.01, 0.05, 0.12, 0.2]) * 20.0
            for side, pool in ((ref, "v5p-4x4x4"),
                               (port, "nvidia-gb200-mnnvl-4")):
                side.on_request_delta("MODIFIED", {
                    "metadata": {"name": f"s{i}", "namespace": "ns"},
                    "status": {"pool": pool, "progress": {
                        "checkpointedStep": int(acked[i])}}})
    rs, ps = ref.snapshot(), port.snapshot()
    assert [(k, v["acked_steps"], v["goodput_ratio"])
            for k, v in ps["slices"].items()] == \
        [(k, v["acked_steps"], v["goodput_ratio"])
         for k, v in rs["slices"].items()]
    assert ps["worst_slices"] == rs["worst_slices"]
    assert {v["generation"] for v in ps["slices"].values()} == {"gb200"}
    assert {v["generation"] for v in rs["slices"].values()} == {"v5p"}


def test_goodput_reads_the_pool_generation_through_the_table():
    _, port, clock = folds()
    for t, step in ((0.0, 0), (100.0, 10)):
        clock[0] = t
        port.on_request_delta("MODIFIED", {
            "metadata": {"name": "a", "namespace": "ns"},
            "status": {"pool": "nvidia-a100-sxm4-80gb-nvswitch-8",
                       "migration": {"ackedStep": step}}})
    got = port.snapshot()["slices"]["ns/a"]
    assert got["generation"] == "a100-sxm"
    assert got["goodput_ratio"] == round((10 / 100.0) / 0.10, 4)


def _telemetry_sides():
    from tpu_operator.controllers.telemetry_controller import (
        TelemetryReconciler as RRec,
    )
    from tpu_operator.runtime import FakeClient as RFake
    from tpu_operator.runtime import Request as RReq
    from tpu_operator_torch.controllers.telemetry_controller import (
        TelemetryReconciler,
    )
    from tpu_operator_torch.runtime import FakeClient, Request

    ref_c, port_c = RFake(), FakeClient()
    ref_c.add_node("n0", labels={RL.GKE_TPU_ACCELERATOR: "tpu-v5e-slice",
                                 RL.GKE_TPU_TOPOLOGY: "2x4"},
                   allocatable={"google.com/tpu": "4"})
    port_c.add_node("n0", labels={L.GKE_ACCELERATOR: "nvidia-h100-80gb",
                                  L.GPU_TOPOLOGY: "nvswitch-4"},
                    allocatable={L.GPU_RESOURCE: "4"})
    ref_c.add_node("cpu-0")
    port_c.add_node("cpu-0")
    ref, port, _ = folds()
    return ((ref_c, ref, RRec(client=ref_c, telemetry=ref), RReq, RL),
            (port_c, port, TelemetryReconciler(client=port_c,
                                               telemetry=port), Request, L))


def test_reconciler_writes_the_condition_alike():
    """Each step's condition and write verbs, side by side: nothing for
    a healthy node, False at the third FAIL, True at the second OK, and
    no write while the condition matches the scorer."""
    sides = _telemetry_sides()
    script = ["ok", "fail", "fail", "fail", "fail", "ok", "ok", "ok", "warn"]
    logs = []
    for client, fold, rec, Req, lab in sides:
        log = []
        for seq, status in enumerate(script, 1):
            fold.on_node_delta("MODIFIED", {"metadata": {
                "name": "n0", "labels": dict(client.get(
                    "v1", "Node", "n0")["metadata"]["labels"]),
                "annotations": {lab.HEALTH_DIGEST: he.digest_annotation(
                    digest(status, seq))}}})
            client.reset_verb_counts()
            rec.reconcile(Req(name="n0"))
            rec.reconcile(Req(name="cpu-0"))
            rec.reconcile(Req(name="gone"))
            counts = client.reset_verb_counts()
            conds = [c for c in (client.get("v1", "Node", "n0").get(
                "status") or {}).get("conditions") or []
                if c["type"] == lab.TELEMETRY_CONDITION]
            log.append(([(N.name(c["type"]), c["status"], c["reason"],
                          c["message"]) for c in conds],
                        {v: n for v, n in counts.items()
                         if v in ("update", "update_status", "patch") and n}))
        logs.append(log)
    assert logs[1] == logs[0]
    assert [c[0][0][1] if c[0] else None for c in logs[1]] == \
        [None, None, None, "False", "False", "False", "True", "True", "True"]
    assert sum(bool(c[1]) for c in logs[1]) == 2


def test_reconciler_predicate_watches_digest_and_condition_only():
    from tpu_operator.controllers import telemetry_controller as rtc
    from tpu_operator_torch.controllers import telemetry_controller as tc
    from tpu_operator_torch.runtime import WatchEvent

    _, base = nodes("n0", dig=digest("ok", 1))
    echo = json.loads(json.dumps(base))
    echo["metadata"]["labels"]["x"] = "y"
    publish = json.loads(json.dumps(base))
    publish["metadata"]["annotations"][L.HEALTH_DIGEST] = \
        he.digest_annotation(digest("ok", 2))
    flipped = json.loads(json.dumps(base))
    flipped["status"] = {"conditions": [{"type": L.TELEMETRY_CONDITION,
                                         "status": "False"}]}
    got = [tc._node_telemetry_changed(WatchEvent(t, o), base)
           for t, o in (("MODIFIED", echo), ("MODIFIED", publish),
                        ("MODIFIED", flipped), ("ADDED", echo))]
    assert got == [False, True, True, True]
    assert tc.TelemetryReconciler.name == rtc.TelemetryReconciler.name
    assert tc._node_telemetry_changed(WatchEvent("MODIFIED", base), None)


def _get(mgr, path):
    port = mgr._http.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, json.loads(r.read())


def test_debug_fleet_answers_from_the_managers_fold():
    """Both Managers, on a CachedClient over their FakeClient, attach
    their process-wide fold at start; digests published after start
    reach ``/debug/fleet`` by watch events; stop detaches."""
    from tpu_operator.metrics.fleet import FLEET_TELEMETRY as RFT
    from tpu_operator.runtime import CachedClient as RCached
    from tpu_operator.runtime import FakeClient as RFake
    from tpu_operator.runtime import Manager as RManager
    from tpu_operator_torch.metrics.fleet import FLEET_TELEMETRY
    from tpu_operator_torch.runtime import CachedClient, FakeClient, Manager

    bodies = []
    for fake, cached, mgr_cls, ft, lab, labels, alloc in (
            (RFake, RCached, RManager, RFT, RL,
             {RL.GKE_TPU_ACCELERATOR: "tpu-v5e-slice",
              RL.GKE_TPU_TOPOLOGY: "2x4", RL.GKE_NODEPOOL: "pool-a"},
             {"google.com/tpu": "4"}),
            (FakeClient, CachedClient, Manager, FLEET_TELEMETRY, L,
             {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
              L.GPU_TOPOLOGY: "nvswitch-4", L.GKE_NODEPOOL: "pool-a"},
             {L.GPU_RESOURCE: "4"})):
        ft.reset()
        client = fake()
        for i in range(3):
            client.add_node(f"n{i}", labels=labels, allocatable=alloc)
        mgr = mgr_cls(cached(client), health_port=0)
        mgr.start()
        try:
            for seq, status in enumerate(["fail"] * 3 + ["ok"], 1):
                client.patch("v1", "Node", "n1", {"metadata": {
                    "annotations": {lab.HEALTH_DIGEST: he.digest_annotation(
                        digest(status, seq))}}})
                if seq == 3:
                    assert ft.condemned() == ["n1"]
            client.patch("v1", "Node", "n2", {"metadata": {"annotations": {
                lab.HEALTH_DIGEST: he.digest_annotation(digest("ok", 1))}}})
            code, body = _get(mgr, "/debug/fleet")
            assert code == 200
            bodies.append(body)
        finally:
            mgr.stop()
        assert not ft._cancels  # detached at stop
        ft.reset()
    ref, port = bodies
    ref["domains"]["pool-a"]["generation"] = "h100-sxm"
    assert port == ref
    assert port["scorer"]["condemned"] == ["n1"]
    assert port["totals"] == {"nodes": 3, "reporting": 2, "silent": 1,
                              "condemned": 1, "chips": 12,
                              "degraded_chips": 0}


def _reference_operator(client):
    """The reference's Manager as its ``main()`` wires it (it has no
    ``wire_manager``): a CachedClient and the four reconcilers."""
    from tpu_operator.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler,
    )
    from tpu_operator.controllers.placement_controller import (
        PlacementReconciler,
    )
    from tpu_operator.controllers.tpudriver_controller import (
        TPUDriverReconciler,
    )
    from tpu_operator.controllers.upgrade_controller import UpgradeReconciler
    from tpu_operator.runtime import CachedClient, Manager

    api = CachedClient(client)
    mgr = Manager(api, namespace="tpu-operator")
    for rec in (ClusterPolicyReconciler, TPUDriverReconciler,
                UpgradeReconciler, PlacementReconciler):
        mgr.add_reconciler(rec(client=api, namespace="tpu-operator"))
    return mgr


def test_c9_wire_manager_registers_no_telemetry_reconciler():
    """ROADMAP C9, kept: the operator as its CLI wires it attaches the
    fold but registers no TelemetryReconciler, so a condemnation never
    becomes the node condition placement drains on. Pinned in both
    packages."""
    import inspect

    from tpu_operator.cli import operator as rop
    from tpu_operator.metrics.fleet import FLEET_TELEMETRY as RFT
    from tpu_operator.runtime import FakeClient as RFake
    from tpu_operator_torch.cli import operator as op
    from tpu_operator_torch.metrics.fleet import FLEET_TELEMETRY
    from tpu_operator_torch.runtime import FakeClient

    ref_main = inspect.getsource(rop.main)
    assert ref_main.count("mgr.add_reconciler(") == 4
    assert "TelemetryReconciler" not in ref_main
    assert "TelemetryReconciler" not in inspect.getsource(op)

    def port_operator(client):
        return op.wire_manager(client, op.build_parser().parse_args(
            ["--no-trace"]), snapshot_dir=None)

    for wire, fake, ft, lab, labels in (
            (_reference_operator, RFake, RFT, RL,
             {RL.GKE_TPU_ACCELERATOR: "tpu-v5e-slice",
              RL.GKE_TPU_TOPOLOGY: "2x4"}),
            (port_operator, FakeClient, FLEET_TELEMETRY, L,
             {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
              L.GPU_TOPOLOGY: "nvswitch-4"})):
        ft.reset()
        client = fake()
        client.add_node("n0", labels=labels)
        mgr = wire(client)
        assert "telemetry" not in [c.name for c in mgr.controllers]
        assert len(mgr.controllers) == 4
        mgr.start()
        try:
            for seq in range(1, 4):
                client.patch("v1", "Node", "n0", {"metadata": {
                    "annotations": {lab.HEALTH_DIGEST: he.digest_annotation(
                        digest("fail", seq))}}})
            assert ft.condemned() == ["n0"]
            mgr.wait_idle(timeout=10.0)
            conds = (client.get("v1", "Node", "n0").get("status") or {}) \
                .get("conditions") or []
            assert not [c for c in conds
                        if c["type"] == lab.TELEMETRY_CONDITION]
        finally:
            mgr.stop()
            ft.reset()


def test_engine_digest_parses_on_both_sides():
    d = digest("warn", 9)
    raw = he.digest_annotation(d)
    assert he.parse_digest(raw) == rhe.parse_digest(raw) == d
    assert he.DIGEST_SCHEMA_VERSION == rhe.DIGEST_SCHEMA_VERSION

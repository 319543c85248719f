"""The port's informer cache and snapshots against the JAX package's: the
same writes and watch events through each package's ``CachedClient`` over
its own ``FakeClient`` give equal ``get``/``list``/``index``/
``index_keys``/``cache_stats`` through the name map — a GKE TPU host
(``gke-tpu-accelerator``, ``google.com/tpu``) <-> a GKE H100 host
(``gke-accelerator``, ``nvidia.com/gpu``), the capacity-only node in
either package's unlabeled bucket. A snapshot's capture, write,
``load_latest`` and restore round-trip equal to the reference's."""

import json

import pytest

import torch_naming as N
from tpu_operator.api import labels as RL
from tpu_operator.runtime import cache as rcache
from tpu_operator.runtime import snapshot as rsnap
from tpu_operator.runtime.fake import FakeClient as RFake
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.runtime import cache
from tpu_operator_torch.runtime import snapshot as snap
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.objects import thaw_obj

# the cluster map, reference -> port: torch_naming's rows, and a second
# accelerator for a node relabelled mid-run
ACCEL = {**{k: N.name(k) for k in (RL.GKE_TPU_ACCELERATOR, "tpu-v5p-slice",
                                   "google.com/tpu")},
         "tpu-v6e-slice": "nvidia-h100-mega-80gb"}
assert ACCEL[RL.GKE_TPU_ACCELERATOR] == L.GKE_ACCELERATOR


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.cache_mod = rcache if ref else cache
        self.snap_mod = rsnap if ref else snap
        self.fake = RFake() if ref else FakeClient()
        self.c = self.cache_mod.CachedClient(self.fake)

    def name(self, s: str) -> str:
        return s if self.ref else ACCEL.get(s, s)

    def node(self, name, accel=None, res=None, **labels):
        lab = dict(labels)
        if accel:
            lab[self.name(RL.GKE_TPU_ACCELERATOR)] = self.name(accel)
        alloc = {self.name("google.com/tpu"): res} if res else {}
        self.fake.add_node(name, labels=lab, allocatable=alloc)

    def pod(self, name, node, owner_uid=None, phase="Running"):
        meta = {"name": name, "namespace": "ns", "uid": f"uid-{name}",
                "labels": {"app": name.split("-")[0]}}
        if owner_uid:
            meta["ownerReferences"] = [{"apiVersion": "apps/v1",
                                        "kind": "DaemonSet",
                                        "name": "ds", "uid": owner_uid}]
        self.fake.create({
            "apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"nodeName": node, "containers": [
                {"name": "c", "image": "img", "env": [{"name": "A",
                                                        "value": "1"}],
                 "resources": {"requests": {"cpu": "1"}}}]},
            "status": {"phase": phase, "podIP": "10.0.0.1"}})


def to_port(tree):
    """A reference read result under the cluster map; uids dropped
    (nodes mint random ones)."""
    if isinstance(tree, dict):
        return {ACCEL.get(k, k): to_port(v) for k, v in tree.items()
                if k != "uid"}
    if isinstance(tree, list):
        return [to_port(v) for v in tree]
    return ACCEL.get(tree, tree) if isinstance(tree, str) else tree


def plain(tree):
    return to_port(json.loads(json.dumps(tree))) if tree is not None \
        else None


def observe(side: Side) -> dict:
    c = side.c
    by_accel = {k: [o["metadata"]["name"] for o in
                    c.index("v1", "Node", "by-accelerator", k)]
                for k in c.index_keys("v1", "Node", "by-accelerator")}
    reads = {
        "node": c.get("v1", "Node", "gpu-0"),
        "nodes": c.list("v1", "Node"),
        "pool_a": [o["metadata"]["name"] for o in
                   c.list("v1", "Node",
                          side.cache_mod.ListOptions(
                              label_selector={"pool": "a"}))],
        "by_accel": by_accel,
        "by_node": [o["metadata"]["name"]
                    for o in c.index("v1", "Pod", "by-node", "gpu-0")],
        "by_owner": [o["metadata"]["name"] for o in
                     c.index("v1", "Pod", "by-owner-uid", "ds-uid")],
        "pods": c.list("v1", "Pod", side.cache_mod.ListOptions(
            namespace="ns", label_selector={"matchExpressions": [
                {"key": "app", "operator": "In", "values": ["w"]}]})),
    }
    stats = c.cache_stats()
    for kind, row in stats["kinds"].items():
        if kind == "v1/Node":  # label strings differ in length
            assert row.pop("bytes") > 0
            assert row.pop("full_bytes") >= 0
    return plain({**reads, "stats": stats})


def drive(ref: bool) -> tuple:
    side = Side(ref)
    side.node("gpu-0", "tpu-v5p-slice", "4", pool="a")
    side.node("gpu-1", "tpu-v5p-slice", "4", pool="b")
    side.node("gpu-bare", None, "8", pool="a")   # capacity, no label
    side.node("cpu-0", None, None, pool="a")
    side.fake.create({"apiVersion": "apps/v1", "kind": "DaemonSet",
                      "metadata": {"name": "ds", "namespace": "ns",
                                   "uid": "ds-uid"}, "spec": {}})
    for i in range(3):
        side.pod(f"w-{i}", "gpu-0" if i < 2 else "gpu-1",
                 owner_uid="ds-uid" if i else None)
    steps = [observe(side)]                        # informers warm up
    # write-through: the cache's own write, read back at once
    side.c.patch("v1", "Node", "gpu-1", {"metadata": {"labels": {
        "pool": "a"}}})
    steps.append(observe(side))
    # watch events: writes on the apiserver side reach the stores
    node = thaw_obj(side.fake.get("v1", "Node", "cpu-0"))
    node["metadata"]["labels"][side.name(RL.GKE_TPU_ACCELERATOR)] = \
        side.name("tpu-v6e-slice")
    side.fake.update(node)
    side.fake.delete("v1", "Pod", "w-0", "ns")
    side.pod("w-9", "gpu-0", owner_uid="ds-uid")
    steps.append(observe(side))
    # a dropped stream: the heal relists and prunes what vanished
    side.fake.delete("v1", "Node", "gpu-bare")
    side.c.mark_stale()
    steps.append(observe(side))
    return side, steps


@pytest.fixture(scope="module")
def driven():
    return drive(True), drive(False)


@pytest.mark.parametrize("step", range(4))
def test_reads_agree_step_by_step(driven, step):
    (_, ref), (_, port) = driven
    assert port[step] == ref[step]


def test_unlabeled_gpu_bucket(driven):
    (_, ref), (side, port) = driven
    assert cache.UNLABELED_GPU == rcache.UNLABELED_TPU == "(unlabeled)"
    assert N.name("UNLABELED_TPU") == "UNLABELED_GPU"
    assert port[0]["by_accel"] == {"(unlabeled)": ["gpu-bare"],
                                   "nvidia-h100-80gb": ["gpu-0", "gpu-1"]}
    assert port[2]["by_accel"]["nvidia-h100-mega-80gb"] == ["cpu-0"]
    assert "(unlabeled)" not in port[3]["by_accel"]
    assert port[3]["stats"]["relists"] >= 1
    assert side.c.has_index("v1", "Node", "by-accelerator")


def test_projection_drops_what_no_reader_reads(driven):
    (_, ref), (side, port) = driven
    pod = side.c.get("v1", "Pod", "w-1", "ns")
    assert set(pod["spec"]) == {"nodeName", "containers"}
    assert pod["spec"]["containers"][0] == {"name": "c", "resources": {
        "requests": {"cpu": "1"}}}
    assert "podIP" not in pod["status"]
    row = port[0]["stats"]["kinds"]["v1/Pod"]
    assert row["projected"] and 0 < row["bytes"] < row["full_bytes"]


def test_delta_listeners_agree():
    out = []
    for ref in (True, False):
        side = Side(ref)
        seen = []
        side.c.add_delta_listener("v1", "Node", lambda t, o: seen.append(
            (t, o["metadata"]["name"])))

        def broken(t, o):
            raise ValueError("consumer bug")

        side.c.add_delta_listener("v1", "Node", broken)
        side.c.list("v1", "Node")
        for i in range(6):
            side.node(f"n{i}", "tpu-v5p-slice", "4")
        side.c.delete("v1", "Node", "n0")
        out.append((seen, side.c.listener_errors))
    assert out[0] == out[1]
    seen, errors = out[1]
    assert errors == side.cache_mod.LISTENER_DETACH_AFTER
    assert ("DELETED", "n0") in seen


def round_trip(ref: bool, tmp_path) -> dict:
    side, _ = drive(ref)
    directory = str(tmp_path / ("ref" if ref else "port"))
    captured = side.snap_mod.capture(side.c, wall=1000.0)
    path = side.snap_mod.write_snapshot(directory, captured)
    loaded = side.snap_mod.load_latest(directory, now_wall=1010.0)
    fresh = side.cache_mod.CachedClient(side.fake)
    summary = side.snap_mod.restore(fresh, loaded)
    side.snap_mod.record_restore(directory, {"outcome": "restored",
                                             **summary})
    meta = side.snap_mod.snapshot_metadata(directory, now_wall=1010.0)
    seeded = {kind: row["objects"] for kind, row in
              fresh.cache_stats()["kinds"].items()}
    for key in ("dir", "snapshots"):
        meta.pop(key)
    meta["latest"].pop("path")
    # a restart's first read: the informer resumes from the snapshot's RV
    nodes = fresh.list("v1", "Node")
    return plain({"summary": summary, "seeded": seeded, "meta": meta,
                  "stale": side.snap_mod.validate(loaded, now_wall=1e9),
                  "schema": captured["schema"],
                  "file": path.rsplit("/", 1)[1],
                  "nodes": nodes,
                  "resumes": fresh.watch_resumes,
                  "stores": {k: len(v["objects"]) for k, v in
                             captured["stores"].items()}})


def test_snapshot_round_trip_agrees(tmp_path):
    ref = round_trip(True, tmp_path)
    port = round_trip(False, tmp_path)
    assert port == ref
    assert port["summary"] == {"kinds": 2, "objects": 6}
    assert port["resumes"] == 1 and port["stale"].startswith("stale")
    assert port["meta"]["last_restore"]["outcome"] == "restored"
    # the index and admission sections came with placement, federation's
    # with the router (their round trips are test_torch_snapshot_placement.py's
    # and test_torch_multicell.py's)
    assert hasattr(snap, "restore_index") and hasattr(snap,
                                                      "restore_admission")
    assert hasattr(snap, "restore_federation")


def test_corrupt_snapshot_is_discarded(tmp_path):
    for mod in (rsnap, snap):
        d = tmp_path / mod.__name__
        d.mkdir()
        (d / "snapshot-0000000000000002.json").write_text("{not json")
        (d / "snapshot-0000000000000001.json").write_text(
            json.dumps({"schema": -1}))
        assert mod.load_latest(str(d)) is None
    assert snap.SCHEMA_VERSION == rsnap.SCHEMA_VERSION


def test_derive_requeue_state_agrees():
    crs = [{"metadata": {"name": "a", "namespace": "n"},
            "status": {"requeueAttempts": 3}},
           {"metadata": {"name": "b"}, "status": {"requeueAttempts": "x"}},
           {"metadata": {"name": "c"}, "status": {"requeueAttempts": 0}}]
    assert snap.derive_requeue_state(crs) == \
        rsnap.derive_requeue_state(crs) == {("n", "a"): 3}

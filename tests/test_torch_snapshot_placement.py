"""The snapshot plane's placement sections in the port
(``runtime/snapshot.py``, ``runtime/manager.py``): a capture carries the
placement index's node set and the admission state (deficit clocks,
budget buckets), ``restore_index`` rebuilds an index that answers as the
live one did, ``restore_admission`` hands the state back, and both
equal what the JAX package's capture and restore give on the same
cluster. Under the Manager, a placement reconciler's index is captured
beside the cache, and a restart replays the SliceRequests' persisted
requeue attempts into the reconciler (the reference's
``runtime/manager.py:800-850``) before any watch is wired."""

import json
import time

import torch_placement_fleets as F
from tpu_operator.api import slicerequest as rsr
from tpu_operator.controllers import placement_controller as rpc
from tpu_operator.runtime import CachedClient as RCached
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime import snapshot as rsnap
from tpu_operator.scheduling import quota as rq
from tpu_operator_torch.api import slicerequest as sr
from tpu_operator_torch.api.slicerequest import SliceRequestSpec
from tpu_operator_torch.cli import operator as op
from tpu_operator_torch.controllers import placement_controller as pc
from tpu_operator_torch.runtime import CachedClient
from tpu_operator_torch.runtime import snapshot as snap
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Request
from tpu_operator_torch.scheduling import quota as q

ROWS = [{"name": "prod", "weight": 3, "minChips": 64, "preemptTokens": 1},
        {"name": "batch"}]


def placed_cluster(ref: bool):
    """A mapped fleet, three requests reconciled (two placed, one too big:
    Unschedulable) under a quota tree that starves prod."""
    mod = rsr if ref else sr
    c = RFake() if ref else FakeClient()
    F.add_nodes(c, ref)
    t = [1000.0]
    rec = (rpc if ref else pc).PlacementReconciler(
        client=c, namespace="default",
        quota=(rq if ref else q).QuotaTree.from_config({"classes": ROWS}),
        admission_policy="finish-time", now=lambda: t[0])
    for name, chips in (("a", 4), ("b", 16), ("huge", 64)):
        cr = mod.new_slice_request(name, {"chips": chips},
                                   namespace="prod")
        c.create(cr)
        t[0] += 1.0
        rec.reconcile((RRequest if ref else Request)(name=name,
                                                     namespace="prod"))
    return c, rec


def test_capture_and_restore_carry_index_and_admission():
    got, want = [], []
    for ref, out in ((True, want), (False, got)):
        c, rec = placed_cluster(ref)
        cached = (RCached if ref else CachedClient)(c)
        for av, kind in (("v1", "Node"),
                         ((rsr if ref else sr).V1ALPHA1, "SliceRequest")):
            cached.list(av, kind)
        mod = rsnap if ref else snap
        doc = mod.capture(cached, index=rec.fleet_index,
                          admission=rec.admission_snapshot(), wall=5.0)
        doc = json.loads(json.dumps(doc))
        index = mod.restore_index(doc)
        spec = (rsr if ref else sr).SliceRequestSpec(chips=4)
        best = index.best(spec)
        live = rec.fleet_index.best(spec)
        out.append((sorted(n["metadata"]["name"] for n in
                           doc["index_nodes"]),
                    mod.restore_admission(doc),
                    best.nodes, best.nodes == live.nodes,
                    index.owned_nodes("prod/b"),
                    mod.restore_admission({"admission": "garbage"}),
                    mod.restore_index({})))
        cached.close()
    assert got == want
    (_, admission, _, same, owned, bad, none), = got
    assert same and owned and bad is None and none is None
    assert admission["deficit_since"] == {"prod": 1003.0}


def test_snapshot_metadata_reports_the_sections(tmp_path):
    c, rec = placed_cluster(False)
    cached = CachedClient(c)
    cached.list("v1", "Node")
    snap.write_snapshot(str(tmp_path), snap.capture(
        cached, index=rec.fleet_index, admission=rec.admission_snapshot()))
    meta = snap.snapshot_metadata(str(tmp_path))
    assert meta["latest"]["has_index"] is True
    assert meta["latest"]["has_admission"] is True
    cached.close()


def wait(pred, what, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_manager_captures_the_index_and_replays_requeue_state(tmp_path):
    """Under the manager as gpu-operator wires it: watch events place a
    request and park a too-big one Unschedulable (its attempts in
    status); the clean stop's snapshot holds the index; the restart
    restores and seeds the parked request's attempts into the new
    placement reconciler."""
    fake = FakeClient()
    F.add_nodes(fake, False, singles=2, slices=("pa",))
    args = op.build_parser().parse_args(["--namespace", "default"])
    outcomes = []
    for round_ in range(2):
        mgr = op.wire_manager(fake, args, snapshot_dir=str(tmp_path))
        [ctrl] = [c for c in mgr.controllers if c.name == "sliceplacement"]
        mgr.start()
        try:
            if round_ == 0:
                fake.create(sr.new_slice_request("fits", {"chips": 8}))
                fake.create(sr.new_slice_request("huge", {"chips": 64}))
                wait(lambda: (fake.get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                                       "huge", "default").get("status")
                              or {}).get("requeueAttempts"),
                     "the too-big request to park")
                wait(lambda: (fake.get(sr.V1ALPHA1, sr.KIND_SLICE_REQUEST,
                                       "fits", "default").get("status")
                              or {}).get("phase") == "Placed",
                     "the request to be placed")
                assert mgr._snapshot_index() is ctrl.reconciler.fleet_index
            else:
                outcomes.append(dict(mgr.last_restore))
                seeded = dict(ctrl.reconciler._unsched_attempts)
            assert mgr.wait_idle(timeout=20.0, horizon=0.5)
        finally:
            mgr.stop()
        if round_ == 0:
            fake.reset_verb_counts()
    [restore] = outcomes
    assert restore["outcome"] == "restored"
    assert restore["requeue_state_seeded"] == 1
    assert seeded.get("default/huge", 0) >= 1
    files = snap.snapshot_files(str(tmp_path))
    doc = snap.load_latest(str(tmp_path))
    assert files and len(doc["index_nodes"]) == 6
    assert SliceRequestSpec(chips=8).chips_needed() == 8

"""The multi-cell harness, the placement reconciler's cell rider, the
cross-cell invariants and the snapshot's federation section against the
JAX package's — the rest of ``tests/test_federation.py``'s counterparts,
and the Manager's capture and restore of the router (the reference's
``runtime/manager.py:851-859``, ``:888-895``).

Both packages run the same calls (``R`` the reference's modules, ``P``
the port's) over the fleets ``torch_chaos_parity`` maps one to one, and
the port's outcome must be the reference's."""

import json
from types import SimpleNamespace

import torch_chaos_parity as CP
from tpu_operator.api import labels as RL
from tpu_operator.api import slicerequest as rsr
from tpu_operator.chaos import invariants as rinv
from tpu_operator.controllers import placement_controller as rpc
from tpu_operator.federation import digest as rdigest
from tpu_operator.federation import router as rrouter
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime import fake as rfake
from tpu_operator.runtime import multicell as rmc
from tpu_operator.runtime.timeline import TIMELINE as RTIMELINE
from tpu_operator.workloads import elastic as relastic
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api import slicerequest as sr
from tpu_operator_torch.chaos import invariants as inv
from tpu_operator_torch.controllers import placement_controller as pc
from tpu_operator_torch.federation import digest, router
from tpu_operator_torch.runtime import Request
from tpu_operator_torch.runtime import fake, multicell
from tpu_operator_torch.runtime.timeline import TIMELINE
from tpu_operator_torch.workloads import elastic

R = SimpleNamespace(L=RL, sr=rsr, inv=rinv, pc=rpc, digest=rdigest,
                    router=rrouter, Request=RRequest, fake=rfake, mc=rmc,
                    TIMELINE=RTIMELINE, elastic=relastic, ref=True)
P = SimpleNamespace(L=L, sr=sr, inv=inv, pc=pc, digest=digest,
                    router=router, Request=Request, fake=fake, mc=multicell,
                    TIMELINE=TIMELINE, elastic=elastic, ref=False)


def both(fn):
    want, got = fn(R), fn(P)
    assert got == want
    return got


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class _Timeline:
    def __init__(self, pkg, clock):
        self.tl, self.clock = pkg.TIMELINE, clock

    def __enter__(self):
        self._prev = (self.tl.clock, self.tl.enabled)
        self.tl.reset(clock=self.clock, enabled=True)
        return self.tl

    def __exit__(self, *exc):
        self.tl.reset(clock=self._prev[0], enabled=self._prev[1])


def _harness(pkg, clock):
    fakes = {name: CP.build(pkg.ref)(8) for name in ("cell-a", "cell-b")}
    cells = {}
    for name, c in fakes.items():
        recon = pkg.pc.PlacementReconciler(c, namespace="default",
                                           preemption=False, now=clock,
                                           cell=name)
        cells[name] = pkg.mc.Cell(name, c, reconciler=recon)
    r = pkg.router.GlobalRouter(["cell-a", "cell-b"], now=clock,
                                failure_threshold=1,
                                condemnation_horizon_s=30.0)
    harness = pkg.mc.MultiCellHarness(
        r, cells, now=clock,
        shim_factory=lambda cell, name, ns, store:
        pkg.elastic.ElasticWorkload(fakes[cell.name], name, ns,
                                    clock=clock, store=store))
    return fakes, cells, r, harness


def _settle(pkg, fakes, cells, harness, shims_for=()):
    for _ in range(6):
        for name in sorted(cells):
            c = fakes[name]
            for cr in c.list(pkg.sr.V1ALPHA1, pkg.sr.KIND_SLICE_REQUEST):
                cells[name].reconciler.reconcile(pkg.Request(
                    name=cr["metadata"]["name"], namespace="default"))
            pkg.fake.simulate_kubelet(c, ready=True)
            for key in shims_for:
                ns, _, nm = key.partition("/")
                cr = c.get_or_none(pkg.sr.V1ALPHA1,
                                   pkg.sr.KIND_SLICE_REQUEST, nm, ns)
                owned = {k for cell in cells.values() for k in cell.shims}
                if (cr is not None and key not in owned
                        and (cr.get("status") or {}).get("phase")
                        == pkg.sr.PHASE_PLACED):
                    cells[name].shims[key] = pkg.elastic.ElasticWorkload(
                        c, nm, ns, clock=harness.now)
            for key in sorted(cells[name].shims):
                cells[name].shims[key].tick()
        harness.migration_pass()


def test_condemned_cell_slices_hop_with_their_checkpoints():
    def run(pkg):
        clock = Clock()
        with _Timeline(pkg, clock) as tl:
            fakes, cells, r, harness = _harness(pkg, clock)
            for name in ("cell-a", "cell-b"):
                r.observe_digest(pkg.digest.cell_digest(
                    cells[name].fleet_index(), name, 1, clock()))
            harness.submit(pkg.sr.new_slice_request("job", {"chips": 4}))
            routed = harness.route_pass()
            key = "default/job"
            src = next(n for n in sorted(fakes) if fakes[n].list(
                pkg.sr.V1ALPHA1, pkg.sr.KIND_SLICE_REQUEST))
            dst = "cell-b" if src == "cell-a" else "cell-a"
            _settle(pkg, fakes, cells, harness, shims_for=(key,))
            placed = fakes[src].get_or_none(
                pkg.sr.V1ALPHA1, pkg.sr.KIND_SLICE_REQUEST, "job",
                "default")["status"]["phase"]
            for _ in range(4):
                clock.t += 10.0
                for k in sorted(cells[src].shims):
                    cells[src].shims[k].tick()
            r.record_failure(src)
            state = r.cells[src].state
            clock.t += 31.0
            condemned = r.condemned_cells()
            _settle(pkg, fakes, cells, harness)
            twin = fakes[dst].get_or_none(pkg.sr.V1ALPHA1,
                                          pkg.sr.KIND_SLICE_REQUEST, "job",
                                          "default")
            mig = dict(twin["status"]["migration"])
            events = tl.timeline("SliceRequest", key)
            hop = next(e for e in events
                       if e["event"] == "migration:CrossCellHop")
            return {
                "routed": routed, "src": src, "placed": placed,
                "state": state, "condemned": condemned,
                "twin_phase": twin["status"]["phase"],
                "twin_nodes": list(twin["status"]["nodes"]),
                "migration": (mig["phase"], mig["from"], mig["ackedStep"],
                              mig["restoredStep"]),
                "src_gone": fakes[src].get_or_none(
                    pkg.sr.V1ALPHA1, pkg.sr.KIND_SLICE_REQUEST, "job",
                    "default") is None,
                "shims": (key in cells[dst].shims,
                          key in cells[src].shims),
                "in_flight": dict(harness.migrations),
                "events": [e["event"] for e in events],
                "hop_origins": [c["origin"] for c in hop["causes"]],
            }
    out = both(run)
    assert out["routed"] == 1 and out["placed"] == "Placed"
    assert out["state"] == "Open" and out["condemned"] == [out["src"]]
    assert out["twin_phase"] == "Placed"
    phase, origin, acked, restored = out["migration"]
    assert phase == "Resumed" and origin == f"cell/{out['src']}"
    assert int(restored) >= int(acked)
    assert out["src_gone"] and out["shims"] == (True, False)
    assert out["in_flight"] == {}
    assert f"cell/{out['src']}" in out["hop_origins"]


def test_recover_migrations_rebuilds_from_request_status():
    def run(pkg):
        clock = Clock()
        with _Timeline(pkg, clock):
            fakes, cells, r, harness = _harness(pkg, clock)
            body = pkg.sr.new_slice_request("moving", {"chips": 4})
            body["metadata"]["annotations"] = {pkg.L.CELL_PIN: "cell-b"}
            fakes["cell-b"].create(body)
            live = fakes["cell-b"].get_or_none(
                pkg.sr.V1ALPHA1, pkg.sr.KIND_SLICE_REQUEST, "moving",
                "default")
            cr = json.loads(json.dumps(live))
            cr.setdefault("status", {})["migration"] = {
                "phase": pkg.sr.MIG_CHECKPOINTED, "from": "cell/cell-a",
                "ackedStep": 12}
            fakes["cell-b"].update_status(cr)
            return harness.recover_migrations(), dict(harness.migrations)
    assert both(run) == (1, {"default/moving": {
        "src": "cell-a", "dst": "cell-b", "stage": "hop"}})


def test_placement_rider_places_only_its_cells_requests():
    """``PlacementReconciler(cell=...)`` places a request pinned to its
    cell, leaves an unpinned one and another cell's alone; with no cell
    it ignores pins."""
    def run(pkg):
        c = CP.build(pkg.ref)(8)
        for name, pin in (("mine", "cell-a"), ("theirs", "cell-b"),
                          ("unrouted", None)):
            body = pkg.sr.new_slice_request(name, {"chips": 4})
            if pin:
                body["metadata"]["annotations"] = {pkg.L.CELL_PIN: pin}
            c.create(body)
        out = {}
        for cell in ("cell-a", None):
            rec = pkg.pc.PlacementReconciler(c, namespace="default",
                                             preemption=False,
                                             now=Clock(), cell=cell)
            for name in ("mine", "theirs", "unrouted"):
                rec.reconcile(pkg.Request(name=name, namespace="default"))
            out[str(cell)] = {
                cr["metadata"]["name"]: (cr.get("status") or {}).get(
                    "phase") for cr in c.list(pkg.sr.V1ALPHA1,
                                              pkg.sr.KIND_SLICE_REQUEST)}
        return out
    out = both(run)
    assert out["cell-a"] == {"mine": "Placed", "theirs": None,
                             "unrouted": None}
    assert set(out["None"].values()) == {"Placed"}


def _client_with(pkg, name, status):
    c = pkg.fake.FakeClient()
    c.create(pkg.sr.new_slice_request(name, {"chips": 4}))
    live = c.get_or_none(pkg.sr.V1ALPHA1, pkg.sr.KIND_SLICE_REQUEST, name,
                         "default")
    cr = json.loads(json.dumps(live))
    cr["status"] = status
    c.update_status(cr)
    return c


def test_restore_below_acked_high_water_is_a_violation():
    def run(pkg):
        checker = pkg.inv.CrossCellWorkChecker()
        a = _client_with(pkg, "job", {"phase": "Placed", "migration": {
            "phase": pkg.sr.MIG_CHECKPOINTED, "ackedStep": 40,
            "toCell": "b"}})
        checker.observe(0, {"a": a})
        b = _client_with(pkg, "job", {"phase": "Placed", "migration": {
            "phase": pkg.sr.MIG_RESUMED, "from": "cell/a",
            "restoredStep": 30}})
        checker.observe(1, {"b": b})
        first = checker.to_list()
        checker.observe(2, {"b": b})
        return first, len(checker.violations), checker.acked_high_water
    first, count, high = both(run)
    assert [v["invariant"] for v in first] == ["no-lost-work-cross-cell"]
    assert count == 1 and high == {"default/job": 40}


def test_double_placement_flagged_but_handoff_window_exempt():
    def run(pkg):
        checker = pkg.inv.CrossCellWorkChecker()
        src = _client_with(pkg, "job", {"phase": "Placed", "migration": {
            "phase": pkg.sr.MIG_CHECKPOINTED, "toCell": "b"}})
        dst = _client_with(pkg, "job", {"phase": "Placed"})
        checker.observe(0, {"a": src, "b": dst})
        before = checker.to_list()
        rogue = _client_with(pkg, "job", {"phase": "Placed"})
        checker.observe(1, {"a": rogue, "b": dst})
        return before, checker.to_list()
    before, after = both(run)
    assert before == [] and [v["invariant"] for v in after] == [
        "single-binding"]


def test_snapshot_carries_the_router_section():
    from tpu_operator.runtime import snapshot as rsnap
    from tpu_operator_torch.runtime import snapshot as snap

    def run(pkg_snap):
        def go(pkg):
            c = pkg.fake.FakeClient()
            from_cache = SimpleNamespace(dump_stores=lambda: {})
            r = pkg.router.GlobalRouter(["a", "b"], now=Clock(50.0),
                                        failure_threshold=1)
            r.record_failure("b")
            s = pkg_snap[pkg.ref].capture(from_cache, wall=1.0,
                                          federation=r.snapshot())
            del c
            return (s["federation"],
                    pkg_snap[pkg.ref].restore_federation(s),
                    pkg_snap[pkg.ref].restore_federation({}),
                    pkg_snap[pkg.ref].restore_federation(
                        {"federation": "garbage"}))
        return go
    fed, restored, none1, none2 = both(run({True: rsnap, False: snap}))
    assert fed == restored and fed["cells"]["b"]["state"] == "Open"
    assert none1 is None and none2 is None


def test_manager_restart_restores_the_router(tmp_path):
    """The Manager captures the router's ledgers in its snapshot and
    hands them back at restore (outcome ``federation_restored``)."""
    from tpu_operator_torch.controllers.federation_controller import (
        FederationReconciler,
    )
    from tpu_operator_torch.runtime.cache import CachedClient
    from tpu_operator_torch.runtime.manager import Manager

    def manager(router):
        c = CachedClient(fake.FakeClient())
        mgr = Manager(c, namespace="gpu-operator", snapshot_dir=str(tmp_path))
        mgr.add_reconciler(FederationReconciler(c, router))
        return mgr

    r1 = router.GlobalRouter(["east", "west"], now=Clock(80.0),
                             failure_threshold=1)
    r1.record_failure("west")
    mgr = manager(r1)
    assert mgr.write_snapshot_now() is not None
    r2 = router.GlobalRouter(["east", "west"], now=Clock(90.0),
                             failure_threshold=1)
    mgr2 = manager(r2)
    outcome = mgr2.restore_from_snapshot()
    assert outcome["outcome"] == "restored"
    assert outcome["federation_restored"] is True
    assert r2.cells["west"].state == "Open"
    assert r2.cells["west"].open_since == 80.0


def test_c11_the_harness_contact_pass_probes_no_cell_with_an_index():
    """ROADMAP C11, kept: ``MultiCellHarness.contact_pass`` reads a cell's
    digest from its reconciler's in-process index once it has one, so a
    cell partitioned from the global plane is still contacted with
    success; the chaos runner (and phase M) probe by a list through the
    gate instead. Without an index the pass lists, and the partition
    shows."""
    from tpu_operator.chaos import federation as rcf
    from tpu_operator_torch.chaos import federation as cf

    def run(pkg, gate_cls):
        states = []
        for warm in (True, False):
            c = CP.build(pkg.ref)(8)
            rec = pkg.pc.PlacementReconciler(c, namespace="default",
                                             preemption=False, now=Clock(),
                                             cell="a")
            if warm:  # a placement builds the reconciler's index
                body = pkg.sr.new_slice_request("job", {"chips": 4})
                body["metadata"]["annotations"] = {pkg.L.CELL_PIN: "a"}
                c.create(body)
                rec.reconcile(pkg.Request(name="job", namespace="default"))
            gate = gate_cls(c)
            r = pkg.router.GlobalRouter(["a"], now=Clock(),
                                        failure_threshold=1)
            harness = pkg.mc.MultiCellHarness(
                r, {"a": pkg.mc.Cell("a", gate, reconciler=rec)},
                now=Clock())
            gate.blocked = True
            harness.contact_pass()
            states.append((rec.fleet_index is not None, r.cells["a"].state))
        return states

    assert run(R, rcf._PartitionGate) == run(P, cf._PartitionGate) == [
        (True, "Healthy"), (False, "Open")]

"""The federation plane's units against the JAX package's: cell digests,
the circuit-breaking global router, the router reconciler, the cells
report and ``/debug/cells`` — the counterparts of ``tests/test_federation.py``.

Each test drives the same calls through both packages (``R`` the
reference's modules, ``P`` the port's) and holds the port's outcome to
the reference's. The router keys headroom by an opaque generation
string, so a digest carries the reference's ``v5p`` on one side and the
port's ``h100-sxm`` on the other (``torch_chaos_parity.GENERATIONS``);
a real index's digest is read over the mapped fleets of
``torch_chaos_parity``."""

import json
import random
from types import SimpleNamespace

import pytest

import torch_chaos_parity as CP
from tpu_operator.api import labels as RL
from tpu_operator.api import slicerequest as rsr
from tpu_operator.controllers import federation_controller as rfc
from tpu_operator.federation import digest as rdigest
from tpu_operator.federation import router as rrouter
from tpu_operator.runtime import Request as RRequest
from tpu_operator.runtime import fake as rfake
from tpu_operator.runtime.timeline import TIMELINE as RTIMELINE
from tpu_operator.topology import index as rindex
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api import slicerequest as sr
from tpu_operator_torch.controllers import federation_controller as fc
from tpu_operator_torch.federation import digest, router
from tpu_operator_torch.runtime import Request
from tpu_operator_torch.runtime import fake
from tpu_operator_torch.runtime.timeline import TIMELINE
from tpu_operator_torch.topology import index

R = SimpleNamespace(digest=rdigest, router=rrouter, fc=rfc, sr=rsr,
                    L=RL, fake=rfake, index=rindex, Request=RRequest,
                    TIMELINE=RTIMELINE, gen="v5p", other="v5e", ref=True)
P = SimpleNamespace(digest=digest, router=router, fc=fc, sr=sr, L=L,
                    fake=fake, index=index, Request=Request,
                    TIMELINE=TIMELINE, gen="h100-sxm", other="a100-sxm",
                    ref=False)


def both(fn):
    """``fn`` on each package; the port's outcome must be the
    reference's. Returns the port's."""
    want, got = fn(R), fn(P)
    assert got == want
    return got


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def mk_digest(pkg, cell, seq, at=0.0, chips_free=64, hosts=16,
              fragmentation=0.0, condemned=0, headroom=None):
    return {
        "v": pkg.digest.CELL_DIGEST_SCHEMA_VERSION,
        "cell": cell, "seq": seq, "at": at, "hosts": hosts,
        "chips_free": chips_free,
        "chips_placed": hosts * 4 - chips_free,
        "utilization": 1.0 - chips_free / (hosts * 4.0),
        "headroom": headroom if headroom is not None
        else {pkg.gen: chips_free},
        "fragmentation": fragmentation, "condemned": condemned,
    }


def test_constants_are_the_references():
    for name in ("CELL_DIGEST_SCHEMA_VERSION", "PUBLISH_INTERVAL_S",
                 "PUBLISH_JITTER"):
        assert getattr(digest, name) == getattr(rdigest, name)
    for name in ("CELL_HEALTHY", "CELL_SUSPECT", "CELL_OPEN",
                 "FAILURE_THRESHOLD", "PROBE_BACKOFF_BASE_S",
                 "PROBE_BACKOFF_CAP_S", "DIGEST_HALF_LIFE_S",
                 "CONDEMNATION_HORIZON_S", "LOCALITY_TOLERANCE",
                 "SUSPECT_PENALTY", "ROUTER_STATE_VERSION"):
        assert getattr(router, name) == getattr(rrouter, name)
    assert fc.ROUTE_RETRY_S == rfc.ROUTE_RETRY_S
    assert fc.FederationReconciler.name == rfc.FederationReconciler.name
    assert L.CELL_PIN == "gpu.graft.dev/cell"
    assert L.CELL_AFFINITY == "gpu.graft.dev/cell-affinity"


class TestCellDigest:
    def test_digest_from_real_index_round_trips(self):
        def run(pkg):
            nodes = CP.build(pkg.ref)(12).list("v1", "Node")
            d = pkg.digest.cell_digest(pkg.index.FleetIndex(nodes),
                                       "cell-a", 3, 42.0)
            assert pkg.digest.parse_cell_digest(
                pkg.digest.cell_digest_json(d)) == d
            d["headroom"] = {CP.GENERATIONS.get(g, g): v
                             for g, v in d["headroom"].items()}
            return d
        d = both(run)
        assert d["chips_free"] > 0 and d["hosts"] > 0

    def test_unknown_schema_version_parses_to_none(self):
        def run(pkg):
            d = mk_digest(pkg, "a", 1)
            d["v"] += 1
            return (pkg.digest.parse_cell_digest(d),
                    pkg.digest.parse_cell_digest(json.dumps(d)))
        assert both(run) == (None, None)

    def test_malformed_payloads_parse_to_none(self):
        def run(pkg):
            no_cell = mk_digest(pkg, "a", 1)
            no_cell.pop("cell")
            bad_seq = dict(mk_digest(pkg, "a", 1), seq="three")
            return [pkg.digest.parse_cell_digest(x) for x in
                    (None, "{not json", "[1,2]", no_cell, bad_seq)]
        assert both(run) == [None] * 5

    def test_publish_wait_is_seeded_and_bounded(self):
        waits = both(lambda pkg: [pkg.digest.publish_wait(f"cell-{i}")
                                  for i in range(8)])
        assert len(set(waits)) > 1
        assert all(15.0 * 0.8 <= w <= 15.0 * 1.2 for w in waits)


class TestRouterBreaker:
    def test_streak_walks_healthy_suspect_open_and_heals(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a"], now=Clock(),
                                        failure_threshold=3)
            states = [r.cells["a"].state]
            for _ in range(3):
                r.record_failure("a")
                states.append(r.cells["a"].state)
            r.record_success("a")
            cs = r.cells["a"]
            return states, (cs.state, cs.failure_streak, cs.probes,
                            cs.open_since)
        assert both(run) == (["Healthy", "Suspect", "Suspect", "Open"],
                             ("Healthy", 0, 0, None))

    def test_open_cell_probed_on_capped_exponential_backoff(self):
        def run(pkg):
            clock = Clock(t=0.0)
            r = pkg.router.GlobalRouter(["a", "b"], now=clock,
                                        failure_threshold=1,
                                        probe_base_s=10.0, probe_cap_s=35.0)
            seen = []
            r.record_failure("a")
            for t, fail in ((0.0, False), (10.0, True), (29.9, False),
                            (30.0, True), (64.9, False), (65.0, False)):
                clock.t = t
                seen.append((t, r.cells_to_contact()))
                if fail:
                    r.record_failure("a")
            return seen
        seen = both(run)
        assert seen[0][1] == ["b"] and seen[1][1] == ["a", "b"]
        assert "a" in seen[-1][1] and "a" not in seen[-2][1]

    def test_condemnation_waits_for_the_horizon(self):
        def run(pkg):
            clock = Clock(t=100.0)
            r = pkg.router.GlobalRouter(["a"], now=clock,
                                        failure_threshold=1,
                                        condemnation_horizon_s=60.0)
            r.record_failure("a")
            out = [r.condemned_cells()]
            for t in (159.9, 160.0):
                clock.t = t
                out.append(r.condemned_cells())
            r.record_success("a")
            return out + [r.condemned_cells()]
        assert both(run) == [[], [], ["a"], []]


class TestRouterScoring:
    def test_open_and_digestless_cells_never_score(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a", "b", "c"], now=Clock(t=0.0),
                                        failure_threshold=1)
            r.observe_digest(mk_digest(pkg, "a", 1))
            r.observe_digest(mk_digest(pkg, "b", 1))
            r.record_failure("b")
            return ([r.score(c, chips=4) for c in "abc"],
                    r.route(4)["cell"])
        scores, cell = both(run)
        assert scores[0] > 0.0 and scores[1:] == [0.0, 0.0] and cell == "a"

    def test_stale_digest_is_age_discounted(self):
        def run(pkg):
            clock = Clock(t=0.0)
            r = pkg.router.GlobalRouter(["a"], now=clock,
                                        digest_half_life_s=60.0)
            r.observe_digest(mk_digest(pkg, "a", 1, at=0.0))
            out = []
            for t in (0.0, 60.0, 120.0):
                clock.t = t
                out.append(r.score("a", chips=4))
            return out
        fresh, half, third = both(run)
        assert half == pytest.approx(fresh / 2)
        assert third == pytest.approx(fresh / 3)

    def test_suspect_cell_scores_at_a_discount_not_zero(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a"], now=Clock(t=0.0),
                                        failure_threshold=3)
            r.observe_digest(mk_digest(pkg, "a", 1))
            healthy = r.score("a", chips=4)
            r.record_failure("a")
            return healthy, r.cells["a"].state, r.score("a", chips=4)
        healthy, state, suspect = both(run)
        assert state == "Suspect" and suspect == pytest.approx(healthy / 2)

    def test_generation_headroom_gates_pinned_requests(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a", "b"], now=Clock(t=0.0))
            r.observe_digest(mk_digest(pkg, "a", 1, chips_free=64,
                                       headroom={pkg.other: 64}))
            r.observe_digest(mk_digest(pkg, "b", 1, chips_free=16,
                                       headroom={pkg.gen: 16}))
            return (r.route(4)["cell"],
                    r.route(4, generation=pkg.gen)["cell"],
                    r.route(32, generation=pkg.gen))
        assert both(run) == ("a", "b", None)

    def test_a_product_pin_routes_by_its_generation(self):
        """The port reads a pinned request's generation off its
        ``gpu.product`` pin, where the reference reads a GKE TPU
        accelerator label's."""
        assert router.request_generation("NVIDIA-H100-80GB-HBM3") == \
            "h100-sxm"
        assert router.request_generation("NVIDIA-GB200") == "gb200"
        assert router.request_generation(None) is None
        assert router.request_generation("") is None
        assert RL.accelerator_generation("tpu-v5p-slice") == "v5p"

    def test_routing_books_capacity_until_the_next_publish(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a"], now=Clock(t=0.0))
            r.observe_digest(mk_digest(pkg, "a", 1, chips_free=8,
                                       headroom={pkg.gen: 8}))
            out = [r.route(8), r.route(8)]
            r.observe_digest(mk_digest(pkg, "a", 2, chips_free=8,
                                       headroom={pkg.gen: 8}))
            return out + [r.route(8)]
        first, second, third = both(run)
        assert first["cell"] == "a" and second is None
        assert third["cell"] == "a"

    def test_locality_steers_between_comparable_cells_only(self):
        def run(pkg):
            out = []
            for b_free in (48, 4):
                r = pkg.router.GlobalRouter(["a", "b"], now=Clock(t=0.0))
                r.observe_digest(mk_digest(pkg, "a", 1, chips_free=64))
                r.observe_digest(mk_digest(pkg, "b", 1, chips_free=b_free))
                d = r.route(4, locality="b")
                out.append((d["cell"], d["reason"]))
            return out
        assert both(run) == [("b", "locality"), ("a", "digest-score")]


class TestArrivalOrderIndependence:
    def test_seeded_permutations_reach_identical_decisions(self):
        def run(pkg):
            rng = random.Random(1513)
            cells = [f"cell-{i}" for i in range(4)]
            digests = [mk_digest(pkg, c, seq, at=float(seq),
                                 chips_free=rng.randrange(8, 96, 4),
                                 fragmentation=rng.random() / 2,
                                 headroom={pkg.gen: rng.randrange(4, 64, 4)})
                       for c in cells for seq in (1, 2, 3)]
            stream = [(rng.choice((4, 8, 16)),
                       rng.choice((None, pkg.gen)),
                       rng.choice((None, rng.choice(cells))))
                      for _ in range(30)]

            def decisions(order_seed):
                r = pkg.router.GlobalRouter(cells, now=Clock(t=10.0))
                batch = digests + digests
                random.Random(order_seed).shuffle(batch)
                for d in batch:
                    r.observe_digest(dict(d))
                return [r.route(chips, generation=gen, locality=loc)
                        for chips, gen, loc in stream]

            base = decisions(0)
            assert all(decisions(s) == base for s in range(1, 6))
            return base
        base = both(run)
        assert any(d is not None for d in base)

    def test_stale_echo_never_regresses_the_held_view(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a"], now=Clock(t=0.0))
            out = [r.observe_digest(mk_digest(pkg, "a", 5, chips_free=32)),
                   r.observe_digest(mk_digest(pkg, "a", 4, chips_free=99)),
                   r.observe_digest(mk_digest(pkg, "a", 5, chips_free=99))]
            return out, r.cells["a"].digest["chips_free"]
        assert both(run) == ([True, False, False], 32)


class TestRouterSnapshot:
    def test_breaker_ledger_survives_the_json_round_trip(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a", "b"], now=Clock(t=50.0),
                                        failure_threshold=2)
            r.observe_digest(mk_digest(pkg, "a", 7, at=40.0))
            for _ in range(3):
                r.record_failure("b")
            r.route(4)
            snap = json.loads(json.dumps(r.snapshot(), sort_keys=True))
            r2 = pkg.router.GlobalRouter.restore(
                snap, ["a", "b"], now=Clock(t=50.0), failure_threshold=2)
            b, a = r2.cells["b"], r2.cells["a"]
            snap["cells"]["a"]["digest"]["headroom"] = {}
            snap["cells"]["a"]["booked_by_gen"] = {}
            return (snap, (b.state, b.probes, b.open_since),
                    (a.digest["seq"], a.booked), r2.route(4)["cell"])
        snap, b, a, cell = both(run)
        assert b == ("Open", 1, 50.0) and a == (7, 4) and cell == "a"

    def test_adopt_refuses_foreign_or_malformed_state(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["a"], now=Clock())
            return [r.adopt(s) for s in (None, {"cells": {}},
                                         {"v": 999, "cells": {}},
                                         {"v": 1, "cells": "nope"},
                                         {"v": 1, "cells": {}})]
        assert both(run) == [False, False, False, False, True]


class _Timeline:
    """The package's TIMELINE on a test clock, put back afterwards."""

    def __init__(self, pkg, clock):
        self.tl, self.clock = pkg.TIMELINE, clock

    def __enter__(self):
        self._prev = (self.tl.clock, self.tl.enabled)
        self.tl.reset(clock=self.clock, enabled=True)
        return self.tl

    def __exit__(self, *exc):
        self.tl.reset(clock=self._prev[0], enabled=self._prev[1])


class TestFederationReconciler:
    def test_unpinned_request_gets_routed_and_stamped(self):
        def run(pkg):
            clock = Clock(t=0.0)
            with _Timeline(pkg, clock) as tl:
                c = pkg.fake.FakeClient()
                r = pkg.router.GlobalRouter(["east", "west"], now=clock)
                r.observe_digest(mk_digest(pkg, "east", 1, chips_free=64))
                r.observe_digest(mk_digest(pkg, "west", 1, chips_free=8))
                c.create(pkg.sr.new_slice_request("train", {"chips": 16}))
                res = pkg.fc.FederationReconciler(c, r).reconcile(
                    pkg.Request(name="train", namespace="default"))
                live = c.get_or_none(pkg.sr.V1ALPHA1,
                                     pkg.sr.KIND_SLICE_REQUEST, "train",
                                     "default")
                routed = next(e for e in tl.timeline(
                    "SliceRequest", "default/train")
                    if e["event"] == "routed")
                return ((res.requeue, res.requeue_after),
                        live["metadata"]["annotations"][pkg.L.CELL_PIN],
                        routed)
        res, pin, routed = both(run)
        assert res == (False, 0.0) and pin == "east"
        assert any(c["origin"] == "cell/east" for c in routed["causes"])

    def test_pinned_request_is_left_alone(self):
        def run(pkg):
            c = pkg.fake.FakeClient()
            body = pkg.sr.new_slice_request("pinned", {"chips": 4})
            body["metadata"]["annotations"] = {pkg.L.CELL_PIN: "west"}
            c.create(body)
            r = pkg.router.GlobalRouter(["east", "west"], now=Clock())
            r.observe_digest(mk_digest(pkg, "east", 1))
            pkg.fc.FederationReconciler(c, r).reconcile(
                pkg.Request(name="pinned", namespace="default"))
            live = c.get_or_none(pkg.sr.V1ALPHA1,
                                 pkg.sr.KIND_SLICE_REQUEST, "pinned",
                                 "default")
            return (live["metadata"]["annotations"][pkg.L.CELL_PIN],
                    r.cells["east"].routed_total)
        assert both(run) == ("west", 0)

    def test_unroutable_request_requeues_on_the_retry_cadence(self):
        def run(pkg):
            c = pkg.fake.FakeClient()
            c.create(pkg.sr.new_slice_request("stuck", {"chips": 4}))
            r = pkg.router.GlobalRouter(["east"], now=Clock(),
                                        failure_threshold=1)
            r.record_failure("east")
            res = pkg.fc.FederationReconciler(c, r).reconcile(
                pkg.Request(name="stuck", namespace="default"))
            live = c.get_or_none(pkg.sr.V1ALPHA1,
                                 pkg.sr.KIND_SLICE_REQUEST, "stuck",
                                 "default")
            return (res.requeue_after,
                    pkg.L.CELL_PIN in (live["metadata"].get("annotations")
                                       or {}))
        assert both(run) == (rfc.ROUTE_RETRY_S, False)

    def test_a_pinned_product_routes_to_the_cell_with_its_headroom(self):
        """A request pinned to a ``gpu.product`` is routed by that card's
        generation's headroom — as a reference request pinned to a TPU
        accelerator is by its generation's."""
        def run(pkg):
            c = pkg.fake.FakeClient()
            pin = ("tpu-v5p-slice" if pkg.ref
                   else "NVIDIA-H100-80GB-HBM3")
            c.create(pkg.sr.new_slice_request(
                "pinned", {"chips": 8, "accelerator": pin}))
            r = pkg.router.GlobalRouter(["east", "west"], now=Clock())
            r.observe_digest(mk_digest(pkg, "east", 1, chips_free=64,
                                       headroom={pkg.other: 64}))
            r.observe_digest(mk_digest(pkg, "west", 1, chips_free=8,
                                       headroom={pkg.gen: 8}))
            pkg.fc.FederationReconciler(c, r).reconcile(
                pkg.Request(name="pinned", namespace="default"))
            live = c.get_or_none(pkg.sr.V1ALPHA1,
                                 pkg.sr.KIND_SLICE_REQUEST, "pinned",
                                 "default")
            return live["metadata"]["annotations"][pkg.L.CELL_PIN]
        assert both(run) == "west"

    def test_snapshot_hooks_are_the_routers(self):
        def run(pkg):
            r = pkg.router.GlobalRouter(["east"], now=Clock(),
                                        failure_threshold=1)
            r.record_failure("east")
            rec = pkg.fc.FederationReconciler(pkg.fake.FakeClient(), r)
            snap = rec.router_snapshot()
            r2 = pkg.router.GlobalRouter(["east"], now=Clock())
            rec2 = pkg.fc.FederationReconciler(pkg.fake.FakeClient(), r2)
            return snap, rec2.adopt_router_state(snap), \
                r2.cells["east"].state
        snap, adopted, state = both(run)
        assert adopted is True and state == "Open"


def test_cells_report_groups_by_pin():
    def run(pkg):
        c = pkg.fake.FakeClient()
        for name, pin in (("a1", "east"), ("a2", "east"), ("b1", "west"),
                          ("q1", None)):
            body = pkg.sr.new_slice_request(name, {"chips": 4})
            if pin:
                body["metadata"]["annotations"] = {pkg.L.CELL_PIN: pin}
            c.create(body)
        r = pkg.router.GlobalRouter(["east", "west"], now=Clock())
        return pkg.router.cells_report(c, "default", router=r)
    rep = both(run)
    assert sorted(rep["cells"]) == ["east", "west"]
    assert rep["cells"]["east"]["chips"] == 8
    assert [r["name"] for r in rep["unrouted"]] == ["q1"]
    assert rep["router"]["cells"]["east"]["state"] == "Healthy"


class TestCellsEndpoint:
    def _doc(self, controllers=()):
        import urllib.request

        from tpu_operator_torch.runtime.manager import Manager

        mgr = Manager(fake.FakeClient(), namespace="gpu-operator",
                      health_port=0)
        for rec in controllers:
            mgr.controllers.append(SimpleNamespace(
                reconciler=rec, start=lambda: None, stop=lambda: None))
        mgr.start()
        try:
            port = mgr._http.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/debug/cells",
                    timeout=10.0) as resp:
                return resp.status, json.loads(resp.read())
        finally:
            mgr.stop()

    def test_serves_the_federation_report(self):
        c = fake.FakeClient()
        body = sr.new_slice_request("a1", {"chips": 8})
        body["metadata"]["annotations"] = {L.CELL_PIN: "east"}
        c.create(body)
        rec = fc.FederationReconciler(
            c, router.GlobalRouter(["east"], now=Clock()))
        status, doc = self._doc([rec])
        assert status == 200
        assert doc == json.loads(json.dumps(rec.federation_report()))
        assert doc["cells"]["east"]["chips"] == 8
        assert doc["router"]["cells"]["east"]["state"] == "Healthy"

    def test_no_federation_plane_is_explicit_not_404(self):
        status, doc = self._doc()
        assert status == 200
        assert doc == {"cells": {}, "unrouted": [], "router": None}

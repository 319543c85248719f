"""The elastic-slice handshake in the port (``controllers/slices.py``'s
migration half, ``workloads/elastic.py``) against the JAX package's.

Each scenario of the reference's tests/test_elastic.py runs on both
packages' own FakeClient over a mapped fleet of two 2-host NVLink
domains (two ``mnnvl-4`` nodepools <-> two ``1x8`` TPU slices), driven
by a stepped clock: the migrator's intent, the workload's checkpoint and
ack, the rebind onto the other domain, the resume (phase by phase), the
deadline's hard drain, the opt-out, a restarted migrator, crashes that
lose only un-acked steps, and the shrink's direct shard handoff with its
fallbacks. Every step's statuses, annotations, leases and the shims'
steps agree under the naming rule. ``MemoryCheckpointStore`` and the
layout planner are held to the reference on the same inputs; the shim
over the port's ``DCPCheckpointStore`` (a real DCP checkpoint of a small
burn-in state) walks the whole handshake; and C7 (ROADMAP.md §C), the
reference's missing ``restore_shards`` on its real store, is pinned in
both packages."""

import pytest
import torch

import torch_placement_fleets as F
from tpu_operator.api import labels as RL
from tpu_operator.api import slicerequest as rsr
from tpu_operator.controllers import placement_controller as rpc
from tpu_operator.controllers import slices as rslices
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import Request as RRequest
from tpu_operator.workloads import elastic as rel
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api import slicerequest as sr
from tpu_operator_torch.controllers import placement_controller as pc
from tpu_operator_torch.controllers import slices
from tpu_operator_torch.runtime.fake import FakeClient
from tpu_operator_torch.runtime.manager import Request
from tpu_operator_torch.runtime.objects import (annotations_of, get_nested,
                                                set_nested, thaw_obj)
from tpu_operator_torch.workloads import burnin
from tpu_operator_torch.workloads import elastic as el
from tpu_operator_torch.workloads.checkpoint import TrainCheckpointer

FLEET = {"singles": 0, "slices": ("pool-a", "pool-b"), "hosts": 2}


class Side:
    def __init__(self, ref: bool):
        self.ref = ref
        self.mod, self.L = (rsr, RL) if ref else (sr, L)
        self.el = rel if ref else el
        self.c = RFake() if ref else FakeClient()
        F.add_nodes(self.c, ref, **FLEET)
        self.t = [100.0]
        self.clock = lambda: self.t[0]
        self.rec = (rpc if ref else pc).PlacementReconciler(
            client=self.c, namespace="default", now=self.clock)
        self.c.create(self.mod.new_slice_request(
            "job", {"chips": 8}, namespace="default"))
        self.reconcile()
        self.bound = list(get_nested(self.get(), "status", "nodes"))
        self.migrator = (rslices if ref else slices).SliceMigrator(
            self.c, now=self.clock)

    def reconcile(self):
        self.rec.reconcile((RRequest if self.ref else Request)(
            name="job", namespace="default"))

    def get(self):
        return self.c.get(self.mod.V1ALPHA1, self.mod.KIND_SLICE_REQUEST,
                          "job", "default")

    def shim(self, **kw):
        return self.el.ElasticWorkload(self.c, "job", "default",
                                       clock=self.clock, **kw)

    def shrink(self, chips=4):
        cr = thaw_obj(self.get())
        set_nested(cr, chips, "spec", "chips")
        self.c.update(cr)

    def state(self, wl=None):
        cr = self.get()
        leases = sorted((n["metadata"]["name"],
                         annotations_of(n).get(self.L.PLACED_BY))
                        for n in self.c.list("v1", "Node")
                        if annotations_of(n).get(self.L.PLACED_BY))
        return {"status": thaw_obj(cr.get("status") or {}),
                "annotations": {k.rpartition("/")[2]: v for k, v in
                                annotations_of(cr).items()},
                "leases": leases,
                "shim": None if wl is None else (wl.step, wl.max_acked,
                                                 wl.last_reshard)}


def port_words(tree):
    import torch_naming as N

    pools = {"v6e-1x8": "nvidia-gb200-mnnvl-4"}
    if isinstance(tree, dict):
        return {k: (pools.get(v, v) if k == "pool" else port_words(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(port_words(v) for v in tree)
    return N.name(tree) if isinstance(tree, str) else tree


def sc_full_walk(s):
    wl = s.shim()
    for _ in range(3):
        wl.tick()
        s.t[0] += 1
    yield s.migrator.ready_to_drain(s.bound, s.t[0] + 60), s.state(wl)
    wl.tick()
    yield s.state(wl)
    yield s.migrator.ready_to_drain(s.bound, s.t[0] + 60), s.state(wl)
    wl.tick()
    yield s.state(wl)
    wl.tick()
    yield s.state(wl)


def sc_timeout(s):
    deadline = s.t[0] + 60
    yield s.migrator.ready_to_drain(s.bound, deadline), s.state()
    s.t[0] = deadline + 1
    yield s.migrator.ready_to_drain(s.bound, deadline), s.state()
    # the placement controller's janitor leaves an aborted attempt be
    s.reconcile()
    yield s.state()


def sc_opt_out(s):
    s.c.patch(s.mod.V1ALPHA1, s.mod.KIND_SLICE_REQUEST, "job",
              {"metadata": {"annotations": {s.L.SLICE_ELASTIC: "false"}}},
              namespace="default")
    yield s.migrator.ready_to_drain(s.bound, s.t[0] + 60), s.state()


def sc_restarted_migrator(s):
    wl = s.shim()
    wl.tick()
    yield (s.migrator.ready_to_drain(s.bound, s.t[0] + 60),
           s.state(wl))
    wl.tick()
    fresh = (rslices if s.ref else slices).SliceMigrator(s.c, now=s.clock)
    yield fresh.ready_to_drain(s.bound, s.t[0] + 60), s.state(wl)


def sc_janitor_reaps_an_expired_attempt(s):
    wl = s.shim()
    wl.tick()
    yield s.migrator.ready_to_drain(s.bound, s.t[0] + 30), s.state(wl)
    s.t[0] += 31
    s.reconcile()
    yield s.state(wl)


def sc_crash_loses_only_unacked(s):
    wl = s.shim(checkpoint_every=6, steps_per_tick=3)
    for _ in range(4):
        wl.tick()
        s.t[0] += 1
    wl.crash(partial=True)
    wl.tick()
    yield wl.store.all_steps(), s.state(wl)
    wl.tick()
    yield s.state(wl)


def sc_crash_after_ack(s):
    wl = s.shim()
    wl.tick()
    s.migrator.ready_to_drain(s.bound, s.t[0] + 60)
    wl.tick()
    wl.step += wl.steps_per_tick
    wl.crash(partial=True)
    wl.tick()
    yield s.state(wl)


def _resize(s, wl):
    s.shrink()
    s.reconcile()
    s.t[0] += 1
    wl.tick()
    s.reconcile()


def sc_shrink_hands_shards_off(s):
    wl = s.shim(state_bytes=1 << 20)
    for _ in range(3):
        wl.tick()
        s.t[0] += 1
    _resize(s, wl)
    yield s.state(wl)
    wl.tick()
    yield s.state(wl)


def sc_crash_mid_handoff(s):
    wl = s.shim(state_bytes=1 << 20)
    for _ in range(3):
        wl.tick()
        s.t[0] += 1
    wl.arm_reshard_crash()
    _resize(s, wl)
    wl.tick()
    yield wl.store.latest_step(), s.state(wl)
    wl.tick()
    yield s.state(wl)


def sc_layout_mismatch(s):
    wl = s.shim()
    for _ in range(3):
        wl.tick()
        s.t[0] += 1
    wl.force_layout_mismatch()
    wl.tick()
    s.t[0] += 1
    _resize(s, wl)
    yield s.state(wl)
    wl.tick()
    yield s.state(wl)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_full_walk, sc_timeout, sc_opt_out, sc_restarted_migrator,
    sc_janitor_reaps_an_expired_attempt, sc_crash_loses_only_unacked,
    sc_crash_after_ack, sc_shrink_hands_shards_off, sc_crash_mid_handoff,
    sc_layout_mismatch)}


def run(name):
    want = port_words(list(SCENARIOS[name](Side(True))))
    got = list(SCENARIOS[name](Side(False)))
    return want, got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_handshake_agrees(name):
    want, got = run(name)
    assert got == want


def phases(step):
    return step["status"].get("migration", {}).get("phase")


def test_the_walk_is_what_it_is_named_for():
    _, got = run("full_walk")
    (ready1, s1), s2, (ready2, s3), s4, s5 = got
    assert (ready1, ready2) == (False, True)
    assert [phases(s) for s in (s1, s2, s3, s4)] == [
        "Migrating", "Checkpointed", "Rebound", "Resumed"]
    assert s1["annotations"]["slice-intent"] == "migrate"
    acked = s2["status"]["migration"]["ackedStep"]
    assert s2["annotations"]["slice-intent-ack"] == str(acked)
    assert not set(s3["status"]["nodes"]) & {"m-pool-a-0", "m-pool-a-1"}
    assert s3["leases"] == [(n, "default/job") for n in s3["status"]["nodes"]]
    assert s4["status"]["migration"]["restoredStep"] == acked
    assert s5["shim"][0] > acked
    _, got = run("timeout")
    assert got[1][0] is True and phases(got[1][1]) == "Aborted"
    assert got[1][1]["status"]["nodes"] == ["m-pool-a-0", "m-pool-a-1"]
    _, got = run("shrink_hands_shards_off")
    mig = got[1]["status"]["migration"]
    assert (phases(got[0]), mig["phase"]) == ("Resharding", "Resumed")
    assert mig["bytesMoved"] * 2 == 1 << 20


def test_memory_store_agrees():
    got, want = el.MemoryCheckpointStore(2), rel.MemoryCheckpointStore(2)
    layout = el.build_layout(["b", "a"], 1000, n_shards=5)
    assert layout == rel.build_layout(["b", "a"], 1000, n_shards=5)
    for store in (got, want):
        store.save(3, {"step": 3})
        store.save(6, {"step": 6}, layout=layout)
        store.save(9, {"step": 9}, partial=True)
        store.save(6, None, partial=True)
    assert got.all_steps() == want.all_steps() == [3, 6, 9]
    assert got.restore() == want.restore() == (6, {"step": 6})
    assert got.manifest(6) == want.manifest(6) == layout
    assert got.manifest(9) is want.manifest(9) is None
    assert got.restore_shards(6, ["0", "3"]) == want.restore_shards(
        6, ["0", "3"])
    with pytest.raises(FileNotFoundError):
        got.restore_shards(6, ["99"])
    got.save(12, {"step": 12})
    assert got.all_steps() == [6, 9, 12]


@pytest.mark.parametrize("hosts, new", [
    (["a", "b", "c", "d"], ["a", "b"]), (["a", "b"], ["a", "b", "c"]),
    (["a"], ["z"]), (["a", "b"], ["b", "a"])])
def test_layout_planner_agrees(hosts, new):
    layout = el.build_layout(hosts, 12345, n_shards=16)
    moved = el.rebalance_layout(layout, new)
    assert moved == rel.rebalance_layout(rel.build_layout(
        hosts, 12345, n_shards=16), new)
    assert el.plan_reshard(layout, moved) == rel.plan_reshard(layout, moved)
    skew = dict(moved, version=2)
    assert el.plan_reshard(layout, skew)["compatible"] is False
    assert el.plan_reshard(layout, skew) == rel.plan_reshard(layout, skew)


# --- the shim over the port's DCP store ------------------------------------

CFG = burnin.BurninConfig(vocab=64, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, seq_len=16, batch=4, dtype=torch.float32)


class Trainer:
    """A small burn-in trainer composed with the shim as a real job
    would: after each tick it runs the train steps the shim counted
    (``steps_per_tick`` a training tick, none on a restore tick), and the
    store's ``state_fn`` catches it up to the shim's step first, so a
    save holds the state of the step it is numbered."""

    def __init__(self, shim_fn, ckdir):
        self.step_fn, init_state, _ = burnin.make_train_step(
            None, CFG, device="cpu")
        self.state = init_state(0)
        self.losses = {}
        store = el.DCPCheckpointStore(
            TrainCheckpointer(ckdir), state_fn=self._caught_up,
            state_like_fn=lambda: self.state)
        self.shim = shim_fn(store)

    def _caught_up(self):
        while self.state.step < self.shim.step:
            batch = burnin.make_batch(CFG, None, self.state.step,
                                      device="cpu")
            self.state, loss = self.step_fn(self.state, batch)
            self.losses[self.state.step] = loss
        return self.state

    def tick(self):
        self.shim.tick()
        self._caught_up()


def test_the_shim_over_dcp_migrates_a_trainer(tmp_path):
    s = Side(False)
    first = Trainer(lambda store: s.shim(store=store, checkpoint_every=4,
                                         steps_per_tick=2), tmp_path)
    for _ in range(3):
        first.tick()
    assert not s.migrator.ready_to_drain(s.bound, s.t[0] + 60)
    first.tick()
    acked = get_nested(s.get(), "status", "migration", "ackedStep")
    assert acked == first.state.step == 8
    assert s.migrator.ready_to_drain(s.bound, s.t[0] + 60)
    assert phases({"status": thaw_obj(s.get()["status"])}) == "Rebound"
    # the old binding drains with its job; a new process on the new
    # binding starts from a fresh state and restores the ack
    second = Trainer(lambda store: s.shim(store=store, checkpoint_every=4,
                                          steps_per_tick=2), tmp_path)
    second.tick()
    mig = get_nested(s.get(), "status", "migration")
    assert (mig["phase"], mig["restoredStep"]) == ("Resumed", acked)
    assert second.state.step == second.shim.step == acked
    for _ in range(2):
        second.tick()
    # an uninterrupted run from the same seed: the same losses, exactly
    step_fn, init_state, _ = burnin.make_train_step(None, CFG, device="cpu")
    state = init_state(0)
    oracle = {}
    for i in range(12):
        state, oracle[i + 1] = step_fn(
            state, burnin.make_batch(CFG, None, i, device="cpu"))
    assert sorted(second.losses) == [9, 10, 11, 12]
    for step, loss in second.losses.items():
        assert torch.equal(loss, oracle[step]), step


class StubCheckpointer:
    """A checkpointer with one committed step and its layout manifest,
    and nothing more: enough for the stores' constructors and the shim's
    handoff planner, and no framework at all."""

    def __init__(self, layout):
        self.layout = layout

    def latest_step(self):
        return 6

    def read_manifest(self, step):
        return self.layout if step == 6 else None


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_c7_a_resharding_rebind_over_a_real_store_raises(ref):
    """C7, kept as the reference has it: with the sharded gate on, a
    Resharding rebind makes the shim plan a handoff and call
    ``store.restore_shards``, which only the in-memory store has: over
    the reference's ``OrbaxCheckpointStore`` and the port's
    ``DCPCheckpointStore`` the tick raises AttributeError, where the
    docstring promises a full-restore fallback on any mismatch."""
    mod, client = (rsr, RFake()) if ref else (sr, FakeClient())
    lib = rel if ref else el
    store_cls = lib.OrbaxCheckpointStore if ref else lib.DCPCheckpointStore
    assert lib.SHARDED_CKPT_GATE.enabled
    store = store_cls(StubCheckpointer(lib.build_layout(["a", "b"], 1 << 20)),
                      state_fn=lambda: None, state_like_fn=lambda: None)
    assert not hasattr(store, "restore_shards")
    cr = mod.new_slice_request("job", {"chips": 4}, namespace="default")
    cr["status"] = {"phase": mod.PHASE_PLACED, "nodes": ["a"],
                    "migration": {"phase": mod.MIG_RESHARDING}}
    client.create(cr)
    wl = lib.ElasticWorkload(client, "job", "default", store=store,
                             clock=lambda: 100.0)
    with pytest.raises(AttributeError, match="restore_shards"):
        wl.tick()


def sc_c8_progress_write_racing_the_intent(s):
    """The migrator posts its intent while a periodic save is between the
    shim's read of the request and its progress write; the write puts
    back the status it read, without ``status.migration``."""
    wl = s.shim(checkpoint_every=3, steps_per_tick=3)
    wl.tick()
    inner = wl.store.save
    posted = []

    def save_while_the_intent_lands(*args, **kwargs):
        if not posted:
            posted.append(s.migrator.ready_to_drain(s.bound, s.t[0] + 60))
        return inner(*args, **kwargs)

    wl.store.save = save_while_the_intent_lands
    wl.tick()
    yield posted, s.state(wl)
    for _ in range(3):
        wl.tick()
        yield s.migrator.ready_to_drain(s.bound, s.t[0] + 60), s.state(wl)
    s.t[0] += 61
    yield s.migrator.ready_to_drain(s.bound, s.t[0] - 1), s.state(wl)


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_c8_a_progress_write_racing_the_intent_erases_it(ref):
    """C8, kept as the reference has it: the shim's periodic progress
    write puts back the whole status it read, so an intent posted
    between that read and that write loses its ``status.migration``;
    the shim, which acks only a ``Migrating`` phase, never acks, and the
    attempt runs to its deadline and the hard drain. Both packages walk
    the same transcript."""
    got = list(sc_c8_progress_write_racing_the_intent(Side(ref)))
    (posted, raced), *waits, (last_ready, last) = got
    assert posted == [False]
    assert raced["annotations"]["slice-intent"] == "migrate"
    assert "migration" not in raced["status"]
    assert all(ready is False and wl["shim"][1] == -1
               for ready, wl in waits)
    assert last_ready is True and last["status"]["nodes"] == [
        "m-pool-a-0", "m-pool-a-1"]
    if not ref:
        want = port_words(list(sc_c8_progress_write_racing_the_intent(
            Side(True))))
        assert got == want

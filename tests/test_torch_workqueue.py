"""The port's workqueue against the JAX package's: the same seeded op
scripts (numpy) through both ``WorkQueue``s under one stepped clock give
the same items dequeued with their lanes, waits and causes, the same
coalesced counts, snapshots and lane depths; ``RateLimiter.when`` gives
the same delays; ``shard_of`` the same shards over the same keys; and a
``kill_shard`` transfer loses no key in either package and lands each key
on the same survivor."""

import types

import numpy as np
import pytest

from tpu_operator.runtime import FakeClient as RFake
from tpu_operator.runtime import manager as rmgr
from tpu_operator.runtime import workqueue as rwq
from tpu_operator_torch.runtime import manager as mgr
from tpu_operator_torch.runtime import workqueue as wq
from tpu_operator_torch.runtime.fake import FakeClient

KEYS = [f"k{i}" for i in range(6)]
LANE_CHOICES = (None, "health", "placement", "bulk", "nonsense")
OPS = ("add", "add", "add_after", "escalate", "get", "get", "done",
       "step", "rate", "forget")


class SteppedClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def script(seed: int, n: int = 120) -> list:
    """A seeded op script, as plain data both packages replay."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        op = OPS[rng.randint(len(OPS))]
        key = KEYS[rng.randint(len(KEYS))]
        lane = LANE_CHOICES[rng.randint(len(LANE_CHOICES))]
        cause = (f"r{rng.randint(3)}", f"o{rng.randint(2)}",
                 int(rng.randint(-1, 3)))
        delay = float(rng.choice([0.0, 0.25, 1.5]))
        ops.append((op, key, lane, cause, delay))
    return ops


def replay(mod, ops, monkeypatch) -> list:
    """Run ``ops`` through ``mod``'s WorkQueue; everything observable,
    causes as dicts."""
    clock = SteppedClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=clock, sleep=lambda s: None))
    coalesced = []
    q = mod.WorkQueue(mod.RateLimiter(0.1, 3.0),
                      on_coalesced=lambda: coalesced.append(1))
    held = []
    out = []
    for op, key, lane, (reason, origin, trace), delay in ops:
        cause = mod.Cause(reason=reason, origin=origin, trace_id=trace)
        if op == "add":
            out.append(("add", q.add(key, lane=lane, cause=cause)))
        elif op == "add_after":
            q.add_after(key, delay, lane=lane, cause=cause)
        elif op == "escalate":
            out.append(("escalate", q.escalate(key, cause=cause)))
        elif op == "get":
            item, waited, got_lane, causes = q.get_with_info(timeout=0)
            if item is not None:
                held.append(item)
            out.append(("get", item, round(waited, 9), got_lane,
                        [c.to_dict() for c in causes]))
        elif op == "done" and held:
            q.done(held.pop(0))
        elif op == "step":
            clock.t += delay
        elif op == "rate":
            q.add_rate_limited(key, lane=lane, cause=cause)
        elif op == "forget":
            q.forget(key)
        snap = q.snapshot()
        out.append(("state", snap.queued, tuple(sorted(snap.processing)),
                    tuple(sorted(snap.delayed)), q.lane_depths(), len(q),
                    q.coalesced_total, q.escalations_total))
    out.append(("coalesced", len(coalesced)))
    out.append(("drain", [(item, lane, [c.to_dict() for c in causes])
                          for item, lane, causes in q.drain_pending()]))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_op_scripts_agree(seed, monkeypatch):
    ops = script(seed)
    ref = replay(rwq, ops, monkeypatch)
    port = replay(wq, ops, monkeypatch)
    assert port == ref
    assert any(o[0] == "get" and o[1] is not None for o in port)


@pytest.mark.parametrize("seed", range(3))
def test_op_scripts_agree_with_lanes_off(seed, monkeypatch):
    monkeypatch.setattr(rwq.LANE_GATE, "enabled", False)
    monkeypatch.setattr(wq.LANE_GATE, "enabled", False)
    ops = script(100 + seed)
    ref = replay(rwq, ops, monkeypatch)
    assert replay(wq, ops, monkeypatch) == ref
    assert all(o[3] == "bulk" for o in ref if o[0] == "get" and o[1])


def test_frozen_queue_hands_out_nothing_and_keeps_adds(monkeypatch):
    res = []
    for mod in (rwq, wq):
        q = mod.WorkQueue()
        q.add("a", cause=mod.Cause("watch:ADDED"))
        q.freeze()
        got = q.get_with_info(timeout=0)
        q.add("b", lane="health")
        q.add_after("c", 5.0)
        res.append((got[0], [(i, lane, [c.to_dict() for c in cs])
                             for i, lane, cs in q.drain_pending()]))
    assert res[0] == res[1]
    assert res[1][0] is None and {i for i, _, _ in res[1][1]} == {"a", "b",
                                                                  "c"}


def test_causes_capped_at_max_causes():
    for mod in (rwq, wq):
        q = mod.WorkQueue()
        for i in range(mod.MAX_CAUSES + 5):
            q.add("k", cause=mod.Cause(f"r{i}"))
        _, _, _, causes = q.get_with_info(timeout=0)
        assert [c.reason for c in causes] == [f"r{i}" for i in
                                              range(mod.MAX_CAUSES)]
    assert wq.MAX_CAUSES == rwq.MAX_CAUSES == 8


def test_rate_limiter_delays_and_eviction_agree():
    rng = np.random.RandomState(7)
    keys = [f"key-{rng.randint(12)}" for _ in range(200)]
    forgets = rng.rand(200) < 0.1
    out = []
    for mod in (rwq, wq):
        rl = mod.RateLimiter(base=0.1, max_delay=3.0, max_tracked=5)
        seq = []
        for key, forget in zip(keys, forgets):
            if forget:
                rl.forget(key)
            seq.append((rl.when(key), rl.retries(key), rl.tracked()))
        out.append(seq)
    assert out[0] == out[1]
    assert max(d for d, _, _ in out[1]) == 3.0
    assert max(t for _, _, t in out[1]) == 5


def test_write_budget_unlimited_is_free():
    for mod in (rwq, wq):
        b = mod.WriteBudget(0)
        assert b.acquire() == 0.0 and b.throttled_seconds == 0.0
    assert wq.env_write_qps({"OPERATOR_WRITE_QPS": "2.5"}) == 2.5
    assert wq.env_write_qps({"OPERATOR_WRITE_QPS": "x"}) == 0.0
    assert wq.env_lanes_enabled({"OPERATOR_QUEUE_LANES": "off"}) is False


@pytest.mark.parametrize("shards", [[0, 1], [0, 1, 2, 3], [0, 2, 3], [5]])
def test_shard_of_agrees(shards):
    keys = [f"ns-{i}/obj-{i * 7}" for i in range(300)] + ["gpu-cluster-policy"]
    ref = [rmgr.shard_of(k, shards) for k in keys]
    assert [mgr.shard_of(k, shards) for k in keys] == ref
    assert set(ref) <= set(shards)


def test_env_shards_agree():
    for env in ({}, {"OPERATOR_SHARDS": "4"}, {"OPERATOR_SHARDS": "0"},
                {"OPERATOR_SHARDS": "x"}):
        assert mgr.env_shards(env) == rmgr.env_shards(env)


class _Idle:
    name = "idle"

    def reconcile(self, request):  # pragma: no cover - never started
        raise AssertionError("no worker runs in this test")


@pytest.mark.parametrize("dead", [0, 2])
def test_kill_shard_transfer_loses_no_key(dead):
    """Keys queued on the dead shard rehash onto survivors in both
    packages: the same count moved, every key still queued once, on the
    same survivor, with the failover cause appended."""
    placed = []
    for mod, fake in ((rmgr, RFake), (mgr, FakeClient)):
        ctrl = mod.Controller("idle", _Idle(), fake(), shards=3)
        reqs = [mod.Request(name=f"obj-{i}", namespace="ns")
                for i in range(40)]
        for i, req in enumerate(reqs):
            ctrl.enqueue(req, lane=("health" if i % 5 == 0 else None))
        before = {str(r) for q in ctrl.queues for r in q.snapshot().queued}
        moved = ctrl.kill_shard(dead)
        where = {}
        for i in ctrl.live_shards():
            snap = ctrl.queues[i].snapshot()
            for r in snap.queued:
                assert str(r) not in where, f"{r} queued twice"
                where[str(r)] = i
        assert set(where) == before == {str(r) for r in reqs}
        assert dead not in ctrl.live_shards()
        causes = {}
        for i in ctrl.live_shards():
            q = ctrl.queues[i]
            while True:
                item, _, lane, cs = q.get_with_info(timeout=0)
                if item is None:
                    break
                causes[str(item)] = [c.reason for c in cs]
        placed.append((moved, where, causes))
        for q in ctrl.queues:
            q.shutdown()
    assert placed[0] == placed[1]
    moved, _, causes = placed[1]
    assert moved > 0
    assert sum("failover-transfer" in cs for cs in causes.values()) >= moved - 1

"""The reference's property tier for the runtime (``tests/test_fuzz_runtime.py``,
11 properties) held on the port: the RFC 7386 ``merge_patch`` algebra
against the reference's independent diff oracle, ``FakeClient.patch``'s
bookkeeping (resourceVersion and generation bump only on a change, a
no-op publishes nothing), the rendezvous shard routing and the work
queue's lane discipline. Each drawn example also goes through the
reference, and the deterministic outputs are equal: the merged document,
the stored object's spec, resourceVersion and generation and the events
published, the shard of each key, the order a drain serves.

The reference's example counts and fixed seed; ``GPU_FUZZ_EXAMPLES``
raises the count."""

import copy
import os

from hypothesis import HealthCheck, given, settings, strategies as st

import torch_naming as N
from test_fuzz_runtime import (_ADD_SEQS, _DOCS, _PATCHES, _SHARD_KEYS,
                               rfc7386_diff)
from tpu_operator import runtime as rruntime
from tpu_operator.runtime import workqueue as rworkqueue
from tpu_operator.runtime.client import merge_patch as rmerge_patch
from tpu_operator_torch import runtime
from tpu_operator_torch.runtime import workqueue
from tpu_operator_torch.runtime.client import merge_patch

FUZZ = settings(
    max_examples=int(os.environ.get(N.FUZZ_ENV["TPU_FUZZ_EXAMPLES"], "80")),
    deadline=None, derandomize=True, database=None,
    suppress_health_check=[HealthCheck.too_slow])


class TestMergePatchAlgebra:
    @FUZZ
    @given(_DOCS, _DOCS)
    def test_diff_then_merge_is_identity(self, a, b):
        patch = rfc7386_diff(a, b)
        assert merge_patch(a, patch) == b == rmerge_patch(a, patch)

    @FUZZ
    @given(_DOCS, _PATCHES)
    def test_idempotent(self, base, patch):
        once = merge_patch(base, patch)
        assert merge_patch(once, patch) == once
        assert once == rmerge_patch(base, patch)

    @FUZZ
    @given(_DOCS)
    def test_empty_patch_is_identity(self, base):
        assert merge_patch(base, {}) == base == rmerge_patch(base, {})

    @FUZZ
    @given(_DOCS, _PATCHES)
    def test_no_nulls_survive(self, base, patch):
        def no_none(v):
            if isinstance(v, dict):
                return all(no_none(x) for x in v.values())
            return v is not None

        assert no_none(merge_patch(base, patch))

    @FUZZ
    @given(_DOCS, _PATCHES)
    def test_base_not_mutated(self, base, patch):
        snapshot = copy.deepcopy(base)
        merge_patch(base, patch)
        assert base == snapshot


def patched(mod, spec, patch):
    """Seed a ConfigMap in ``mod``'s FakeClient, watch it, patch its spec:
    (before, after, the event types published by the patch)."""
    c = mod.FakeClient()
    c.create({"apiVersion": "v1", "kind": "ConfigMap",
              "metadata": {"name": "x", "namespace": "default"},
              "data": {"k": "v"}, "spec": spec})
    events = []
    c.watch("v1", "ConfigMap", events.append)
    del events[:]  # the initial ADDED replay
    before = c.get("v1", "ConfigMap", "x", "default")
    after = c.patch("v1", "ConfigMap", "x", {"spec": patch}, "default")
    return before, after, [e.type for e in events]


def bookkeeping(before, after, events):
    meta_b, meta_a = before["metadata"], after["metadata"]
    return (after.get("spec"), meta_b["resourceVersion"],
            meta_a["resourceVersion"], meta_b.get("generation", 1),
            meta_a.get("generation", 1), events)


class TestFakeClientPatchBookkeeping:
    @FUZZ
    @given(_DOCS, _PATCHES)
    def test_patch_matches_merge_model(self, spec, patch):
        before, after, _ = patched(runtime, spec, patch)
        assert after.get("spec", {}) == merge_patch(before.get("spec", {}),
                                                    patch)
        ref = patched(rruntime, spec, patch)
        assert after.get("spec") == ref[1].get("spec")

    @FUZZ
    @given(_DOCS, _PATCHES)
    def test_rv_and_generation_rules(self, spec, patch):
        before, after, events = patched(runtime, spec, patch)
        ours = bookkeeping(before, after, events)
        _, rv_before, rv_after, gen_before, gen_after, _ = ours
        if after.get("spec") != before.get("spec"):
            assert rv_after != rv_before
            assert gen_after == gen_before + 1
            assert events == ["MODIFIED"]
        else:
            assert rv_after == rv_before
            assert gen_after == gen_before
            assert events == []
        assert ours == bookkeeping(*patched(rruntime, spec, patch))


class TestShardRoutingProperties:
    @FUZZ
    @given(_SHARD_KEYS, st.integers(2, 8))
    def test_rehash_moves_only_the_dead_shards_keys(self, keys, shards):
        live = list(range(shards))
        before = {k: runtime.shard_of(k, live) for k in keys}
        assert before == {k: rruntime.shard_of(k, live) for k in keys}
        for dead in range(shards):
            survivors = [s for s in live if s != dead]
            for k in keys:
                after = runtime.shard_of(k, survivors)
                if before[k] == dead:
                    assert after in survivors
                else:
                    assert after == before[k]

    @FUZZ
    @given(_SHARD_KEYS, st.integers(2, 8))
    def test_every_key_routes_to_exactly_one_live_shard(self, keys, shards):
        live = list(range(shards))
        for k in keys:
            s = runtime.shard_of(k, live)
            assert s in live
            assert runtime.shard_of(k, live) == s == rruntime.shard_of(k, live)


def drained(mod, seq):
    """Every (key, lane) a full drain of ``mod``'s WorkQueue serves, in
    order, after ``seq``'s adds."""
    q = mod.WorkQueue()
    for key, lane in seq:
        q.add(key, lane=lane)
    served = []
    while True:
        item, _, lane, _ = q.get_with_info(timeout=0)
        if item is None:
            return served
        served.append((item, lane))
        q.done(item)


def failover(mod, shard_of, seq):
    """Keys over three shard queues, the busiest killed (freeze, drain,
    requeue on the survivors): the keys queued after."""
    live = [0, 1, 2]
    queues = {s: mod.WorkQueue() for s in live}
    for key, lane in seq:
        queues[shard_of(key, live)].add(key, lane=lane)
    dead = max(live, key=lambda s: len(queues[s]))
    queues[dead].freeze()
    moved = queues[dead].drain_pending()
    survivors = [s for s in live if s != dead]
    for item, lane, causes in moved:
        queues[shard_of(item, survivors)].add(item, lane=lane, cause=causes)
    after = set()
    for s in survivors:
        after |= set(queues[s].snapshot().queued)
    return after


class TestLaneDisciplineProperties:
    @FUZZ
    @given(_ADD_SEQS)
    def test_drain_serves_each_key_once_in_lane_priority_order(self, seq):
        rank = {lane: i for i, lane in enumerate(workqueue.LANES)}
        served = drained(workqueue, seq)
        assert sorted(k for k, _ in served) == sorted({k for k, _ in seq})
        ranks = [rank[lane] for _, lane in served]
        assert ranks == sorted(ranks), (seq, served)
        assert workqueue.LANES == rworkqueue.LANES
        assert served == drained(rworkqueue, seq)

    @FUZZ
    @given(_ADD_SEQS)
    def test_shard_failover_drain_loses_no_key(self, seq):
        after = failover(workqueue, runtime.shard_of, seq)
        assert after == {k for k, _ in seq}
        assert after == failover(rworkqueue, rruntime.shard_of, seq)

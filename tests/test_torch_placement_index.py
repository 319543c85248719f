"""The port's incremental placement index (``topology/index.py``): its
answers are the rescan's by construction (both call the one
``_group_candidates``), and these tests hold them equal under seeded
interleavings of bookings, releases and node deltas (lease echoes,
cordons, relabels, removals, joins) on the port's pool mix; the port's
index against the JAX package's on fleets mapped one to one; and the
per-class usage, the trial board, the export/resync warm path and the
kill switch."""

import numpy as np
import pytest

import torch_placement_fleets as F
from tpu_operator.api.slicerequest import SliceRequestSpec as RSpec
from tpu_operator.topology import index as rindex
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.slicerequest import SliceRequestSpec
from tpu_operator_torch.benchmarks import controlplane as cp
from tpu_operator_torch.runtime.objects import thaw_obj
from tpu_operator_torch.topology import index as ix
from tpu_operator_torch.topology import placement as p

SPECS = [SliceRequestSpec(chips=c) for c in (4, 8, 16, 32)] + [
    SliceRequestSpec(chips=8, accelerator="NVIDIA-A100-SXM4-80GB"),
    SliceRequestSpec(chips=4, preferred_generations=["a100-sxm"]),
    SliceRequestSpec(chips=8, topology="mnnvl")]


def key(c):
    return None if c is None else (c.pool, c.slice_id, c.nodes, c.score,
                                   c.breakdown)


def rescan_best(nodes, spec):
    ranked = p.rank_candidates(spec, p.FleetState(list(nodes.values())))
    return ranked[0] if ranked else None


def lease(node, owner):
    node = thaw_obj(node)
    anns = node["metadata"].setdefault("annotations", {})
    if owner is None:
        anns.pop(L.PLACED_BY, None)
    else:
        anns[L.PLACED_BY] = owner
    return node


@pytest.mark.parametrize("seed", [0, 1])
def test_index_equals_the_rescan_under_churn(seed):
    rng = np.random.default_rng(seed)
    nodes = {n["metadata"]["name"]: thaw_obj(n)
             for n in cp.build_cluster(60).list("v1", "Node")}
    index = ix.FleetIndex(list(nodes.values()))
    live = []
    for step in range(70):
        op = rng.integers(0, 6)
        if op <= 1:  # place and book, with the lease echo
            spec = SPECS[int(rng.integers(0, len(SPECS)))]
            best = index.best(spec)
            if best is not None:
                owner = f"ns/r{step}"
                index.book(best.nodes, owner)
                for n in best.nodes:
                    nodes[n] = lease(nodes[n], owner)
                    index.apply("MODIFIED", nodes[n])
                live.append(owner)
        elif op == 2 and live:
            owner = live.pop(int(rng.integers(0, len(live))))
            held = index.owned_nodes(owner)
            index.release(owner=owner)
            for n in held:
                nodes[n] = lease(nodes[n], None)
                index.apply("MODIFIED", nodes[n])
        elif op == 3:  # cordon flip
            name = sorted(nodes)[int(rng.integers(0, len(nodes)))]
            node = thaw_obj(nodes[name])
            node["spec"]["unschedulable"] = not node["spec"].get(
                "unschedulable", False)
            nodes[name] = node
            index.apply("MODIFIED", node)
        elif op == 4:  # a node leaves, or a new one joins the GB200 pool
            if rng.random() < 0.5:
                name = sorted(nodes)[int(rng.integers(0, len(nodes)))]
                gone = nodes.pop(name)
                index.apply("DELETED", gone)
            else:
                c = cp.build_cluster(0)
                c.add_node(f"gb200-new-{step}", labels=cp._gpu_labels(
                    "nvidia-gb200", "NVIDIA-GB200", "mnnvl-4", 4),
                    allocatable={L.GPU_RESOURCE: "4"})
                node = thaw_obj(c.get("v1", "Node", f"gb200-new-{step}"))
                nodes[node["metadata"]["name"]] = node
                index.apply("ADDED", node)
        else:  # relabel into another pool's topology
            name = sorted(nodes)[int(rng.integers(0, len(nodes)))]
            node = thaw_obj(nodes[name])
            if L.GPU_TOPOLOGY in node["metadata"]["labels"]:
                node["metadata"]["labels"][L.GPU_TOPOLOGY] = "nvswitch-4"
                nodes[name] = node
                index.apply("MODIFIED", node)
        for spec in SPECS:
            assert key(index.best(spec)) == key(rescan_best(nodes, spec)), \
                (step, spec)
        fresh = p.FleetState(list(nodes.values()))
        assert index.chip_totals() == fresh.chip_totals()
        assert [c.nodes for c in index.rank(SPECS[1])] == \
            [c.nodes for c in p.rank_candidates(SPECS[1], fresh)]
        assert index.unschedulable_reason(SPECS[3]) == \
            p.unschedulable_reason(SPECS[3], fresh)


def test_index_agrees_with_the_reference_index():
    ref = rindex.FleetIndex(F.node_objects(True, slices=("pa", "pb", "pc")))
    port = ix.FleetIndex(F.node_objects(False, slices=("pa", "pb", "pc")))
    pairs = [(RSpec(chips=c), SliceRequestSpec(chips=c))
             for c in (4, 8, 12, 16)]
    for i in range(12):
        rspec, spec = pairs[i % len(pairs)]
        got, want = port.best(spec), ref.best(rspec)
        assert (got is None) == (want is None)
        if got is None:
            continue
        assert (got.nodes, got.score, got.breakdown) == \
            (want.nodes, want.score, want.breakdown)
        ref.book(want.nodes, f"r{i}")
        port.book(got.nodes, f"r{i}")
        if i % 3 == 2:
            ref.release(owner=f"r{i - 1}")
            port.release(owner=f"r{i - 1}")
    rs, ps = ref.index_stats(), port.index_stats()
    for k in ("nodes", "eligible_hosts", "pools", "domains", "leases",
              "owners", "spec_shapes"):
        assert ps[k] == rs[k], k
    assert ps["updates"] == rs["updates"]


def test_class_usage_folds_with_the_leases():
    index = ix.FleetIndex(cp.build_cluster(20).list("v1", "Node"))
    best = index.best(SliceRequestSpec(chips=8))
    index.book(best.nodes, "team-a/job")
    index.set_owner_class("team-a/job", "team-a")
    assert index.class_usage() == {"team-a": 8}
    from tpu_operator_torch.workloads.hardware import CHIPS

    assert index.class_tflops() == {
        "team-a": 8 * CHIPS[best.generation].peak_bf16_tflops}
    trial = index.snapshot_state()
    trial.release(owner="team-a/job")
    assert index.owned_nodes("team-a/job") == best.nodes
    assert not trial.owned_nodes("team-a/job")
    index.release(owner="team-a/job")
    assert index.class_usage() == {}


def test_export_rebuilds_and_resync_folds_the_delta():
    c = cp.build_cluster(40)
    index = ix.FleetIndex(c.list("v1", "Node"))
    index.best(SliceRequestSpec(chips=4))
    warm = ix.FleetIndex(index.export_nodes())
    node = thaw_obj(c.get("v1", "Node", "h100-nvswitch-8-0"))
    node["spec"]["unschedulable"] = True
    c.update(node)
    warm.resync(c.list("v1", "Node"))
    fresh = p.FleetState(c.list("v1", "Node"))
    for spec in SPECS:
        ranked = p.rank_candidates(spec, fresh)
        assert key(warm.best(spec)) == key(ranked[0] if ranked else None)
    assert warm.updates["resync"] == 1 and warm.updates["modified"] == 1
    stats = warm.digest_stats()
    assert stats["chips_placed"] == 0 and stats["condemned"] == 0
    assert stats["chips_free"] == sum(
        b["free"] for b in fresh.chip_totals().values())


@pytest.mark.parametrize("value, on", [("1", True), ("0", False),
                                       ("off", False), ("no", False),
                                       ("yes", True)])
def test_kill_switch_spellings(value, on):
    env = {"OPERATOR_PLACEMENT_INDEX": value}
    assert ix.env_placement_index_enabled(env) is on
    assert rindex.env_placement_index_enabled(env) is on

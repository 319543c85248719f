"""The rider's new parts (``benchmarks/controlplane.py``: placement,
placement at fleet scale, the elastic migration and the resize, the
snapshot-warm restart, fair-share admission) against the JAX package's
benchmarks. Each side's ``build_cluster`` is replaced by a fleet mapped
one to one (``torch_placement_fleets``: 4-card single hosts and 4-host
NVLink domains, one generation: TPU v5p <-> GB200, so the seeded pins and
preferences of the request stream land alike), and every figure that
does not depend on timing is the reference's: decisions, utilization,
index structure, migrations, stalls on the virtual clock, lost steps,
bytes moved, restored kinds, Jain's index. On the port's own pool mix
the claims hold: the elastic migration loses no acked step and stalls no
longer than kill-and-reschedule, the handoff moves fewer bytes than the
full path, warm and cold restarts decide alike (the packing claim is
``test_torch_placement.py``'s)."""

import pytest

import torch_placement_fleets as F
from tpu_operator.benchmarks import controlplane as rcp
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator_torch.benchmarks import controlplane as cp
from tpu_operator_torch.runtime.fake import FakeClient

GEN = ("tpu-v5p-slice", "nvidia-gb200", "NVIDIA-GB200")


def mapped_cluster(ref: bool):
    def build(n):
        c = RFake() if ref else FakeClient()
        n_slices = max(1, n // 8)
        F.add_nodes(c, ref, singles=n - 4 * n_slices,
                    slices=tuple(f"p{i:03d}" for i in range(n_slices)),
                    hosts=4, gen=GEN)
        for i in range(n // 10):
            c.add_node(f"cpu-{i}")
        return c
    return build


@pytest.fixture
def mapped(monkeypatch):
    monkeypatch.setattr(rcp, "build_cluster", mapped_cluster(True))
    monkeypatch.setattr(cp, "build_cluster", mapped_cluster(False))


def same(got, want, keys):
    want = {k.replace("tpu", "gpu"): v for k, v in want.items()}
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}


def test_placement_agrees(mapped):
    got = cp.run_placement_bench(64, n_requests=400, lifetime=80)
    want = rcp.run_placement_bench(64, n_requests=400, lifetime=80)
    same(got, want, ("n_gpu_nodes", "n_requests", "lifetime", "placed",
                     "unschedulable", "fleet_utilization",
                     "fleet_utilization_first_fit", "first_fit_placed"))


def test_placement_fleet_agrees(mapped):
    got = cp.run_placement_fleet_bench(256, baseline_gpu=64,
                                       n_requests=400, rescan_sample=5)
    want = rcp.run_placement_fleet_bench(256, baseline_tpu=64,
                                         n_requests=400, rescan_sample=5)
    same(got, want, ("n_gpu_nodes", "n_requests", "indexed_placed",
                     "indexed_unschedulable", "rescan_sample"))
    for k in ("domains", "pools", "eligible_hosts", "spec_shapes"):
        assert got["index_stats"][k] == want["index_stats"][k], k


def test_fairness_agrees(mapped):
    got = cp.run_fairness_bench(48)
    want = rcp.run_fairness_bench(48)
    same(got, want, ("n_gpu_nodes", "n_requests", "capacity_chips",
                     "policy", "fairness_jain_index",
                     "fairness_jain_baseline", "placed", "placed_baseline",
                     "throughput_vs_baseline", "attained_over_share",
                     "attained_over_share_baseline"))
    assert got["fairness_jain_index"] > got["fairness_jain_baseline"]


def test_migration_and_resize_agree(mapped):
    got = cp.run_migration_bench(24, n_requests=4)
    want = rcp.run_migration_bench(24, n_requests=4)
    same(got, want, ("n_gpu_nodes", "n_requests", "migrations",
                     "migrations_aborted", "migration_stalls", "kills",
                     "slice_migration_p50_s", "slice_migration_p95_s",
                     "kill_reschedule_p50_s", "kill_reschedule_p95_s",
                     "elastic_lost_steps", "kill_lost_steps", "resizes",
                     "resize_stalls", "resize_p50_s", "resize_p95_s",
                     "resize_full_p95_s", "resharded", "reshard_fallbacks",
                     "reshard_bytes_moved", "reshard_bytes_full"))
    assert got["elastic_lost_steps"] == 0 and got["migrations"] > 0


def test_restart_agrees(mapped):
    got = cp.run_restart_bench(64, delta_nodes=10)
    want = rcp.run_restart_bench(64, delta_nodes=10)
    same(got, want, ("n_gpu_nodes", "delta_nodes", "restored_kinds",
                     "decisions_agree"))
    assert got["decisions_agree"] is True
    assert got["restored_objects"] > 64


def test_the_claims_hold_on_the_pool_mix():
    mg = cp.run_migration_bench(60, n_requests=4)
    assert mg["elastic_lost_steps"] == 0
    assert mg["migrations_aborted"] == 0 and mg["migrations"] >= 4
    assert mg["slice_migration_p95_s"] <= mg["kill_reschedule_p95_s"]
    assert 0 < mg["reshard_bytes_moved"] < mg["reshard_bytes_full"]
    rs = cp.run_restart_bench(120, delta_nodes=10)
    assert rs["decisions_agree"] and rs["watch_resumes"] > 0
    assert rs["restored_kinds"] >= 10

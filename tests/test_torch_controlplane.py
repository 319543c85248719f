"""The port's control-plane benchmark against the JAX package's, at
small ``n``, each on its own package's fake apiserver. Timings are not
compared; what the operator asks of the apiserver and how the benchmark
ends are: the steady pass's requests by verb (O(states), and none once
the informer cache serves the reads), the state count and readiness,
the DAG plan's levels and critical path, the fleet's paged relist, and
``build_cluster``'s nodes, GPU nodes, pools and upgrade units against
the reference's mix under ``torch_naming.py``'s ``POOL_MIX``. The fleet
rollout is ``test_torch_rollout_bench.py``'s."""

import pytest

import torch_naming as N
from tpu_operator.benchmarks import controlplane as rcp
from tpu_operator.controllers.upgrade_controller import (
    UpgradeReconciler as RUpgradeReconciler)
from tpu_operator.state import nodepool as rnodepool
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.benchmarks import controlplane as cp
from tpu_operator_torch.controllers.upgrade_controller import (
    UpgradeReconciler)
from tpu_operator_torch.state import nodepool


def cluster_counts(ref: bool, n: int) -> dict:
    c = (rcp if ref else cp).build_cluster(n)
    nodes = c.list("v1", "Node")
    pools = (rnodepool if ref else nodepool).get_node_pools(nodes)
    rec = (RUpgradeReconciler if ref else UpgradeReconciler)(client=c)
    accel = "google.com/tpu" if ref else L.GPU_RESOURCE
    return {
        "nodes": len(nodes),
        "gpu_nodes": sum(1 for x in nodes
                         if accel in (x.get("status") or {}).get(
                             "allocatable", {})),
        "pools": len(pools),
        "multi_host_pools": sum(1 for p in pools if p.multi_host),
        "pool_sizes": sorted(len(p.nodes) for p in pools),
        "units": len(rec._upgrade_units(
            {x["metadata"]["name"]: x for x in nodes})),
    }


@pytest.mark.parametrize("n", [50, 137, 500])
def test_build_cluster_counts_agree(n):
    assert cluster_counts(False, n) == cluster_counts(True, n)


def test_pool_mix_follows_the_rule():
    assert cp.CPU_FRACTION == rcp.CPU_FRACTION
    assert cp.INSTALL_BUDGET_S == rcp.INSTALL_BUDGET_S
    assert len(cp.POOL_MIX) == len(rcp.POOL_MIX)
    for (accel, topo, chips, share), port in zip(rcp.POOL_MIX, cp.POOL_MIX):
        assert port[:4] == N.POOL_MIX[(accel, topo, chips)]
        assert port[4] == share
    multi = [row for row in cp.POOL_MIX
             if nodepool.NodePool(row[1], row[2]).multi_host]
    ref_multi = [row for row in rcp.POOL_MIX
                 if rnodepool.NodePool(row[0], row[1]).multi_host]
    assert len(multi) == len(ref_multi) == 1
    labels = cp.build_cluster(10).get("v1", "Node", "h100-nvswitch-8-0")[
        "metadata"]["labels"]
    assert labels == {L.GKE_ACCELERATOR: "nvidia-h100-80gb",
                      L.GKE_ACCELERATOR_COUNT: "8",
                      L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
                      L.GPU_TOPOLOGY: "nvswitch-8"}


SCALE_KEYS = ("n_states", "ready", "steady_requests", "steady_verbs",
              "steady_requests_cached", "steady_verbs_cached",
              "steady_cache_reads")


def test_scale_bench_requests_agree():
    ref = rcp.run_scale_bench(50)
    port = cp.run_scale_bench(50)
    assert port["n_gpu_nodes"] == ref["n_tpu_nodes"] == 50
    assert {k: port[k] for k in SCALE_KEYS} == \
        {k: ref[k] for k in SCALE_KEYS}
    assert port["ready"] and port["steady_requests_cached"] == 0
    assert set(port["steady_verbs"]) <= {"get", "list"}


def test_dag_plan_agrees():
    ref = rcp.run_dag_compare_bench(50, verb_latency_s=0.0)
    port = cp.run_dag_compare_bench(50, verb_latency_s=0.0)
    for k in ("n_states", "dag_levels", "ready"):
        assert port[k] == ref[k]
    assert port["critical_path"] == [N.name(s) for s in ref["critical_path"]]
    assert port["ready"]


def test_fleet_bench_relist_and_lanes_agree():
    ref = rcp.run_fleet_bench(200, baseline_tpu=50, churn_items=2000)
    port = cp.run_fleet_bench(200, baseline_gpu=50, churn_items=2000)
    for k in ("ready", "fleet_steady_verbs", "relist_pages", "lane_served",
              "lane_max_depth"):
        assert port[k] == ref[k], k
    assert port["ready"] and port["fleet_steady_verbs"] == {}


def test_lineage_bench_shape_agrees():
    ref = rcp.run_lineage_bench(2000, rounds=1)
    port = cp.run_lineage_bench(2000, rounds=1)
    assert set(port) == set(ref)
    assert (port["items"], port["rounds"]) == (ref["items"], ref["rounds"])
    assert port["lineage_overhead_ratio"] > 0

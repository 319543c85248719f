"""The port's fleet driver rollout (``run_rollout_bench``) against the
JAX package's at 100 nodes, polled and edge-triggered: one upgrade FSM
pass a kubelet tick, or the upgrade reconciler's own watch set draining
into a real ``Controller``'s queue. The passes, the reconciles and the
end (every GPU node ``done`` on the new driver revision) agree; the
reference gives 22 passes polled, 11 passes and 34 reconciles
edge-triggered. Timings are not compared."""

import pytest

from tpu_operator.benchmarks import controlplane as rcp
from tpu_operator_torch.benchmarks import controlplane as cp


@pytest.mark.parametrize("edge", [False, True], ids=["polled", "edge"])
def test_rollout_bench_agrees(edge):
    keys = ("passes", "reconciles", "rolled", "max_parallel",
            "edge_triggered")
    ref = rcp.run_rollout_bench(100, max_parallel=8, edge_triggered=edge)
    port = cp.run_rollout_bench(100, max_parallel=8, edge_triggered=edge)
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["rolled"]
    assert (port["passes"], port["reconciles"]) == (
        (11, 34) if edge else (22, 22))

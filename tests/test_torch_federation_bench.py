"""The federation benchmark (``benchmarks/controlplane.py``
``run_federation_bench``) against the JAX package's, at 3 cells of 100
nodes. Each side's ``build_cluster`` is a fleet mapped one to one
(``torch_placement_fleets``: 4-card single hosts and 4-host NVLink
domains of one generation, TPU v5p <-> GB200, the entry the seeded
request stream pins and prefers at the same index on both sides), so
every figure that does not depend on timing is the reference's: chips
placed flat and federated, unrouted and infeasible requests, and their
ratio. The rider's ``federation`` part and its knobs are the
reference's by ``torch_naming.BENCH_ENV``."""

import pytest

import torch_placement_fleets as F
from tpu_operator.benchmarks import controlplane as rcp
from tpu_operator.runtime import FakeClient as RFake
from tpu_operator_torch.benchmarks import controlplane as cp
from tpu_operator_torch.runtime.fake import FakeClient

GEN = ("tpu-v5p-slice", "nvidia-gb200", "NVIDIA-GB200")
DETERMINISTIC = ("n_cells", "nodes_per_cell", "n_requests",
                 "flat_placed_chips", "federated_placed_chips",
                 "federated_unrouted", "federated_infeasible",
                 "federation_quality_vs_flat")


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


@pytest.fixture(scope="module")
def both():
    mp = pytest.MonkeyPatch()
    mp.setattr(rcp, "build_cluster", mapped_cluster(True))
    mp.setattr(cp, "build_cluster", mapped_cluster(False))
    try:
        yield (rcp.run_federation_bench(n_cells=3, nodes_per_cell=100),
               cp.run_federation_bench(n_cells=3, nodes_per_cell=100))
    finally:
        mp.undo()


def test_keys_are_the_references(both):
    ref, port = both
    assert set(port) == set(ref)


@pytest.mark.parametrize("key", DETERMINISTIC)
def test_deterministic_figures_agree(both, key):
    ref, port = both
    assert port[key] == ref[key]


def test_federated_plane_places_most_of_what_the_flat_one_does(both):
    _, port = both
    assert port["federated_placed_chips"] > 0
    assert port["federation_quality_vs_flat"] >= 0.9
    assert port["federation_route_p99_ms"] > 0.0


def test_request_stream_pins_the_ports_products():
    """The stream pins the port mix's products and prefers its
    generations, entry by entry for the reference's draws."""
    assert cp.PINNED_PRODUCTS == ("NVIDIA-H100-80GB-HBM3", "NVIDIA-GB200",
                                  "NVIDIA-A100-SXM4-80GB")
    assert cp.PREFERRED_GENERATIONS == ("a100-sxm", "h100-sxm", "gb200")


def test_rider_part_and_knobs(monkeypatch):
    """The rider carries ``federation``, ``federation_route_p99_ms`` and
    ``federation_quality_vs_flat`` under GPUOP_BENCH_FEDERATION_CELLS and
    _NODES_PER_CELL, and GPUOP_BENCH_SKIP_FEDERATION drops all three."""
    from tpu_operator_torch import bench

    real = cp.run_federation_bench
    seen = {}

    def small(n_cells, nodes_per_cell):
        seen["args"] = (n_cells, nodes_per_cell)
        return real(n_cells=n_cells, nodes_per_cell=nodes_per_cell,
                    n_requests=200, lifetime=40)

    monkeypatch.setattr(cp, "run_federation_bench", small)
    for part in ("FLEET", "PLACEMENT_FLEET", "RESTART", "FAIRNESS",
                 "RESHARD", "TELEMETRY"):
        monkeypatch.setenv(f"GPUOP_BENCH_SKIP_{part}", "1")
    monkeypatch.delenv("GPUOP_BENCH_SKIP_SCALE", raising=False)
    monkeypatch.setenv("GPUOP_BENCH_SCALE_NODES", "8")
    monkeypatch.setenv("GPUOP_BENCH_FEDERATION_CELLS", "2")
    monkeypatch.setenv("GPUOP_BENCH_FEDERATION_NODES_PER_CELL", "40")
    for name in ("run_dag_compare_bench", "run_rollout_bench",
                 "run_concurrency_bench", "run_placement_bench",
                 "run_migration_bench", "run_lineage_bench"):
        monkeypatch.setattr(cp, name, lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("skipped")))
    doc = bench._controlplane_doc()
    assert seen["args"] == (2, 40)
    fed = doc["federation"]
    assert (fed["n_cells"], fed["nodes_per_cell"]) == (2, 40)
    assert doc["federation_quality_vs_flat"] == round(
        fed["federated_placed_chips"] / fed["flat_placed_chips"], 4)
    assert doc["federation_route_p99_ms"] > 0.0
    monkeypatch.setenv("GPUOP_BENCH_SKIP_FEDERATION", "1")
    doc = bench._controlplane_doc()
    assert not {"federation", "federation_route_p99_ms",
                "federation_quality_vs_flat"} & set(doc)

"""The fleet telemetry benchmark (``run_telemetry_bench``) and the
headline rider's ``telemetry`` part in the port against the JAX
package's, at test size (40 nodes, one ABBA round, fleets of 40 and 80
for the digest footprint). Its deterministic figures are equal: the
publishes a round, the rollup's domains, the goodput SLO's step counts
and verdict, and digest bytes a node flat across fleet sizes. The
digest bytes themselves differ by design: a port node's digest names
its cards ``gpu<i>`` and its generation by the hardware table, and the
mix's 8-card hosts grade eight cards."""

import pytest

import torch_naming as N
from tpu_operator.benchmarks import controlplane as rcp
from tpu_operator_torch.benchmarks import controlplane as cp

SIZE = dict(rounds=1, flat_baseline=40, flat_fleet=80)


@pytest.fixture(scope="module")
def both():
    return (rcp.run_telemetry_bench(40, **SIZE),
            cp.run_telemetry_bench(40, **SIZE))


def test_keys_follow_the_rule(both):
    ref, port = both
    assert set(port) == {N.BENCH_KEYS.get(k, k) for k in ref}
    assert port["n_gpu_nodes"] == ref["n_tpu_nodes"] == 40


@pytest.mark.parametrize("key", ["publishes_per_round", "rollup_domains",
                                 "goodput_slo", "rounds"])
def test_deterministic_figures_agree(both, key):
    ref, port = both
    assert port[key] == ref[key]


def test_goodput_slo_breaches_as_designed(both):
    _, port = both
    slo = port["goodput_slo"]
    assert slo["breached"] is True
    assert slo["degraded_steps"] > 0 and slo["good_steps"] > 0


def test_digest_bytes_are_flat(both):
    for side in both:
        assert side["digest_bytes_vs_baseline"] == pytest.approx(1.0,
                                                                 abs=0.01)
        assert side["rollup_bytes"]["fleet"] < 4 * side["rollup_bytes"][
            "baseline"]


def test_rider_part_and_knobs(monkeypatch):
    """The rider carries ``telemetry`` and ``telemetry_overhead_ratio``
    under GPUOP_BENCH_TELEMETRY_NODES, and GPUOP_BENCH_SKIP_TELEMETRY
    drops both, as the reference's TPUOP_ knobs do."""
    from tpu_operator_torch import bench

    real = cp.run_telemetry_bench
    monkeypatch.setattr(cp, "run_telemetry_bench",
                        lambda n: real(n, **SIZE))
    for part in ("SCALE", "FLEET", "PLACEMENT_FLEET", "RESTART",
                 "FAIRNESS", "RESHARD", "FEDERATION"):
        monkeypatch.setenv(f"GPUOP_BENCH_SKIP_{part}", "1")
    monkeypatch.delenv("GPUOP_BENCH_SKIP_SCALE")
    monkeypatch.setenv("GPUOP_BENCH_SCALE_NODES", "8")
    monkeypatch.setenv("GPUOP_BENCH_TELEMETRY_NODES", "24")
    for name in ("run_dag_compare_bench", "run_rollout_bench",
                 "run_concurrency_bench", "run_placement_bench",
                 "run_migration_bench", "run_lineage_bench"):
        monkeypatch.setattr(cp, name, lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("skipped")))
    doc = bench._controlplane_doc()
    assert doc["telemetry"]["n_gpu_nodes"] == 24
    assert doc["telemetry"]["goodput_slo_breached"] is True
    assert doc["telemetry_overhead_ratio"] == \
        doc["telemetry"]["overhead_ratio"]
    monkeypatch.setenv("GPUOP_BENCH_SKIP_TELEMETRY", "1")
    doc = bench._controlplane_doc()
    assert "telemetry" not in doc and "telemetry_overhead_ratio" not in doc

"""The port's headline bench (``python -m tpu_operator_torch.bench``)
against the repository's root ``bench.py``: its control-plane rider has
the reference rider's keys, less the parts whose benchmarks wait for
modules not ported, under ``torch_naming.py``'s ``BENCH_KEYS``, and the
same deterministic values at small ``n`` (each side's benchmarks shrunk
alike: no apiserver latency, a 60-node fleet over a 50-node baseline, a
2000-item lineage round). Without CUDA the port's bench prints one
``validator_bench_unavailable`` line and exits 1: it has no CPU
fallback. Its env knobs are the reference's by ``BENCH_ENV``."""

import functools
import json
import os
import pathlib
import subprocess
import sys

import bench as rbench
import torch_naming as N
from tpu_operator.benchmarks import controlplane as rcp
from tpu_operator_torch import bench
from tpu_operator_torch.benchmarks import controlplane as cp

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_NODES = 20
FLEET_NODES = 60
# the reference rider's parts whose benchmarks need modules not ported
# (placement, migration and resharding, fleet telemetry, restart,
# fairness, federation; ROADMAP.md §A items 3-6)
NOT_PORTED = {"placement", "placement_p99_ms", "fleet_utilization",
              "fleet_utilization_first_fit", "migration",
              "slice_migration_p95_s", "reshard", "resize_p95_s",
              "reshard_bytes_ratio", "placement_fleet",
              "placement_fleet_p99_ms", "placement_storm_rps", "telemetry",
              "telemetry_overhead_ratio", "restart",
              "restart_to_first_decision_warm_s", "warm_over_cold",
              "fairness", "fairness_jain_index", "saturation_drain_rps",
              "federation", "federation_route_p99_ms",
              "federation_quality_vs_flat"}


def shrink(monkeypatch, mod, baseline_kw):
    """The rider's benchmarks at test size, the same on both sides."""
    monkeypatch.setattr(mod, "run_dag_compare_bench", functools.partial(
        mod.run_dag_compare_bench, verb_latency_s=0.0))
    monkeypatch.setattr(mod, "run_lineage_bench", functools.partial(
        mod.run_lineage_bench, items=2000, rounds=1))
    monkeypatch.setattr(mod, "run_fleet_bench", functools.partial(
        mod.run_fleet_bench, churn_items=2000, **{baseline_kw: 50}))


def not_ported(*args, **kwargs):
    raise RuntimeError("not ported")


def riders(monkeypatch):
    shrink(monkeypatch, rcp, "baseline_tpu")
    shrink(monkeypatch, cp, "baseline_gpu")
    for name in ("run_placement_bench", "run_migration_bench"):
        monkeypatch.setattr(rcp, name, not_ported)
    for key, value in (("SCALE_NODES", str(N_NODES)),
                       ("FLEET_NODES", str(FLEET_NODES))):
        monkeypatch.setenv("TPUOP_BENCH_" + key, value)
        monkeypatch.setenv(N.BENCH_ENV["TPUOP_BENCH_" + key], value)
    for part in ("PLACEMENT_FLEET", "TELEMETRY", "RESTART", "FAIRNESS",
                 "FEDERATION", "RESHARD"):
        monkeypatch.setenv("TPUOP_BENCH_SKIP_" + part, "1")
    return rbench._controlplane_doc(), bench._controlplane_doc()


def keys(tree):
    """Every key path of a doc, the reference's by BENCH_KEYS."""
    out = set()
    for k, v in tree.items():
        k = N.BENCH_KEYS.get(k, k)
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{sub}" for sub in keys(v)}
    return out


def deterministic(doc):
    """The rider's values that do not depend on timing."""
    pick = {
        "": ("n_states", "ready", "steady_requests", "steady_verbs",
             "steady_requests_cached", "steady_verbs_cached",
             "steady_cache_reads", "steady_writes_avoided",
             "render_cache", "rollout_passes"),
        "rollout": ("passes", "rolled"),
        "rollout_edge": ("passes", "rolled", "reconciles"),
        "dag": ("verb_latency_ms", "ready", "dag_levels"),
        "fleet": ("baseline_nodes", "ready", "relist_pages"),
        "lineage": ("items", "rounds"),
    }
    out = {}
    for part, names in pick.items():
        src = doc[part] if part else doc
        for name in names:
            out[f"{part}.{name}"] = src[name]
        for name in ("n_tpu_nodes", "n_gpu_nodes"):
            if name in src:
                out[f"{part}.n_nodes"] = src[name]
    out["dag.critical_path"] = [N.name(s) for s in doc["dag"]["critical_path"]]
    out["workers"] = sorted(N.BENCH_KEYS.get(k, k) for k in doc["workers"])
    return out


def test_rider_agrees_with_the_reference(monkeypatch):
    ref, port = riders(monkeypatch)
    assert not any("error" in v for v in port.values() if isinstance(v, dict))
    assert keys(port) == {k for k in keys(ref)
                          if k.split(".")[0] not in NOT_PORTED}
    assert deterministic(port) == deterministic(ref)
    assert port["ready"] and port["steady_requests_cached"] == 0
    assert port["rollout"]["rolled"] and port["rollout_edge"]["rolled"]
    assert port["fleet"]["n_gpu_nodes"] == FLEET_NODES


def test_no_cuda_is_unavailable_and_exits_1():
    env = dict(os.environ, GPUOP_BENCH_SKIP_SCALE="1",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "tpu_operator_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {
        "metric": "validator_bench_unavailable", "value": 0.0,
        "unit": "none", "vs_baseline": 0.0}


def test_env_knobs_and_metrics_follow_the_rule():
    ref_src = (ROOT / "bench.py").read_text()
    port_src = pathlib.Path(bench.__file__).read_text()
    for ref_knob, knob in N.BENCH_ENV.items():
        assert f'"{ref_knob}"' in ref_src and f'"{knob}"' in port_src
    assert "TPUOP_" not in port_src
    for ref_metric, metric in N.BENCH_METRICS.items():
        assert f'"{ref_metric}"' in ref_src and f'"{metric}"' in port_src
    assert bench.BASELINE_FRACTION == rbench.BASELINE_FRACTION
    assert bench.HBM_BASELINE_FRACTION == rbench.HBM_BASELINE_FRACTION

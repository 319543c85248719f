"""The port's node-status exporter (tpu_operator_torch.validator.metrics)
against the JAX package's, case for case (the reference's
tests/test_validator.py exporter cases): the same barrier contents,
written under each package's names, give the same gauges under the
renames below. Both outputs are parsed with ``prometheus_client.parser``
and compared series by series."""

import threading
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

from tpu_operator.validator import barrier as jax_barrier
from tpu_operator.validator import metrics as jax_metrics
from tpu_operator_torch.validator import barrier, metrics

NODE = "node-0"
# reference gauge -> port gauge
GAUGE_RENAMES = {
    "tpu_operator_node_component_ready": "gpu_operator_node_component_ready",
    "tpu_operator_node_tpu_chips": "gpu_operator_node_gpus",
    "tpu_operator_node_revalidations_total":
        "gpu_operator_node_revalidations_total",
    "tpu_operator_node_driver_revalidation_ok":
        "gpu_operator_node_driver_revalidation_ok",
    "tpu_operator_node_matmul_mxu_utilization":
        "gpu_operator_node_matmul_tensor_core_utilization",
    "tpu_operator_node_ici_fraction_of_peak":
        "gpu_operator_node_nvlink_fraction_of_peak",
    "tpu_operator_node_hbm_fraction_of_peak":
        "gpu_operator_node_hbm_fraction_of_peak",
    "tpu_operator_node_collective_bus_gbps":
        "gpu_operator_node_collective_bus_gbps",
}
COMPONENT_RENAMES = {"jax": "cuda", "ici": "nvlink", "vtpu": "vgpu"}
STATUS_RENAMES = {"jax-ready": "cuda-ready", "ici-ready": "nvlink-ready",
                  "vtpu-ready": "vgpu-ready"}
KEY_RENAMES = {"MXU_UTILIZATION": "TENSOR_CORE_UTILIZATION"}


@pytest.fixture
def valdirs(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_VALIDATION_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("GPU_VALIDATION_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("TPU_FENCING_FILE", str(tmp_path / "no-fence"))
    monkeypatch.setenv("GPU_FENCING_FILE", str(tmp_path / "no-fence-port"))
    monkeypatch.setenv("TPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "4")
    return tmp_path


def write_both(name, info):
    """One barrier file, under each package's file and key names."""
    jax_barrier.write_status(name, info)
    barrier.write_status(STATUS_RENAMES.get(name, name),
                         {KEY_RENAMES.get(k, k): v for k, v in info.items()})


def series(text, renamed=False):
    """{(gauge, labels): value} of an exposition text; ``renamed`` maps
    the reference's names to the port's."""
    out = {}
    for family in text_string_to_metric_families(text):
        for s in family.samples:
            name, labels = s.name, dict(s.labels)
            if renamed:
                name = GAUGE_RENAMES[name]
                if "component" in labels:
                    labels["component"] = COMPONENT_RENAMES.get(
                        labels["component"], labels["component"])
            out[(name, tuple(sorted(labels.items())))] = s.value
    return out


def both(revalidate=False):
    """Collect once on each side; returns (reference's, port's) series,
    the reference's renamed. Kept objects let a case collect again."""
    ref, port = jax_metrics.NodeMetrics(NODE), metrics.NodeMetrics(NODE)
    ref.collect_once(revalidate=revalidate)
    port.collect_once(revalidate=revalidate)
    return ref, port


def compare(ref, port):
    want = series(ref.render().decode(), renamed=True)
    got = series(port.render().decode())
    assert got == want
    return got


def value(got, name, **labels):
    return got.get((name, tuple(sorted(dict(labels, node=NODE).items()))))


def test_serves_gauges(valdirs):
    """The reference's test_serves_gauges: the driver proof's card count
    and readiness over HTTP, /healthz 200."""
    from tpu_operator.validator.components import validate_driver
    from tpu_operator_torch.validator import components

    validate_driver()
    components.validate_driver()
    bodies = []
    for serve in (jax_metrics.serve, metrics.serve):
        stop = threading.Event()
        server = serve(0, node_name=NODE, poll_interval=0.05,
                       stop_event=stop)
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
                assert r.status == 200
                bodies.append(r.read().decode())
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                assert r.status == 200 and r.read() == b"ok"
        finally:
            stop.set()
            server.shutdown()
            server.server_close()
    got = series(bodies[1])
    assert got == series(bodies[0], renamed=True)
    assert value(got, "gpu_operator_node_gpus") == 4.0
    assert value(got, "gpu_operator_node_component_ready",
                 component="driver") == 1.0


def test_perf_figures_republished_as_gauges(valdirs):
    write_both("jax-ready", {"MXU_UTILIZATION": "0.942"})
    write_both("ici-ready", {"FRACTION_OF_PEAK": "0.85",
                             "SUITE_ALL_GATHER_BUS_GBPS": "123.40",
                             "SUITE_PPERMUTE_BUS_GBPS": "55.00"})
    write_both("hbm-ready", {"FRACTION_OF_PEAK": "0.91"})
    got = compare(*both())
    assert value(got, "gpu_operator_node_matmul_tensor_core_utilization") \
        == 0.942
    assert value(got, "gpu_operator_node_nvlink_fraction_of_peak") == 0.85
    assert value(got, "gpu_operator_node_collective_bus_gbps",
                 op="all_gather") == 123.4
    assert value(got, "gpu_operator_node_collective_bus_gbps",
                 op="ppermute") == 55.0
    assert value(got, "gpu_operator_node_hbm_fraction_of_peak") == 0.91
    for comp in ("cuda", "nvlink"):
        assert value(got, "gpu_operator_node_component_ready",
                     component=comp) == 1.0


def test_perf_gauges_absent_until_proofs_run(valdirs):
    got = compare(*both())
    names = {name for name, _ in got}
    for gauge in ("gpu_operator_node_matmul_tensor_core_utilization",
                  "gpu_operator_node_nvlink_fraction_of_peak",
                  "gpu_operator_node_hbm_fraction_of_peak",
                  "gpu_operator_node_collective_bus_gbps"):
        assert gauge not in names
    assert value(got, "gpu_operator_node_gpus") == 0.0
    assert {c: value(got, "gpu_operator_node_component_ready", component=c)
            for c in metrics.COMPONENT_FILES} == dict.fromkeys(
                ("driver", "runtime", "cuda", "plugin", "nvlink"), 0.0)


def test_perf_gauges_cleared_when_barrier_file_goes(valdirs):
    write_both("jax-ready", {"MXU_UTILIZATION": "0.95"})
    write_both("ici-ready", {"FRACTION_OF_PEAK": "0.86",
                             "SUITE_PPERMUTE_BUS_GBPS": "55.00"})
    ref, port = both()
    got = compare(ref, port)
    assert value(got, "gpu_operator_node_matmul_tensor_core_utilization") \
        == 0.95
    jax_barrier.cleanup_all()  # the validator's preStop
    barrier.cleanup_all()
    ref.collect_once()
    port.collect_once()
    got = compare(ref, port)
    names = {name for name, _ in got}
    assert "gpu_operator_node_matmul_tensor_core_utilization" not in names
    assert "gpu_operator_node_nvlink_fraction_of_peak" not in names
    assert "gpu_operator_node_collective_bus_gbps" not in names


def test_suite_gauges_cleared_when_suite_disabled(valdirs):
    write_both("ici-ready", {"FRACTION_OF_PEAK": "0.86",
                             "SUITE_ALL_TO_ALL_BUS_GBPS": "44.10"})
    ref, port = both()
    got = compare(ref, port)
    assert value(got, "gpu_operator_node_collective_bus_gbps",
                 op="all_to_all") == 44.1
    # re-proven without the full suite: no SUITE_ keys any more
    write_both("ici-ready", {"FRACTION_OF_PEAK": "0.85"})
    ref.collect_once()
    port.collect_once()
    got = compare(ref, port)
    assert value(got, "gpu_operator_node_collective_bus_gbps",
                 op="all_to_all") is None
    assert value(got, "gpu_operator_node_nvlink_fraction_of_peak") == 0.85


@pytest.mark.parametrize("chips, ok", [("4", 1.0), (None, 0.0)],
                         ids=["driver-present", "driver-gone"])
def test_driver_revalidation(valdirs, monkeypatch, tmp_path, chips, ok):
    """The periodic driver re-proof counts its attempts and reports its
    outcome; a failed re-proof leaves the barrier file alone."""
    write_both("driver-ready", {"CHIP_COUNT": "4", "SOURCE": "fake"})
    if chips is None:
        for k in ("TPU_FAKE_CHIPS", "GPU_FAKE_CHIPS"):
            monkeypatch.delenv(k)
        # no nvidia-smi, no device node, no sysfs tree: nothing to find
        monkeypatch.setenv("NVIDIA_SMI_BIN", str(tmp_path / "no-smi"))
        monkeypatch.setenv("TPU_SYSFS_ROOT", str(tmp_path / "no-sysfs"))
        from tpu_operator.validator import components as jax_components
        from tpu_operator_torch.validator import components

        monkeypatch.setattr(components, "CARD_NODE_GLOB",
                            str(tmp_path / "nvidia[0-9]*"))
        monkeypatch.setattr(jax_components, "discover_chips",
                            lambda: {"count": 0, "source": "none",
                                     "devices": []})
    ref, port = both(revalidate=True)
    ref.collect_once(revalidate=True)
    port.collect_once(revalidate=True)
    got = compare(ref, port)
    assert value(got, "gpu_operator_node_revalidations_total") == 2.0
    assert value(got, "gpu_operator_node_driver_revalidation_ok") == ok
    assert barrier.is_ready("driver-ready")


def test_unparseable_figure_is_removed(valdirs):
    write_both("hbm-ready", {"FRACTION_OF_PEAK": "0.9"})
    ref, port = both()
    write_both("hbm-ready", {"FRACTION_OF_PEAK": "n/a"})
    ref.collect_once()
    port.collect_once()
    got = compare(ref, port)
    assert value(got, "gpu_operator_node_hbm_fraction_of_peak") is None


def test_set_or_remove_on_a_series_never_published():
    m = metrics.NodeMetrics(NODE)
    metrics.set_or_remove(m.hbm_fraction, None, (NODE,))  # no KeyError
    metrics.set_or_remove(m.hbm_fraction, 0.5, (NODE,))
    assert value(series(m.render().decode()),
                 "gpu_operator_node_hbm_fraction_of_peak") == 0.5


@pytest.mark.parametrize("plane", ["fence-published", "fencing-proved",
                                   "absent"])
def test_isolated_plane_gauges(valdirs, plane):
    """The fencing and vgpu readiness series are served only where the
    isolated plane runs: a fence published, or its proof passed."""
    import json

    if plane == "fence-published":
        for name in ("no-fence", "no-fence-port"):
            (valdirs / name).write_text(json.dumps({"fenced": ["x"]}))
        write_both("vtpu-ready", {"PROFILE": "v"})
    elif plane == "fencing-proved":
        write_both("fencing-ready", {"FENCED": "x"})
    got = compare(*both())
    ready = {c: value(got, "gpu_operator_node_component_ready",
                      component=c)
             for c in metrics.ISOLATION_COMPONENT_FILES}
    assert ready == {"fence-published": {"fencing": 0.0, "vgpu": 1.0},
                     "fencing-proved": {"fencing": 1.0, "vgpu": 0.0},
                     "absent": {"fencing": None, "vgpu": None}}[plane]

"""The port's multi-node backend against the JAX package's: the env
contract (GPU_* and torchrun's in place of TPU_* and MEGASCALE_*), the
rank layouts of the slice-aware meshes held to JAX's ``mesh.devices`` ids
on the 8 CPU devices under the same two-slice split, and the DCN proof
(``validate_dcn``) case for case, with the bandwidth probe stubbed; one
gloo spawn runs the probe over two fake slices of two ranks."""

import socket
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tpu_operator.parallel import mesh as jax_mesh
from tpu_operator.parallel import multihost as jax_mh
from tpu_operator.validator import barrier as jax_barrier
from tpu_operator.validator import components as jax_components
from tpu_operator_torch.parallel import mesh, multihost
from tpu_operator_torch.parallel.multihost import DistributedConfig
from tpu_operator_torch.validator import barrier, components
from tpu_operator_torch.validator.components import ValidationFailed

N = 8


def two_slices_jax(d) -> int:
    return 0 if d.id < N // 2 else 1


def two_slices(rank) -> int:
    return 0 if rank < N // 2 else 1


def ids(jmesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jmesh.devices)


class TestDistributedConfig:
    def test_framework_contract_wins(self):
        cfg = DistributedConfig.from_env({
            "GPU_COORDINATOR_ADDRESS": "10.0.0.1:8476",
            "GPU_NUM_PROCESSES": "4",
            "GPU_PROCESS_ID": "2",
            "MASTER_ADDR": "ignored",
        })
        assert cfg.coordinator_address == "10.0.0.1:8476"
        assert cfg.num_processes == 4
        assert cfg.process_id == 2
        assert cfg.multi_process

    def test_torchrun_env_resolves_to_auto_topology(self):
        # torchrun's env names the rendezvous; the launcher, not the node,
        # knows the process topology, so the group joins through env://
        cfg = DistributedConfig.from_env({
            "MASTER_ADDR": "coord", "MASTER_PORT": "29500",
            "GPU_NUM_NODES": "2", "GROUP_RANK": "1",
        })
        assert cfg.auto
        assert cfg.multi_process
        assert cfg.coordinator_address is None

    def test_worker_id_fallback_for_process_id(self):
        cfg = DistributedConfig.from_env({
            "GPU_COORDINATOR_ADDRESS": "c:1",
            "GPU_NUM_PROCESSES": "2",
            "GPU_WORKER_ID": "1",
        })
        assert cfg.process_id == 1

    def test_default_single_process(self):
        cfg = DistributedConfig.from_env({})
        assert not cfg.multi_process
        assert cfg.coordinator_address is None

    def test_field_names_are_the_jax_ones(self):
        assert list(DistributedConfig.__dataclass_fields__) == list(
            jax_mh.DistributedConfig.__dataclass_fields__)
        assert list(multihost.DCNProbeResult.__dataclass_fields__) == list(
            jax_mh.DCNProbeResult.__dataclass_fields__)

    @pytest.mark.parametrize("env, want", [
        ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "2",
          "TPU_WORKER_ID": "1"}, (1, 2, False)),
        ({"MEGASCALE_COORDINATOR_ADDRESS": "coord:8080"}, (0, 0, True)),
        ({}, (0, 1, False)),
    ])
    def test_env_mapping_resolves_as_jax_does(self, env, want):
        ref = jax_mh.DistributedConfig.from_env(env)
        renamed = {k.replace("TPU_", "GPU_")
                   .replace("MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR"): v
                   for k, v in env.items()}
        cfg = DistributedConfig.from_env(renamed)
        assert (cfg.process_id, cfg.num_processes, cfg.auto) == want == (
            ref.process_id, ref.num_processes, ref.auto)


class TestInitialize:
    def test_single_process_is_a_noop(self, monkeypatch):
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **k: pytest.fail("joined a group"))
        cfg = multihost.initialize(DistributedConfig(None, 1, 0))
        assert not cfg.multi_process

    def test_a_joined_rank_does_not_join_again(self, monkeypatch):
        monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **k: pytest.fail("joined twice"))
        multihost.initialize(DistributedConfig("c:1", 2, 1))

    @pytest.mark.parametrize("cfg, method, extra", [
        (DistributedConfig("10.0.0.1:8476", 4, 2), "tcp://10.0.0.1:8476",
         {"world_size": 4, "rank": 2}),
        (DistributedConfig(None, 0, 0, auto=True), "env://", {}),
    ])
    def test_joins_over_gloo_on_the_cpu(self, monkeypatch, cfg, method,
                                        extra):
        calls = []
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **k: calls.append((a, k)))
        multihost.initialize(cfg)
        assert calls == [(("gloo",), dict(init_method=method, **extra))]


class TestLayouts:
    @pytest.mark.parametrize("n", range(1, 17))
    def test_factor_axes_matches_jax(self, n):
        assert mesh.factor_axes(n) == jax_mesh.factor_axes(n)

    @pytest.mark.parametrize("mp", [None, 1, 2, 4, 8])
    def test_build_mesh_layout_is_jax_build_mesh(self, mp):
        want = ids(jax_mesh.build_mesh(jax.devices()[:N], model_parallel=mp))
        np.testing.assert_array_equal(mesh.mesh_layout(range(N), mp), want)

    def test_indivisible_model_axis_rejected(self):
        with pytest.raises(ValueError, match="not divisible"):
            mesh.factor_axes(8, 3)

    def test_cpu_ranks_are_slice_zero(self):
        assert multihost.slice_id_of(0) == 0

    def test_group_rectangular(self):
        groups = multihost.group_by_slice(range(N), two_slices)
        want = jax_mh.group_by_slice(jax.devices()[:N], two_slices_jax)
        assert groups == [[d.id for d in g] for g in want]
        assert [len(g) for g in groups] == [4, 4]

    def test_ragged_grouping_rejected(self):
        ragged = lambda r: 0 if r == 0 else 1
        with pytest.raises(ValueError, match="not the same size"):
            multihost.group_by_slice(range(N), ragged)

    @pytest.mark.parametrize("mp", [None, 4])
    def test_hybrid_layout_is_jax_hybrid_mesh(self, mp):
        jm = jax_mh.hybrid_mesh(jax.devices()[:N], model_parallel=mp,
                                slice_getter=two_slices_jax)
        got = multihost.hybrid_layout(range(N), mp, two_slices)
        np.testing.assert_array_equal(got, ids(jm))
        assert got.shape == tuple(jm.shape.values())
        # each slice's ranks stay inside one dcn index
        for s in range(2):
            assert {two_slices(r) for r in got[s].flatten()} == {s}

    @pytest.mark.parametrize("mp", [None, 2, 4])
    def test_training_layout_is_jax_training_mesh(self, mp):
        jm = jax_mh.training_mesh(jax.devices()[:N], model_parallel=mp,
                                  slice_getter=two_slices_jax)
        got = multihost.training_layout(range(N), mp, two_slices)
        np.testing.assert_array_equal(got, ids(jm))
        for row in got:  # every model group inside one slice
            assert len({two_slices(r) for r in row}) == 1

    def test_training_layout_rejects_model_axis_across_dcn(self):
        with pytest.raises(ValueError, match="must not cross the DCN"):
            multihost.training_layout(range(N), 8, two_slices)

    def test_fake_slice_getter_matches_jax(self):
        devs = jax.devices()[:N]
        jget = jax_mh.fake_slice_getter(devs, 4)
        get = multihost.fake_slice_getter(list(range(N)), 4)
        assert [get(r) for r in range(N)] == [jget(d) for d in devs]
        with pytest.raises(ValueError, match="exceed"):
            multihost.fake_slice_getter([0], 2)

    def test_probe_rejects_a_single_slice(self):
        # refused from the layout, before any group is needed
        with pytest.raises(ValueError, match="single slice"):
            multihost.dcn_allreduce_probe(size_mb=0.1, ranks=range(N))


def test_probe_on_two_fake_slices_of_two_ranks():
    res = multihost.fake_slices_probe(2, device="cpu", world_size=4,
                                      size_mb=0.01, iters=2, repeats=1)
    assert res.correct and res.slices == 2 and res.devices_per_slice == 2
    assert res.bus_bw_gbps > 0 and res.device_kind == "cpu"


def test_fake_slices_probe_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.fake_slices_probe(2)


# --- the DCN proof ----------------------------------------------------------


@pytest.fixture
def valdir(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_VALIDATION_DIR", str(tmp_path / "port"))
    monkeypatch.setenv("TPU_VALIDATION_DIR", str(tmp_path / "jax"))
    for k in ("GPU_NUM_NODES", "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK",
              "MEGASCALE_NUM_SLICES", "MEGASCALE_COORDINATOR_ADDRESS",
              "MEGASCALE_SLICE_ID", "DCN_BANDWIDTH_PROBE",
              "DCN_PROBE_FAKE_SLICES", "DCN_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    return tmp_path


@pytest.fixture
def listener():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    threading.Thread(target=lambda: srv.accept(), daemon=True).start()
    yield srv.getsockname()[1]
    srv.close()


def two_nodes(monkeypatch, port, slice_id="1"):
    monkeypatch.setenv("GPU_NUM_NODES", "2")
    monkeypatch.setenv("GROUP_RANK", slice_id)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    monkeypatch.setenv("MEGASCALE_SLICE_ID", slice_id)
    monkeypatch.setenv("MEGASCALE_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")


def stub_probe(monkeypatch, bus_bw_gbps, correct=True):
    res = SimpleNamespace(correct=correct, slices=2, bus_bw_gbps=bus_bw_gbps,
                          algo_bw_gbps=bus_bw_gbps)
    for mod, name in ((multihost, "fake_slices_probe"),
                      (multihost, "dcn_allreduce_probe"),
                      (jax_mh, "dcn_allreduce_probe")):
        monkeypatch.setattr(mod, name, lambda *a, **kw: res)
    monkeypatch.setattr(multihost, "initialize", lambda *a, **k: None)
    monkeypatch.setenv("DCN_BANDWIDTH_PROBE", "true")


def test_dcn_skipped_single_node(valdir):
    info = components.validate_dcn()
    ref = jax_components.validate_dcn()
    assert "SKIPPED" in info and set(info) == set(ref)
    assert info["NUM_SLICES"] == ref["NUM_SLICES"] == "1"
    assert barrier.is_ready("dcn-ready")


def test_dcn_reaches_the_rendezvous(valdir, monkeypatch, listener):
    two_nodes(monkeypatch, listener)
    info = components.validate_dcn()
    ref = jax_components.validate_dcn()
    assert set(info) == set(ref) == {"COORDINATOR", "NUM_SLICES",
                                     "SLICE_ID", "RTT_MS"}
    assert info["COORDINATOR"] == f"127.0.0.1:{listener}"
    assert info["NUM_SLICES"] == "2" and info["SLICE_ID"] == "1"
    assert float(info["RTT_MS"]) >= 0
    assert barrier.read_status("dcn-ready") == info
    assert jax_barrier.is_ready("dcn-ready")


def test_dcn_unreachable_fails(valdir, monkeypatch):
    # an ephemeral port bound and closed: connects get ECONNREFUSED
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    two_nodes(monkeypatch, port)
    with pytest.raises(ValidationFailed, match="unreachable over DCN"):
        components.validate_dcn(timeout=2.0)
    assert not barrier.is_ready("dcn-ready")


def test_dcn_default_port_is_torchruns(valdir, monkeypatch):
    monkeypatch.setenv("GPU_NUM_NODES", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setattr(components.time, "sleep", lambda s: None)
    with pytest.raises(ValidationFailed, match="127.0.0.1:29500"):
        components.validate_dcn(timeout=0.01)


@pytest.mark.parametrize("threshold, bus, passes", [
    ("10", 3.5, False), ("10", 25.0, True), ("", 0.01, True)])
def test_dcn_threshold(valdir, monkeypatch, listener, threshold, bus,
                       passes):
    """DCN_THRESHOLD (absolute bus GB/s): a measured figure below it fails
    the proof; unset, any figure passes — reachability plus correct data
    is the base contract. The JAX proof decides the same."""
    two_nodes(monkeypatch, listener)
    if threshold:
        monkeypatch.setenv("DCN_THRESHOLD", threshold)
    stub_probe(monkeypatch, bus)
    if passes:
        info = components.validate_dcn(timeout=5)
        ref = jax_components.validate_dcn(timeout=5)
        assert info["DCN_BUS_GBPS"] == ref["DCN_BUS_GBPS"] == f"{bus:.2f}"
        assert info["DCN_SLICES"] == "2" and set(info) == set(ref)
        assert barrier.is_ready("dcn-ready")
    else:
        with pytest.raises(ValidationFailed, match="DCN_THRESHOLD"):
            components.validate_dcn(timeout=5)
        with pytest.raises(jax_components.ValidationFailed,
                           match="DCN_THRESHOLD"):
            jax_components.validate_dcn(timeout=5)
        assert not barrier.is_ready("dcn-ready")


def test_dcn_probe_with_wrong_data_fails(valdir, monkeypatch, listener):
    two_nodes(monkeypatch, listener)
    stub_probe(monkeypatch, 25.0, correct=False)
    with pytest.raises(ValidationFailed, match="wrong values"):
        components.validate_dcn(timeout=5)
    assert not barrier.is_ready("dcn-ready")


def test_dcn_probe_that_cannot_run_leaves_the_verdict(valdir, monkeypatch,
                                                      listener):
    # fake slices over this host's cards: there is no card here, so the
    # probe cannot run; the error is recorded and reachability stands
    two_nodes(monkeypatch, listener)
    monkeypatch.setenv("DCN_BANDWIDTH_PROBE", "true")
    monkeypatch.setenv("DCN_PROBE_FAKE_SLICES", "2")
    info = components.validate_dcn(timeout=5)
    assert "CUDA is not available" in info["DCN_PROBE_ERROR"]
    assert "DCN_BUS_GBPS" not in info and "RTT_MS" in info
    assert barrier.is_ready("dcn-ready")

"""Validation chain of the port (tpu_operator_torch.validator) on the CPU:
the proofs run with the CPU opt-in and fake cards, and their barrier files
are held to the JAX package's, key for key."""

import os

import jax
import pytest

from tpu_operator.validator import barrier as jax_barrier
from tpu_operator.validator import components as jax_components
from tpu_operator.workloads import collectives as jax_collectives
from tpu_operator_torch.cli import validator as cli
from tpu_operator_torch.validator import barrier, components
from tpu_operator_torch.validator.components import ValidationFailed
from tpu_operator_torch.workloads import collectives, hbm_probe, matmul

# barrier files and info keys the port renames; every other key is shared
STATUS_RENAMES = {"jax-ready": "cuda-ready", "ici-ready": "nvlink-ready"}
KEY_RENAMES = {"MXU_UTILIZATION": "TENSOR_CORE_UTILIZATION"}
CHAIN = ("driver", "runtime", "cuda", "hbm", "nvlink", "dcn")
# the files the in-process chain writes: every known one but plugin-ready,
# which the plugin pod's proof writes
CHAIN_FILES = ("driver-ready", "runtime-ready", "cuda-ready", "hbm-ready",
               "nvlink-ready", "dcn-ready")
SMALL = {"MATMUL_SIZE": "64", "HBM_SIZE_MB": "2"}


@pytest.fixture
def valdir(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_VALIDATION_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def cpu_chain_env(valdir, monkeypatch):
    monkeypatch.setenv("GPU_FAKE_CHIPS", "2")
    monkeypatch.setenv("GPU_VALIDATOR_ALLOW_CPU", "true")
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    # one node: the DCN proof is skipped, as the JAX one on one slice
    for k in ("GPU_NUM_NODES", "MASTER_ADDR", "MEGASCALE_NUM_SLICES",
              "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    return valdir


@pytest.fixture
def no_cards(tmp_path, monkeypatch):
    """A host with no nvidia-smi and no device nodes."""
    monkeypatch.setenv("NVIDIA_SMI_BIN", str(tmp_path / "no-nvidia-smi"))
    monkeypatch.setattr(components, "CARD_NODE_GLOB",
                        str(tmp_path / "nvidia[0-9]*"))


def _fake_smi(tmp_path, monkeypatch, rows):
    script = tmp_path / "nvidia-smi"
    script.write_text("#!/bin/sh\n" + "".join(f"echo '{r}'\n" for r in rows))
    script.chmod(0o755)
    monkeypatch.setenv("NVIDIA_SMI_BIN", str(script))


def _jax_chain_infos(tmp_path, monkeypatch):
    """The JAX package's chain on the CPU at the same sizes; the ICI proof
    sees one device, as the port's NVLink proof sees one card."""
    monkeypatch.setenv("TPU_VALIDATION_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("TPU_FAKE_CHIPS", "2")
    monkeypatch.setenv("TPU_VALIDATOR_ALLOW_CPU", "true")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jax_components.validate_driver()
    jax_components.validate_runtime()
    jax_components.validate_jax()
    jax_components.validate_hbm()
    jax_components.validate_ici()
    jax_components.validate_dcn()
    return {STATUS_RENAMES.get(name, name): jax_barrier.read_status(name)
            for name in ("driver-ready", "runtime-ready", "jax-ready",
                         "hbm-ready", "ici-ready", "dcn-ready")}


def _keys(info):
    return {KEY_RENAMES.get(k, k) for k in info}


def test_chain_writes_barriers_with_the_jax_keys(cpu_chain_env, tmp_path,
                                                 monkeypatch):
    for comp in CHAIN:
        getattr(components, f"validate_{comp}")()
    port = {name: barrier.read_status(name) for name in CHAIN_FILES}
    assert all(info is not None for info in port.values()), port
    assert port["nvlink-ready"]["SKIPPED"].startswith("single-card host")
    assert port["dcn-ready"]["SKIPPED"].startswith("single-node job")
    assert port["cuda-ready"]["MATMUL_SIZE"] == "64"
    assert port["hbm-ready"]["DEVICE_KIND"] == "cpu"
    assert hbm_probe.triad_.launches == 0  # the CPU runs the plain version
    ref = _jax_chain_infos(tmp_path, monkeypatch)
    assert set(ref) == set(port)
    for name, info in ref.items():
        assert _keys(info) == _keys(port[name]), name


def test_cli_runs_the_chain_and_cleans_up(cpu_chain_env):
    for comp in CHAIN:
        assert cli.main(["-c", comp]) == 0, comp
    assert sorted(os.listdir(cpu_chain_env)) == sorted(CHAIN_FILES)
    barrier.write_status("plugin-ready", {"WORKLOAD_PHASE": "Succeeded"})
    assert cli.main(["cleanup"]) == 0
    assert os.listdir(cpu_chain_env) == []


@pytest.mark.parametrize("comp, status", [
    ("cuda", "cuda-ready"), ("hbm", "hbm-ready"), ("nvlink", "nvlink-ready")])
def test_proofs_refuse_the_cpu_without_opt_in(valdir, monkeypatch, comp,
                                              status):
    monkeypatch.delenv("GPU_VALIDATOR_ALLOW_CPU", raising=False)
    with pytest.raises(ValidationFailed, match="CUDA is not usable"):
        getattr(components, f"validate_{comp}")()
    assert not barrier.is_ready(status)
    assert cli.main(["-c", comp]) == 1


def test_explicit_allow_cpu_false_wins_over_env(valdir, monkeypatch):
    monkeypatch.setenv("GPU_VALIDATOR_ALLOW_CPU", "true")
    with pytest.raises(ValidationFailed, match="CUDA is not usable"):
        components.validate_hbm(allow_cpu=False)


class TestGates:
    @staticmethod
    def _hbm_result(fraction, correct=True):
        return hbm_probe.TriadResult(
            bytes_moved=1 << 30, seconds=0.01, bandwidth_gbps=2500.0,
            peak_hbm_gbps=3350.0, fraction_of_peak=fraction,
            device_kind="NVIDIA H100 80GB HBM3", correct=correct)

    @staticmethod
    def _link_result(fraction, correct=True, op="all_reduce"):
        return collectives.CollectiveResult(
            devices=8, bytes_per_device=1 << 28, seconds=0.1,
            algo_bw_gbps=200.0, bus_bw_gbps=fraction * 450.0,
            peak_ici_gbps=450.0, fraction_of_peak=fraction,
            device_kind="NVIDIA H100 80GB HBM3", correct=correct, op=op)

    def test_hbm_below_threshold_fails_and_writes_no_barrier(
            self, valdir, monkeypatch):
        monkeypatch.setattr(hbm_probe, "run",
                            lambda **kw: self._hbm_result(0.3))
        with pytest.raises(ValidationFailed, match="below the 50%"):
            components.validate_hbm(allow_cpu=True)
        assert not barrier.is_ready("hbm-ready")

    def test_hbm_above_threshold_passes(self, valdir, monkeypatch):
        monkeypatch.setattr(hbm_probe, "run",
                            lambda **kw: self._hbm_result(0.73))
        info = components.validate_hbm(allow_cpu=True)
        assert info["FRACTION_OF_PEAK"] == "0.730"
        assert barrier.read_status("hbm-ready") == info

    def test_hbm_threshold_from_env(self, valdir, monkeypatch):
        monkeypatch.setenv("HBM_THRESHOLD", "0.8")
        monkeypatch.setattr(hbm_probe, "run",
                            lambda **kw: self._hbm_result(0.73))
        with pytest.raises(ValidationFailed, match="below the 80%"):
            components.validate_hbm(allow_cpu=True)

    def test_hbm_incorrect_triad_fails(self, valdir, monkeypatch):
        monkeypatch.setattr(hbm_probe, "run",
                            lambda **kw: self._hbm_result(0.9, correct=False))
        with pytest.raises(ValidationFailed, match="wrong values"):
            components.validate_hbm(allow_cpu=True)
        assert not barrier.is_ready("hbm-ready")

    def test_cuda_checksum_failure_fails(self, valdir, monkeypatch):
        monkeypatch.setattr(matmul, "run", lambda **kw: matmul.MatmulResult(
            size=64, iters=8, calls=2, seconds=0.01, tflops=1.0,
            peak_tflops=989.0, utilization=0.001, device_kind="x",
            checksum_ok=False))
        with pytest.raises(ValidationFailed, match="non-finite"):
            components.validate_cuda(matmul_size=64, allow_cpu=True)
        assert not barrier.is_ready("cuda-ready")

    @pytest.mark.parametrize("fraction, correct, match", [
        (0.42, True, "below the 80%"),
        (0.95, False, "wrong values"),
    ])
    def test_nvlink_failures_write_no_barrier(self, valdir, monkeypatch,
                                              fraction, correct, match):
        monkeypatch.setattr(components, "_card_count", lambda dev: 8)
        monkeypatch.setattr(collectives, "run", lambda **kw: self._link_result(
            fraction, correct))
        with pytest.raises(ValidationFailed, match=match):
            components.validate_nvlink(allow_cpu=True)
        assert not barrier.is_ready("nvlink-ready")

    def test_nvlink_suite_keys_match_jax_ici(self, valdir, tmp_path,
                                             monkeypatch):
        monkeypatch.setenv("NVLINK_FULL_SUITE", "true")
        monkeypatch.setenv("ICI_FULL_SUITE", "true")
        monkeypatch.setenv("TPU_VALIDATION_DIR", str(tmp_path / "jax"))
        monkeypatch.setattr(components, "_card_count", lambda dev: 8)
        monkeypatch.setattr(collectives, "run",
                            lambda **kw: self._link_result(0.91))
        monkeypatch.setattr(collectives, "run_suite", lambda **kw: {
            op: self._link_result(0.9, op=op) for op in collectives._BUS_FACTOR})
        monkeypatch.setattr(jax_collectives, "run",
                            lambda **kw: self._link_result(0.91))
        monkeypatch.setattr(jax_collectives, "run_suite", lambda **kw: {
            op: self._link_result(0.9, op=op) for op in collectives._BUS_FACTOR})
        port = components.validate_nvlink(allow_cpu=True)
        ref = jax_components.validate_ici(allow_cpu=True)
        assert port == ref
        assert port["SUITE_PPERMUTE_BUS_GBPS"] == "405.00"
        assert barrier.read_status("nvlink-ready") == port


class TestDiscoveryAndNodes:
    def test_nvidia_smi_inventory(self, valdir, tmp_path, monkeypatch):
        _fake_smi(tmp_path, monkeypatch,
                  ["0, NVIDIA H100 80GB HBM3, GPU-aaaa",
                   "1, NVIDIA H100 80GB HBM3, GPU-bbbb"])
        info = components.validate_driver()
        assert info == {"CHIP_COUNT": "2", "SOURCE": "nvidia-smi",
                        "DEVICES": "GPU-aaaa,GPU-bbbb",
                        "DEVICE_KIND": "NVIDIA H100 80GB HBM3"}

    def test_no_cards_fails_driver(self, valdir, no_cards):
        with pytest.raises(ValidationFailed, match="no CUDA cards"):
            components.validate_driver()
        assert cli.main(["-c", "driver"]) == 1

    def test_runtime_needs_driver_ready(self, valdir, monkeypatch):
        monkeypatch.setenv("GPU_FAKE_CHIPS", "1")
        with pytest.raises(ValidationFailed, match="driver-ready gate"):
            components.validate_runtime()

    @pytest.mark.parametrize("cards, ctl, nodes, match", [
        (1, "/dev/null", "/dev/null", None),
        (2, "/dev/null", "/dev/null", "2 card\\(s\\) visible, 1 usable"),
        (1, "/dev/null", "REGULAR", "not a character device"),
        (1, "REGULAR", "/dev/null", "not a character device"),
        (1, "/dev/null", "MISSING", "0 usable"),
    ])
    def test_runtime_node_proof(self, valdir, tmp_path, monkeypatch, cards,
                                ctl, nodes, match):
        regular = tmp_path / "nvidia0"
        regular.write_text("")
        paths = {"REGULAR": str(regular), "MISSING": str(tmp_path / "gone*")}
        _fake_smi(tmp_path, monkeypatch,
                  [f"{i}, NVIDIA H100 80GB HBM3, GPU-{i}" for i in range(cards)])
        monkeypatch.setattr(components, "CONTROL_NODE", paths.get(ctl, ctl))
        monkeypatch.setattr(components, "CARD_NODE_GLOB",
                            paths.get(nodes, nodes))
        components.validate_driver()
        if match is None:
            info = components.validate_runtime()
            assert info == {"DEVICE_COUNT": "1", "DEVICE_NODES": "/dev/null"}
        else:
            with pytest.raises(ValidationFailed, match=match):
                components.validate_runtime()
            assert not barrier.is_ready("runtime-ready")


class TestCli:
    def test_no_component_prints_help(self, valdir):
        assert cli.main([]) == 2

    def test_wait(self, valdir):
        barrier.write_status("hbm-ready", {"X": "1"})
        assert cli.main(["wait", "hbm-ready", "--timeout", "1"]) == 0
        assert cli.main(["wait", "nvlink-ready", "--timeout", "0.1"]) == 1

    def test_with_wait_retries_until_the_proof_passes(self, valdir,
                                                      monkeypatch):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ValidationFailed("not yet")
            return {"OK": "1"}

        monkeypatch.setattr(components, "validate_driver", flaky)
        monkeypatch.setattr(barrier, "RETRY_INTERVAL_S", 0.01)
        assert cli.main(["-c", "driver", "--with-wait"]) == 0
        assert len(calls) == 3

    def test_unknown_component_is_refused(self, valdir):
        with pytest.raises(SystemExit):
            cli.main(["-c", "ici"])


def test_barrier_defaults_are_the_ports_own(monkeypatch):
    monkeypatch.delenv("GPU_VALIDATION_DIR", raising=False)
    assert str(barrier.validation_dir()) == "/run/nvidia/validations"
    assert set(barrier.KNOWN_STATUS_FILES) == {
        "driver-ready", "runtime-ready", "cuda-ready", "plugin-ready",
        "hbm-ready", "nvlink-ready", "dcn-ready", "topology-ready",
        "fencing-ready", "vgpu-ready", ".driver-ctr-ready"}

"""Hardware specs, CUDA bring-up and array conversion of the port, on a
host without a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.workloads import hardware as jax_hardware
from tpu_operator_torch import convert
from tpu_operator_torch.workloads import backend, hardware


@pytest.mark.parametrize("name, gen", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 SXM5 80GB", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
    ("", None),
])
def test_chip_spec_for(name, gen):
    spec = hardware.chip_spec_for(name)
    assert (spec.generation if spec else None) == gen


def test_h100_published_peaks():
    sxm, pcie = hardware.CHIPS["h100-sxm"], hardware.CHIPS["h100-pcie"]
    assert (sxm.peak_bf16_tflops, sxm.hbm_gb, sxm.hbm_bw_gbps) == (989.0, 80, 3350)
    assert (pcie.peak_bf16_tflops, pcie.hbm_gb, pcie.hbm_bw_gbps) == (756.0, 80, 2000)
    # one direction of NVLink's 900 GB/s, so a 0.8 bus-bandwidth gate can pass
    assert sxm.nvlink_bw_gbps == 450.0
    assert hardware.chip_spec_for("cpu") is jax_hardware.chip_spec_for("cpu") is None


def test_detect_without_a_card():
    assert hardware.detect() == ("cpu", 1, "cpu", None)
    assert hardware.device_kind("cpu") == "cpu"


def test_resolve_device():
    assert backend.resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            backend.resolve_device(dev)


def test_init_devices_retries_then_raises():
    lines = []
    with pytest.raises((RuntimeError, AssertionError)):
        backend.init_devices(attempts=2, backoff_s=0.01, log=lines.append)
    assert sum("CUDA init attempt" in line for line in lines) == 2


def test_describe_environment(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    desc = backend.describe_environment()
    assert "CUDA_VISIBLE_DEVICES=3,5" in desc and "device_nodes=" in desc


def test_diagnose_holders_without_nodes_is_empty(monkeypatch):
    monkeypatch.setattr(backend, "_DEVICE_GLOBS", ("/nonexistent/nvidia*",))
    assert backend.diagnose_holders() == []


def test_diagnose_holders_finds_another_process(tmp_path, monkeypatch):
    import subprocess
    import sys

    node = tmp_path / "nvidia0"
    node.write_text("")
    monkeypatch.setattr(backend, "_DEVICE_GLOBS", (str(node),))
    holder = subprocess.Popen(
        [sys.executable, "-c",
         f"import sys, time; f = open({str(node)!r}); print('open', flush=True); time.sleep(30)"],
        stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "open"
        found = backend.diagnose_holders()
        assert [h.pid for h in found] == [holder.pid]
        assert found[0].paths == [str(node)]
    finally:
        holder.kill()
        holder.wait(timeout=10)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16])
def test_to_torch_keeps_values_and_dtype(dtype):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(dtype)
    t = convert.to_torch(x, "cpu")
    assert t.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(convert.to_numpy(t), x)
    x[0, 0] = 99  # a copy, not a view of the numpy buffer
    assert t[0, 0].item() != 99


def test_to_torch_carries_jax_bf16_exactly():
    x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 8)),
                    jnp.bfloat16)
    arr = np.asarray(x)
    assert arr.dtype.name == "bfloat16"  # torch.from_numpy refuses this
    t = convert.to_torch(arr, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(convert.to_numpy(t),
                                  np.asarray(x.astype(jnp.float32)))


def test_to_torch_default_device_is_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.to_torch(np.zeros(3, np.float32))

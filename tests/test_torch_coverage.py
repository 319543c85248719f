"""Every module of the JAX package has its counterpart in the port: the
same path under ``tpu_operator_torch/``, or the one file the naming rule
renames (ROADMAP.md §C). A module of ``tpu_operator/`` with neither is a
part of the system the port does not yet do."""

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "tpu_operator"
PORT = ROOT / "tpu_operator_torch"
# the six files the naming rule renames
RENAMED = {
    "api/tpudriver.py": "api/gpudriver.py",
    "controllers/tpudriver_controller.py":
        "controllers/gpudriver_controller.py",
    "isolation/vtpu.py": "isolation/vgpu.py",
    "metrics/libtpu_exporter.py": "metrics/gpu_exporter.py",
    "workloads/pallas_probe.py": "workloads/hbm_probe.py",
    "cli/tpuop_cfg.py": "cli/gpuop_cfg.py",
}
MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py")
                 if "__pycache__" not in p.parts)


def counterpart(module: str) -> str:
    return RENAMED.get(module, module)


@pytest.mark.parametrize("module", MODULES)
def test_module_has_a_port_counterpart(module):
    assert (PORT / counterpart(module)).is_file(), module


def test_no_module_is_left():
    missing = [m for m in MODULES if not (PORT / counterpart(m)).is_file()]
    assert missing == []
    assert len(MODULES) > 100


@pytest.mark.parametrize("ref, port", sorted(RENAMED.items()))
def test_a_renamed_module_has_no_namesake(ref, port):
    assert (REF / ref).is_file()
    assert not (PORT / ref).exists()

"""Every command the port's manifests give a container is one of the
port's agents: a ``[project.scripts]`` entry of pyproject.toml whose
target imports from ``tpu_operator_torch`` and names a callable. The
reference's entries stay as they are, and the manifests ship as package
data."""

import importlib
import pathlib
import tomllib

import pytest

from tpu_operator_torch.api.clusterpolicy import (GPUClusterPolicySpec,
                                                  new_cluster_policy)
from tpu_operator_torch.state.operands import build_states
from tpu_operator_torch.state.state import SyncContext

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROJECT = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]
SCRIPTS = PROJECT["scripts"]


def rendered_commands() -> dict:
    """command[0] -> the (state, container) that run it, over every state
    with the sandbox plane and every optional operand on."""
    policy = new_cluster_policy(spec={
        "sandboxWorkloads": {"enabled": True},
        "gpuHealth": {"enabled": True},
        "operator": {"serviceMonitor": True},
        "devicePlugin": {"configMap": "plugin-configs"}})
    ctx = SyncContext(client=None, policy=policy,
                      spec=GPUClusterPolicySpec.from_obj(policy),
                      namespace="gpu-operator")
    out = {}
    for state in build_states():
        assert state.enabled(ctx), state.name
        for obj in state.render(ctx):
            if obj["kind"] != "DaemonSet":
                continue
            pod = obj["spec"]["template"]["spec"]
            for ctr in pod.get("initContainers", []) + pod["containers"]:
                cmds = [ctr["command"]]
                pre = (ctr.get("lifecycle") or {}).get("preStop")
                if pre:
                    cmds.append(pre["exec"]["command"])
                for cmd in cmds:
                    out.setdefault(cmd[0], []).append(
                        (state.name, ctr["name"]))
    return out


COMMANDS = rendered_commands()


def test_every_agent_is_rendered_somewhere():
    assert sorted(COMMANDS) == sorted([
        "gpu-validator", "gpu-driver-manager", "gpu-driver-install",
        "gpu-runtime-setup", "gpu-device-plugin",
        "gpu-isolated-device-plugin", "gpu-chip-fencing",
        "gpu-vgpu-device-manager", "gpu-health-engine",
        "gpu-feature-discovery", "gpu-topology-manager",
        "gpu-metrics-exporter"])


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_command_resolves_to_a_port_agent(command):
    target = SCRIPTS[command]
    module, _, attr = target.partition(":")
    assert module.startswith("tpu_operator_torch.")
    assert callable(getattr(importlib.import_module(module), attr))


def test_reference_scripts_stay():
    for name, target in SCRIPTS.items():
        if name.startswith("gpu-"):
            assert target.startswith("tpu_operator_torch.")
        else:
            assert target.startswith("tpu_operator.")
    assert SCRIPTS["tpu-validator"] == "tpu_operator.cli.validator:main"


def test_manifests_ship_as_package_data():
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["tpu_operator_torch"]
    shipped = {p for pattern in data
               for p in (ROOT / "tpu_operator_torch").glob(pattern)}
    manifests = set((ROOT / "tpu_operator_torch" / "manifests")
                    .rglob("*.yaml"))
    assert len(manifests) == 39 and manifests <= shipped

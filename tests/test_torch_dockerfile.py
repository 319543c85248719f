"""The port's container build file (``tpu_operator_torch/docker/Dockerfile``)
checked statically: every ``ghcr.io/gpu-operator/<image>`` the port's
operand states, ``values.yaml``, OLM bundle and CLIs name has a build
target of that name, and each image's entry point is a ``[project.scripts]``
command of the port. Building it needs its base images, which are
pulled from a registry."""

import pathlib
import re
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tpu_operator_torch"
DOCKERFILE = (PORT / "docker" / "Dockerfile").read_text()
SCRIPTS = tomllib.loads((ROOT / "pyproject.toml").read_text())[
    "project"]["scripts"]


def named_images() -> set:
    names = set()
    for path in list(PORT.rglob("*.py")) + list(PORT.rglob("*.yaml")):
        text = path.read_text()
        names |= set(re.findall(r"ghcr\.io/gpu-operator/([a-z0-9-]+)", text))
    operands = (PORT / "state" / "operands.py").read_text()
    names |= set(re.findall(
        r'common_data\(\s*ctx,\s*[^,]+,\s*"[^"]+",\s*"([a-z0-9-]+)"\)',
        operands))
    names |= set(re.findall(r'validator, "([a-z0-9-]+)"\)', operands))
    values = (PORT / "deploy" / "values.yaml").read_text()
    names |= set(re.findall(r"^\s+image: ([a-z0-9-]+)\s*$", values, re.M))
    return names


def stages() -> dict:
    """target -> its ENTRYPOINT command (None for a shared stage)."""
    out, current = {}, None
    for line in DOCKERFILE.splitlines():
        m = re.match(r"FROM \S+ AS (\S+)", line)
        if m:
            current = m.group(1)
            out[current] = None
        m = re.match(r'ENTRYPOINT \["([^"]+)"', line)
        if m and current:
            out[current] = m.group(1)
    return out


IMAGES = sorted(named_images())


def test_the_port_names_its_eleven_images():
    assert IMAGES == sorted([
        "gpu-operator", "gpu-validator", "gpu-driver-installer",
        "gpu-runtime", "gpu-device-plugin", "gpu-health-engine",
        "gpu-metrics-exporter", "gpu-feature-discovery",
        "gpu-topology-manager", "gpu-chip-fencing",
        "gpu-vgpu-device-manager"])


@pytest.mark.parametrize("image", IMAGES)
def test_image_has_a_target(image):
    command = stages().get(image)
    assert command is not None, f"no target {image} with an ENTRYPOINT"
    assert SCRIPTS[command].startswith("tpu_operator_torch."), command


def test_build_copies_the_port_and_no_jax():
    assert "COPY tpu_operator_torch/ tpu_operator_torch/" in DOCKERFILE
    assert "jax" not in DOCKERFILE
    assert "ghcr.io/tpu-operator" not in DOCKERFILE

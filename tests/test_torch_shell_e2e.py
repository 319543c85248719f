"""The port's shell e2e tier: ``tpu_operator_torch/scripts/end-to-end.sh``
runs the full install -> verify -> restart -> validate -> workload
pipeline through the port's CLIs, as CI would run it, and passes the
reference's nine stages in the reference's order. On this host the
workload-proof stage runs on the CPU only because
``GPU_VALIDATOR_ALLOW_CPU=true`` says so (without it the proof refuses:
``tests/test_torch_validator.py``)."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAGES = ["install-manifests", "values-pipeline", "lifecycle-hooks",
          "validate-clusterpolicy", "verify-operator", "restart-operator",
          "validator-components", "workload-proof", "isolated-plane"]


def reference_stages():
    """The stages the reference's script declares, in its order."""
    text = (ROOT / "scripts" / "end-to-end.sh").read_text()
    return re.findall(r"^stage ([\w-]+)$", text, re.M)


def test_end_to_end_script():
    proc = subprocess.run(
        ["bash", str(ROOT / "tpu_operator_torch" / "scripts" /
                     "end-to-end.sh")],
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHON": sys.executable,
             "GPU_VALIDATOR_ALLOW_CPU": "true", "HOME": "/tmp"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "END_TO_END_OK"
    stages = [ln.split()[1] for ln in proc.stdout.splitlines()
              if ln.startswith("STAGE_OK")]
    assert stages == STAGES == reference_stages()


"""The port stands alone: every module of tpu_operator_torch, and
chip_smoke.py, imports with JAX and the JAX package blocked, and its
default device is the card, which this host does not have: the entry
points refuse to run rather than fall back to the CPU."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys

    # a None entry makes `import x` (and `import x.y`) raise ImportError
    for name in ("jax", "jaxlib", "tpu_operator", "flax", "optax", "orbax"):
        sys.modules[name] = None

    import tpu_operator_torch

    mods = ["tpu_operator_torch"] + [
        m.name for m in pkgutil.walk_packages(tpu_operator_torch.__path__,
                                              "tpu_operator_torch.")]
    for m in mods:
        importlib.import_module(m)
    importlib.import_module("chip_smoke")

    from tpu_operator_torch import dryrun, entry
    from tpu_operator_torch.workloads import (backend, burnin, convburn, moe,
                                              pipeline)

    def refusal(fn):
        try:
            fn()
            return "ran"
        except RuntimeError as e:
            return str(e)

    default = refusal(lambda: backend.resolve_device(None))
    entries = {"burnin.run": refusal(lambda: burnin.run(steps=1)),
               "pipeline.run": refusal(pipeline.run),
               "moe.run": refusal(moe.run),
               "convburn.run": refusal(lambda: convburn.run(steps=1)),
               "burnin.init_params": refusal(
                   lambda: burnin.init_params(burnin.BurninConfig())),
               "dryrun_multichip": refusal(
                   lambda: dryrun.dryrun_multichip(2, "cuda")),
               "entry": refusal(entry.entry)}
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tpu_operator")
                    and sys.modules[m] is not None)
    print(json.dumps({"modules": mods, "default": default,
                      "entries": entries, "leaked": leaked}))
""")


def test_port_imports_without_jax_or_the_jax_package():
    import json

    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("MASTER_ADDR", "GPU_COORDINATOR_ADDRESS"):  # no job to join
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {
        "tpu_operator_torch.convert",
        "tpu_operator_torch.kernels.build",
        "tpu_operator_torch.workloads.hardware",
        "tpu_operator_torch.workloads.backend",
        "tpu_operator_torch.workloads.hbm_probe",
        "tpu_operator_torch.workloads.matmul",
        "tpu_operator_torch.workloads.collectives",
        "tpu_operator_torch.workloads.flashattention",
        "tpu_operator_torch.workloads.ringattention",
        "tpu_operator_torch.parallel.mesh",
        "tpu_operator_torch.parallel.multihost",
        "tpu_operator_torch.parallel.comm",
        "tpu_operator_torch.workloads.pipeline",
        "tpu_operator_torch.workloads.moe",
        "tpu_operator_torch.workloads.convburn",
        "tpu_operator_torch.workloads.burnin",
        "tpu_operator_torch.workloads.checkpoint",
        "tpu_operator_torch.dryrun",
        "tpu_operator_torch.validator.barrier",
        "tpu_operator_torch.validator.components",
        "tpu_operator_torch.cli.validator",
        "tpu_operator_torch.api.labels",
        "tpu_operator_torch.runtime.kubeclient",
        "tpu_operator_torch.validator.workload",
        "tpu_operator_torch.validator.metrics",
        "tpu_operator_torch.metrics.gpu_exporter",
        "tpu_operator_torch.entry",
        "tpu_operator_torch.workloads.elastic",
    }
    assert expected <= set(res["modules"])
    assert res["leaked"] == []
    assert res["default"].startswith("CUDA is not available")
    assert len(res["entries"]) == 7
    for entry, refusal in res["entries"].items():
        assert refusal.startswith("CUDA is not available"), entry


def test_chip_smoke_refuses_a_host_without_cuda(tmp_path):
    # alone in a directory and beside the package alike, it exits non-zero
    # and prints no result line
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(alone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

"""The port stands alone: every module of tpu_operator_torch, and
chip_smoke.py, imports with JAX and the JAX package blocked (and none
but the generated v1beta1 messages pulls in grpc, protobuf or yaml),
and its default device is the card, which this host does not have: the
entry points refuse to run rather than fall back to the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest

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
    # the generated v1beta1 messages import protobuf: last, so that what
    # the other modules pull in at import is seen apart
    mods.sort(key=lambda m: m.endswith(".api_pb2"))
    for m in mods:
        if m.endswith(".api_pb2"):
            top_level = [t for t in ("grpc", "google.protobuf", "yaml")
                         if t in sys.modules]
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
                      "entries": entries, "leaked": leaked,
                      "top_level": top_level}))
""")


# the host modules of the chaos and federation slice: each imports with
# torch blocked as well
NO_TORCH = (
    "tpu_operator_torch.chaos",
    "tpu_operator_torch.chaos.faults",
    "tpu_operator_torch.chaos.invariants",
    "tpu_operator_torch.chaos.runner",
    "tpu_operator_torch.chaos.federation",
    "tpu_operator_torch.cli.chaos",
    "tpu_operator_torch.federation",
    "tpu_operator_torch.federation.digest",
    "tpu_operator_torch.federation.router",
    "tpu_operator_torch.controllers.federation_controller",
    "tpu_operator_torch.runtime.multicell",
)


@pytest.mark.parametrize("module", NO_TORCH)
def test_chaos_and_federation_import_no_torch(module):
    probe = textwrap.dedent(f"""
        import importlib, sys
        for name in ("torch", "jax", "jaxlib", "tpu_operator"):
            sys.modules[name] = None
        importlib.import_module({module!r})
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "tpu_operator")
                     and sys.modules[m] is not None))
    """)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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
        "tpu_operator_torch.runtime.objects",
        "tpu_operator_torch.deviceplugin.api_pb2",
        "tpu_operator_torch.deviceplugin.plugin",
        "tpu_operator_torch.isolation.fencing",
        "tpu_operator_torch.isolation.vgpu",
        "tpu_operator_torch.metrics.health_engine",
        "tpu_operator_torch.featurediscovery.agent",
        "tpu_operator_torch.cli.node_agents",
        "tpu_operator_torch.state.nodepool",
        "tpu_operator_torch.topology.manager",
        # placement with quota, and the elastic handshake
        "tpu_operator_torch.api.slicerequest",
        "tpu_operator_torch.topology.placement",
        "tpu_operator_torch.topology.index",
        "tpu_operator_torch.scheduling",
        "tpu_operator_torch.scheduling.quota",
        "tpu_operator_torch.controllers.placement_controller",
        "tpu_operator_torch.controllers.slices",
        "tpu_operator_torch.runtime.snapshot",
        "tpu_operator_torch.runtime.manager",
        "tpu_operator_torch.cli.operator",
        "tpu_operator_torch.benchmarks.controlplane",
        # fleet telemetry, the CRD schemas, admission, the deploy tree
        # and the CLIs
        "tpu_operator_torch.metrics.fleet",
        "tpu_operator_torch.controllers.telemetry_controller",
        "tpu_operator_torch.api.crd",
        "tpu_operator_torch.api.cel",
        "tpu_operator_torch.api.validate",
        "tpu_operator_torch.api.versioned",
        "tpu_operator_torch.api.registry",
        "tpu_operator_torch.deploy",
        "tpu_operator_torch.deploy.packaging",
        "tpu_operator_torch.deploy.values",
        "tpu_operator_torch.deploy.helmchart",
        "tpu_operator_torch.deploy.csv",
        "tpu_operator_torch.deploy.apply",
        "tpu_operator_torch.deploy.diff",
        "tpu_operator_torch.cli.maintenance",
        "tpu_operator_torch.cli.must_gather",
        "tpu_operator_torch.cli.gpuop_cfg",
        # chaos and federation
        *NO_TORCH,
    }
    assert expected <= set(res["modules"])
    assert res["leaked"] == []
    # grpc, protobuf and yaml are imported where they are used, never at
    # a module's top (the plugin's core and the agents run without them)
    assert res["top_level"] == []
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

"""``tpu_operator_torch/scripts/hbm_sweep.py`` against the reference's
``scripts/hbm_sweep.py``: the same grid, the same report from the same
measurements (each script's probe replaced by one returning fixed
results), and without CUDA a JSON error and exit 1, where the reference
exits 1 off a TPU: the plain version never stands in for the kernel."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_grids():
    """The two grids ``scripts/hbm_sweep.py``'s ``main`` spells out."""
    tree = ast.parse(open(os.path.join(ROOT, "scripts",
                                       "hbm_sweep.py")).read())
    ifexp = next(n for n in ast.walk(tree) if isinstance(n, ast.IfExp))
    return ast.literal_eval(ifexp.body), ast.literal_eval(ifexp.orelse)


def test_the_grid_is_the_reference_s():
    from tpu_operator_torch.scripts import hbm_sweep

    assert (hbm_sweep.QUICK_GRID, hbm_sweep.GRID) == reference_grids()


# (bandwidth GB/s, fraction of peak, correct) a point, as both probes
# report them; the fastest point is incorrect, so best is the next
MEASURED = {256.0: (2950.04, 0.880611, True),
            512.0: (3080.46, 0.919541, True),
            1024.0: (3111.9, 0.928925, False)}


def run_reference(capsys):
    spec = importlib.util.spec_from_file_location(
        "reference_hbm_sweep", os.path.join(ROOT, "scripts", "hbm_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from tpu_operator.workloads import backend, pallas_probe

    def run(size_mb, iters, repeats):
        bw, frac, ok = MEASURED[size_mb]
        return types.SimpleNamespace(bandwidth_gbps=bw,
                                     fraction_of_peak=frac, correct=ok)

    device = types.SimpleNamespace(platform="tpu", device_kind="TPU v5p")
    saved = (backend.honor_jax_platforms_env, backend.init_devices,
             pallas_probe.run, sys.argv)
    backend.honor_jax_platforms_env = lambda: None
    backend.init_devices = lambda attempts: [device]
    pallas_probe.run = run
    sys.argv = ["hbm_sweep.py", "--quick"]
    try:
        assert mod.main() == 0
    finally:
        (backend.honor_jax_platforms_env, backend.init_devices,
         pallas_probe.run, sys.argv) = saved
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_report_is_the_reference_s(capsys, monkeypatch):
    from tpu_operator_torch.scripts import hbm_sweep
    from tpu_operator_torch.workloads import backend, hardware, hbm_probe

    def run(size_mb, iters, repeats, device):
        bw, frac, ok = MEASURED[size_mb]
        return types.SimpleNamespace(bandwidth_gbps=bw,
                                     fraction_of_peak=frac, correct=ok)

    monkeypatch.setattr(backend, "init_devices", lambda attempts: ["card"])
    monkeypatch.setattr(hbm_probe, "run", run)
    monkeypatch.setattr(hardware, "device_kind",
                        lambda dev: "NVIDIA H100 80GB HBM3")
    assert hbm_sweep.main(["--quick"]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = run_reference(capsys)
    assert port["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert {k: v for k, v in port.items() if k != "device_kind"} == \
        {k: v for k, v in ref.items() if k != "device_kind"}
    assert port["best"] == {"config": "512MBx24", "score": 0.9195}


def test_without_cuda_it_reports_an_error_and_exits_1():
    out = subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.scripts.hbm_sweep",
         "--quick"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT,
                                        CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1 and list(json.loads(lines[0])) == ["error"]

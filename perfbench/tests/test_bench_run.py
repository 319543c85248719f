"""A run as the command line makes it: the result line's shape, the traced
run's, the refusal without a card, without the program, and with JAX
loaded."""

import json
import os
import shutil
import subprocess
import sys


from perfbench import harness, manifest
from perfbench.tests import cpu

ROOT = str(manifest.ROOT)


def test_result_line_shape():
    line = cpu.run(cpu.small_cell("proofs.hbm-1card"))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"proof_gbps", "peak_gib", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert line["checks"] == {"a_max_abs_err": {"value": 0.0, "limit": 0.0}}
    json.dumps(line)


def test_traced_line_shape():
    line = cpu.run(cpu.small_cell("attn.prefill-64k"), trace=True)
    assert list(line)[-1] == "checks"
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    # no device operation on the CPU: the readers return nothing
    assert line["metrics"] == {}
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_refuses_without_a_card():
    res = _run(["perfbench/run.py", "--workload", "proofs.hbm-1card",
                "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
               ROOT, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(["-c", "from perfbench.tests import cpu; "
                "cpu.run(cpu.small_cell('proofs.hbm-1card'))"],
               str(tmp_path), dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode != 0
    assert "tpu_operator_torch" in res.stderr
    assert res.stdout.strip() == ""


def test_no_jax_in_a_run():
    """A whole CPU run, in a process of its own, loads no module named
    jax, jaxlib, flax or tpu_operator (compared by top-level name)."""
    code = ("import sys, json; from perfbench.tests import cpu; "
            "cpu.run(cpu.small_cell('attn.train-16k')); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    res = _run(["-c", code], ROOT)
    assert res.returncode == 0, res.stderr
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "tpu_operator_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_refuses_a_result_with_jax_loaded(monkeypatch, capsys):
    spec = harness.RunSpec(cell=cpu.small_cell("proofs.hbm-1card"), seed=1,
                           seconds=0.2, trace=False, t_start=0.0,
                           device_type="cpu")
    out = harness.run_ranks(spec)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.emit(spec, out, "cpu", None) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "jax" in captured.err

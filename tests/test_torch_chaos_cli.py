"""``gpuop-chaos`` (``tpu_operator_torch.cli.chaos``) against the
reference's ``tpuop-chaos``: ``list`` names the same 18 scenarios, and
``run`` prints the verdict ``run_scenario`` returns, byte for byte, and
exits 0 only on an ``ok`` verdict; ``--no-cache`` drops the informer
cache. It is a ``[project.scripts]`` entry under the naming rule."""

import json
import os
import pathlib
import subprocess
import sys
import tomllib

import pytest

import torch_naming as N
from tpu_operator.cli import chaos as rchaos
from tpu_operator_torch.chaos.runner import SCENARIOS, run_scenario
from tpu_operator_torch.cli import chaos

ROOT = pathlib.Path(__file__).resolve().parent.parent


def cli(argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "tpu_operator_torch.cli.chaos", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_list_is_the_references(capsys):
    assert rchaos.main(["list"]) == 0
    want = capsys.readouterr().out
    out = cli(["list"])
    assert out.returncode == 0
    assert out.stdout == want
    assert out.stdout.split() == list(SCENARIOS)


@pytest.mark.parametrize("argv", [
    ["--scenario", "cell-partition", "--nodes", "32", "--seed", "7"],
    ["--scenario", "watch-flap", "--nodes", "8", "--seed", "1",
     "--steps", "3", "--no-cache"],
], ids=["cell-partition", "watch-flap-no-cache"])
def test_run_prints_the_verdict(argv):
    out = cli(["run", *argv])
    kw = {"nodes": int(argv[argv.index("--nodes") + 1]),
          "seed": int(argv[argv.index("--seed") + 1])}
    if "--steps" in argv:
        kw["steps"] = int(argv[argv.index("--steps") + 1])
    verdict = run_scenario(argv[1], cached="--no-cache" not in argv, **kw)
    assert out.stdout == json.dumps(verdict, indent=2, sort_keys=True) + "\n"
    assert out.returncode == (0 if verdict["ok"] else 1)
    if "--no-cache" in argv:
        assert verdict["cached"] is False and verdict["cache_relists"] == 0


def test_run_refuses_an_unknown_scenario(capsys):
    with pytest.raises(SystemExit):
        chaos.main(["run", "--scenario", "split-brain"])
    assert "invalid choice" in capsys.readouterr().err


def test_is_a_project_script():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts[N.CHAOS["tpuop-chaos"]] == \
        "tpu_operator_torch.cli.chaos:main"
    assert scripts["tpuop-chaos"] == "tpu_operator.cli.chaos:main"

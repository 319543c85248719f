"""The chaos plane's verdicts against the JAX package's, part a of three
(the 18 scenarios split so that each file runs on one xdist worker well
under its budget). Each scenario runs at 32 nodes, seed 7, in both
packages over fleets mapped one to one (``torch_chaos_parity``); the
reference's verdict, put in the port's words, must equal the port's
byte for byte. Also here: a verdict is byte-identical run to run, and an
unknown scenario is refused, in both packages."""

import json

import pytest

import torch_chaos_parity as P
from tpu_operator.chaos.runner import run_scenario as ref_run_scenario
from tpu_operator_torch.chaos.runner import SCENARIOS, run_scenario

PART = ("saturation-storm", "conflict-storm", "watch-flap", "node-churn",
        "cell-partition", "chip-loss")


@pytest.fixture(scope="module")
def runs():
    procs = P.start(PART)
    got = {}

    def verdicts():
        if not got:
            got.update(P.verdicts(procs))
        return got

    yield verdicts
    P.stop(procs)


@pytest.mark.parametrize("scenario", PART)
def test_verdict_is_the_references(scenario, runs):
    got = runs()["port"][scenario]
    assert got["ok"] is True, got["violations"]
    assert sum(got["faults_injected"].values()) > 0
    want = P.port_words(runs()["ref"][scenario], scenario)
    assert P.canonical(P.normalized(got)) == P.canonical(want)


def test_same_seed_byte_identical_verdict():
    runs = [run_scenario("chip-loss", nodes=P.NODES, seed=P.SEED)
            for _ in range(2)]
    payloads = [json.dumps(v, indent=2, sort_keys=True) for v in runs]
    assert payloads[0] == payloads[1]
    assert runs[0]["ok"] is True


@pytest.mark.parametrize("run", [ref_run_scenario, run_scenario],
                         ids=["reference", "port"])
def test_unknown_scenario_rejected(run):
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        run("split-brain", nodes=4, seed=0)


def test_the_parts_hold_every_scenario_once():
    import test_torch_chaos_scenarios_b as b
    import test_torch_chaos_scenarios_c as c

    parts = PART + b.PART + c.PART
    assert sorted(parts) == sorted(SCENARIOS)
    assert len(SCENARIOS) == 18

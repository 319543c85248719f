"""The chaos plane's verdicts against the JAX package's, part b of three
(see part a). Also here: a deliberately broken controller is caught —
its dropped status write turns the verdict red — and a reconciler that
fails every other pass degrades to a verdict, not a crash, as
``tests/test_chaos.py``'s ``TestBrokenControllerIsCaught`` holds the
reference."""

import pytest

import torch_chaos_parity as P
from tpu_operator_torch.chaos.runner import run_scenario

PART = ("operator-crash", "placement-storm", "upgrade-under-fire",
        "dag-race", "stale-digest", "split-brain-router")


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


def test_dropped_status_write_goes_red(monkeypatch):
    from tpu_operator_torch.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler,
    )

    monkeypatch.setattr(ClusterPolicyReconciler, "_set_state",
                        lambda self, cr, state: None)
    v = run_scenario("conflict-storm", nodes=8, seed=0, steps=2)
    assert v["ok"] is False
    assert any(viol["invariant"] == "convergence"
               for viol in v["violations"])


def test_lost_update_is_a_violation_not_a_crash(monkeypatch):
    from tpu_operator_torch.controllers import clusterpolicy_controller as cpc
    from tpu_operator_torch.runtime.client import ServerUnavailableError

    orig = cpc.ClusterPolicyReconciler._reconcile

    def flaky(self, request):
        flaky.calls += 1
        if flaky.calls % 2 == 0:
            raise ServerUnavailableError("chaos-test: injected")
        return orig(self, request)

    flaky.calls = 0
    monkeypatch.setattr(cpc.ClusterPolicyReconciler, "_reconcile", flaky)
    v = run_scenario("watch-flap", nodes=8, seed=1, steps=2)
    assert isinstance(v["ok"], bool)
    assert "violations" in v

"""The port's driver-upgrade FSM against the JAX package's, part two:
the eviction drain (the skip label, PodDisruptionBudgets blocking until
the drain deadline, ``drainForce``, headroom, ``matchExpressions``), the
drain set (isolated and vGPU consumers, completed pods, renamed
resources), per-node and per-CR pauses and the sandbox gate, the
driver-CR path, and restarts mid-upgrade that keep their deadlines
(``torch_upgrade_scenarios.DRAIN``). The transcripts agree as in
``test_torch_upgrade.py``."""

import pytest

import torch_upgrade_scenarios as S


@pytest.mark.parametrize("scenario", list(S.DRAIN))
def test_scenario_agrees(scenario):
    ref, port = S.agrees(scenario)
    assert port == ref


def test_scenarios_say_what_they_are_named_for():
    drained = S.run("drain_evicts_workloads_but_respects_skip_label",
                    ref=False)
    assert drained["observed"] == [False, True]
    assert drained["evictions"] == ["default/train-job"]
    blocked = S.run("pdb_blocks_drain_until_timeout_then_failed", ref=False)
    assert blocked["stages"]["node-0"][-2:] == ["drain-required", "failed"]
    assert "drain timed out" in blocked["observed"][4]
    assert blocked["gauges"]["failed"] == 1
    assert S.run("pdb_match_expressions_blocks_eviction", ref=False)[
        "observed"] == ["blocked", 429]
    assert S.run("isolated_and_vgpu_pods_are_drained_too", ref=False)[
        "observed"] == {"node-0": ["isolated-wl", "shared", "vtpu-wl"]}
    crd = S.run("driver_cr_rendered_ds_rolls_through_fsm", ref=False)
    assert crd["observed"][0] == "ready"
    assert crd["observed"][-2] == {"node-0": "done"}

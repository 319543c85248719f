"""The port's driver-upgrade FSM against the JAX package's, part one:
the walk, the parallel budget, slice units moving together and healing
to the earliest stage, deadlines into ``failed`` and the retry after
backoff, the gauges and the events (``torch_upgrade_scenarios.FSM``;
``test_torch_upgrade_drain.py`` has the drain, the pauses and the
restarts). Each scenario runs on both packages' own ``FakeClient`` over
clusters mapped one to one; the transcripts (what it observed, every
upgrade-state label the reconciler wrote node by node, its evictions,
the Events, the gauges and counters) agree under ``torch_naming.py``'s
map. The migrate stage's elastic handshake has its own scenarios
(``torch_upgrade_scenarios.MIGRATE``, ``test_torch_migration.py``)."""

import pytest

import torch_naming as N
import torch_upgrade_scenarios as S
from tpu_operator_torch.controllers import slices
from tpu_operator_torch.runtime.fake import FakeClient

FULL_WALK = ["upgrade-required", "cordon-required", "migrate-required",
             "drain-required", "pod-restart-required", "validation-required",
             "uncordon-required", "done"]


@pytest.mark.parametrize("scenario", list(S.FSM))
def test_scenario_agrees(scenario):
    ref, port = S.agrees(scenario)
    assert port == ref


def test_scenarios_say_what_they_are_named_for():
    walk = S.run("single_node_full_upgrade_cycle", ref=False)
    assert walk["stages"] == {"node-0": FULL_WALK}
    assert walk["observed"][1] == {"node-0": "validation-required"}
    assert walk["observed"][6] == {"node-0": "done"}
    assert walk["done"] == 1 and walk["failed"] == 0
    reasons = {(e[1], e[2]) for e in walk["events"]}
    assert {("DriverUpgradeStarted", "Normal"),
            ("DriverUpgradeComplete", "Normal")} <= reasons
    units = S.run("upgrade_units_metric_counts_slices_once", ref=False)
    assert units["gauges"]["units_in_progress"] == 1
    assert units["gauges"]["in_progress"] == 2
    slice_walk = S.run("slice_hosts_move_together", ref=False)
    assert slice_walk["observed"][0] == {
        "slice-h0": "validation-required", "slice-h1": "validation-required",
        "z-single-0": "upgrade-required"}
    failed = S.run("validation_timeout_emits_failure_warning", ref=False)
    assert [e[2] for e in failed["events"]
            if e[1] == "DriverUpgradeFailed"] == ["Warning"]


def test_migrator_lists_slice_requests_as_the_reference():
    """One LIST of the SliceRequest kind a migrate pass, as the
    reference's, so the FSM's request counts match; an unbound or
    un-placed request does not hold the unit."""
    c = FakeClient()
    for name, phase, nodes in (("a", slices.PHASE_PLACED, ["other"]),
                               ("b", "Pending", ["node-0"])):
        c.create({"apiVersion": slices.V1ALPHA1,
                  "kind": slices.KIND_SLICE_REQUEST,
                  "metadata": {"name": name, "namespace": "ns"},
                  "status": {"phase": phase, "nodes": nodes}})
    c.reset_verb_counts()
    assert slices.SliceMigrator(c).ready_to_drain(["node-0"], 0.0) is True
    assert c.reset_verb_counts() == {"list": 1}
    assert slices.V1ALPHA1 == N.name("tpu.graft.dev/v1alpha1")
    assert [slices.request_key(cr) for cr in slices.placed_requests_on(
        c, ["other"])] == ["ns/a"]


def test_upgrade_labels_follow_the_rule():
    from tpu_operator.api import labels as RL
    from tpu_operator_torch.api import labels as L

    for key in N.UPGRADE_LABELS:
        assert N.name(key) in vars(L).values()
        assert key in vars(RL).values()
    assert S.up.UpgradeReconciler.name == N.name(
        S.rup.UpgradeReconciler.name)

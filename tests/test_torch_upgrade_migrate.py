"""The port's driver-upgrade FSM against the JAX package's, part three:
the migrate stage's elastic handshake (``torch_upgrade_scenarios.
MIGRATE``). A Placed SliceRequest bound to a draining unit is
checkpointed by its workload (the elastic shim) and rebound onto
replacement capacity before the drain; an expired deadline degrades to
the hard drain; ``elastic: false`` skips the handshake; a request
spanning two units moves once. Each scenario runs on both packages' own
FakeClient over clusters mapped one to one, and the transcripts (the
FSM's stages and evictions, the request's status, annotations and
leases, the shim's steps) agree under ``torch_naming.py``'s map."""

import pytest

import torch_upgrade_scenarios as S


@pytest.mark.parametrize("scenario", list(S.MIGRATE))
def test_migrate_scenario_agrees(scenario):
    ref, port = S.agrees(scenario)
    assert port == ref


def test_migrate_scenarios_say_what_they_are_named_for():
    walk = S.run("placed_request_migrates_before_the_drain", ref=False)
    (s1, r1, pod1), (s2, r2, pod2), (s3, r3, pod3), last = walk["observed"]
    assert s1["node-0"] == "migrate-required" and pod1
    assert r1["migration"]["phase"] == "Migrating"
    assert r2["migration"]["phase"] == "Rebound" and r2["nodes"] == \
        ["node-1"] and r2["leases"] == ["node-1"]
    assert s2["node-0"] == "validation-required" and not pod2
    assert last[0]["migration"]["phase"] == "Resumed"
    assert last[0]["migration"]["restoredStep"] == \
        last[0]["migration"]["ackedStep"]
    assert walk["evictions"] == ["default/train-job"]
    hard = S.run("expired_deadline_degrades_to_the_hard_drain", ref=False)
    s1, r1, s2, r2, pod = hard["observed"]
    assert r1["migration"]["phase"] == "Migrating"
    assert r2["migration"]["phase"] == "Aborted" and r2["nodes"] == \
        ["node-0"] and not pod
    skip = S.run("non_elastic_request_skips_the_handshake", ref=False)
    assert skip["observed"][1]["migration"] is None
    assert skip["observed"][0]["node-0"] == "validation-required"
    span = S.run("request_spanning_two_units_moves_once", ref=False)
    assert span["observed"][-1]["nodes"] == ["slice-h0", "slice-h1"]
    assert span["observed"][-1]["migrations"] == 1

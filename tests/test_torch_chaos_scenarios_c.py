"""The chaos plane's verdicts against the JAX package's, part c of three
(see part a). Also here: the GPU facts the runner and the checker state
in module constants are the mapped fleet's (the NODE_ADD host is the
mapped single host, the index probes pin its product and generation),
the fault schedules are the reference's under the rollout markers'
rename, and a chaos run hands the process-wide recorders back as it
found them."""

import pytest

import torch_chaos_parity as P
import torch_naming as N
from tpu_operator.chaos.faults import FaultPlan as RefPlan
from tpu_operator_torch.chaos import invariants, runner
from tpu_operator_torch.chaos.faults import FaultPlan
from tpu_operator_torch.chaos.runner import SCENARIOS, run_scenario

PART = ("slice-migrate", "placement-contention", "shard-failover",
        "operand-drift", "chip-degrade", "apiserver-brownout")


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


def test_declared_difference_shows_once(runs):
    """The domain models' one declared difference is there, once."""
    import json

    blob = json.dumps(P._tree(runs()["ref"]["slice-migrate"], ref=True))
    for ref_text, _ in P.DECLARED["slice-migrate"]:
        assert blob.count(json.dumps(ref_text)) == 1


def test_gpu_facts_are_the_mapped_fleets():
    from tpu_operator_torch.api import labels as L
    from tpu_operator_torch.topology.placement import pool_generation

    labels, alloc = P.single_labels(ref=False)
    assert runner.NODE_ADD_LABELS == labels
    assert runner.NODE_ADD_ALLOCATABLE == alloc
    assert invariants.PROBE_ACCELERATOR == labels[L.GPU_PRODUCT]
    assert invariants.PROBE_GENERATIONS == (
        pool_generation(labels[L.GPU_PRODUCT]),)
    assert P.GENERATIONS["v5p"] == invariants.PROBE_GENERATIONS[0]
    assert (runner.NAMESPACE, runner.POLICY) == (
        N.name("tpu-operator"), N.name("tpu-cluster-policy"))
    assert runner.DRIVER_COMPONENT == N.name("libtpu-driver")
    [(accel, product, topology, cards)] = N.CHAOS_NODE_ADD.values()
    assert labels == {L.GKE_ACCELERATOR: accel, L.GPU_PRODUCT: product,
                      L.GPU_TOPOLOGY: topology,
                      L.GKE_ACCELERATOR_COUNT: str(cards)}
    assert (invariants.PROBE_ACCELERATOR, invariants.PROBE_GENERATIONS) == (
        N.CHAOS_PROBES["tpu-v5p-slice"], (N.CHAOS_PROBES["v5p"],))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_schedule_is_the_references(scenario):
    names = [f"n-{i}" for i in range(8)]
    got = FaultPlan.build(scenario, 11, list(names), 12).schedule_json()
    want = RefPlan.build(scenario, 11, list(names), 12).schedule_json()
    for ref_marker, marker in N.CHAOS_MARKERS:
        want = want.replace(ref_marker, marker)
    assert got == want


def test_recorders_are_handed_back():
    from tpu_operator_torch.runtime.timeline import TIMELINE
    from tpu_operator_torch.runtime.tracing import TRACER

    TRACER.reset(enabled=True)
    TIMELINE.reset(enabled=True)
    with TRACER.trace("phase", "before"):
        pass
    TIMELINE.record("SliceRequest", "default/before", "placed")
    traces, timeline = TRACER.traces(), TIMELINE.snapshot()
    clock = TRACER.clock
    try:
        assert run_scenario("stale-digest", nodes=P.NODES,
                            seed=P.SEED)["ok"]
        assert run_scenario("watch-flap", nodes=8, seed=1, steps=2)
        assert TRACER.traces() == traces
        assert TIMELINE.snapshot() == timeline
        assert TRACER.clock is clock and TRACER.enabled
    finally:
        TRACER.reset(enabled=False)
        TIMELINE.reset(enabled=False)

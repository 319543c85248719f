"""The port's placement engine (``topology/placement.py``) against the
JAX package's, on fleets mapped one to one (``torch_placement_fleets``):
the NVLink domains are the reference's ICI domains host for host, and a
seeded stream of requests, bookings and releases gets the same ranked
candidates from both (nodes, cards, score and every term, exactly), the
same first-fit window and the same unschedulable reason under the naming
rule. The GPU model's own rules (an ``mnnvl`` nodepool is one domain of
its hosts' cards, every other fabric ends at the host, the fabric pin,
the product pin, name order) have tests of their own, and so has the
reference's claim on the port's pool mix: the scored engine packs at
least as well as first fit."""

import numpy as np
import pytest

import torch_placement_fleets as F
from tpu_operator.api.slicerequest import SliceRequestSpec as RSpec
from tpu_operator.topology import placement as rp
from tpu_operator.workloads.hardware import CHIPS as RCHIPS
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.slicerequest import SliceRequestSpec
from tpu_operator_torch.topology import placement as p
from tpu_operator_torch.workloads.hardware import CHIPS

SIZES = (4, 8, 12, 16, 20, 24)


def fleets(**kw):
    ref = rp.FleetState(F.node_objects(True, **kw))
    port = p.FleetState(F.node_objects(False, **kw))
    return ref, port


def mapped(cands, pools, slices):
    return [(pools[c.pool], slices[c.slice_id], c.nodes, c.chips, c.score,
             c.breakdown) for c in cands]


def ours(cands):
    return [(c.pool, c.slice_id, c.nodes, c.chips, c.score, c.breakdown)
            for c in cands]


def test_domains_map_one_to_one():
    ref, port = fleets()
    assert [[h.name for h in g.hosts] for g in ref.slices] == \
        [[h.name for h in g.hosts] for g in port.slices]
    assert [rp._slice_capacity(g) for g in ref.slices] == \
        [p._slice_capacity(g) for g in port.slices]
    assert [g.host_grid[-1] for g in ref.slices] == \
        [g.host_grid[-1] for g in port.slices]
    assert ref.chip_totals() == {"v6e": {"free": 56, "placed": 0}}
    assert port.chip_totals() == {"gb200": {"free": 56, "placed": 0}}


def specs_pair(rng):
    """One request on each side: cards, an optional pin, an optional
    preference list, drawn from ``rng``."""
    chips = int(rng.choice(SIZES))
    pin = rng.integers(0, 5)
    rkw, kw = {"chips": chips}, {"chips": chips}
    if pin == 0:
        rkw["accelerator"], kw["accelerator"] = F.FAST[0], F.FAST[2]
    elif pin == 1:
        rkw["accelerator"], kw["accelerator"] = F.NO_POOL
    elif pin == 2:
        rkw["preferred_generations"] = ["v5p", "v6e"]
        kw["preferred_generations"] = ["h100-sxm", "gb200"]
    return RSpec(**rkw), SliceRequestSpec(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decisions_agree_on_a_seeded_stream(seed):
    rng = np.random.default_rng(seed)
    ref, port = fleets(singles=5, slices=("pa", "pb", "pc"))
    pools, slices = F.pool_map(ref, port), F.slice_map(ref, port)
    live = []
    decided = 0
    for i in range(80):
        rspec, spec = specs_pair(rng)
        want = mapped(rp.rank_candidates(rspec, ref), pools, slices)
        got = ours(p.rank_candidates(spec, port))
        assert got == want, i
        rff, ff = rp.first_fit(rspec, ref), p.first_fit(spec, port)
        assert (ff is None) == (rff is None)
        if ff is not None:
            assert (ff.nodes, ff.chips) == (rff.nodes, rff.chips)
            assert ff.pool == pools[rff.pool]
        if not got:
            assert p.unschedulable_reason(spec, port) == F.text(
                rp.unschedulable_reason(rspec, ref), pools)
        elif rng.random() < 0.7:
            nodes = got[0][2]
            ref.book(nodes, f"r{i}")
            port.book(nodes, f"r{i}")
            live.append(f"r{i}")
            decided += 1
        if live and rng.random() < 0.3:
            owner = live.pop(int(rng.integers(0, len(live))))
            ref.release(owner=owner)
            port.release(owner=owner)
        assert port.utilization() == ref.utilization()
    assert decided > 10


def test_reclaim_and_owned_nodes_agree():
    ref, port = fleets()
    for fleet in (ref, port):
        fleet.book(["m-pa-0", "m-pa-1"], "ns/job")
    rspec, spec = RSpec(chips=16), SliceRequestSpec(chips=16)
    assert not [c for c in p.rank_candidates(spec, port)
                if c.slice_id == "pa"]
    got = [c.nodes for c in p.rank_candidates(spec, port,
                                              reclaim="ns/job")]
    assert got == [c.nodes for c in rp.rank_candidates(rspec, ref,
                                                       reclaim="ns/job")]
    assert ("m-pa-0", "m-pa-1", "m-pa-2", "m-pa-3") in got
    assert port.owned_nodes("ns/job") == ref.owned_nodes("ns/job")
    twin = port.clone()
    twin.release(owner="ns/job")
    assert port.owned_nodes("ns/job") and not twin.owned_nodes("ns/job")


@pytest.mark.parametrize("rkw, kw", [
    ({"chips": 0}, {"chips": 0}),
    ({"chips": 20}, {"chips": 20}),
    ({"chips": 4, "accelerator": F.NO_POOL[0]},
     {"chips": 4, "accelerator": F.NO_POOL[1]}),
], ids=["zero", "too-big", "no-pool"])
def test_unschedulable_reasons_agree(rkw, kw):
    ref, port = fleets()
    pools = F.pool_map(ref, port)
    assert p.unschedulable_reason(SliceRequestSpec(**kw), port) == \
        F.text(rp.unschedulable_reason(RSpec(**rkw), ref), pools)


def test_full_fleet_reason_agrees():
    ref, port = fleets(singles=2, slices=("pa",))
    for fleet in (ref, port):
        fleet.book([h.name for g in fleet.slices for h in g.hosts], "x/y")
    pools = F.pool_map(ref, port)
    got = p.unschedulable_reason(SliceRequestSpec(chips=4), port)
    assert got == F.text(rp.unschedulable_reason(RSpec(chips=4), ref), pools)
    assert got == "4 chips requested; no free capacity"


def test_throughput_term_is_the_peak_over_the_fastest():
    """Each side on its own table: the fastest generation is 1.0 (v6e,
    GB200); the H100 reads its 989 TFLOP/s over GB200's 2500."""
    assert p._MAX_PEAK == CHIPS["gb200"].peak_bf16_tflops == 2500.0
    assert rp._MAX_PEAK == RCHIPS["v6e"].peak_bf16_tflops
    port = p.FleetState(F.node_objects(False, singles=1, slices=(),
                                       slow_singles=1))
    got = {c.generation: c.breakdown["throughput"]
           for c in p.rank_candidates(SliceRequestSpec(chips=4), port)}
    assert got == {"gb200": 1.0, "h100-sxm": round(989.0 / 2500.0, 6)}


# --- the GPU model's own rules -------------------------------------------


def gpu_node(name, product, topology, cards=4, pool=None, ready=True):
    labels = {L.GPU_PRODUCT: product, L.GPU_TOPOLOGY: topology}
    if pool:
        labels[L.GKE_NODEPOOL] = pool
    return {"metadata": {"name": name, "labels": labels}, "spec": {},
            "status": {"allocatable": {L.GPU_RESOURCE: str(cards)},
                       "conditions": [{"type": "Ready",
                                       "status": "True" if ready
                                       else "False"}]}}


def test_an_mnnvl_nodepool_is_one_domain_of_its_hosts_cards():
    nodes = [gpu_node(f"g-{i:02d}", "NVIDIA-GB200", "mnnvl-4", pool="nvl72")
             for i in range(18)]
    nodes.append(gpu_node("g-99", "NVIDIA-GB200", "mnnvl-4", pool="nvl72",
                          ready=False))
    fleet = p.FleetState(nodes)
    [dom] = fleet.slices
    assert (dom.slice_id, len(dom.hosts)) == ("nvl72", 18)
    # the domain's size counts a NotReady member's cards, as a TPU grid
    # counts every chip of its slice
    assert p._slice_capacity(dom) == 76
    best = p.place(SliceRequestSpec(chips=72), fleet)
    assert best.nodes == tuple(f"g-{i:02d}" for i in range(18))
    assert best.breakdown["adjacency"] == 1.0
    assert best.breakdown["fragmentation"] == 1.0


def test_other_fabrics_end_at_the_host():
    nodes = [gpu_node(f"h-{i}", "NVIDIA-H100-80GB-HBM3", "nvswitch-8", 8)
             for i in range(3)]
    fleet = p.FleetState(nodes)
    assert [(g.slice_id, [h.name for h in g.hosts]) for g in fleet.slices] \
        == [(f"nvidia-h100-80gb-hbm3-nvswitch-8/{i}", [f"h-{i}"])
            for i in range(3)]
    assert p.place(SliceRequestSpec(chips=16), fleet) is None
    assert p.unschedulable_reason(SliceRequestSpec(chips=16), fleet) == (
        "16 chips requested; largest NVLink domain offers 8 chips "
        "(pool nvidia-h100-80gb-hbm3-nvswitch-8)")
    assert p.place(SliceRequestSpec(chips=8), fleet).nodes == ("h-0",)


def test_hosts_are_in_name_order_and_a_window_is_contiguous():
    names = ["g-b", "g-a", "g-d", "g-c"]
    fleet = p.FleetState([gpu_node(n, "NVIDIA-GB200", "mnnvl-4", pool="p")
                          for n in names])
    assert [h.name for h in fleet.slices[0].hosts] == sorted(names)
    fleet.book(["g-b"], "x/y")
    runs = fleet.free_runs(fleet.slices[0])
    assert [[h.name for h in r] for r in runs] == [["g-a"], ["g-c", "g-d"]]
    best = p.place(SliceRequestSpec(chips=8), fleet)
    assert best.nodes == ("g-c", "g-d") and best.breakdown["adjacency"] == 1.0


@pytest.mark.parametrize("topology, pools", [
    ("mnnvl", ["nvidia-gb200-mnnvl-4"]),
    ("mnnvl-4", ["nvidia-gb200-mnnvl-4"]),
    ("nvswitch", ["nvidia-h100-80gb-hbm3-nvswitch-8"]),
    ("nvswitch-8", ["nvidia-h100-80gb-hbm3-nvswitch-8"]),
    ("pcie", []),
    ("", ["nvidia-gb200-mnnvl-4", "nvidia-h100-80gb-hbm3-nvswitch-8"]),
])
def test_topology_names_a_fabric_or_a_whole_value(topology, pools):
    nodes = [gpu_node("g-0", "NVIDIA-GB200", "mnnvl-4", pool="p"),
             gpu_node("h-0", "NVIDIA-H100-80GB-HBM3", "nvswitch-8", 8)]
    fleet = p.FleetState(nodes)
    spec = SliceRequestSpec(chips=4, topology=topology)
    assert sorted({c.pool for c in p.rank_candidates(spec, fleet)}) == pools
    if not pools:
        assert p.unschedulable_reason(spec, fleet) == (
            "no pool topology admits requested topology 'pcie'")


def test_the_accelerator_pin_is_a_product_and_unknown_cards_are_left_out():
    nodes = [gpu_node("a-0", "NVIDIA-A100-SXM4-80GB", "nvswitch-8", 8),
             gpu_node("h-0", "NVIDIA-H100-80GB-HBM3", "nvswitch-8", 8),
             gpu_node("l-0", "NVIDIA-L4", "pcie-1", 1)]
    fleet = p.FleetState(nodes)
    assert [g.generation for g in fleet.slices] == ["a100-sxm", "h100-sxm"]
    spec = SliceRequestSpec(chips=8, accelerator="NVIDIA-A100-SXM4-80GB")
    assert p.place(spec, fleet).nodes == ("a-0",)
    # unpinned, the faster card wins; a preference steers between equals
    assert p.place(SliceRequestSpec(chips=8), fleet).nodes == ("h-0",)
    assert fleet.chip_totals() == {"a100-sxm": {"free": 8, "placed": 0},
                                   "h100-sxm": {"free": 8, "placed": 0}}


def test_a_condemned_or_cordoned_node_is_never_offered():
    nodes = [gpu_node(f"h-{i}", "NVIDIA-H100-80GB-HBM3", "nvswitch-8", 8)
             for i in range(3)]
    nodes[0]["status"]["conditions"].append(
        {"type": L.TELEMETRY_CONDITION, "status": "False"})
    nodes[1]["spec"]["unschedulable"] = True
    fleet = p.FleetState(nodes)
    assert [g.hosts[0].name for g in fleet.slices] == ["h-2"]


def test_scored_packs_at_least_as_well_as_first_fit_on_the_pool_mix():
    """The reference's claim on the port's POOL_MIX at the rider's
    default size: the scored engine's steady-state utilization (cards
    the live requests asked for, over the fleet's) is at least first
    fit's."""
    from tpu_operator_torch.benchmarks import controlplane as cp

    r = cp.run_placement_bench(500, 2000)
    assert r["fleet_utilization"] >= r["fleet_utilization_first_fit"]
    assert r["placed"] >= r["first_fit_placed"]
    assert r["placed"] + r["unschedulable"] == 2000


def test_spec_keeps_the_reference_fields():
    kw = {"chips": 8, "topology": "mnnvl", "accelerator": "NVIDIA-GB200",
          "priority": 2, "preferred_generations": ["gb200"]}
    spec = SliceRequestSpec(**kw)
    assert set(spec.to_obj()) == set(RSpec(**kw).to_obj())
    assert SliceRequestSpec.from_obj({"spec": spec.to_obj()}) == spec
    # a topology names a fabric, never the size of the request
    assert spec.chips_needed() == 8
    assert RSpec(chips=8, topology="4x4").chips_needed() == 16


def test_hardware_rows_of_the_pool_mix():
    """A100 SXM4 80GB and GB200 NVL72 (per GPU) from NVIDIA's data
    sheets: dense bf16, memory, memory rate, one-way NVLink."""
    a100, gb200 = CHIPS["a100-sxm"], CHIPS["gb200"]
    assert (a100.peak_bf16_tflops, a100.hbm_gb, a100.hbm_bw_gbps,
            a100.nvlink_bw_gbps) == (312.0, 80, 2039, 300.0)
    assert (gb200.peak_bf16_tflops, gb200.hbm_gb, gb200.hbm_bw_gbps,
            gb200.nvlink_bw_gbps) == (2500.0, 186, 8000, 900.0)
    assert L.accelerator_generation("nvidia-gb200") == "gb200"

"""The port's node pools (tpu_operator_torch.state.nodepool) against the
JAX package's: the same fleets, mapped one to one (a TPU accelerator to a
GPU product, a single-host TPU topology to ``nvswitch-<n>``, a multi-host
one to ``mnnvl-<n>``, GKE's nodepool label as it is), partition into the
same pools with the same multi-host flag and the same slices; and the
topology value's classification of NVML's facts (``topology_of``)."""

import pytest

from tpu_operator.api import labels as RL
from tpu_operator.state import nodepool as rnodepool
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.deviceplugin.plugin import Card, Fabric, Inventory
from tpu_operator_torch.state import nodepool

PRODUCTS = {"tpu-v5p-slice": "NVIDIA-H100-80GB-HBM3",
            "tpu-v5-lite-podslice": "NVIDIA-H200"}
TOPOLOGIES = {"2x2x1": "nvswitch-4", "4x4x4": "mnnvl-4", "2x4": "nvswitch-8",
              "2x2x2": "mnnvl-8", "4x4": "mnnvl-16", "1x1": "pcie-1",
              "1x2": "nvlink-2", "": ""}

# (name, accelerator, topology, gke nodepool); None: the label is absent
FLEETS = {
    "one-host-pools": [
        ("a-0", "tpu-v5p-slice", "2x2x1", None),
        ("a-1", "tpu-v5p-slice", "2x2x1", None),
        ("e-0", "tpu-v5-lite-podslice", "2x4", None),
        ("cpu-0", None, None, None),
    ],
    "multi-host-nodepools": [
        ("m-0", "tpu-v5p-slice", "4x4x4", "pool-a"),
        ("m-1", "tpu-v5p-slice", "4x4x4", "pool-a"),
        ("m-2", "tpu-v5p-slice", "4x4x4", "pool-b"),
        ("m-3", "tpu-v5p-slice", "4x4x4", "pool-b"),
        ("s-0", "tpu-v5p-slice", "2x2x1", "pool-c"),
    ],
    "mixed": [
        ("z-9", "tpu-v5p-slice", "2x2x2", "big"),
        ("z-1", "tpu-v5p-slice", "2x2x2", "big"),
        ("y-0", "tpu-v5-lite-podslice", "4x4", None),
        ("x-0", "tpu-v5p-slice", None, None),
        ("w-0", "tpu-v5p-slice", "1x1", "small"),
        ("v-0", "tpu-v5p-slice", "1x2", "pair"),
        ("cpu-1", None, None, "default-pool"),
    ],
}


def node(name, labels):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels}}


def fleets(spec):
    """(reference nodes, port nodes) of one fleet."""
    ref, port = [], []
    for name, accel, topo, pool in spec:
        rl, pl = {}, {}
        if accel is not None:
            rl[RL.GKE_TPU_ACCELERATOR] = accel
            pl[L.GPU_PRODUCT] = PRODUCTS[accel]
        if topo is not None:
            rl[RL.GKE_TPU_TOPOLOGY] = topo
            pl[L.GPU_TOPOLOGY] = TOPOLOGIES[topo]
        if pool is not None:
            rl[RL.GKE_NODEPOOL] = pl[L.GKE_NODEPOOL] = pool
        ref.append(node(name, rl))
        port.append(node(name, pl))
    return ref, port


def mapped(pool):
    """A reference pool's key under the mapping."""
    return (PRODUCTS[pool.accelerator], TOPOLOGIES[pool.topology])


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_pools_partition_alike(fleet):
    ref_nodes, port_nodes = fleets(FLEETS[fleet])
    ref = rnodepool.get_node_pools(ref_nodes)
    got = nodepool.get_node_pools(port_nodes)
    want = {mapped(p): (p.nodes, p.multi_host) for p in ref}
    assert {(p.product, p.topology): (p.nodes, p.multi_host)
            for p in got} == want
    assert len(got) == len(ref)
    assert [p.name for p in got] == sorted(p.name for p in got)


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_slices_alike(fleet):
    ref_nodes, port_nodes = fleets(FLEETS[fleet])
    by_name = {n["metadata"]["name"]: n for n in port_nodes}
    rby_name = {n["metadata"]["name"]: n for n in ref_nodes}
    ref = {mapped(p): (p.name, rnodepool.slices_of(p, rby_name))
           for p in rnodepool.get_node_pools(ref_nodes)}
    for p in nodepool.get_node_pools(port_nodes):
        ref_name, want = ref[(p.product, p.topology)]
        got = nodepool.slices_of(p, by_name)
        # a node without a nodepool label is a slice named for its pool
        assert got == {(p.name if k == ref_name else k): v
                       for k, v in want.items()}


@pytest.mark.parametrize("ref_restrict, port_restrict", [
    ({RL.GKE_NODEPOOL: "pool-a"}, {L.GKE_NODEPOOL: "pool-a"}),
    ({RL.GKE_TPU_TOPOLOGY: "4x4x4"}, {L.GPU_TOPOLOGY: "mnnvl-4"}),
    ({"matchExpressions": [{"key": RL.GKE_NODEPOOL, "operator": "In",
                            "values": ["pool-b", "pool-c"]}]},
     {"matchExpressions": [{"key": L.GKE_NODEPOOL, "operator": "In",
                            "values": ["pool-b", "pool-c"]}]}),
    ({"matchExpressions": [{"key": RL.GKE_NODEPOOL,
                            "operator": "DoesNotExist"}]},
     {"matchExpressions": [{"key": L.GKE_NODEPOOL,
                            "operator": "DoesNotExist"}]}),
], ids=["nodepool", "topology", "in", "does-not-exist"])
def test_restrict_alike(ref_restrict, port_restrict):
    ref_nodes, port_nodes = fleets(FLEETS["multi-host-nodepools"]
                                   + FLEETS["one-host-pools"])
    ref = rnodepool.get_node_pools(ref_nodes, restrict=ref_restrict)
    got = nodepool.get_node_pools(port_nodes, restrict=port_restrict)
    assert {(p.product, p.topology): p.nodes for p in got} == \
        {mapped(p): p.nodes for p in ref}


def test_unknown_selector_operator_raises_alike():
    ref_nodes, port_nodes = fleets(FLEETS["mixed"])
    bad = {"matchExpressions": [{"key": "k", "operator": "Near"}]}
    with pytest.raises(ValueError) as r:
        rnodepool.get_node_pools(ref_nodes, restrict=bad)
    with pytest.raises(ValueError) as p:
        nodepool.get_node_pools(port_nodes, restrict=bad)
    assert str(p.value) == str(r.value)


# the mapping holds but for two pairs: a v5p host has 4 chips and a v5e
# host 8, so 2x4 spans hosts on v5p alone and 2x2x2 on v5e fits one
@pytest.mark.parametrize("accel, topo", [
    (a, t) for a in PRODUCTS for t in TOPOLOGIES
    if (a, t) not in (("tpu-v5p-slice", "2x4"),
                      ("tpu-v5-lite-podslice", "2x2x2"))])
def test_multi_host_alike(accel, topo):
    ref = rnodepool.NodePool(accelerator=accel, topology=topo)
    got = nodepool.NodePool(product=PRODUCTS[accel],
                            topology=TOPOLOGIES[topo])
    assert got.multi_host == ref.multi_host


@pytest.mark.parametrize("product, topo, name, selector", [
    ("NVIDIA-H100-80GB-HBM3", "nvswitch-8", "nvidia-h100-80gb-hbm3-nvswitch-8",
     {L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3", L.GPU_TOPOLOGY: "nvswitch-8"}),
    ("NVIDIA-H100-80GB-HBM3", "", "nvidia-h100-80gb-hbm3-any",
     {L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}),
    ("", "mnnvl-4", "gpu-mnnvl-4", {L.GPU_TOPOLOGY: "mnnvl-4"}),
])
def test_name_and_selector(product, topo, name, selector):
    """The reference's forms, with the product for the TPU generation
    ('tpu' -> 'gpu' where none is known)."""
    pool = nodepool.NodePool(product=product, topology=topo)
    assert (pool.name, pool.selector) == (name, selector)
    ref = rnodepool.NodePool(accelerator="", topology="")
    assert ref.name == "tpu-any" and ref.selector == {}


@pytest.mark.parametrize("text", ["NVIDIA H100 80GB HBM3", "4x4x4",
                                  "--A_b--", "", "tpu-v5p-slice"])
def test_sanitize_alike(text):
    assert nodepool.sanitize(text) == rnodepool.sanitize(text)


# --- the topology value from NVML's facts ------------------------------------

ZERO = "00000000-0000-0000-0000-000000000000"
CLUSTER = "10111213-1415-1617-1819-1a1b1c1d1e1f"
SWITCHED = tuple((ln, "nvswitch") for ln in range(18))


def cards(*specs):
    return Inventory(tuple(Card(f"gpu{i}", i, f"GPU-{i}", i, nvlink=links,
                                fabric=fabric)
                           for i, (links, fabric) in enumerate(specs)))


def fabric(uuid, state="completed", status=0):
    return Fabric(uuid, 7 if uuid != ZERO else 0, state, status)


@pytest.mark.parametrize("inventory, want", [
    (Inventory(), None),
    (cards((SWITCHED, fabric(ZERO))), "nvswitch-1"),
    (cards(*[(SWITCHED, fabric(ZERO))] * 8), "nvswitch-8"),
    (cards(*[(SWITCHED, fabric(CLUSTER))] * 4), "mnnvl-4"),
    # a registration still in progress, or failed, names no cluster yet
    (cards((SWITCHED, fabric(CLUSTER, "in_progress"))), "nvswitch-1"),
    (cards((SWITCHED, fabric(CLUSTER, status=5))), "nvswitch-1"),
    # NVML refused a card's fabric: only the links speak
    (cards((SWITCHED, None), (SWITCHED, fabric(ZERO))), "nvswitch-2"),
    # a cluster is named even where the links were refused
    (cards((None, fabric(CLUSTER))), "mnnvl-1"),
    (cards((((0, "gpu"), (1, "gpu")), None), (((0, "gpu"),), None)),
     "nvlink-2"),
    (cards(((), None), ((), None)), "pcie-2"),
    # one card's links refused: no guess
    (cards((SWITCHED, None), (None, None)), None),
    # active links whose far end NVML would not name
    (cards((((0, None),), None),), None),
    (cards((((0, None), (1, "nvswitch")), None),), "nvswitch-1"),
], ids=["no-card", "one-hgx-card", "hgx-8", "nvl-cluster", "in-progress",
        "failed-registration", "fabric-refused", "links-refused-cluster",
        "bridges", "pcie", "links-refused", "remote-refused",
        "one-remote-named"])
def test_topology_of(inventory, want):
    assert nodepool.topology_of(inventory) == want
    if want:
        pool = nodepool.NodePool(product="p", topology=want)
        assert pool.multi_host == want.startswith("mnnvl-")

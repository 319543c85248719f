"""Fleets mapped one to one between the JAX package's placement model and
the port's, for the placement, index, quota and controller parity tests.

The two models agree where a TPU domain and an NVLink domain have the
same shape: a single-host pool (a TPU ``2x2`` host of 4 chips <-> an
``nvswitch-4`` host of 4 cards, one host a domain) and a multi-host
pool whose reference grid is one row (a ``1x16`` slice of 4 hosts,
worker ids 0-3, <-> an ``mnnvl-4`` nodepool of 4 hosts). The generation
is the fastest of each side's table (TPU v6e <-> GB200), so the
throughput term is 1.0 on both sides and the scores are equal. Node
names sort in worker order, so the port's name order is the reference's
worker order. A second, slower generation (v5p <-> H100) is there for
tests that only compare structure.
"""

from tpu_operator.api import labels as RL
from tpu_operator_torch.api import labels as L

# (reference GKE accelerator, port GKE accelerator, port gpu.product)
FAST = ("tpu-v6e-slice", "nvidia-gb200", "NVIDIA-GB200")
SLOW = ("tpu-v5p-slice", "nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3")
# a pin that matches no pool of these fleets, on each side
NO_POOL = ("tpu-v4-podslice", "NVIDIA-A100-SXM4-80GB")


def _single(ref: bool, gen, name: str) -> tuple:
    if ref:
        return name, {RL.GKE_TPU_ACCELERATOR: gen[0],
                      RL.GKE_TPU_TOPOLOGY: "2x2",
                      RL.GKE_ACCELERATOR_COUNT: "4"}, {RL.TPU_RESOURCE: "4"}
    return name, {L.GKE_ACCELERATOR: gen[1], L.GPU_PRODUCT: gen[2],
                  L.GPU_TOPOLOGY: "nvswitch-4",
                  L.GKE_ACCELERATOR_COUNT: "4"}, {L.GPU_RESOURCE: "4"}


def _multi(ref: bool, gen, pool: str, worker: int, hosts: int) -> tuple:
    name = f"m-{pool}-{worker}"
    if ref:
        return name, {RL.GKE_TPU_ACCELERATOR: gen[0],
                      RL.GKE_TPU_TOPOLOGY: f"1x{4 * hosts}",
                      RL.GKE_NODEPOOL: pool,
                      RL.GKE_TPU_WORKER_ID: str(worker),
                      RL.GKE_ACCELERATOR_COUNT: "4"}, {RL.TPU_RESOURCE: "4"}
    return name, {L.GKE_ACCELERATOR: gen[1], L.GPU_PRODUCT: gen[2],
                  L.GPU_TOPOLOGY: "mnnvl-4", L.GKE_NODEPOOL: pool,
                  L.GKE_ACCELERATOR_COUNT: "4"}, {L.GPU_RESOURCE: "4"}


def node_rows(ref: bool, singles: int = 6, slices=("pa", "pb"),
              hosts: int = 4, gen=FAST, slow_singles: int = 0) -> list:
    """(name, labels, allocatable) of a mapped fleet: ``singles``
    single-host nodes and one ``hosts``-host multi-host slice a name of
    ``slices``, all of generation ``gen``; ``slow_singles`` single hosts
    of the slower generation on top."""
    rows = [_single(ref, gen, f"s-{i:02d}") for i in range(singles)]
    for pool in slices:
        rows += [_multi(ref, gen, pool, w, hosts) for w in range(hosts)]
    rows += [_single(ref, SLOW, f"t-{i:02d}") for i in range(slow_singles)]
    return rows


def node_objects(ref: bool, **kw) -> list:
    """The fleet as Node objects (Ready), for the pure engines."""
    return [{"apiVersion": "v1", "kind": "Node",
             "metadata": {"name": name, "labels": dict(labels)},
             "spec": {},
             "status": {"allocatable": dict(alloc),
                        "conditions": [{"type": "Ready",
                                        "status": "True"}]}}
            for name, labels, alloc in node_rows(ref, **kw)]


def add_nodes(client, ref: bool, **kw) -> None:
    """The fleet on a FakeClient."""
    for name, labels, alloc in node_rows(ref, **kw):
        client.add_node(name, labels=labels, allocatable=alloc)


def pool_map(ref_fleet, port_fleet) -> dict:
    """Reference pool name -> the port's, by the hosts they hold."""
    port_of = {h.name: g.pool for g in port_fleet.slices for h in g.hosts}
    return {g.pool: port_of[g.hosts[0].name] for g in ref_fleet.slices
            if g.hosts}


def slice_map(ref_fleet, port_fleet) -> dict:
    """Reference domain id -> the port's, by the hosts they hold."""
    port_of = {h.name: g.slice_id for g in port_fleet.slices
               for h in g.hosts}
    return {g.slice_id: port_of[g.hosts[0].name] for g in ref_fleet.slices
            if g.hosts}


def text(value: str, pools: dict) -> str:
    """A reference reason in the port's words: pool names by ``pools``,
    ICI -> NVLink domains, TPU pins by the fleets' products."""
    import torch_naming as N

    for a, b in N.PLACEMENT_TEXT:
        value = value.replace(a, b)
    for a, b in sorted(pools.items(), key=lambda kv: -len(kv[0])):
        value = value.replace(f"(pool {a})", f"(pool {b})")
    for ref_accel, port_product in ((FAST[0], FAST[2]), (SLOW[0], SLOW[2]),
                                    NO_POOL):
        value = value.replace(repr(ref_accel), repr(port_product))
    return value

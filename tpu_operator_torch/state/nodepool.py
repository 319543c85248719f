"""GPU node pools, and what a node's topology value means.

Counterpart of ``tpu_operator/state/nodepool.py``. A pool is the nodes of
one (product, topology), read from the feature-discovery labels
``gpu.product`` and ``gpu.topology``: the reference keys by GKE's TPU
accelerator and topology labels, and GKE names no GPU topology. Slice
identity inside a pool stays GKE's nodepool.

The topology value is ``<fabric>-<cards>``, the node's fabric as NVML
reports it and its card count (``topology_of``):

- ``mnnvl``: a card's NVLink fabric registration names a cluster (a
  non-zero cluster UUID), so its NVLink domain spans hosts;
- ``nvswitch``: the cards' active links reach NVSwitches;
- ``nvlink``: active links reach other cards directly (bridges);
- ``pcie``: no card has an active link.

A pool is multi-host exactly when its fabric is ``mnnvl``: the GPU's
counterpart of a TPU slice larger than one host.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import labels as L
from ..runtime.objects import labels_of, match_labels, name_of

FABRIC_MNNVL = "mnnvl"
FABRIC_NVSWITCH = "nvswitch"
FABRIC_NVLINK = "nvlink"
FABRIC_PCIE = "pcie"

_SAFE = re.compile(r"[^a-z0-9-]+")


def sanitize(s: str) -> str:
    return _SAFE.sub("-", s.lower()).strip("-")


def topology_of(inventory) -> Optional[str]:
    """``<fabric>-<cards>`` of a ``deviceplugin.plugin.Inventory``, or
    None where NVML leaves the fabric unknown (no card; a card whose links
    NVML refused; active links whose far end it refused to name)."""
    cards = inventory.cards
    if not cards:
        return None
    if any(c.fabric is not None and c.fabric.spans_hosts for c in cards):
        fabric = FABRIC_MNNVL
    elif any(c.nvlink is None for c in cards):
        return None
    else:
        remotes = {remote for c in cards for _, remote in c.nvlink}
        if FABRIC_NVSWITCH in remotes:
            fabric = FABRIC_NVSWITCH
        elif None in remotes:
            return None
        else:
            fabric = FABRIC_NVLINK if remotes else FABRIC_PCIE
    return f"{fabric}-{len(cards)}"


def fabric_of(topology: str) -> str:
    """The fabric part of a topology value ('nvswitch-8' -> 'nvswitch')."""
    return topology.rpartition("-")[0]


@dataclass
class NodePool:
    """One (product, topology) group of GPU nodes."""

    product: str              # e.g. NVIDIA-H100-80GB-HBM3
    topology: str             # e.g. nvswitch-8
    nodes: List[str] = field(default_factory=list)

    @property
    def name(self) -> str:
        product = sanitize(self.product) or "gpu"
        topo = sanitize(self.topology) or "any"
        return f"{product}-{topo}"

    @property
    def selector(self) -> Dict[str, str]:
        sel = {}
        if self.product:
            sel[L.GPU_PRODUCT] = self.product
        if self.topology:
            sel[L.GPU_TOPOLOGY] = self.topology
        return sel

    @property
    def multi_host(self) -> bool:
        """True when the pool's NVLink domain spans hosts."""
        return fabric_of(self.topology or "") == FABRIC_MNNVL


def get_node_pools(nodes: List[dict],
                   restrict: Optional[Dict[str, str]] = None) -> List[NodePool]:
    """Partition GPU nodes into pools. ``restrict`` is a CR-level
    nodeSelector limiting which nodes participate."""
    pools: Dict[tuple, NodePool] = {}
    for node in nodes:
        nl = labels_of(node)
        if L.GPU_PRODUCT not in nl:
            continue
        if restrict and not match_labels(nl, restrict):
            continue
        key = (nl.get(L.GPU_PRODUCT, ""), nl.get(L.GPU_TOPOLOGY, ""))
        pool = pools.setdefault(key, NodePool(product=key[0],
                                              topology=key[1]))
        pool.nodes.append(name_of(node))
    out = list(pools.values())
    out.sort(key=lambda p: p.name)
    for p in out:
        p.nodes.sort()
    return out


def slices_of(pool: NodePool,
              nodes_by_name: Dict[str, dict]) -> Dict[str, List[str]]:
    """slice id -> member node names for one pool. Slice identity =
    product x topology x gke-nodepool, the key the topology manager's
    grouped agreement shares."""
    by_slice: Dict[str, List[str]] = {}
    for node_name in pool.nodes:
        slice_id = labels_of(nodes_by_name[node_name]).get(
            L.GKE_NODEPOOL, pool.name)
        by_slice.setdefault(slice_id, []).append(node_name)
    return by_slice

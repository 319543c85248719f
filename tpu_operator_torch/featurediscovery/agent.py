"""Card feature discovery: the gpu-feature-discovery slot.

Counterpart of ``tpu_operator/featurediscovery/agent.py``. The agent
reads the cards present (NVML, through the device plugin's inventory)
and stamps ``gpu.graft.dev/*`` property labels, so a scheduler and the
topology manager can select by product, memory, link class and fabric
without cloud-specific keys.

Ownership: the operator owns the presence and deploy labels; this agent
owns only ``labels.FEATURE_LABELS`` and removes one whose property is
gone. It patches only what changed.
"""

from __future__ import annotations

import logging
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, Optional

from ..api import labels as L
from ..runtime.objects import label_delta, labels_of, name_of

log = logging.getLogger("gpu_feature_discovery")


def label_value(text: str) -> str:
    """``text`` as a label value: runs of characters a value may not
    hold become '-', the ends are alphanumeric, at most 63 characters
    ('NVIDIA H100 80GB HBM3' -> 'NVIDIA-H100-80GB-HBM3')."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", text)[:63].strip("-_.")


def compute_feature_labels(node_labels: Dict[str, str],
                           inventory) -> Dict[str, Optional[str]]:
    """Property labels for a node; ``None`` marks a stale key's removal.

    ``inventory`` is ``deviceplugin.plugin.Inventory``. The product is
    GKE's accelerator label where the node has one, else NVML's name of
    its first card; the topology is ``GPU_TOPOLOGY`` where set, else the
    fabric NVML reports (``state.nodepool.topology_of``), and multihost
    is its pool's; memory and link rate come from the hardware table
    keyed by the product; the driver version is NVML's.
    """
    from ..state.nodepool import NodePool, topology_of
    from ..workloads.hardware import chip_spec_for

    want: Dict[str, Optional[str]] = {}
    names = [c.name for c in inventory.cards if c.name]
    product = label_value(node_labels.get(L.GKE_ACCELERATOR, "")
                          or (names[0] if names else ""))
    topo = os.environ.get("GPU_TOPOLOGY") or topology_of(inventory)
    if product:
        want[L.GPU_PRODUCT] = product
    if topo:
        want[L.GPU_TOPOLOGY] = topo
        want[L.GPU_MULTIHOST] = str(
            NodePool(product=product, topology=topo).multi_host).lower()
    spec = chip_spec_for(product)
    if spec is not None:
        want[L.GPU_MEMORY_GB] = str(int(spec.hbm_gb))
        want[L.GPU_NVLINK_GBPS] = str(int(spec.nvlink_bw_gbps))
    if inventory.driver_version:
        want[L.DRIVER_VERSION] = label_value(inventory.driver_version)
    # a key this agent owns but can no longer derive goes
    for key in L.FEATURE_LABELS:
        if key not in want and key in node_labels:
            want[key] = None
    return want


@dataclass
class FeatureDiscovery:
    client: object   # get and merge-patch of a Node
    node_name: str

    def apply_once(self) -> Dict[str, Optional[str]]:
        from ..deviceplugin.plugin import card_inventory

        node = self.client.get("v1", "Node", self.node_name)
        have = labels_of(node)
        want = compute_feature_labels(have, card_inventory())
        delta = label_delta(have, want)
        if delta:
            self.client.patch("v1", "Node", name_of(node),
                              {"metadata": {"labels": delta}})
            log.info("node %s feature labels: %s", self.node_name, delta)
        return delta

    def run_forever(self, interval: float = 60.0) -> None:  # pragma: no cover
        while True:
            try:
                self.apply_once()
            except Exception:
                log.exception("feature discovery failed")
            time.sleep(interval)


def main() -> int:  # pragma: no cover - container entrypoint
    logging.basicConfig(level=logging.INFO)
    from ..runtime.kubeclient import InClusterClient

    agent = FeatureDiscovery(client=InClusterClient.from_env(),
                             node_name=os.environ["NODE_NAME"])
    agent.run_forever(interval=float(os.environ.get("INTERVAL", "60")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

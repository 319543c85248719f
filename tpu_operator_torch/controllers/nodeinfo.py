"""Node attribute extraction + label filter builders.

The port's counterpart of ``tpu_operator/controllers/nodeinfo.py``
(internal/nodeinfo analog): a typed view over Node objects for the
controllers that need per-node facts. A GPU node is one GKE labels with an
``nvidia-`` accelerator or one that exposes ``nvidia.com/gpu``
(``api.labels.is_gpu_node``); its topology is feature discovery's
``gpu.graft.dev/gpu.topology`` label, since GKE names no GPU topology.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..api import labels as L
from ..runtime.client import Client
from ..runtime.objects import get_nested, labels_of, name_of


@dataclass(frozen=True)
class NodeAttributes:
    name: str
    is_gpu: bool
    accelerator: str
    generation: str
    topology: str
    chip_count: int
    workload_config: str
    kubelet_version: str
    kernel_version: str
    os_image: str
    schedulable: bool
    upgrade_state: Optional[str]


def attributes_of(node: dict) -> NodeAttributes:
    nl = labels_of(node)
    accel = nl.get(L.GKE_ACCELERATOR, "")
    chips = nl.get(L.GKE_ACCELERATOR_COUNT) or nl.get(L.GPU_CHIP_COUNT) or \
        str(get_nested(node, "status", "allocatable", L.GPU_RESOURCE,
                       default="") or "")
    return NodeAttributes(
        name=name_of(node),
        is_gpu=L.is_gpu_node(node),
        accelerator=accel,
        generation=L.accelerator_generation(accel) if accel else "",
        topology=nl.get(L.GPU_TOPOLOGY, ""),
        chip_count=int(chips or 0),
        workload_config=nl.get(L.WORKLOAD_CONFIG, "container"),
        kubelet_version=get_nested(node, "status", "nodeInfo",
                                   "kubeletVersion", default=""),
        kernel_version=get_nested(node, "status", "nodeInfo",
                                  "kernelVersion", default=""),
        os_image=get_nested(node, "status", "nodeInfo", "osImage",
                            default=""),
        schedulable=not get_nested(node, "spec", "unschedulable",
                                   default=False),
        upgrade_state=nl.get(L.UPGRADE_STATE),
    )


class NodeFilter:
    """Composable node predicate (NodeLabelFilterBuilder analog)."""

    def __init__(self):
        self._preds: List[Callable[[dict], bool]] = []

    def with_label(self, key: str, value: Optional[str] = None) -> "NodeFilter":
        if value is None:
            self._preds.append(lambda n: key in labels_of(n))
        else:
            self._preds.append(lambda n: labels_of(n).get(key) == value)
        return self

    def without_label(self, key: str) -> "NodeFilter":
        self._preds.append(lambda n: key not in labels_of(n))
        return self

    def gpu_only(self) -> "NodeFilter":
        self._preds.append(lambda n: attributes_of(n).is_gpu)
        return self

    def schedulable(self) -> "NodeFilter":
        self._preds.append(lambda n: attributes_of(n).schedulable)
        return self

    def matches(self, node: dict) -> bool:
        return all(p(node) for p in self._preds)

    def apply(self, nodes: List[dict]) -> List[dict]:
        return [n for n in nodes if self.matches(n)]


class NodeInfoProvider:
    """Live node facts (nodeinfo.Provider analog)."""

    def __init__(self, client: Client):
        self.client = client

    def nodes(self, node_filter: Optional[NodeFilter] = None) -> List[dict]:
        all_nodes = self.client.list("v1", "Node")
        return node_filter.apply(all_nodes) if node_filter else all_nodes

    def attributes(self, node_filter: Optional[NodeFilter] = None
                   ) -> List[NodeAttributes]:
        return [attributes_of(n) for n in self.nodes(node_filter)]

    def gpu_nodes(self) -> List[NodeAttributes]:
        return self.attributes(NodeFilter().gpu_only())

"""Cluster facts provider (the port's counterpart of
``tpu_operator/controllers/clusterinfo.py``; clusterinfo.go analog). The
GPU additions are topology/generation summaries, keyed as the reference's
TPU ones are (``tpuTopologies`` -> ``gpuTopologies``, ``tpuGenerations``
-> ``gpuGenerations``).

``facts()`` computes everything in ONE node list (a 200-node cluster must
not pay one list per fact, per reconcile); the per-getter API is the
parity surface, each expressed over that single pass so the two can
never drift. The reconcile loop publishes the dict on the CR's
``status.clusterInfo`` and passes it to states via SyncContext.cluster.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..runtime.client import Client
from ..runtime.objects import get_nested
from .nodeinfo import attributes_of

import logging

log = logging.getLogger("tpu_operator_torch.clusterinfo")


@dataclass
class ClusterInfo:
    client: Client

    def facts(self) -> Dict:
        """One pass over the node list. ``containerRuntime`` follows the
        reference's getRuntime discipline (state_manager.go:714-751):
        GPU nodes decide by majority (mixed fleets are warned about);
        non-GPU nodes only serve as a fallback."""
        k8s = ""
        kernels = set()
        topologies: Dict[str, int] = {}
        generations: Dict[str, int] = {}
        rt_counts: Dict[str, int] = {}
        rt_fallback = ""
        for node in self.client.list("v1", "Node"):
            info = get_nested(node, "status", "nodeInfo", default={}) or {}
            k8s = k8s or info.get("kubeletVersion", "")
            if info.get("kernelVersion"):
                kernels.add(info["kernelVersion"])
            attrs = attributes_of(node)
            rt = (info.get("containerRuntimeVersion") or "").split(":")[0]
            if rt:
                if attrs.is_gpu:
                    rt_counts[rt] = rt_counts.get(rt, 0) + 1
                elif not rt_fallback:
                    rt_fallback = rt
            if not attrs.is_gpu:
                continue
            topo = attrs.topology or "unknown"
            topologies[topo] = topologies.get(topo, 0) + 1
            if attrs.generation:
                generations[attrs.generation] = \
                    generations.get(attrs.generation, 0) + 1
        if rt_counts:
            if len(rt_counts) > 1:
                log.warning("mixed container runtimes across GPU nodes: "
                            "%s; using the majority runtime", rt_counts)
            # majority wins; name breaks ties deterministically
            runtime = max(rt_counts.items(),
                          key=lambda kv: (kv[1], kv[0]))[0]
        else:
            runtime = rt_fallback or "containerd"
        return {
            "kubernetesVersion": k8s or "unknown",
            "containerRuntime": runtime,
            "kernelVersions": sorted(kernels),
            "gpuTopologies": topologies,
            "gpuGenerations": generations,
        }

    # -- per-getter parity surface (clusterinfo.go getters) ---------------

    def get_kubernetes_version(self) -> str:
        return self.facts()["kubernetesVersion"]

    def get_container_runtime(self) -> str:
        return self.facts()["containerRuntime"]

    def get_kernel_versions(self) -> List[str]:
        return self.facts()["kernelVersions"]

    def get_gpu_topologies(self) -> Dict[str, int]:
        """topology string -> node count, across GPU nodes."""
        return self.facts()["gpuTopologies"]

    def get_gpu_generations(self) -> Dict[str, int]:
        return self.facts()["gpuGenerations"]

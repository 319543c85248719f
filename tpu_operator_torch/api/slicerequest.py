"""SliceRequest: a namespaced ask for GPU cards in one NVLink domain.

The port's counterpart of ``tpu_operator/api/slicerequest.py``. The
placement analog of a PodSpec resource request: a workload asks for
``chips`` cards (optionally a ``topology``, a fabric such as ``mnnvl``
or a whole ``gpu.topology`` value such as ``mnnvl-4``, and an
``accelerator`` pin, a ``gpu.product`` value), and the placement engine
(topology/placement.py) bin-packs it onto the fleet's pools, reconciling
the decision as state: ``status.phase: Pending|Placed|Unschedulable``
plus a ``gpu.graft.dev/placed-by`` lease annotation on the chosen nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .clusterpolicy import GROUP
from .convert import field, from_dict, to_dict

V1ALPHA1 = f"{GROUP}/v1alpha1"
KIND_SLICE_REQUEST = "SliceRequest"

PHASE_PENDING = "Pending"
PHASE_PLACED = "Placed"
PHASE_UNSCHEDULABLE = "Unschedulable"

# --- elastic-slice protocol (status.migration.phase) -----------------------
# Lifecycle of one migration/resize attempt, surfaced on the request so
# operators can follow the handshake:
#   Migrating    intent posted, waiting for the workload to checkpoint
#   Checkpointed workload acked a durable checkpoint step
#   Rebound      operator leased replacement capacity and moved the binding
#   Resharding   same-NVLink-domain rebind via direct shard handoff:
#                surviving hosts keep their shards in place, only the
#                reassigned shards move (status.migration carries
#                bytesMoved/shardsMoved and path=sharded-handoff)
#   Resumed      workload restored the acked step on the new binding
#   Aborted      deadline passed (or the attempt was superseded); the
#                operator degraded to the pre-elastic hard-drain behavior
MIG_MIGRATING = "Migrating"
MIG_CHECKPOINTED = "Checkpointed"
MIG_REBOUND = "Rebound"
MIG_RESHARDING = "Resharding"
MIG_RESUMED = "Resumed"
MIG_ABORTED = "Aborted"
MIG_TERMINAL = ("", MIG_RESUMED, MIG_ABORTED)

INTENT_MIGRATE = "migrate"
INTENT_SHRINK = "shrink"
INTENT_GROW = "grow"


@dataclass
class SliceRequestSpec:
    chips: Optional[int] = field(
        default=0, description="Number of GPU cards requested")
    topology: Optional[str] = field(
        description="Requested fabric (mnnvl, nvswitch, nvlink, pcie) or "
                    "a whole gpu.topology value such as mnnvl-4")
    accelerator: Optional[str] = field(
        description="Pin to one gpu.product label value, "
                    "e.g. NVIDIA-H100-80GB-HBM3")
    priority: Optional[int] = field(
        default=0, description="Preemption priority; higher wins when "
                               "preemption is enabled")
    preferred_generations: Optional[List[str]] = field(
        description="Ordered generation preferences, e.g. "
                    "[h100-sxm, a100-sxm]")

    @classmethod
    def from_obj(cls, cr: dict) -> "SliceRequestSpec":
        return from_dict(cls, cr.get("spec") or {})

    def to_obj(self) -> dict:
        return to_dict(self)

    def chips_needed(self) -> int:
        """Effective card count. A GPU topology value names a fabric and
        a card count per host, never the size of the request, so the
        count is ``chips`` whatever ``topology`` says (the reference
        derives it from a TPU grid when one is given)."""
        return int(self.chips or 0)


def new_slice_request(name: str, spec: Optional[dict] = None,
                      namespace: str = "default") -> dict:
    return {
        "apiVersion": V1ALPHA1,
        "kind": KIND_SLICE_REQUEST,
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec or {},
    }

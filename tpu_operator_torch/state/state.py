"""State interface + sync context (the port's own copy of
``tpu_operator/state/state.py``).

The single state-engine abstraction (the reference's *destination*
architecture: internal/state/state.go State interface + manager.go
SyncState; the legacy 4876-line object_controls.go path is deliberately
not reproduced — SURVEY.md section 7 "keep engine B's shape").
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..api.clusterpolicy import GPUClusterPolicySpec
from ..runtime.client import Client


class SyncStatus(str, enum.Enum):
    READY = "ready"
    NOT_READY = "notReady"
    DISABLED = "disabled"
    ERROR = "error"


@dataclass
class SyncResult:
    status: SyncStatus
    message: str = ""

    @property
    def ready(self) -> bool:
        return self.status in (SyncStatus.READY, SyncStatus.DISABLED)


@dataclass
class SyncContext:
    """Everything a state needs to render and apply its operands
    (internal/state/types.go InfoCatalog analog, but explicit)."""

    client: Client
    policy: dict                      # the GPUClusterPolicy CR (raw)
    spec: GPUClusterPolicySpec        # typed view of policy.spec
    namespace: str
    cluster: Dict[str, Any] = field(default_factory=dict)  # clusterinfo facts
    extra: Dict[str, Any] = field(default_factory=dict)


class State:
    """One operand state: renders its objects, applies them, reports
    readiness. Subclasses (or OperandState instances) define the operand."""

    name: str = "state"
    description: str = ""

    def enabled(self, ctx: SyncContext) -> bool:
        return True

    def sync(self, ctx: SyncContext) -> SyncResult:  # pragma: no cover
        raise NotImplementedError

    # names of states whose sync must complete earlier in the same pass
    # (the DAG scheduler's edges). None = unspecified: the scheduler
    # chains this state to its list-order predecessor, so an undeclared
    # graph reproduces the serial walk exactly. [] = no dependencies.
    def requires(self) -> Optional[List[str]]:
        return None

    # (api_version, kind) pairs whose events should retrigger reconcile
    def watch_sources(self) -> List[tuple]:
        return [("apps/v1", "DaemonSet")]

"""Node telemetry condition reconciler: the scorer's publishing arm.

The port's counterpart of
``tpu_operator/controllers/telemetry_controller.py``; a node counts when
``labels.is_gpu_node`` says so, where the reference reads GKE's TPU
accelerator label.

metrics/fleet.py condemns and absolves nodes in memory from their
health-digest streams; this reconciler is the only writer of that
verdict into the cluster, as the ``GPUTelemetryHealthy`` node condition
(status "False" = condemned). Everything downstream — FleetState and
FleetIndex eligibility, the placement controller's ``_binding_broken``
drain — reads the condition, never the in-memory ledger, so a restarted
operator re-earns each condemnation from fresh streaks instead of
trusting stale state.

Rides the health lane: a digest edge must not pool behind bulk churn.
Writes follow the zero-write steady state — a node whose condition
already matches the scorer costs the apiserver nothing, and a node that
was never condemned never gains the condition at all (the fleet's
steady state is condition-free, not fleet-wide "True" stamps).
"""

from __future__ import annotations

from typing import Optional

from ..api import labels as L
from ..api.conditions import update_status_with_retry
from ..metrics.fleet import FLEET_TELEMETRY, FleetTelemetry
from ..runtime import (
    LANE_HEALTH,
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
    WatchEvent,
)
from ..runtime.objects import (
    annotations_of,
    get_nested,
    name_of,
    set_nested,
    thaw_obj,
)


def _condition_of(node: dict) -> Optional[dict]:
    for c in get_nested(node, "status", "conditions", default=[]) or []:
        if c.get("type") == L.TELEMETRY_CONDITION:
            return c
    return None


def _node_telemetry_changed(event: WatchEvent,
                            old: Optional[dict]) -> bool:
    """React to digest publishes and condition flips only — lease
    echoes and label churn never wake this reconciler."""
    if event.type in ("ADDED", "DELETED") or old is None:
        return True

    def facet(n):
        cond = _condition_of(n) or {}
        return (annotations_of(n).get(L.HEALTH_DIGEST),
                cond.get("status"), cond.get("message"))

    return facet(event.obj) != facet(old)


class TelemetryReconciler(Reconciler):
    name = "telemetry"
    primary_kind = "Node"

    def __init__(self, client, telemetry: Optional[FleetTelemetry] = None):
        self.client = client
        self.telemetry = FLEET_TELEMETRY if telemetry is None else telemetry

    def setup_controller(self, controller: Controller, manager: Manager):
        controller.watch("v1", "Node",
                         predicate=_node_telemetry_changed,
                         lane=LANE_HEALTH)

    def reconcile(self, request: Request) -> Result:
        live = self.client.get_or_none("v1", "Node", request.name)
        if live is None:
            return Result()
        if not L.is_gpu_node(live):
            return Result()
        name = name_of(live)
        condemned = self.telemetry.is_condemned(name)
        current = _condition_of(live)
        if condemned:
            want = {"type": L.TELEMETRY_CONDITION, "status": "False",
                    "reason": "TelemetryCondemned",
                    "message": (f"condemned after "
                                f"{self.telemetry.condemn_after} "
                                "consecutive FAIL digests")}
        elif current is not None:
            # absolved (or scorer state lost to a restart and not yet
            # re-earned): flip to True rather than delete, so the
            # recovery is visible in the condition history
            want = {"type": L.TELEMETRY_CONDITION, "status": "True",
                    "reason": "TelemetryHealthy",
                    "message": "digest stream healthy"}
        else:
            return Result()
        if current == want:
            return Result()
        node = thaw_obj(live)
        conds = [c for c in get_nested(node, "status", "conditions",
                                       default=[]) or []
                 if c.get("type") != L.TELEMETRY_CONDITION]
        conds.append(want)
        set_nested(node, conds, "status", "conditions")
        update_status_with_retry(self.client, node, live=live)
        return Result()

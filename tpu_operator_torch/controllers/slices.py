"""Per-pool readiness rows for ``status.slices[]``.

The port's counterpart of the status half of
``tpu_operator/controllers/slices.py`` (``slice_status``,
``_validated_hosts``, ``_aggregate_upgrade_state``, :79-160). A row is one
slice of a multi-host pool — an ``mnnvl`` pool, whose NVLink domain spans
hosts (``state/nodepool.py``) — keyed by GKE's nodepool, as the topology
manager's grouped agreement keys it:

    {id, product, topology, hosts, hostsValidated, validated, upgradeState}

A slice is ``validated`` only when EVERY host's validation-gate pod is
Ready (grouped readiness). Terminating pods don't count: a dying
validator's Ready=True is the OLD proof, not a re-validation. Single-host
pools are not listed: their readiness is already the per-state status.

Of the reference's elastic-migration half (``:163-464``) the port has the
request lookup the upgrade FSM's migrate stage runs (``request_key``,
``migration_of``, ``placed_requests_on``) and a ``SliceMigrator`` that
answers for a unit no Placed SliceRequest is bound to. Moving a bound
request (checkpoint, ``find_replacement``, rebind) needs placement and
the elastic workload, which are not ported: the migrator raises
``MigrationNotPortedError`` there rather than let the unit fall to a hard
drain the reference would not take.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional

from ..api import labels as L
from ..api.clusterpolicy import GROUP
from ..runtime.client import Client, ListOptions
from ..runtime.objects import (
    get_nested,
    labels_of,
    name_of,
    namespace_of,
    pod_ready,
)
from ..state.nodepool import get_node_pools, slices_of

# the SliceRequest CRD (the reference's api/slicerequest.py): its group
# version, kind and the phase of a bound request
V1ALPHA1 = f"{GROUP}/v1alpha1"
KIND_SLICE_REQUEST = "SliceRequest"
PHASE_PLACED = "Placed"

MAX_ROWS = 100  # status-size bound; rows are sorted, so truncation is stable

# the validation-gate DaemonSets' pod app labels (operator-validation and
# isolated-validation)
VALIDATOR_APPS = ("gpu-operator-validator", "gpu-isolated-validator")

# upgrade-state severity for the per-slice aggregate: the row shows the
# most in-need-of-attention member state (failed dominates; done only
# when every labeled member is done)
_SEVERITY = ("failed", "drain-required", "migrate-required",
             "cordon-required", "pod-restart-required",
             "validation-required", "uncordon-required",
             "upgrade-required", "done")


def _aggregate_upgrade_state(states: List[str]) -> str:
    present = [s for s in states if s]
    if not present:
        return ""
    for sev in _SEVERITY:
        if sev in present:
            return sev
    return present[0]  # unknown label value: surface it verbatim


def _validated_hosts(client: Client, namespace: str) -> set:
    out = set()
    for app in VALIDATOR_APPS:
        for pod in client.list("v1", "Pod",
                               ListOptions(namespace=namespace,
                                           label_selector={"app": app})):
            if get_nested(pod, "metadata", "deletionTimestamp"):
                continue
            if pod_ready(pod):
                node = get_nested(pod, "spec", "nodeName")
                if node:
                    out.add(node)
    return out


def slice_status(client: Client, namespace: str,
                 nodes: Optional[List[dict]] = None) -> List[dict]:
    """Rows for ``status.slices[]``; empty when no multi-host pool
    exists. Pass ``nodes`` when the caller already holds the node list.
    Returns the FULL sorted row list; the CR writer applies the MAX_ROWS
    status-size cap, so gauge consumers still see every slice."""
    if nodes is None:
        nodes = client.list("v1", "Node")
    by_name = {name_of(n): n for n in nodes}
    pools = [p for p in get_node_pools(nodes) if p.multi_host]
    if not pools:
        return []
    validated = _validated_hosts(client, namespace)
    rows: List[dict] = []
    for pool in pools:
        for slice_id, members in slices_of(pool, by_name).items():
            n_ok = sum(1 for m in members if m in validated)
            rows.append({
                "id": slice_id,
                "product": pool.product,
                "topology": pool.topology,
                "hosts": len(members),
                "hostsValidated": n_ok,
                "validated": n_ok == len(members),
                "upgradeState": _aggregate_upgrade_state(
                    [labels_of(by_name[m]).get(L.UPGRADE_STATE, "")
                     for m in members]),
            })
    rows.sort(key=lambda r: r["id"])
    return rows


# --- the elastic migrate stage's request lookup ---------------------------


def request_key(cr: dict) -> str:
    return f"{namespace_of(cr) or 'default'}/{name_of(cr)}"


def migration_of(cr: dict) -> dict:
    return dict(get_nested(cr, "status", "migration", default={}) or {})


def placed_requests_on(client: Client, node_names: Iterable[str]) -> List[dict]:
    """Placed SliceRequests whose binding intersects ``node_names``,
    sorted by key for deterministic processing order."""
    wanted = set(node_names)
    out = []
    for cr in client.list(V1ALPHA1, KIND_SLICE_REQUEST):
        if get_nested(cr, "status", "phase") != PHASE_PLACED:
            continue
        bound = get_nested(cr, "status", "nodes", default=[]) or []
        if wanted.intersection(bound):
            out.append(cr)
    out.sort(key=request_key)
    return out


class MigrationNotPortedError(RuntimeError):
    """A Placed SliceRequest is bound to a draining unit: moving it needs
    the placement engine and the elastic workload (ROADMAP.md §A item 3),
    which the port does not have yet."""


class SliceMigrator:
    """The migrate stage of the upgrade FSM.

    ``ready_to_drain`` lists the SliceRequests as the reference's does
    and returns True when no Placed request is bound to the unit, as the
    reference's returns there. A bound request would take the
    checkpoint-and-rebind handshake, which is not ported: it raises
    :class:`MigrationNotPortedError`, never a silent hard drain."""

    def __init__(self, client: Client, now: Callable[[], float] = time.time):
        self.client = client
        self.now = now

    def ready_to_drain(self, unit_nodes: List[str], deadline: float) -> bool:
        bound = placed_requests_on(self.client, unit_nodes)
        if bound:
            raise MigrationNotPortedError(
                "SliceRequest(s) "
                + ", ".join(request_key(cr) for cr in bound)
                + f" placed on draining unit {sorted(unit_nodes)}: the "
                "elastic migration needs placement and the elastic "
                "workload (ROADMAP.md §A item 3), not ported")
        return True

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
The elastic-migration half of the reference's module comes with the
placement engine.
"""

from __future__ import annotations

from typing import List, Optional

from ..api import labels as L
from ..runtime.client import Client, ListOptions
from ..runtime.objects import get_nested, labels_of, name_of, pod_ready
from ..state.nodepool import get_node_pools, slices_of

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

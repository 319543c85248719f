"""metav1.Condition handling for CR status (the port's own copy of
``tpu_operator/api/conditions.py``).

Mirrors internal/conditions/conditions.go:31-35 (Updater with
SetConditionsReady / SetConditionsError) and the condition constants used
by both reconcilers.
"""

from __future__ import annotations

import datetime
from typing import Optional

from ..runtime.client import SPEC_HASH_GATE, Client, ConflictError, NotFoundError
from ..runtime.objects import (
    FrozenDict,
    get_nested,
    name_of,
    namespace_of,
    set_nested,
    thaw_obj,
)

COND_READY = "Ready"
COND_ERROR = "Error"

REASON_RECONCILED = "Reconciled"
REASON_ERROR = "ReconcileFailed"
REASON_OPERANDS_NOT_READY = "OperandsNotReady"


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def set_condition(cr: dict, type_: str, status: str, reason: str,
                  message: str = "") -> bool:
    """Upsert a condition on ``cr.status.conditions``; returns True when the
    condition materially changed (lastTransitionTime only moves on a status
    flip, per metav1 semantics)."""
    conds = get_nested(cr, "status", "conditions", default=None)
    if conds is None:
        conds = []
        set_nested(cr, conds, "status", "conditions")
    gen = get_nested(cr, "metadata", "generation", default=0)
    for c in conds:
        if c.get("type") == type_:
            changed = (c.get("status") != status or c.get("reason") != reason
                       or c.get("message") != message
                       or c.get("observedGeneration") != gen)
            if c.get("status") != status:
                c["lastTransitionTime"] = _now()
            c.update({"status": status, "reason": reason, "message": message,
                      "observedGeneration": gen})
            return changed
    conds.append({"type": type_, "status": status, "reason": reason,
                  "message": message, "observedGeneration": gen,
                  "lastTransitionTime": _now()})
    return True


def update_status_with_retry(client: Client, cr: dict,
                              attempts: int = 3,
                              live: Optional[dict] = None) -> None:
    """Status write with retry-on-conflict (client-go
    retry.RetryOnConflict semantics): the CR's spec/metadata move under
    the reconciler constantly (users edit the spec, the upgrade
    controller annotates), and a 409 here otherwise costs the whole
    reconcile a backoff requeue — on a busy cluster that starves
    convergence. Status is reconciler-owned, so re-getting the object
    and re-applying OUR status over the fresh resourceVersion is safe
    last-writer-wins on fields nobody else writes.

    ``live`` (the cached read the reconciler started from) enables the
    zero-write steady state: when the computed status equals the live
    status, the write is skipped client-side — even a server-side no-op
    update_status still counts as an apiserver request. Gated by
    OPERATOR_SPEC_HASH like the skel's spec-hash skip."""
    if (live is not None and SPEC_HASH_GATE.enabled
            and (live.get("status") or {}) == (cr.get("status") or {})):
        from ..metrics.operator_metrics import OPERATOR_METRICS

        OPERATOR_METRICS.writes_avoided.labels(
            kind=cr.get("kind", "")).inc()
        return
    for attempt in range(attempts):
        try:
            client.update_status(cr)
            return
        except NotFoundError:
            # the CR was deleted mid-reconcile (uninstall races the
            # in-flight pass): there is no status left to write and the
            # next reconcile observes the deletion — not an error
            return
        except ConflictError:
            if attempt == attempts - 1:
                raise
            try:
                fresh = client.get(cr.get("apiVersion", ""),
                                   cr.get("kind", ""), name_of(cr),
                                   namespace_of(cr) or None)
            except NotFoundError:
                return  # deleted between the conflict and the re-get
            fresh = thaw_obj(fresh)
            fresh["status"] = cr.get("status") or {}
            cr = fresh


def set_ready(client: Client, cr: dict, message: str = "",
              live: Optional[dict] = None) -> None:
    """Ready=True, Error=False (conditions.Updater.SetConditionsReady)."""
    if isinstance(cr, FrozenDict):
        live, cr = cr, thaw_obj(cr)  # frozen read passed straight in
    set_condition(cr, COND_READY, "True", REASON_RECONCILED, message)
    set_condition(cr, COND_ERROR, "False", REASON_RECONCILED, "")
    update_status_with_retry(client, cr, live=live)


def set_not_ready(client: Client, cr: dict, reason: str, message: str,
                  live: Optional[dict] = None) -> None:
    if isinstance(cr, FrozenDict):
        live, cr = cr, thaw_obj(cr)
    set_condition(cr, COND_READY, "False", reason, message)
    set_condition(cr, COND_ERROR, "False", REASON_RECONCILED, "")
    update_status_with_retry(client, cr, live=live)


def set_error(client: Client, cr: dict, reason: str, message: str,
              live: Optional[dict] = None) -> None:
    """Ready=False, Error=True (SetConditionsError)."""
    if isinstance(cr, FrozenDict):
        live, cr = cr, thaw_obj(cr)
    set_condition(cr, COND_READY, "False", reason, message)
    set_condition(cr, COND_ERROR, "True", reason, message)
    update_status_with_retry(client, cr, live=live)


def get_condition(cr: dict, type_: str) -> Optional[dict]:
    for c in get_nested(cr, "status", "conditions", default=[]) or []:
        if c.get("type") == type_:
            return c
    return None

"""Per-pool readiness rows for ``status.slices[]``, and the operator's
half of the elastic-slice protocol.

The port's counterpart of ``tpu_operator/controllers/slices.py``. A row
is one slice of a multi-host pool — an ``mnnvl`` pool, whose NVLink
domain spans hosts (``state/nodepool.py``) — keyed by GKE's nodepool, as
the topology manager's grouped agreement keys it:

    {id, product, topology, hosts, hostsValidated, validated, upgradeState}

A slice is ``validated`` only when EVERY host's validation-gate pod is
Ready (grouped readiness). Terminating pods don't count: a dying
validator's Ready=True is the OLD proof, not a re-validation. Single-host
pools are not listed: their readiness is already the per-state status.

The elastic half (``clear_intent``, ``post_intent``, ``abort_migration``,
the binding move, the shard-handoff planner and ``SliceMigrator``) is the
reference's, over the port's placement engine: the upgrade FSM's migrate
stage asks the migrator whether a unit may drain, and a Placed
SliceRequest bound to the unit is checkpointed by its workload and
rebound onto replacement capacity first.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Iterable, List, Optional

from ..api import labels as L
from ..api.conditions import update_status_with_retry
from ..api.slicerequest import (
    INTENT_MIGRATE,
    KIND_SLICE_REQUEST,
    MIG_ABORTED,
    MIG_CHECKPOINTED,
    MIG_MIGRATING,
    MIG_REBOUND,
    MIG_RESHARDING,
    MIG_RESUMED,
    MIG_TERMINAL,
    PHASE_PLACED,
    V1ALPHA1,
    SliceRequestSpec,
)
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.client import Client, ListOptions
from ..runtime.objects import (
    annotations_of,
    get_nested,
    labels_of,
    name_of,
    namespace_of,
    pod_ready,
    set_nested,
    thaw_obj,
)
from ..runtime.timeline import TIMELINE
from ..state.nodepool import get_node_pools, slices_of

log = logging.getLogger("tpu_operator_torch.slices")

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


# --- elastic-slice protocol (slice-intent contract) ------------------------
#
# The handshake, driven from both ends:
#
#   operator                        workload shim (workloads/elastic.py)
#   --------                        ------------------------------------
#   post intent annotation +        sees intent, checkpoints at the next
#   status.migration Migrating ->   step boundary, acks the durable step
#                                   (annotation + status Checkpointed) ->
#   leases replacement window,
#   rewrites the binding
#   (status Rebound) ->             restores the acked step on the new
#                                   topology (status Resumed)
#
# Past the deadline the operator aborts the attempt (status Aborted,
# outcome=timeout) and degrades to the pre-elastic hard drain — the
# workload loses only un-ACKED steps, never acknowledged ones. All
# timestamps flow through an injectable clock, so a run driven off a
# virtual clock is byte-identical per seed.


def request_key(cr: dict) -> str:
    return f"{namespace_of(cr) or 'default'}/{name_of(cr)}"


def migration_of(cr: dict) -> dict:
    return dict(get_nested(cr, "status", "migration", default={}) or {})


def _fmt_ts(ts: float) -> str:
    return f"{float(ts):.3f}"


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


def clear_intent(client: Client, cr: dict) -> None:
    client.patch(
        V1ALPHA1, KIND_SLICE_REQUEST, name_of(cr),
        {"metadata": {"annotations": {L.SLICE_INTENT: None,
                                      L.SLICE_INTENT_DEADLINE: None,
                                      L.SLICE_INTENT_ACK: None}}},
        namespace=namespace_of(cr))


def post_intent(client: Client, cr: dict, live: dict, intent: str,
                deadline: float, now: float,
                extra: Optional[dict] = None) -> None:
    """Open a migration attempt: intent annotations first (the workload's
    trigger), then status.migration (the observable phase)."""
    key = request_key(cr)
    client.patch(
        V1ALPHA1, KIND_SLICE_REQUEST, name_of(cr),
        {"metadata": {"annotations": {
            L.SLICE_INTENT: intent,
            L.SLICE_INTENT_DEADLINE: _fmt_ts(deadline),
            L.SLICE_INTENT_ACK: None}}},
        namespace=namespace_of(cr))
    mig = {
        "phase": MIG_MIGRATING,
        "intent": intent,
        "deadline": _fmt_ts(deadline),
        "startedAt": _fmt_ts(now),
        "from": sorted(get_nested(cr, "status", "nodes", default=[]) or []),
    }
    mig.update(extra or {})
    set_nested(cr, mig, "status", "migration")
    update_status_with_retry(client, cr, live=live)
    if TIMELINE.enabled:
        TIMELINE.record("SliceRequest", key, "migration:" + MIG_MIGRATING,
                        {"intent": intent, "deadline": _fmt_ts(deadline),
                         "from": mig["from"]})
    log.info("posted %s intent on %s (deadline %s)", intent, key,
             _fmt_ts(deadline))


def abort_migration(client: Client, cr: dict, live: dict, reason: str,
                    outcome: str, extra: Optional[dict] = None) -> None:
    """Retire the current attempt; the hard-drain (or the unchanged
    binding, for a resize) is the degradation the caller falls back to.
    Intent annotations are kept so the attempt stays idempotent within
    its deadline window — a fresh attempt posts a fresh deadline."""
    mig = migration_of(cr)
    mig["phase"] = MIG_ABORTED
    mig["reason"] = reason
    mig.update(extra or {})
    mig.pop("to", None)
    set_nested(cr, mig, "status", "migration")
    update_status_with_retry(client, cr, live=live)
    OPERATOR_METRICS.slice_migrations.labels(outcome=outcome).inc()
    if TIMELINE.enabled:
        TIMELINE.record("SliceRequest", request_key(cr),
                        "migration:" + MIG_ABORTED,
                        {"outcome": outcome, "reason": reason})
    log.warning("migration of %s aborted (%s): %s",
                request_key(cr), outcome, reason)


def _move_binding(client: Client, cr: dict, live: dict,
                  spec: SliceRequestSpec, candidate, now: float,
                  outcome: str, phase: str,
                  mig_extra: Optional[dict] = None) -> None:
    """Move a Placed binding onto ``candidate``'s window: lease the new
    nodes BEFORE publishing status (placement-sound, same order as the
    initial bind), then release the leases left behind. A crash between
    status and release leaves orphan self-leases, which the placement
    controller's Placed-sound sweep reclaims. ``phase`` is Rebound for
    the full-checkpoint path, Resharding for the direct shard handoff —
    the workload's restore strategy keys off it."""
    key = request_key(cr)
    old = set(get_nested(cr, "status", "nodes", default=[]) or [])
    new = set(candidate.nodes)
    for n in sorted(new):
        client.patch("v1", "Node", n,
                     {"metadata": {"annotations": {L.PLACED_BY: key}}})
    mig = migration_of(cr)
    mig["phase"] = phase
    mig["to"] = sorted(new)
    mig.pop("reason", None)
    mig.update(mig_extra or {})
    set_nested(cr, mig, "status", "migration")
    set_nested(cr, sorted(new), "status", "nodes")
    set_nested(cr, candidate.pool, "status", "pool")
    set_nested(cr, candidate.slice_id, "status", "sliceId")
    set_nested(cr, f"{candidate.score:.6f}", "status", "score")
    set_nested(cr, spec.chips_needed(), "status", "chips")
    set_nested(cr, int(get_nested(cr, "status", "migrations",
                                  default=0) or 0) + 1,
               "status", "migrations")
    update_status_with_retry(client, cr, live=live)
    for n in sorted(old - new):
        node = client.get_or_none("v1", "Node", n)
        if node is not None and annotations_of(node).get(L.PLACED_BY) == key:
            client.patch("v1", "Node", n,
                         {"metadata": {"annotations": {L.PLACED_BY: None}}})
    clear_intent(client, cr)
    OPERATOR_METRICS.slice_migrations.labels(outcome=outcome).inc()
    if TIMELINE.enabled:
        TIMELINE.record("SliceRequest", key, "migration:" + phase,
                        {"outcome": outcome, "pool": candidate.pool,
                         "score": f"{candidate.score:.6f}",
                         "from": sorted(old), "to": sorted(new)})
    started = mig.get("startedAt")
    if started:
        OPERATOR_METRICS.slice_migration_duration.observe(
            max(0.0, now - float(started)))
    log.info("request %s rebound %s -> %s (%s)", key,
             sorted(old), sorted(new), outcome)


def rebind_request(client: Client, cr: dict, live: dict,
                   spec: SliceRequestSpec, candidate, now: float,
                   outcome: str) -> None:
    """The full-checkpoint rebind: every byte of the acked checkpoint is
    restored on the new binding. Stamps path=full-checkpoint so the CLI
    can show which road a completed move took."""
    _move_binding(client, cr, live, spec, candidate, now, outcome,
                  phase=MIG_REBOUND,
                  mig_extra={"path": "full-checkpoint"})


def _handoff_ineligible(cr: dict, candidate) -> Optional[str]:
    """None when a direct shard handoff onto ``candidate`` is sound,
    else the fallback reason. Pure (no metrics, no I/O) so the resize
    path can also use it to PREFER a same-domain candidate: the exact-
    fit scorer routinely out-ranks a job's own window with a window in
    another pool, and for a resize the byte bill dominates the score
    margin. Sound means:

    - the sharded layout is enabled and the workload's ack published
      its shard map at the operator's layout version,
    - the candidate stays in the SAME NVLink domain (same pool, at least
      one surviving host — a cross-domain move shares no interconnect,
      every shard travels anyway)."""
    from ..workloads.elastic import LAYOUT_VERSION, SHARDED_CKPT_GATE

    if not SHARDED_CKPT_GATE.enabled:
        return "disabled"
    layout = migration_of(cr).get("layout")
    if not layout or not layout.get("shards"):
        return "no-layout"
    if int(layout.get("version", -1)) != LAYOUT_VERSION:
        return "layout-version"
    old_nodes = set(get_nested(cr, "status", "nodes", default=[]) or [])
    if candidate.pool != get_nested(cr, "status", "pool") \
            or not old_nodes & set(candidate.nodes):
        return "cross-domain"
    return None


def handoff_eligible(cr: dict, candidate) -> bool:
    return _handoff_ineligible(cr, candidate) is None


def plan_handoff(cr: dict, candidate) -> Optional[dict]:
    """Fast-path eligibility + shard-movement plan for a resize onto
    ``candidate``. Returns the plan (bytes/shards accounted) only when
    the direct handoff is sound (see :func:`_handoff_ineligible`) and
    the planner can diff the layouts (no version skew, same shard set).
    Any mismatch returns None (counted by reason) and the caller rides
    the existing atomic full-checkpoint path — the fast path is an
    optimization, never a new failure mode."""
    import time as _time

    from ..workloads.elastic import plan_reshard, rebalance_layout

    def fallback(reason: str) -> None:
        OPERATOR_METRICS.reshard_fallbacks.labels(reason=reason).inc()

    reason = _handoff_ineligible(cr, candidate)
    if reason is not None:
        fallback(reason)
        return None
    layout = migration_of(cr).get("layout")
    t0 = _time.perf_counter()
    plan = plan_reshard(layout, rebalance_layout(layout, candidate.nodes))
    OPERATOR_METRICS.reshard_plan_seconds.observe(
        _time.perf_counter() - t0)
    if not plan["compatible"]:
        fallback("incompatible")
        return None
    return plan


def reshard_request(client: Client, cr: dict, live: dict,
                    spec: SliceRequestSpec, candidate, now: float,
                    plan: dict) -> None:
    """The same-domain direct shard handoff: surviving hosts keep their
    shards in place, only the planned moves travel. The binding move is
    the SAME placement-sound lease dance as a full rebind — only the
    phase (Resharding) and the byte bill differ; the workload's restore
    fetches exactly the planned shards and falls back to the full
    restore on any torn manifest."""
    _move_binding(client, cr, live, spec, candidate, now,
                  outcome="resharded", phase=MIG_RESHARDING,
                  mig_extra={"path": "sharded-handoff",
                             "bytesMoved": int(plan["bytesMoved"]),
                             "shardsMoved": int(plan["shardsMoved"])})
    OPERATOR_METRICS.reshard_bytes_moved.inc(int(plan["bytesMoved"]))
    OPERATOR_METRICS.reshard_shard_handoffs.inc(int(plan["shardsMoved"]))


class SliceMigrator:
    """Drives the migrate half of the protocol for the upgrade FSM.

    Stateless across passes — every decision is recomputed from the
    cluster, so a controller restart mid-handshake resumes where the
    annotations/status say it left off. ``ready_to_drain`` returns True
    only when every placed request on the unit has either rebound onto
    replacement capacity or exhausted its deadline (hard-drain
    degradation)."""

    def __init__(self, client: Client, now: Callable[[], float] = time.time):
        self.client = client
        self.now = now

    def ready_to_drain(self, unit_nodes: List[str], deadline: float) -> bool:
        ready = True
        for live in placed_requests_on(self.client, unit_nodes):
            if not self._advance_one(live, unit_nodes, deadline):
                ready = False
        return ready

    def _advance_one(self, live: dict, unit_nodes: List[str],
                     deadline: float) -> bool:
        cr = thaw_obj(live)
        key = request_key(cr)
        anns = annotations_of(cr)
        phase = migration_of(cr).get("phase", "")
        intent = anns.get(L.SLICE_INTENT)
        try:
            raw = anns.get(L.SLICE_INTENT_DEADLINE)
            ann_deadline = float(raw) if raw is not None else None
        except (TypeError, ValueError):
            ann_deadline = None
        live_attempt = (intent is not None and ann_deadline is not None
                        and self.now() <= ann_deadline)
        if not live_attempt:
            # an expired attempt still mid-phase degrades to the hard
            # drain right now; otherwise open a fresh attempt for THIS
            # drain (unless the workload opted out of the handshake, or
            # our own window is already gone)
            if intent is not None and phase not in MIG_TERMINAL:
                abort_migration(self.client, cr, live,
                                "migration deadline exceeded; hard drain",
                                outcome="timeout")
                return True
            if anns.get(L.SLICE_ELASTIC) == "false":
                return True
            if self.now() > deadline:
                return True
            post_intent(self.client, cr, live, INTENT_MIGRATE,
                        deadline, self.now())
            return False
        # an attempt is live — ours, a sibling upgrade unit's (a request
        # spanning two draining units), or a concurrent resize. The SAME
        # phase machine drives all of them off the ANNOTATION's deadline,
        # so two units sharing a request never ping-pong reposts
        if phase in (MIG_REBOUND, MIG_RESHARDING, MIG_RESUMED, MIG_ABORTED):
            return True
        if phase == MIG_CHECKPOINTED:
            from .placement_controller import find_replacement

            spec = SliceRequestSpec.from_obj(cr)
            cand = find_replacement(self.client, spec, key,
                                    exclude=unit_nodes)
            if cand is not None:
                rebind_request(self.client, cr, live, spec, cand,
                               self.now(), outcome="migrated")
                return True
        return False

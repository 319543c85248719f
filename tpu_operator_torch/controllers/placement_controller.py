"""SliceRequest reconciler — placement decisions as state.

The port's counterpart of
``tpu_operator/controllers/placement_controller.py``. Binds the pure
engine (topology/placement.py) to the cluster: a ``SliceRequest`` moves
through ``status.phase: Pending -> Placed`` (or ``Unschedulable``), and
every chosen node carries the ``gpu.graft.dev/placed-by = <ns>/<name>``
lease annotation. The lease is
written BEFORE the status so two requests can never observe the same
node as free across a crash between the two writes (placement-sound).

A Placed request is re-checked, not re-placed: the binding only breaks
through an explicit drain event — node gone, lease lost/stolen, or
accelerator pin violated — which increments ``status.evictions`` and
records ``status.lastEvictionReason`` before the request re-enters
Pending (placement-stable: no silent moves). Node NotReady flaps do NOT
evict; placements ride through kubelet restarts.

Priority preemption exists but is OFF by default
(OPERATOR_PLACEMENT_PREEMPTION=1 to enable): when nothing fits, Placed
requests of strictly lower priority are drained lowest-first until the
request fits or no victims remain.

Plugs into the existing planes: reads ride the informer cache, every
reconcile is traced with a child span per scoring pass, and status
writes are skipped when nothing changed (the zero-write steady state).
No wall clocks or RNG touch status: a run driven off a virtual clock is
byte-identical per seed. As one cell of a federated fleet
(``cell=...``) it places only the requests the global router pinned to
that cell (``federation/router.py``); ``cell=None`` is the
single-cluster mode.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Iterable, Optional

from ..api import labels as L
from ..api.conditions import update_status_with_retry
from ..api.slicerequest import (
    INTENT_GROW,
    INTENT_MIGRATE,
    INTENT_SHRINK,
    KIND_SLICE_REQUEST,
    MIG_ABORTED,
    MIG_CHECKPOINTED,
    MIG_MIGRATING,
    MIG_REBOUND,
    MIG_RESHARDING,
    PHASE_PENDING,
    PHASE_PLACED,
    PHASE_UNSCHEDULABLE,
    V1ALPHA1,
    SliceRequestSpec,
)
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.timeline import TIMELINE
from ..runtime.workqueue import Cause
from ..scheduling.quota import (
    _GEN_TFLOPS,
    ADMISSION_GATE,
    KIND_GPU_QUOTA,
    POLICY_BASELINE,
    QUOTA_CONFIGMAP,
    AdmissionState,
    QuotaTree,
    baseline_key,
    order_batch,
    quota_report,
)
from ..scheduling.quota import V1ALPHA1 as QUOTA_API
from ..runtime import (
    LANE_HEALTH,
    LANE_PLACEMENT,
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
    WatchEvent,
    generation_changed,
)
from ..runtime.objects import (
    annotations_of,
    get_nested,
    labels_of,
    name_of,
    namespace_of,
    pop_nested,
    set_nested,
    thaw_obj,
)
from ..topology.index import PLACEMENT_INDEX_GATE, FleetIndex
from ..topology.placement import (
    FleetState,
    _node_telemetry_ok,
    rank_candidates,
    unschedulable_reason,
)

log = logging.getLogger("tpu_operator_torch.placement")

# Unschedulable requeues back off exponentially (base doubling per
# attempt, capped) instead of the old fixed 30s: a request that will not
# fit for hours must not re-score the fleet every 30s, while a request
# blocked on one draining node retries quickly at first. The jitter that
# de-synchronizes a thundering herd of Unschedulable requests is seeded
# from (request key, attempt) — fully deterministic per seed.
REQUEUE_UNSCHEDULABLE_BASE_S = 5.0
REQUEUE_UNSCHEDULABLE_CAP_S = 240.0

# deadline for a shrink/grow resize handshake (spec edit on a Placed
# request); past it the attempt aborts and the old binding stands
RESIZE_TIMEOUT_S = 120.0
REQUEUE_RESIZE_S = 5.0


def unschedulable_backoff(key: str, attempt: int) -> float:
    delay = min(REQUEUE_UNSCHEDULABLE_CAP_S,
                REQUEUE_UNSCHEDULABLE_BASE_S * (2 ** min(attempt, 16)))
    jitter = random.Random(f"requeue:{key}:{attempt}").uniform(
        0.0, delay / 4.0)
    return delay + jitter


def find_replacement(client, spec: SliceRequestSpec, key: str,
                     exclude: Iterable[str] = ()):
    """Best candidate window for ``spec`` with the draining domain
    carved out of the fleet entirely (its leases, capacity and adjacency
    must not score). Returns None when nothing fits — the caller decides
    between waiting and degrading."""
    shut = set(exclude)
    nodes = [n for n in client.list("v1", "Node") if name_of(n) not in shut]
    ranked = rank_candidates(spec, FleetState(nodes), reclaim=key)
    return ranked[0] if ranked else None


def _env_preemption() -> bool:
    return os.environ.get("OPERATOR_PLACEMENT_PREEMPTION", "0").lower() in (
        "1", "true", "yes", "on")


def _node_placement_changed(event: WatchEvent, old: Optional[dict]) -> bool:
    """Node edges the placement loop cares about: existence, schedulability,
    readiness, lease annotations, and the pool-identity labels."""
    if event.type in ("ADDED", "DELETED") or old is None:
        return True
    new = event.obj

    def facet(n):
        nl = labels_of(n)
        return (
            get_nested(n, "spec", "unschedulable", default=False),
            any(c.get("type") == "Ready" and c.get("status") == "True"
                for c in get_nested(n, "status", "conditions",
                                    default=[]) or []),
            _node_telemetry_ok(n),
            annotations_of(n).get(L.PLACED_BY),
            nl.get(L.GPU_PRODUCT),
            nl.get(L.GPU_TOPOLOGY),
            nl.get(L.GKE_NODEPOOL),
        )

    return facet(new) != facet(old)


class PlacementReconciler(Reconciler):
    name = "sliceplacement"
    primary_kind = "SliceRequest"

    def __init__(self, client, namespace: Optional[str] = None,
                 preemption: Optional[bool] = None,
                 now=time.time, resize_timeout: float = RESIZE_TIMEOUT_S,
                 quota: Optional[QuotaTree] = None,
                 admission_policy: Optional[str] = None,
                 cell: Optional[str] = None):
        self.client = client
        self.namespace = namespace or os.environ.get(
            "OPERATOR_NAMESPACE", "gpu-operator")
        # federation rider: when this reconciler runs as one cell of a
        # federated fleet, it only places requests the global router
        # pinned to it (L.CELL_PIN). An UNPINNED request is a global-
        # queue entry the router still owes a decision — touching it
        # here would race the routing decision. None (the default) is
        # the single-cluster mode: pins are ignored entirely.
        self.cell = cell
        self.preemption = (_env_preemption() if preemption is None
                           else preemption)
        self.now = now
        self.resize_timeout = resize_timeout
        # fair-share admission: an injected QuotaTree wins; None means
        # load the GPUQuota CRD / gpu-operator-quota ConfigMap per gang
        # pass (rides the informer cache — no config means a strict
        # no-op and the legacy pass, byte for byte)
        self.quota = quota
        self.admission_policy = admission_policy
        # deficit clocks + preemption-budget buckets; snapshot-persisted
        # (schema v3) so a crash never resets starvation accounting
        self._admission = AdmissionState()
        # starvation watchdog -> workqueue health-lane promotion; wired
        # by setup_controller, absent in library/bench use
        self._escalate_fn = None
        # quota config memo keyed on resourceVersion, and the virtual
        # timestamp of the last admission pass (a gang pass at the same
        # instant would re-derive the identical decisions)
        self._quota_cache = None
        self._admission_last_pass = None
        # place-and-bind is read-rank-annotate: serialized so N workers
        # placing different requests can't both observe a node as free
        self._bind_lock = threading.Lock()
        # long-lived incremental fleet view (OPERATOR_PLACEMENT_INDEX=0
        # falls back to per-request FleetState rebuilds). When the client
        # exposes a delta-listener hook the index rides watch events in
        # O(delta); otherwise each pass resyncs it from a list diff.
        self._index: Optional[FleetIndex] = None
        self._index_live = False
        self._index_mu = threading.RLock()
        # Unschedulable backoff attempt per request key; reset on any
        # successful placement or deletion. The count is persisted in
        # ``status.requeueAttempts`` (riding the Unschedulable status
        # write, no extra apiserver call) and re-derived lazily after a
        # process restart — a restart must not collapse a fleet of 240s
        # backoffs into an immediate-retry storm right when the
        # apiserver is weakest.
        self._unsched_attempts = {}

    @property
    def fleet_index(self) -> Optional[FleetIndex]:
        """The long-lived placement index, if built — the Manager's
        snapshot writer captures it alongside the cache stores."""
        return self._index

    def adopt_index(self, index: FleetIndex) -> None:
        """Warm-restore: adopt a snapshot-restored FleetIndex instead of
        paying a full rebuild. Called after the cache stores are seeded
        but BEFORE any watch subscribes, so the delta listener registered
        here sees the subscribe replay — which the cache reduces to the
        changes since the snapshot — and folds exactly that delta."""
        with self._index_mu:
            reg = getattr(self.client, "add_delta_listener", None)
            if callable(reg):
                reg("v1", "Node", self._on_node_delta)
                self._index_live = True
            self._index = index
        OPERATOR_METRICS.placement_index_updates.labels(
            event="adopt").inc()

    def admission_snapshot(self) -> dict:
        """JSON-safe admission state (deficit clocks, token buckets) for
        the durable snapshot's ``admission`` section."""
        return self._admission.to_dict()

    def adopt_admission(self, doc: Optional[dict]) -> None:
        """Warm-restore: adopt snapshot-persisted admission state so a
        restart resumes mid-deficit instead of resetting every class's
        starvation clock to zero."""
        self._admission = AdmissionState.from_dict(doc)

    def admission_report(self) -> dict:
        """The live quota explainer (``/debug/quota``): the shared report with THIS process's deficit
        clocks and token buckets folded in."""
        tree = self.quota if self.quota is not None \
            else QuotaTree.load(self.client, self.namespace)
        return quota_report(self.client, self.namespace, tree=tree,
                            state=self._admission,
                            policy=self._policy(), now=self.now)

    def _policy(self) -> str:
        return self.admission_policy or ADMISSION_GATE.policy

    def _quota_tree(self) -> Optional[QuotaTree]:
        """Per-pass quota lookup, memoized on config resourceVersion:
        the common case (config unchanged) costs two cache reads, not a
        JSON parse and tree rebuild on every gang pass."""
        if self.quota is not None:
            return self.quota
        key: tuple = ()
        try:
            key += tuple(sorted(
                (name_of(o) or "",
                 str(get_nested(o, "metadata", "resourceVersion")))
                for o in self.client.list(QUOTA_API, KIND_GPU_QUOTA)))
        except Exception:
            pass
        try:
            cm = self.client.get_or_none("v1", "ConfigMap",
                                         QUOTA_CONFIGMAP, self.namespace)
        except Exception:
            cm = None
        if cm is not None:
            key += (("cm", str(get_nested(cm, "metadata",
                                          "resourceVersion"))),)
        cached = self._quota_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        tree = QuotaTree.load(self.client, self.namespace)
        self._quota_cache = (key, tree)
        return tree

    def seed_requeue_state(self, requests: Iterable[dict]) -> int:
        """Warm-restore hook: pre-seed the in-memory backoff counters
        from the ``status.requeueAttempts`` a previous process
        persisted, so requeues after a restart resume mid-schedule."""
        from ..runtime.snapshot import derive_requeue_state

        seeded = 0
        for (ns, name), attempts in derive_requeue_state(requests).items():
            key = f"{ns or 'default'}/{name}"
            if key not in self._unsched_attempts:
                self._unsched_attempts[key] = attempts
                seeded += 1
        return seeded

    # -- wiring ------------------------------------------------------------

    def setup_controller(self, controller: Controller, manager: Manager):
        # spec edges only: our own status writes must not re-trigger;
        # placement lane — scoring requests outranks bulk churn but
        # yields to node-health events
        controller.watch(V1ALPHA1, KIND_SLICE_REQUEST,
                         predicate=generation_changed,
                         lane=LANE_PLACEMENT)
        # node edges re-examine every request: a freed node can unblock
        # an Unschedulable request, a removed node breaks a binding —
        # that's fleet health, so it preempts both other lanes
        controller.watch("v1", "Node",
                         predicate=_node_placement_changed,
                         mapper=self._enqueue_all_requests,
                         lane=LANE_HEALTH)
        # starvation watchdog: a starving class's queued requests jump
        # the placement/bulk churn via the queue's escalate path (any
        # controller stand-in without one still promotes through add)
        esc = getattr(controller, "escalate", None)
        if esc is None:
            def esc(req, cause=None, _c=controller):
                _c.add(req, lane=LANE_HEALTH, cause=cause)
        self._escalate_fn = esc

    def _enqueue_all_requests(self, event: WatchEvent) -> Iterable[Request]:
        for cr in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
            yield Request(name=name_of(cr), namespace=namespace_of(cr))

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, request: Request) -> Result:
        import time as _time

        from ..runtime.tracing import TRACER

        started = _time.perf_counter()
        try:
            with TRACER.trace(self.name, str(request)):
                return self._reconcile(request)
        finally:
            OPERATOR_METRICS.reconcile_duration_by_controller.labels(
                controller=self.name).observe(
                    _time.perf_counter() - started)

    def _reconcile(self, request: Request) -> Result:
        key = f"{request.namespace or 'default'}/{request.name}"
        live = self.client.get_or_none(
            V1ALPHA1, KIND_SLICE_REQUEST, request.name,
            request.namespace or None)
        if live is None:
            # request deleted: return its nodes to the pool, and retire
            # the per-request checkpoint-age series — a gauge child for
            # a deleted request would otherwise export its last value
            # forever (and look like an ever-staler checkpoint)
            self._unsched_attempts.pop(key, None)
            try:
                OPERATOR_METRICS.slice_checkpoint_age.remove(key)
            except KeyError:
                pass
            if self._release_leases(key):
                OPERATOR_METRICS.placement_decisions.labels(
                    outcome="released").inc()
                if TIMELINE.enabled:
                    TIMELINE.record("SliceRequest", key, "released",
                                    {"controller": self.name})
            return Result()
        cr = thaw_obj(live)
        if self.cell is not None \
                and annotations_of(cr).get(L.CELL_PIN) != self.cell:
            # not (or not yet) this cell's request — the router owns it
            return Result()
        spec = SliceRequestSpec.from_obj(cr)
        phase = get_nested(cr, "status", "phase")

        if phase == PHASE_PLACED:
            broken = self._binding_broken(cr, spec, key)
            if broken is None:
                self._unsched_attempts.pop(key, None)
                nodes = self.client.list("v1", "Node")
                # heal orphan self-leases: a crash between a migration's
                # status write and its old-lease release strands leases
                # on nodes outside the (new) binding
                bound = set(get_nested(cr, "status", "nodes",
                                       default=[]) or [])
                for node in nodes:
                    n = name_of(node)
                    if (annotations_of(node).get(L.PLACED_BY) == key
                            and n not in bound):
                        self.client.patch(
                            "v1", "Node", n,
                            {"metadata": {"annotations": {
                                L.PLACED_BY: None}}})
                res = self._reap_expired_migration(cr, live)
                if res is None:
                    res = self._complete_preemption(cr, live, key)
                if res is None:
                    res = self._maybe_resize(cr, live, spec, key)
                self._export_gauges(nodes)
                return res if res is not None else Result()
            # explicit drain event: the ONLY path off a placement
            self._release_leases(key)
            from .slices import clear_intent, migration_of
            mig = migration_of(cr)
            if mig.get("phase") in (MIG_MIGRATING, MIG_CHECKPOINTED,
                                    MIG_REBOUND, MIG_RESHARDING):
                # an eviction supersedes any in-flight handshake; the
                # workload restores from its last durable checkpoint on
                # the replacement binding, so no ACKED work is lost
                mig["phase"] = MIG_ABORTED
                mig["reason"] = f"evicted: {broken}"
                set_nested(cr, mig, "status", "migration")
                clear_intent(self.client, cr)
                OPERATOR_METRICS.slice_migrations.labels(
                    outcome="aborted").inc()
            set_nested(cr, PHASE_PENDING, "status", "phase")
            set_nested(cr, [], "status", "nodes")
            set_nested(cr, int(get_nested(cr, "status", "evictions",
                                          default=0) or 0) + 1,
                       "status", "evictions")
            set_nested(cr, broken, "status", "lastEvictionReason")
            update_status_with_retry(self.client, cr, live=live)
            OPERATOR_METRICS.placement_decisions.labels(
                outcome="evicted").inc()
            if TIMELINE.enabled:
                TIMELINE.record("SliceRequest", key, "evicted",
                                {"controller": self.name,
                                 "reason": broken})
            log.info("request %s drained: %s", key, broken)
            return Result(requeue=True)

        # Pending / Unschedulable / new: run a scoring pass. With the
        # incremental index enabled, all Pending siblings visible right
        # now ride the same pass against one shared snapshot with
        # in-pass booking (batched gang placement) — a mass submission
        # costs one fleet view, not one rebuild per request. Their own
        # queued reconciles then no-op (they observe Placed) or pick up
        # their backoff (they observe Unschedulable).
        with self._bind_lock:
            engine = self._fleet_snapshot()
            tree = self._quota_tree()
            if PLACEMENT_INDEX_GATE.enabled:
                batch = self._drain_batch(key, cr, live, spec, tree=tree)
            else:
                batch = [(key, cr, live, spec)]
            batch = self._admission_order(batch, tree, engine)
            OPERATOR_METRICS.placement_batch_size.set(len(batch))
            my_result = Result()
            for bkey, bcr, blive, bspec in batch:
                res = self._place_one(bkey, bcr, blive, bspec, engine,
                                      tree=tree)
                if bkey == key:
                    my_result = res
            if tree is not None:
                # watchdog: advance deficit clocks, fire the starvation
                # gauges, escalate starving classes and reclaim their
                # min-guarantee via budgeted elastic preemption
                self._admission_pass(tree, engine)
            self._export_gauges(None, fleet=engine)
        return my_result

    # -- placement pass ----------------------------------------------------

    def _fleet_snapshot(self):
        """The pass's bookable fleet view: the long-lived FleetIndex
        (built once, then O(delta) via the client's delta listener or a
        per-pass list diff), or a fresh FleetState when the index is
        killed — either way ONE snapshot per pass, shared by scoring,
        preemption trials, lease bookkeeping and gauges."""
        if not PLACEMENT_INDEX_GATE.enabled:
            return FleetState(self.client.list("v1", "Node"))
        with self._index_mu:
            idx = self._index
            if idx is None:
                reg = getattr(self.client, "add_delta_listener", None)
                if callable(reg):
                    # register BEFORE the seeding list: deltas racing the
                    # build block on the init lock and fold in after it
                    reg("v1", "Node", self._on_node_delta)
                    self._index_live = True
                idx = FleetIndex(self.client.list("v1", "Node"))
                self._index = idx
                OPERATOR_METRICS.placement_index_updates.labels(
                    event="replace").inc()
                return idx
        if not self._index_live:
            idx.resync(self.client.list("v1", "Node"))
            OPERATOR_METRICS.placement_index_updates.labels(
                event="resync").inc()
        return idx

    def _on_node_delta(self, event_type: str, obj: dict) -> None:
        with self._index_mu:
            idx = self._index
            if idx is None:
                # pre-build replay; the seeding list covers these
                return
            idx.apply(event_type, obj)
        OPERATOR_METRICS.placement_index_updates.labels(
            event=str(event_type).lower()).inc()

    def _drain_batch(self, key: str, cr: dict, live: dict,
                     spec: SliceRequestSpec,
                     tree: Optional[QuotaTree] = None) -> list:
        """The gang for this pass: every Pending/new SliceRequest
        visible now, ordered by priority (desc), age, key. Unschedulable
        siblings keep their own backoff cadence — re-scoring them on
        every sibling's pass would defeat it — but the triggering
        request always rides, whatever its phase, and so does any
        Unschedulable request of a STARVING class: between a
        preemption's lease release and the victim's own rebind there
        may be exactly one pass, and the starving class must be in it
        to claim the freed nodes (its backoff retry would arrive after
        the victim took them back)."""
        batch = {key: (cr, live, spec)}
        for other in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
            okey = f"{namespace_of(other) or 'default'}/{name_of(other)}"
            if okey in batch:
                continue
            phase = get_nested(other, "status", "phase")
            if phase == PHASE_PLACED:
                continue
            if self.cell is not None and annotations_of(other).get(
                    L.CELL_PIN) != self.cell:
                continue
            if phase == PHASE_UNSCHEDULABLE and not (
                    tree is not None
                    and self._admission.deficit_since
                    and tree.class_of(other)
                    in self._admission.deficit_since):
                continue
            ocr = thaw_obj(other)
            batch[okey] = (ocr, other, SliceRequestSpec.from_obj(ocr))

        # priority desc, then PARSED creation epoch, then (ns, name):
        # the raw-string compare broke total order as soon as two API
        # clients serialized timestamps differently (clock skew in
        # disguise) — baseline_key is deterministic under skew
        def order(item):
            k, (c, _unused, s) = item
            return baseline_key(k, c, s)

        return [(k, c, l, s)
                for k, (c, l, s) in sorted(batch.items(), key=order)]

    def _admission_order(self, batch: list, tree: Optional[QuotaTree],
                         engine) -> list:
        """Apply the selected admission policy to the gang batch. The
        baseline policy (or no quota tree) returns the batch UNCHANGED —
        the kill-switch guarantee the parity tests pin."""
        policy = self._policy()
        if tree is None or policy == POLICY_BASELINE or len(batch) <= 1:
            return batch
        usage = usage_tflops = None
        if isinstance(engine, FleetIndex):
            self._register_owner_classes(tree, engine)
            usage = engine.class_usage()
            usage_tflops = engine.class_tflops()
        else:
            usage = {}
            for other in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
                if get_nested(other, "status", "phase") != PHASE_PLACED:
                    continue
                cls = tree.class_of(other)
                usage[cls] = usage.get(cls, 0) + int(
                    get_nested(other, "status", "chips", default=0) or 0)
        dominant = max(
            (_GEN_TFLOPS.get(gen, 1.0)
             for gen in engine.chip_totals()), default=1.0)
        return order_batch(batch, policy, tree, usage=usage,
                           usage_tflops=usage_tflops,
                           dominant_tflops=dominant)

    def _register_owner_classes(self, tree: QuotaTree,
                                engine: FleetIndex) -> None:
        """Teach the index which quota class each lease owner draws
        from, so per-class usage folds O(delta) with the leases
        (set_owner_class no-ops on unchanged owners)."""
        for other in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
            okey = f"{namespace_of(other) or 'default'}/{name_of(other)}"
            engine.set_owner_class(okey, tree.class_of(other))

    def _best_for(self, spec: SliceRequestSpec, key: str, engine):
        if isinstance(engine, FleetIndex):
            return engine.best(spec, reclaim=key)
        ranked = rank_candidates(spec, engine, reclaim=key)
        return ranked[0] if ranked else None

    def _place_one(self, key: str, cr: dict, live: dict,
                   spec: SliceRequestSpec, engine,
                   tree: Optional[QuotaTree] = None) -> Result:
        """One request's placement decision against the pass's shared
        snapshot. Caller holds the bind lock. With a quota tree active,
        the legacy hard-evict preemption is superseded by the budgeted
        elastic path (_preempt_budgeted) — victims migrate, never die."""
        import time as _time

        from ..runtime.tracing import TRACER

        t0 = _time.perf_counter()
        with TRACER.trace("placement.score", key):
            best = self._best_for(spec, key, engine)
        if best is None and self.preemption and tree is None \
                and self._preempt(spec, key, engine):
            # bind in THIS pass: requeueing instead would let the
            # victims re-place onto the freed nodes before we run
            # again — a preemption livelock
            best = self._best_for(spec, key, engine)
        if best is None:
            # a partially-failed earlier bind may have leased nodes
            # before crashing; nothing fits now, so hand them back
            # rather than strand them behind an Unschedulable request
            self._release_leases(key, engine=engine)
            reason = engine.unschedulable_reason(spec) \
                if isinstance(engine, FleetIndex) \
                else unschedulable_reason(spec, engine)
            from .slices import clear_intent, migration_of
            mig = migration_of(cr)
            if mig.get("intent") == INTENT_MIGRATE \
                    and mig.get("preemptedFor") \
                    and mig.get("phase") in (MIG_MIGRATING,
                                             MIG_CHECKPOINTED):
                # a preempted slice that cannot re-place right now parks
                # Unschedulable with the handshake closed; its durable
                # checkpoint restores whenever capacity returns
                mig["phase"] = MIG_ABORTED
                mig["reason"] = "preempted; no replacement capacity yet"
                set_nested(cr, mig, "status", "migration")
                clear_intent(self.client, cr)
                OPERATOR_METRICS.slice_migrations.labels(
                    outcome="aborted").inc()
            set_nested(cr, PHASE_UNSCHEDULABLE, "status", "phase")
            set_nested(cr, [], "status", "nodes")
            set_nested(cr, reason, "status", "reason")
            attempt = self._unsched_attempts.get(key)
            if attempt is None:
                # restart re-derivation: resume the backoff schedule a
                # previous process persisted instead of restarting it
                # from the fast end
                try:
                    attempt = int(get_nested(
                        cr, "status", "requeueAttempts", default=0) or 0)
                except (TypeError, ValueError):
                    attempt = 0
            self._unsched_attempts[key] = attempt + 1
            set_nested(cr, attempt + 1, "status", "requeueAttempts")
            update_status_with_retry(self.client, cr, live=live)
            OPERATOR_METRICS.placement_decisions.labels(
                outcome="unschedulable").inc()
            if TIMELINE.enabled:
                TIMELINE.record("SliceRequest", key, "unschedulable",
                                {"controller": self.name,
                                 "reason": reason})
            OPERATOR_METRICS.placement_latency.observe(
                _time.perf_counter() - t0)
            OPERATOR_METRICS.placement_requeues.inc()
            return Result(
                requeue_after=unschedulable_backoff(key, attempt))

        # drop any stale self-leases outside the chosen window, then
        # lease the window BEFORE publishing status: a crash between
        # the two leaves leased-but-Pending (recoverable via
        # reclaim), never Placed-but-unleased
        chosen = set(best.nodes)
        for n in engine.owned_nodes(key):
            if n not in chosen:
                self.client.patch(
                    "v1", "Node", n,
                    {"metadata": {"annotations": {L.PLACED_BY: None}}})
                engine.release([n])
        for n in best.nodes:
            self.client.patch(
                "v1", "Node", n,
                {"metadata": {"annotations": {L.PLACED_BY: key}}})
        engine.book(best.nodes, key)
        from .slices import clear_intent, migration_of
        mig = migration_of(cr)
        if mig.get("intent") == INTENT_MIGRATE \
                and mig.get("preemptedFor") \
                and mig.get("phase") == MIG_CHECKPOINTED:
            # budgeted preemption completing: the victim re-binds onto
            # new capacity with its acked checkpoint intact — the elastic
            # shim restores from ackedStep and resumes (never dies)
            mig["phase"] = MIG_REBOUND
            mig["to"] = sorted(best.nodes)
            set_nested(cr, mig, "status", "migration")
            clear_intent(self.client, cr)
            OPERATOR_METRICS.slice_migrations.labels(
                outcome="preempted").inc()
        if tree is not None and isinstance(engine, FleetIndex):
            engine.set_owner_class(key, tree.class_of(cr))
        set_nested(cr, PHASE_PLACED, "status", "phase")
        set_nested(cr, sorted(best.nodes), "status", "nodes")
        set_nested(cr, best.pool, "status", "pool")
        set_nested(cr, best.slice_id, "status", "sliceId")
        set_nested(cr, f"{best.score:.6f}", "status", "score")
        set_nested(cr, spec.chips_needed(), "status", "chips")
        pop_nested(cr, "status", "reason")
        pop_nested(cr, "status", "requeueAttempts")
        update_status_with_retry(self.client, cr, live=live)
        self._unsched_attempts.pop(key, None)
        OPERATOR_METRICS.placement_decisions.labels(outcome="placed").inc()
        OPERATOR_METRICS.placement_latency.observe(
            _time.perf_counter() - t0)
        if TIMELINE.enabled:
            TIMELINE.record("SliceRequest", key, "placed",
                            {"controller": self.name, "pool": best.pool,
                             "score": f"{best.score:.6f}",
                             "nodes": sorted(best.nodes)})
        log.info("request %s placed on %s (%d nodes, score %s)",
                 key, best.pool, len(best.nodes), f"{best.score:.6f}")
        return Result()

    # -- helpers -----------------------------------------------------------

    def _reap_expired_migration(self, cr: dict,
                                live: dict) -> Optional[Result]:
        """Janitor for a migrate handshake nobody will finish: the
        migrator aborts expired attempts itself while its unit sits in
        the migrate stage, but an operator crash (or a unit forced past
        the stage) can leave the intent open forever. An expired,
        still-mid-phase migrate intent on a sound binding degrades to
        Aborted here, exactly as the migrator would have."""
        from .slices import abort_migration, migration_of

        mig = migration_of(cr)
        if mig.get("intent") != INTENT_MIGRATE \
                or mig.get("phase") not in (MIG_MIGRATING, MIG_CHECKPOINTED):
            return None
        try:
            raw = annotations_of(cr).get(L.SLICE_INTENT_DEADLINE) \
                or mig.get("deadline")
            deadline = float(raw) if raw is not None else 0.0
        except (TypeError, ValueError):
            deadline = 0.0
        if self.now() <= deadline:
            return None
        abort_migration(self.client, cr, live,
                        "migration deadline exceeded; hard drain",
                        outcome="timeout")
        return Result()

    def _complete_preemption(self, cr: dict, live: dict,
                             key: str) -> Optional[Result]:
        """Drive a budgeted preemption handshake on a sound Placed
        binding. MIGRATING waits for the workload's checkpoint ack (the
        reaper aborts it past the deadline); CHECKPOINTED releases the
        binding — the durable checkpoint is acked, so the slice re-enters
        the gang pass and *migrates* onto fair-share capacity. The
        release rides ``status.migrations`` (not an eviction): a
        preempted slice never dies."""
        from .slices import migration_of

        mig = migration_of(cr)
        if mig.get("intent") != INTENT_MIGRATE \
                or not mig.get("preemptedFor"):
            return None
        phase = mig.get("phase")
        if phase == MIG_MIGRATING:
            return Result(requeue_after=REQUEUE_RESIZE_S)
        if phase != MIG_CHECKPOINTED:
            return None
        self._release_leases(key)
        set_nested(cr, PHASE_PENDING, "status", "phase")
        set_nested(cr, [], "status", "nodes")
        set_nested(cr, int(get_nested(cr, "status", "migrations",
                                      default=0) or 0) + 1,
                   "status", "migrations")
        update_status_with_retry(self.client, cr, live=live)
        OPERATOR_METRICS.placement_decisions.labels(
            outcome="preempted").inc()
        if TIMELINE.enabled:
            TIMELINE.record("SliceRequest", key, "preempted",
                            {"controller": self.name,
                             "for": str(mig.get("preemptedFor"))})
        log.info("request %s preempted for class %s (checkpoint acked)",
                 key, mig.get("preemptedFor"))
        self._nudge_starving(str(mig.get("preemptedFor")))
        return Result(requeue=True)

    def _nudge_starving(self, fcls: str) -> None:
        """A preemption just released its leases: put the class it was
        reclaimed FOR back on the health lane NOW. The health lane pops
        before the victim's own bulk requeue, so the starving class
        claims the freed nodes instead of losing the race and watching
        the victim re-place onto them (preemption ping-pong)."""
        if self._escalate_fn is None:
            return
        try:
            tree = self._quota_tree()
            if tree is None:
                return
            cause = Cause(reason="preemption-complete",
                          origin=f"class/{fcls}")
            for other in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
                if get_nested(other, "status", "phase") == PHASE_PLACED:
                    continue
                if tree.class_of(other) != fcls:
                    continue
                self._escalate_fn(
                    Request(name=name_of(other),
                            namespace=namespace_of(other) or "default"),
                    cause=cause)
        except Exception:
            # admission is best-effort: a nudge must never fail the
            # victim's own status transition
            log.debug("starvation nudge for class %s failed", fcls,
                      exc_info=True)

    def _admission_pass(self, tree: QuotaTree, engine) -> None:
        """The starvation watchdog, run once per gang pass under the
        bind lock: advance every leaf's deficit clock, export the
        admission gauges, escalate a starving class's queued requests
        onto the health lane, and reclaim its min-guarantee through
        budget-bounded elastic preemption of over-share classes."""
        from .slices import migration_of

        now = self.now()
        if now == self._admission_last_pass:
            # gang passes at the same instant (a drained batch under a
            # virtual clock) would re-derive identical decisions —
            # observe/escalate/preempt are all keyed on `now`
            return
        self._admission_last_pass = now
        usage: dict = {}
        queued: dict = {}
        queued_keys: dict = {}
        queued_sizes: dict = {}
        pending_reclaim: dict = {}
        placed: list = []
        for other in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
            okey = f"{namespace_of(other) or 'default'}/{name_of(other)}"
            cls = tree.class_of(other)
            if get_nested(other, "status", "phase") == PHASE_PLACED:
                chips = int(get_nested(other, "status", "chips",
                                       default=0) or 0)
                usage[cls] = usage.get(cls, 0) + chips
                mig = migration_of(other)
                if mig.get("intent") == INTENT_MIGRATE \
                        and mig.get("preemptedFor") \
                        and mig.get("phase") in (MIG_MIGRATING,
                                                 MIG_CHECKPOINTED):
                    # in-flight reclaim: counts toward the starving
                    # class so back-to-back passes never double-preempt
                    fcls = str(mig.get("preemptedFor"))
                    pending_reclaim[fcls] = (
                        pending_reclaim.get(fcls, 0) + chips)
                else:
                    placed.append((okey, other, cls, chips))
            else:
                ospec = SliceRequestSpec.from_obj(other)
                size = int(ospec.chips_needed() or 0)
                queued[cls] = queued.get(cls, 0) + size
                queued_keys.setdefault(cls, []).append(okey)
                queued_sizes.setdefault(cls, []).append(size)
        deficits = self._admission.observe(tree, usage, queued, now)
        capacity = sum(b["free"] + b["placed"]
                       for b in engine.chip_totals().values())
        demand = {n: usage.get(n, 0) + queued.get(n, 0)
                  for n in tree.leaf_names()}
        shares = tree.shares(int(capacity), demand)
        for name in tree.leaf_names():
            qc = tree.get(name)
            lbl = {"class": name}
            OPERATOR_METRICS.admission_starvation_seconds.labels(
                **lbl).set(deficits.get(name, 0.0))
            OPERATOR_METRICS.admission_share.labels(
                **lbl).set(shares.get(name, 0))
            OPERATOR_METRICS.preemption_budget_remaining.labels(
                **lbl).set(self._admission.remaining(qc, now))
        for name in sorted(deficits):
            # a running deficit clock (anchored this pass or earlier)
            # marks the class starving — rescue starts immediately, not
            # one pass late when elapsed seconds turn nonzero
            if name not in self._admission.deficit_since:
                continue
            qc = tree.get(name)
            # escalate BEFORE the bound: the whole point is to rescue
            # the class while the deficit clock still has runway
            if self._escalate_fn is not None:
                cause = Cause(reason="admission-starvation",
                              origin=f"class/{name}")
                for okey in sorted(queued_keys.get(name, [])):
                    ns, _, nm = okey.partition("/")
                    self._escalate_fn(Request(name=nm, namespace=ns),
                                      cause=cause)
            use = usage.get(name, 0)
            floor = min(qc.min_chips, use + queued.get(name, 0))
            needed = floor - use - pending_reclaim.get(name, 0)
            if needed > 0:
                self._preempt_budgeted(name, needed, tree, shares,
                                       usage, placed, now,
                                       targets=queued_sizes.get(name))

    def _preempt_budgeted(self, for_cls: str, needed: int,
                          tree: QuotaTree, shares: dict, usage: dict,
                          placed: list, now: float,
                          targets: Optional[list] = None) -> int:
        """Post MIGRATE intents (stamped ``preemptedFor``) at Placed
        requests of other classes until ``needed`` chips are in flight
        back to the starving class. Victims sitting over their fair
        share drain first; under-share victims are still eligible (a
        fragmented fleet can leave every class under its nominal share
        while a min-guarantee goes unmet — the min outranks the soft
        share), but no drain ever pushes a victim class below its OWN
        min-guarantee floor. Every victim costs its class one
        preemption-budget token — an exhausted window stops the drain
        cold — and every victim rides the full checkpoint->rebind
        handshake. Returns chips reclaimed (in flight)."""
        from .slices import migration_of, post_intent

        cands = []
        for okey, other, vcls, chips in placed:
            if vcls == for_cls or chips <= 0:
                continue
            if tree.get(vcls).preempt_tokens <= 0:
                continue  # preemption-exempt class
            if annotations_of(other).get(L.SLICE_ELASTIC) == "false":
                continue  # cannot checkpoint: never hard-kill for quota
            if migration_of(other).get("phase") in (MIG_MIGRATING,
                                                    MIG_CHECKPOINTED):
                continue  # already mid-handshake
            over = usage.get(vcls, 0) - shares.get(vcls, 0)
            prio = int(SliceRequestSpec.from_obj(other).priority or 0)
            cands.append((-over, prio, okey, other, vcls, chips))
        cands.sort(key=lambda v: (v[0], v[1], v[2]))
        # shape-matched drain: serve the starving class's queued slice
        # sizes smallest-first, each by ONE victim at least that large.
        # Chip-count greed is shape-blind — two 4-chip fragments freed
        # on different pools can never host an 8-chip slice, so blind
        # accumulation churns victims (and burns tokens) for nothing.
        goals = sorted(t for t in (targets or []) if t > 0) or [needed]
        reclaimed = 0
        drained: dict = {}
        used = set()
        for goal in goals:
            if reclaimed >= needed:
                break
            for i, (_over, _prio, okey, other, vcls, chips) in \
                    enumerate(cands):
                if i in used or chips < goal:
                    continue
                vqc = tree.get(vcls)
                vfloor = min(vqc.min_chips, usage.get(vcls, 0))
                if (usage.get(vcls, 0) - drained.get(vcls, 0) - chips
                        < vfloor):
                    continue  # would push the victim below ITS floor
                if not self._admission.take_token(vqc, now):
                    continue  # window budget exhausted for this class
                vcr = thaw_obj(other)
                post_intent(self.client, vcr, other, INTENT_MIGRATE,
                            now + self.resize_timeout, now,
                            extra={"preemptedFor": for_cls})
                used.add(i)
                drained[vcls] = drained.get(vcls, 0) + chips
                reclaimed += chips
                if TIMELINE.enabled:
                    TIMELINE.record("SliceRequest", okey,
                                    "preempt-intent",
                                    {"controller": self.name,
                                     "for": for_cls})
                log.info("posted preempt intent at %s (class %s) for "
                         "starving class %s", okey, vcls, for_cls)
                break
        return reclaimed

    def _maybe_resize(self, cr: dict, live: dict, spec: SliceRequestSpec,
                      key: str) -> Optional[Result]:
        """Shrink/grow handshake for a sound Placed binding whose spec
        size diverged from the bound size. One attempt per spec
        generation: a timed-out resize parks as Aborted until the spec
        changes again, so a non-elastic workload quiesces instead of
        re-posting intents forever."""
        from .slices import (
            abort_migration,
            handoff_eligible,
            migration_of,
            plan_handoff,
            post_intent,
            rebind_request,
            reshard_request,
        )

        bound_chips = get_nested(cr, "status", "chips", default=None)
        if bound_chips is None:
            # binding predates elastic slices: adopt its current size
            set_nested(cr, spec.chips_needed(), "status", "chips")
            update_status_with_retry(self.client, cr, live=live)
            return None
        need = spec.chips_needed()
        mig = migration_of(cr)
        phase = mig.get("phase", "")
        gen = int(get_nested(cr, "metadata", "generation",
                             default=0) or 0)
        resizing = (mig.get("intent") in (INTENT_SHRINK, INTENT_GROW)
                    and phase in (MIG_MIGRATING, MIG_CHECKPOINTED))
        if need == int(bound_chips):
            if resizing:
                # spec reverted mid-handshake: retire the attempt
                abort_migration(self.client, cr, live,
                                "superseded: spec reverted to bound size",
                                outcome="aborted",
                                extra={"forGeneration": gen})
            return None
        if phase == MIG_ABORTED and int(
                mig.get("forGeneration", -1) or -1) == gen:
            return None  # this generation already had its attempt
        if resizing:
            if phase == MIG_CHECKPOINTED:
                # acked: move the binding; its own nodes may be reused
                # (a shrink usually lands inside the old window). When
                # the winner stays in the same NVLink domain AND the ack
                # published a compatible shard layout, drive the direct
                # shard handoff — only shards changing owner travel;
                # any mismatch rides the full-checkpoint path
                nodes = [n for n in self.client.list("v1", "Node")]
                ranked = rank_candidates(spec, FleetState(nodes),
                                         reclaim=key)
                if ranked:
                    # prefer a same-domain window when one ranks at all:
                    # the exact-fit scorer routinely out-ranks the job's
                    # own pool, but for a resize the shards that DON'T
                    # move dominate the score margin
                    cand = next((x for x in ranked
                                 if handoff_eligible(cr, x)), ranked[0])
                    plan = plan_handoff(cr, cand)
                    if plan is not None:
                        reshard_request(self.client, cr, live, spec,
                                        cand, self.now(), plan)
                    else:
                        rebind_request(self.client, cr, live, spec,
                                       cand, self.now(),
                                       outcome="resized")
                    return Result()
            if self.now() > float(mig.get("deadline") or 0):
                abort_migration(self.client, cr, live,
                                "resize deadline exceeded; binding kept",
                                outcome="timeout",
                                extra={"forGeneration": gen})
                return Result()
            return Result(requeue_after=REQUEUE_RESIZE_S)
        if annotations_of(cr).get(L.SLICE_ELASTIC) == "false":
            abort_migration(self.client, cr, live,
                            "workload is not elastic; binding kept",
                            outcome="aborted",
                            extra={"forGeneration": gen})
            return None
        intent = INTENT_SHRINK if need < int(bound_chips) else INTENT_GROW
        post_intent(self.client, cr, live, intent,
                    self.now() + self.resize_timeout, self.now(),
                    extra={"forGeneration": gen})
        return Result(requeue_after=REQUEUE_RESIZE_S)

    def _binding_broken(self, cr: dict, spec: SliceRequestSpec,
                        key: str) -> Optional[str]:
        """None when the Placed binding is sound, else the drain reason.
        NotReady is tolerated — only existence, lease, pool identity and
        a telemetry condemnation break a binding. The condemnation is
        the hysteresis scorer's published verdict (sustained FAIL
        digests) — a flapping card never raises it, so flaps never
        evict."""
        bound = list(get_nested(cr, "status", "nodes", default=[]) or [])
        if not bound:
            return "placed with no nodes recorded"
        for node_name in sorted(bound):
            node = self.client.get_or_none("v1", "Node", node_name)
            if node is None:
                return f"node {node_name} removed"
            lease = annotations_of(node).get(L.PLACED_BY)
            if lease != key:
                return (f"lease on node {node_name} "
                        f"{'lost' if not lease else 'taken by ' + lease}")
            if spec.accelerator and labels_of(node).get(
                    L.GPU_PRODUCT) != spec.accelerator:
                return (f"node {node_name} no longer matches accelerator "
                        f"pin {spec.accelerator!r}")
            if not _node_telemetry_ok(node):
                return f"node {node_name} condemned by telemetry"
        return None

    def _release_leases(self, key: str, engine=None) -> int:
        if isinstance(engine, FleetIndex):
            # the index's owner ledger covers every annotated node
            # (including ineligible ones), so this is O(owned), not a
            # fleet scan
            names = engine.owned_nodes(key)
            for n in names:
                self.client.patch(
                    "v1", "Node", n,
                    {"metadata": {"annotations": {L.PLACED_BY: None}}})
            engine.release(owner=key)
            return len(names)
        released = 0
        for node in self.client.list("v1", "Node"):
            if annotations_of(node).get(L.PLACED_BY) == key:
                self.client.patch(
                    "v1", "Node", name_of(node),
                    {"metadata": {"annotations": {L.PLACED_BY: None}}})
                released += 1
        if engine is not None:
            engine.release(owner=key)
        return released

    def _preempt(self, spec: SliceRequestSpec, key: str, engine) -> bool:
        """Drain lower-priority Placed requests, lowest first, until the
        request fits. Returns True when at least one victim was drained.
        Feasibility is probed on a cloned trial board; actual drains are
        folded back into the pass's shared snapshot."""
        my_prio = int(spec.priority or 0)
        victims = []
        for other in self.client.list(V1ALPHA1, KIND_SLICE_REQUEST):
            okey = f"{namespace_of(other) or 'default'}/{name_of(other)}"
            if okey == key:
                continue
            if get_nested(other, "status", "phase") != PHASE_PLACED:
                continue
            ospec = SliceRequestSpec.from_obj(other)
            if int(ospec.priority or 0) < my_prio:
                victims.append((int(ospec.priority or 0), okey, other))
        victims.sort(key=lambda v: (v[0], v[1]))
        if not victims:
            return False
        # feasibility gate: would the request fit even with EVERY victim
        # drained? A request that can never fit (too big for any NVLink
        # domain) must not thrash the fleet evicting workloads it cannot
        # use — without this the infeasible request re-preempts the whole
        # lower-priority tier on every requeue, forever. The trial board
        # shares the pass snapshot's structure instead of relisting.
        trial = engine.snapshot_state() if isinstance(engine, FleetIndex) \
            else engine.clone()
        for _, okey, _ in victims:
            trial.release(owner=okey)
        if not rank_candidates(spec, trial, reclaim=key):
            return False
        drained = 0
        for _, okey, other in victims:
            ocr = thaw_obj(other)
            self._release_leases(okey, engine=engine)
            set_nested(ocr, PHASE_PENDING, "status", "phase")
            set_nested(ocr, [], "status", "nodes")
            set_nested(ocr, int(get_nested(ocr, "status", "evictions",
                                           default=0) or 0) + 1,
                       "status", "evictions")
            set_nested(ocr, f"preempted by {key} (priority {my_prio})",
                       "status", "lastEvictionReason")
            update_status_with_retry(self.client, ocr, live=other)
            OPERATOR_METRICS.placement_decisions.labels(
                outcome="evicted").inc()
            drained += 1
            if self._best_for(spec, key, engine) is not None:
                break
        return drained > 0

    def _export_gauges(self, nodes: Optional[list],
                       fleet=None) -> None:
        if fleet is None:
            if nodes is None:
                nodes = self.client.list("v1", "Node")
            fleet = FleetState(nodes)
        for gen, bucket in sorted(fleet.chip_totals().items()):
            for state in ("free", "placed"):
                OPERATOR_METRICS.fleet_chips.labels(
                    accelerator=gen, state=state).set(bucket[state])

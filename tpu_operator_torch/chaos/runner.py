"""Named chaos scenarios against the mock cluster.

The port's copy of ``tpu_operator/chaos/runner.py``: the same 18
scenarios, steps, budgets and verdict. The GPU facts the reference
states as TPU ones each sit in one module-level constant, so a parity
test can map them as it maps ``build_cluster``: the node a NODE_ADD
joins (:data:`NODE_ADD_LABELS`, :data:`NODE_ADD_ALLOCATABLE`, the port
mix's 4-card single host where the reference adds a ``tpu-v5p-slice``
``2x2x1`` host), the resource CHIP_LOSS zeroes (``nvidia.com/gpu``),
the spec field TRIGGER_ROLLOUT edits (``driver.installDir``), the
driver pods ``_fleet_rolled`` selects (:data:`DRIVER_COMPONENT`),
:data:`NAMESPACE` and :data:`POLICY`. A fleet node is a GPU node
(``labels.is_gpu_node``). ``_chaos_globals`` puts back what it found in
the process-wide ``TRACER`` and ``TIMELINE`` (their buffers, clocks and
flags) and the DAG gate, where the reference only restores their
clocks and flags: a run inside a live operator process leaves that
process's flight recorder as it was.

The runner is deliberately single-threaded: the production Manager's
worker threads would make fault-consumption order depend on the
scheduler, and a chaos verdict that can't be reproduced from (scenario,
seed) is a bug report nobody can act on. :class:`_SyncController`
re-uses the real ``setup_controller`` wiring — watches, predicates,
mappers — so the event plumbing under test is the production code, only
the thread is gone. Time is a :class:`~.faults.VirtualClock`: requeue
delays, FSM deadlines and injected latency all advance it, never the
wall clock, so a 100-node scenario runs in seconds and two runs with the
same seed emit byte-identical JSON.

Each step: apply the step's faults (apiserver faults arm the
ChaosClient; object faults mutate the world through the unwrapped fake),
drain both controllers, tick the fake kubelet, drain again, advance the
clock, then let the invariant checker observe. After the plan runs out,
the cluster must converge to all-Ready within the soak budget —
"eventual convergence once faults stop" is itself an invariant.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import asdict
from typing import Callable, Dict, List, Optional

from ..api import labels as L
from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1, new_cluster_policy
from ..api.slicerequest import (
    KIND_SLICE_REQUEST,
    MIG_TERMINAL,
    PHASE_PLACED,
    PHASE_UNSCHEDULABLE,
    V1ALPHA1,
    SliceRequestSpec,
    new_slice_request,
)
from ..benchmarks.controlplane import build_cluster
from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
from ..controllers.placement_controller import PlacementReconciler
from ..controllers.telemetry_controller import TelemetryReconciler
from ..metrics.fleet import FleetTelemetry
from ..controllers.upgrade_controller import (
    STATE_DONE,
    UpgradeReconciler,
    desired_revision,
)
from ..runtime import (
    LANE_BULK,
    LANE_HEALTH,
    LANES,
    CachedClient,
    FakeClient,
    Request,
)
from ..runtime.client import (
    ApiError,
    ConflictError,
    ListOptions,
    NotFoundError,
)
from ..runtime.fake import simulate_kubelet
from ..runtime.manager import any_event, enqueue_object, shard_of
from ..runtime.timeline import TIMELINE
from ..runtime.tracing import TRACER
from ..runtime.workqueue import MAX_CAUSES, Cause
from ..runtime.objects import (
    annotations_of,
    get_nested,
    labels_of,
    name_of,
    namespace_of,
    set_nested,
    thaw_obj,
)
from ..workloads.elastic import ElasticWorkload
from ..runtime import snapshot as snapshot_mod
from .faults import (
    ANNOTATION_CLEAR,
    API_CONFLICT,
    API_LATENCY,
    API_THROTTLE,
    API_UNAVAILABLE,
    BROWNOUT_END,
    BROWNOUT_START,
    CHIP_LOSS,
    CHIP_RESTORE,
    DIGEST_DEGRADE,
    DIGEST_HEAL,
    DIGEST_SEED,
    MUTATE_POLICY,
    NODE_ADD,
    NODE_FLAP,
    NODE_HEAL,
    NODE_REMOVE,
    OPERAND_DRIFT,
    OPERATOR_CRASH,
    POD_CRASH,
    RESHARD_CRASH,
    SHARD_KILL,
    SLICE_REQUEST,
    SLICE_RESIZE,
    TRIGGER_ROLLOUT,
    WATCH_DROP,
    WORKLOAD_CRASH,
    ChaosClient,
    Fault,
    FaultPlan,
    VirtualClock,
)
from .invariants import (
    InvariantChecker,
    canonical_settled_state,
    settled_state_digest,
)

# federation scenarios run N cells under the global router; they have
# their own runner (chaos/federation.py) — run_scenario dispatches there
FEDERATION_SCENARIOS = ("cell-partition", "stale-digest",
                        "split-brain-router")

SCENARIOS = ("conflict-storm", "watch-flap", "node-churn",
             "upgrade-under-fire", "chip-loss", "operand-drift",
             "dag-race", "placement-contention", "placement-storm",
             "slice-migrate", "shard-failover", "operator-crash",
             "apiserver-brownout", "chip-degrade", "saturation-storm"
             ) + FEDERATION_SCENARIOS

# scenarios that run the placement controller (they create SliceRequests)
PLACEMENT_SCENARIOS = ("placement-contention", "placement-storm",
                       "slice-migrate", "operator-crash", "chip-degrade",
                       "saturation-storm")
# scenarios whose elastic requests get workload shims (the training
# jobs' half of the slice-intent protocol)
SHIM_SCENARIOS = ("slice-migrate", "operator-crash", "chip-degrade",
                  "saturation-storm")
# scenarios that crash the operator AND must reach the byte-identical
# canonical settled state as a never-crashed run of the same seed
RESTART_COHERENT_SCENARIOS = ("operator-crash", "saturation-storm")

# virtual deadlines for the slice-migrate scenario, sized in runner steps
# (STEP_DT each): long enough for the elastic handshake (~3 passes),
# short enough that a rigid request demonstrably times out into the
# hard-drain degradation inside the soak budget
MIGRATION_TIMEOUT_S = 60.0
RESIZE_TIMEOUT_VIRTUAL_S = 60.0

NAMESPACE = "gpu-operator"
POLICY = "gpu-cluster-policy"
# the node a NODE_ADD joins: the port mix's 4-card single host
# (benchmarks/controlplane.py POOL_MIX), where the reference adds a
# ``tpu-v5p-slice`` ``2x2x1`` host of 4 chips
NODE_ADD_LABELS = {
    L.GKE_ACCELERATOR: "nvidia-h100-80gb",
    L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
    L.GPU_TOPOLOGY: "nvswitch-4",
    L.GKE_ACCELERATOR_COUNT: "4"}
NODE_ADD_ALLOCATABLE = {L.GPU_RESOURCE: "4"}
# the driver DaemonSets' component label value (state-gpu-driver)
DRIVER_COMPONENT = "gpu-driver"
# the order operand DaemonSets and pods are picked or deleted in
# (OPERAND_DRIFT, ANNOTATION_CLEAR, POD_CRASH, NODE_REMOVE): by name, as
# the reference's; its renamed operands sort differently (ROADMAP §C),
# so a parity test maps this to the reference's order
OPERAND_ORDER = name_of
STEP_DT = 20.0           # virtual seconds per runner step
DEFAULT_STEPS = 12
SETUP_PASS_BUDGET = 30   # fault-free passes to reach the baseline Ready
SOAK_PASS_BUDGET = 150   # post-fault passes before convergence fails
DRAIN_BUDGET = 500       # reconciles per drain — a backstop, not a knob
# reconciles each controller gets before an OPERATOR_CRASH fires: the
# process dies mid-pass with queues half-drained, not at a tick boundary
CRASH_PARTIAL_DRAIN = 6
RETRY_DELAY_S = 1.0      # virtual requeue delay after an injected failure
MAX_PARALLEL_UPGRADES = 8
FAILOVER_SHARDS = 4      # shard count for the shard-failover scenario
# the lane-priority invariant: no health-lane item may be dequeued having
# waited behind more than this many bulk reconciles
LANE_PRIORITY_BUDGET = 8


def _saturation_quota(n_nodes: int) -> dict:
    """The saturation-storm scenario's quota config, scaled to fleet
    size. ``prod`` carries the min-guarantee (the floor self-caps at
    live demand, so a generous value just means "rescue all of prod")
    and zero preempt tokens — the guaranteed class is itself
    preemption-exempt. The opportunists carry token budgets sized so
    the whole rescue fits without exhausting a window: budget
    EXHAUSTION mid-rescue would make the crashed run's outcome hinge
    on one lost tick of token accounting, and the restart-coherent
    check demands tick-for-tick-identical settled state."""
    return {"classes": [
        {"name": "prod", "weight": 6.0, "minChips": 2 * n_nodes,
         "starvationBoundSeconds": 240},
        {"name": "batch", "weight": 3.0, "preemptTokens": 16,
         "preemptWindowSeconds": 600},
        {"name": "research", "weight": 1.0,
         "maxChips": max(32, 2 * n_nodes), "preemptTokens": 16,
         "preemptWindowSeconds": 600},
    ]}


class _SyncController:
    """Single-threaded Controller stand-in: same watch/predicate/mapper
    registration surface, but reconciles run inline from :meth:`drain`
    and delayed requeues key off the virtual clock.

    Models the production Controller's fleet-scale queueing exactly:
    requests route to ``shards`` rendezvous-hashed queues (the same
    ``shard_of`` the Manager uses, so a kill moves only the dead shard's
    keys) and each shard holds per-lane FIFOs popped health > placement >
    bulk. ``shards=1`` is the default — scenarios that predate sharding
    keep one queue. The lane journal (``max_health_behind_bulk``) feeds
    the lane-priority invariant: how many bulk reconciles ran while the
    worst-served health item waited."""

    def __init__(self, reconciler, client, clock: VirtualClock,
                 shards: int = 1, name: str = ""):
        self.reconciler = reconciler
        self.client = client
        self.clock = clock
        self.name = name
        self.timeline_kind = getattr(reconciler, "primary_kind", None)
        self.shards = max(1, shards)
        self._live: List[int] = list(range(self.shards))
        self._queues: List[Dict[str, List[Request]]] = [
            {lane: [] for lane in LANES} for _ in range(self.shards)]
        self._lane_of: Dict[Request, str] = {}
        # cause provenance per queued key, same bounded-merge discipline
        # as the production WorkQueue — popped with the key at drain
        self._causes: Dict[Request, tuple] = {}
        self._delayed: Dict[Request, float] = {}
        self._last_seen: Dict[tuple, dict] = {}
        self.reconcile_errors = 0
        # lane-priority accounting: bulk reconciles completed while each
        # queued health item waited, and the worst case seen
        self._bulk_pops = 0
        self._health_marks: Dict[Request, int] = {}
        self.max_health_behind_bulk = 0
        self.keys_moved_on_failover = 0
        self._cancels: List[Callable] = []

    def watch(self, api_version: str, kind: str,
              predicate: Callable = any_event,
              mapper: Callable = enqueue_object,
              lane: Optional[str] = None) -> None:
        def handler(event):
            key = (api_version, kind, namespace_of(event.obj),
                   name_of(event.obj))
            old = self._last_seen.get(key)
            if event.type == "DELETED":
                self._last_seen.pop(key, None)
            else:
                self._last_seen[key] = event.obj
            try:
                if not predicate(event, old):
                    return
                cause = None
                if TRACER.enabled:
                    # watch delivery is synchronous from the writer, so
                    # the trace open on this thread IS the reconcile
                    # whose write fired the event — the causal link
                    tr = TRACER.current_trace()
                    cause = Cause(
                        reason=f"watch:{event.type}",
                        origin=f"{kind}/{name_of(event.obj)}",
                        trace_id=tr.seq if tr is not None else -1)
                for req in mapper(event):
                    self.add(req, lane=lane, cause=cause)
            except ApiError:
                # the mapper's LIST ate an armed fault; the per-tick
                # resync (and any relist) re-enqueues what this loses
                pass

        self._cancels.append(self.client.watch(api_version, kind, handler))

    def stop(self) -> None:
        """The process dies: watch subscriptions are torn down (the
        OPERATOR_CRASH teardown — queued keys, delayed requeues and lane
        state simply stop existing with this object)."""
        for cancel in self._cancels:
            cancel()
        self._cancels.clear()

    def _shard_for(self, request: Request) -> int:
        return shard_of(str(request), self._live)

    def _stamp_cause(self, request: Request, cause) -> None:
        if cause is None:
            return
        causes = (cause,) if isinstance(cause, Cause) else tuple(cause)
        cur = self._causes.get(request, ())
        for c in causes:
            if len(cur) >= MAX_CAUSES:
                break
            if c not in cur:
                cur = cur + (c,)
        if cur:
            self._causes[request] = cur

    def add(self, request: Request, lane: Optional[str] = None,
            cause=None) -> None:
        lane = lane if lane in LANES else LANE_BULK
        self._stamp_cause(request, cause)
        if (cause is not None and self.timeline_kind is not None
                and TIMELINE.enabled
                and self._lane_of.get(request) is None):
            # same per-object enqueue attribution the production
            # Controller.enqueue records: caused FRESH adds only — the
            # per-tick resync and coalesced duplicates would be noise
            TIMELINE.record(self.timeline_kind, str(request), "enqueue",
                            {"controller": self.name, "lane": lane},
                            causes=(cause,) if isinstance(cause, Cause)
                            else tuple(cause))
        cur = self._lane_of.get(request)
        if cur is not None:
            # already queued: promote to the higher-priority lane only
            if LANES.index(lane) < LANES.index(cur):
                shard = self._shard_for(request)
                self._queues[shard][cur].remove(request)
                self._queues[shard][lane].append(request)
                self._lane_of[request] = lane
                if lane == LANE_HEALTH:
                    self._health_marks.setdefault(request, self._bulk_pops)
            return
        self._queues[self._shard_for(request)][lane].append(request)
        self._lane_of[request] = lane
        if lane == LANE_HEALTH:
            self._health_marks.setdefault(request, self._bulk_pops)

    def kill_busiest(self, preferred: int) -> Optional[tuple]:
        """Kill the killable shard currently holding the most queued
        keys (ties: ``preferred`` if killable, else lowest id) — the
        adversary aims where it hurts. Deterministic given the queue
        state. Returns ``(shard, keys_moved)`` or None when no shard can
        die (single-shard controller)."""
        killable = self._live[1:]  # the first live shard always survives
        if not killable:
            return None
        depth = {s: sum(len(self._queues[s][lane]) for lane in LANES)
                 for s in killable}
        top = max(depth.values())
        candidates = sorted(s for s, d in depth.items() if d == top)
        victim = (preferred if preferred in candidates and top == 0
                  else candidates[0])
        return victim, self.kill_shard(victim) or 0

    def kill_shard(self, shard: int) -> Optional[int]:
        """Kill one shard's (virtual) worker group: remove it from the
        live set and rehash its queued keys onto the survivors, lanes
        preserved. Returns keys moved, or None when the kill is a no-op
        (unknown/dead shard, or it would take the last shard down)."""
        if shard not in self._live or len(self._live) == 1:
            return None
        self._live.remove(shard)
        dead = self._queues[shard]
        self._queues[shard] = {lane: [] for lane in LANES}
        moved = 0
        for lane in LANES:
            for req in dead[lane]:
                del self._lane_of[req]
                self.add(req, lane=lane,
                         cause=Cause(reason="failover-transfer",
                                     origin=f"{self.name}:shard{shard}"))
                moved += 1
        self.keys_moved_on_failover += moved
        return moved

    def _pop(self) -> Optional[Request]:
        # strict lane priority, shards visited in live order within a
        # lane — deterministic, and with shards=1 exactly the old FIFO
        # per lane
        for lane in LANES:
            for shard in self._live:
                queue = self._queues[shard][lane]
                if queue:
                    req = queue.pop(0)
                    del self._lane_of[req]
                    if lane == LANE_BULK:
                        self._bulk_pops += 1
                    elif lane == LANE_HEALTH:
                        behind = self._bulk_pops - self._health_marks.pop(
                            req, self._bulk_pops)
                        if behind > self.max_health_behind_bulk:
                            self.max_health_behind_bulk = behind
                    return req
        return None

    def _schedule(self, request: Request, due: float, cause=None) -> None:
        self._stamp_cause(request, cause)
        prev = self._delayed.get(request)
        self._delayed[request] = due if prev is None else min(prev, due)

    def _promote(self) -> None:
        for req in [r for r, t in self._delayed.items()
                    if t <= self.clock()]:
            del self._delayed[req]
            self.add(req)

    def drain(self, budget: int = DRAIN_BUDGET) -> int:
        done = 0
        self._promote()
        while done < budget:
            req = self._pop()
            if req is None:
                break
            done += 1
            causes = self._causes.pop(req, ())
            tr = None
            try:
                # open the root here (the reconciler's own wrapper nests
                # as a passthrough) so the popped causes ride the trace —
                # same dual-path treatment the production _worker gives
                with TRACER.trace(self.reconciler.name, str(req),
                                  causes=causes) as t:
                    tr = t
                    result = self.reconciler.reconcile(req)
            except ApiError:
                # an injected 409/429/5xx escaped the reconcile: retry
                # with a (virtual) delay, like the workqueue rate limiter
                self.reconcile_errors += 1
                self._schedule(req, self.clock() + RETRY_DELAY_S,
                               cause=Cause(
                                   reason="retry-backoff", origin=self.name,
                                   trace_id=tr.seq if tr else -1))
                continue
            if result and result.requeue_after > 0:
                self._schedule(req, self.clock() + result.requeue_after,
                               cause=Cause(
                                   reason="requeue-after", origin=self.name,
                                   trace_id=tr.seq if tr else -1))
            elif result and result.requeue:
                self.add(req, cause=Cause(
                    reason="requeue", origin=self.name,
                    trace_id=tr.seq if tr else -1))
            self._promote()
        return done


# -- object-level faults (adversary moves through the unwrapped fake) -------


def _mutate_cr(fake: FakeClient, mutate: Callable[[dict], None]) -> None:
    for _ in range(10):
        cr = fake.get_or_none(V1, KIND_CLUSTER_POLICY, POLICY)
        if cr is None:
            return
        cr = thaw_obj(cr)  # reads are frozen store snapshots
        mutate(cr)
        try:
            fake.update(cr)
            return
        except ConflictError:
            continue


def _set_node_ready(fake: FakeClient, name: str, ready: bool) -> bool:
    node = fake.get_or_none("v1", "Node", name)
    if node is None:
        return False
    node = thaw_obj(node)
    set_nested(node, [{"type": "Ready",
                       "status": "True" if ready else "False"}],
               "status", "conditions")
    fake.update_status(node)
    return True


def _digest_target(arg: str, fake: FakeClient,
                   state: dict) -> Optional[str]:
    """Resolve a digest fault's target node. A literal node name passes
    through; the ``@placed:N`` sentinel resolves to the N-th (sorted)
    GPU node carrying a placement lease at FIRST resolution and is then
    pinned in ``state`` — the whole FAIL ramp stays aimed at one node
    even after the eviction it provokes moves the lease elsewhere.
    Distinct sentinels pin distinct nodes, so the flap target can never
    accidentally heal the ramp target's streak."""
    if not arg.startswith("@placed:"):
        return arg
    targets = state.setdefault("digest_targets", {})
    if arg in targets:
        return targets[arg]
    leased = sorted(
        name_of(n) for n in fake.list("v1", "Node")
        if L.is_gpu_node(n)
        and annotations_of(n).get(L.PLACED_BY))
    if not leased:
        # nothing bound (all requests unschedulable this seed): fall
        # back to any GPU node so the scorer is still exercised
        leased = sorted(
            name_of(n) for n in fake.list("v1", "Node")
            if L.is_gpu_node(n))
    pool = [n for n in leased if n not in set(targets.values())] or leased
    if not pool:
        return None
    name = pool[int(arg.split(":", 1)[1]) % len(pool)]
    targets[arg] = name
    return name


def _publish_digest(fake: FakeClient, node_name: str, state: dict,
                    status: str, temp_c: float) -> bool:
    """One digest publish onto a node's annotation — the chaos analog of
    the on-node engine's jittered publish loop. ``seq`` counts publishes
    per node, so the scorer's per-seq dedupe sees each write as exactly
    one new sample no matter how many watch echoes deliver it."""
    from ..metrics.fleet import node_generation
    from ..metrics.health_engine import (
        DIGEST_SCHEMA_VERSION,
        digest_annotation,
    )

    node = fake.get_or_none("v1", "Node", node_name)
    if node is None:
        return False
    seqs = state.setdefault("digest_seq", {})
    seqs[node_name] = seqs.get(node_name, 0) + 1
    nl = labels_of(node)
    gen = node_generation(node)
    try:
        chips = int(nl.get(L.GKE_ACCELERATOR_COUNT) or "4")
    except ValueError:
        chips = 4
    # a FAIL digest is one overheating chip, not a dead board — exactly
    # the single-chip degradation the hysteresis scorer arbitrates
    grades = {f"chip{i}": "ok" for i in range(chips)}
    if status == "fail" and grades:
        grades["chip0"] = "fail"
    digest = {"v": DIGEST_SCHEMA_VERSION, "status": status,
              "grades": grades,
              "duty_pct": 95.0 if status == "ok" else 35.0,
              "hbm_free_frac": 0.4 if status == "ok" else 0.05,
              "temp_max_c": float(temp_c), "gen": gen,
              "seq": seqs[node_name]}
    node = thaw_obj(node)
    node.setdefault("metadata", {}).setdefault("annotations", {})[
        L.HEALTH_DIGEST] = digest_annotation(digest)
    try:
        fake.update(node)
    except ConflictError:
        return False
    return True


def _apply_fault(fault: Fault, fake: FakeClient, chaos: ChaosClient,
                 state: dict) -> None:
    kind = fault.kind
    if kind in (API_CONFLICT, API_THROTTLE, API_UNAVAILABLE, API_LATENCY):
        chaos.arm(fault)
        return
    applied = False
    if kind in (NODE_FLAP, NODE_HEAL):
        applied = _set_node_ready(fake, fault.arg, ready=kind == NODE_HEAL)
    elif kind == NODE_ADD:
        fake.add_node(fault.arg, labels=dict(NODE_ADD_LABELS),
                      allocatable=dict(NODE_ADD_ALLOCATABLE))
        applied = True
    elif kind == NODE_REMOVE:
        if fake.get_or_none("v1", "Node", fault.arg) is not None:
            # the VM is gone: its pods go with it (no graceful drain)
            for pod in sorted(fake.list("v1", "Pod"), key=lambda p: (
                    namespace_of(p), OPERAND_ORDER(p))):
                if get_nested(pod, "spec", "nodeName") == fault.arg:
                    try:
                        fake.delete("v1", "Pod", name_of(pod),
                                    namespace_of(pod) or None)
                    except NotFoundError:
                        pass
            try:
                fake.delete("v1", "Node", fault.arg)
                applied = True
            except NotFoundError:
                pass
    elif kind == CHIP_LOSS:
        node = fake.get_or_none("v1", "Node", fault.arg)
        if node is not None:
            node = thaw_obj(node)
            alloc = get_nested(node, "status", "allocatable",
                               default={}) or {}
            state["chips"].setdefault(fault.arg,
                                      alloc.get(L.GPU_RESOURCE, "0"))
            for field in ("allocatable", "capacity"):
                cur = dict(get_nested(node, "status", field,
                                      default={}) or {})
                cur[L.GPU_RESOURCE] = "0"
                set_nested(node, cur, "status", field)
            fake.update_status(node)
            applied = True
    elif kind == CHIP_RESTORE:
        saved = state["chips"].pop(fault.arg, None)
        node = fake.get_or_none("v1", "Node", fault.arg)
        if saved is not None and node is not None:
            node = thaw_obj(node)
            for field in ("allocatable", "capacity"):
                cur = dict(get_nested(node, "status", field,
                                      default={}) or {})
                cur[L.GPU_RESOURCE] = saved
                set_nested(node, cur, "status", field)
            fake.update_status(node)
            applied = True
    elif kind == POD_CRASH:
        pods = sorted(
            (p for p in fake.list("v1", "Pod",
                                  ListOptions(namespace=NAMESPACE))
             if get_nested(p, "spec", "nodeName") == fault.arg
             and not get_nested(p, "metadata", "deletionTimestamp")),
            key=OPERAND_ORDER)
        if pods:  # deterministic victim: first by name
            victim = thaw_obj(pods[0])
            set_nested(victim, "Pending", "status", "phase")
            set_nested(victim, [{"type": "Ready", "status": "False"}],
                       "status", "conditions")
            fake.update_status(victim)
            applied = True
    elif kind == MUTATE_POLICY:
        def set_marker(cr: dict) -> None:
            cr.setdefault("spec", {}).setdefault("devicePlugin", {})[
                "env"] = [{"name": "CHAOS_MARKER", "value": fault.arg}]

        _mutate_cr(fake, set_marker)
        state["marker"] = fault.arg
        applied = True
    elif kind == TRIGGER_ROLLOUT:
        _mutate_cr(fake, lambda cr: cr.setdefault("spec", {}).__setitem__(
            "driver", {"installDir": fault.arg}))
        state["rollout"] = True
        applied = True
    elif kind == OPERAND_DRIFT:
        # out-of-band spec edit that leaves the spec-hash annotation
        # INTACT — the blind spot of an annotation-only skip. The image
        # is a field every desired container carries, so the operator's
        # live-vs-desired check must see the mismatch and rewrite.
        dss = sorted(fake.list("apps/v1", "DaemonSet",
                               ListOptions(namespace=NAMESPACE)),
                     key=OPERAND_ORDER)
        if dss:
            victim = thaw_obj(dss[fault.count % len(dss)])
            ctrs = get_nested(victim, "spec", "template", "spec",
                              "containers", default=[]) or []
            if ctrs:
                ctrs[0]["image"] = f"chaos-drift/{fault.arg}"
                try:
                    fake.update(victim)
                    state["drift"] = True
                    applied = True
                except ConflictError:
                    pass
    elif kind == SLICE_REQUEST:
        # demand arrives: a user submits a SliceRequest. Chip count rides
        # in ``count``, priority in ``seconds`` (the plan's only free
        # numeric slots), and an optional quota class suffixed onto the
        # name as ``name@class`` (the saturation scenario's classed
        # demand); the placement controller picks it up from the ADDED
        # watch event like any other client would.
        req_name, _, qclass = fault.arg.partition("@")
        if fake.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST, req_name,
                            NAMESPACE) is None:
            obj = new_slice_request(
                req_name,
                spec=SliceRequestSpec(chips=fault.count,
                                      priority=int(fault.seconds)).to_obj(),
                namespace=NAMESPACE)
            if qclass:
                obj.setdefault("metadata", {}).setdefault(
                    "annotations", {})[L.QUOTA_CLASS] = qclass
            fake.create(obj)
            if chaos.clock is not None:
                # birth time on the virtual clock: the denominator of
                # the verdict's deterministic per-slice goodput rate
                state.setdefault("req_created", {})[req_name] = \
                    chaos.clock.t
            applied = True
    elif kind == SLICE_RESIZE:
        # the user edits spec.chips on a live request (kubectl apply of a
        # bigger/smaller topology). The fake bumps metadata.generation on
        # the spec change, so the placement controller's watch fires and
        # the elastic shrink/grow handshake starts from the intent post.
        live = fake.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST, fault.arg,
                                NAMESPACE)
        if live is not None:
            victim = thaw_obj(live)
            if get_nested(victim, "spec", "chips") != fault.count:
                set_nested(victim, fault.count, "spec", "chips")
                try:
                    fake.update(victim)
                    applied = True
                except ConflictError:
                    pass
    elif kind == SHARD_KILL:
        # kill the busiest killable shard's worker group on every
        # controller: queued keys rehash onto the survivors (lanes
        # preserved); the no-op guard (never the last shard) mirrors
        # Controller.kill_shard
        kills = []
        for ctrl in state.get("ctrls") or []:
            out = ctrl.kill_busiest(fault.count)
            if out is not None:
                kills.append({"controller": ctrl.name, "shard": out[0],
                              "keys_moved": out[1]})
        if kills:
            state.setdefault("shard_kills", []).extend(kills)
            applied = True
    elif kind == WORKLOAD_CRASH:
        # the training job dies mid-step, leaving a torn (never-acked)
        # checkpoint behind — the restart must restore the newest durable
        # step, and the no-lost-work invariant holds it to the acked one
        wl = (state.get("shims") or {}).get(fault.arg)
        if wl is not None:
            wl.crash(partial=True)
            applied = True
    elif kind == RESHARD_CRASH:
        # arm a kill landing mid-shard-handoff: the shim's next direct
        # handoff writes a torn (unfinalized) re-shard manifest and
        # dies — restore must roll back to the finalized step. The
        # "@mismatch" mode instead bumps the shim's layout version so
        # its next resize is ineligible for the fast path and exercises
        # the full-checkpoint fallback arc
        name, _, mode = str(fault.arg or "").partition("@")
        wl = (state.get("shims") or {}).get(name)
        if wl is not None:
            if mode == "mismatch":
                wl.force_layout_mismatch()
            else:
                wl.arm_reshard_crash()
            applied = True
    elif kind == ANNOTATION_CLEAR:
        # strip the hash annotations entirely (a `kubectl annotate ...-`
        # adversary): the skip must fail closed and restore them
        dss = sorted(fake.list("apps/v1", "DaemonSet",
                               ListOptions(namespace=NAMESPACE)),
                     key=OPERAND_ORDER)
        if dss:
            victim = thaw_obj(dss[fault.count % len(dss)])
            anns = victim.setdefault("metadata", {}).get("annotations") or {}
            cleared = bool(anns.pop(L.SPEC_HASH, None)) \
                | bool(anns.pop(L.LAST_APPLIED_HASH, None))
            if cleared:
                try:
                    fake.update(victim)
                    state["drift"] = True
                    applied = True
                except ConflictError:
                    pass
    elif kind == DIGEST_SEED:
        # t=0 of the telemetry plane: every GPU node starts publishing
        # healthy digests, so silence is never mistaken for health
        for nm in sorted(
                name_of(n) for n in fake.list("v1", "Node")
                if L.is_gpu_node(n)):
            applied = _publish_digest(fake, nm, state, "ok", 55.0) \
                or applied
    elif kind in (DIGEST_DEGRADE, DIGEST_HEAL):
        target = _digest_target(fault.arg, fake, state)
        if target is not None:
            if kind == DIGEST_DEGRADE:
                # the plan rides the chip temperature in ``seconds``
                applied = _publish_digest(fake, target, state, "fail",
                                          fault.seconds or 90.0)
            else:
                applied = _publish_digest(fake, target, state, "ok", 55.0)
    if applied:
        chaos.record(kind)


# -- convergence ------------------------------------------------------------


def _marker_landed(fake: FakeClient, marker: str) -> bool:
    for ds in fake.list("apps/v1", "DaemonSet",
                        ListOptions(namespace=NAMESPACE)):
        for ctr in get_nested(ds, "spec", "template", "spec", "containers",
                              default=[]) or []:
            for var in ctr.get("env") or []:
                if var.get("name") == "CHAOS_MARKER" \
                        and var.get("value") == marker:
                    return True
    return False


def _fleet_rolled(fake: FakeClient) -> bool:
    """Every driver pod runs its DaemonSet's current template revision —
    the controller's own canonical definition (desired_revision), same as
    the rollout bench's fleet check."""
    sel = ListOptions(namespace=NAMESPACE,
                      label_selector={L.DOMAIN + "/component":
                                      DRIVER_COMPONENT})
    wants = {name_of(ds): desired_revision(fake, ds)
             for ds in fake.list("apps/v1", "DaemonSet", sel)}
    if not wants:
        return False
    pods = fake.list("v1", "Pod", sel)
    for pod in pods:
        ds_name = next(
            (o.get("name") for o in get_nested(
                pod, "metadata", "ownerReferences", default=[]) or []
             if o.get("kind") == "DaemonSet"), None)
        want = wants.get(ds_name)
        if want is not None and get_nested(
                pod, "metadata", "labels",
                "controller-revision-hash") != want:
            return False
    return bool(pods)


def _converged(fake: FakeClient, state: dict) -> bool:
    cr = fake.get_or_none(V1, KIND_CLUSTER_POLICY, POLICY)
    if cr is None or get_nested(cr, "status", "state") != "ready":
        return False
    for node in fake.list("v1", "Node"):
        if not L.is_gpu_node(node):
            continue
        if get_nested(node, "spec", "unschedulable", default=False):
            return False
        conds = get_nested(node, "status", "conditions", default=[]) or []
        if not any(c.get("type") == "Ready" and c.get("status") == "True"
                   for c in conds):
            return False
        if labels_of(node).get(L.UPGRADE_STATE) not in (None, STATE_DONE):
            return False
    if state["marker"] is not None \
            and not _marker_landed(fake, state["marker"]):
        return False
    if state["rollout"] and not _fleet_rolled(fake):
        return False
    if state.get("drift"):
        # drift must be healed: every operand carries the spec-hash
        # annotation again and no container still runs a drifted image
        for ds in fake.list("apps/v1", "DaemonSet",
                            ListOptions(namespace=NAMESPACE)):
            anns = get_nested(ds, "metadata", "annotations",
                              default={}) or {}
            if L.SPEC_HASH not in anns:
                return False
            for ctr in get_nested(ds, "spec", "template", "spec",
                                  "containers", default=[]) or []:
                if str(ctr.get("image", "")).startswith("chaos-drift/"):
                    return False
    # every SliceRequest must sit in a terminal phase with a consistent
    # lease trail — a request still Pending (or Placed onto a vanished or
    # re-leased node) means the placement loop hasn't finished healing
    for req in fake.list(V1ALPHA1, KIND_SLICE_REQUEST):
        phase = get_nested(req, "status", "phase")
        if phase not in (PHASE_PLACED, PHASE_UNSCHEDULABLE):
            return False
        # an elastic handshake still in flight (Migrating/Checkpointed/
        # Rebound) means a controller or workload still owes a move
        if (get_nested(req, "status", "migration", "phase") or "") \
                not in MIG_TERMINAL:
            return False
        if phase != PHASE_PLACED:
            continue
        key = f"{namespace_of(req) or 'default'}/{name_of(req)}"
        for node_name in get_nested(req, "status", "nodes",
                                    default=[]) or []:
            node = fake.get_or_none("v1", "Node", node_name)
            if node is None or annotations_of(node).get(L.PLACED_BY) != key:
                return False
    from ..controllers.slices import slice_status

    return all(r["validated"] for r in slice_status(fake, NAMESPACE))


def _placement_summary(fake: FakeClient) -> dict:
    """Deterministic placement outcome block for the verdict: phase
    counts, total evictions survived, and the chip inventory the gauges
    export — all read from the settled store, no clocks involved."""
    from ..topology.placement import FleetState

    reqs = fake.list(V1ALPHA1, KIND_SLICE_REQUEST)
    phases: Dict[str, int] = {}
    evictions = 0
    for req in reqs:
        phase = get_nested(req, "status", "phase") or "Pending"
        phases[phase] = phases.get(phase, 0) + 1
        evictions += int(get_nested(req, "status", "evictions",
                                    default=0) or 0)
    totals = FleetState(fake.list("v1", "Node")).chip_totals()
    free = sum(b["free"] for b in totals.values())
    placed = sum(b["placed"] for b in totals.values())
    return {
        "requests": len(reqs),
        "phases": {k: phases[k] for k in sorted(phases)},
        "evictions": evictions,
        "chips_placed": placed,
        "chips_free": free,
        "utilization": (round(placed / (placed + free), 4)
                        if placed + free else 0.0),
    }


def _migration_summary(fake: FakeClient) -> dict:
    """Deterministic elastic-protocol outcome block for the verdict: the
    settled migration phase per request, completed-move counts, and the
    acked/restored step pair the no-lost-work invariant audits — all read
    from the store, byte-identical per seed."""
    reqs = sorted(fake.list(V1ALPHA1, KIND_SLICE_REQUEST), key=name_of)
    phases: Dict[str, int] = {}
    completed = 0
    rows = []
    for req in reqs:
        mig = dict(get_nested(req, "status", "migration",
                              default={}) or {})
        phase = mig.get("phase") or "none"
        phases[phase] = phases.get(phase, 0) + 1
        moves = int(get_nested(req, "status", "migrations",
                               default=0) or 0)
        completed += moves
        rows.append({
            "name": name_of(req),
            "phase": phase,
            "migrations": moves,
            "ackedStep": mig.get("ackedStep"),
            "restoredStep": mig.get("restoredStep"),
            "reason": mig.get("reason"),
            "path": mig.get("path"),
            "bytesMoved": mig.get("bytesMoved"),
            "shardsMoved": mig.get("shardsMoved"),
        })
    return {
        "requests": len(reqs),
        "phases": {k: phases[k] for k in sorted(phases)},
        "completed_moves": completed,
        "resharded": sum(1 for r in rows
                         if r["path"] == "sharded-handoff"),
        "rows": rows,
    }


def _telemetry_summary(fake: FakeClient, telemetry, state: dict) -> dict:
    """Deterministic telemetry outcome block for the verdict: the fleet
    rollup over the settled store, the scorer's condemned set and
    streaks, the digest publish ledger, and every eviction the telemetry
    path caused — the evidence the no-flap-evict invariant audited."""
    from ..metrics.fleet import rollup_nodes

    tel_evictions = []
    for req in sorted(fake.list(V1ALPHA1, KIND_SLICE_REQUEST),
                      key=name_of):
        reason = get_nested(req, "status", "lastEvictionReason") or ""
        if "condemned by telemetry" in reason:
            tel_evictions.append({
                "request": name_of(req), "reason": reason,
                "evictions": int(get_nested(req, "status", "evictions",
                                            default=0) or 0)})
    return {
        "rollup": rollup_nodes(fake.list("v1", "Node")),
        "condemned": telemetry.condemned() if telemetry is not None else [],
        "targets": dict(sorted(
            (state.get("digest_targets") or {}).items())),
        "digest_publishes": dict(sorted(
            (state.get("digest_seq") or {}).items())),
        "telemetry_evictions": tel_evictions,
    }


def _goodput_summary(fake: FakeClient, now_s: float, state: dict) -> dict:
    """Deterministic slice-goodput block for the verdict: each request's
    durably-checkpointed steps rated against the generation-ideal rate
    over its own virtual lifetime — pure store + virtual-clock reads,
    byte-identical per seed. Feeds the ``slice-goodput`` SLO row: a
    slice that lost its node to a condemned chip spends virtual time
    evicted, and those slow steps burn the budget by design."""
    from ..metrics.fleet import GOODPUT_DEGRADED_RATIO, ideal_steps_per_s
    from ..topology.placement import pool_generation

    created = state.get("req_created") or {}
    rows = []
    good = bad = 0
    for req in sorted(fake.list(V1ALPHA1, KIND_SLICE_REQUEST),
                      key=name_of):
        nm = name_of(req)
        acked = get_nested(req, "status", "progress", "checkpointedStep",
                           default=None)
        if acked is None:
            acked = get_nested(req, "status", "migration", "ackedStep",
                               default=None)
        if acked is None:
            continue
        acked = int(acked)
        born = created.get(nm)
        elapsed = (now_s - born) if born is not None else 0.0
        pool = str(get_nested(req, "status", "pool", default="") or "")
        gen = pool_generation(pool) if pool else ""
        ratio = ((acked / elapsed) / ideal_steps_per_s(gen)) \
            if elapsed > 0 else 0.0
        quality = "good" if ratio >= GOODPUT_DEGRADED_RATIO \
            else "degraded"
        if quality == "good":
            good += acked
        else:
            bad += acked
        rows.append({"name": nm, "acked_steps": acked,
                     "virtual_s": round(elapsed, 1), "generation": gen,
                     "goodput_ratio": round(ratio, 4),
                     "quality": quality})
    return {"rows": rows, "steps_good": good, "steps_degraded": bad}


# the convergence SLO's virtual budget: converging inside this many
# virtual seconds past the last fault is "good". Generous next to the
# soak budget (150 passes * 20s) so only a genuinely struggling run
# burns it — convergence FAILURE already fails the verdict outright.
CONVERGENCE_SLO_VIRTUAL_S = 600.0
# single-window burn threshold for the chaos SLO block: the settled
# store is one window (there is no time series to diff), so the classic
# fast/slow pair collapses to one threshold
CHAOS_BURN_THRESHOLD = 2.0


def _slo_verdict(scenario: str, out: dict,
                 conv_s: Optional[float]) -> dict:
    """Deterministic SLO block for the verdict: settled-store event
    counts (never wall-clock histograms) fed through the same
    :func:`~tpu_operator_torch.metrics.slo.burn_verdict` math the production
    SLOEngine runs, so the verdicts are byte-identical per seed yet
    exercise the identical formula. Scenarios engineered to violate an
    objective (slice-migrate's rigid requests, the contention storm's
    preemptions) must show up in ``breached`` — a chaos invariant."""
    from ..api.slicerequest import MIG_ABORTED, MIG_RESUMED
    from ..metrics.slo import burn_verdict

    conv_ok = (out["converged"] and conv_s is not None
               and conv_s <= CONVERGENCE_SLO_VIRTUAL_S)
    slos = {
        # 0/1 SLI: the run either converged inside the virtual budget or
        # it torched the whole error budget
        "convergence-latency": burn_verdict(
            good=1 if conv_ok else 0, bad=0 if conv_ok else 1,
            objective=0.99, threshold=CHAOS_BURN_THRESHOLD),
    }
    pl = out.get("placement")
    if pl is not None:
        slos["placement-stability"] = burn_verdict(
            good=pl["phases"].get(PHASE_PLACED, 0),
            bad=pl["evictions"],
            objective=0.90, threshold=CHAOS_BURN_THRESHOLD)
    mig = out.get("migrations")
    if mig is not None:
        slos["migration-success"] = burn_verdict(
            good=mig["phases"].get(MIG_RESUMED, 0),
            bad=mig["phases"].get(MIG_ABORTED, 0),
            objective=0.90, threshold=CHAOS_BURN_THRESHOLD)
    gp = out.get("goodput")
    if gp is not None:
        # the same objective the production slice-goodput SLOSpec
        # carries (metrics/slo.py), fed the verdict's deterministic
        # step classification instead of the live counters
        slos["slice-goodput"] = burn_verdict(
            good=gp["steps_good"], bad=gp["steps_degraded"],
            objective=0.90, threshold=CHAOS_BURN_THRESHOLD)
    return {
        "objective_threshold": CHAOS_BURN_THRESHOLD,
        "slos": {k: slos[k] for k in sorted(slos)},
        "breached": sorted(n for n, v in slos.items() if v["breached"]),
    }


# -- scenario driver --------------------------------------------------------


def run_scenario(scenario: str, nodes: int = 100, seed: int = 0,
                 steps: Optional[int] = None, cached: bool = True) -> dict:
    """Run one named scenario and return its deterministic verdict.

    ``cached=True`` (the default, matching production) puts an
    informer-backed :class:`~tpu_operator_torch.runtime.cache.CachedClient`
    between the controllers and the fault-injecting apiserver — the
    watch-drop scenarios then exercise the cache's relist healing, and
    the checker's ``cache-staleness`` invariant holds it to account."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown chaos scenario {scenario!r}; "
                         f"choose from {', '.join(SCENARIOS)}")
    if scenario in FEDERATION_SCENARIOS:
        # N-cell scenarios run the federation plane's own loop; it owns
        # its globals ctx (and its own restart-coherent wrapper), so it
        # is imported lazily to keep the module graphs independent
        from .federation import run_federation_scenario

        return run_federation_scenario(scenario, nodes=nodes, seed=seed,
                                       steps=steps)
    import logging

    # injected faults make the controllers log real ERROR tracebacks by
    # design — hundreds of them. The verdict is the signal; the expected
    # failure spam is not. Anything that matters (a dropped invariant, a
    # non-convergence) lands in the verdict, not the log.
    op_log = logging.getLogger("tpu_operator_torch")
    prev_level = op_log.level
    op_log.setLevel(logging.CRITICAL)
    try:
        return _run_scenario(scenario, nodes, seed, steps, cached)
    finally:
        op_log.setLevel(prev_level)


def _chaos_globals(scenario: str, seed: int):
    """Context manager owning the process-wide recorders for one run.

    Span timestamps come from the yielded virtual clock and sequence ids
    restart at 0, so traces/timelines embedded in the verdict are part
    of the deterministic output (byte-identical per seed). The DAG
    scheduler runs in VIRTUAL mode: waves execute sequentially in a
    seeded shuffle, so branch interleaving is adversarial yet the run
    stays single-threaded. A fresh RNG per run makes back-to-back runs
    of the same seed identical too."""
    import random

    from ..state.scheduler import DAG_GATE

    @contextmanager
    def _ctx():
        clock = VirtualClock()
        prev_dag, prev_rng = DAG_GATE.enabled, DAG_GATE.virtual_rng
        with recorders_saved():
            TRACER.reset(clock=clock, enabled=True)
            TIMELINE.reset(clock=clock, enabled=True)
            DAG_GATE.enabled = True
            DAG_GATE.virtual_rng = random.Random(f"dag:{scenario}:{seed}")
            try:
                yield clock
            finally:
                DAG_GATE.enabled, DAG_GATE.virtual_rng = prev_dag, prev_rng

    return _ctx()


@contextmanager
def recorders_saved():
    """Hand the process-wide ``TRACER`` and ``TIMELINE`` back as they
    were found — buffers, sequence numbers, clocks and flags — however
    the body resets them."""
    saved = TRACER.save(), TIMELINE.save()
    try:
        yield
    finally:
        TRACER.restore(saved[0])
        TIMELINE.restore(saved[1])


def _run_scenario(scenario: str, nodes: int, seed: int,
                  steps: Optional[int], cached: bool) -> dict:
    with _chaos_globals(scenario, seed) as clock:
        out = _run_scenario_impl(scenario, nodes, seed, steps, cached,
                                 clock)
    if scenario in RESTART_COHERENT_SCENARIOS:
        # restart-coherent: re-run the same seed with ONLY the crash
        # faults stripped — every other fault, request and clock tick
        # identical — and demand the byte-identical canonical settled
        # state. A crash changing what settled state the fleet reaches
        # is exactly the bug class this scenario exists to catch. For
        # the saturation scenario this also pins the snapshot-restored
        # deficit clocks and budget tokens: a restart that re-ran or
        # skipped a rescue would settle a different set of placements.
        with _chaos_globals(scenario, seed) as base_clock:
            base = _run_scenario_impl(scenario, nodes, seed, steps,
                                      cached, base_clock,
                                      strip_crashes=True)
        coherent = (base["converged"]
                    and base["settled_digest"] == out["settled_digest"])
        out["restart_coherent"] = {
            "ok": bool(out["converged"] and coherent),
            "digest": out["settled_digest"],
            "baseline_digest": base["settled_digest"],
            "baseline_converged": base["converged"],
        }
        if out["converged"] and not coherent:
            out["violations"].append({
                "invariant": "restart-coherent", "step": out["steps"],
                "detail": "settled state after crash+restore diverged "
                          "from the never-crashed baseline "
                          f"({out['settled_digest'][:12]} != "
                          f"{base['settled_digest'][:12]}, baseline "
                          f"converged={base['converged']})"})
            out["ok"] = False
    return out


def _run_scenario_impl(scenario: str, nodes: int, seed: int,
                       steps: Optional[int], cached: bool,
                       clock: VirtualClock,
                       strip_crashes: bool = False) -> dict:
    from ..runtime.tracing import TRACER, TracingClient

    n_steps = steps or DEFAULT_STEPS
    fake = build_cluster(n_gpu=nodes)
    chaos = ChaosClient(fake, clock)
    # controllers read through the cache (which reads through the chaos
    # client, so informer relists still eat armed faults); the adversary
    # and the checker keep talking to the unwrapped fake. The cache runs
    # on the virtual clock so degraded-mode reconnect backoff and
    # staleness age are part of the deterministic schedule.
    client = CachedClient(chaos, now=clock) if cached else chaos
    # the reconcilers' client verbs get trace spans; the checker and the
    # verdict's relist counter keep the bare client
    traced = TracingClient(client)
    upgrade_spec = {"autoUpgrade": True,
                    "maxParallelUpgrades": MAX_PARALLEL_UPGRADES}
    if scenario in SHIM_SCENARIOS:
        # a short virtual migrate window (3 ticks): the elastic requests
        # complete the handshake inside it, the rigid ones demonstrably
        # time out into the hard-drain degradation path
        upgrade_spec["migrationTimeoutSeconds"] = int(MIGRATION_TIMEOUT_S)
    fake.create(new_cluster_policy(spec={"upgradePolicy": upgrade_spec}))
    # the saturation scenario runs under a quota tree (seeded as the
    # production ConfigMap, so the controller exercises its own config
    # loading) and the throughput-aware finish-time admission policy;
    # every other scenario has no tree, so its admission layer — and
    # its verdict — is byte-identical to before this plane existed
    quota_tree = None
    admission_policy = None
    if scenario == "saturation-storm":
        import json as _json

        from ..scheduling.quota import (
            QUOTA_CONFIG_KEY,
            QUOTA_CONFIGMAP,
            QuotaTree,
        )

        quota_doc = _saturation_quota(nodes)
        fake.create({
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": QUOTA_CONFIGMAP,
                         "namespace": NAMESPACE},
            "data": {QUOTA_CONFIG_KEY: _json.dumps(quota_doc,
                                                   sort_keys=True)}})
        quota_tree = QuotaTree.from_config(quota_doc)
        admission_policy = "finish-time"
    prec = ClusterPolicyReconciler(client=traced, namespace=NAMESPACE)
    urec = UpgradeReconciler(client=traced, namespace=NAMESPACE, now=clock)
    # the failover scenario runs sharded queues (kills rehash keys); every
    # other scenario keeps one shard — identical routing to before
    shards = FAILOVER_SHARDS if scenario == "shard-failover" else 1
    ctrls = [_SyncController(prec, traced, clock, shards=shards,
                             name="policy"),
             _SyncController(urec, traced, clock, shards=shards,
                             name="upgrade")]
    prec.setup_controller(ctrls[0], None)
    urec.setup_controller(ctrls[1], None)
    # the placement controller only joins the scenarios built around it:
    # the other scenarios create no SliceRequests, and keeping their
    # controller set unchanged keeps their verdicts unchanged. Preemption
    # is ON for the contention storm (off by default in production) so it
    # also exercises the priority-eviction path under fire; the migrate
    # scenario keeps it off so every rebind is a migration, not an
    # eviction, and runs on the virtual clock for the intent deadlines.
    # the storm scenario keeps preemption off: its whole demand wave is
    # same-age Pending, so the interesting machinery is the batched gang
    # pass and the index's churn survival, not the eviction path
    place_ctrl = None
    if scenario in PLACEMENT_SCENARIOS:
        lrec = PlacementReconciler(
            client=traced, namespace=NAMESPACE,
            preemption=(scenario == "placement-contention"),
            now=clock, resize_timeout=RESIZE_TIMEOUT_VIRTUAL_S,
            admission_policy=admission_policy)
        place_ctrl = _SyncController(lrec, traced, clock, shards=shards,
                                     name="placement")
        lrec.setup_controller(place_ctrl, None)
        ctrls.append(place_ctrl)
    # the fleet-telemetry plane joins the chip-degrade scenario: a fresh
    # scorer on the virtual clock folds digests O(delta) off the cache's
    # delta hook (per-tick resync when uncached), and the telemetry
    # reconciler publishes its verdict as the node condition the
    # placement engine then drains on — the full ingest -> score ->
    # condemn -> evict loop under fire
    telemetry = None
    tel_ctrl = None
    if scenario == "chip-degrade":
        telemetry = FleetTelemetry(now=clock)
        if cached:
            telemetry.attach(client)
        trec = TelemetryReconciler(client=traced, telemetry=telemetry)
        tel_ctrl = _SyncController(trec, traced, clock, shards=shards,
                                   name="telemetry")
        trec.setup_controller(tel_ctrl, None)
        ctrls.append(tel_ctrl)
    # elastic workload shims (the training jobs' half of the slice-intent
    # protocol) join only the migrate scenario; requests named ``rreq-*``
    # deliberately get none — they model rigid jobs that never ack, so the
    # migrate stage's timeout -> hard-drain fallback is always exercised
    shims: Dict[str, ElasticWorkload] = {}

    state = {"marker": None, "rollout": False, "chips": {}, "drift": False,
             "shims": shims, "ctrls": ctrls}
    resync = Request(name=POLICY)
    checker = InvariantChecker(fake, NAMESPACE,
                               cache=client if cached else None,
                               journal=prec.state_manager.journal,
                               quota=quota_tree, step_dt=STEP_DT)
    relists_lost = 0  # relists crashed processes performed, for the verdict

    def _enqueue_resync(c: _SyncController) -> None:
        # the resync add is the informer-resync analog: the liveness
        # backstop that keeps a scenario about SAFETY invariants — one
        # event lost to an armed fault inside a watch handler must not
        # deadlock the whole run. The placement controller's resync is
        # per-request: its primary kind is the SliceRequest, not the CR.
        if c is place_ctrl:
            for cr in fake.list(V1ALPHA1, KIND_SLICE_REQUEST):
                c.add(Request(name=name_of(cr),
                              namespace=namespace_of(cr)))
        elif c is tel_ctrl:
            # the telemetry reconciler's primary is the Node: its resync
            # re-audits every GPU node's condition against the scorer
            for n in fake.list("v1", "Node"):
                if L.is_gpu_node(n):
                    c.add(Request(name=name_of(n)))
        else:
            c.add(resync)

    def tick() -> None:
        if telemetry is not None and not cached:
            # no delta hook to ride: feed the same fold from a listing
            telemetry.resync(fake.list("v1", "Node"))
            for cr in fake.list(V1ALPHA1, KIND_SLICE_REQUEST):
                telemetry.on_request_delta("MODIFIED", cr)
        for c in ctrls:
            _enqueue_resync(c)
            c.drain()
        simulate_kubelet(fake, ready=True)
        if scenario in SHIM_SCENARIOS:
            # the training jobs run their quantum: elastic requests get a
            # shim the first time they appear, rigid (rreq-*) never do.
            # Shims talk to the unwrapped fake like any out-of-cluster
            # client — their writes still raise watch events for the
            # controllers, but armed faults stay aimed at the operator.
            # The shims themselves survive an OPERATOR_CRASH: the
            # training jobs don't die when the operator does.
            for cr in fake.list(V1ALPHA1, KIND_SLICE_REQUEST):
                nm = name_of(cr)
                if nm.startswith("ereq-") and nm not in shims:
                    shims[nm] = ElasticWorkload(fake, nm, NAMESPACE,
                                                clock=clock)
            for nm in sorted(shims):
                shims[nm].tick()
        for c in ctrls:
            c.drain()
        clock.advance(STEP_DT)
        for c in ctrls:
            c.drain()

    def _crash_restart(step: int) -> None:
        """OPERATOR_CRASH: the process dies and a successor boots.

        Everything in process memory — work queues, delayed requeues,
        the FleetIndex, Unschedulable backoff counters, the informer
        stores — is gone. The successor warm-restores from the last
        periodic snapshot (``state["snapshot"]``, captured at the end of
        the previous tick like the production writer thread would have),
        seeds its cache stores pre-watch, adopts the restored index, and
        re-derives the requeue state — so recovery work is O(changes
        since snapshot), and every invariant must hold across the gap.
        """
        nonlocal client, traced, prec, urec, place_ctrl, relists_lost
        for c in ctrls:
            c.stop()
        if cached:
            relists_lost += client.relists
            client.close()
        snap = state.get("snapshot") if cached else None
        client = CachedClient(chaos, now=clock) if cached else chaos
        restored = None
        if snap is not None:
            restored = snapshot_mod.restore(client, snap)
        traced = TracingClient(client)
        prec = ClusterPolicyReconciler(client=traced, namespace=NAMESPACE)
        urec = UpgradeReconciler(client=traced, namespace=NAMESPACE,
                                 now=clock)
        ctrls[:] = [_SyncController(prec, traced, clock, shards=shards,
                                    name="policy"),
                    _SyncController(urec, traced, clock, shards=shards,
                                    name="upgrade")]
        lrec = PlacementReconciler(
            client=traced, namespace=NAMESPACE, preemption=False,
            now=clock, resize_timeout=RESIZE_TIMEOUT_VIRTUAL_S,
            admission_policy=admission_policy)
        if snap is not None:
            idx = snapshot_mod.restore_index(snap)
            if idx is not None:
                # before any watch subscribes: the adopted index's delta
                # listener then folds exactly the replayed delta
                lrec.adopt_index(idx)
            adm = snapshot_mod.restore_admission(snap)
            if adm is not None:
                # deficit clocks + preemption-budget tokens survive the
                # crash: a restart must neither reset a starving class's
                # clock nor refill a spent window
                lrec.adopt_admission(adm)
            for skey, payload in snap.get("stores", {}).items():
                if skey.endswith("/" + KIND_SLICE_REQUEST):
                    lrec.seed_requeue_state(payload.get("objects") or [])
        place_ctrl = _SyncController(lrec, traced, clock, shards=shards,
                                     name="placement")
        ctrls.append(place_ctrl)
        # watches subscribe here — seeded stores replay O(delta)
        prec.setup_controller(ctrls[0], None)
        urec.setup_controller(ctrls[1], None)
        lrec.setup_controller(place_ctrl, None)
        state["ctrls"] = ctrls
        state["crashes"] = state.get("crashes", 0) + 1
        state.setdefault("restores", []).append({
            "step": step,
            "outcome": ("restored" if restored is not None
                        else ("cold" if cached else "uncached")),
            "objects": (restored or {}).get("objects", 0),
            "kinds": (restored or {}).get("kinds", 0),
        })
        checker.on_operator_restart(step,
                                    cache=client if cached else None,
                                    journal=prec.state_manager.journal)

    def verdict(plan: FaultPlan, converged: bool, soak: int,
                conv_s: Optional[float]) -> dict:
        # lane-priority invariant: the worst-served health item across
        # every controller waited behind at most LANE_PRIORITY_BUDGET
        # bulk reconciles — checked at verdict time so every exit path
        # (setup failure included) audits it
        for ctrl in ctrls:
            if ctrl.max_health_behind_bulk > LANE_PRIORITY_BUDGET:
                checker.record(
                    "lane-priority", plan.steps,
                    f"[{ctrl.name}] a health-lane event waited behind "
                    f"{ctrl.max_health_behind_bulk} bulk reconciles "
                    f"(budget {LANE_PRIORITY_BUDGET})")
        violations = checker.to_list()
        out = {
            "scenario": scenario,
            "seed": seed,
            "nodes": nodes,
            "steps": plan.steps,
            "schedule": [asdict(f) for f in plan.faults],
            "faults_injected": {k: chaos.injected[k]
                                for k in sorted(chaos.injected)},
            "cached": cached,
            # accumulated across operator restarts: crashed processes'
            # relists plus the live one's
            "cache_relists": (client.relists + relists_lost) if cached
            else 0,
            "converged": converged,
            "soak_passes": soak,
            "convergence_virtual_s": conv_s,
            "violations": violations,
            # flight-recorder evidence: the slowest reconcile (virtual
            # duration — latency faults advance the clock) and every
            # failed one, each a complete span tree down to client verbs
            "traces": {
                "slowest": TRACER.slowest_trace(),
                "failed": TRACER.failed_traces(),
            },
            # fleet-scale queueing evidence: worst health-behind-bulk
            # wait per controller, and (sharded runs) the kill ledger —
            # which shards died and how many queued keys each failover
            # rehashed onto the survivors
            "lanes": {
                "budget": LANE_PRIORITY_BUDGET,
                "max_health_behind_bulk": {
                    ctrl.name: ctrl.max_health_behind_bulk
                    for ctrl in ctrls},
            },
            "shards": {
                "configured": shards,
                "live": {ctrl.name: list(ctrl._live) for ctrl in ctrls},
                "kills": state.get("shard_kills", []),
                "keys_rehashed": sum(ctrl.keys_moved_on_failover
                                     for ctrl in ctrls),
            },
            "ok": bool(converged and not violations),
        }
        if place_ctrl is not None:
            out["placement"] = _placement_summary(fake)
        if scenario in SHIM_SCENARIOS:
            out["migrations"] = _migration_summary(fake)
        if scenario == "slice-migrate":
            # the per-object causal story (enqueue causes, migration
            # phases, placement decisions) rides the verdict for the
            # migrate scenario — the `gpuop-cfg why` golden chain. Only
            # the kinds that tell that story: operand write-avoided
            # noise would dwarf the verdict
            out["timelines"] = {
                k: ev for k, ev in TIMELINE.snapshot().items()
                if k.split("/", 1)[0] in ("SliceRequest",
                                          "GPUClusterPolicy",
                                          "UpgradeUnit")}
        if scenario in RESTART_COHERENT_SCENARIOS:
            out["restarts"] = {
                "crashes": state.get("crashes", 0),
                "restores": state.get("restores", []),
            }
            settled = canonical_settled_state(fake, NAMESPACE)
            out["settled_state"] = settled
            out["settled_digest"] = settled_state_digest(settled)
        if scenario == "saturation-storm" and place_ctrl is not None:
            # the fair-share ledger at settle: per-class usage, queue
            # depth, shares, deficit clocks and remaining budget tokens
            # — all virtual-clock reads, byte-identical per seed
            try:
                out["admission"] = place_ctrl.reconciler.admission_report()
            except ApiError:
                pass  # an unconsumed armed fault ate the report reads
        if scenario == "chip-degrade":
            out["telemetry"] = _telemetry_summary(fake, telemetry, state)
            out["goodput"] = _goodput_summary(fake, clock.t, state)
        if scenario == "apiserver-brownout":
            out["brownout"] = {
                "degraded_entered": bool(state.get("degraded_seen")),
                "max_staleness_virtual_s": round(
                    state.get("max_staleness", 0.0), 1),
                "healed": (not getattr(client, "degraded", False))
                if cached else True,
            }
            if cached and converged and not state.get("degraded_seen"):
                # the scenario exists to prove the degradation path; a
                # breaker that never tripped during a full brownout
                # window means the mode is unreachable, not that the
                # run got lucky
                checker.record(
                    "degraded-mode", plan.steps,
                    "cache never entered degraded mode during the "
                    "brownout window")
                out["violations"] = checker.to_list()
                out["ok"] = bool(converged and not out["violations"])
        out["slo"] = _slo_verdict(scenario, out, conv_s)
        return out

    # baseline convergence — faults only start from a known-good state,
    # so a later non-convergence indicts the storm, not the install
    for _ in range(SETUP_PASS_BUDGET):
        tick()
        if _converged(fake, state):
            break
    else:
        checker.record("convergence", -1,
                       "cluster never reached all-Ready before fault "
                       "injection")
        return verdict(FaultPlan(scenario=scenario, seed=seed, steps=0),
                       converged=False, soak=0, conv_s=None)

    gpu_names = sorted(
        name_of(n) for n in fake.list("v1", "Node")
        if L.is_gpu_node(n))
    plan = FaultPlan.build(scenario, seed, gpu_names, n_steps)
    if strip_crashes:
        # the restart-coherent baseline: identical schedule minus the
        # crashes themselves (the RNG already ran, so every other fault
        # is byte-identical to the crashed run's)
        plan = FaultPlan(scenario=plan.scenario, seed=plan.seed,
                         steps=plan.steps,
                         faults=[f for f in plan.faults
                                 if f.kind != OPERATOR_CRASH])
    # periodic-snapshot analog: capture at the end of every tick while
    # crash faults remain, so a crash restores from the PREVIOUS tick's
    # state and the successor's recovery is genuinely O(delta)
    take_snapshots = cached and any(f.kind == OPERATOR_CRASH
                                    for f in plan.faults)

    for step in range(plan.steps):
        step_faults = plan.for_step(step)
        dropping = any(f.kind == WATCH_DROP for f in step_faults)
        crashing = any(f.kind == OPERATOR_CRASH for f in step_faults)
        if any(f.kind == BROWNOUT_START for f in step_faults):
            # the apiserver goes dark: every stream dies AND every list
            # fails, while the world below keeps moving
            chaos.suspend_watch_streams()
            chaos.set_brownout(True)
            if cached:
                client.mark_stale()
        if dropping:
            # streams die BEFORE this step's mutations land, so the
            # events are genuinely lost; the resume's relist must heal
            chaos.suspend_watch_streams()
        for fault in step_faults:
            if fault.kind not in (WATCH_DROP, OPERATOR_CRASH,
                                  BROWNOUT_START, BROWNOUT_END):
                _apply_fault(fault, fake, chaos, state)
        if dropping:
            chaos.resume_watch_streams()
        if any(f.kind == BROWNOUT_END for f in step_faults):
            # capture the breaker state at the worst moment — the
            # instant before heal — then let the streams replay
            if cached:
                state["degraded_seen"] = (state.get("degraded_seen")
                                          or client.degraded)
            chaos.set_brownout(False)
            chaos.resume_watch_streams()
        if crashing:
            # the process dies MID-PASS: resync enqueued, a handful of
            # reconciles in, then every queue is abandoned half-drained
            for c in ctrls:
                _enqueue_resync(c)
                c.drain(budget=CRASH_PARTIAL_DRAIN)
            chaos.record(OPERATOR_CRASH)
            _crash_restart(step)
        tick()
        if cached and chaos.brownout:
            state["degraded_seen"] = (state.get("degraded_seen")
                                      or client.degraded)
            state["max_staleness"] = max(state.get("max_staleness", 0.0),
                                         client.staleness_s())
        if take_snapshots:
            import json

            state["snapshot"] = json.loads(json.dumps(
                snapshot_mod.capture(client, index=getattr(
                    place_ctrl.reconciler, "fleet_index", None)
                    if place_ctrl is not None else None,
                    wall=clock(),
                    admission=place_ctrl.reconciler.admission_snapshot()
                    if place_ctrl is not None else None),
                sort_keys=True))
        checker.observe(step)

    faults_stopped_at = clock.t
    soak = 0
    converged = _converged(fake, state)
    while not converged and soak < SOAK_PASS_BUDGET:
        tick()
        soak += 1
        checker.observe(plan.steps + soak - 1)
        converged = _converged(fake, state)
    if converged:
        conv_s = clock.t - faults_stopped_at
        # one final resync pass before the settled audit: the production
        # Manager's periodic-resync analog. Label-only transitions the
        # upgrade controller makes late in a tick (the last unit flipping
        # to done) don't match the policy's node-watch predicate, so the
        # CR's status rows may legitimately trail the cluster by one
        # pass — a liveness gap resync closes, not a lost write.
        for c in ctrls:
            c.add(resync)
            c.drain()
        checker.check_settled(plan.steps + soak)
    else:
        conv_s = None
        checker.record(
            "convergence", plan.steps + soak,
            f"cluster not all-Ready after {soak} soak passes "
            f"({soak * STEP_DT:.0f} virtual s) past the last fault")
    return verdict(plan, converged=converged, soak=soak, conv_s=conv_s)

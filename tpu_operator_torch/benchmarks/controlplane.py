"""Reconcile-loop scale benchmark on a mock cluster.

The port's counterpart of ``tpu_operator/benchmarks/controlplane.py``,
for the functions whose modules are ported. It measures:

- install -> all-operands-Ready wall time on an N-node cluster,
- a steady-state reconcile pass's wall time,
- apiserver requests per steady-state pass, split by verb — the number
  that must be O(states), not O(states x nodes),
- the same steady pass through the informer-backed
  :class:`~tpu_operator_torch.runtime.cache.CachedClient`: reads served
  from the watch-fed cache, so the apiserver sees *write verbs only* and
  the request count is independent of node count,
- install wall time through the real threaded Manager at workers=N
  (``run_concurrency_bench``), the MaxConcurrentReconciles knob,
- serial against DAG install on a latency-charged apiserver
  (``run_dag_compare_bench``),
- a fleet driver rollout through the upgrade FSM (``run_rollout_bench``),
- cache bytes per node, paged relists and lane queue times at fleet
  scale (``run_fleet_bench``), and the lineage stamp's cost
  (``run_lineage_bench``),
- the fleet telemetry fold's ingest overhead, digest bytes a node and
  the goodput SLO's breach (``run_telemetry_bench``),
- the placement engine's decision latency and packing against first
  fit (``run_placement_bench``), the incremental index against the
  rescan at fleet scale (``run_placement_fleet_bench``), the elastic
  migration against kill-and-reschedule through a driver rollout and
  the same-domain resize (``run_migration_bench``,
  ``run_resize_bench``), the snapshot-warm restart against a cold one
  (``run_restart_bench``) and fair-share admission at saturation
  (``run_fairness_bench``), and the federated plane's global routing
  against one flat index over the same fleet (``run_federation_bench``).

Used by ``tpu_operator_torch.bench`` (the control-plane rider of the
port's headline line). Everything runs on the in-memory fake apiserver:
this benchmark is about the operator's own request/CPU behavior, which
is identical against the mock and a real apiserver modulo wire latency.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..api import labels as L
from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1, new_cluster_policy
from ..runtime.fake import FakeClient
from ..runtime.manager import Request

# install -> all-operands-Ready under 5 minutes (the reference's
# BASELINE.md budget): the single source for the rider's vs_baseline
INSTALL_BUDGET_S = 300.0

# the reference's mix (four pools, the same shares, one of them
# multi-host, CPU nodes on top) in GKE's GPU machine families: A3 High
# (8 H100s on NVSwitch), A4X (4 GB200s a host in a multi-host NVL72
# domain: the mnnvl pool), A3 High's 4-card shape, and A2 Ultra (8
# A100s on NVSwitch). Pools key on feature discovery's gpu.product x
# gpu.topology (state/nodepool.py)
POOL_MIX = (
    # (GKE accelerator label, gpu.product, gpu.topology, cards per host,
    #  hosts share of n)
    ("nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3", "nvswitch-8", 8, 0.40),
    ("nvidia-gb200", "NVIDIA-GB200", "mnnvl-4", 4, 0.20),  # multi-host
    ("nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3", "nvswitch-4", 4, 0.25),
    ("nvidia-a100-80gb", "NVIDIA-A100-SXM4-80GB", "nvswitch-8", 8, 0.15),
)
CPU_FRACTION = 0.10  # on top of n_gpu

# the placement benchmarks' request mix in the POOL_MIX's terms, entry by
# entry for the reference's: a hard pin names a gpu.product where the
# reference pins a GKE TPU accelerator (tpu-v5e-slice, tpu-v5p-slice,
# tpu-v4-podslice), a soft preference two generations of the list where
# the reference samples two of (v4, v5e, v5p); v5p's multi-host pool is
# the GB200's
PINNED_PRODUCTS = ("NVIDIA-H100-80GB-HBM3", "NVIDIA-GB200",
                   "NVIDIA-A100-SXM4-80GB")
PREFERRED_GENERATIONS = ("a100-sxm", "h100-sxm", "gb200")


def _gpu_labels(accel: str, product: str, topology: str, cards: int) -> dict:
    return {L.GKE_ACCELERATOR: accel,
            L.GKE_ACCELERATOR_COUNT: str(cards),
            L.GPU_PRODUCT: product,
            L.GPU_TOPOLOGY: topology}


def build_cluster(n_gpu: int = 500) -> FakeClient:
    """N GPU nodes in the POOL_MIX, plus CPU nodes."""
    c = FakeClient()
    made = 0
    for accel, product, topo, cards, share in POOL_MIX:
        count = int(n_gpu * share)
        for i in range(count):
            c.add_node(f"{accel.split('-')[1]}-{topo}-{i}",
                       labels=_gpu_labels(accel, product, topo, cards),
                       allocatable={L.GPU_RESOURCE: str(cards)})
            made += 1
    accel, product, topo, cards, _ = POOL_MIX[0]
    for i in range(n_gpu - made):  # share rounding remainder
        c.add_node(f"h100-extra-{i}",
                   labels=_gpu_labels(accel, product, topo, cards),
                   allocatable={L.GPU_RESOURCE: str(cards)})
    for i in range(int(n_gpu * CPU_FRACTION)):
        c.add_node(f"cpu-{i}")
    return c


def _counter_sum(sample_name: str) -> float:
    """Sum a counter's samples across all label sets (writes_avoided is
    per-kind; the bench wants the total)."""
    from ..metrics.registry import REGISTRY

    total = 0.0
    for metric in REGISTRY.collect():
        for s in metric.samples:
            if s.name == sample_name:
                total += s.value
    return total


def run_scale_bench(n_gpu: int = 500,
                    client: Optional[FakeClient] = None) -> Dict:
    """Converge an n_gpu-node cluster, then measure one steady pass.

    Returns install_to_ready_s, steady_pass_s, steady-state request
    counts by verb, and the state count — the inputs for both the test
    budgets and the bench record."""
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler

    c = client or build_cluster(n_gpu)
    c.create(new_cluster_policy())
    rec = ClusterPolicyReconciler(client=c, namespace="gpu-operator")
    req = Request(name="gpu-cluster-policy")

    t0 = time.perf_counter()
    rec.reconcile(req)                 # apply all states
    c.simulate_kubelet(ready=True)     # kubelet schedules + readies pods
    rec.reconcile(req)                 # observe readiness -> CR ready
    install_s = time.perf_counter() - t0
    cr = c.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
    state = (cr.get("status") or {}).get("state")
    n_states = len(rec.state_manager.states)

    # reconcile-latency percentiles ride the new per-controller duration
    # histogram: snapshot its cumulative buckets here, diff at the end,
    # so the percentiles cover exactly the steady passes measured below
    # (the install reconciles above are excluded)
    from ..metrics.registry import histogram_buckets, quantiles_from_buckets

    buckets_before = histogram_buckets(
        "gpu_operator_reconcile_duration_seconds",
        labels={"controller": rec.name})

    # steady state: hash-skip pass, nothing rewritten. Wall time is the
    # min of three passes — a scheduler hiccup on a loaded CI box should
    # not define the steady-state figure. Request counts come from the
    # last pass (every steady pass issues the identical request set).
    steady_s = float("inf")
    c.reset_verb_counts()
    for _ in range(3):
        t1 = time.perf_counter()
        rec.reconcile(req)
        steady_s = min(steady_s, time.perf_counter() - t1)
        verbs = c.reset_verb_counts()

    # the same steady pass, reads served by the informer cache: a fresh
    # reconciler on the converged cluster, its client wrapped in
    # CachedClient. The first pass warms the informers (each kind's
    # subscribe replays current state — the fake counts it as one LIST,
    # the honest informer start-up cost); measurement starts after.
    from ..runtime import CachedClient

    cached = CachedClient(c)
    crec = ClusterPolicyReconciler(client=cached, namespace="gpu-operator")
    crec.reconcile(req)                # warm: informers subscribe + fill
    steady_cached_s = float("inf")
    c.reset_verb_counts()
    reads_before = cached.cache_reads
    # zero-write accounting over the cached steady passes: how many
    # writes the spec-hash/status skips absorbed, and the render-memo
    # hit ratio (a converged pass should re-render nothing)
    wa_before = _counter_sum("gpu_operator_writes_avoided_total")
    rh_before = _counter_sum("gpu_operator_render_cache_hits_total")
    rm_before = _counter_sum("gpu_operator_render_cache_misses_total")
    for _ in range(3):
        t1 = time.perf_counter()
        crec.reconcile(req)
        steady_cached_s = min(steady_cached_s, time.perf_counter() - t1)
        verbs_cached = c.reset_verb_counts()
        cache_reads = cached.cache_reads - reads_before
        reads_before = cached.cache_reads
    cached.close()
    writes_avoided = _counter_sum("gpu_operator_writes_avoided_total") - wa_before
    render_hits = _counter_sum("gpu_operator_render_cache_hits_total") - rh_before
    render_misses = (_counter_sum("gpu_operator_render_cache_misses_total")
                     - rm_before)
    render_total = render_hits + render_misses
    render_hit_ratio = (render_hits / render_total) if render_total else None

    buckets_after = histogram_buckets(
        "gpu_operator_reconcile_duration_seconds",
        labels={"controller": rec.name})
    steady_buckets = {le: buckets_after.get(le, 0.0)
                      - buckets_before.get(le, 0.0)
                      for le in buckets_after}
    qs = quantiles_from_buckets(steady_buckets, (0.50, 0.95, 0.99))
    latency_ms = (None if qs is None else
                  {"p50": qs[0] * 1000.0, "p95": qs[1] * 1000.0,
                   "p99": qs[2] * 1000.0})

    return {
        "n_gpu_nodes": n_gpu,
        "n_states": n_states,
        "ready": state == "ready",
        "install_to_ready_s": install_s,
        "steady_pass_s": steady_s,
        "steady_requests": sum(verbs.values()),
        "steady_verbs": verbs,
        # cached figures: apiserver requests left per steady pass (write
        # verbs only) and the reads the cache absorbed instead
        "steady_pass_cached_s": steady_cached_s,
        "steady_requests_cached": sum(verbs_cached.values()),
        "steady_verbs_cached": verbs_cached,
        "steady_cache_reads": cache_reads,
        # writes the spec-hash/status skips suppressed across the 3
        # cached passes, and the render memo's hit ratio over the same
        # window (converged steady state should re-render nothing)
        "steady_writes_avoided": writes_avoided,
        "render_cache": {
            "hits": render_hits,
            "misses": render_misses,
            "hit_ratio": render_hit_ratio,
        },
        # percentiles over the 6 steady passes (3 read-through + 3
        # cached), from the reconcile-duration histogram's bucket deltas
        # — histogram-resolution figures, not exact order statistics
        "reconcile_latency_ms": latency_ms,
    }


def run_concurrency_bench(n_gpu: int = 500, workers: int = 1,
                          timeout_s: float = 240.0) -> Dict:
    """Install -> Ready through the real threaded Manager with
    ``workers`` reconcile workers per controller (MaxConcurrentReconciles
    analog) over a CachedClient, on an n_gpu-node cluster.

    The kubelet simulator ticks between idle-waits, as in the e2e tier.
    Returns {n_gpu_nodes, workers, ready, wall_s, reconciles} — the
    datapoint showing whether the multi-worker configuration costs
    anything on the single-CR install path."""
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..runtime import CachedClient, Manager

    c = build_cluster(n_gpu)
    cached = CachedClient(c)
    mgr = Manager(cached, namespace="gpu-operator")
    ctrl = mgr.add_reconciler(
        ClusterPolicyReconciler(client=cached, namespace="gpu-operator"),
        workers=workers)
    mgr.start()
    t0 = time.perf_counter()
    c.create(new_cluster_policy())
    ready = False
    deadline = t0 + timeout_s
    while time.perf_counter() < deadline:
        c.simulate_kubelet(ready=True)
        mgr.wait_idle(timeout=30.0, horizon=1.0)
        cr = c.get_or_none(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
        if cr is not None and (cr.get("status") or {}).get("state") == "ready":
            ready = True
            break
    wall = time.perf_counter() - t0
    reconciles = ctrl.reconcile_total
    mgr.stop()
    cached.close()
    return {
        "n_gpu_nodes": n_gpu,
        "workers": workers,
        "ready": ready,
        "wall_s": wall,
        "reconciles": reconciles,
    }


class _LatencyClient:
    """Charge a fixed wall latency per apiserver verb (a real sleep, so
    it releases the GIL and parallel state syncs genuinely overlap it).
    This is the wire-latency model ``run_dag_compare_bench`` needs: on
    the zero-latency fake, a serial and a DAG install differ only by
    Python CPU time, which the GIL serializes anyway — with per-verb
    latency, the serial walk pays the *sum* of every state's verb naps
    while the DAG walk pays only its critical path's. ``watch`` is
    exempt (subscribing isn't a round-trip the reconcile path waits on);
    everything else, reads included, naps once per call."""

    def __init__(self, inner, per_verb_s: float):
        self.inner = inner
        self.per_verb_s = per_verb_s

    def _nap(self):
        time.sleep(self.per_verb_s)

    def get(self, *a, **kw):
        self._nap()
        return self.inner.get(*a, **kw)

    def get_or_none(self, *a, **kw):
        self._nap()
        return self.inner.get_or_none(*a, **kw)

    def list(self, *a, **kw):
        self._nap()
        return self.inner.list(*a, **kw)

    def create(self, *a, **kw):
        self._nap()
        return self.inner.create(*a, **kw)

    def update(self, *a, **kw):
        self._nap()
        return self.inner.update(*a, **kw)

    def update_status(self, *a, **kw):
        self._nap()
        return self.inner.update_status(*a, **kw)

    def patch(self, *a, **kw):
        self._nap()
        return self.inner.patch(*a, **kw)

    def delete(self, *a, **kw):
        self._nap()
        return self.inner.delete(*a, **kw)

    def watch(self, *a, **kw):
        return self.inner.watch(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def run_dag_compare_bench(n_gpu: int = 500,
                          verb_latency_s: float = 0.015) -> Dict:
    """Same install, serial walk vs DAG scheduler, on a latency-charged
    apiserver — the datapoint behind "install-to-ready is O(critical
    path), not O(states)".

    Per mode: a fresh n_gpu cluster is pre-labeled through the RAW
    client (the O(nodes) node-patch pass is identical in both modes and
    isn't what the DAG parallelizes — charging it latency would only
    dilute the comparison), then a reconciler over a
    :class:`_LatencyClient` runs install -> all-operands-Ready with the
    gate forced serial, then forced DAG. Returns both walls, the
    speedup, and the plan's shape."""
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..controllers.state_manager import StateManager
    from ..state.scheduler import DAG_GATE

    def install(dag: bool):
        c = build_cluster(n_gpu)
        c.create(new_cluster_policy())
        # pre-pass with the reconciler's own arguments (default spec:
        # sandbox off, auto-upgrade off) so the measured reconcile's
        # label pass finds zero drift and pays one LIST, no patches
        pre = StateManager(client=c, namespace="gpu-operator")
        pre.label_gpu_nodes("container", sandbox_enabled=False,
                            upgrade_annotation=False)
        rec = ClusterPolicyReconciler(
            client=_LatencyClient(c, verb_latency_s),
            namespace="gpu-operator")
        req = Request(name="gpu-cluster-policy")
        prev = DAG_GATE.enabled
        DAG_GATE.enabled = dag
        try:
            t0 = time.perf_counter()
            rec.reconcile(req)
            c.simulate_kubelet(ready=True)
            rec.reconcile(req)
            wall = time.perf_counter() - t0
        finally:
            DAG_GATE.enabled = prev
        cr = c.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
        return wall, (cr.get("status") or {}).get("state") == "ready"

    serial_s, serial_ready = install(dag=False)
    dag_s, dag_ready = install(dag=True)
    from ..state.operands import build_states
    from ..state.scheduler import DagPlan

    plan = DagPlan.build(build_states())
    return {
        "n_gpu_nodes": n_gpu,
        "verb_latency_ms": verb_latency_s * 1000.0,
        "install_serial_s": serial_s,
        "install_dag_s": dag_s,
        "speedup": (serial_s / dag_s) if dag_s > 0 else None,
        "ready": serial_ready and dag_ready,
        "n_states": len(plan.order),
        "dag_levels": len(plan.levels),
        "critical_path": list(plan.critical_path),
    }


def run_rollout_bench(n_gpu: int = 100, max_parallel: int = 8,
                      pass_budget: int = 50,
                      edge_triggered: bool = False) -> Dict:
    """Fleet driver-rollout throughput: bump the driver spec on a
    converged n_gpu-node cluster and drive the upgrade FSM
    (maxParallelUpgrades=max_parallel) until every GPU node is done and
    every driver pod runs the new template revision.

    ``edge_triggered=False`` (the default) drives the FSM the pre-DAG
    way: one blind ``urec.reconcile`` per pass, however little changed.
    ``edge_triggered=True`` registers the upgrade reconciler's real
    watch set (CR generation, driver DaemonSets, driver/validator pods,
    node upgrade-state labels) on a real :class:`~.manager.Controller`
    and drains only what the watches enqueue — a pass does as many
    targeted reconciles as events warrant, so one kubelet tick advances
    a whole admitted batch and the fleet converges in O(batches) passes
    instead of O(2x batches) blind polls.

    Returns {n_gpu_nodes, max_parallel, passes, wall_s, rolled,
    reconciles} — the scale datapoint the reference has no analog for
    (its upgrade loop is driven by requeues against a live cluster and
    is never measured). ``rolled`` False means the pass budget ran out
    first."""
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..controllers.upgrade_controller import (
        STATE_DONE,
        UpgradeReconciler,
        desired_revision,
    )
    from ..runtime import ListOptions
    from ..runtime.objects import get_nested, labels_of, thaw_obj

    c = build_cluster(n_gpu)
    c.create(new_cluster_policy(spec={
        "upgradePolicy": {"autoUpgrade": True,
                          "maxParallelUpgrades": max_parallel}}))
    prec = ClusterPolicyReconciler(client=c, namespace="gpu-operator")
    urec = UpgradeReconciler(client=c, namespace="gpu-operator")
    req = Request(name="gpu-cluster-policy")
    prec.reconcile(req)
    c.simulate_kubelet(ready=True)
    prec.reconcile(req)

    ctrl = None
    reconciles = 0
    if edge_triggered:
        from ..runtime.manager import Controller

        # the real Controller's watch/queue wiring, drained inline (no
        # worker threads — the bench stays deterministic and the pass
        # count stays comparable to the serial loop's). Registered
        # BEFORE the spec bump below, so the bump's generation change is
        # itself the first edge.
        ctrl = Controller("gpu-upgrade-bench", urec, c)
        urec.setup_controller(ctrl, None)

    def drain(budget: int = 200) -> int:
        """Reconcile what the watches enqueued, inline. Timed requeues
        stay parked (they are the liveness backstop, not the edge
        path); an event-storm on the policy key collapses to one queued
        item plus one dirty re-run — the workqueue's coalescing."""
        done = 0
        while done < budget:
            item = ctrl.queue.get(timeout=0)
            if item is None:
                break
            done += 1
            try:
                result = urec.reconcile(item)
            except Exception:
                ctrl.queue.add_rate_limited(item)
            else:
                if result and result.requeue_after > 0:
                    ctrl.queue.forget(item)
                    ctrl.queue.add_after(item, result.requeue_after)
                elif result and result.requeue:
                    ctrl.queue.add_rate_limited(item)
                else:
                    ctrl.queue.forget(item)
            finally:
                ctrl.queue.done(item)
        return done

    cr = thaw_obj(c.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy"))
    cr["spec"]["driver"] = {"installDir": "/opt/rollout-marker"}
    c.update(cr)
    prec.reconcile(req)
    c.simulate_kubelet(ready=True)

    def fleet_done() -> bool:
        gpu_nodes = [n for n in c.list("v1", "Node")
                     if labels_of(n).get(L.GKE_ACCELERATOR)]
        if any(labels_of(n).get(L.UPGRADE_STATE) != STATE_DONE
               for n in gpu_nodes):
            return False
        [ds] = [d for d in c.list(
            "apps/v1", "DaemonSet", ListOptions(namespace="gpu-operator"))
            if d["metadata"]["name"] == "gpu-driver-daemonset"]
        # the controller's own canonical revision definition, so the
        # bench can never disagree with what the FSM rolled to
        want = desired_revision(c, ds)
        pods = c.list("v1", "Pod", ListOptions(
            namespace="gpu-operator",
            label_selector={"gpu.graft.dev/component": "gpu-driver"}))
        return (len(pods) == len(gpu_nodes)
                and all(get_nested(p, "metadata", "labels",
                                   "controller-revision-hash") == want
                        for p in pods))

    t0 = time.perf_counter()
    passes = 0
    rolled = False
    while passes < pass_budget:
        passes += 1
        if edge_triggered:
            reconciles += drain()
            c.simulate_kubelet(ready=True)
            reconciles += drain()
        else:
            reconciles += 1
            urec.reconcile(req)
            c.simulate_kubelet(ready=True)
        if fleet_done():
            rolled = True
            break
    if ctrl is not None:
        ctrl.stop()
    return {
        "n_gpu_nodes": n_gpu,
        "max_parallel": max_parallel,
        "edge_triggered": edge_triggered,
        "passes": passes,
        "wall_s": time.perf_counter() - t0,
        "rolled": rolled,
        "reconciles": reconciles,
    }


def _lane_churn(churn_items: int) -> Dict:
    """Drive a real :class:`~tpu_operator_torch.runtime.workqueue.WorkQueue`
    through a bulk-churn backlog and measure per-lane queue time.

    The producer enqueues ``churn_items`` distinct bulk keys (a fleet
    rollout's per-unit requeues) with sparse health and placement events
    injected mid-stream; the consumer pops at a quarter of the enqueue
    rate, so the bulk backlog grows into the thousands exactly when the
    health events arrive. Strict lane priority is what keeps a health
    key's queue time at the consumer's per-pop latency while bulk keys
    wait out the whole backlog — the figure behind "a node-health event
    never queues behind 10k items of rollout churn"."""
    from ..runtime.workqueue import (
        LANE_BULK,
        LANE_HEALTH,
        LANE_PLACEMENT,
        LANES,
        WorkQueue,
    )

    q = WorkQueue()
    waits: Dict[str, list] = {lane: [] for lane in LANES}
    max_depth: Dict[str, int] = {lane: 0 for lane in LANES}

    def pop_one() -> bool:
        item, waited, lane, _ = q.get_with_info(timeout=0)
        if item is None:
            return False
        waits[lane].append(waited)
        q.done(item)
        return True

    health_n = placement_n = 0
    for i in range(churn_items):
        q.add(("bulk", i), lane=LANE_BULK)
        if i % 97 == 0:  # sparse node-health events amid the churn
            q.add(("health", health_n), lane=LANE_HEALTH)
            health_n += 1
        if i % 193 == 0:
            q.add(("placement", placement_n), lane=LANE_PLACEMENT)
            placement_n += 1
        if i % 4 == 0:  # consumer at 1/4 the enqueue rate: backlog grows
            pop_one()
        if i % 512 == 0:
            for lane, d in q.lane_depths().items():
                max_depth[lane] = max(max_depth[lane], d)
    while pop_one():  # drain the accumulated backlog
        pass
    q.shutdown()

    def p99_ms(lane: str) -> float:
        xs = sorted(waits[lane])
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))] * 1000.0

    return {
        "churn_items": churn_items,
        "served": {lane: len(waits[lane]) for lane in LANES},
        "max_depth": max_depth,
        "p99_ms": {lane: p99_ms(lane) for lane in LANES},
    }


def fatten_nodes(c) -> None:
    """Give every node the kubelet-reported status payload a real
    fleet carries — image records and attached-volume lists are the
    bulk of a production Node object, and exactly what the index-only
    projection drops. Without them the synthetic fleet would make the
    projection look free AND worthless at once."""
    from ..runtime.objects import name_of, thaw_obj

    for n in c.list("v1", "Node"):
        node = thaw_obj(n)
        status = node.setdefault("status", {})
        status["images"] = [
            {"names": [f"registry.example/layer-{i}@sha256:{i:064x}"],
             "sizeBytes": 10_000_000 + i} for i in range(40)]
        status["volumesInUse"] = [
            f"kubernetes.io/csi/pd-{name_of(node)}-{i}"
            for i in range(8)]
        c.update_status(node)


def run_fleet_bench(n_gpu: int = 10000, baseline_gpu: int = 500,
                    churn_items: int = 20000) -> Dict:
    """The 10k-node survivability datapoint: cache bytes per node must be
    flat as the fleet grows 20x (index-only projections keep the store
    O(fleet) with a small constant), a steady reconcile pass must stay
    read-free on the apiserver, a relist must page through the fleet in
    ``relist_chunk``-object chunks, and a health-lane event's p99 queue
    time under bulk churn must stay decades under the bulk lane's.

    Returns the two guard figures (``fleet_bytes_per_node``,
    ``fleet_p99_queue_ms`` — the health lane's p99) alongside the
    supporting evidence: the 500-node baseline bytes/node, the
    projected-vs-full savings, relist page count, per-lane p99s, and the
    process max-RSS for the whole run (informative only: it includes the
    fake apiserver's full-fidelity copy of the cluster, which a real
    operator never holds)."""
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..runtime import CachedClient

    def converged_stats(n: int):
        """Converge an n-node cluster, warm a CachedClient over it, and
        return (raw client, cached client, reconciler, stats dict)."""
        c = build_cluster(n)
        fatten_nodes(c)
        c.create(new_cluster_policy())
        rec = ClusterPolicyReconciler(client=c, namespace="gpu-operator")
        req = Request(name="gpu-cluster-policy")
        rec.reconcile(req)
        c.simulate_kubelet(ready=True)
        rec.reconcile(req)
        cached = CachedClient(c)
        crec = ClusterPolicyReconciler(client=cached,
                                       namespace="gpu-operator")
        crec.reconcile(req)  # warm: informers subscribe + fill
        return c, cached, crec, req

    def bytes_per_node(cached: CachedClient) -> tuple:
        """(projected, full) cache bytes per Node object, summed over
        every cached kind — the per-node cost of the whole watch cache,
        not just the Node store."""
        kinds = cached.cache_stats()["kinds"]
        n_nodes = kinds["v1/Node"]["objects"]
        total = sum(k["bytes"] for k in kinds.values())
        full = sum(k["full_bytes"] or k["bytes"] for k in kinds.values())
        return total / n_nodes, full / n_nodes

    # 500-node baseline: same converge + warm, only the fleet size differs
    _, base_cached, _, _ = converged_stats(baseline_gpu)
    base_bpn, _ = bytes_per_node(base_cached)
    base_cached.close()

    t0 = time.perf_counter()
    c, cached, crec, req = converged_stats(n_gpu)
    install_s = time.perf_counter() - t0
    cr = c.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy")
    ready = (cr.get("status") or {}).get("state") == "ready"
    fleet_bpn, fleet_full_bpn = bytes_per_node(cached)

    # steady pass at fleet scale through the cache: min of 3, write verbs
    # only on the apiserver (the O(states)-not-O(nodes) property at 10k)
    steady_s = float("inf")
    c.reset_verb_counts()
    for _ in range(3):
        t1 = time.perf_counter()
        crec.reconcile(req)
        steady_s = min(steady_s, time.perf_counter() - t1)
        verbs = c.reset_verb_counts()

    # paginated relist of the fleet's Node store: flag the store dirty
    # (what a dropped watch does) and let the next read heal it; the
    # fake's verb counter shows how many LIST pages the chunking issued
    store = cached._stores[("v1", "Node")]
    c.reset_verb_counts()
    store.needs_relist = True
    t1 = time.perf_counter()
    cached.list("v1", "Node")
    relist_s = time.perf_counter() - t1
    relist_pages = c.reset_verb_counts().get("list", 0)
    cached.close()

    from ..runtime.workqueue import LANE_BULK, LANE_HEALTH

    lanes = _lane_churn(churn_items)
    health_p99 = lanes["p99_ms"][LANE_HEALTH]
    bulk_p99 = lanes["p99_ms"][LANE_BULK]

    try:
        import resource
        rss_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                  / 1024.0)
    except Exception:  # pragma: no cover - non-POSIX
        rss_mb = None

    return {
        "n_gpu_nodes": n_gpu,
        "baseline_nodes": baseline_gpu,
        "ready": ready,
        "install_to_ready_s": install_s,
        "fleet_steady_pass_s": steady_s,
        "fleet_steady_verbs": verbs,
        # guard figure 1: projected cache bytes per node at 10k. Flatness
        # vs the 500-node baseline is the O(fleet)-with-small-constant
        # claim; the ratio is what the slow test asserts on.
        "fleet_bytes_per_node": fleet_bpn,
        "baseline_bytes_per_node": base_bpn,
        "bytes_per_node_vs_baseline": (fleet_bpn / base_bpn
                                       if base_bpn else None),
        "fleet_full_bytes_per_node": fleet_full_bpn,
        "projection_savings_ratio": (1.0 - fleet_bpn / fleet_full_bpn
                                     if fleet_full_bpn else None),
        "relist_pages": relist_pages,
        "relist_s": relist_s,
        # guard figure 2: health-lane p99 queue time under bulk churn
        "fleet_p99_queue_ms": health_p99,
        "lane_p99_ms": lanes["p99_ms"],
        "lane_p99_ratio": (health_p99 / bulk_p99) if bulk_p99 else None,
        "lane_max_depth": lanes["max_depth"],
        "lane_served": lanes["served"],
        "max_rss_mb": rss_mb,
    }


def run_lineage_bench(items: int = 20000, rounds: int = 5) -> Dict:
    """Cost of the cause-stamping lineage plane on the workqueue hot
    path: enqueue+dequeue ``items`` keys per round, once with a
    :class:`~tpu_operator_torch.runtime.workqueue.Cause` stamped per add (and
    popped via ``get_with_info``) and once bare — ABBA-interleaved and
    paired per round, same discipline as the tracer-overhead scale test,
    so ambient machine drift cancels. The guard figure is the median
    paired overhead ratio: cause stamping must stay within a few percent
    of the bare path or the OPERATOR_TRACE kill switch stops being a
    choice at fleet scale."""
    import statistics

    from ..runtime.workqueue import Cause, WorkQueue

    cause = Cause(reason="watch:MODIFIED", origin="Node/bench", trace_id=7)

    def run_once(with_cause: bool) -> float:
        q = WorkQueue()
        batch = 64  # queue a small batch then drain: the real add/pop
        stamp = cause if with_cause else None  # mix, queue never balloons
        t0 = time.perf_counter()
        for base in range(0, items, batch):
            for i in range(base, min(base + batch, items)):
                q.add(i, cause=stamp)
            while True:
                item, _, _, _ = q.get_with_info(timeout=0)
                if item is None:
                    break
                q.done(item)
        dt = time.perf_counter() - t0
        q.shutdown()
        return dt

    run_once(True)
    run_once(False)  # warm-up both paths
    ratios, on_times, off_times = [], [], []
    for _ in range(rounds):
        a_on = run_once(True)       # ABBA: on/off/off/on per round
        a_off = run_once(False)
        b_off = run_once(False)
        b_on = run_once(True)
        on = (a_on + b_on) / 2.0
        off = (a_off + b_off) / 2.0
        on_times.append(on)
        off_times.append(off)
        ratios.append(on / off if off else 1.0)
    on_best, off_best = min(on_times), min(off_times)
    return {
        "items": items,
        "rounds": rounds,
        "cause_ns_per_op": on_best / items * 1e9,
        "bare_ns_per_op": off_best / items * 1e9,
        # the bench-guard figure: median paired causes-on/causes-off
        "lineage_overhead_ratio": statistics.median(ratios),
    }


def run_placement_bench(n_gpu: int = 500, n_requests: int = 2000,
                        lifetime: int = 300, seed: int = 0) -> Dict:
    """Stream n_requests SliceRequests through the placement engine
    against a mixed n_gpu-node fleet and measure per-decision latency
    plus steady-state fleet utilization.

    The stream models a churning training fleet: each request runs for
    ``lifetime`` decision slots and then releases its nodes, so the
    engine keeps placing into the holes earlier placements left behind —
    the regime where packing quality shows. The same seeded stream is
    replayed through the naive first-fit baseline, so the record carries
    the scored-vs-naive utilization gap alongside the latency numbers.
    Utilization is the mean over post-warmup decisions (the steady
    state), not the saturated end state, which any greedy engine
    reaches. It counts the cards the live requests asked for over the
    fleet's cards: a 4-card request leases an 8-card host whole, and
    counting the leased host's cards would score that waste as use (the
    reference's hosts all hold 4 chips and its requests are multiples of
    4, where the two counts agree)."""
    import random

    from ..api.slicerequest import SliceRequestSpec
    from ..topology.placement import FleetState, first_fit, place

    rng = random.Random(seed)
    sizes = (4, 4, 8, 8, 16, 32)
    specs = []
    for _ in range(n_requests):
        kw = {"chips": rng.choice(sizes)}
        r = rng.random()
        if r < 0.15:  # hard accelerator pins
            kw["accelerator"] = rng.choice(PINNED_PRODUCTS)
        elif r < 0.40:  # soft generation preferences
            kw["preferred_generations"] = rng.sample(
                list(PREFERRED_GENERATIONS), 2)
        specs.append(SliceRequestSpec(**kw))

    nodes = build_cluster(n_gpu).list("v1", "Node")

    def _drive(engine):
        fleet = FleetState(nodes)
        total = sum(b["free"] + b["placed"]
                    for b in fleet.chip_totals().values())
        live: Dict[int, tuple] = {}
        latencies, utils = [], []
        placed = unschedulable = asked = 0
        for i, spec in enumerate(specs):
            gone = i - lifetime
            if gone in live:
                gone_nodes, gone_chips = live.pop(gone)
                fleet.release(node_names=gone_nodes)
                asked -= gone_chips
            t0 = time.perf_counter()
            best = engine(spec, fleet)
            latencies.append(time.perf_counter() - t0)
            if best is None:
                unschedulable += 1
            else:
                fleet.book(best.nodes, f"bench/r{i}")
                live[i] = (best.nodes, spec.chips_needed())
                asked += spec.chips_needed()
                placed += 1
            if i >= lifetime:
                utils.append(asked / total if total else 0.0)
        latencies.sort()

        def pct(p):
            return latencies[min(len(latencies) - 1,
                                 int(p * len(latencies)))] * 1000.0

        return {
            "placed": placed,
            "unschedulable": unschedulable,
            "utilization": sum(utils) / len(utils) if utils else 0.0,
            "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
        }

    scored = _drive(place)
    naive = _drive(first_fit)
    return {
        "n_gpu_nodes": n_gpu,
        "n_requests": n_requests,
        "lifetime": lifetime,
        "placed": scored["placed"],
        "unschedulable": scored["unschedulable"],
        "placement_p50_ms": scored["p50_ms"],
        "placement_p95_ms": scored["p95_ms"],
        "placement_p99_ms": scored["p99_ms"],
        "fleet_utilization": scored["utilization"],
        "fleet_utilization_first_fit": naive["utilization"],
        "first_fit_placed": naive["placed"],
    }


def run_placement_fleet_bench(n_gpu: int = 10000, baseline_gpu: int = 500,
                              n_requests: int = 5000, lifetime: int = 300,
                              rescan_sample: int = 40,
                              seed: int = 0) -> Dict:
    """Placement at fleet scale: the incremental index vs the per-request
    rescan, and p99 flatness from ``baseline_gpu`` to ``n_gpu`` nodes.

    The same seeded request stream (same shape mix as
    ``run_placement_bench``: sizes, hard pins, soft preferences,
    lifetime-slot releases) is driven three ways:

    - **indexed @ baseline_gpu** — one long-lived ``FleetIndex``, per
      decision a ``best()`` heap peek; the 500-node p99 anchor. The
      anchor's lease lifetime is scaled by the fleet ratio (weak
      scaling) so both runs hold the same utilization fraction —
      otherwise the small fleet saturates and its p99 measures the
      cheap nothing-fits path instead of real decisions.
    - **indexed @ n_gpu** — the same, at fleet scale. The tentpole
      target is ``placement_fleet_p99_ms`` within 2x of the anchor:
      decision cost tracks *dirtied domains*, not fleet size.
    - **rescan @ n_gpu** — what the controller does under
      ``OPERATOR_PLACEMENT_INDEX=0``: a fresh ``FleetState(nodes)`` +
      full ``rank_candidates`` per request. Driven over a small sample
      (``rescan_sample``) because at 10k nodes it is the slow path by
      design; its throughput is extrapolated from that sample.

    Headline keys: ``placement_fleet_p99_ms`` (lower is better) and
    ``placement_storm_rps`` (higher is better)."""
    import random

    from ..api.slicerequest import SliceRequestSpec
    from ..topology.index import FleetIndex
    from ..topology.placement import FleetState, rank_candidates

    rng = random.Random(seed)
    sizes = (4, 4, 8, 8, 16, 32)
    specs = []
    for _ in range(n_requests):
        kw = {"chips": rng.choice(sizes)}
        r = rng.random()
        if r < 0.15:
            kw["accelerator"] = rng.choice(PINNED_PRODUCTS)
        elif r < 0.40:
            kw["preferred_generations"] = rng.sample(
                list(PREFERRED_GENERATIONS), 2)
        specs.append(SliceRequestSpec(**kw))

    def pct(lat, p):
        lat = sorted(lat)
        return lat[min(len(lat) - 1, int(p * len(lat)))] * 1000.0

    def drive_indexed(nodes, slots) -> Dict:
        index = FleetIndex(nodes)
        # steady-state warmup: a novel request *shape* pays one O(fleet)
        # fragment build on first sight, amortized over the shape's
        # lifetime in a long-lived controller index. Touch each distinct
        # shape once untimed so the measured distribution is the steady
        # state the controller actually runs in.
        seen = set()
        for spec in specs:
            sk = FleetIndex._spec_key(spec)
            if sk not in seen:
                seen.add(sk)
                index.best(spec)
        live: Dict[int, tuple] = {}
        lat = []
        placed = unschedulable = 0
        t_all = time.perf_counter()
        for i, spec in enumerate(specs):
            gone = i - slots
            if gone in live:
                index.release(node_names=live.pop(gone))
            t0 = time.perf_counter()
            best = index.best(spec)
            lat.append(time.perf_counter() - t0)
            if best is None:
                unschedulable += 1
            else:
                index.book(best.nodes, f"bench/r{i}")
                live[i] = best.nodes
                placed += 1
        wall = time.perf_counter() - t_all
        return {
            "placed": placed, "unschedulable": unschedulable,
            "p50_ms": pct(lat, 0.50), "p99_ms": pct(lat, 0.99),
            "rps": len(specs) / wall if wall > 0 else 0.0,
            "stats": index.index_stats(),
        }

    def drive_rescan(nodes) -> Dict:
        # the OPERATOR_PLACEMENT_INDEX=0 controller path per request:
        # rebuild the fleet view, replay the live leases (the annotation
        # ingest a real rebuild performs), full rank
        live: Dict[int, tuple] = {}
        lat = []
        t_all = time.perf_counter()
        n = min(rescan_sample, len(specs))
        for i, spec in enumerate(specs[:n]):
            gone = i - lifetime
            if gone in live:
                live.pop(gone)
            t0 = time.perf_counter()
            fleet = FleetState(nodes)
            for j, ns in live.items():
                fleet.book(ns, f"bench/r{j}")
            ranked = rank_candidates(spec, fleet)
            lat.append(time.perf_counter() - t0)
            if ranked:
                live[i] = ranked[0].nodes
        wall = time.perf_counter() - t_all
        return {
            "sample": n, "p99_ms": pct(lat, 0.99),
            "rps": n / wall if wall > 0 else 0.0,
        }

    base_nodes = build_cluster(baseline_gpu).list("v1", "Node")
    fleet_nodes = build_cluster(n_gpu).list("v1", "Node")
    # weak scaling: hold the live-lease fraction constant across fleet
    # sizes so the anchor p99 measures real decisions, not saturation
    anchor_slots = max(1, round(lifetime * baseline_gpu / n_gpu))
    anchor = drive_indexed(base_nodes, anchor_slots)
    indexed = drive_indexed(fleet_nodes, lifetime)
    rescan = drive_rescan(fleet_nodes)
    return {
        "n_gpu_nodes": n_gpu,
        "baseline_gpu_nodes": baseline_gpu,
        "n_requests": n_requests,
        "lifetime": lifetime,
        "indexed_placed": indexed["placed"],
        "indexed_unschedulable": indexed["unschedulable"],
        "placement_baseline_p99_ms": anchor["p99_ms"],
        "placement_fleet_p99_ms": indexed["p99_ms"],
        "p99_flatness_x": (indexed["p99_ms"] / anchor["p99_ms"]
                           if anchor["p99_ms"] > 0 else 0.0),
        "placement_storm_rps": indexed["rps"],
        "rescan_sample": rescan["sample"],
        "rescan_rps": rescan["rps"],
        "rescan_p99_ms": rescan["p99_ms"],
        "storm_speedup_x": (indexed["rps"] / rescan["rps"]
                            if rescan["rps"] > 0 else 0.0),
        "index_stats": indexed["stats"],
    }


def run_federation_bench(n_cells: int = 5, nodes_per_cell: int = 2000,
                         n_requests: int = 2000, lifetime: int = 200,
                         digest_refresh: int = 32,
                         seed: int = 0) -> Dict:
    """The federation tentpole's cost question: what does splitting one
    flat control plane into N digest-summarized cells do to global
    decision latency and placement quality?

    The same seeded request stream is driven two ways:

    - **flat** — one ``FleetIndex`` over every node
      (``n_cells * nodes_per_cell``), per decision a ``best()`` peek;
      the single-plane anchor.
    - **federated** — ``n_cells`` separate indexes, each distilled into
      a schema-stamped cell digest on a refresh cadence
      (``digest_refresh`` decisions, standing in for the publish
      interval); per request the :class:`GlobalRouter` scores the held
      digests (the GLOBAL decision — what's timed), then the chosen
      cell's own index does fine placement. The router books routed
      chips between publishes, exactly as in production, so stale
      digests can't stampede one cell.

    Headline keys: ``federation_route_p99_ms`` (lower is better; the
    reference's bar is 2x the flat anchor) and
    ``federation_quality_vs_flat`` (chips placed, federated / flat; the
    reference's floor 0.95). The request stream pins a ``gpu.product``
    of :data:`PINNED_PRODUCTS` where the reference pins a TPU
    accelerator, and prefers two of :data:`PREFERRED_GENERATIONS`, entry
    by entry (the same draws); a pinned request routes by its product's
    generation."""
    import random

    from ..api.slicerequest import SliceRequestSpec
    from ..federation.digest import cell_digest
    from ..federation.router import GlobalRouter, request_generation
    from ..topology.index import FleetIndex

    rng = random.Random(seed)
    sizes = (4, 4, 8, 8, 16, 32)
    cell_names = [f"cell-{i}" for i in range(n_cells)]
    specs = []
    for _ in range(n_requests):
        kw = {"chips": rng.choice(sizes)}
        r = rng.random()
        if r < 0.15:
            kw["accelerator"] = rng.choice(PINNED_PRODUCTS)
        elif r < 0.40:
            kw["preferred_generations"] = rng.sample(
                list(PREFERRED_GENERATIONS), 2)
        locality = (rng.choice(cell_names)
                    if rng.random() < 0.25 else None)
        specs.append((SliceRequestSpec(**kw), locality))

    def pct(lat, p):
        lat = sorted(lat)
        return lat[min(len(lat) - 1, int(p * len(lat)))] * 1000.0

    # -- flat anchor: one index over the whole fleet -----------------------
    flat_nodes = build_cluster(n_cells * nodes_per_cell).list("v1", "Node")
    flat = FleetIndex(flat_nodes)
    seen = set()
    for spec, _ in specs:
        sk = FleetIndex._spec_key(spec)
        if sk not in seen:
            seen.add(sk)
            flat.best(spec)
    live: Dict[int, tuple] = {}
    flat_lat = []
    flat_chips = 0
    for i, (spec, _) in enumerate(specs):
        gone = i - lifetime
        if gone in live:
            flat.release(node_names=live.pop(gone))
        t0 = time.perf_counter()
        best = flat.best(spec)
        flat_lat.append(time.perf_counter() - t0)
        if best is not None:
            flat.book(best.nodes, f"bench/r{i}")
            live[i] = best.nodes
            flat_chips += spec.chips_needed()

    # -- federated: N cell indexes under the router ------------------------
    indexes = {name: FleetIndex(
        build_cluster(nodes_per_cell).list("v1", "Node"))
        for name in cell_names}
    for name in cell_names:
        seen = set()
        for spec, _ in specs:
            sk = FleetIndex._spec_key(spec)
            if sk not in seen:
                seen.add(sk)
                indexes[name].best(spec)
    router = GlobalRouter(cell_names, now=lambda: 0.0)
    seqs = {name: 0 for name in cell_names}

    def publish():
        for name in cell_names:
            seqs[name] += 1
            router.observe_digest(cell_digest(
                indexes[name], name, seqs[name], 0.0))

    publish()
    fed_live: Dict[int, tuple] = {}
    route_lat = []
    fed_chips = 0
    unrouted = infeasible = 0
    for i, (spec, locality) in enumerate(specs):
        if i and i % digest_refresh == 0:
            publish()
        gone = i - lifetime
        if gone in fed_live:
            cell, nodes = fed_live.pop(gone)
            indexes[cell].release(node_names=nodes)
        generation = request_generation(spec.accelerator)
        t0 = time.perf_counter()
        decision = router.route(spec.chips_needed(),
                                generation=generation,
                                locality=locality)
        route_lat.append(time.perf_counter() - t0)
        if decision is None:
            unrouted += 1
            continue
        cell = decision["cell"]
        best = indexes[cell].best(spec)
        if best is None:
            infeasible += 1
            continue
        indexes[cell].book(best.nodes, f"bench/r{i}")
        fed_live[i] = (cell, best.nodes)
        fed_chips += spec.chips_needed()

    flat_p99 = pct(flat_lat, 0.99)
    route_p99 = pct(route_lat, 0.99)
    return {
        "n_cells": n_cells,
        "nodes_per_cell": nodes_per_cell,
        "n_requests": n_requests,
        "flat_placed_chips": flat_chips,
        "federated_placed_chips": fed_chips,
        "federated_unrouted": unrouted,
        "federated_infeasible": infeasible,
        "flat_p99_ms": flat_p99,
        "federation_route_p99_ms": route_p99,
        "route_vs_flat_x": (route_p99 / flat_p99
                            if flat_p99 > 0 else 0.0),
        "federation_quality_vs_flat": (fed_chips / flat_chips
                                       if flat_chips > 0 else 0.0),
    }


def run_migration_bench(n_gpu: int = 100, n_requests: int = 6,
                        pass_budget: int = 300, seed: int = 0,
                        include_resize: bool = True) -> Dict:
    """Workload recovery latency across a full driver rollout: the
    elastic migrate stage (checkpoint-ack-rebind ahead of the drain)
    vs the kill-and-reschedule baseline (migrate stage disabled, the
    job dies with the drain and waits out the unit's whole
    drain/restart/validate/uncordon cycle on its old nodes).

    Both modes run the SAME seeded request mix through the REAL
    controllers (placement + upgrade FSM + the ElasticWorkload shim) on
    a virtual clock, so a recovery span is deterministic virtual
    seconds, not wall noise. A span is a STALLED-TRAINING window,
    measured identically in both modes: it opens the first pass a
    workload makes no step progress and closes when it is past its
    pre-stall step again. Elastic's only stall is the reshard/restore
    pause after the rebind; the killed job is dark for its unit's whole
    cordon-to-uncordon cycle plus the re-warm back to its old step. The
    headline pair is ``slice_migration_p95_s`` vs
    ``kill_reschedule_p95_s``, plus the checkpointed steps each mode
    lost."""
    import random

    from ..api.slicerequest import (
        KIND_SLICE_REQUEST,
        MIG_ABORTED,
        V1ALPHA1,
        SliceRequestSpec,
        new_slice_request,
    )
    from ..chaos.faults import VirtualClock
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..controllers.placement_controller import PlacementReconciler
    from ..controllers.upgrade_controller import (
        STATE_DONE,
        UpgradeReconciler,
    )
    from ..runtime.objects import get_nested, labels_of, name_of, thaw_obj
    from ..workloads.elastic import ElasticWorkload

    ns = "gpu-operator"
    step_dt = 20.0

    def _mode(elastic: bool) -> Dict:
        clock = VirtualClock()
        c = build_cluster(n_gpu)
        c.create(new_cluster_policy(spec={"upgradePolicy": {
            "autoUpgrade": True, "maxParallelUpgrades": 8,
            "migrationTimeoutSeconds": 120 if elastic else 0}}))
        prec = ClusterPolicyReconciler(client=c, namespace=ns)
        urec = UpgradeReconciler(client=c, namespace=ns, now=clock)
        lrec = PlacementReconciler(client=c, namespace=ns, now=clock)
        req = Request(name="gpu-cluster-policy")
        rng = random.Random(seed)
        names = [f"mig-{i:03d}" for i in range(n_requests)]
        for nm in names:
            c.create(new_slice_request(
                nm, spec=SliceRequestSpec(
                    chips=rng.choice((4, 4, 8, 8))).to_obj(),
                namespace=ns))

        def place_all() -> None:
            for nm in names:
                lrec.reconcile(Request(name=nm, namespace=ns))

        prec.reconcile(req)
        c.simulate_kubelet(ready=True)
        prec.reconcile(req)
        place_all()
        shims = {nm: ElasticWorkload(c, nm, ns, clock=clock)
                 for nm in names}
        for _ in range(3):  # baseline training before the rollout
            for nm in names:
                shims[nm].tick()
            clock.advance(step_dt)

        cr = thaw_obj(c.get(V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy"))
        cr["spec"]["driver"] = {"installDir": "/srv/elastic-bench"}
        c.update(cr)
        prec.reconcile(req)

        spans: list = []
        stall: Dict[str, tuple] = {}
        high_step = {nm: shims[nm].step for nm in names}
        down: set = set()
        lost_steps = 0

        for _ in range(pass_budget):
            urec.reconcile(req)
            place_all()
            c.simulate_kubelet(ready=True)
            unsched = {name_of(n) for n in c.list("v1", "Node")
                       if get_nested(n, "spec", "unschedulable",
                                     default=False)}
            for nm in sorted(shims):
                live = c.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST, nm, ns)
                if live is None:
                    continue
                bound = get_nested(live, "status", "nodes",
                                   default=[]) or []
                blocked = False
                if not elastic:
                    # with the migrate stage disabled, the drain follows
                    # the cordon inside one FSM pass: the first cordoned
                    # bound node means the job is dead, and it stays
                    # dark until every bound node is schedulable again
                    if any(b in unsched for b in bound):
                        if nm not in down:
                            wl = shims[nm]
                            lost_steps += wl.step - (
                                wl.store.latest_step() or 0)
                            wl.crash(partial=False)
                            down.add(nm)
                        blocked = True
                    else:
                        down.discard(nm)
                if not blocked:
                    shims[nm].tick()
                step_now = shims[nm].step
                if nm in stall:
                    if step_now > stall[nm][1]:
                        spans.append(clock.t - stall[nm][0])
                        del stall[nm]
                elif step_now <= high_step[nm]:
                    stall[nm] = (clock.t, high_step[nm])
                high_step[nm] = max(high_step[nm], step_now)
            urec.reconcile(req)
            place_all()
            clock.advance(step_dt)
            gpu_nodes = [n for n in c.list("v1", "Node")
                         if labels_of(n).get(L.GKE_ACCELERATOR)]
            if all(labels_of(n).get(L.UPGRADE_STATE) == STATE_DONE
                   for n in gpu_nodes) and not stall and not down:
                break

        moves = aborted = 0
        for nm in names:
            live = c.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST, nm, ns)
            if live is None:
                continue
            moves += int(get_nested(live, "status", "migrations",
                                    default=0) or 0)
            if (get_nested(live, "status", "migration", "phase")
                    or "") == MIG_ABORTED:
                aborted += 1
        spans.sort()

        def pct(p: float) -> float:
            if not spans:
                return 0.0
            return spans[min(len(spans) - 1, int(p * len(spans)))]

        return {"spans": len(spans), "p50_s": pct(0.50),
                "p95_s": pct(0.95), "lost_steps": lost_steps,
                "moves": moves, "aborted": aborted, "virtual_s": clock.t}

    el = _mode(elastic=True)
    kl = _mode(elastic=False)
    out = {
        "n_gpu_nodes": n_gpu,
        "n_requests": n_requests,
        "migrations": el["moves"],
        "migrations_aborted": el["aborted"],
        "migration_stalls": el["spans"],
        "kills": kl["spans"],
        "slice_migration_p50_s": el["p50_s"],
        "slice_migration_p95_s": el["p95_s"],
        "kill_reschedule_p50_s": kl["p50_s"],
        "kill_reschedule_p95_s": kl["p95_s"],
        "elastic_lost_steps": el["lost_steps"],
        "kill_lost_steps": kl["lost_steps"],
        "speedup_p95": (kl["p95_s"] / el["p95_s"]
                        if el["p95_s"] else 0.0),
    }
    if include_resize:
        out.update(run_resize_bench(n_gpu=n_gpu, n_requests=n_requests,
                                    seed=seed))
    return out


def run_resize_bench(n_gpu: int = 60, n_requests: int = 6,
                     pass_budget: int = 200, seed: int = 0) -> Dict:
    """Same-NVLink-domain resize latency and byte bill: the direct shard
    handoff (sharded checkpoints — only shards changing owner move,
    surviving hosts keep theirs in place) vs the SAME seeded resizes
    forced down the full-checkpoint path (``OPERATOR_SHARDED_CKPT=0``
    semantics, every byte re-fetched on the new binding).

    Both modes run the REAL placement controller's shrink/grow
    handshake and the ElasticWorkload shim on a virtual clock; the
    restore pause is bandwidth-modeled (``state_bytes`` fetched at
    ``restore_bandwidth`` per tick), so a stalled-training span is
    deterministic virtual seconds and the bytes-moved figures are
    exact. The headline pair is ``resize_p95_s`` (fast path) vs
    ``resize_full_p95_s``, plus ``reshard_bytes_ratio`` = bytes the
    handoff moved / bytes the full path re-fetched."""
    from ..api.slicerequest import (
        KIND_SLICE_REQUEST,
        MIG_TERMINAL,
        V1ALPHA1,
        SliceRequestSpec,
        new_slice_request,
    )
    from ..chaos.faults import VirtualClock
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..controllers.placement_controller import PlacementReconciler
    from ..runtime.objects import get_nested, thaw_obj
    from ..workloads.elastic import SHARDED_CKPT_GATE, ElasticWorkload

    ns = "gpu-operator"
    step_dt = 5.0
    state_bytes = 256 << 20   # one job's checkpoint footprint
    bandwidth = 64 << 20      # restore fetch per training tick

    def _mode(fast: bool) -> Dict:
        prev = SHARDED_CKPT_GATE.enabled
        SHARDED_CKPT_GATE.enabled = fast
        try:
            clock = VirtualClock()
            c = build_cluster(n_gpu)
            c.create(new_cluster_policy(spec={}))
            prec = ClusterPolicyReconciler(client=c, namespace=ns)
            lrec = PlacementReconciler(client=c, namespace=ns, now=clock)
            req = Request(name="gpu-cluster-policy")
            names = [f"rsz-{i:03d}" for i in range(n_requests)]
            for nm in names:
                c.create(new_slice_request(
                    nm, spec=SliceRequestSpec(chips=8).to_obj(),
                    namespace=ns))

            def place_all() -> None:
                for nm in names:
                    lrec.reconcile(Request(name=nm, namespace=ns))

            prec.reconcile(req)
            c.simulate_kubelet(ready=True)
            prec.reconcile(req)
            place_all()
            shims = {nm: ElasticWorkload(c, nm, ns, clock=clock,
                                         state_bytes=state_bytes,
                                         restore_bandwidth=bandwidth)
                     for nm in names}
            for _ in range(3):  # steady training before the resize
                for nm in names:
                    shims[nm].tick()
                clock.advance(step_dt)
            # a same-domain shrink on every job (8 -> 4 cards) — the arc
            # the fast path exists for; cross-domain arcs always ride the
            # full path anyway
            for nm in sorted(names):
                live = c.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST, nm, ns)
                if live is None:
                    continue
                cr = thaw_obj(live)
                cr["spec"]["chips"] = 4
                c.update(cr)

            spans: list = []
            stall: Dict[str, tuple] = {}
            high = {nm: shims[nm].step for nm in names}
            for _ in range(pass_budget):
                place_all()
                for nm in sorted(shims):
                    shims[nm].tick()
                    step_now = shims[nm].step
                    if nm in stall:
                        if step_now > stall[nm][1]:
                            spans.append(clock.t - stall[nm][0])
                            del stall[nm]
                    elif step_now <= high[nm]:
                        stall[nm] = (clock.t, high[nm])
                    high[nm] = max(high[nm], step_now)
                clock.advance(step_dt)
                settled = not stall
                for nm in names:
                    live = c.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST,
                                         nm, ns)
                    mig = (get_nested(live, "status", "migration",
                                      default={}) or {}) if live else {}
                    if (mig.get("phase") or "") not in MIG_TERMINAL:
                        settled = False
                if settled:
                    break

            bytes_moved = resharded = fallbacks = resized = 0
            for nm in names:
                live = c.get_or_none(V1ALPHA1, KIND_SLICE_REQUEST, nm, ns)
                if live is None:
                    continue
                if not int(get_nested(live, "status", "migrations",
                                      default=0) or 0):
                    continue
                resized += 1
                mig = get_nested(live, "status", "migration",
                                 default={}) or {}
                if mig.get("path") == "sharded-handoff":
                    resharded += 1
                    bytes_moved += int(mig.get("bytesMoved") or 0)
                else:
                    # full path: the restore re-fetches the whole blob
                    fallbacks += 1
                    bytes_moved += state_bytes
            spans.sort()

            def pct(p: float) -> float:
                if not spans:
                    return 0.0
                return spans[min(len(spans) - 1, int(p * len(spans)))]

            return {"spans": len(spans), "p50_s": pct(0.50),
                    "p95_s": pct(0.95), "bytes_moved": bytes_moved,
                    "resharded": resharded, "fallbacks": fallbacks,
                    "resized": resized}
        finally:
            SHARDED_CKPT_GATE.enabled = prev

    fastd = _mode(fast=True)
    fulld = _mode(fast=False)
    return {
        "resizes": fastd["resized"],
        "resize_stalls": fastd["spans"],
        "resize_p50_s": fastd["p50_s"],
        "resize_p95_s": fastd["p95_s"],
        "resize_full_p50_s": fulld["p50_s"],
        "resize_full_p95_s": fulld["p95_s"],
        "resize_speedup_p95": (fulld["p95_s"] / fastd["p95_s"]
                               if fastd["p95_s"] else 0.0),
        "resharded": fastd["resharded"],
        "reshard_fallbacks": fastd["fallbacks"],
        "reshard_bytes_moved": fastd["bytes_moved"],
        "reshard_bytes_full": fulld["bytes_moved"],
        "reshard_bytes_ratio": (fastd["bytes_moved"]
                                / fulld["bytes_moved"]
                                if fulld["bytes_moved"] else 0.0),
    }


class _WireClient:
    """Bench-only wire-fidelity shim over the in-memory fake: every
    object crossing ``list()`` or ``watch()`` is JSON round-tripped,
    charging the serialize+parse cost a real apiserver connection
    charges per object read. The fake's zero-copy reads otherwise make
    a cold relist unrealistically free — while the warm path's whole
    point is that it parses one snapshot file instead of re-reading the
    fleet per kind, and its ``since_rv`` resume pays the round-trip
    only on the downtime delta. Writes pass through unwired (both
    restart paths issue the same writes)."""

    def __init__(self, inner):
        self.inner = inner

    @staticmethod
    def _wire(obj):
        import json

        return json.loads(json.dumps(obj, separators=(",", ":")))

    def list(self, api_version, kind, opts=None):
        from ..runtime.client import PagedList

        out = self.inner.list(api_version, kind, opts)
        wired = [self._wire(o) for o in out]
        cont = getattr(out, "continue_", None)
        if cont is not None:
            paged = PagedList(wired)
            paged.continue_ = cont
            return paged
        return wired

    def watch(self, api_version, kind, handler, since_rv=None):
        from ..runtime.client import WatchEvent

        def wire_handler(event):
            handler(WatchEvent(event.type, self._wire(event.obj)))

        if since_rv is None:
            return self.inner.watch(api_version, kind, wire_handler)
        return self.inner.watch(api_version, kind, wire_handler,
                                since_rv=since_rv)

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


def run_restart_bench(n_gpu: int = 10000, delta_nodes: int = 100,
                      seed: int = 0,
                      snapshot_dir: Optional[str] = None) -> Dict:
    """Restart-to-first-placement-decision at fleet scale: cold (full
    paged LIST of a fattened fleet, projection + freeze + byte-measure
    per object, from-scratch ``FleetIndex``) vs warm (load the newest
    durable snapshot from disk, seed the cache stores pre-watch, let the
    subscribe-time replay short-circuit on resourceVersion for every
    unchanged object, rebuild the index from the snapshot's already
    projected node set, and ``resync()`` only the downtime delta).

    The downtime delta is ``delta_nodes`` label-touched Nodes (new RVs
    the replay cannot skip) applied after the snapshot is written and
    the old cache is closed — the O(delta) the warm path actually pays.

    Headline keys: ``restart_to_first_decision_cold_s`` and
    ``restart_to_first_decision_warm_s``."""
    import os
    import random
    import shutil
    import tempfile

    from ..api.slicerequest import SliceRequestSpec
    from ..controllers.clusterpolicy_controller import ClusterPolicyReconciler
    from ..runtime import CachedClient
    from ..runtime.objects import name_of, thaw_obj
    from ..runtime.snapshot import (capture, load_latest, restore,
                                    restore_index, write_snapshot)
    from ..topology.index import FleetIndex

    rng = random.Random(seed)
    c = build_cluster(n_gpu)
    fatten_nodes(c)
    c.create(new_cluster_policy())
    rec = ClusterPolicyReconciler(client=c, namespace="gpu-operator")
    req = Request(name="gpu-cluster-policy")
    rec.reconcile(req)
    c.simulate_kubelet(ready=True)
    rec.reconcile(req)

    # the running operator whose crash we simulate: warm cache over every
    # operand kind, a live index that has paid its fragment builds
    cached = CachedClient(c)
    crec = ClusterPolicyReconciler(client=cached, namespace="gpu-operator")
    crec.reconcile(req)
    index = FleetIndex(cached.list("v1", "Node"))
    spec = SliceRequestSpec(chips=8)
    index.best(spec)

    owns_dir = snapshot_dir is None
    directory = snapshot_dir or tempfile.mkdtemp(prefix="gpuop-bench-snap-")
    try:
        t0 = time.perf_counter()
        path = write_snapshot(directory, capture(cached, index=index))
        snapshot_write_s = time.perf_counter() - t0
        snapshot_bytes = os.path.getsize(path)
        cached.close()  # the operator goes down

        # downtime churn: label touches bump RVs without moving topology,
        # so the index folds them as cheap fingerprint-equal MODIFIEDs —
        # but the cache replay must still re-ingest every one
        names = [name_of(n) for n in c.list("v1", "Node")]
        for i, name in enumerate(rng.sample(names,
                                            min(delta_nodes, len(names)))):
            node = thaw_obj(c.get("v1", "Node", name))
            labels = node.setdefault("metadata", {}).setdefault("labels", {})
            labels["bench.gpu-operator/restart-touch"] = str(i)
            c.update(node)

        # both restarts warm the full cache (every kind the controllers
        # read — a restarting operator's first pass) before the first
        # placement decision; only the route to "warm stores" differs.
        # Both run over the wire shim: cold re-reads the fleet per kind,
        # warm parses the snapshot once and resumes each watch from the
        # snapshot RV, paying the wire only for the downtime delta.
        # A gc fence before each timed block keeps one path's garbage
        # out of the other path's wall clock.
        import gc

        wire = _WireClient(c)
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            cold = CachedClient(wire)
            ClusterPolicyReconciler(
                client=cold, namespace="gpu-operator").reconcile(req)
            cold_index = FleetIndex(cold.list("v1", "Node"))
            cold_best = cold_index.best(spec)
            cold_s = time.perf_counter() - t0
        finally:
            gc.enable()
        cold.close()
        del cold, cold_index
        gc.collect()

        gc.disable()
        try:
            t0 = time.perf_counter()
            snap = load_latest(directory)
            warm = CachedClient(wire)
            restored = restore(warm, snap)
            ClusterPolicyReconciler(
                client=warm, namespace="gpu-operator").reconcile(req)
            warm_index = restore_index(snap)
            warm_index.resync(warm.list("v1", "Node"))
            warm_best = warm_index.best(spec)
            warm_s = time.perf_counter() - t0
        finally:
            gc.enable()
        warm_resumes = warm.watch_resumes
        warm.close()
    finally:
        if owns_dir:
            shutil.rmtree(directory, ignore_errors=True)

    return {
        "n_gpu_nodes": n_gpu,
        "delta_nodes": min(delta_nodes, len(names)),
        "snapshot_bytes": snapshot_bytes,
        "snapshot_write_s": snapshot_write_s,
        "restored_objects": restored["objects"],
        "restored_kinds": restored["kinds"],
        "watch_resumes": warm_resumes,
        "decisions_agree": (cold_best is None) == (warm_best is None),
        # guard figures: wall time from process start to the first
        # index.best() answer, cold vs snapshot-warm
        "restart_to_first_decision_cold_s": cold_s,
        "restart_to_first_decision_warm_s": warm_s,
        "warm_over_cold": (warm_s / cold_s) if cold_s > 0 else None,
    }


def run_telemetry_bench(n_gpu: int = 800, rounds: int = 5,
                        flat_baseline: int = 500,
                        flat_fleet: int = 10000) -> Dict:
    """Cost and scaling of the fleet telemetry plane, three claims:

    - **ingest overhead**: a full fleet of digest publishes (one
      annotation write per GPU node, through the watch-fed cache) with
      the :class:`~tpu_operator_torch.metrics.fleet.FleetTelemetry` fold
      attached vs detached — ABBA-interleaved and paired per round like
      the lineage bench, so machine drift cancels. The guard figure is
      ``telemetry_overhead_ratio`` (paired median); the design bar is
      <1.05x: the fold is O(delta) and the O(fleet) gauge rollup is
      cadence-bounded, so attaching telemetry must be nearly free.
    - **digest flatness**: digest wire bytes per node at ``flat_fleet``
      nodes vs the ``flat_baseline`` fleet — the digest describes one
      node's chips, so its size must not grow with fleet size; the
      rollup payload grows O(domains), not O(nodes).
    - **goodput SLO**: a seeded degraded-chip fleet driven through the
      production goodput classifier must breach the slice-goodput SLO
      exactly as designed — the burn-rate math, not an eyeball.
    """
    import json
    import statistics

    from ..metrics.fleet import (
        FleetTelemetry,
        ideal_steps_per_s,
        rollup_nodes,
    )
    from ..metrics.health_engine import (
        DIGEST_SCHEMA_VERSION,
        digest_annotation,
    )
    from ..metrics.slo import burn_verdict
    from ..runtime import CachedClient
    from ..runtime.objects import labels_of, name_of, thaw_obj

    def _digest_for(node: dict, seq: int) -> str:
        nl = labels_of(node)
        gen = L.accelerator_generation(nl.get(L.GKE_ACCELERATOR, "")) or ""
        try:
            chips = int(nl.get(L.GKE_ACCELERATOR_COUNT) or "4")
        except ValueError:
            chips = 4
        return digest_annotation({
            "v": DIGEST_SCHEMA_VERSION, "status": "ok",
            "grades": {f"gpu{i}": "ok" for i in range(chips)},
            "duty_pct": 90.0 + (seq % 10), "hbm_free_frac": 0.35,
            "temp_max_c": 55.0 + (seq % 5), "gen": gen,
            "seq": seq})

    # -- ingest overhead: fleet-wide publish storm, fold on vs off ------
    c = build_cluster(n_gpu)
    cached = CachedClient(c)
    cached.list("v1", "Node")  # informer subscribes + fills
    gpu_names = sorted(name_of(n) for n in c.list("v1", "Node")
                       if L.is_gpu_node(n))
    seq_box = [0]

    def publish_all() -> float:
        """One digest publish per GPU node — identical writes whether
        the fold is attached or not; the only variable is the listener."""
        seq_box[0] += 1
        seq = seq_box[0]
        t0 = time.perf_counter()
        for nm in gpu_names:
            node = thaw_obj(c.get("v1", "Node", nm))
            node.setdefault("metadata", {}).setdefault(
                "annotations", {})[L.HEALTH_DIGEST] = _digest_for(node,
                                                                  seq)
            c.update(node)
        return time.perf_counter() - t0

    tel = FleetTelemetry(now=time.monotonic)

    def run_once(attached: bool) -> float:
        if attached:
            tel.attach(cached)
        try:
            return publish_all()
        finally:
            if attached:
                tel.detach()

    run_once(True)
    run_once(False)  # warm-up both paths
    ratios, on_times, off_times = [], [], []
    for _ in range(rounds):
        a_on = run_once(True)       # ABBA: on/off/off/on per round
        a_off = run_once(False)
        b_off = run_once(False)
        b_on = run_once(True)
        on = (a_on + b_on) / 2.0
        off = (a_off + b_off) / 2.0
        on_times.append(on)
        off_times.append(off)
        ratios.append(on / off if off else 1.0)
    cached.close()
    on_best, off_best = min(on_times), min(off_times)

    # -- digest bytes per node: flat as the fleet grows 20x -------------
    def digest_footprint(n: int) -> Dict:
        cl = build_cluster(n)
        sized = []
        for node in cl.list("v1", "Node"):
            if not L.is_gpu_node(node):
                continue
            node = thaw_obj(node)
            node.setdefault("metadata", {}).setdefault(
                "annotations", {})[L.HEALTH_DIGEST] = _digest_for(node, 1)
            sized.append(node)
        bytes_total = sum(
            len((node["metadata"]["annotations"][L.HEALTH_DIGEST])
                .encode("utf-8")) for node in sized)
        roll = rollup_nodes(sized)
        return {"nodes": len(sized),
                "digest_bytes_per_node": bytes_total / len(sized),
                "rollup_bytes": len(json.dumps(
                    roll, sort_keys=True).encode("utf-8")),
                "domains": len(roll["domains"])}

    base_fp = digest_footprint(flat_baseline)
    fleet_fp = digest_footprint(flat_fleet)

    # -- goodput SLO breach, exactly as designed ------------------------
    # ten GB200 slices (the reference's v5p multi-host pool) over 600
    # virtual seconds in 30s observations; the six striped across the
    # degraded card's NVLink domain checkpoint at 0.04 steps/s vs the
    # 0.15 generation ideal (ratio 0.27, degraded),
    # the other four run at the bar. The production classifier turns
    # that into good/degraded step counts; the burn-rate verdict over
    # the slice-goodput objective (0.90) must breach.
    steps = {"good": 0, "degraded": 0}

    class _Handle:
        def __init__(self, quality):
            self.quality = quality

        def inc(self, n=1):
            if self.quality is not None:
                steps[self.quality] = steps.get(self.quality, 0) + n

        def set(self, v):
            pass

    class _Family:
        def labels(self, **kw):
            return _Handle(kw.get("quality"))

    class _Metrics:
        def __getattr__(self, attr):
            return _Family()

    t_box = [0.0]
    classifier = FleetTelemetry(metrics=_Metrics(), now=lambda: t_box[0])
    acked = [0.0] * 10
    for _tick in range(20):
        t_box[0] += 30.0
        for i in range(10):
            acked[i] += (0.04 if i < 6 else 0.15) * 30.0
            classifier.on_request_delta("MODIFIED", {
                "metadata": {"name": f"slice-{i:02d}",
                             "namespace": "bench"},
                "status": {"pool": "nvidia-gb200-mnnvl-4",
                           "progress": {"checkpointedStep": int(acked[i])}},
            })
    slo = burn_verdict(good=steps["good"], bad=steps["degraded"],
                       objective=0.90, threshold=2.0)

    return {
        "n_gpu_nodes": n_gpu,
        "rounds": rounds,
        "publishes_per_round": len(gpu_names),
        "ingest_on_s": on_best,
        "ingest_off_s": off_best,
        "ingest_us_per_publish": (on_best / len(gpu_names) * 1e6
                                  if gpu_names else None),
        # the bench-guard figure: median paired fold-on/fold-off ratio
        "telemetry_overhead_ratio": statistics.median(ratios),
        "digest_bytes_per_node": fleet_fp["digest_bytes_per_node"],
        "baseline_digest_bytes_per_node": base_fp["digest_bytes_per_node"],
        "digest_bytes_vs_baseline": (
            fleet_fp["digest_bytes_per_node"]
            / base_fp["digest_bytes_per_node"]
            if base_fp["digest_bytes_per_node"] else None),
        "rollup_bytes": {"baseline": base_fp["rollup_bytes"],
                         "fleet": fleet_fp["rollup_bytes"]},
        "rollup_domains": {"baseline": base_fp["domains"],
                           "fleet": fleet_fp["domains"]},
        "goodput_slo": {
            "objective": 0.90,
            "threshold": 2.0,
            "good_steps": steps["good"],
            "degraded_steps": steps["degraded"],
            "error_rate": slo["error_rate"],
            "burn_rate": slo["burn_rate"],
            "breached": slo["breached"],
        },
    }


def run_fairness_bench(n_gpu: int = 300, n_requests: Optional[int] = None,
                       wave: int = 40, lifetime_waves: int = 4,
                       seed: int = 0,
                       policy: str = "finish-time") -> Dict:
    """Fair-share admission at saturation: Jain's index and drain
    throughput for the quota-ordered gang pass vs the priority baseline.

    A three-class tenant mix (prod w6 with a min-guarantee, batch w3,
    research w1 with a cap) floods a mixed fleet with ~3x oversubscribed
    demand in waves; batch sets the highest numeric priority, so the
    legacy priority/age order lets it monopolize the fleet. Each wave
    replays the controller's admission pipeline — baseline sort, then
    ``order_batch`` under ``policy`` — and placed slices release after
    ``lifetime_waves`` waves, so classes compete for the holes forever.

    Fairness is Jain's index over per-class attained-over-entitled
    service (usage / water-filled share, sampled each post-warmup wave):
    1.0 means every class sits exactly at its share. The same seeded
    stream re-runs under the ``priority`` kill switch for the contrast
    figures; ``saturation_drain_rps`` is placement decisions per wall
    second while draining, the throughput cost of fairness."""
    import random

    from ..api.slicerequest import V1ALPHA1 as SR_API
    from ..api.slicerequest import SliceRequestSpec
    from ..scheduling.quota import (POLICY_BASELINE, QuotaTree,
                                    _capacity_chips, baseline_key,
                                    order_batch)
    from ..topology.placement import FleetState, place

    if n_requests is None:
        # hold the oversubscription ratio constant across fleet sizes so
        # a small-fleet run (GPUOP_BENCH_FAIRNESS_NODES) measures the
        # same contention regime as the 300-node default
        n_requests = 4 * n_gpu
    nodes = build_cluster(n_gpu).list("v1", "Node")
    capacity = _capacity_chips(nodes)
    tree = QuotaTree.from_config({"classes": [
        {"name": "prod", "weight": 6.0, "minChips": max(4, capacity // 5),
         "starvationBoundSeconds": 240},
        {"name": "batch", "weight": 3.0, "preemptTokens": 16},
        {"name": "research", "weight": 1.0,
         "maxChips": max(16, capacity // 3), "preemptTokens": 16},
    ]})

    # the seeded tenant stream: batch-heavy, batch loudest (priority 2)
    rng = random.Random(seed)
    sizes = (4, 4, 8, 8, 16)
    mix = (("batch", 2, 0.50), ("research", 1, 0.30), ("prod", 0, 0.20))
    stream = []
    for i in range(n_requests):
        r, acc = rng.random(), 0.0
        for cls, prio, share in mix:
            acc += share
            if r < acc:
                break
        chips = rng.choice(sizes)
        cr = {
            "apiVersion": SR_API,
            "kind": "SliceRequest",
            "metadata": {
                "name": f"fair-{i:05d}", "namespace": "bench",
                "annotations": {L.QUOTA_CLASS: cls},
                "creationTimestamp": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(1_700_000_000 + i)),
            },
            "spec": {"chips": chips, "priority": prio},
        }
        stream.append((f"bench/fair-{i:05d}", cr,
                       SliceRequestSpec.from_obj(cr)))

    n_waves = -(-n_requests // wave) + lifetime_waves + 8

    def _drive(pol):
        fleet = FleetState(nodes)
        usage: Dict[str, int] = {}
        backlog: list = []
        live: Dict[int, list] = {}
        samples: Dict[str, list] = {}
        placed = 0
        feed = iter(stream)
        t0 = time.perf_counter()
        for w in range(n_waves):
            for nodes_used, cls, chips in live.pop(w - lifetime_waves, []):
                fleet.release(node_names=nodes_used)
                usage[cls] = usage.get(cls, 0) - chips
            for _ in range(wave):
                nxt = next(feed, None)
                if nxt is not None:
                    key, cr, spec = nxt
                    backlog.append((key, cr, None, spec))
            backlog.sort(key=lambda it: baseline_key(it[0], it[1], it[3]))
            ordered = order_batch(backlog, pol, tree, usage=dict(usage))
            backlog = []
            for item in ordered:
                key, cr, _live, spec = item
                best = place(spec, fleet)
                if best is None:
                    backlog.append(item)
                    continue
                fleet.book(best.nodes, key)
                cls = tree.class_of(cr)
                usage[cls] = usage.get(cls, 0) + spec.chips_needed()
                live.setdefault(w, []).append(
                    (best.nodes, cls, spec.chips_needed()))
                placed += 1
            if w < lifetime_waves:
                continue
            demand = dict(usage)
            for key, cr, _live, spec in backlog:
                cls = tree.class_of(cr)
                demand[cls] = demand.get(cls, 0) + spec.chips_needed()
            shares = tree.shares(capacity, demand)
            for cls, share in shares.items():
                if share > 0 and demand.get(cls, 0) > 0:
                    samples.setdefault(cls, []).append(
                        usage.get(cls, 0) / share)
        wall = time.perf_counter() - t0
        attained = {cls: sum(v) / len(v) for cls, v in samples.items() if v}
        xs = list(attained.values())
        jain = (sum(xs) ** 2 / (len(xs) * sum(x * x for x in xs))
                if xs and any(xs) else 0.0)
        return {
            "jain_index": jain,
            "attained_over_share": {k: round(v, 4)
                                    for k, v in sorted(attained.items())},
            "placed": placed,
            "backlog_left": len(backlog),
            "drain_rps": placed / wall if wall > 0 else 0.0,
            "utilization": fleet.utilization(),
        }

    fair = _drive(policy)
    base = _drive(POLICY_BASELINE)
    return {
        "n_gpu_nodes": n_gpu,
        "n_requests": n_requests,
        "capacity_chips": capacity,
        "policy": policy,
        "fairness_jain_index": fair["jain_index"],
        "fairness_jain_baseline": base["jain_index"],
        "saturation_drain_rps": fair["drain_rps"],
        "drain_rps_baseline": base["drain_rps"],
        "placed": fair["placed"],
        "placed_baseline": base["placed"],
        "throughput_vs_baseline": (fair["placed"] / base["placed"]
                                   if base["placed"] else None),
        "attained_over_share": fair["attained_over_share"],
        "attained_over_share_baseline": base["attained_over_share"],
    }

"""Operator-level Prometheus metrics.

The port's counterpart of ``tpu_operator/metrics/operator_metrics.py``:
the same series, types and label names under the naming rule
(``tpu_operator_*`` -> ``gpu_operator_*``, ``tpu_nodes`` -> ``gpu_nodes``,
``tpu_chips`` -> ``gpu_chips``; TPU -> GPU in the help text).
"""

from __future__ import annotations

from prometheus_client import Counter, Gauge, Histogram

from .registry import REGISTRY

# control-plane latency buckets: reconciles on a warm informer cache sit
# in the sub-ms range, full apply passes in the tens of ms, and a live
# apiserver round-trip or drain wait stretches into seconds
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class OperatorMetrics:
    def __init__(self, registry=REGISTRY):
        g = lambda name, doc, **kw: Gauge(name, doc, registry=registry, **kw)
        c = lambda name, doc, **kw: Counter(name, doc, registry=registry, **kw)
        h = lambda name, doc, **kw: Histogram(
            name, doc, registry=registry, buckets=LATENCY_BUCKETS, **kw)
        self.reconcile_total = c(
            "gpu_operator_reconciliation_total",
            "Total GPUClusterPolicy reconciliations")
        self.reconcile_failures = c(
            "gpu_operator_reconciliation_failed_total",
            "Reconciliations that ended in error")
        self.reconcile_status = g(
            "gpu_operator_reconciliation_status",
            "1 when the last reconciliation reached all-ready")
        self.gpu_nodes = g(
            "gpu_operator_gpu_nodes_total",
            "Nodes detected as GPU nodes")
        self.operand_ready = g(
            "gpu_operator_operand_ready",
            "Per-state readiness (1 ready / 0 not)", labelnames=("state",))
        self.driver_upgrades_in_progress = g(
            "gpu_operator_driver_upgrades_in_progress",
            "Nodes currently upgrading the driver")
        self.driver_upgrades_done = c(
            "gpu_operator_driver_upgrades_done_total",
            "Completed per-node the driver upgrades")
        self.driver_upgrades_failed = c(
            "gpu_operator_driver_upgrades_failed_total",
            "Failed per-node the driver upgrades")
        self.driver_upgrades_pending = g(
            "gpu_operator_driver_upgrades_pending",
            "Nodes waiting for the driver upgrade")
        # remaining series of the reference's 17-gauge set that carry over
        # (operator_metrics.go:29-201; the DTK/OpenShift ones are dropped)
        self.reconcile_last_success = g(
            "gpu_operator_reconciliation_last_success_timestamp_seconds",
            "Unix time of the last all-ready reconciliation")
        self.policy_state = g(
            "gpu_operator_cluster_policy_state",
            "Coarse CR state (0 ready / 1 notReady / 2 ignored / 3 disabled)",
            labelnames=("policy",))
        self.operand_sync_duration = g(
            "gpu_operator_operand_sync_duration_seconds",
            "Wall time of the last sync per state", labelnames=("state",))
        self.gpu_chips_cluster_total = g(
            "gpu_operator_gpu_chips_total",
            "GPU cards across all discovered GPU nodes")
        self.node_pools = g(
            "gpu_operator_node_pools_total",
            "Distinct (generation x topology) GPU node pools")
        self.upgrade_state_nodes = g(
            "gpu_operator_upgrade_state_nodes",
            "Nodes per upgrade FSM state", labelnames=("state",))
        self.upgrade_units_in_progress = g(
            "gpu_operator_upgrade_units_in_progress",
            "Upgrade units (multi-host slices count once) currently "
            "moving through the FSM")
        self.reconcile_duration = g(
            "gpu_operator_reconciliation_duration_seconds",
            "Wall time of the last full GPUClusterPolicy reconciliation")
        # beyond the reference's 17: BASELINE target #1 (<5min install->
        # all-operands-Ready, tests/e2e/gpu_operator_test.go:83-88) is a
        # budget the reference never measures; this gauge records it
        self.install_to_ready = g(
            "gpu_operator_install_to_ready_seconds",
            "Wall time from first observation of a GPUClusterPolicy to "
            "its first all-operands-ready", labelnames=("policy",))
        # slice-level face of status.slices[]: alert when a multi-host
        # slice loses a host's validation without digging through the CR
        self.slices_total = g(
            "gpu_operator_slices_total",
            "Multi-host GPU slices discovered (status.slices[] rows)")
        self.slices_validated = g(
            "gpu_operator_slices_validated",
            "Multi-host slices whose every host passed validation")
        # chaos plane (chaos/): injected faults and caught invariant
        # violations are first-class observables, so a chaos run against
        # a live control plane shows up on the same /metrics the
        # operator always serves — not only in the runner's JSON verdict
        self.chaos_faults_injected = c(
            "gpu_operator_chaos_faults_injected_total",
            "Faults injected by the chaos plane", labelnames=("kind",))
        self.chaos_invariant_violations = c(
            "gpu_operator_chaos_invariant_violations_total",
            "Cluster invariant violations caught by the chaos checker",
            labelnames=("invariant",))
        # concurrent-reconcile observability (runtime/manager.py workers=N
        # + runtime/workqueue.py): queue depth and latency per controller,
        # and per-controller reconcile wall time (the existing unlabeled
        # gpu_operator_reconciliation_duration_seconds stays as the
        # ClusterPolicy headline series)
        self.workqueue_depth = g(
            "gpu_operator_workqueue_depth",
            "Items waiting in a controller's workqueue (incl. delayed)",
            labelnames=("controller",))
        self.workqueue_queue_duration = g(
            "gpu_operator_workqueue_queue_duration_seconds",
            "Queue latency of the most recently dequeued item",
            labelnames=("controller",))
        # tracing plane (runtime/tracing.py): the distribution series the
        # last-write gauges above can't provide. The per-controller
        # reconcile duration is a Histogram (was a gauge) so percentiles
        # survive between scrapes; queue time and client verb latency get
        # their own histograms. The verb histogram's source label splits
        # informer-cache hits from real apiserver round-trips.
        self.reconcile_duration_by_controller = h(
            "gpu_operator_reconcile_duration_seconds",
            "Reconcile wall time, per controller",
            labelnames=("controller",))
        self.workqueue_queue_latency = h(
            "gpu_operator_workqueue_queue_time_seconds",
            "Time items spent queued before a worker dequeued them",
            labelnames=("controller",))
        self.client_verb_duration = h(
            "gpu_operator_client_verb_duration_seconds",
            "API client verb latency, by verb/kind and whether the read "
            "was served from the informer cache or the apiserver",
            labelnames=("verb", "kind", "source"))
        # zero-write steady state (state/skel.py spec-hash gate +
        # api/conditions.py status-write skip, render memo in
        # state/operands.py): how much apiserver traffic and render CPU
        # the converged path avoided — the observable face of the
        # "0 requests per settled pass" contract
        self.writes_avoided = c(
            "gpu_operator_writes_avoided_total",
            "Apiserver writes skipped because the live object already "
            "matches the rendered spec-hash (incl. no-op status writes)",
            labelnames=("kind",))
        self.render_cache_hits = c(
            "gpu_operator_render_cache_hits_total",
            "Operand renders served from the memoized render cache")
        self.render_cache_misses = c(
            "gpu_operator_render_cache_misses_total",
            "Operand renders that had to run the template engine")
        # edge-triggered convergence (state DAG + operand watch fan-out):
        # a watch-event storm on one key collapses to one queued item,
        # and informer relists (the 410-Gone heal + resync) are counted
        # per kind so a relist loop is visible on /metrics
        self.workqueue_coalesced = c(
            "gpu_operator_workqueue_coalesced_total",
            "Redundant enqueues absorbed while the key was already "
            "queued or already marked for re-run",
            labelnames=("controller",))
        self.cache_relists = c(
            "gpu_operator_cache_relists_total",
            "Informer cache relists (watch-gap heals and forced "
            "resyncs), per cached kind",
            labelnames=("kind",))
        # slice placement engine (topology/placement.py + the
        # SliceRequest controller): decision outcomes, per-decision
        # scoring latency, and the free/placed chip inventory per
        # generation — the fleet-utilization face of the bin-packer
        self.placement_decisions = c(
            "gpu_operator_placement_decisions_total",
            "SliceRequest placement decisions, by outcome "
            "(placed|unschedulable|released|evicted)",
            labelnames=("outcome",))
        self.placement_latency = h(
            "gpu_operator_placement_latency_seconds",
            "Wall time of one placement scoring pass (rank + bind)")
        self.fleet_chips = g(
            "gpu_operator_fleet_chips",
            "GPU chips by generation and placement state",
            labelnames=("accelerator", "state"))
        # incremental placement index (topology/index.py): deltas folded
        # into the long-lived fleet view, by event
        # (added|modified|deleted|replace|resync), and how many Pending
        # requests the last batched gang-placement pass drained
        self.placement_index_updates = c(
            "gpu_operator_placement_index_updates_total",
            "Node deltas folded into the incremental placement index, "
            "by event (added|modified|deleted|replace|resync)",
            labelnames=("event",))
        self.placement_batch_size = g(
            "gpu_operator_placement_batch_size",
            "Pending SliceRequests drained by the last batched "
            "gang-placement pass")
        # elastic slices (slice-intent protocol): migration/resize
        # attempt outcomes, intent→rebound handshake latency, how stale
        # each workload's last durable checkpoint is, and the two
        # robustness counters the satellite work added (Unschedulable
        # requeue backoff fires, corrupt-checkpoint restore fallbacks)
        self.slice_migrations = c(
            "gpu_operator_slice_migrations_total",
            "Elastic slice migration/resize attempts, by outcome "
            "(migrated|resized|timeout|aborted)",
            labelnames=("outcome",))
        self.slice_migration_duration = h(
            "gpu_operator_slice_migration_duration_seconds",
            "Intent-posted to capacity-rebound latency of one "
            "successful migration/resize handshake")
        self.slice_checkpoint_age = g(
            "gpu_operator_slice_checkpoint_age_seconds",
            "Seconds since the workload on a placed slice last wrote a "
            "durable checkpoint",
            labelnames=("request",))
        # fleet-scale control plane (sharded reconcile lanes + bounded
        # cache): per-lane queue depth (health must never pool behind
        # bulk), time spent blocked on the shared apiserver write
        # budget, and the measured in-memory size of each informer
        # store (the projected view when projection is on)
        self.workqueue_lane_depth = g(
            "gpu_operator_workqueue_lane_depth",
            "Items waiting per workqueue priority lane "
            "(health > placement > bulk)",
            labelnames=("controller", "lane"))
        self.client_write_throttle = c(
            "gpu_operator_client_write_throttle_seconds_total",
            "Seconds reconcile workers spent blocked on the shared "
            "apiserver write budget (OPERATOR_WRITE_QPS token bucket)",
            labelnames=("controller",))
        self.cache_store_bytes = g(
            "gpu_operator_cache_store_bytes",
            "Measured bytes held by one informer store (the projected "
            "view when field projection is on)",
            labelnames=("kind",))
        self.placement_requeues = c(
            "gpu_operator_placement_requeue_total",
            "Unschedulable SliceRequest requeues (capped exponential "
            "backoff schedule)")
        self.checkpoint_restore_fallbacks = c(
            "gpu_operator_checkpoint_restore_fallbacks_total",
            "Restores that skipped a partial/corrupt latest checkpoint "
            "and fell back to an older retained step")
        # causal lineage plane (runtime/timeline.py + metrics/slo.py):
        # per-lane queue-time distribution (the health-lane-queue SLO's
        # SLI source — the per-controller queue-time histogram above
        # can't split lanes), and the SLO engine's exported verdicts
        self.workqueue_lane_queue_latency = h(
            "gpu_operator_workqueue_lane_queue_time_seconds",
            "Time items spent queued before dequeue, per priority lane",
            labelnames=("lane",))
        self.slo_burn_rate = g(
            "gpu_operator_slo_burn_rate",
            "Error-budget burn rate per SLO and evaluation window "
            "(1.0 = spending budget exactly at the sustainable rate)",
            labelnames=("slo", "window"))
        self.slo_budget_remaining = g(
            "gpu_operator_slo_error_budget_remaining",
            "Fraction of the error budget left over the engine's "
            "retained history (1.0 = untouched, 0.0 = exhausted)",
            labelnames=("slo",))
        self.slo_breached = g(
            "gpu_operator_slo_breached",
            "1 when every evaluation window of the SLO burns past its "
            "threshold (the multi-window page condition)",
            labelnames=("slo",))
        # crash-safe restart plane (runtime/snapshot.py + cache degraded
        # mode): durable snapshot lifecycle, warm-restore outcomes, and
        # the brownout breaker's externally visible state
        self.cache_listener_errors = c(
            "gpu_operator_cache_listener_errors_total",
            "Exceptions raised by cache delta listeners (a listener is "
            "detached after repeated consecutive failures)",
            labelnames=("kind",))
        self.cache_degraded = g(
            "gpu_operator_cache_degraded",
            "1 while the informer cache is in Degraded mode: apiserver "
            "syncs failing past the breaker threshold, reads served "
            "from the stale cache, reconnects capped-backoff")
        self.cache_staleness_seconds = g(
            "gpu_operator_cache_staleness_seconds",
            "Age of the cached view: seconds since the last successful "
            "apiserver sync once syncs start failing (0 while healthy)")
        self.snapshot_writes = c(
            "gpu_operator_snapshot_writes_total",
            "Durable cache/index snapshot write attempts by outcome "
            "(written|failed|skipped_degraded — the cache breaker was "
            "Degraded, so capturing would embalm a stale view under a "
            "fresh timestamp)",
            labelnames=("outcome",))
        self.snapshot_restores = c(
            "gpu_operator_snapshot_restores_total",
            "Warm-restore attempts at manager start by outcome "
            "(restored|missing|discarded|failed)",
            labelnames=("outcome",))
        self.snapshot_age_seconds = g(
            "gpu_operator_snapshot_age_seconds",
            "Age of the newest valid durable snapshot on disk")
        # fleet telemetry plane (metrics/fleet.py): node health digests
        # folded O(delta) into per-domain/generation rollups, the
        # hysteresis scorer's condemned count, and per-slice goodput
        # (acked steps per wall-second vs the generation-ideal rate)
        self.fleet_duty_cycle_pct = g(
            "gpu_operator_fleet_duty_cycle_pct",
            "Mean chip duty cycle over a domain's digest-reporting "
            "nodes, per NVLink domain and generation",
            labelnames=("domain", "generation"))
        self.fleet_hbm_headroom_fraction = g(
            "gpu_operator_fleet_hbm_headroom_fraction",
            "Worst-chip free HBM fraction over a domain's "
            "digest-reporting nodes, per NVLink domain and generation",
            labelnames=("domain", "generation"))
        self.fleet_degraded_chips = g(
            "gpu_operator_fleet_degraded_chips",
            "Chips currently graded warn or fail by their node digest, "
            "per NVLink domain and generation",
            labelnames=("domain", "generation"))
        self.fleet_digest_nodes = g(
            "gpu_operator_fleet_digest_nodes",
            "GPU nodes by telemetry state (reporting|silent|condemned); "
            "condemned = failed the hysteresis scorer, excluded from "
            "placement",
            labelnames=("state",))
        self.fleet_slice_goodput_ratio = g(
            "gpu_operator_fleet_slice_goodput_ratio",
            "Acked steps per wall-second vs the generation-ideal rate "
            "for one placed slice (1.0 = full-speed training)",
            labelnames=("request",))
        self.slice_goodput_steps = c(
            "gpu_operator_slice_goodput_steps_total",
            "Acked workload steps classified against the goodput bar "
            "(good = at or above the degraded threshold ratio)",
            labelnames=("quality",))
        # fair-share admission plane (scheduling/quota.py + the
        # placement gang pass): per-class deficit clocks, computed fair
        # shares, and the preemption-budget buckets — the observables
        # behind the no-starvation and preemption-budget invariants
        self.admission_starvation_seconds = g(
            "gpu_operator_admission_starvation_seconds",
            "Seconds a quota class has sat below its min-guarantee "
            "floor with work queued (its starvation deficit clock)",
            labelnames=("class",))
        self.admission_share = g(
            "gpu_operator_admission_share",
            "Fair-share chips computed for a quota class by the "
            "weighted water-fill over current demand",
            labelnames=("class",))
        self.preemption_budget_remaining = g(
            "gpu_operator_preemption_budget_remaining",
            "Preemption-budget tokens a quota class has left in the "
            "current window (preemptions the class may still suffer)",
            labelnames=("class",))
        # multi-cluster federation plane (federation/): per-cell breaker
        # state and digest freshness, global routing decision outcomes
        # and latency, breaker probes against Open cells, and cross-cell
        # elastic migrations — the observables behind the
        # no-lost-work-cross-cell invariant
        self.federation_cell_state = g(
            "gpu_operator_federation_cell_state",
            "Circuit-breaker state of one federation cell "
            "(0 Healthy / 1 Suspect / 2 Open)",
            labelnames=("cell",))
        self.federation_digest_age = g(
            "gpu_operator_federation_digest_age_seconds",
            "Age of the newest fleet digest held for one cell "
            "(-1 when no digest has ever arrived)",
            labelnames=("cell",))
        self.federation_route_decisions = c(
            "gpu_operator_federation_route_decisions_total",
            "Global router placement decisions, by outcome "
            "(routed|no-cell)",
            labelnames=("outcome",))
        self.federation_route_latency = h(
            "gpu_operator_federation_route_latency_seconds",
            "Wall time of one global routing decision (score every "
            "cell's digest + pick)")
        self.federation_breaker_probes = c(
            "gpu_operator_federation_breaker_probes_total",
            "Backoff probes sent to an Open cell that failed (success "
            "closes the breaker and ends the series' growth)",
            labelnames=("cell",))
        self.federation_cross_cell_migrations = c(
            "gpu_operator_federation_cross_cell_migrations_total",
            "Cross-cell elastic migrations of slices out of condemned "
            "cells, by outcome (migrated|failed|aborted)",
            labelnames=("outcome",))
        # live resharding (sharded checkpoints + direct same-domain
        # handoff): the byte bill of the fast path vs the full blob,
        # planner cost, and why resizes fell back to the full path
        self.reshard_bytes_moved = c(
            "gpu_operator_reshard_bytes_moved_total",
            "Checkpoint bytes actually moved by direct shard handoffs "
            "(shards changing owner; surviving hosts' shards stay put)")
        self.reshard_shard_handoffs = c(
            "gpu_operator_reshard_shard_handoffs_total",
            "Shards reassigned to a new owner by direct handoffs")
        self.reshard_plan_seconds = h(
            "gpu_operator_reshard_plan_seconds",
            "Wall time to diff two shard layouts into a minimal "
            "movement plan")
        self.reshard_fallbacks = c(
            "gpu_operator_reshard_fallbacks_total",
            "Resizes that fell back to the full-checkpoint path, by "
            "reason (disabled|no-layout|layout-version|cross-domain|"
            "incompatible)",
            labelnames=("reason",))


OPERATOR_METRICS = OperatorMetrics()

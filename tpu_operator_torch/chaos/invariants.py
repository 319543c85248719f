"""Continuous cluster-invariant checking for chaos runs.

The port's copy of ``tpu_operator/chaos/invariants.py``. Where the
reference reads a TPU fact, the port reads the GPU one: the
accelerator pin is checked against ``gpu.product`` (a SliceRequest's
``spec.accelerator`` pins it), the index-coherence probes pin
:data:`PROBE_ACCELERATOR` and prefer :data:`PROBE_GENERATIONS` (the
reference's ``tpu-v5p-slice`` and ``v5p``: ``build_cluster``'s v5p pool
is an H100 pool), a fleet node is a GPU node (``labels.is_gpu_node``),
the settled state counts ``gpu_nodes``, and gauge-consistency reads the
``gpu_operator_slices_*`` series.

The checker reads the cluster through the UNWRAPPED inner client (its
reads must never consume an armed fault or perturb the run) and asserts
the properties the control plane promises to hold *at every observation
point*, not just at convergence:

- ``rv-regress``: resourceVersions never move backwards on the policy
  CR, Nodes, or operand DaemonSets. The fake apiserver's RV counter is
  globally monotonic, so a regression means a write path resurrected a
  stale snapshot — a lost status update.
- ``fsm-monotonic``: per upgrade *unit* (all hosts of a multi-host
  slice, the upgrade controller's own grouping), the aggregate FSM state
  only walks forward through ``_STAGE_ORDER``, with exactly the legal
  resets: anything may fail; ``failed`` retries to ``upgrade-required``;
  ``done`` may re-enter ``upgrade-required`` on a new rollout. A unit
  observed moving backward mid-flight (drain back to cordon) lost a
  member's transition.
- ``upgrade-budget``: units concurrently in ``IN_PROGRESS_STATES`` never
  exceed ``upgradePolicy.maxParallelUpgrades``.
- ``gauge-consistency`` (settled runs only): the slice gauges and the
  CR's ``status.slices[]`` rows agree with a fresh
  :func:`~tpu_operator_torch.controllers.slices.slice_status` computation.
  Checked only once faults stop — mid-storm a reconcile legally sets
  gauges and then loses its status write to an injected 409.
- ``cache-staleness`` (when the controllers read through a
  :class:`~tpu_operator_torch.runtime.cache.CachedClient`): continuously, no
  cached object may be *ahead* of the authoritative store — a cached
  resourceVersion above the apiserver's means the cache invented state
  (being behind mid-storm is legal; that's what healing is for). Once
  settled, the cache must agree exactly: same keys, same
  resourceVersions, for every kind it caches — a dropped watch that
  resumed must leave no stale or phantom entries behind.
- ``dag-order`` (when the runner hands over the state manager's
  :class:`~tpu_operator_torch.state.scheduler.SyncJournal`): within every sync
  pass, no operand state may *start* syncing before every state in its
  ``requires()`` has *finished* — the dependency contract the DAG
  scheduler exists to uphold, checked against the journal's sequence
  numbers rather than trusted. Journal entries accumulate per pass
  across drains, so a pass split over two observation points cannot
  false-positive.
- ``placement-sound``: no node is ever claimed by two Placed
  SliceRequests at once, and a bound node never violates the request's
  accelerator pin. Once settled, every bound node must also exist and
  carry the matching ``gpu.graft.dev/placed-by`` lease, and no node may
  carry an orphan lease (mid-storm a NODE_REMOVE legally breaks a
  binding until the eviction path catches up). Checked in every
  scenario — a run with no SliceRequests is a clean no-op.
- ``placement-stable``: a Placed request's node set never changes
  without ``status.evictions`` OR ``status.migrations`` incrementing —
  the controller's promise that placements only move through an
  explicit drain event or an acknowledged elastic migration, never a
  silent re-pack.
- ``no-lost-work``: the elastic-slice durability promise. A workload's
  acked step (``status.migration.ackedStep`` / the
  ``gpu.graft.dev/slice-intent-ack`` annotation) is a receipt for a
  finalized checkpoint, so per request the acked high-water mark never
  regresses, and every restore (``status.migration.restoredStep``
  changing) lands at or above it — acknowledged training work must
  survive any migrate/resize/crash interleaving the storm produces.
- ``index-coherence``: the incremental placement index
  (:class:`~tpu_operator_torch.topology.index.FleetIndex`), fed O(delta) from
  the node-list diffs between observation points exactly as the
  placement controller's resync path feeds it, must rank
  candidate-for-candidate identically to a from-scratch ``FleetState``
  — same ``sort_key`` order, same ``unschedulable_reason`` — for a
  panel of probe request shapes at every settle point. A divergence
  means the O(delta) maintenance lost or invented structure the full
  rebuild sees.
- ``telemetry-no-flap-evict``: a telemetry-driven eviction
  (``status.lastEvictionReason`` naming a node "condemned by
  telemetry") is legal only for a node whose own digest stream — folded
  independently here, seq by seq, through the same hysteresis rule the
  scorer uses — actually sustained ``CONDEMN_AFTER`` consecutive FAIL
  publishes, and at most once per (request, node) pair. A flapping chip
  must cause zero evictions and a condemned one must never ping-pong
  the same slice off the same node twice. Checked in every scenario — a
  run that publishes no digests is a clean no-op.
- ``no-starvation`` (when the runner hands over the scenario's quota
  tree): a quota class with work queued and usage below its
  min-guarantee floor (``min(minChips, usage + queued)`` — the same
  floor the admission watchdog clocks) may stay starved for at most its
  ``starvationBoundSeconds`` of virtual time before the deficit-driven
  escalation and budgeted preemption must have rescued it. Folded
  independently from CR phases and spec sizes, never from the
  controller's own deficit clocks. Checked in every scenario — with no
  quota tree the fold is a strict no-op, so legacy verdicts stay
  byte-identical.
- ``preemption-budget`` (same gating): preemptions are bounded AND
  non-lethal. Each posted preempt intent (a ``status.migration`` with
  ``preemptedFor`` and a fresh ``startedAt``) counts against the
  victim's class inside a sliding ``preemptWindowSeconds`` window; more
  events than the class's ``preemptTokens`` is a violation. And a
  preemption must route through the elastic checkpoint->rebind
  handshake — a ``status.evictions`` increment whose reason names a
  preemption means a slice was killed for quota, the one thing the
  budgeted path exists to prevent.
- ``lane-priority`` (recorded by the runner): no health-lane event may
  be dequeued having waited behind more than the runner's
  ``LANE_PRIORITY_BUDGET`` bulk reconciles — the workload-aware
  queueing promise the priority lanes exist for, audited from the
  controllers' lane journals at verdict time.
- ``convergence``: recorded by the runner when the cluster fails to
  reach all-Ready within the soak budget after faults stop.

Every violation also increments
``gpu_operator_chaos_invariant_violations_total{invariant=...}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api import labels as L
from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1
from ..controllers.upgrade_controller import (
    IN_PROGRESS_STATES,
    STATE_DONE,
    STATE_FAILED,
    _STAGE_ORDER,
)
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..metrics.registry import REGISTRY
from ..runtime.client import Client, ListOptions
from ..runtime.objects import get_nested, labels_of, name_of

# the index-coherence probes' pin and preference: the reference's
# ``tpu-v5p-slice`` and ``v5p`` in the port's terms (a gpu.product pin
# and a generation of the hardware table); a parity test maps them
PROBE_ACCELERATOR = "NVIDIA-H100-80GB-HBM3"
PROBE_GENERATIONS = ("h100-sxm",)


@dataclass(frozen=True)
class Violation:
    invariant: str
    step: int
    detail: str

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "step": self.step,
                "detail": self.detail}


class InvariantChecker:
    def __init__(self, client: Client, namespace: str = "gpu-operator",
                 cache=None, journal=None, quota=None,
                 step_dt: float = 1.0):
        self.client = client
        self.namespace = namespace
        self.cache = cache  # CachedClient under test, or None
        self.journal = journal  # state manager's SyncJournal, or None
        # the scenario's QuotaTree (admission invariants), or None —
        # with None the admission fold is a strict no-op, so every
        # pre-quota scenario's verdict stays byte-identical
        self.quota = quota
        self.step_dt = step_dt  # virtual seconds per observation step
        self.violations: List[Violation] = []
        self._last_rv: Dict[Tuple[str, str, str], int] = {}
        self._unit_states: Dict[Tuple[str, ...], Optional[str]] = {}
        # pass_id -> {state: done_seq}, accumulated across journal drains
        self._dag_done: Dict[int, Dict[str, int]] = {}
        # request key -> (sorted bound-node tuple, evictions, migrations)
        # at the last observation the request was Placed
        # (placement-stable history)
        self._placements: Dict[str, Tuple[Tuple[str, ...], int, int]] = {}
        # request key -> (acked high-water step, last restoredStep seen)
        # for the no-lost-work audit
        self._work: Dict[str, Tuple[Optional[int], Optional[int]]] = {}
        # long-lived FleetIndex fed by node-list diffs across the whole
        # run (index-coherence); built lazily on the first observation
        self._fleet_index = None
        # telemetry-no-flap-evict: an independent digest fold (last seq,
        # fail streak, ever-legitimately-condemned set) plus the
        # telemetry-eviction ledger per (request key, node)
        self._tel_seq: Dict[str, object] = {}
        self._tel_fail: Dict[str, int] = {}
        self._tel_ever: set = set()
        self._tel_evicted: Dict[Tuple[str, str], int] = {}
        self._tel_evictions: Dict[str, int] = {}
        # admission fold: class -> step its starvation began; request
        # key -> last migration startedAt counted as a preempt event;
        # class -> event steps inside the sliding window; request key ->
        # last evictions count (preemptions must never surface here)
        self._starve_start: Dict[str, int] = {}
        self._preempt_seen: Dict[str, object] = {}
        self._preempt_events: Dict[str, List[int]] = {}
        self._adm_evictions: Dict[str, int] = {}

    def on_operator_restart(self, step: int, cache=None,
                            journal=None) -> None:
        """The operator process died and a successor took over: audit
        and release the dead process's sync journal, then follow the
        successor's cache and journal. Cluster-state history (RVs,
        placements, acked work, FSM units) survives untouched — the
        cluster didn't restart, the operator did."""
        self._check_dag(step)
        # the successor's journal restarts pass ids and sequence
        # numbers; stale done-seqs would false-positive dag-order
        self._dag_done.clear()
        self.cache = cache
        self.journal = journal

    def record(self, invariant: str, step: int, detail: str) -> None:
        self.violations.append(Violation(invariant, step, detail))
        OPERATOR_METRICS.chaos_invariant_violations.labels(
            invariant=invariant).inc()

    def to_list(self) -> List[dict]:
        return [v.to_dict() for v in self.violations]

    # -- periodic observation ----------------------------------------------

    def observe(self, step: int) -> None:
        nodes = {name_of(n): n for n in self.client.list("v1", "Node")}
        self._check_rv(step, nodes)
        self._check_fsm(step, nodes)
        self._check_budget(step, nodes)
        self._check_cache(step, settled=False)
        self._check_dag(step)
        self._check_placement(step, nodes, settled=False)
        self._check_work(step)
        self._check_telemetry(step, nodes)
        self._check_admission(step)
        self._feed_index(nodes)

    # -- fair-share admission ------------------------------------------------

    def _check_admission(self, step: int) -> None:
        """no-starvation + preemption-budget (see module docstring).
        The fold is the checker's OWN: per-class usage and queue depth
        come straight from CR phases and spec sizes, the starvation
        floor is recomputed from the tree — a watchdog whose deficit
        clocks drift is caught rather than trusted."""
        if self.quota is None:
            return
        from ..api.slicerequest import (
            KIND_SLICE_REQUEST,
            PHASE_PLACED,
            V1ALPHA1,
            SliceRequestSpec,
        )
        from ..controllers.slices import migration_of

        dt = max(self.step_dt, 1e-9)
        usage: Dict[str, int] = {}
        queued: Dict[str, int] = {}
        for req in sorted(self.client.list(V1ALPHA1, KIND_SLICE_REQUEST),
                          key=lambda r: (namespace_key(r), name_of(r))):
            key = f"{namespace_key(req) or 'default'}/{name_of(req)}"
            cls = self.quota.class_of(req)
            if get_nested(req, "status", "phase") == PHASE_PLACED:
                usage[cls] = usage.get(cls, 0) + int(
                    get_nested(req, "status", "chips", default=0) or 0)
            else:
                queued[cls] = queued.get(cls, 0) + int(
                    SliceRequestSpec.from_obj(req).chips_needed() or 0)
            mig = migration_of(req)
            started = mig.get("startedAt")
            if mig.get("preemptedFor") and started is not None \
                    and self._preempt_seen.get(key) != started:
                # one event per posted preempt intent, charged to the
                # VICTIM's class (the budget bounds what a class suffers)
                self._preempt_seen[key] = started
                self._preempt_events.setdefault(cls, []).append(step)
            evictions = int(get_nested(req, "status", "evictions",
                                       default=0) or 0)
            prev = self._adm_evictions.get(key, 0)
            self._adm_evictions[key] = evictions
            if evictions > prev:
                reason = str(get_nested(req, "status",
                                        "lastEvictionReason",
                                        default="") or "")
                if reason.startswith("preempted"):
                    self.record(
                        "preemption-budget", step,
                        f"{key}: hard-evicted for a preemption "
                        f"({reason!r}) — quota reclaim must migrate "
                        f"through the checkpoint handshake, never kill")
        for name in self.quota.leaf_names():
            qc = self.quota.get(name)
            events = self._preempt_events.get(name)
            if events:
                horizon = step - qc.preempt_window_s / dt
                events[:] = [s for s in events if s > horizon]
                if len(events) > qc.preempt_tokens:
                    self.record(
                        "preemption-budget", step,
                        f"class {name}: {len(events)} preemptions inside "
                        f"one {qc.preempt_window_s:.0f}s window, budget "
                        f"is {qc.preempt_tokens}")
                    events.clear()  # one report per overrun, not per step
            use = usage.get(name, 0)
            q = queued.get(name, 0)
            floor = min(qc.min_chips, use + q)
            if not (q > 0 and use < floor):
                self._starve_start.pop(name, None)
                continue
            start = self._starve_start.setdefault(name, step)
            waited = (step - start) * dt
            if waited > qc.starvation_bound_s:
                self.record(
                    "no-starvation", step,
                    f"class {name}: {use}/{floor} min-guarantee chips "
                    f"with {q} queued for {waited:.0f} virtual s — past "
                    f"the {qc.starvation_bound_s:.0f}s starvation bound")
                self._starve_start[name] = step  # re-arm, don't spam

    # -- telemetry eviction legality -----------------------------------------

    def _check_telemetry(self, step: int, nodes: Dict[str, dict]) -> None:
        """telemetry-no-flap-evict (see module docstring). The fold here
        is the checker's OWN: same hysteresis rule as the production
        scorer (consecutive FAIL publishes by digest seq, any other
        status resets the streak) but fed straight from the node
        annotations, so a scorer that miscounts is caught rather than
        trusted. Runs at most one publish behind — the runner applies at
        most one digest per node per step, and this observes every step."""
        from ..api.slicerequest import KIND_SLICE_REQUEST, V1ALPHA1
        from ..metrics.fleet import CONDEMN_AFTER
        from ..metrics.health_engine import parse_digest

        for name in sorted(nodes):
            digest = parse_digest((get_nested(
                nodes[name], "metadata", "annotations", default={})
                or {}).get(L.HEALTH_DIGEST))
            if digest is None or digest.get("seq") == self._tel_seq.get(
                    name):
                continue
            self._tel_seq[name] = digest.get("seq")
            if str(digest.get("status", "")) == "fail":
                self._tel_fail[name] = self._tel_fail.get(name, 0) + 1
                if self._tel_fail[name] >= CONDEMN_AFTER:
                    self._tel_ever.add(name)
            else:
                self._tel_fail.pop(name, None)
        requests = self.client.list(V1ALPHA1, KIND_SLICE_REQUEST)
        if not requests and not self._tel_evictions:
            return
        live = set()
        for req in sorted(requests, key=name_of):
            key = f"{namespace_key(req) or 'default'}/{name_of(req)}"
            live.add(key)
            evictions = int(get_nested(req, "status", "evictions",
                                       default=0) or 0)
            prev = self._tel_evictions.get(key, 0)
            self._tel_evictions[key] = evictions
            if evictions <= prev:
                continue
            reason = str(get_nested(req, "status", "lastEvictionReason",
                                    default="") or "")
            if not (reason.startswith("node ")
                    and reason.endswith(" condemned by telemetry")):
                continue
            node_name = reason[len("node "):-len(
                " condemned by telemetry")]
            if node_name not in self._tel_ever:
                self.record(
                    "telemetry-no-flap-evict", step,
                    f"{key}: evicted off {node_name}, whose digest "
                    f"stream never sustained {CONDEMN_AFTER} consecutive "
                    f"FAIL publishes (streak now "
                    f"{self._tel_fail.get(node_name, 0)}) — a flapping "
                    f"chip caused an eviction")
            pair = (key, node_name)
            self._tel_evicted[pair] = self._tel_evicted.get(pair, 0) + 1
            if self._tel_evicted[pair] > 1:
                self.record(
                    "telemetry-no-flap-evict", step,
                    f"{key}: evicted off {node_name} by telemetry "
                    f"{self._tel_evicted[pair]} times — condemn/absolve "
                    f"ping-pong")
        for key in [k for k in self._tel_evictions if k not in live]:
            del self._tel_evictions[key]

    # -- incremental-index coherence ----------------------------------------

    def _feed_index(self, nodes: Dict[str, dict]) -> None:
        from ..topology.index import FleetIndex

        if self._fleet_index is None:
            self._fleet_index = FleetIndex(list(nodes.values()))
        else:
            # the same O(delta) diff feed the controller uses when the
            # client has no delta hook — so the index under audit has
            # lived through every churn step, never a fresh rebuild
            self._fleet_index.resync(list(nodes.values()))

    def _check_index(self, step: int, nodes: Dict[str, dict]) -> None:
        """index-coherence (see module docstring): candidate-for-candidate
        equality between the run-long incrementally-fed FleetIndex and a
        from-scratch FleetState, across probe shapes covering plain,
        pinned, preferred-generation, and infeasible requests."""
        from ..api.slicerequest import SliceRequestSpec
        from ..topology.placement import (
            FleetState,
            rank_candidates,
            unschedulable_reason,
        )

        self._feed_index(nodes)
        idx = self._fleet_index
        scratch = FleetState(list(nodes.values()))
        probes = [SliceRequestSpec(chips=c) for c in (4, 8, 16, 32)]
        probes += [SliceRequestSpec(chips=8,
                                    accelerator=PROBE_ACCELERATOR),
                   SliceRequestSpec(chips=8,
                                    preferred_generations=PROBE_GENERATIONS)]
        for spec in probes:
            want = [c.sort_key() for c in rank_candidates(spec, scratch)]
            got = [c.sort_key() for c in idx.rank(spec)]
            if got != want:
                self.record(
                    "index-coherence", step,
                    f"spec chips={spec.chips_needed()} "
                    f"acc={spec.accelerator!r}: index ranked "
                    f"{len(got)} candidates (top {got[:1]}), rescan "
                    f"ranked {len(want)} (top {want[:1]})")
            best = idx.best(spec)
            top = (best.sort_key() if best is not None else None)
            if top != (want[0] if want else None):
                self.record(
                    "index-coherence", step,
                    f"spec chips={spec.chips_needed()}: index best() "
                    f"{top} != rescan top "
                    f"{want[0] if want else None}")
        impossible = SliceRequestSpec(chips=10 ** 6)
        want_reason = unschedulable_reason(impossible, scratch)
        got_reason = idx.unschedulable_reason(impossible)
        if got_reason != want_reason:
            self.record(
                "index-coherence", step,
                f"unschedulable_reason diverged: index {got_reason!r} "
                f"!= rescan {want_reason!r}")

    # -- slice placement ----------------------------------------------------

    def _check_placement(self, step: int, nodes: Dict[str, dict],
                         settled: bool) -> None:
        """placement-sound + placement-stable (see module docstring).
        Listing an unknown kind returns [] on the fake apiserver, so in
        every scenario that creates no SliceRequests this is a no-op."""
        from ..api.slicerequest import (
            KIND_SLICE_REQUEST,
            PHASE_PLACED,
            V1ALPHA1,
            SliceRequestSpec,
        )

        requests = sorted(self.client.list(V1ALPHA1, KIND_SLICE_REQUEST),
                          key=lambda r: (namespace_key(r), name_of(r)))
        if not requests and not self._placements:
            return
        owner_by_node: Dict[str, str] = {}
        live_keys = set()
        for req in requests:
            key = f"{namespace_key(req) or 'default'}/{name_of(req)}"
            live_keys.add(key)
            if get_nested(req, "status", "phase") != PHASE_PLACED:
                continue
            spec = SliceRequestSpec.from_obj(req)
            bound = tuple(sorted(
                get_nested(req, "status", "nodes", default=[]) or []))
            evictions = int(get_nested(req, "status", "evictions",
                                       default=0) or 0)
            for node_name in bound:
                prior = owner_by_node.get(node_name)
                if prior is not None:
                    self.record(
                        "placement-sound", step,
                        f"node {node_name} double-booked by {prior} "
                        f"and {key}")
                owner_by_node[node_name] = key
                node = nodes.get(node_name)
                if node is None:
                    # legal mid-storm (NODE_REMOVE outruns the eviction
                    # path); a hole after settling is a lost drain
                    if settled:
                        self.record(
                            "placement-sound", step,
                            f"{key}: bound node {node_name} does not "
                            f"exist after settling")
                    continue
                if spec.accelerator and labels_of(node).get(
                        L.GPU_PRODUCT) != spec.accelerator:
                    self.record(
                        "placement-sound", step,
                        f"{key}: node {node_name} violates accelerator "
                        f"pin {spec.accelerator!r}")
                if settled:
                    lease = (get_nested(node, "metadata", "annotations",
                                        default={}) or {}).get(L.PLACED_BY)
                    if lease != key:
                        self.record(
                            "placement-sound", step,
                            f"{key}: node {node_name} lease is {lease!r} "
                            f"after settling, want {key!r}")
            migrations = int(get_nested(req, "status", "migrations",
                                        default=0) or 0)
            prev = self._placements.get(key)
            if prev is not None and bound != prev[0] \
                    and evictions <= prev[1] and migrations <= prev[2]:
                self.record(
                    "placement-stable", step,
                    f"{key}: bound nodes {list(prev[0])} -> {list(bound)} "
                    f"without status.evictions "
                    f"({prev[1]} -> {evictions}) or status.migrations "
                    f"({prev[2]} -> {migrations}) incrementing")
            self._placements[key] = (bound, evictions, migrations)
        if settled:
            for node_name in sorted(nodes):
                lease = (get_nested(nodes[node_name], "metadata",
                                    "annotations", default={})
                         or {}).get(L.PLACED_BY)
                if lease and owner_by_node.get(node_name) != lease:
                    self.record(
                        "placement-sound", step,
                        f"node {node_name}: orphan placement lease "
                        f"{lease!r} after settling")
        # deleted requests stop being tracked (their leases were audited
        # above while they lived); a namesake re-create starts fresh
        for key in [k for k in self._placements if k not in live_keys]:
            del self._placements[key]

    # -- elastic no-lost-work ----------------------------------------------

    def _check_work(self, step: int) -> None:
        """no-lost-work (see module docstring). An ack is written only
        after the checkpoint it names is finalized, and retention never
        prunes past the newest finalized step, so a regression here means
        acknowledged training work genuinely evaporated."""
        from ..api.slicerequest import KIND_SLICE_REQUEST, V1ALPHA1

        requests = self.client.list(V1ALPHA1, KIND_SLICE_REQUEST)
        if not requests and not self._work:
            return
        live = set()
        for req in sorted(requests, key=name_of):
            key = f"{namespace_key(req) or 'default'}/{name_of(req)}"
            live.add(key)
            mig = get_nested(req, "status", "migration", default={}) or {}
            anns = get_nested(req, "metadata", "annotations",
                              default={}) or {}
            acks = []
            for raw in (mig.get("ackedStep"),
                        anns.get(L.SLICE_INTENT_ACK)):
                try:
                    if raw is not None:
                        acks.append(int(raw))
                except (TypeError, ValueError):
                    pass
            high, prev_restored = self._work.get(key, (None, None))
            if acks and high is not None and max(acks) < high:
                self.record(
                    "no-lost-work", step,
                    f"{key}: acked step regressed {high} -> {max(acks)}")
            raw_restored = mig.get("restoredStep")
            try:
                restored = (int(raw_restored)
                            if raw_restored is not None else None)
            except (TypeError, ValueError):
                restored = None
            if restored is not None and restored != prev_restored \
                    and high is not None and restored < high:
                self.record(
                    "no-lost-work", step,
                    f"{key}: restored step {restored} below the acked "
                    f"high-water mark {high}")
            candidates = acks if high is None else acks + [high]
            self._work[key] = (max(candidates) if candidates else None,
                               restored)
        # deleted requests stop being tracked; their durability promise
        # died with them (a namesake re-create starts at step 0 legally)
        for key in [k for k in self._work if k not in live]:
            del self._work[key]

    # -- DAG dependency order ----------------------------------------------

    def _check_dag(self, step: int) -> None:
        """No state starts before its requires() finished, per pass.

        Journal entries are recorded at state *completion* (the scheduler
        joins each wave before the next draws start sequences), so by the
        time a dependent's entry exists, every prerequisite's entry from
        the same pass exists too — a missing or later-finishing
        prerequisite is a genuine ordering violation, not a drain
        artifact."""
        if self.journal is None:
            return
        entries = self.journal.drain()
        for e in entries:
            self._dag_done.setdefault(e.pass_id, {})[e.state] = e.done_seq
        for e in entries:
            done = self._dag_done.get(e.pass_id, {})
            for req in e.requires:
                done_seq = done.get(req)
                if done_seq is None or done_seq > e.start_seq:
                    self.record(
                        "dag-order", step,
                        f"pass {e.pass_id}: {e.state} started (seq "
                        f"{e.start_seq}) before required state {req} "
                        f"finished (seq {done_seq})")
        # old passes can never gain new entries; keep the map bounded
        if entries:
            newest = max(e.pass_id for e in entries)
            for pid in [p for p in self._dag_done if p < newest - 4]:
                del self._dag_done[pid]

    # -- cache coherence ----------------------------------------------------

    def _authoritative_rvs(self, api_version: str,
                           kind: str) -> Dict[tuple, str]:
        return {(namespace_key(obj), name_of(obj)):
                get_nested(obj, "metadata", "resourceVersion")
                for obj in self.client.list(api_version, kind)}

    def _check_cache(self, step: int, settled: bool) -> None:
        if self.cache is None:
            return
        for api_version, kind in self.cache.cached_kinds():
            cached = self.cache.store_snapshot(api_version, kind)
            auth = self._authoritative_rvs(api_version, kind)
            for key, rv in sorted(cached.items()):
                want = auth.get(key)
                if want is not None:
                    try:
                        ahead = int(rv) > int(want)
                    except (TypeError, ValueError):
                        ahead = False
                    if ahead:
                        self.record(
                            "cache-staleness", step,
                            f"{kind} {key[0]}/{key[1]}: cache rv {rv} is "
                            f"AHEAD of apiserver rv {want}")
                    elif settled and rv != want:
                        self.record(
                            "cache-staleness", step,
                            f"{kind} {key[0]}/{key[1]}: settled cache rv "
                            f"{rv} != apiserver rv {want}")
                elif settled:
                    self.record(
                        "cache-staleness", step,
                        f"{kind} {key[0]}/{key[1]}: phantom cache entry "
                        f"(rv {rv}) for an object the apiserver deleted")
            if settled:
                for key in sorted(set(auth) - set(cached)):
                    self.record(
                        "cache-staleness", step,
                        f"{kind} {key[0]}/{key[1]}: missing from cache "
                        f"after settling (apiserver rv {auth[key]})")

    def _check_rv(self, step: int, nodes: Dict[str, dict]) -> None:
        tracked = list(self.client.list(V1, KIND_CLUSTER_POLICY))
        tracked += list(nodes.values())
        tracked += self.client.list(
            "apps/v1", "DaemonSet", ListOptions(namespace=self.namespace))
        seen = set()
        for obj in tracked:
            key = (obj.get("kind", ""), namespace_key(obj), name_of(obj))
            seen.add(key)
            try:
                rv = int(get_nested(obj, "metadata", "resourceVersion"))
            except (TypeError, ValueError):
                continue
            last = self._last_rv.get(key)
            if last is not None and rv < last:
                self.record("rv-regress", step,
                            f"{key[0]} {key[2]}: resourceVersion went "
                            f"{last} -> {rv}")
            self._last_rv[key] = rv
        # deleted objects stop being tracked; a re-created namesake gets a
        # fresh (higher, globally monotonic) RV anyway
        for key in [k for k in self._last_rv if k not in seen]:
            del self._last_rv[key]

    # -- upgrade FSM monotonicity ------------------------------------------

    @staticmethod
    def _units(nodes: Dict[str, dict]) -> List[List[str]]:
        """The upgrade controller's own unit partition (multi-host slices
        move as one unit; everything else is a singleton) — recomputed
        here so the invariant judges the controller by its own grouping."""
        from ..state.nodepool import get_node_pools, slices_of

        units: List[List[str]] = []
        grouped = set()
        for pool in get_node_pools(list(nodes.values())):
            if pool.multi_host:
                for _, members in sorted(slices_of(pool, nodes).items()):
                    units.append(sorted(members))
            else:
                for node_name in pool.nodes:
                    units.append([node_name])
            grouped.update(pool.nodes)
        for name in sorted(set(nodes) - grouped):
            units.append([name])
        units.sort(key=lambda u: u[0])
        return units

    @staticmethod
    def _unit_state(members: List[str],
                    nodes: Dict[str, dict]) -> Optional[str]:
        states = [labels_of(nodes[m]).get(L.UPGRADE_STATE) for m in members]
        if any(s == STATE_FAILED for s in states):
            return STATE_FAILED
        present = [s for s in states if s in _STAGE_ORDER]
        if not present:
            return None
        return min(present, key=_STAGE_ORDER.index)

    @staticmethod
    def _legal_transition(prev: Optional[str], new: Optional[str]) -> bool:
        if prev is None or new is None or prev == new:
            return True
        if new == STATE_FAILED:
            return True  # any stage may fail
        # backoff retry (from failed) and fresh rollout (from done) both
        # re-enter at upgrade-required, but the controller advances
        # multiple safe stages per pass while this checker samples once
        # per step — any stage downstream of the re-entry point can be
        # the first one observed (e.g. failed -> validation-required
        # when the retried unit's drain is instantly clean)
        if prev in (STATE_FAILED, STATE_DONE):
            return new in _STAGE_ORDER
        if prev in _STAGE_ORDER and new in _STAGE_ORDER:
            return _STAGE_ORDER.index(new) >= _STAGE_ORDER.index(prev)
        return True  # unknown label value: not this invariant's problem

    def _check_fsm(self, step: int, nodes: Dict[str, dict]) -> None:
        seen = set()
        for members in self._units(nodes):
            key = tuple(members)
            seen.add(key)
            new = self._unit_state(members, nodes)
            prev = self._unit_states.get(key)
            if not self._legal_transition(prev, new):
                self.record("fsm-monotonic", step,
                            f"unit [{members[0]}+{len(members) - 1}]: "
                            f"{prev} -> {new}")
            self._unit_states[key] = new
        # churned units (membership changed) restart with no history —
        # a different member set is a different unit, not a regression
        for key in [k for k in self._unit_states if k not in seen]:
            del self._unit_states[key]

    def _check_budget(self, step: int, nodes: Dict[str, dict]) -> None:
        crs = self.client.list(V1, KIND_CLUSTER_POLICY)
        if not crs:
            return
        crs.sort(key=lambda c: (
            get_nested(c, "metadata", "creationTimestamp", default=""),
            name_of(c)))
        raw = get_nested(crs[0], "spec", "upgradePolicy",
                         "maxParallelUpgrades")
        budget = max(1, raw or 1)  # the controller's own default
        in_progress = sum(
            1 for members in self._units(nodes)
            if self._unit_state(members, nodes) in IN_PROGRESS_STATES)
        if in_progress > budget:
            self.record("upgrade-budget", step,
                        f"{in_progress} upgrade units in progress, "
                        f"budget is {budget}")

    # -- settled-only checks ------------------------------------------------

    def check_settled(self, step: int) -> None:
        """Gauge/status consistency, valid only once faults have stopped
        and the cluster has had time to settle: mid-storm a reconcile can
        legally set the gauges and then lose the CR status write to an
        injected 409."""
        from ..controllers.slices import MAX_ROWS, slice_status

        rows = slice_status(self.client, self.namespace)
        total = REGISTRY.get_sample_value("gpu_operator_slices_total")
        validated = REGISTRY.get_sample_value("gpu_operator_slices_validated")
        want_total = float(len(rows))
        want_validated = float(sum(1 for r in rows if r["validated"]))
        if total != want_total or validated != want_validated:
            self.record("gauge-consistency", step,
                        f"slice gauges ({total}, {validated}) != "
                        f"recomputed ({want_total}, {want_validated})")
        crs = self.client.list(V1, KIND_CLUSTER_POLICY)
        for cr in crs:
            if get_nested(cr, "status", "state") != "ready":
                continue
            cr_rows = get_nested(cr, "status", "slices", default=[]) or []
            if cr_rows != rows[:MAX_ROWS]:
                self.record("gauge-consistency", step,
                            f"policy {name_of(cr)}: status.slices[] "
                            f"({len(cr_rows)} rows) disagrees with a fresh "
                            f"slice_status ({len(rows)} rows)")
        self._check_cache(step, settled=True)
        if self.cache is not None and getattr(self.cache, "degraded",
                                              False):
            # a healed apiserver must let the breaker close again —
            # settling while still serving stale reads is a stuck exit
            self.record("cache-staleness", step,
                        "cache still in degraded mode after settling "
                        f"(staleness {self.cache.staleness_s():.1f}s)")
        self._check_dag(step)
        nodes = {name_of(n): n for n in self.client.list("v1", "Node")}
        self._check_placement(step, nodes, settled=True)
        self._check_work(step)
        self._check_telemetry(step, nodes)
        self._check_admission(step)
        self._check_index(step, nodes)


class CrossCellWorkChecker:
    """Federation invariants over N cells (chaos/federation.py):

    - **no-lost-work-cross-cell**: per request key, the acked
      checkpoint high-water (max of ``status.migration.ackedStep``,
      ``status.progress.checkpointedStep`` and the intent-ack
      annotation, observed across EVERY cell) must never regress, and
      any observed ``restoredStep`` must be at or above it — a restore
      below the high-water after a hop means acked work evaporated in
      transit between clusters.
    - **single-binding**: a request Placed in more than one cell at the
      same observation, excluding the source copy of an in-flight
      outbound handoff (it carries ``migration.toCell``; the window
      between the destination's bind and the source's retirement is the
      handshake working as designed, not a double-spend).
    - **no-route-to-open** is recorded by the runner via :meth:`record`
      — only the decision site knows the breaker state at decision
      time.

    Observes each cell's RAW client (never the chaos-wrapped one): the
    auditor sees ground truth even while the global plane is
    partitioned away from it.
    """

    def __init__(self, namespace: str = "default"):
        self.namespace = namespace
        self.violations: List[Violation] = []
        self._high: Dict[str, int] = {}
        # last restoredStep judged per key (judge each restore once)
        self._judged: Dict[str, int] = {}

    def record(self, invariant: str, step: int, detail: str) -> None:
        self.violations.append(Violation(invariant, step, detail))
        OPERATOR_METRICS.chaos_invariant_violations.labels(
            invariant=invariant).inc()

    def to_list(self) -> List[dict]:
        return [v.to_dict() for v in self.violations]

    @property
    def acked_high_water(self) -> Dict[str, int]:
        return dict(self._high)

    def observe(self, step: int, cells: Dict[str, Client]) -> None:
        from ..api import labels as L
        from ..api.slicerequest import KIND_SLICE_REQUEST, V1ALPHA1

        placed_in: Dict[str, List[str]] = {}
        for cell_name in sorted(cells):
            client = cells[cell_name]
            for cr in client.list(V1ALPHA1, KIND_SLICE_REQUEST,
                                  ListOptions(namespace=self.namespace)):
                ns = get_nested(cr, "metadata", "namespace") or "default"
                key = f"{ns}/{name_of(cr)}"
                mig = get_nested(cr, "status", "migration",
                                 default={}) or {}
                # the high-water is built from ACK points only — the
                # steps a workload declared durably checkpointed for a
                # handoff. The live checkpointedStep is deliberately
                # excluded: a resumed twin trains past its restore
                # point immediately, and holding yesterday's
                # restoredStep against today's progress would flag the
                # recovery working as designed.
                acked = [mig.get("ackedStep"),
                         (get_nested(cr, "metadata", "annotations",
                                     default={}) or {}).get(
                             L.SLICE_INTENT_ACK)]
                for val in acked:
                    try:
                        val = int(val)
                    except (TypeError, ValueError):
                        continue
                    if val > self._high.get(key, -1):
                        self._high[key] = val
                restored = mig.get("restoredStep")
                try:
                    restored = int(restored)
                except (TypeError, ValueError):
                    restored = None
                # judge each restore once, when it appears (or moves):
                # the marker is historical and must not be re-tried
                # against high-waters acked after it
                if restored is not None \
                        and self._judged.get(key) != restored:
                    self._judged[key] = restored
                    if restored < self._high.get(key, -1):
                        self.record(
                            "no-lost-work-cross-cell", step,
                            f"{key} restored at step {restored} in "
                            f"{cell_name}, below the acked high-water "
                            f"{self._high[key]}")
                if get_nested(cr, "status", "phase") == "Placed" \
                        and not mig.get("toCell"):
                    placed_in.setdefault(key, []).append(cell_name)
        for key, where in sorted(placed_in.items()):
            if len(where) > 1:
                self.record(
                    "single-binding", step,
                    f"{key} Placed in {len(where)} cells at once: "
                    f"{sorted(where)}")


def namespace_key(obj: dict) -> str:
    return get_nested(obj, "metadata", "namespace", default="") or ""


def canonical_settled_state(client: Client, namespace: str) -> dict:
    """The restart-coherent invariant's comparison object: a canonical,
    clock-free projection of everything the operator owes the user at
    settle — which requests run, at what size, with sound leases, on a
    converged fleet. A crashed-and-restored run must produce this dict
    byte-for-byte equal (via its sorted-JSON digest) to a never-crashed
    run of the same seed.

    Deliberately excluded: resourceVersions and write counts (a restart
    legally re-writes), eviction/migration tallies and exact node
    assignments (a crash may legally shift WHICH equivalent nodes serve
    a slice — placement-sound and no-lost-work hold those paths to
    account), and requeue/backoff bookkeeping."""
    from ..api.slicerequest import (
        KIND_SLICE_REQUEST,
        MIG_TERMINAL,
        V1ALPHA1,
        SliceRequestSpec,
    )

    nodes = {name_of(n): n for n in client.list("v1", "Node")}
    requests = sorted(client.list(V1ALPHA1, KIND_SLICE_REQUEST),
                      key=lambda r: (namespace_key(r), name_of(r)))
    rows = []
    owners = set()
    for req in requests:
        key = f"{namespace_key(req) or 'default'}/{name_of(req)}"
        owners.add(key)
        bound = sorted(get_nested(req, "status", "nodes",
                                  default=[]) or [])
        sound = True
        for node_name in bound:
            node = nodes.get(node_name)
            lease = (get_nested(node, "metadata", "annotations",
                                default={}) or {}).get(L.PLACED_BY) \
                if node is not None else None
            if lease != key:
                sound = False
        rows.append({
            "name": f"{namespace_key(req)}/{name_of(req)}",
            "phase": get_nested(req, "status", "phase") or "",
            "chips": SliceRequestSpec.from_obj(req).chips_needed(),
            "nodes_bound": len(bound),
            "leases_sound": sound,
            "migration_terminal":
                (get_nested(req, "status", "migration", "phase") or "")
                in MIG_TERMINAL,
        })
    orphan_leases = 0
    gpu_nodes = ready = rolled = 0
    for node_name in sorted(nodes):
        node = nodes[node_name]
        lease = (get_nested(node, "metadata", "annotations",
                            default={}) or {}).get(L.PLACED_BY)
        if lease and lease not in owners:
            orphan_leases += 1
        if not L.is_gpu_node(node):
            continue
        gpu_nodes += 1
        conds = get_nested(node, "status", "conditions",
                           default=[]) or []
        if any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in conds):
            ready += 1
        if labels_of(node).get(L.UPGRADE_STATE) in (None, STATE_DONE):
            rolled += 1
    crs = client.list(V1, KIND_CLUSTER_POLICY)
    return {
        "requests": rows,
        "fleet": {"gpu_nodes": gpu_nodes, "ready": ready,
                  "rolled": rolled, "orphan_leases": orphan_leases},
        "policy_ready": bool(crs) and all(
            get_nested(cr, "status", "state") == "ready" for cr in crs),
    }


def settled_state_digest(state: dict) -> str:
    """sha256 over the canonical sorted-JSON serialization — the byte
    identity the restart-coherent invariant compares."""
    import hashlib
    import json

    blob = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()

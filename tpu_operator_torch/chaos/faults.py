"""Deterministic fault injection for the control plane.

The port's copy of ``tpu_operator/chaos/faults.py``. Fault kinds,
scenario names and every scenario's schedule are the reference's; the
rollout markers name a driver install dir where the reference's name
libtpu's (``/opt/chaos-driver`` for ``/opt/chaos-libtpu``).

Two halves:

- :class:`FaultPlan` — a seeded RNG materialized up-front into a
  reproducible schedule of :class:`Fault` events. Nothing draws from the
  RNG at run time, so the same (scenario, seed, node set, steps) always
  yields a byte-identical schedule — the property the determinism test
  pins (tests/test_chaos.py) and the property that makes a chaos failure
  reproducible from its verdict alone.
- :class:`ChaosClient` — a :class:`~tpu_operator_torch.runtime.client.Client`
  wrapper that injects apiserver-side faults into whatever client the
  controllers actually use: 409 conflict storms, 429 Retry-After
  throttles, transient 5xx, request latency (charged to a virtual
  clock, never a real sleep), and dropped watch streams healed the way
  a real informer heals them — 410 Gone, then relist (the underlying
  ``watch()`` replays ADDED for every live object).

Object-level faults (node NotReady flaps, chip disappearance, operand
pod crash-loops, node churn) are *adversary moves against the world*,
not apiserver behaviors, so they are applied by the runner directly
through the unwrapped inner client — see ``runner._apply_fault``.
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Callable, List, Optional, Sequence

from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.client import (
    Client,
    ConflictError,
    ListOptions,
    ServerUnavailableError,
    TooManyRequestsError,
)

# fault kinds consumed by ChaosClient (apiserver-side)
API_CONFLICT = "api-conflict"      # 409 on the next mutating request
API_THROTTLE = "api-throttle"      # 429 Retry-After on the next request
API_UNAVAILABLE = "api-5xx"        # 503 on the next request
API_LATENCY = "api-latency"        # virtual latency on the next requests
WATCH_DROP = "watch-drop"          # drop every stream; 410-then-relist

# fault kinds applied by the runner against cluster objects
NODE_FLAP = "node-flap"            # Ready=False on one node
NODE_HEAL = "node-heal"            # Ready=True again
NODE_ADD = "node-add"              # a GPU node joins
NODE_REMOVE = "node-remove"        # a GPU node (and its pods) vanishes
CHIP_LOSS = "chip-loss"            # health engine reports chips missing
CHIP_RESTORE = "chip-restore"      # chips come back
POD_CRASH = "pod-crash"            # an operand pod crash-loops
MUTATE_POLICY = "mutate-policy"    # spec edit the operator must apply
TRIGGER_ROLLOUT = "trigger-rollout"  # driver change -> fleet upgrade FSM
OPERAND_DRIFT = "operand-drift"    # out-of-band spec edit to a live operand
ANNOTATION_CLEAR = "annotation-clear"  # strip the spec-hash annotations
SLICE_REQUEST = "slice-request"    # a SliceRequest lands in the queue
SLICE_RESIZE = "slice-resize"      # spec.chips edit on a live SliceRequest
WORKLOAD_CRASH = "workload-crash"  # elastic shim dies mid-save (torn ckpt)
RESHARD_CRASH = "reshard-crash"    # elastic shim dies mid-shard-handoff
#                                    (torn re-shard manifest must roll
#                                    back to the finalized step); arg
#                                    "name@mismatch" instead bumps the
#                                    shim's layout version so the next
#                                    resize exercises the full-checkpoint
#                                    fallback arc
SHARD_KILL = "shard-kill"          # a reconcile shard's workers die;
#                                    queued keys must rehash losslessly
#                                    onto the survivors (count = shard id)
OPERATOR_CRASH = "operator-crash"  # the process dies mid-pass; the runner
#                                    rebuilds it from the latest snapshot
BROWNOUT_START = "brownout-start"  # apiserver brownout: lists fail and
#                                    watch streams die until the matching
BROWNOUT_END = "brownout-end"      # heal — controllers must serve stale
DIGEST_SEED = "digest-seed"        # every GPU node publishes an OK digest
DIGEST_DEGRADE = "digest-degrade"  # one FAIL digest publish on a node
#                                    (seeded per-chip temp ramp); arg may
#                                    be "@placed:N" — resolved at apply
#                                    time to the N-th node carrying a
#                                    placement lease (deterministic, and
#                                    guarantees the ramp hits a bound
#                                    slice); the resolution is pinned so
#                                    the whole ramp stays on one node
DIGEST_HEAL = "digest-heal"        # one OK digest publish on a node

# fault kinds consumed by the federation runner (chaos/federation.py);
# ``arg`` targets a CELL name, not a node
CELL_PARTITION_START = "cell-partition-start"  # one cell's apiserver
#                                    unreachable from the global plane:
#                                    contacts fail, the breaker opens —
#                                    but the cell keeps running inside
CELL_PARTITION_END = "cell-partition-end"      # the partition heals
DIGEST_STALE_START = "digest-stale-start"  # cell reachable, but its
#                                    digest publishes freeze (a wedged
#                                    publisher): the router must age-
#                                    discount, never trust the last words
DIGEST_STALE_END = "digest-stale-end"
ROUTER_CRASH = "router-crash"      # the global router dies mid-pass;
#                                    the runner rebuilds it from its
#                                    durable snapshot (restart-coherent)
ROUTER_SPLIT = "router-split"      # a shadow router is spawned from the
#                                    snapshot and fed the same digests
#                                    in seeded-permuted order; every
#                                    decision is compared (split-brain)


@dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``step`` indexes the runner's step loop;
    ``arg`` is a target node name or a marker value; ``count``/``seconds``
    parameterize the apiserver faults."""

    step: int
    kind: str
    arg: str = ""
    count: int = 0
    seconds: float = 0.0


class VirtualClock:
    """Monotonic virtual time: the runner advances it per step, latency
    faults charge it per request, and the upgrade FSM's deadlines read it
    (``UpgradeReconciler(now=clock)``) — so timeout behavior is part of
    the deterministic schedule, not the wall clock."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


@dataclass
class FaultPlan:
    scenario: str
    seed: int
    steps: int
    faults: List[Fault] = field(default_factory=list)

    def for_step(self, step: int) -> List[Fault]:
        return [f for f in self.faults if f.step == step]

    def schedule_json(self) -> str:
        """Stable serialization — the determinism contract's artifact."""
        return json.dumps(
            {"scenario": self.scenario, "seed": self.seed,
             "steps": self.steps,
             "faults": [asdict(f) for f in self.faults]},
            sort_keys=True)

    # -- schedule generation ------------------------------------------------

    @classmethod
    def build(cls, scenario: str, seed: int, node_names: Sequence[str],
              steps: int) -> "FaultPlan":
        """Materialize the schedule for a named scenario. ``node_names``
        must be the sorted GPU node list of the cluster under test (the
        runner passes it), so node-targeted faults are reproducible."""
        rng = random.Random(f"{scenario}:{seed}")
        nodes = list(node_names)
        build = {
            "conflict-storm": cls._conflict_storm,
            "watch-flap": cls._watch_flap,
            "node-churn": cls._node_churn,
            "upgrade-under-fire": cls._upgrade_under_fire,
            "chip-loss": cls._chip_loss,
            "operand-drift": cls._operand_drift,
            "dag-race": cls._dag_race,
            "placement-contention": cls._placement_contention,
            "placement-storm": cls._placement_storm,
            "slice-migrate": cls._slice_migrate,
            "shard-failover": cls._shard_failover,
            "operator-crash": cls._operator_crash,
            "apiserver-brownout": cls._apiserver_brownout,
            "chip-degrade": cls._chip_degrade,
            "saturation-storm": cls._saturation_storm,
            # federation scenarios: ``node_names`` is the sorted CELL
            # name list (the federation runner passes it)
            "cell-partition": cls._cell_partition,
            "stale-digest": cls._stale_digest,
            "split-brain-router": cls._split_brain_router,
        }.get(scenario)
        if build is None:
            raise ValueError(f"unknown chaos scenario {scenario!r}")
        faults = build(rng, nodes, steps)
        faults.sort(key=lambda f: (f.step, f.kind, f.arg))
        return cls(scenario=scenario, seed=seed, steps=steps, faults=faults)

    @staticmethod
    def _marker(rng: random.Random, prefix: str) -> str:
        return f"{prefix}-{rng.randrange(1_000_000)}"

    @classmethod
    def _conflict_storm(cls, rng, nodes, steps) -> List[Fault]:
        """Write 409s in bursts, with 429/503 sprinkled in, each burst
        paired with a spec mutation the operator must still land."""
        out: List[Fault] = []
        for step in range(steps):
            if step % 3 == 0:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 6)))
                out.append(Fault(step, MUTATE_POLICY,
                                 arg=cls._marker(rng, "storm")))
            if step % 5 == 2:
                out.append(Fault(step, API_THROTTLE,
                                 count=rng.randrange(1, 3),
                                 seconds=float(rng.randrange(1, 5))))
            if step % 7 == 3:
                out.append(Fault(step, API_UNAVAILABLE, count=1))
        return out

    @classmethod
    def _watch_flap(cls, rng, nodes, steps) -> List[Fault]:
        """Streams die repeatedly; every drop pairs with a mutation so a
        client that fails to relist demonstrably loses the event."""
        out: List[Fault] = []
        for step in range(steps):
            if step % 4 == 1:
                out.append(Fault(step, WATCH_DROP))
                out.append(Fault(step, MUTATE_POLICY,
                                 arg=cls._marker(rng, "flap")))
            if step % 6 == 4:
                out.append(Fault(step, API_LATENCY, count=rng.randrange(3, 8),
                                 seconds=0.5))
        return out

    @classmethod
    def _node_churn(cls, rng, nodes, steps) -> List[Fault]:
        """Nodes flap NotReady, join, and vanish mid-run."""
        out: List[Fault] = []
        join = 0
        for step in range(steps):
            if step % 4 == 0 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, NODE_FLAP, arg=victim))
                out.append(Fault(min(step + 2, steps - 1), NODE_HEAL,
                                 arg=victim))
            if step % 6 == 3:
                join += 1
                out.append(Fault(step, NODE_ADD, arg=f"chaos-join-{join}"))
            if step % 9 == 5 and len(nodes) > 1:
                # never remove a node scheduled to heal later
                flapped = {f.arg for f in out if f.kind == NODE_FLAP}
                candidates = [n for n in nodes if n not in flapped]
                if candidates:
                    victim = rng.choice(candidates)
                    nodes.remove(victim)
                    out.append(Fault(step, NODE_REMOVE, arg=victim))
        return out

    @classmethod
    def _upgrade_under_fire(cls, rng, nodes, steps) -> List[Fault]:
        """A fleet driver rollout, then every apiserver fault class plus
        node flaps while the FSM walks the cluster."""
        out: List[Fault] = [
            Fault(0, TRIGGER_ROLLOUT, arg=cls._marker(rng, "/opt/chaos-driver"))]
        for step in range(1, steps):
            if step % 3 == 1:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(1, 4)))
            if step % 5 == 2:
                out.append(Fault(step, WATCH_DROP))
            if step % 4 == 3 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, NODE_FLAP, arg=victim))
                out.append(Fault(min(step + 2, steps - 1), NODE_HEAL,
                                 arg=victim))
            if step % 7 == 4:
                out.append(Fault(step, API_THROTTLE, count=1,
                                 seconds=float(rng.randrange(1, 4))))
        return out

    @classmethod
    def _operand_drift(cls, rng, nodes, steps) -> List[Fault]:
        """A config-management adversary edits live operand specs
        out-of-band (the spec-hash annotation stays intact — the exact
        case an annotation-only skip is blind to) and strips the
        spec-hash annotations entirely; the operator must detect both
        and re-converge. ``count`` doubles as the deterministic victim
        index into the sorted DaemonSet list."""
        out: List[Fault] = []
        for step in range(steps):
            if step % 3 == 0:
                out.append(Fault(step, OPERAND_DRIFT,
                                 arg=cls._marker(rng, "drift"),
                                 count=rng.randrange(0, 16)))
            if step % 4 == 1:
                out.append(Fault(step, ANNOTATION_CLEAR,
                                 count=rng.randrange(0, 16)))
            if step % 5 == 3:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(1, 3)))
        return out

    @classmethod
    def _dag_race(cls, rng, nodes, steps) -> List[Fault]:
        """Operand-sync faults aimed at parallel DAG branches: 409/503
        bursts land mid-wave (the seeded virtual scheduler shuffles which
        branch eats them per seed), operand drift forces re-applies on
        one branch while siblings are mid-sync, and spec mutations keep
        every state re-rendering. The dag-order invariant must hold — no
        state may sync before all its ``requires()`` report ready —
        whichever branch the fault lands on."""
        out: List[Fault] = []
        for step in range(steps):
            if step % 2 == 0:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 3 == 0:
                out.append(Fault(step, MUTATE_POLICY,
                                 arg=cls._marker(rng, "race")))
            if step % 3 == 1:
                out.append(Fault(step, OPERAND_DRIFT,
                                 arg=cls._marker(rng, "race-drift"),
                                 count=rng.randrange(0, 16)))
            if step % 5 == 2:
                out.append(Fault(step, API_UNAVAILABLE, count=1))
            if step % 4 == 3:
                out.append(Fault(step, WATCH_DROP))
        return out

    @classmethod
    def _placement_contention(cls, rng, nodes, steps) -> List[Fault]:
        """More demand than chips: waves of SliceRequests (chip count in
        ``count``, priority in ``seconds``) land against a fleet that
        flaps NotReady and shrinks mid-bind, with 409 storms hitting the
        lease/status writes. The placement-sound and placement-stable
        invariants must hold through every storm, and once faults stop
        every request must sit in a terminal phase with consistent
        leases."""
        out: List[Fault] = []
        sizes = (4, 4, 8, 8, 16, 32)
        req = 0
        for step in range(steps):
            # a wave of requests every step: demand outruns the fleet
            # within the first few steps, so the scorer is packing a
            # contended pool for most of the run
            for _ in range(rng.randrange(2, 5)):
                req += 1
                out.append(Fault(step, SLICE_REQUEST,
                                 arg=f"sreq-{req:03d}",
                                 count=rng.choice(sizes),
                                 seconds=float(rng.randrange(0, 3))))
            if step % 3 == 1:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 4 == 2 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, NODE_FLAP, arg=victim))
                out.append(Fault(min(step + 2, steps - 1), NODE_HEAL,
                                 arg=victim))
            if step % 5 == 3 and len(nodes) > 1:
                # a bound node vanishing is the explicit drain event the
                # eviction path exists for; never remove a node scheduled
                # to heal later
                flapped = {f.arg for f in out if f.kind == NODE_FLAP}
                candidates = [n for n in nodes if n not in flapped]
                if candidates:
                    victim = rng.choice(candidates)
                    nodes.remove(victim)
                    out.append(Fault(step, NODE_REMOVE, arg=victim))
        return out

    @classmethod
    def _placement_storm(cls, rng, nodes, steps) -> List[Fault]:
        """Batched-gang-placement stress: the whole demand wave lands
        Pending in the opening steps (2 requests per GPU node — 2k
        requests on a 1k-node fleet), so the controller's first passes
        drain deep batches against one shared index snapshot while nodes
        flap, join and vanish and watch drops force the index through
        its relist/resync healing. The index-coherence invariant then
        holds the O(delta) view to a from-scratch rescan at settle."""
        out: List[Fault] = []
        sizes = (4, 4, 8, 8, 16, 32)
        flood = max(24, 2 * len(nodes))
        front = max(1, min(3, steps))
        for i in range(flood):
            out.append(Fault(i % front, SLICE_REQUEST,
                             arg=f"storm-{i:04d}",
                             count=rng.choice(sizes),
                             seconds=float(rng.randrange(0, 3))))
        join = 0
        for step in range(steps):
            if step % 3 == 1 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, NODE_FLAP, arg=victim))
                out.append(Fault(min(step + 2, steps - 1), NODE_HEAL,
                                 arg=victim))
            if step % 4 == 2:
                join += 1
                out.append(Fault(step, NODE_ADD, arg=f"storm-join-{join}"))
            if step % 5 == 3:
                out.append(Fault(step, WATCH_DROP))
            if step % 6 == 4:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 7 == 5 and len(nodes) > 1:
                # never remove a node scheduled to heal later
                flapped = {f.arg for f in out if f.kind == NODE_FLAP}
                candidates = [n for n in nodes if n not in flapped]
                if candidates:
                    victim = rng.choice(candidates)
                    nodes.remove(victim)
                    out.append(Fault(step, NODE_REMOVE, arg=victim))
        return out

    @classmethod
    def _saturation_storm(cls, rng, nodes, steps) -> List[Fault]:
        """Fair-share admission at ~10x chip oversubscription: the
        opportunist classes (``batch``/``research``) flood the fleet
        first and soak every chip, then the min-guaranteed ``prod``
        class arrives into a saturated cluster — at LOWER priority, so
        only the deficit-clock watchdog (never the baseline sort) can
        rescue it, via budgeted elastic preemption of the over-share
        incumbents. A few rigid (``rreq-*``) opportunists verify the
        drain routes around slices that cannot checkpoint. One seeded
        operator crash lands mid-rescue: deficit clocks and budget
        tokens must ride the snapshot, and the restart-coherent rerun
        demands the same settled state as a never-crashed run. Node
        capacity deliberately never changes — the fair-share math under
        audit, not churn survival."""
        out: List[Fault] = []
        sizes = (4, 8, 8, 16, 16)
        flood = max(24, 2 * len(nodes))
        front = max(1, min(2, steps))
        n = 0
        for i in range(flood):
            n += 1
            qclass = "batch" if i % 3 else "research"
            out.append(Fault(i % front, SLICE_REQUEST,
                             arg=f"ereq-sat-{n:04d}@{qclass}",
                             count=rng.choice(sizes),
                             seconds=float(rng.randrange(1, 3))))
        for _ in range(3):
            n += 1
            out.append(Fault(0, SLICE_REQUEST,
                             arg=f"rreq-sat-{n:04d}@batch",
                             count=rng.choice(sizes),
                             seconds=float(rng.randrange(1, 3))))
        prod_step = min(2, steps - 1)
        for _ in range(max(4, len(nodes) // 10)):
            n += 1
            out.append(Fault(prod_step, SLICE_REQUEST,
                             arg=f"ereq-sat-{n:04d}@prod",
                             count=rng.choice((4, 8)),
                             seconds=0.0))
        if steps > prod_step + 3:
            out.append(Fault(rng.randrange(prod_step + 2, steps - 1),
                             OPERATOR_CRASH))
        for step in range(steps):
            if step % 3 == 2:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 5 == 4:
                out.append(Fault(step, WATCH_DROP))
        return out

    @classmethod
    def _slice_migrate(cls, rng, nodes, steps) -> List[Fault]:
        """Drain-safe migrate/resize under fire: elastic (``ereq-*``) and
        rigid (``rreq-*``) requests land in the opening steps, then a
        fleet rollout forces every placed slice through the migrate
        stage while 409 storms, watch drops, torn-checkpoint workload
        crashes, spec resizes and a node removal interleave. The
        no-acked-work-lost invariant must hold on every path — including
        the rigid requests' timeout → hard-drain degradation."""
        out: List[Fault] = []
        sizes = (4, 4, 8, 8, 16)
        n_elastic = n_rigid = 0
        for step in range(min(3, steps)):
            for _ in range(rng.randrange(2, 4)):
                if rng.random() < 0.7:
                    n_elastic += 1
                    name = f"ereq-{n_elastic:03d}"
                else:
                    n_rigid += 1
                    name = f"rreq-{n_rigid:03d}"
                out.append(Fault(step, SLICE_REQUEST, arg=name,
                                 count=rng.choice(sizes),
                                 seconds=float(rng.randrange(0, 3))))
        if n_rigid == 0:
            # the timeout degradation path is part of the contract; a
            # seed must not be able to roll it off the schedule
            n_rigid = 1
            out.append(Fault(0, SLICE_REQUEST, arg="rreq-001",
                             count=rng.choice(sizes)))
        rollout_step = min(3, steps - 1)
        out.append(Fault(rollout_step, TRIGGER_ROLLOUT,
                         arg=cls._marker(rng, "/opt/elastic-driver")))
        removed = False
        for step in range(rollout_step + 1, steps):
            if step % 3 == 1:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 4 == 2 and n_elastic:
                out.append(Fault(
                    step, WORKLOAD_CRASH,
                    arg=f"ereq-{rng.randrange(1, n_elastic + 1):03d}"))
            if step % 5 == 3:
                idx = rng.randrange(1, n_elastic + n_rigid + 1)
                name = (f"ereq-{idx:03d}" if idx <= n_elastic
                        else f"rreq-{idx - n_elastic:03d}")
                out.append(Fault(step, SLICE_RESIZE, arg=name,
                                 count=rng.choice(sizes)))
            if step % 5 == 4:
                out.append(Fault(step, WATCH_DROP))
            if not removed and step % 6 == 5 and len(nodes) > 4:
                # a bound node vanishing mid-handshake: the eviction
                # path must retire the in-flight attempt cleanly
                victim = rng.choice(nodes)
                nodes.remove(victim)
                out.append(Fault(step, NODE_REMOVE, arg=victim))
                removed = True
        # live-resharding arcs (appended AFTER the loop so the rng draw
        # sequence above is untouched): seeded mid-shard-handoff kills —
        # the torn re-shard manifest must roll back to the finalized
        # step — plus one deterministic layout-version mismatch so every
        # seed also exercises the full-checkpoint fallback path
        if n_elastic:
            for step in range(rollout_step + 1, steps):
                if step % 7 == 6:
                    out.append(Fault(
                        step, RESHARD_CRASH,
                        arg=f"ereq-{rng.randrange(1, n_elastic + 1):03d}"))
            out.append(Fault(min(rollout_step + 2, steps - 1),
                             RESHARD_CRASH, arg="ereq-001@mismatch"))
        return out

    @classmethod
    def _operator_crash(cls, rng, nodes, steps) -> List[Fault]:
        """Crash-safe instant restart: the slice-migrate opening (elastic
        and rigid requests, then a fleet rollout forcing every placed
        slice through the migrate stage), with the operator process
        killed at seeded points — once right after the rollout posts
        migrate intents (mid-migration) and once with a same-step gang
        wave half-drained (mid-gang-batch). Each crash discards every
        queue, in-memory index and backoff counter; the successor warms
        from the last snapshot and must converge to the same settled
        state as a run that never crashed (restart-coherent), with no
        acked work lost."""
        out: List[Fault] = []
        sizes = (4, 4, 8, 8, 16)
        n_elastic = n_rigid = 0
        for step in range(min(3, steps)):
            for _ in range(rng.randrange(2, 4)):
                if rng.random() < 0.7:
                    n_elastic += 1
                    name = f"ereq-{n_elastic:03d}"
                else:
                    n_rigid += 1
                    name = f"rreq-{n_rigid:03d}"
                out.append(Fault(step, SLICE_REQUEST, arg=name,
                                 count=rng.choice(sizes),
                                 seconds=float(rng.randrange(0, 3))))
        if n_elastic == 0:
            # a crash mid-migration of an *elastic* slice is the
            # hardest path (checkpoint handshake in flight); pin one
            n_elastic = 1
            out.append(Fault(0, SLICE_REQUEST, arg="ereq-001",
                             count=rng.choice(sizes)))
        rollout_step = min(3, steps - 1)
        out.append(Fault(rollout_step, TRIGGER_ROLLOUT,
                         arg=cls._marker(rng, "/opt/crash-driver")))
        # crash #1: right after the rollout posts migrate intents
        crash1 = min(rollout_step + 1, steps - 1)
        out.append(Fault(crash1, OPERATOR_CRASH))
        # crash #2: a seeded later step, with a same-step request wave
        # so the gang batch is half-drained when the process dies
        if steps > crash1 + 2:
            crash2 = rng.randrange(crash1 + 2, steps - 1)
            for _ in range(3):
                n_elastic += 1
                out.append(Fault(crash2, SLICE_REQUEST,
                                 arg=f"ereq-{n_elastic:03d}",
                                 count=rng.choice(sizes)))
            out.append(Fault(crash2, OPERATOR_CRASH))
        for step in range(rollout_step + 1, steps):
            if step % 3 == 2:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 5 == 4:
                out.append(Fault(step, WATCH_DROP))
        return out

    @classmethod
    def _chip_degrade(cls, rng, nodes, steps) -> List[Fault]:
        """Fleet telemetry under fire: elastic slices land and train,
        every node starts publishing OK digests, then two telemetry
        stories run concurrently on the virtual clock. A *ramp* node
        (resolved at apply time to a node actually hosting a placed
        slice) publishes FAIL digests every step — after CONDEMN_AFTER
        consecutive publishes the scorer condemns it, the condition
        lands, and its slice must evict and re-place with no acked work
        lost. A *flap* node (a different placed node) alternates
        FAIL/FAIL/OK forever — its streak never sustains, so it must
        cause ZERO evictions (telemetry-no-flap-evict). Background 409s
        and watch drops make sure the digest fold rides the same
        delta/relist machinery as everything else."""
        out: List[Fault] = []
        sizes = (4, 4, 8)
        n_elastic = 0
        for step in range(min(3, steps)):
            for _ in range(rng.randrange(2, 4)):
                n_elastic += 1
                out.append(Fault(step, SLICE_REQUEST,
                                 arg=f"ereq-{n_elastic:03d}",
                                 count=rng.choice(sizes),
                                 seconds=float(rng.randrange(0, 3))))
        # everyone reports healthy before anyone degrades: the rollup
        # sees a full fleet, and the scorer's streaks start from OK
        out.append(Fault(min(3, steps - 1), DIGEST_SEED))
        ramp_start = min(4, steps - 1)
        for step in range(ramp_start, steps):
            # sustained temp ramp: FAIL every publish, never healing
            out.append(Fault(step, DIGEST_DEGRADE, arg="@placed:0",
                             seconds=float(90 + 2 * (step - ramp_start))))
            # flapping chip: two FAILs then an OK, forever — one short
            # of the condemn threshold on every cycle
            if (step - ramp_start) % 3 < 2:
                out.append(Fault(step, DIGEST_DEGRADE, arg="@placed:1",
                                 seconds=float(91)))
            else:
                out.append(Fault(step, DIGEST_HEAL, arg="@placed:1"))
            if step % 4 == 1:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(2, 5)))
            if step % 5 == 4:
                out.append(Fault(step, WATCH_DROP))
        return out

    @classmethod
    def _apiserver_brownout(cls, rng, nodes, steps) -> List[Fault]:
        """The apiserver browns out for a seeded window: every list
        fails and every watch stream dies, while the world keeps moving
        (spec mutations, node flaps the operator cannot see). The
        controllers must degrade to stale cached reads — no crash-loop,
        bounded staleness — and fully converge on the backlog once the
        window heals."""
        out: List[Fault] = [
            Fault(0, MUTATE_POLICY, arg=cls._marker(rng, "pre"))]
        start = min(2, steps - 1)
        end = min(start + max(2, steps // 3), steps - 1)
        out.append(Fault(start, BROWNOUT_START,
                         seconds=float(max(0, end - start))))
        out.append(Fault(end, BROWNOUT_END))
        for step in range(start, end):
            if (step - start) % 2 == 0:
                # a mutation the operator is blind to until the heal
                out.append(Fault(step, MUTATE_POLICY,
                                 arg=cls._marker(rng, "dark")))
            if (step - start) % 3 == 1 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, NODE_FLAP, arg=victim))
                out.append(Fault(min(end + 1, steps - 1), NODE_HEAL,
                                 arg=victim))
        for step in range(end, steps):
            # catch-up happens under mild conflict pressure, like a real
            # post-outage thundering herd
            if step % 3 == 0:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(1, 3)))
            if step == end + 1:
                out.append(Fault(step, MUTATE_POLICY,
                                 arg=cls._marker(rng, "post")))
        return out

    @classmethod
    def _shard_failover(cls, rng, nodes, steps) -> List[Fault]:
        """A fleet rollout keeps every reconcile shard churning bulk
        work, node flaps keep the health lane hot, and two of the four
        shards die mid-run — their queued keys must rehash losslessly
        onto the survivors (rendezvous hashing: only the dead shard's
        keys move). Convergence, all standing invariants and the
        lane-priority bound must hold through both failovers, and the
        verdict stays byte-identical per seed. Shard 0 is never a
        victim, so at least one shard always survives."""
        out: List[Fault] = [
            Fault(0, TRIGGER_ROLLOUT,
                  arg=cls._marker(rng, "/opt/shard-driver"))]
        kill_steps = sorted(rng.sample(range(2, max(4, steps - 2)), 2))
        for idx, kill_step in enumerate(kill_steps):
            # a same-step CR mutation lands first (faults sort by kind
            # within a step, "mutate-policy" < "shard-kill"), so its
            # watch events are queued on every controller when the shard
            # dies — the kill demonstrably rehashes in-flight keys, not
            # an empty queue. ``count`` seeds the victim preference; the
            # runner kills the busiest killable shard deterministically.
            out.append(Fault(kill_step, MUTATE_POLICY,
                             arg=cls._marker(rng, f"failover-{idx}")))
            out.append(Fault(kill_step, SHARD_KILL,
                             count=rng.randrange(1, 4)))
        join = 0
        for step in range(1, steps):
            if step % 3 == 1 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, NODE_FLAP, arg=victim))
                out.append(Fault(min(step + 2, steps - 1), NODE_HEAL,
                                 arg=victim))
            if step % 4 == 2:
                out.append(Fault(step, API_CONFLICT,
                                 count=rng.randrange(1, 4)))
            if step % 4 == 3:
                # labeled GPU nodes joining pass the policy controller's
                # label predicate on ADDED — live health-lane traffic
                # racing the rollout's bulk churn
                join += 1
                out.append(Fault(step, NODE_ADD,
                                 arg=f"failover-join-{join}"))
            if step % 5 == 4:
                out.append(Fault(step, WATCH_DROP))
        return out

    @classmethod
    def _chip_loss(cls, rng, nodes, steps) -> List[Fault]:
        """Chips disappear from health samples (allocatable drops), come
        back, and operand pods crash-loop in between."""
        out: List[Fault] = []
        for step in range(steps):
            if step % 4 == 0 and nodes:
                victim = rng.choice(nodes)
                out.append(Fault(step, CHIP_LOSS, arg=victim))
                out.append(Fault(min(step + 3, steps - 1), CHIP_RESTORE,
                                 arg=victim))
            if step % 5 == 2 and nodes:
                out.append(Fault(step, POD_CRASH, arg=rng.choice(nodes)))
            if step % 6 == 5:
                out.append(Fault(step, API_UNAVAILABLE, count=1))
        return out

    # -- federation scenarios (``nodes`` is the sorted CELL name list) -----

    @classmethod
    def _federation_load(cls, rng, cells, steps, prefix="freq",
                         front=2) -> List[Fault]:
        """Shared request load for the federation scenarios: elastic
        SliceRequests land on the GLOBAL queue across the opening steps
        and keep trickling, ~a third carrying a data-locality affinity
        (arg suffix ``@<cell>``) the router should honor while the cell
        stays competitive."""
        out: List[Fault] = []
        sizes = (4, 4, 8, 8)
        n = 0
        for step in range(steps):
            burst = rng.randrange(2, 5) if step < front else (
                1 if step % 2 == 0 else 0)
            for _ in range(burst):
                n += 1
                affinity = (rng.choice(cells)
                            if cells and rng.random() < 0.35 else "")
                out.append(Fault(step, SLICE_REQUEST,
                                 arg=f"{prefix}-{n:03d}@{affinity}",
                                 count=rng.choice(sizes)))
        return out

    @classmethod
    def _cell_partition(cls, rng, cells, steps) -> List[Fault]:
        """One cell drops off the global plane for a seeded window while
        request load keeps arriving. The breaker must open (no request
        routed to the Open cell — the no-route-to-open invariant), the
        cell's bound slices are left alone through the window, and past
        the condemnation horizon they migrate cross-cell with no acked
        work lost. A router crash lands mid-window: the rebuilt-from-
        snapshot router must carry the Open/backoff state forward, and
        the restart-coherent rerun must settle byte-identically."""
        out = cls._federation_load(rng, cells, steps)
        victim = rng.choice(cells) if cells else ""
        start = min(2, steps - 1)
        end = min(start + max(3, steps // 2), steps - 1)
        out.append(Fault(start, CELL_PARTITION_START, arg=victim,
                         seconds=float(max(0, end - start))))
        out.append(Fault(end, CELL_PARTITION_END, arg=victim))
        if steps > start + 2:
            out.append(Fault(rng.randrange(start + 1, end), ROUTER_CRASH))
        return out

    @classmethod
    def _stale_digest(cls, rng, cells, steps) -> List[Fault]:
        """One cell stays perfectly reachable but its digest publisher
        wedges: seq stops advancing while the cell's real capacity
        drains under routed load. The router must age-discount the
        frozen digest toward zero — a stale cell fades out of the score
        race — instead of stampeding capacity its last words promised."""
        out = cls._federation_load(rng, cells, steps)
        victim = rng.choice(cells) if cells else ""
        start = min(1, steps - 1)
        end = min(start + max(3, steps // 2), steps - 1)
        out.append(Fault(start, DIGEST_STALE_START, arg=victim,
                         seconds=float(max(0, end - start))))
        out.append(Fault(end, DIGEST_STALE_END, arg=victim))
        return out

    @classmethod
    def _split_brain_router(cls, rng, cells, steps) -> List[Fault]:
        """A shadow router is forked from the primary's snapshot and fed
        the same digest stream in seeded-permuted arrival order, with a
        cell partition thrown in so breaker transitions interleave with
        digest delivery. Every routing decision is cross-checked: any
        divergence is a violation — the arrival-order-independence
        property, run as chaos instead of a unit test."""
        out = cls._federation_load(rng, cells, steps)
        out.append(Fault(0, ROUTER_SPLIT))
        if cells and steps >= 4:
            victim = rng.choice(cells)
            start = min(3, steps - 1)
            end = min(start + 2, steps - 1)
            out.append(Fault(start, CELL_PARTITION_START, arg=victim,
                             seconds=float(max(0, end - start))))
            out.append(Fault(end, CELL_PARTITION_END, arg=victim))
        return out


# mutating verbs a 409 can hit (create 409s are AlreadyExists, a
# different controller path — conflict storms target RV'd writes)
_CONFLICT_VERBS = ("update", "update_status", "patch")


class ChaosClient(Client):
    """Client wrapper injecting armed apiserver faults into every verb.

    Faults are armed as a FIFO; each incoming request consumes the head
    fault if it applies to the request's verb (conflicts only hit RV'd
    writes, throttles/5xx hit anything, latency charges the virtual
    clock and lets the request through). With a synchronous runner the
    consumption order — and therefore the whole run — is deterministic.
    """

    def __init__(self, inner: Client, clock: Optional[VirtualClock] = None):
        self.inner = inner
        self.clock = clock
        self.injected: dict = {}            # kind -> count, for the verdict
        self._armed: List[Fault] = []
        self._watches: List[dict] = []
        self.brownout = False               # lists fail while set

    def set_brownout(self, on: bool) -> None:
        """Enter/exit apiserver brownout: while on, every ``list()``
        raises 503 — the informer cache's relists fail until its breaker
        trips into degraded mode. The runner pairs this with
        ``suspend_watch_streams()`` so reads AND streams are dark."""
        if on and not self.brownout:
            self.record(BROWNOUT_START)
        elif not on and self.brownout:
            self.record(BROWNOUT_END)
        self.brownout = on

    @property
    def supports_chunked_list(self) -> bool:
        # pass-through: list() forwards opts verbatim, so chunking works
        # iff the wrapped client chunks (the cache's relist then pages
        # through the fault injector, eating armed faults per page)
        return getattr(self.inner, "supports_chunked_list", False)

    # -- arming -------------------------------------------------------------

    def arm(self, fault: Fault) -> None:
        """Queue an apiserver fault: count N expands to N queued shots."""
        for _ in range(max(1, fault.count)):
            self._armed.append(fault)

    def record(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1
        OPERATOR_METRICS.chaos_faults_injected.labels(kind=kind).inc()

    def _intercept(self, verb: str) -> None:
        while self._armed:
            fault = self._armed[0]
            if fault.kind == API_LATENCY:
                self._armed.pop(0)
                self.record(API_LATENCY)
                if self.clock is not None:
                    self.clock.advance(fault.seconds)
                continue  # slow, not failed — let the request through
            if fault.kind == API_CONFLICT:
                if verb not in _CONFLICT_VERBS:
                    return  # head stays armed for the next RV'd write
                self._armed.pop(0)
                self.record(API_CONFLICT)
                raise ConflictError(
                    "chaos: the object has been modified; please apply "
                    "your changes to the latest version")
            if fault.kind == API_THROTTLE:
                self._armed.pop(0)
                self.record(API_THROTTLE)
                if self.clock is not None:
                    self.clock.advance(fault.seconds)
                raise TooManyRequestsError(
                    "chaos: too many requests", retry_after=fault.seconds)
            if fault.kind == API_UNAVAILABLE:
                self._armed.pop(0)
                self.record(API_UNAVAILABLE)
                raise ServerUnavailableError(
                    "chaos: the server is currently unable to handle "
                    "the request")
            return  # unknown armed kind: ignore defensively

    # -- Client verbs -------------------------------------------------------

    def get(self, api_version, kind, name, namespace=None,
            metadata_only=False):
        self._intercept("get")
        return self.inner.get(api_version, kind, name, namespace,
                              metadata_only=metadata_only)

    def list(self, api_version, kind, opts: Optional[ListOptions] = None):
        if self.brownout:
            raise ServerUnavailableError(
                "chaos: apiserver brownout — list unavailable")
        self._intercept("list")
        return self.inner.list(api_version, kind, opts)

    def create(self, obj):
        self._intercept("create")
        return self.inner.create(obj)

    def update(self, obj):
        self._intercept("update")
        return self.inner.update(obj)

    def update_status(self, obj):
        self._intercept("update_status")
        return self.inner.update_status(obj)

    def patch(self, api_version, kind, name, patch, namespace=None):
        self._intercept("patch")
        return self.inner.patch(api_version, kind, name, patch, namespace)

    def delete(self, api_version, kind, name, namespace=None):
        self._intercept("delete")
        return self.inner.delete(api_version, kind, name, namespace)

    @property
    def supports_watch_resume(self):
        return getattr(self.inner, "supports_watch_resume", False)

    def watch(self, api_version, kind, handler: Callable,
              since_rv=None) -> Callable:
        kw = {} if since_rv is None else {"since_rv": since_rv}
        entry = {"av": api_version, "kind": kind, "handler": handler,
                 "cancel": self.inner.watch(api_version, kind, handler,
                                            **kw)}
        self._watches.append(entry)

        def cancel():
            entry["cancel"]()
            if entry in self._watches:
                self._watches.remove(entry)

        return cancel

    def suspend_watch_streams(self) -> None:
        """Every active stream dies (the 410 Gone analog). Events
        published while suspended are genuinely lost to the controllers —
        the runner mutates cluster objects in exactly this window."""
        self.record(WATCH_DROP)
        for entry in self._watches:
            entry["cancel"]()

    def resume_watch_streams(self) -> None:
        """Re-establish every suspended stream — the underlying
        ``watch()`` replays ADDED for all live objects, which is exactly
        an informer relist. A client that skipped the relist would
        silently miss every event between drop and resubscribe; pairing
        drops with mutations in the plan makes that failure mode a
        convergence violation, not a mystery."""
        for entry in self._watches:
            entry["cancel"] = self.inner.watch(entry["av"], entry["kind"],
                                               entry["handler"])

    def drop_watch_streams(self) -> None:
        """Suspend + immediately resume: a plain stream reset."""
        self.suspend_watch_streams()
        self.resume_watch_streams()

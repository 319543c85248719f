"""Rate-limited reconcile workqueue with priority lanes.

The port's own copy of ``tpu_operator/runtime/workqueue.py``: the queue
encodes no accelerator fact, so it is the reference's line for line.

Mirrors the queue discipline the reference configures on its controllers
(controllers/clusterpolicy_controller.go:51-52,357): per-item exponential
backoff from 100 ms to 3 s, de-duplication of queued keys, and delayed
re-adds for requeue-after results.

Fleet-scale additions on top of the reference's flat FIFO:

* **Priority lanes** (``health`` > ``placement`` > ``bulk``). The
  enqueuer declares the lane (a controller's watch registration names
  it), and ``get`` always drains the highest-priority non-empty lane, so
  a node-health event never queues behind 10k items of rollout churn.
  A re-add of an already-queued key at a higher-priority lane *promotes*
  it. ``OPERATOR_QUEUE_LANES=0`` collapses everything into the single
  bulk FIFO — exactly the pre-lane behavior.
* **Write token bucket** (:class:`WriteBudget`): a shared
  ``OPERATOR_WRITE_QPS`` budget the manager threads every controller's
  apiserver writes through, so one storming controller can't starve the
  apiserver (client-side priority-and-fairness). ``qps<=0`` (the
  default) is unlimited — today's behavior.
* **Bounded backoff state**: the per-item failure map is capped
  (LRU-evicted) so a churning 10k-node fleet can't grow it without
  bound.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

#: Priority lanes, highest first. Dequeue order is strict: a queued
#: health item is always served before any placement item, which is
#: always served before any bulk item.
LANE_HEALTH = "health"
LANE_PLACEMENT = "placement"
LANE_BULK = "bulk"
LANES = (LANE_HEALTH, LANE_PLACEMENT, LANE_BULK)
_LANE_RANK = {lane: i for i, lane in enumerate(LANES)}

#: Cap on the causes carried per queued item: a coalescing storm on one
#: key must not grow an unbounded provenance list — beyond this the
#: earliest causes win (they are the ones that explain the re-run).
MAX_CAUSES = 8


@dataclass(frozen=True)
class Cause:
    """Provenance of one enqueue: which trace (if any) produced it, from
    which origin span/object, and why. Stamped by the enqueuer (watch
    handler, requeue path, failover transfer), merged on coalesce, and
    surfaced by :meth:`WorkQueue.get_with_info` so the reconcile's root
    trace can link back to the event that caused it."""

    reason: str
    origin: str = ""
    trace_id: int = -1

    def to_dict(self) -> dict:
        d: dict = {"reason": self.reason}
        if self.origin:
            d["origin"] = self.origin
        if self.trace_id >= 0:
            d["trace_id"] = self.trace_id
        return d


def env_lanes_enabled(env=None) -> bool:
    """Priority lanes default ON; OPERATOR_QUEUE_LANES=0 (or
    false/no/off) collapses every enqueue into the bulk FIFO — the
    escape hatch that restores the pre-lane single-queue ordering."""
    val = (env or os.environ).get("OPERATOR_QUEUE_LANES", "1")
    return str(val).strip().lower() not in ("0", "false", "no", "off")


class LaneGate:
    """Process-wide switch for workqueue priority lanes."""

    def __init__(self):
        self.enabled = env_lanes_enabled()


LANE_GATE = LaneGate()


def env_write_qps(env=None) -> float:
    """Shared apiserver write budget in writes/second; 0 (the default)
    means unlimited — the pre-budget behavior."""
    val = (env or os.environ).get("OPERATOR_WRITE_QPS", "0")
    try:
        return float(val)
    except (TypeError, ValueError):
        return 0.0


class WriteBudget:
    """Token-bucket rate limit on apiserver writes, shared across
    controllers (the manager hands every controller the same instance).

    ``acquire()`` blocks until a token is available and returns the
    seconds it waited; with ``qps <= 0`` it is a free no-op, restoring
    today's unthrottled behavior exactly. ``burst`` defaults to one
    second's worth of tokens (min 1), so a quiet controller can absorb a
    short write burst without queueing."""

    def __init__(self, qps: float, burst: Optional[float] = None):
        self.qps = float(qps)
        self.burst = float(burst) if burst is not None else max(1.0, self.qps)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()
        # total seconds callers spent blocked on this budget — the
        # client_write_throttle_seconds observable
        self.throttled_seconds = 0.0

    def acquire(self) -> float:
        """Take one token, blocking until available; returns seconds
        waited (0.0 when a token was free or the budget is unlimited)."""
        if self.qps <= 0:
            return 0.0
        waited = 0.0
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    self.throttled_seconds += waited
                    return waited
                need = (1.0 - self._tokens) / self.qps
            time.sleep(need)
            waited += need


class RateLimiter:
    """Per-item exponential backoff: base * 2**failures, capped at max.

    The failure map is bounded: beyond ``max_tracked`` distinct items the
    least-recently-bumped entry is evicted (treated as forgotten). On a
    churning 10k-node fleet the old unbounded map was a slow leak — every
    key that ever failed stayed resident until an explicit ``forget``."""

    def __init__(self, base: float = 0.1, max_delay: float = 3.0,
                 max_tracked: int = 4096):
        self.base = base
        self.max_delay = max_delay
        self.max_tracked = max_tracked
        self._failures: dict[Any, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Any) -> float:
        with self._lock:
            # pop+reinsert keeps dict insertion order ~= recency, so the
            # eviction below drops the coldest key, not the hottest
            n = self._failures.pop(item, 0)
            self._failures[item] = n + 1
            while len(self._failures) > self.max_tracked:
                self._failures.pop(next(iter(self._failures)))
        return min(self.base * (2 ** n), self.max_delay)

    def forget(self, item: Any) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def retries(self, item: Any) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def tracked(self) -> int:
        """Distinct items currently holding backoff state."""
        with self._lock:
            return len(self._failures)


@dataclass(frozen=True)
class QueueSnapshot:
    """Point-in-time view of a WorkQueue (``WorkQueue.snapshot()``): what is
    queued, what a worker holds, and what is parked with its due time
    (``time.monotonic`` clock). Lets callers like ``Controller.wait_idle``
    reason about idleness without touching queue internals."""

    queued: tuple
    processing: tuple
    delayed: tuple  # of (due_monotonic, item)

    def idle(self, horizon: Optional[float] = None) -> bool:
        """True when nothing is queued or in flight. With ``horizon``,
        delayed items due more than ``horizon`` seconds out don't count —
        a parked periodic resync shouldn't make the queue look busy."""
        if self.queued or self.processing:
            return False
        if horizon is None:
            return not self.delayed
        cut = time.monotonic() + horizon
        return not any(due <= cut for due, _ in self.delayed)


class WorkQueue:
    """Thread-safe delaying queue with dedup of pending items and
    priority lanes.

    Semantics match client-go's workqueue closely enough for our manager:
    an item queued while being processed is re-queued when done; duplicate
    adds collapse. Multiple consumers are safe — ``get``'s processing set
    plus ``add``'s dirty marking give per-item serialization however many
    workers drain the queue. ``add(item, lane=...)`` files the item under
    a priority lane; ``get`` serves lanes strictly highest-first.
    """

    def __init__(self, rate_limiter: Optional[RateLimiter] = None,
                 on_coalesced: Optional[Callable[[], None]] = None):
        self.rate_limiter = rate_limiter or RateLimiter()
        self._cond = threading.Condition()
        self._queues: dict[str, deque] = {lane: deque() for lane in LANES}
        self._pending: set = set()
        self._processing: set = set()
        self._dirty: set = set()
        self._delayed: list[tuple[float, int, Any, str, Any]] = []
        self._enqueued_at: dict[Any, float] = {}
        # lane assignment of every pending/dirty item (popped with it)
        self._lane: dict[Any, str] = {}
        # cause list (capped at MAX_CAUSES) of every pending/dirty item;
        # coalesced re-adds merge into it, get_with_info pops it
        self._causes: dict[Any, tuple] = {}
        self._seq = 0
        self._shutdown = False
        self._frozen = False
        # queue latency of the most recently dequeued item (seconds spent
        # between add and get) — the workqueue_queue_duration observable
        self.last_wait = 0.0
        self.last_lane = LANE_BULK
        # enqueues absorbed by dedup: the item was already queued, or
        # already marked dirty behind an in-flight processing slot. The
        # callback (Controller wires the per-controller Prometheus
        # counter) runs under the queue lock — it must stay cheap.
        self.coalesced_total = 0
        self.on_coalesced = on_coalesced
        # lane escalations served via escalate() — the admission
        # starvation watchdog's deficit-driven promotions
        self.escalations_total = 0

    @staticmethod
    def _resolve_lane(lane: Optional[str]) -> str:
        if lane is None or lane not in _LANE_RANK or not LANE_GATE.enabled:
            return LANE_BULK
        return lane

    def _coalesced_locked(self) -> None:
        self.coalesced_total += 1
        if self.on_coalesced is not None:
            try:
                self.on_coalesced()
            except Exception:
                pass  # an observer must never poison the queue lock

    def _note_lane_locked(self, item: Any, lane: str) -> None:
        """Record/raise the lane of a dirty or pending item: a
        higher-priority re-add wins (a health event for a key already
        dirty as bulk must re-run at health urgency)."""
        cur = self._lane.get(item)
        if cur is None or _LANE_RANK[lane] < _LANE_RANK[cur]:
            self._lane[item] = lane

    def _stamp_cause_locked(self, item: Any, cause: Any) -> None:
        """Merge ``cause`` (a Cause, or an iterable of them — the
        failover-transfer path re-adds a whole list) into the item's
        bounded cause tuple. Earliest causes win past the cap; exact
        duplicates collapse."""
        if cause is None:
            return
        causes = (cause,) if isinstance(cause, Cause) else tuple(cause)
        cur = self._causes.get(item, ())
        for c in causes:
            if len(cur) >= MAX_CAUSES:
                break
            if c not in cur:
                cur = cur + (c,)
        if cur:
            self._causes[item] = cur

    def _enqueue_locked(self, item: Any, lane: str, now: float) -> None:
        self._pending.add(item)
        self._lane[item] = lane
        self._enqueued_at.setdefault(item, now)
        self._queues[lane].append(item)
        self._cond.notify()

    def add(self, item: Any, lane: Optional[str] = None,
            cause: Any = None) -> bool:
        """Enqueue (or coalesce) the item. Returns True when this add
        genuinely bought a future reconcile the item did not already
        have — a fresh enqueue or the first dirty mark of an in-flight
        key — and False for a coalesced/promoted duplicate. Callers use
        the distinction for per-object timeline attribution: a merged
        duplicate keeps its cause (stamped either way) but should not
        produce another timeline entry."""
        lane = self._resolve_lane(lane)
        with self._cond:
            if self._shutdown:
                return False
            self._stamp_cause_locked(item, cause)
            if item in self._processing:
                fresh = item not in self._dirty
                # first re-add of an in-flight key buys exactly one
                # re-run (the dirty mark); further adds are coalesced
                if fresh:
                    self._dirty.add(item)
                else:
                    self._coalesced_locked()
                # queue-wait attribution: the re-run's wait clock starts
                # at the FIRST re-add, not when done() files the item —
                # setdefault keeps the earliest stamp under churn
                self._enqueued_at.setdefault(item, time.monotonic())
                self._note_lane_locked(item, lane)
                return fresh
            if item in self._pending:
                cur = self._lane.get(item, LANE_BULK)
                if _LANE_RANK[lane] < _LANE_RANK[cur]:
                    # lane promotion: the queued key just became urgent —
                    # move it so it stops waiting behind bulk churn
                    try:
                        self._queues[cur].remove(item)
                    except ValueError:  # pragma: no cover - defensive
                        pass
                    else:
                        self._lane[item] = lane
                        self._queues[lane].append(item)
                        self._cond.notify()
                self._coalesced_locked()
                return False
            self._enqueue_locked(item, lane, time.monotonic())
            return True

    def escalate(self, item: Any, cause: Any = None) -> bool:
        """Promote-or-enqueue the item onto the health lane. The
        starvation watchdog's entry point (deficit-driven lane
        escalation): a queued item moves ahead of placement/bulk churn
        via :meth:`add`'s lane-promotion path, an in-flight item gets
        its re-run marked health-urgent, an absent item is enqueued
        fresh. Returns :meth:`add`'s fresh-work verdict. No-ops lane
        routing (but still enqueues) when the lane gate is off."""
        with self._cond:
            self.escalations_total += 1
        return self.add(item, lane=LANE_HEALTH, cause=cause)

    def add_after(self, item: Any, delay: float,
                  lane: Optional[str] = None, cause: Any = None) -> None:
        if delay <= 0:
            self.add(item, lane=lane, cause=cause)
            return
        lane = self._resolve_lane(lane)
        with self._cond:
            if self._shutdown:
                return
            self._seq += 1
            heapq.heappush(
                self._delayed,
                (time.monotonic() + delay, self._seq, item, lane, cause))
            self._cond.notify()

    def add_rate_limited(self, item: Any, lane: Optional[str] = None,
                         cause: Any = None) -> None:
        self.add_after(item, self.rate_limiter.when(item), lane=lane,
                       cause=cause)

    def forget(self, item: Any) -> None:
        self.rate_limiter.forget(item)

    def _promote_delayed_locked(self) -> Optional[float]:
        """Move due delayed items into their lane; return wait until next."""
        now = time.monotonic()
        wait = None
        while self._delayed:
            due, _, item, lane, cause = self._delayed[0]
            if due <= now:
                heapq.heappop(self._delayed)
                self._stamp_cause_locked(item, cause)
                if item not in self._pending and item not in self._processing:
                    self._enqueue_locked(item, lane, now)
                elif item in self._processing:
                    if item in self._dirty:
                        self._coalesced_locked()
                    else:
                        self._dirty.add(item)
                    # same earliest-stamp rule as add(): the dirty
                    # re-run's wait starts when the delay expired
                    self._enqueued_at.setdefault(item, now)
                    self._note_lane_locked(item, lane)
                else:  # already pending: the promotion collapsed into it
                    self._coalesced_locked()
            else:
                wait = due - now
                break
        return wait

    def _pop_locked(self) -> Optional[tuple]:
        """(item, lane) from the highest-priority non-empty lane."""
        for lane in LANES:
            q = self._queues[lane]
            if q:
                return q.popleft(), lane
        return None

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Block for the next item; None on shutdown or timeout."""
        return self.get_with_info(timeout)[0]

    def get_with_wait(self, timeout: Optional[float] = None
                      ) -> tuple[Optional[Any], float]:
        """Like :meth:`get`, plus the seconds the returned item spent
        queued. Returns ``(None, 0.0)`` on shutdown or timeout."""
        item, waited, _, _ = self.get_with_info(timeout)
        return item, waited

    def get_with_info(self, timeout: Optional[float] = None
                      ) -> tuple[Optional[Any], float, str, tuple]:
        """Like :meth:`get`, plus the seconds the returned item spent
        queued, the lane it was served from, and the merged
        :class:`Cause` tuple stamped by its enqueuers. The shared
        ``last_wait`` field is racy under N workers — this per-item
        figure (computed under the lock) is what the queue-time
        histogram, the per-lane depth gauge, and the reconcile trace's
        root span carry. Returns ``(None, 0.0, "bulk", ())`` on shutdown
        or timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._frozen:
                    # frozen (shard being failed over): stop handing out
                    # items — they will be transferred — but keep
                    # accepting adds so no key racing the failover is lost
                    return None, 0.0, LANE_BULK, ()
                wait = self._promote_delayed_locked()
                popped = self._pop_locked()
                if popped is not None:
                    item, lane = popped
                    self._pending.discard(item)
                    self._lane.pop(item, None)
                    self._processing.add(item)
                    added = self._enqueued_at.pop(item, None)
                    causes = self._causes.pop(item, ())
                    waited = 0.0
                    if added is not None:
                        waited = time.monotonic() - added
                        self.last_wait = waited
                    self.last_lane = lane
                    return item, waited, lane, causes
                if self._shutdown:
                    return None, 0.0, LANE_BULK, ()
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None, 0.0, LANE_BULK, ()
                    wait = remaining if wait is None else min(wait, remaining)
                self._cond.wait(wait)

    def done(self, item: Any) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._pending:
                    lane = self._lane.pop(item, LANE_BULK)
                    self._enqueue_locked(item, lane, time.monotonic())

    def snapshot(self) -> QueueSnapshot:
        """Consistent point-in-time view of queued/processing/delayed.
        ``queued`` lists items in dequeue order (lane priority, FIFO
        within a lane)."""
        with self._cond:
            queued = tuple(item for lane in LANES
                           for item in self._queues[lane])
            return QueueSnapshot(
                queued=queued,
                processing=tuple(self._processing),
                delayed=tuple((due, item)
                              for due, _, item, _, _ in self._delayed))

    def lane_depths(self) -> dict[str, int]:
        """Items waiting per lane (queued + delayed) — the
        workqueue_lane_depth observable."""
        with self._cond:
            depths = {lane: len(self._queues[lane]) for lane in LANES}
            for _, _, _, lane, _ in self._delayed:
                depths[lane] = depths.get(lane, 0) + 1
            return depths

    def drain_pending(self) -> list[tuple[Any, str, tuple]]:
        """Atomically remove and return every not-in-flight item as
        ``(item, lane, causes)``, delayed and dirty included — the
        shard-failover transfer: a killed shard's queued keys are
        re-hashed onto the surviving shards with no key (and no cause
        provenance) lost. In-flight (processing) items are NOT returned;
        the caller must drain/join the shard's workers first to preserve
        per-key serialization."""
        with self._cond:
            out = [(item, lane, self._causes.get(item, ()))
                   for lane in LANES for item in self._queues[lane]]
            for lane in LANES:
                self._queues[lane].clear()
            for _, _, item, lane, cause in self._delayed:
                causes = self._causes.get(item, ())
                if cause is not None:
                    extra = ((cause,) if isinstance(cause, Cause)
                             else tuple(cause))
                    causes = causes + tuple(
                        c for c in extra if c not in causes)
                out.append((item, lane, causes[:MAX_CAUSES]))
            self._delayed.clear()
            for item in self._dirty:
                out.append((item, self._lane.get(item, LANE_BULK),
                            self._causes.get(item, ())))
            self._dirty.clear()
            self._pending.clear()
            self._enqueued_at.clear()
            self._lane.clear()
            self._causes.clear()
            return out

    def freeze(self) -> None:
        """Stop serving ``get`` (consumers see shutdown-style None) while
        still accepting adds. The shard-failover quiesce step: workers
        retire, in-flight items finish, late enqueues accumulate for
        ``drain_pending`` instead of being dropped."""
        with self._cond:
            self._frozen = True
            self._cond.notify_all()

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return (sum(len(q) for q in self._queues.values())
                    + len(self._delayed))

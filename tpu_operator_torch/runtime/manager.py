"""Controller manager: the mini controller-runtime.

The port's own copy of ``tpu_operator/runtime/manager.py``. At
``start()`` it attaches the fleet telemetry fold (``metrics/fleet.py``)
to the informer cache's delta listeners, after the restore and the
watch wiring, and detaches it at ``stop()``; ``/debug/fleet`` serves the
fold's snapshot. Its snapshots hold the cache and the placement index
a registered placement reconciler keeps, and the global router's
breaker ledgers when a reconciler carrying one (``FederationReconciler``)
is registered; a restore replays the SliceRequests' persisted requeue
attempts and hands the router its ledgers back
(``federation_restored``). ``/debug/quota`` answers once a reconciler
carrying admission is registered, and ``/debug/cells`` answers "not
configured" until a router is, as the reference's do. One fix: a
controller's
watches are registered at ``start()``, after the snapshot restore, where
the reference registers them in ``add_reconciler`` — its cache then
refuses the seed (an informer already subscribed) and a manager wired as
its CLI wires it never restores.

Plays the role of ctrl.NewManager and its controller wiring in NVIDIA's
entrypoint (cmd/gpu-operator/main.go:72-220): reconcilers register watches
with predicates, events map to requests on a rate-limited workqueue, worker
threads drive Reconcile, and the manager serves /healthz, /metrics and
the flight recorder at /debug/traces.

Two knobs NVIDIA's operator pins are open here:

* ``workers=N`` per controller (MaxConcurrentReconciles analog; NVIDIA's
  pins 1, clusterpolicy_controller.go:357). Per-key serialization is preserved however many workers
  drain the queue — the WorkQueue's processing/dirty sets guarantee a key
  is never reconciled by two workers at once.
* Reads can be served from an informer-backed cache instead of
  read-through: wrap the client in :class:`~.cache.CachedClient` before
  handing it to the manager and every controller Get/List is O(cache),
  with only writes reaching the apiserver.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, Optional

from ..metrics.operator_metrics import OPERATOR_METRICS
from .client import Client, WatchEvent
from .objects import get_nested, name_of, namespace_of
from .workqueue import (
    Cause,
    RateLimiter,
    WorkQueue,
    WriteBudget,
    env_write_qps,
)

log = logging.getLogger("tpu_operator_torch.manager")


def env_shards(env=None) -> int:
    """Reconcile-plane shard count (worker groups per controller).
    Defaults to 1 — one queue, one worker group: exactly the unsharded
    behavior. At K>1, reconcile keys hash across K independent
    queue+worker-group shards; per-key serialization holds because a key
    always maps to exactly one live shard."""
    try:
        n = int((env or os.environ).get("OPERATOR_SHARDS", "1"))
    except (TypeError, ValueError):
        return 1
    return max(1, n)


def shard_of(key: str, shards) -> int:
    """Deterministic key->shard assignment over the live shard list.

    Rendezvous (highest-random-weight) hashing with crc32 — NOT Python's
    randomized ``hash()``, and NOT ``crc32 % len``: a modulo would remap
    almost every key when the live set shrinks, letting a key in flight
    on a surviving shard be re-routed (and reconciled concurrently) on
    another. Under rendezvous hashing, killing a shard moves only the
    dead shard's keys; every key on a survivor keeps its shard, so the
    per-key serialization argument stays local to one WorkQueue."""
    best = None
    best_w = -1
    for s in shards:
        w = zlib.crc32(f"{s}:{key}".encode())
        if w > best_w:
            best, best_w = s, w
    return best if best is not None else 0


class ThrottledWriteClient:
    """Per-controller write gate over the manager's client: every write
    verb takes one token from the shared :class:`WriteBudget` before
    reaching the apiserver (client-side priority-and-fairness). Reads,
    watches and everything else pass straight through. Seconds spent
    blocked are counted per controller on
    ``client_write_throttle_seconds_total``."""

    _WRITE_VERBS = ("create", "update", "update_status", "patch",
                    "delete", "evict")

    def __init__(self, inner: Client, budget: WriteBudget, controller: str):
        self.inner = inner
        self.budget = budget
        self.controller = controller

    def _gate(self) -> None:
        waited = self.budget.acquire()
        if waited > 0:
            OPERATOR_METRICS.client_write_throttle.labels(
                controller=self.controller).inc(waited)

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in self._WRITE_VERBS and callable(attr):
            def gated(*args, **kwargs):
                self._gate()
                return attr(*args, **kwargs)
            return gated
        return attr


@dataclass(frozen=True)
class Request:
    name: str
    namespace: str = ""

    def __str__(self):
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


class Reconciler:
    """Implement ``reconcile(request) -> Result`` plus
    ``setup_controller(controller, manager)`` to register watches — the
    analog of SetupWithManager in the reference controllers."""

    name = "reconciler"

    def reconcile(self, request: Request) -> Result:  # pragma: no cover
        raise NotImplementedError

    def setup_controller(self, controller: "Controller",
                         manager: "Manager") -> None:  # pragma: no cover
        raise NotImplementedError


# -- predicates (controller-runtime predicate.Funcs analog) -----------------


def generation_changed(event: WatchEvent, old: Optional[dict]) -> bool:
    """True when spec generation changed (GenerationChangedPredicate,
    used on the primary CR watch, clusterpolicy_controller.go:366)."""
    if event.type in ("ADDED", "DELETED"):
        return True
    if old is None:
        return True
    return (get_nested(event.obj, "metadata", "generation")
            != get_nested(old, "metadata", "generation"))


def any_event(event: WatchEvent, old: Optional[dict]) -> bool:
    return True


def label_changed(*keys_or_prefixes: str):
    """Predicate firing when any of the given label keys (or ``prefix*``
    wildcards) change — the analog of the GPU-node label predicates in
    addWatchNewGPUNode (clusterpolicy_controller.go:256-341)."""

    def relevant(labels: dict) -> dict:
        out = {}
        for k, v in (labels or {}).items():
            for pat in keys_or_prefixes:
                if (pat.endswith("*") and k.startswith(pat[:-1])) or k == pat:
                    out[k] = v
        return out

    def pred(event: WatchEvent, old: Optional[dict]) -> bool:
        if event.type in ("ADDED", "DELETED"):
            return True
        new_labels = get_nested(event.obj, "metadata", "labels", default={}) or {}
        old_labels = get_nested(old or {}, "metadata", "labels", default={}) or {}
        return relevant(new_labels) != relevant(old_labels)

    return pred


def enqueue_object(event: WatchEvent) -> Iterable[Request]:
    yield Request(name=name_of(event.obj), namespace=namespace_of(event.obj))


def enqueue_owner(api_version: str, kind: str):
    """Map an owned object's event to its controller owner's request
    (handler.EnqueueRequestForOwner analog, clusterpolicy_controller.go:385).
    Owner references are same-namespace, so namespaced owner kinds inherit
    the event object's namespace; cluster-scoped owners get none."""
    from .objects import is_namespaced

    def mapper(event: WatchEvent) -> Iterable[Request]:
        ns = namespace_of(event.obj) if is_namespaced(kind) else ""
        for ref in get_nested(event.obj, "metadata", "ownerReferences",
                              default=[]) or []:
            if ref.get("apiVersion") == api_version and ref.get("kind") == kind:
                yield Request(name=ref.get("name", ""), namespace=ns)

    return mapper


def enqueue_constant(name: str, namespace: str = ""):
    def mapper(event: WatchEvent) -> Iterable[Request]:
        yield Request(name=name, namespace=namespace)

    return mapper


class Controller:
    """One reconciler + its watches + its sharded queues + worker groups.

    ``workers`` is the MaxConcurrentReconciles analog: N worker threads
    drain one queue. Distinct keys reconcile concurrently; the same key
    never does (WorkQueue's processing set defers a re-add of an in-flight
    key to its ``done``).

    ``shards`` (default: ``OPERATOR_SHARDS``, itself defaulting to 1)
    splits the queue into K independent shards, each with its own worker
    group of ``workers`` threads. Keys hash deterministically onto the
    *live* shard list, so per-key serialization survives sharding: one
    key, one shard, one queue's processing set. ``kill_shard`` models a
    worker-group failure — the dead shard's queued keys rehash onto the
    survivors with no key lost (and only after the dead workers have
    drained, so a key never runs on two shards at once)."""

    def __init__(self, name: str, reconciler: Reconciler, client: Client,
                 rate_limiter: Optional[RateLimiter] = None,
                 workers: int = 1, shards: Optional[int] = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.name = name
        self.reconciler = reconciler
        self.client = client
        self.workers = workers
        # the (kind) this controller's requests refer to, for per-object
        # timeline attribution; reconcilers that want timelines declare
        # ``primary_kind`` (e.g. "SliceRequest")
        self.timeline_kind = getattr(reconciler, "primary_kind", None)
        self.shards = env_shards() if shards is None else max(1, shards)
        rl = rate_limiter or RateLimiter(0.1, 3.0)
        coalesced = OPERATOR_METRICS.workqueue_coalesced.labels(
            controller=name).inc
        # one RateLimiter shared by every shard: backoff state is per
        # key, so it survives a key rehashing to another shard
        self.queues = [WorkQueue(rl, on_coalesced=coalesced)
                       for _ in range(self.shards)]
        self.queue = self.queues[0]  # unsharded-compat alias (shards=1)
        # routing state: _live is the ordered live-shard list keys hash
        # onto; _shard_lock makes route+add atomic so a kill_shard
        # transfer can't race an enqueue into the dying shard
        self._live: list[int] = list(range(self.shards))
        self._dead: set[int] = set()
        self._shard_lock = threading.Lock()
        self._watch_cancels: list[Callable[[], None]] = []
        # _last_seen feeds predicates their "old" object; watch events can
        # arrive from any publishing thread, so all access is under a lock
        self._last_seen: dict[tuple, dict] = {}
        self._seen_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._threads_by_shard: dict[int, list[threading.Thread]] = {
            i: [] for i in range(self.shards)}
        self._stopped = threading.Event()
        # reconcile counters shared by N workers: guarded, not bare ints
        self._stats_lock = threading.Lock()
        self.reconcile_errors = 0
        self.reconcile_total = 0

    def _count_reconcile(self, error: bool) -> None:
        with self._stats_lock:
            self.reconcile_total += 1
            if error:
                self.reconcile_errors += 1

    # -- shard routing ------------------------------------------------------

    def _queue_for_locked(self, req) -> WorkQueue:
        return self.queues[shard_of(str(req), self._live)]

    def enqueue(self, req: Request, lane: Optional[str] = None,
                cause: Optional[Cause] = None) -> None:
        """Route a request to its shard's queue under the declared lane,
        stamping the enqueue's :class:`Cause` (if any) onto the item and
        onto the object's timeline. Coalesced duplicates merge their
        cause into the queued item but add no timeline entry — a node
        storm fanning out to one key must not flood its ring."""
        with self._shard_lock:
            fresh = self._queue_for_locked(req).add(req, lane=lane,
                                                    cause=cause)
        if fresh and cause is not None and self.timeline_kind is not None:
            from .timeline import TIMELINE

            TIMELINE.record(self.timeline_kind, str(req), "enqueue",
                            {"controller": self.name,
                             "lane": lane or "bulk"},
                            causes=(cause,))

    def escalate(self, req: Request,
                 cause: Optional[Cause] = None) -> None:
        """Promote ``req`` onto the health lane wherever it currently
        sits (queued, delayed-behind-a-backoff, in flight, or absent) —
        the admission starvation watchdog's escalation entry. Rides
        :meth:`WorkQueue.escalate` so the promotion is counted."""
        with self._shard_lock:
            fresh = self._queue_for_locked(req).escalate(req, cause=cause)
        if fresh and cause is not None and self.timeline_kind is not None:
            from .timeline import TIMELINE

            TIMELINE.record(self.timeline_kind, str(req), "enqueue",
                            {"controller": self.name,
                             "lane": "health"},
                            causes=(cause,))

    def _requeue_after(self, req: Request, delay: float,
                       cause: Optional[Cause] = None) -> None:
        with self._shard_lock:
            self._queue_for_locked(req).add_after(req, delay, cause=cause)

    def _requeue_rate_limited(self, req: Request,
                              cause: Optional[Cause] = None) -> None:
        with self._shard_lock:
            self._queue_for_locked(req).add_rate_limited(req, cause=cause)

    def kill_shard(self, shard: int) -> int:
        """Fail one shard's worker group and rehash its keys onto the
        survivors. Returns the number of keys transferred. Ordering
        matters for the no-concurrent-same-key guarantee: freeze (stop
        handing out items), join the shard's workers (in-flight
        reconciles finish), THEN atomically reroute + transfer under the
        shard lock so no enqueue lands in the dead queue after the
        drain."""
        with self._shard_lock:
            if shard in self._dead or shard not in self._live:
                raise ValueError(f"shard {shard} is not live")
            if len(self._live) <= 1:
                raise ValueError("cannot kill the last live shard")
            self._dead.add(shard)
        dead_queue = self.queues[shard]
        dead_queue.freeze()  # keep accepting adds; stop handing out items
        for t in self._threads_by_shard.get(shard, ()):
            if t is not threading.current_thread():
                t.join(timeout=30.0)
        with self._shard_lock:
            self._live.remove(shard)
            moved = dead_queue.drain_pending()
            for item, lane, causes in moved:
                # the cause provenance rides the transfer, plus a marker
                # recording that the key crossed a shard failover
                self._queue_for_locked(item).add(
                    item, lane=lane,
                    cause=causes + (Cause(
                        reason="failover-transfer",
                        origin=f"{self.name}:shard{shard}"),))
        dead_queue.shutdown()
        self._update_depth_metrics()
        return len(moved)

    def live_shards(self) -> list[int]:
        with self._shard_lock:
            return list(self._live)

    def _update_depth_metrics(self) -> None:
        depth = 0
        lane_depths: dict[str, int] = {}
        for i, q in enumerate(self.queues):
            if i in self._dead:
                continue
            depth += len(q)
            for lane, n in q.lane_depths().items():
                lane_depths[lane] = lane_depths.get(lane, 0) + n
        OPERATOR_METRICS.workqueue_depth.labels(
            controller=self.name).set(depth)
        for lane, n in lane_depths.items():
            OPERATOR_METRICS.workqueue_lane_depth.labels(
                controller=self.name, lane=lane).set(n)

    def watch(self, api_version: str, kind: str,
              predicate: Callable[[WatchEvent, Optional[dict]], bool] = any_event,
              mapper: Callable[[WatchEvent], Iterable[Request]] = enqueue_object,
              lane: Optional[str] = None) -> None:
        """Register a watch. ``lane`` declares the priority lane every
        request mapped from this watch enqueues under (health >
        placement > bulk; default bulk) — e.g. a node-conditions watch
        declares ``health`` so its events preempt rollout churn."""
        def handler(event: WatchEvent):
            from .tracing import TRACER

            key = (api_version, kind, namespace_of(event.obj), name_of(event.obj))
            with self._seen_lock:
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
                    # the trace open on THIS thread (if any) is the
                    # reconcile whose write fired the event — the
                    # cross-controller causal link
                    origin_tr = TRACER.current_trace()
                    cause = Cause(
                        reason=f"watch:{event.type}",
                        origin=f"{kind}/{name_of(event.obj)}",
                        trace_id=(origin_tr.seq if origin_tr is not None
                                  else -1))
                for req in mapper(event):
                    self.enqueue(req, lane=lane, cause=cause)
                self._update_depth_metrics()
            except Exception:  # watch handlers must never kill the stream
                log.exception("[%s] watch handler failed for %s/%s",
                              self.name, kind, name_of(event.obj))

        self._watch_cancels.append(self.client.watch(api_version, kind, handler))

    def _worker(self, shard: int = 0):
        from .timeline import TIMELINE
        from .tracing import TRACER
        queue = self.queues[shard]
        while not self._stopped.is_set():
            req, waited, lane, causes = queue.get_with_info(timeout=0.5)
            if req is None:
                if shard in self._dead:
                    return  # shard killed: worker group retires
                continue
            OPERATOR_METRICS.workqueue_queue_duration.labels(
                controller=self.name).set(waited)
            OPERATOR_METRICS.workqueue_queue_latency.labels(
                controller=self.name).observe(waited)
            OPERATOR_METRICS.workqueue_lane_queue_latency.labels(
                lane=lane).observe(waited)

            def retry_cause(reason: str, tr) -> Optional[Cause]:
                if not TRACER.enabled:
                    return None
                return Cause(reason=reason, origin=self.name,
                             trace_id=tr.seq if tr is not None else -1)

            try:
                # the trace's root span opens here, at dequeue, carrying
                # the queue wait AND the cause chain the enqueuers
                # stamped; the reconciler's own wrapper (which also
                # covers direct-driven runs) sees a trace is active and
                # passes through. The duration *histogram* is observed
                # in that wrapper — once per reconcile on every path —
                # not here.
                with TRACER.trace(self.name, str(req), queue_wait_s=waited,
                                  causes=causes) as tr:
                    result = self.reconciler.reconcile(req)
                self._count_reconcile(error=False)
                if TIMELINE.enabled and self.timeline_kind is not None:
                    TIMELINE.record(
                        self.timeline_kind, str(req), "reconcile",
                        {"controller": self.name, "outcome": "ok",
                         "lane": lane}, causes=causes)
                # re-adds route through the live-shard mapping, not this
                # worker's queue: after a failover the key may belong to
                # a different shard than it was dequeued from
                if result and result.requeue_after > 0:
                    queue.forget(req)
                    self._requeue_after(req, result.requeue_after,
                                        cause=retry_cause("requeue-after",
                                                          tr))
                elif result and result.requeue:
                    # keep the failure count: repeated requeue=True must back
                    # off toward the 3s cap, like controller-runtime
                    self._requeue_rate_limited(
                        req, cause=retry_cause("requeue", tr))
                else:
                    queue.forget(req)
            except Exception:
                self._count_reconcile(error=True)
                log.exception("[%s] reconcile %s failed", self.name, req)
                if TIMELINE.enabled and self.timeline_kind is not None:
                    TIMELINE.record(
                        self.timeline_kind, str(req), "reconcile",
                        {"controller": self.name, "outcome": "error",
                         "lane": lane}, causes=causes)
                self._requeue_rate_limited(
                    req, cause=retry_cause("retry-backoff", None))
            finally:
                queue.done(req)
                self._update_depth_metrics()

    def start(self):
        for shard in range(self.shards):
            for i in range(self.workers):
                t = threading.Thread(
                    target=self._worker, kwargs={"shard": shard},
                    name=f"ctrl-{self.name}-s{shard}-{i}", daemon=True)
                t.start()
                self._threads.append(t)
                self._threads_by_shard[shard].append(t)

    def stop(self):
        self._stopped.set()
        for q in self.queues:
            q.shutdown()
        for cancel in self._watch_cancels:
            cancel()
        # join the workers: stop() returning must mean no reconcile is
        # still writing — a caller that starts a successor manager (or a
        # test snapshotting cluster state) needs quiescence, not just a
        # flag. Daemon threads + bounded join keep a wedged reconcile
        # from hanging shutdown forever.
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=30.0)
                if t.is_alive():  # pragma: no cover - wedged reconcile
                    log.warning("[%s] worker did not stop within 30s",
                                self.name)

    def wait_idle(self, timeout: float = 30.0,
                  horizon: Optional[float] = None) -> bool:
        """Test helper: wait until the queue fully drains (incl. delayed).
        With ``horizon``, delayed requeues due more than ``horizon``
        seconds out don't count as pending work — a steady-state
        controller parks a periodic resync (120s) that would otherwise
        make it never idle."""
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(self.queues[i].snapshot().idle(horizon=horizon)
                   for i in self.live_shards()):
                return True
            time.sleep(0.01)
        return False


class _HealthHandler(BaseHTTPRequestHandler):
    manager: "Manager" = None  # type: ignore

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        ctype = "text/plain; version=0.0.4"
        if url.path in ("/healthz", "/readyz"):
            body, code = b"ok", 200
        elif url.path == "/metrics":
            from ..metrics.registry import render_prometheus
            body, code = render_prometheus().encode(), 200
        elif url.path == "/debug/cache":
            import json

            cache = self.manager.find_cache()
            if cache is None:
                body = b'{"cached": false}'
            else:
                body = json.dumps({"cached": True, **cache.cache_stats()},
                                  sort_keys=True).encode()
            code = 200
            ctype = "application/json"
        elif url.path == "/debug/snapshot":
            import json

            from . import snapshot as snapshot_mod

            meta = snapshot_mod.snapshot_metadata(self.manager.snapshot_dir)
            meta["last_restore_in_memory"] = self.manager.last_restore
            body = json.dumps(meta, sort_keys=True).encode()
            code = 200
            ctype = "application/json"
        elif url.path == "/debug/traces":
            import json

            from .tracing import TRACER

            q = parse_qs(url.query)

            def one(key):
                vals = q.get(key)
                return vals[-1] if vals else None

            try:
                min_ms = (float(one("min_ms"))
                          if one("min_ms") is not None else None)
                limit = (int(one("limit"))
                         if one("limit") is not None else None)
            except ValueError:
                body, code = b'{"error": "min_ms/limit must be numbers"}', 400
            else:
                traces = TRACER.traces(controller=one("controller"),
                                       min_ms=min_ms,
                                       outcome=one("outcome"),
                                       limit=limit)
                body = json.dumps({"count": len(traces), "traces": traces},
                                  sort_keys=True).encode()
                code = 200
            ctype = "application/json"
        elif url.path == "/debug/timeline":
            import json
            import re

            from .timeline import TIMELINE

            q = parse_qs(url.query)

            def one(key):
                vals = q.get(key)
                return vals[-1] if vals else None

            kind, name = one("kind"), one("name")
            # kind is a bare identifier; name may carry a namespace/
            # prefix. Anything else (empty, missing, control chars) is a
            # client error, reported as JSON like /debug/traces does.
            if (not kind or not name
                    or not re.fullmatch(r"[A-Za-z0-9._-]+", kind)
                    or not re.fullmatch(r"[A-Za-z0-9._/-]+", name)):
                body = (b'{"error": "kind and name are required '
                        b'(kind=<Kind>&name=[ns/]<name>)"}')
                code = 400
            else:
                events = TIMELINE.timeline(kind, name)
                body = json.dumps(
                    {"kind": kind, "name": name, "count": len(events),
                     "events": events}, sort_keys=True).encode()
                code = 200
            ctype = "application/json"
        elif url.path == "/debug/fleet":
            import json

            from ..metrics.fleet import FLEET_TELEMETRY

            body = json.dumps(FLEET_TELEMETRY.snapshot(),
                              sort_keys=True).encode()
            code = 200
            ctype = "application/json"
        elif url.path == "/debug/quota":
            import json

            rec = self.manager.find_admission()
            if rec is None:
                body = b'{"configured": false, "classes": []}'
            else:
                body = json.dumps(rec.admission_report(),
                                  sort_keys=True).encode()
            code = 200
            ctype = "application/json"
        elif url.path == "/debug/cells":
            import json

            fed = self.manager.find_federation()
            if fed is None:
                body = b'{"cells": {}, "unrouted": [], "router": null}'
            else:
                body = json.dumps(fed.federation_report(),
                                  sort_keys=True).encode()
            code = 200
            ctype = "application/json"
        elif url.path == "/debug/slo":
            import json

            from ..metrics.slo import SLO_ENGINE

            q = parse_qs(url.query)
            vals = q.get("window")
            window = vals[-1] if vals else None
            try:
                window_s = float(window) if window is not None else None
                if window_s is not None and window_s <= 0:
                    raise ValueError(window)
            except ValueError:
                body = b'{"error": "window must be a positive number ' \
                       b'of seconds"}'
                code = 400
            else:
                report = SLO_ENGINE.evaluate(extra_window_s=window_s)
                body = json.dumps(report, sort_keys=True).encode()
                code = 200
            ctype = "application/json"
        else:
            body, code = b"not found", 404
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


class Manager:
    """Holds the client, the controllers, and the serving endpoints.

    With ``leader_elect=True`` the controllers only start once the Lease is
    won (cmd/gpu-operator/main.go --leader-elect analog); losing the lease
    invokes ``on_lost_leadership`` (default: hard process exit so the pod
    restarts and re-campaigns — the standard operator pattern)."""

    def __init__(self, client: Client, namespace: str = "gpu-operator",
                 health_port: Optional[int] = None,
                 leader_elect: bool = False,
                 on_lost_leadership: Optional[Callable[[], None]] = None,
                 write_qps: Optional[float] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_interval: Optional[float] = None):
        from . import snapshot as snapshot_mod

        self.client = client
        self.namespace = namespace
        self.controllers: list[Controller] = []
        self.health_port = health_port
        self._http: Optional[ThreadingHTTPServer] = None
        self.leader_elect = leader_elect
        self.elector = None
        self._on_lost = on_lost_leadership or self._default_on_lost
        # ONE token bucket for the whole manager: per-controller write
        # gates all draw from this shared budget (OPERATOR_WRITE_QPS;
        # <=0 = unlimited, the pre-budget behavior)
        qps = env_write_qps() if write_qps is None else write_qps
        self.write_budget = WriteBudget(qps)
        # durable snapshot plane (OPERATOR_SNAPSHOT_DIR unset = off):
        # warm-restore at start, jittered periodic writes, a final write
        # on clean shutdown
        self.snapshot_dir = (snapshot_mod.env_snapshot_dir()
                             if snapshot_dir is None else
                             (snapshot_dir or None))
        self.snapshot_interval = (snapshot_mod.env_snapshot_interval()
                                  if snapshot_interval is None
                                  else max(0.0, snapshot_interval))
        self.last_restore: Optional[dict] = None
        self._snapshot_stop = threading.Event()
        self._snapshot_thread: Optional[threading.Thread] = None
        # controllers whose watches wait for start(): registering a watch
        # subscribes the cache's informer, and a subscribed store refuses
        # the snapshot's seed, so start() restores first, then wires
        self._unwired: list[tuple[Reconciler, Controller]] = []
        self._started = False

    def find_cache(self):
        """The CachedClient in this manager's client chain, if any —
        tracing/throttling wrappers are unwrapped via their ``inner``
        links (the /debug/cache and cache-metrics source)."""
        from .cache import CachedClient

        c, hops = self.client, 0
        while c is not None and hops < 8:
            if isinstance(c, CachedClient):
                return c
            c = getattr(c, "inner", None)
            hops += 1
        return None

    def find_admission(self):
        """The reconciler carrying the admission layer (anything with an
        ``admission_report``), if any controller holds one — wrappers
        are unwrapped via their ``inner`` links, same as find_cache (the
        /debug/quota source)."""
        for ctrl in self.controllers:
            r, hops = getattr(ctrl, "reconciler", None), 0
            while r is not None and hops < 8:
                if callable(getattr(r, "admission_report", None)):
                    return r
                r = getattr(r, "inner", None)
                hops += 1
        return None

    def find_federation(self):
        """The reconciler carrying the global router (anything with a
        ``router_snapshot``), if any controller holds one — same
        unwrap discipline as find_admission (the /debug/cells
        source)."""
        for ctrl in self.controllers:
            r, hops = getattr(ctrl, "reconciler", None), 0
            while r is not None and hops < 8:
                if callable(getattr(r, "router_snapshot", None)):
                    return r
                r = getattr(r, "inner", None)
                hops += 1
        return None

    @staticmethod
    def _default_on_lost():  # pragma: no cover - process exit
        import os

        log.error("leadership lost; exiting for clean re-campaign")
        os._exit(1)

    def add_reconciler(self, reconciler: Reconciler,
                       rate_limiter: Optional[RateLimiter] = None,
                       workers: int = 1,
                       shards: Optional[int] = None) -> Controller:
        client = self.client
        if self.write_budget.qps > 0:
            client = ThrottledWriteClient(client, self.write_budget,
                                          reconciler.name)
            # reconcilers are constructed with the manager's client; when
            # the write budget is on, re-point them at their gated view so
            # their writes actually draw tokens (only when they hold the
            # exact manager client — a custom client stays untouched)
            if getattr(reconciler, "client", None) is self.client:
                reconciler.client = client
        ctrl = Controller(reconciler.name, reconciler, client,
                          rate_limiter, workers=workers, shards=shards)
        self.controllers.append(ctrl)
        if self._started:
            reconciler.setup_controller(ctrl, self)
        else:
            self._unwired.append((reconciler, ctrl))
        return ctrl

    # -- durable snapshots (runtime/snapshot.py) -----------------------------

    def _snapshot_index(self):
        """The FleetIndex a registered placement reconciler maintains,
        if any — captured alongside the cache stores."""
        for ctrl in self.controllers:
            idx = getattr(ctrl.reconciler, "fleet_index", None)
            if idx is not None:
                return idx
        return None

    def restore_from_snapshot(self) -> Optional[dict]:
        """Warm-restore: load the newest valid snapshot and seed the
        cache stores pre-watch, so the informers' subscribe replays fold
        only the delta. Returns the restore outcome (also recorded next
        to the snapshots and on ``snapshot_restores_total``)."""
        import time

        from . import snapshot as snapshot_mod

        cache = self.find_cache()
        if self.snapshot_dir is None or cache is None:
            return None
        outcome: dict = {"at": time.time(), "outcome": "missing"}
        try:
            snap = snapshot_mod.load_latest(self.snapshot_dir,
                                            now_wall=time.time())
            if snap is None:
                # nothing usable on disk: cold start (corrupt/stale files
                # were logged and skipped by load_latest)
                outcome["outcome"] = (
                    "discarded" if snapshot_mod.snapshot_files(
                        self.snapshot_dir) else "missing")
            else:
                summary = snapshot_mod.restore(cache, snap)
                outcome.update(summary)
                outcome["outcome"] = "restored"
                outcome["path"] = snap.get("_path", "")
                outcome["snapshot_written_at"] = snap["written_at"]
                # requeue state lived only in process memory: re-derive
                # the Unschedulable backoff positions from the persisted
                # status so a restart doesn't unleash a retry storm
                seeded = 0
                for skey, payload in snap.get("stores", {}).items():
                    if not skey.endswith("/SliceRequest"):
                        continue
                    for ctrl in self.controllers:
                        hook = getattr(ctrl.reconciler,
                                       "seed_requeue_state", None)
                        if callable(hook):
                            seeded += hook(payload.get("objects") or [])
                if seeded:
                    outcome["requeue_state_seeded"] = seeded
                # federation router state: breaker ledgers + held
                # digests, so a router restart mid-partition keeps its
                # Open/backoff decisions instead of re-hammering a
                # partitioned cell from a cold breaker
                fed_state = snapshot_mod.restore_federation(snap)
                fed = self.find_federation()
                if fed_state is not None and fed is not None:
                    if fed.adopt_router_state(fed_state):
                        outcome["federation_restored"] = True
        except Exception as exc:  # a bad restore must not block startup
            log.exception("snapshot restore failed; cold start")
            outcome["outcome"] = "failed"
            outcome["error"] = str(exc)
        OPERATOR_METRICS.snapshot_restores.labels(
            outcome=outcome["outcome"]).inc()
        snapshot_mod.record_restore(self.snapshot_dir, outcome)
        self.last_restore = outcome
        return outcome

    def write_snapshot_now(self) -> Optional[str]:
        """Capture cache + index and persist atomically. Returns the
        written path, or None when the plane is off / capture failed.

        Refuses to capture while the cache breaker is Degraded: the
        stores are then a stale view the breaker has already stopped
        trusting, but a snapshot written from them would carry a *fresh*
        ``written_at`` — restorable (and trusted) within
        OPERATOR_SNAPSHOT_MAX_AGE long after the staleness it embalmed.
        The previous (healthy-epoch) snapshot on disk stays the restore
        candidate instead."""
        from . import snapshot as snapshot_mod

        cache = self.find_cache()
        if self.snapshot_dir is None or cache is None:
            return None
        if getattr(cache, "degraded", False):
            OPERATOR_METRICS.snapshot_writes.labels(
                outcome="skipped_degraded").inc()
            return None
        fed = self.find_federation()
        try:
            snap = snapshot_mod.capture(
                cache, index=self._snapshot_index(),
                federation=fed.router_snapshot() if fed is not None
                else None)
            path = snapshot_mod.write_snapshot(self.snapshot_dir, snap)
        except Exception:  # pragma: no cover - disk trouble is non-fatal
            log.exception("snapshot write failed")
            OPERATOR_METRICS.snapshot_writes.labels(outcome="failed").inc()
            return None
        OPERATOR_METRICS.snapshot_writes.labels(outcome="written").inc()
        OPERATOR_METRICS.snapshot_age_seconds.set(0)
        return path

    def _snapshot_loop(self):
        # jittered interval: a fleet of operators must not snapshot in
        # lockstep (same reasoning as the requeue jitter)
        import random

        while not self._snapshot_stop.is_set():
            delay = self.snapshot_interval * random.uniform(0.8, 1.2)
            if self._snapshot_stop.wait(timeout=delay):
                return
            self.write_snapshot_now()

    def start(self):
        self.restore_from_snapshot()
        self._started = True
        unwired, self._unwired = self._unwired, []
        for reconciler, ctrl in unwired:
            reconciler.setup_controller(ctrl, self)
        cache = self.find_cache()
        if cache is not None:
            # fleet telemetry plane: fold node health digests O(delta)
            # off the informer cache's delta listeners (never a poll)
            from ..metrics.fleet import FLEET_TELEMETRY

            try:
                FLEET_TELEMETRY.attach(cache)
            except Exception:
                log.exception("fleet telemetry attach failed")
        if (self.snapshot_dir is not None and self.snapshot_interval > 0
                and self.find_cache() is not None):
            self._snapshot_thread = threading.Thread(
                target=self._snapshot_loop, name="snapshot-writer",
                daemon=True)
            self._snapshot_thread.start()
        if self.health_port is not None:
            handler = type("H", (_HealthHandler,), {"manager": self})
            self._http = ThreadingHTTPServer(("0.0.0.0", self.health_port), handler)
            threading.Thread(target=self._http.serve_forever, daemon=True).start()
        if self.leader_elect:
            from .leaderelection import LeaderElector

            self.elector = LeaderElector(
                self.client, namespace=self.namespace,
                on_started_leading=self._start_controllers,
                on_stopped_leading=self._on_lost)
            self.elector.start()
        else:
            self._start_controllers()

    def _start_controllers(self):
        for ctrl in self.controllers:
            ctrl.start()

    def stop(self):
        # clean-shutdown snapshot first, while the cache is still live —
        # the next start's warm restore resumes from *this* state
        self._snapshot_stop.set()
        if self._snapshot_thread is not None:
            self._snapshot_thread.join(timeout=5.0)
        self.write_snapshot_now()
        if self.find_cache() is not None:
            # drop the singleton's cache listeners so a later manager
            # (tests, restart-in-process) attaches to a live cache only
            from ..metrics.fleet import FLEET_TELEMETRY

            FLEET_TELEMETRY.detach()
        # signal the client FIRST: a worker sleeping in the HTTP client's
        # 429 throttle-retry wait is interruptible only by client.close(),
        # and ctrl.stop() below joins that worker — closing after the
        # joins would turn each throttled reconcile into a full
        # Retry-After nap on the shutdown path (fake clients have no
        # connections and no close())
        if hasattr(self.client, "close"):
            self.client.close()
        for ctrl in self.controllers:
            ctrl.stop()
        if self.elector:
            self.elector.stop()
        if self._http:
            self._http.shutdown()
            self._http.server_close()

    def wait_idle(self, timeout: float = 30.0,
                  horizon: Optional[float] = None) -> bool:
        return all(c.wait_idle(timeout, horizon=horizon)
                   for c in self.controllers)

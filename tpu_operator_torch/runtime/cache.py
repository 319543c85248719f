"""Informer-backed client-side cache: the mini controller-runtime cache.

The port's own copy of ``tpu_operator/runtime/cache.py``; its one
accelerator fact is the node index, which keys on GKE's GPU accelerator
label (``cloud.google.com/gke-accelerator``) and files a node with
``nvidia.com/gpu`` capacity and no such label under ``UNLABELED_GPU``.

Plays the role of controller-runtime's shared informer cache:
``CachedClient`` wraps any
:class:`~tpu_operator_torch.runtime.client.Client` and serves ``get``/``list``
from per-(apiVersion, kind) watch-fed stores, so a steady-state reconcile
pass costs the apiserver *writes only* — O(states), not O(states × nodes).

Design, mapped to client-go:

* **Informer per kind, created lazily.** The first ``get``/``list``/
  ``watch`` of a (apiVersion, kind) subscribes a store-feeding watch on the
  inner client. The watch's initial ADDED replay doubles as the initial
  LIST (both the fake and the HTTP client replay current state on
  subscribe), so warming an informer costs exactly one list-equivalent.
* **resourceVersion-monotonic ingest.** Store upserts never move an object
  to an older resourceVersion — the guard that makes the replay/live-event
  race benign (the fake delivers the subscribe-time replay outside its
  store lock, so a newer MODIFIED can legally arrive before an older
  replayed ADDED).
* **Write-through.** Every write passes to the inner client and the
  returned (authoritative) object is upserted into the store, giving
  read-your-writes even while a watch is down: ``get`` after your own
  ``update`` never returns a staler resourceVersion.
* **Heal-by-relist.** A dropped-then-resumed watch replays ADDED for every
  live object. An ADDED for a key the store already holds at the *same*
  resourceVersion cannot happen on a healthy stream (creates mint fresh
  RVs; our own write echoes are recognised via the write-through ledger),
  so it is the signature of a resumed stream — the store marks itself
  dirty and the next read relists through the inner client and prunes
  keys that vanished during the gap (the 410-Gone relist analog).
* **Copy-free frozen reads.** Readers get the stored object itself as a
  recursively frozen view (``objects.freeze_obj``) — zero copies on the
  hot read path; an accidental in-place mutation raises
  ``FrozenObjectError`` instead of corrupting the shared store. Callers
  that edit a read result ``thaw_obj()`` it first (the same contract the
  inner clients now follow).
* **Pluggable indexes.** ``Index(name, key_func)`` per kind; built-ins
  cover pod-by-node, pod-by-owner-uid, node-by-accelerator-label, and an
  automatic by-label index that turns plain ``{k: v}`` label-selector
  lists into bucket intersections instead of full scans.
* **Index-only projections (fleet-scale memory bound).** For kinds with a
  registered projection (Node, Pod) the store keeps only the fields the
  reconcilers actually read — a 10k-node fleet no longer pays for
  ``status.images``/``volumesInUse``/full container specs it never looks
  at. Per-key measured bytes (projected AND what the full object would
  have cost) feed ``cache_store_bytes{kind}`` and ``/debug/cache``.
  ``OPERATOR_CACHE_PROJECTION=0`` stores full objects, exactly as before.
* **Chunked relists.** The 410-Gone heal pages through the inner client
  with ``ListOptions(limit=..., continue_=...)`` when it advertises
  ``supports_chunked_list``, so a fleet-wide relist never materializes
  every object at once; a non-blocking per-store guard means a
  watch-drop storm heals each store exactly once, with concurrent
  readers serving the (RV-monotonic, safe) current view instead of
  convoying behind the relist.

Everything above is threading-safe; driven from one thread it is also
fully deterministic.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from collections.abc import Mapping as _Mapping
from typing import Callable, Iterable, Optional

from ..api import labels as L
from .client import (
    Client,
    ListOptions,
    NotFoundError,
    WatchEvent,
    WatchGoneError,
)
from .objects import (
    FrozenDict,
    deepcopy_obj,
    freeze_obj,
    get_nested,
    is_namespaced,
    labels_of,
    match_labels,
    name_of,
    namespace_of,
    obj_key,
)


class Index:
    """A named secondary index: ``key_func(obj)`` yields the bucket keys the
    object files under (zero keys = not indexed). The analog of client-go's
    ``cache.Indexers`` entry."""

    def __init__(self, name: str, key_func: Callable[[dict], Iterable[str]]):
        self.name = name
        self.key_func = key_func

    def keys(self, obj: dict) -> tuple:
        return tuple(k for k in self.key_func(obj) if k)


# The automatic per-kind label index: one bucket per "key=value" label pair.
# A plain-dict label-selector list intersects its pairs' buckets instead of
# scanning the store.
BY_LABEL = "by-label"


def _label_pairs(obj: dict) -> Iterable[str]:
    return [f"{k}={v}" for k, v in labels_of(obj).items()]


def _pod_node(obj: dict) -> Iterable[str]:
    node = get_nested(obj, "spec", "nodeName")
    return [node] if node else []


def _owner_uids(obj: dict) -> Iterable[str]:
    return [r.get("uid") for r in
            get_nested(obj, "metadata", "ownerReferences", default=[]) or []
            if r.get("uid")]


#: Bucket for GPU nodes exposing nvidia.com/gpu capacity without the
#: accelerator label — keeps the by-accelerator bucket union equal to
#: the full GPU node set, so index-backed callers never miss an
#: unlabeled node.
UNLABELED_GPU = "(unlabeled)"


def _node_accelerator(obj: dict) -> Iterable[str]:
    accel = labels_of(obj).get(L.GKE_ACCELERATOR)
    if accel:
        return [accel]
    if get_nested(obj, "status", "allocatable", L.GPU_RESOURCE,
                  default=None):
        return [UNLABELED_GPU]
    return []


#: Secondary indexes installed on every informer of the matching kind
#: (callers can pass ``extra_indexes`` for more). The by-label index is
#: always installed and not listed here.
DEFAULT_INDEXES: dict[tuple, tuple] = {
    ("v1", "Pod"): (Index("by-node", _pod_node),
                    Index("by-owner-uid", _owner_uids)),
    ("v1", "Node"): (Index("by-accelerator", _node_accelerator),),
}


# ---------------------------------------------------------------------------
# Index-only projections: store what reconcilers read, drop the rest.
#
# The field sets below are the union of every cached read in the repo
# (grep get_nested over controllers/, topology/, validator/, state/):
#   Node — metadata (labels/annotations incl. upgrade FSM state), spec
#     (unschedulable), status.{conditions, capacity, allocatable, nodeInfo}.
#   Pod — metadata (labels/ownerReferences/deletionTimestamp), spec
#     {nodeName, containers[].resources.requests} (the drainable test),
#     status.{phase, conditions}.
# Everything else (managedFields, status.images, volume lists, full
# container specs, probes, env) is O(fleet) memory the control plane
# never looks at. Widening a projection is safe; narrowing one requires
# re-auditing the readers.
# ---------------------------------------------------------------------------


def env_projection_enabled(env=None) -> bool:
    """Cache field projection defaults ON; OPERATOR_CACHE_PROJECTION=0
    (or false/no/off) stores full objects — same spelling as the other
    kill switches."""
    import os

    val = (env or os.environ).get("OPERATOR_CACHE_PROJECTION", "1")
    return str(val).strip().lower() not in ("0", "false", "no", "off")


class ProjectionGate:
    """Process-wide switch for index-only cache projections. Disabled,
    every store holds full objects exactly as before — the escape hatch
    when a consumer reads a field the projection audit missed."""

    def __init__(self):
        self.enabled = env_projection_enabled()


PROJECTION_GATE = ProjectionGate()


def env_relist_chunk(env=None) -> int:
    """Page size for chunked relists (OPERATOR_RELIST_CHUNK, default 500);
    0 disables chunking and relists in one full list."""
    import os

    val = (env or os.environ).get("OPERATOR_RELIST_CHUNK", "500")
    try:
        return max(0, int(str(val).strip()))
    except ValueError:
        return 500


def _project_node(obj: dict) -> dict:
    status = obj.get("status") or {}
    slim = {k: v for k, v in obj.items() if k != "status"}
    slim["status"] = {k: status[k] for k in
                      ("phase", "conditions", "capacity", "allocatable",
                       "nodeInfo")
                      if k in status}
    return slim


def _slim_container(ctr: _Mapping) -> dict:
    out = {}
    if ctr.get("name"):
        out["name"] = ctr["name"]
    requests = get_nested(ctr, "resources", "requests", default=None)
    if requests:
        out["resources"] = {"requests": requests}
    return out


def _project_pod(obj: dict) -> dict:
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    slim = {k: v for k, v in obj.items() if k not in ("spec", "status")}
    slim_spec = {}
    if spec.get("nodeName"):
        slim_spec["nodeName"] = spec["nodeName"]
    if spec.get("containers"):
        slim_spec["containers"] = [_slim_container(c)
                                   for c in spec["containers"]]
    slim["spec"] = slim_spec
    slim["status"] = {k: status[k] for k in ("phase", "conditions")
                      if k in status}
    return slim


#: kind -> projection; applied at ingest when :data:`PROJECTION_GATE` is
#: on. Kinds without an entry (CRs, DaemonSets, ...) are stored full.
PROJECTIONS: dict[tuple, Callable[[dict], dict]] = {
    ("v1", "Node"): _project_node,
    ("v1", "Pod"): _project_pod,
}

logger = logging.getLogger("tpu_operator_torch.cache")

#: Consecutive failures after which a delta listener is detached — a
#: listener that throws on every delta is a dead consumer, and paying
#: an exception per store change forever is a slow leak.
LISTENER_DETACH_AFTER = 5

#: Consecutive relist/list failures after which the cache enters
#: Degraded mode: reads keep serving the (RV-monotonic, gap-stale)
#: cached view instead of surfacing apiserver errors to every
#: controller, and reconnects back off instead of hammering a browned-
#: out apiserver on every read.
DEGRADED_THRESHOLD = 3

#: Capped exponential backoff for degraded-mode reconnect attempts.
DEGRADED_BACKOFF_BASE_S = 1.0
DEGRADED_BACKOFF_CAP_S = 60.0


def measure_bytes(obj) -> int:
    """Approximate resident footprint of one stored object tree:
    recursive ``sys.getsizeof`` over dicts/lists/scalars (frozen views
    included). Shared/interned leaves count at every occurrence, so the
    number is a stable upper bound — what a bytes-per-node figure and
    ``/debug/cache``'s projected-vs-full comparison need,
    cheap enough to run on every ingest."""
    size = sys.getsizeof(obj)
    if isinstance(obj, _Mapping):
        for k, v in obj.items():
            size += measure_bytes(k) + measure_bytes(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            size += measure_bytes(v)
    return size


def _rv_int(obj: Optional[dict]) -> Optional[int]:
    rv = get_nested(obj or {}, "metadata", "resourceVersion")
    try:
        return int(rv)
    except (TypeError, ValueError):
        return None


class _Store:
    """One informer's object store + indexes. All mutation under ``lock``."""

    def __init__(self, api_version: str, kind: str, indexes: tuple):
        self.api_version = api_version
        self.kind = kind
        self.lock = threading.RLock()
        self.objects: dict[tuple, dict] = {}          # (ns, name) -> obj
        self.indexes: dict[str, Index] = {BY_LABEL: Index(BY_LABEL, _label_pairs)}
        for idx in indexes:
            self.indexes[idx.name] = idx
        self._buckets: dict[str, dict[str, set]] = {n: {} for n in self.indexes}
        self._obj_keys: dict[tuple, dict[str, tuple]] = {}  # key -> {index: keys}
        # write-through ledger: key -> resourceVersion we wrote; lets the
        # ingest path tell "echo of our own write" from "resumed-stream
        # replay" when an ADDED arrives at an RV we already hold
        self.written_rvs: dict[tuple, str] = {}
        # warm-restore ledger: key -> resourceVersion seeded from a
        # durable snapshot *before* the informer subscribed. The
        # subscribe-time replay consumes entries (an ADDED at a seeded
        # key is expected, not a resumed-stream signature); keys left
        # unconsumed after the replay were deleted while the operator
        # was down and are pruned — O(delta) healing, no relist.
        self.seeded_rvs: dict[tuple, str] = {}
        # highest RV seeded from the snapshot — the resume point a
        # watch(since_rv=) subscribe heals forward from
        self.seed_floor = 0
        # True when the subscribe resumed from seed_floor (delta replay)
        # instead of a full-state replay
        self.resumed = False
        self.subscribed = False
        self.needs_relist = False
        self.relist_lock = threading.Lock()
        self.relist_total = 0
        self.started = threading.Event()
        # projection applied at ingest (None = store full objects) and
        # the measured-bytes ledger: per-key stored footprint plus what
        # the full (unprojected) object would have cost — the
        # projected-vs-full comparison /debug/cache reports. Running
        # totals keep stats O(1).
        self.projection: Optional[Callable[[dict], dict]] = None
        self.obj_bytes: dict[tuple, int] = {}
        self.full_obj_bytes: dict[tuple, int] = {}
        self.bytes_total = 0
        self.full_bytes_total = 0

    # -- keys ---------------------------------------------------------------

    def key_of(self, obj: dict) -> tuple:
        ns = namespace_of(obj) if is_namespaced(self.kind) else ""
        return (ns, name_of(obj))

    # -- mutation (callers hold no lock) ------------------------------------

    def upsert(self, obj: dict, full_bytes: Optional[int] = None) -> str:
        """RV-monotonic insert/replace. Returns ``"new"``, ``"replaced"``,
        ``"same"`` (identical RV already held) or ``"stale"`` (older than
        held — dropped). ``full_bytes`` is the measured footprint of the
        unprojected object (defaults to the stored object's own)."""
        key = self.key_of(obj)
        new_rv = _rv_int(obj)
        with self.lock:
            cur = self.objects.get(key)
            if cur is not None:
                cur_rv = _rv_int(cur)
                if new_rv is not None and cur_rv is not None:
                    if new_rv < cur_rv:
                        return "stale"
                    if new_rv == cur_rv:
                        return "same"
            self._unindex(key)
            self.objects[key] = obj
            self._index(key, obj)
            stored_b = measure_bytes(obj)
            full_b = stored_b if full_bytes is None else full_bytes
            self.bytes_total += stored_b - self.obj_bytes.get(key, 0)
            self.obj_bytes[key] = stored_b
            self.full_bytes_total += full_b - self.full_obj_bytes.get(key, 0)
            self.full_obj_bytes[key] = full_b
            return "replaced" if cur is not None else "new"

    def remove(self, obj_or_key) -> None:
        key = (obj_or_key if isinstance(obj_or_key, tuple)
               else self.key_of(obj_or_key))
        with self.lock:
            if self.objects.pop(key, None) is not None:
                self._unindex(key)
            self.written_rvs.pop(key, None)
            self.seeded_rvs.pop(key, None)
            self.bytes_total -= self.obj_bytes.pop(key, 0)
            self.full_bytes_total -= self.full_obj_bytes.pop(key, 0)

    def seed_many(self, objects: Iterable[dict],
                  obj_bytes: Optional[dict] = None,
                  full_obj_bytes: Optional[dict] = None) -> int:
        """Pre-watch bulk insert from a durable snapshot: one lock
        acquisition for the whole store, and byte counts carried in the
        snapshot skip the per-object ``measure_bytes`` walk — the
        dominant per-object cost — so seeding a 10k-object store is a
        deserialize + index, not a re-measure of the fleet. Byte ledgers
        may be keyed dicts or sequences aligned with ``objects`` (the
        snapshot's compact form). Objects must already be frozen;
        returns the count seeded."""
        by_pos_o = isinstance(obj_bytes, (list, tuple))
        by_pos_f = isinstance(full_obj_bytes, (list, tuple))
        if not by_pos_o:
            obj_bytes = obj_bytes or {}
        if not by_pos_f:
            full_obj_bytes = full_obj_bytes or {}
        namespaced = is_namespaced(self.kind)
        count = 0
        floor = 0
        with self.lock:
            store_objs = self.objects
            o_ledger, f_ledger = self.obj_bytes, self.full_obj_bytes
            for pos, obj in enumerate(objects):
                md = obj.get("metadata") or {}
                # exact key_of() semantics: missing -> "" (get_nested
                # default), so seeded keys match the replay's lookups
                key = (md.get("namespace", "") if namespaced else "",
                       md.get("name", ""))
                self._unindex(key)
                store_objs[key] = obj
                self._index(key, obj)
                stored_b = (obj_bytes[pos] if by_pos_o
                            else obj_bytes.get(key))
                if stored_b is None:
                    stored_b = measure_bytes(obj)
                full_b = (full_obj_bytes[pos] if by_pos_f
                          else full_obj_bytes.get(key))
                if full_b is None:
                    full_b = stored_b
                self.bytes_total += stored_b - o_ledger.get(key, 0)
                o_ledger[key] = stored_b
                self.full_bytes_total += full_b - f_ledger.get(key, 0)
                f_ledger[key] = full_b
                rv = md.get("resourceVersion")
                if rv:
                    self.seeded_rvs[key] = rv
                    try:
                        irv = int(rv)
                    except (TypeError, ValueError):
                        irv = 0
                    if irv > floor:
                        floor = irv
                count += 1
            if floor > self.seed_floor:
                self.seed_floor = floor
        return count

    def _index(self, key: tuple, obj: dict) -> None:
        filed = {}
        for name, idx in self.indexes.items():
            keys = idx.keys(obj)
            if keys:
                filed[name] = keys
                buckets = self._buckets[name]
                for k in keys:
                    buckets.setdefault(k, set()).add(key)
        if filed:
            self._obj_keys[key] = filed

    def _unindex(self, key: tuple) -> None:
        for name, keys in self._obj_keys.pop(key, {}).items():
            buckets = self._buckets[name]
            for k in keys:
                bucket = buckets.get(k)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del buckets[k]

    # -- reads (lock held by caller via ``with store.lock``) ---------------

    def select_by_label_locked(self, selector: dict) -> list:
        """Bucket-intersect a plain {k: v} selector. O(result), not O(store)."""
        smallest: Optional[set] = None
        buckets = self._buckets[BY_LABEL]
        for k, v in selector.items():
            bucket = buckets.get(f"{k}={v}")
            if not bucket:
                return []
            if smallest is None or len(bucket) < len(smallest):
                smallest = bucket
        if smallest is None:  # empty selector: everything matches
            return list(self.objects.values())
        pairs = {f"{k}={v}" for k, v in selector.items()}
        out = []
        for key in smallest:
            filed = self._obj_keys.get(key, {}).get(BY_LABEL, ())
            if pairs.issubset(filed):
                out.append(self.objects[key])
        return out


class CachedClient(Client):
    """Informer-backed read cache over any ``Client``. See module docstring.

    Reads (``get``/``list``/``index``) are served from watch-fed stores;
    writes pass through to ``inner`` and write-through into the store.
    ``watch`` registrations are delegated to ``inner`` *after* the kind's
    informer is subscribed, so by the time a controller's handler fires,
    the cache already reflects that event — a reconcile triggered by an
    event never reads a cache older than the event itself.
    """

    def __init__(self, inner: Client,
                 extra_indexes: Optional[dict] = None,
                 relist_chunk: Optional[int] = None,
                 now: Optional[Callable[[], float]] = None):
        self.inner = inner
        self._stores: dict[tuple, _Store] = {}
        self._meta = threading.Lock()
        self._cancels: list[Callable[[], None]] = []
        self._extra = dict(extra_indexes or {})
        self._delta_listeners: dict[tuple, list] = {}
        self._listener_failures: dict[int, int] = {}  # id(fn) -> consecutive
        self._closed = False
        self.relist_chunk = (env_relist_chunk() if relist_chunk is None
                             else max(0, relist_chunk))
        # observability for tests: reads served without touching
        # the apiserver, and heals performed
        self.cache_reads = 0
        self.relists = 0
        self.listener_errors = 0
        # warm-restore healing: subscribes that resumed from the snapshot
        # RV (O(delta) replay) vs. fell back to a full replay (410 / no
        # server support)
        self.watch_resumes = 0
        self.watch_resume_fallbacks = 0
        # Degraded-mode breaker state. ``now`` is injectable so a test
        # can drive staleness/backoff off a stepped clock.
        self.now = now or time.monotonic
        self.degraded = False
        self.degraded_since: Optional[float] = None
        self.sync_failures = 0          # consecutive; resets on success
        self.sync_failures_total = 0
        self.last_synced = self.now()   # last successful relist/subscribe
        self._next_reconnect = 0.0
        self._reconnect_delay = DEGRADED_BACKOFF_BASE_S

    @property
    def serves_cached_reads(self) -> bool:
        """True while get/list are answered from the watch-fed stores —
        the tracing layer's deterministic source=cache|api signal."""
        return not self._closed

    # -- informer lifecycle -------------------------------------------------

    def _new_store(self, gvk: tuple) -> _Store:
        """Create (or return) the store for ``gvk`` without subscribing.
        Caller holds no lock."""
        api_version, kind = gvk
        with self._meta:
            store = self._stores.get(gvk)
            if store is None:
                indexes = (tuple(DEFAULT_INDEXES.get(gvk, ()))
                           + tuple(self._extra.get(gvk, ())))
                store = _Store(api_version, kind, indexes)
                if PROJECTION_GATE.enabled:
                    store.projection = PROJECTIONS.get(gvk)
                self._stores[gvk] = store
        return store

    def _ensure(self, api_version: str, kind: str) -> _Store:
        gvk = (api_version, kind)
        store = self._new_store(gvk)
        with self._meta:
            creator = not store.subscribed
            store.subscribed = True
        if creator:
            # subscribe outside the meta lock: the inner watch replays
            # ADDED for every live object synchronously, feeding the store
            # its initial state (the informer's initial LIST). A snapshot-
            # seeded store pays only the delta: replays at an already-held
            # RV short-circuit before projection/freeze/measure.
            handler = self._ingest_handler(store)
            cancel = None
            with store.lock:
                since = store.seed_floor if store.seeded_rvs else 0
            if since and getattr(self.inner, "supports_watch_resume",
                                 False):
                # snapshot-seeded store against a server that can resume:
                # replay only the events after the snapshot's RV — the
                # RV-diff heal, no relist of the world.
                try:
                    cancel = self.inner.watch(api_version, kind, handler,
                                              since_rv=since)
                except WatchGoneError:
                    # resume point fell out of the watch window: pay the
                    # classic full replay below instead
                    with self._meta:
                        self.watch_resume_fallbacks += 1
                else:
                    # the delta replay carried downtime deletions as
                    # explicit DELETED tombstones; seeded keys it never
                    # mentioned are simply unchanged — keep them, no
                    # prune pass
                    with store.lock:
                        store.seeded_rvs.clear()
                    store.resumed = True
                    with self._meta:
                        self.watch_resumes += 1
            if cancel is None:
                cancel = self.inner.watch(api_version, kind, handler)
                self._finish_seed(store)
            with self._meta:
                self._cancels.append(cancel)
            self._mark_synced()
            store.started.set()
        else:
            store.started.wait(timeout=30.0)
        return store

    def seed_store(self, api_version: str, kind: str,
                   objects: Iterable[dict],
                   obj_bytes=None, full_obj_bytes=None) -> int:
        """Warm-restore entry point: pre-load a store from a durable
        snapshot *before* its informer subscribes. Objects are stored as
        given (snapshots hold already-projected views); ``obj_bytes`` /
        ``full_obj_bytes`` carry the footprints measured at snapshot
        time — (ns, name)-keyed dicts or sequences aligned with
        ``objects`` — skipping the re-measure walk. The
        first read of the kind subscribes the informer; its replay then
        folds only the changes since the snapshot (O(delta)) and prunes
        keys deleted during the downtime. Raises if the informer already
        subscribed — seeding an active store would race the stream."""
        gvk = (api_version, kind)
        store = self._new_store(gvk)
        with self._meta:
            if store.subscribed:
                raise RuntimeError(
                    f"cannot seed {api_version}/{kind}: informer already "
                    "subscribed")
        count = store.seed_many(
            (o if type(o) is FrozenDict else freeze_obj(o)
             for o in objects),
            obj_bytes=obj_bytes, full_obj_bytes=full_obj_bytes)
        self._publish_bytes(store)
        return count

    def _finish_seed(self, store: _Store) -> None:
        """After the subscribe-time replay: seeded keys the replay never
        confirmed were deleted while the operator was down — prune them
        (the O(delta) analog of the relist's prune pass)."""
        with store.lock:
            leftover = list(store.seeded_rvs)
            store.seeded_rvs.clear()
        if not leftover:
            return
        gvk = (store.api_version, store.kind)
        for key in leftover:
            with store.lock:
                obj = store.objects.get(key)
            if obj is None:
                continue
            store.remove(key)
            self._notify_delta(gvk, "DELETED", obj)
        self._publish_bytes(store)

    def add_delta_listener(self, api_version: str, kind: str,
                           listener: Callable[[str, dict], None]):
        """Register ``listener(event_type, obj)`` for every store change
        of the given kind: watch ingests (ADDED/MODIFIED/DELETED), write
        echoes (MODIFIED), and local deletes (DELETED, metadata-only
        stub). Fired *after* the store reflects the change, so a listener
        reading the cache never sees a view older than its delta.
        Listener exceptions are absorbed (the cache must stay healthy
        regardless of consumer bugs) but counted on
        ``cache_listener_errors`` and logged; a listener that fails
        ``LISTENER_DETACH_AFTER`` consecutive times is detached with an
        ERROR naming it. Returns a zero-arg cancel."""
        gvk = (api_version, kind)
        with self._meta:
            self._delta_listeners.setdefault(gvk, []).append(listener)

        def cancel():
            with self._meta:
                try:
                    self._delta_listeners.get(gvk, []).remove(listener)
                except ValueError:
                    pass
        return cancel

    def _notify_delta(self, gvk: tuple, event_type: str, obj: dict) -> None:
        for fn in tuple(self._delta_listeners.get(gvk, ())):
            try:
                fn(event_type, obj)
            except Exception:
                # consumer bug firewall: the cache must stay healthy, but
                # a silently-swallowed listener error is an invisible
                # index drifting out of sync — count it, and detach the
                # listener once it proves itself dead.
                self.listener_errors += 1
                fails = self._listener_failures.get(id(fn), 0) + 1
                self._listener_failures[id(fn)] = fails
                from ..metrics.operator_metrics import OPERATOR_METRICS

                OPERATOR_METRICS.cache_listener_errors.labels(
                    kind=gvk[1]).inc()
                name = getattr(fn, "__qualname__",
                               getattr(fn, "__name__", repr(fn)))
                if fails >= LISTENER_DETACH_AFTER:
                    logger.error(
                        "cache: detaching delta listener %s for %s/%s "
                        "after %d consecutive failures", name, gvk[0],
                        gvk[1], fails, exc_info=True)
                    with self._meta:
                        try:
                            self._delta_listeners.get(gvk, []).remove(fn)
                        except ValueError:
                            pass
                    self._listener_failures.pop(id(fn), None)
                else:
                    logger.warning(
                        "cache: delta listener %s for %s/%s raised "
                        "(%d/%d consecutive)", name, gvk[0], gvk[1],
                        fails, LISTENER_DETACH_AFTER, exc_info=True)
            else:
                self._listener_failures.pop(id(fn), None)

    def _ingest_handler(self, store: _Store):
        gvk = (store.api_version, store.kind)

        def handler(event: WatchEvent):
            key = store.key_of(event.obj)
            if event.type == "DELETED":
                # remove() consumes the seeded-ledger entry for the key
                store.remove(event.obj)
                self._publish_bytes(store)
                self._notify_delta(gvk, "DELETED", event.obj)
                return
            # no-op fast path: an event at an RV we already hold cannot
            # change the store (upsert would return same/stale), so skip
            # projection/freeze/measure entirely. This is what makes a
            # snapshot-seeded warm start O(delta) in CPU too — the
            # subscribe replay of 10k unchanged objects is 10k integer
            # compares under one lock hold each, not 10k
            # projection+measure walks.
            rv = get_nested(event.obj, "metadata", "resourceVersion")
            try:
                new_rv = int(rv)
            except (TypeError, ValueError):
                new_rv = None
            with store.lock:
                # any event for a seeded key confirms it survived the
                # downtime — consume the warm-restore ledger entry
                seeded = store.seeded_rvs.pop(key, None) is not None
                cur_rv = _rv_int(store.objects.get(key))
                fast = (new_rv is not None and cur_rv is not None
                        and new_rv <= cur_rv)
                own_echo = False
                if fast and event.type == "ADDED":
                    own_echo = store.written_rvs.get(key) == rv
                    if own_echo:
                        store.written_rvs.pop(key, None)
            if fast:
                if event.type == "ADDED" and not own_echo and not seeded:
                    # replayed state from a resumed stream: deletions
                    # that happened during the gap are invisible to the
                    # replay, so schedule a relist to prune them
                    store.needs_relist = True
                return
            # freeze-on-ingest: a fake/cached inner already publishes
            # frozen views (shared zero-copy); a mutable event object
            # is converted once here — leaves are immutable scalars,
            # so structural sharing with other subscribers is safe.
            # With a projection installed, the slimmed view is frozen
            # instead (new top-level dicts, leaves shared).
            if store.projection is not None:
                obj = freeze_obj(store.projection(event.obj))
                full_b = measure_bytes(event.obj)
            else:
                obj = freeze_obj(event.obj)
                full_b = None
            outcome = store.upsert(obj, full_bytes=full_b)
            self._publish_bytes(store)
            if outcome in ("new", "replaced"):
                self._notify_delta(gvk, event.type, obj)
            if event.type == "ADDED" and outcome in ("same", "stale"):
                # raced with a concurrent ingest for the same key: fall
                # back to the original echo/prune bookkeeping
                with store.lock:
                    own_echo = store.written_rvs.get(key) == rv
                    if own_echo:
                        store.written_rvs.pop(key, None)
                if not own_echo and not seeded:
                    # replayed state from a resumed stream: deletions that
                    # happened during the gap are invisible to the replay,
                    # so schedule a relist to prune them
                    store.needs_relist = True
        return handler

    def _maybe_relist(self, store: _Store) -> None:
        if not store.needs_relist:
            return
        if self.degraded and self.now() < self._next_reconnect:
            return  # reconnect is backed off: serve the stale view
        # non-blocking per-store guard: one heal per store at a time, and
        # readers that lose the race serve the current (RV-monotonic, so
        # never-corrupt, at worst gap-stale) view instead of convoying
        # behind the relist — a watch-drop storm on two kinds heals each
        # store once, in whichever reader thread got there first
        if not store.relist_lock.acquire(blocking=False):
            return
        try:
            if store.needs_relist:
                try:
                    self._relist(store)
                except Exception:
                    # the dirty flag stays set so a later read retries
                    if not self._record_sync_failure():
                        raise
                else:
                    self._mark_synced()
        finally:
            store.relist_lock.release()

    # -- degraded-mode breaker ----------------------------------------------

    def _record_sync_failure(self) -> bool:
        """One failed relist against the apiserver. Returns True when the
        failure is absorbed (cache is — or just became — Degraded and
        keeps serving stale reads) and False when it should propagate to
        the reader (healthy cache, breaker below threshold)."""
        self.sync_failures += 1
        self.sync_failures_total += 1
        from ..metrics.operator_metrics import OPERATOR_METRICS

        if not self.degraded and self.sync_failures < DEGRADED_THRESHOLD:
            return False
        if not self.degraded:
            self.degraded = True
            self.degraded_since = self.now()
            self._reconnect_delay = DEGRADED_BACKOFF_BASE_S
            logger.error(
                "cache: entering Degraded mode after %d consecutive sync "
                "failures; serving stale reads, reconnecting with capped "
                "backoff", self.sync_failures)
        else:
            self._reconnect_delay = min(DEGRADED_BACKOFF_CAP_S,
                                        self._reconnect_delay * 2.0)
        self._next_reconnect = self.now() + self._reconnect_delay
        OPERATOR_METRICS.cache_degraded.set(1)
        OPERATOR_METRICS.cache_staleness_seconds.set(self.staleness_s())
        return True

    def _mark_synced(self) -> None:
        """A successful sync (subscribe replay or relist): reset the
        breaker and, if degraded, exit cleanly."""
        self.last_synced = self.now()
        self.sync_failures = 0
        self._reconnect_delay = DEGRADED_BACKOFF_BASE_S
        self._next_reconnect = 0.0
        if self.degraded:
            since = self.degraded_since or self.last_synced
            logger.warning(
                "cache: apiserver healed; exiting Degraded mode after "
                "%.1fs", self.last_synced - since)
            self.degraded = False
            self.degraded_since = None
        from ..metrics.operator_metrics import OPERATOR_METRICS

        OPERATOR_METRICS.cache_degraded.set(0)
        OPERATOR_METRICS.cache_staleness_seconds.set(0)

    def staleness_s(self) -> float:
        """Age of the cached view: 0 while watches are healthy, seconds
        since the last successful sync once syncs start failing."""
        if not self.degraded and self.sync_failures == 0:
            return 0.0
        return max(0.0, self.now() - self.last_synced)

    def mark_stale(self) -> None:
        """Flag every store dirty — the informer-side signal that the
        watch stream died (410 Gone / timeout). The next read of each
        kind attempts the relist heal; if the apiserver is browned out
        those attempts trip the Degraded breaker."""
        with self._meta:
            stores = list(self._stores.values())
        for store in stores:
            store.needs_relist = True

    def _list_inner_chunked(self, store: _Store) -> Iterable[dict]:
        """Page through the inner client's list when it supports
        ``limit``/``continue_`` — a 10k-node relist touches
        ``relist_chunk`` objects at a time instead of materializing the
        fleet — else one full list."""
        if (self.relist_chunk > 0
                and getattr(self.inner, "supports_chunked_list", False)):
            token = None
            while True:
                page = self.inner.list(
                    store.api_version, store.kind,
                    ListOptions(limit=self.relist_chunk, continue_=token))
                yield from page
                token = getattr(page, "continue_", None)
                if not token:
                    return
        else:
            yield from self.inner.list(store.api_version, store.kind)

    def _relist(self, store: _Store) -> None:
        """List through the inner client (chunked when supported) + prune:
        the 410-Gone heal. May raise (the inner client is allowed to
        fail); the dirty flag stays set so the next read retries."""
        with store.lock:
            pre = {k: _rv_int(o) for k, o in store.objects.items()}
        listed_keys = set()
        for obj in self._list_inner_chunked(store):
            listed_keys.add(store.key_of(obj))
            if store.projection is not None:
                store.upsert(freeze_obj(store.projection(obj)),
                             full_bytes=measure_bytes(obj))
            else:
                store.upsert(freeze_obj(obj))
        with store.lock:
            for key in list(store.objects):
                if key in listed_keys or key not in pre:
                    continue  # seen by the list, or newer than our snapshot
                if _rv_int(store.objects[key]) == pre[key]:
                    store.remove(key)
            store.needs_relist = False
            store.relist_total += 1
        self.relists += 1
        self._publish_bytes(store)
        from ..metrics.operator_metrics import OPERATOR_METRICS

        OPERATOR_METRICS.cache_relists.labels(kind=store.kind).inc()

    def _publish_bytes(self, store: _Store) -> None:
        from ..metrics.operator_metrics import OPERATOR_METRICS

        OPERATOR_METRICS.cache_store_bytes.labels(
            kind=store.kind).set(store.bytes_total)

    def resync(self) -> None:
        """Force a relist of every cached kind (client-go resync analog)."""
        for store in list(self._stores.values()):
            with store.relist_lock:
                self._relist(store)
        self._mark_synced()

    # -- reads: served from the store ---------------------------------------

    def get(self, api_version, kind, name, namespace=None,
            metadata_only=False):
        if self._closed:
            return self.inner.get(api_version, kind, name, namespace=namespace,
                                  metadata_only=metadata_only)
        store = self._ensure(api_version, kind)
        self._maybe_relist(store)
        ns = namespace or "" if is_namespaced(kind) else ""
        with store.lock:
            obj = store.objects.get((ns, name))
        if obj is None:
            raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
        self.cache_reads += 1
        return obj

    def list(self, api_version, kind, opts: Optional[ListOptions] = None):
        if self._closed:
            return self.inner.list(api_version, kind, opts)
        store = self._ensure(api_version, kind)
        self._maybe_relist(store)
        opts = opts or ListOptions()
        sel = opts.label_selector
        plain_selector = (
            sel is not None and isinstance(sel, dict) and sel
            and "matchLabels" not in sel and "matchExpressions" not in sel)
        out = []
        with store.lock:
            if plain_selector:
                candidates = store.select_by_label_locked(sel)
                sel_checked = True
            else:
                candidates = store.objects.values()
                sel_checked = sel is None
            for obj in candidates:
                if opts.namespace and namespace_of(obj) != opts.namespace:
                    continue
                if not sel_checked and not match_labels(labels_of(obj), sel):
                    continue
                if opts.field_selector:
                    fs = opts.field_selector
                    if ("metadata.name" in fs
                            and name_of(obj) != fs["metadata.name"]):
                        continue
                    if ("metadata.namespace" in fs
                            and namespace_of(obj) != fs["metadata.namespace"]):
                        continue
                out.append(obj)
        out.sort(key=obj_key)
        self.cache_reads += 1
        return out

    def index(self, api_version: str, kind: str, index_name: str,
              key: str) -> list:
        """All cached objects of (api_version, kind) filed under ``key`` in
        ``index_name`` — O(result), served as frozen views, e.g.
        ``index("v1", "Pod", "by-node", node_name)``."""
        store = self._ensure(api_version, kind)
        self._maybe_relist(store)
        with store.lock:
            if index_name not in store.indexes:
                raise KeyError(
                    f"no index {index_name!r} on {api_version}/{kind}")
            keys = store._buckets[index_name].get(key, ())
            out = [store.objects[k] for k in keys]
        out.sort(key=obj_key)
        self.cache_reads += 1
        return out

    def index_keys(self, api_version: str, kind: str,
                   index_name: str) -> list:
        """Sorted bucket keys currently populated in ``index_name`` —
        e.g. every distinct accelerator type in the cluster via
        ``index_keys("v1", "Node", "by-accelerator")``. Unioning
        ``index()`` over these keys yields every indexed object without
        scanning unindexed ones."""
        store = self._ensure(api_version, kind)
        self._maybe_relist(store)
        with store.lock:
            if index_name not in store.indexes:
                raise KeyError(
                    f"no index {index_name!r} on {api_version}/{kind}")
            return sorted(k for k, v in
                          store._buckets[index_name].items() if v)

    def has_index(self, api_version: str, kind: str, index_name: str) -> bool:
        gvk = (api_version, kind)
        indexes = (tuple(DEFAULT_INDEXES.get(gvk, ()))
                   + tuple(self._extra.get(gvk, ())))
        return any(i.name == index_name for i in indexes)

    # -- introspection -------------------------------------------------------

    def cached_kinds(self) -> list:
        with self._meta:
            return sorted(self._stores)

    def cache_stats(self) -> dict:
        """Per-kind store sizes, index bucket counts, and measured
        projected-vs-full bytes — the JSON body of the Manager's
        ``/debug/cache`` endpoint."""
        with self._meta:
            stores = dict(self._stores)
        kinds = {}
        for (av, kind), store in sorted(stores.items()):
            with store.lock:
                kinds[f"{av}/{kind}"] = {
                    "objects": len(store.objects),
                    "indexes": {name: len(store._buckets[name])
                                for name in sorted(store.indexes)},
                    "bytes": store.bytes_total,
                    "full_bytes": store.full_bytes_total,
                    "projected": store.projection is not None,
                    "relists": store.relist_total,
                    "resumed": store.resumed,
                }
        return {
            "projection_enabled": PROJECTION_GATE.enabled,
            "relist_chunk": self.relist_chunk,
            "cache_reads": self.cache_reads,
            "relists": self.relists,
            "degraded": self.degraded,
            "staleness_s": round(self.staleness_s(), 3),
            "sync_failures": self.sync_failures,
            "sync_failures_total": self.sync_failures_total,
            "listener_errors": self.listener_errors,
            "watch_resumes": self.watch_resumes,
            "watch_resume_fallbacks": self.watch_resume_fallbacks,
            "kinds": kinds,
        }

    def dump_stores(self) -> dict:
        """Snapshot source: per-kind stored objects (the projected views,
        exactly as served) plus their measured byte ledgers, so a warm
        restore re-seeds without re-projecting or re-measuring. Returns
        ``{(api_version, kind): {"objects": [...], "obj_bytes": [...],
        "full_obj_bytes": [...]}}`` — the byte ledgers are lists aligned
        with ``objects`` (no per-object key strings in the snapshot) and
        the frozen views are shared zero-copy: callers serialize, they
        don't mutate."""
        with self._meta:
            stores = dict(self._stores)
        out = {}
        for gvk, store in sorted(stores.items()):
            with store.lock:
                out[gvk] = {
                    "objects": list(store.objects.values()),
                    "obj_bytes": [store.obj_bytes.get(k, 0)
                                  for k in store.objects],
                    "full_obj_bytes": [store.full_obj_bytes.get(k, 0)
                                       for k in store.objects],
                }
        return out

    def store_snapshot(self, api_version: str, kind: str) -> dict:
        """(ns, name) -> resourceVersion for every cached object of the
        kind; no informer is created if none exists."""
        store = self._stores.get((api_version, kind))
        if store is None:
            return {}
        with store.lock:
            return {k: get_nested(o, "metadata", "resourceVersion")
                    for k, o in store.objects.items()}

    # -- writes: pass through + write-through ---------------------------------

    def _write_through(self, obj: dict) -> dict:
        store = self._stores.get((obj.get("apiVersion", ""),
                                  obj.get("kind", "")))
        if store is not None:
            full_b = None
            if store.projection is not None:
                # projected kinds store the slim view of the write echo
                # too, so a write never re-inflates the store
                frozen = freeze_obj(store.projection(obj))
                full_b = measure_bytes(obj)
            else:
                # a frozen inner result (FakeClient) IS the authoritative
                # stored view — share it zero-copy; a mutable one (HTTP
                # client) is copied then frozen so later caller edits
                # can't reach the store
                frozen = (obj if type(obj) is FrozenDict
                          else freeze_obj(deepcopy_obj(obj)))
            key = store.key_of(frozen)
            rv = get_nested(frozen, "metadata", "resourceVersion")
            with store.lock:
                outcome = store.upsert(frozen, full_bytes=full_b)
                if outcome in ("new", "replaced") and rv:
                    store.written_rvs[key] = rv
            self._publish_bytes(store)
            if outcome in ("new", "replaced"):
                self._notify_delta((store.api_version, store.kind),
                                   "MODIFIED", frozen)
        return obj

    def create(self, obj):
        return self._write_through(self.inner.create(obj))

    def update(self, obj):
        return self._write_through(self.inner.update(obj))

    def update_status(self, obj):
        return self._write_through(self.inner.update_status(obj))

    def patch(self, api_version, kind, name, patch, namespace=None):
        return self._write_through(
            self.inner.patch(api_version, kind, name, patch,
                             namespace=namespace))

    def delete(self, api_version, kind, name, namespace=None):
        self.inner.delete(api_version, kind, name, namespace=namespace)
        store = self._stores.get((api_version, kind))
        if store is not None:
            ns = namespace or "" if is_namespaced(kind) else ""
            store.remove((ns, name))
            self._publish_bytes(store)
            # no full object at hand here; a metadata stub is enough for
            # listeners to forget the key
            self._notify_delta((api_version, kind), "DELETED", {
                "apiVersion": api_version, "kind": kind,
                "metadata": {"name": name, "namespace": ns}})

    # -- watch / lifecycle ----------------------------------------------------

    def watch(self, api_version, kind, handler):
        # informer first: its store handler is subscribed before the
        # caller's, so the cache is never behind the event a controller
        # is reacting to
        self._ensure(api_version, kind)
        return self.inner.watch(api_version, kind, handler)

    def close(self):
        self._closed = True
        with self._meta:
            cancels, self._cancels = self._cancels, []
        for cancel in cancels:
            try:
                cancel()
            except Exception:  # pragma: no cover - defensive teardown
                pass
        if hasattr(self.inner, "close"):
            self.inner.close()

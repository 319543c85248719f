"""In-memory fake apiserver + kubelet/DaemonSet simulator.

The port's own copy of ``tpu_operator/runtime/fake.py``: it raises the
port's error classes, which the port's state engine and controllers
catch. The analog of the controller-runtime fake client the NVIDIA
operator builds its "mock cluster" unit tier on: fabricated Node objects
carry GKE's GPU labels, reconcilers run unmodified against this client,
and DaemonSet "readiness" is driven structurally by ``simulate_kubelet``
rather than by running pods.
"""

from __future__ import annotations

import threading
import uuid
from typing import Mapping, Optional

from .client import (
    AlreadyExistsError,
    Client,
    ConflictError,
    ListOptions,
    NotFoundError,
    PagedList,
    WatchEvent,
    WatchGoneError,
    WatchHub,
    merge_patch,
)
from .objects import (
    deepcopy_obj,
    freeze_obj,
    get_nested,
    is_namespaced,
    labels_of,
    match_labels,
    match_node_selector_terms,
    name_of,
    namespace_of,
    obj_key,
    set_nested,
    thaw_obj,
)
from ..utils.hash import object_hash


class FakeClient(Client):
    supports_chunked_list = True
    supports_watch_resume = True

    def __init__(self):
        self._lock = threading.RLock()
        self._store: dict[tuple, dict] = {}
        # deletion tombstones: key -> RV assigned at delete time. This is
        # the fake's watch cache — watch(since_rv=) replays them so a
        # resuming watcher learns about objects deleted while it was down
        # without a full relist. Latest delete wins per key; a re-create
        # clears the tombstone (the ADDED event supersedes it).
        self._tombstones: dict[tuple, int] = {}
        # when set, since_rv more than this many RVs behind the head is
        # answered with WatchGoneError (the apiserver's bounded watch
        # cache / HTTP 410). None = unlimited, the default for tests.
        self.watch_window: Optional[int] = None
        # live-object uid -> refcount, maintained on create/delete so the
        # orphaned-ownerRef check in create() is O(#refs), not a scan of
        # the whole store (which made bulk creates O(n^2) at scale). A
        # refcount, not a set: callers may create objects with duplicate
        # explicit uids (a real apiserver would too — uid is caller data
        # here), and deleting one of them must not make the survivor look
        # dead to the GC path the chaos plane leans on.
        self._live_uids: dict = {}
        self._rv = 0
        self.hub = WatchHub()
        # apiserver request accounting for the scale tier: every verb a
        # real apiserver would receive counts once. The reconcile loop's
        # request complexity (O(states) vs O(states x nodes)) is asserted
        # from these numbers, not guessed.
        self.verb_counts: dict[str, int] = {}

    # -- internals ---------------------------------------------------------

    def _count(self, verb: str) -> None:
        with self._lock:
            self.verb_counts[verb] = self.verb_counts.get(verb, 0) + 1

    def reset_verb_counts(self) -> dict:
        """Return the counts so far and start a fresh window."""
        with self._lock:
            out, self.verb_counts = self.verb_counts, {}
            return out

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _key(self, api_version: str, kind: str, name: str, namespace: Optional[str]) -> tuple:
        ns = namespace or "" if is_namespaced(kind) else ""
        return (api_version, kind, ns, name)

    def _publish(self, type_: str, obj: dict) -> None:
        # stored objects are frozen views: sharing them with watch
        # handlers is safe zero-copy (a mutating handler raises)
        self.hub.publish(WatchEvent(type_, obj))

    # -- CRUD --------------------------------------------------------------
    #
    # Copy-free reads: the store holds frozen views (objects.freeze_obj)
    # built once per WRITE; get/list/watch hand the stored view out
    # directly instead of deepcopying per read. Callers that edit a read
    # result thaw_obj() it first — in-place mutation raises
    # FrozenObjectError rather than corrupting the store.

    def get(self, api_version, kind, name, namespace=None,
            metadata_only=False):
        self._count("get")
        # metadata_only is a wire-size hint; the fake returns the full
        # object (permitted by the Client contract)
        with self._lock:
            obj = self._store.get(self._key(api_version, kind, name, namespace))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
            return obj

    def list(self, api_version, kind, opts: Optional[ListOptions] = None):
        self._count("list")
        opts = opts or ListOptions()
        out = []
        with self._lock:
            for (av, k, ns, _), obj in self._store.items():
                if av != api_version or k != kind:
                    continue
                if opts.namespace and ns != opts.namespace:
                    continue
                if opts.label_selector is not None and not match_labels(
                        labels_of(obj), opts.label_selector):
                    continue
                if opts.field_selector:
                    fs = opts.field_selector
                    if "metadata.name" in fs and name_of(obj) != fs["metadata.name"]:
                        continue
                    if "metadata.namespace" in fs and ns != fs["metadata.namespace"]:
                        continue
                out.append(obj)
        out.sort(key=obj_key)
        # pagination: the sort key within one (apiVersion, kind) reduces
        # to (namespace, name), so the continue token is "ns/name" of the
        # last object returned (K8s names cannot contain "/")
        if opts.continue_:
            tns, _, tname = opts.continue_.partition("/")
            out = [o for o in out
                   if (namespace_of(o), name_of(o)) > (tns, tname)]
        if opts.limit is not None and 0 < opts.limit < len(out):
            page = PagedList(out[:opts.limit])
            last = page[-1]
            page.continue_ = f"{namespace_of(last)}/{name_of(last)}"
            return page
        return out

    def create(self, obj):
        self._count("create")
        obj = deepcopy_obj(obj)
        if not name_of(obj):
            raise ValueError("object has no metadata.name")
        meta = obj.setdefault("metadata", {})
        if is_namespaced(obj.get("kind", "")):
            meta.setdefault("namespace", "default")
        key = self._key(obj.get("apiVersion", ""), obj.get("kind", ""),
                        name_of(obj), namespace_of(obj) or None)
        with self._lock:
            if key in self._store:
                raise AlreadyExistsError(f"{key[1]} {key[2]}/{key[3]} already exists")
            meta.setdefault("uid", str(uuid.uuid4()))
            meta["resourceVersion"] = self._next_rv()
            meta.setdefault("generation", 1)
            meta.setdefault("creationTimestamp", "1970-01-01T00:00:00Z")
            obj = freeze_obj(obj)
            self._store[key] = obj
            self._tombstones.pop(key, None)
            # creating with an ownerReference to an already-deleted owner:
            # the real apiserver accepts this and the GC controller collects
            # it shortly after; the fake compresses that to "immediately",
            # which closes the CR-deleted-mid-reconcile race deterministically
            self._live_uids[meta["uid"]] = \
                self._live_uids.get(meta["uid"], 0) + 1
            orphaned = any(
                r.get("uid") and r.get("uid") not in self._live_uids
                for r in meta.get("ownerReferences") or [])
        self._publish("ADDED", obj)
        if orphaned:
            try:
                self.delete(obj.get("apiVersion", ""), obj.get("kind", ""),
                            name_of(obj), namespace_of(obj) or None)
            except NotFoundError:
                pass
        return obj

    def update(self, obj):
        self._count("update")
        obj = deepcopy_obj(obj)
        key = self._key(obj.get("apiVersion", ""), obj.get("kind", ""),
                        name_of(obj), namespace_of(obj) or None)
        with self._lock:
            cur = self._store.get(key)
            if cur is None:
                raise NotFoundError(f"{key[1]} {key[2]}/{key[3]} not found")
            claimed = get_nested(obj, "metadata", "resourceVersion")
            actual = get_nested(cur, "metadata", "resourceVersion")
            if claimed is not None and claimed != actual:
                raise ConflictError(
                    f"resourceVersion conflict on {key[1]} {key[3]}: "
                    f"have {claimed}, want {actual}")
            meta = obj.setdefault("metadata", {})
            meta["uid"] = get_nested(cur, "metadata", "uid")
            meta["creationTimestamp"] = get_nested(cur, "metadata", "creationTimestamp")
            cur_gen = get_nested(cur, "metadata", "generation", default=1) or 1
            meta["resourceVersion"] = actual
            meta["generation"] = cur_gen
            # no-op writes don't bump the RV or emit events (real apiserver
            # semantics; prevents self-sustaining reconcile storms)
            if obj == cur:
                return cur
            meta["resourceVersion"] = self._next_rv()
            if obj.get("spec") != cur.get("spec"):
                meta["generation"] = cur_gen + 1
            obj = freeze_obj(obj)
            self._store[key] = obj
        self._publish("MODIFIED", obj)
        return obj

    def update_status(self, obj):
        self._count("update_status")
        key = self._key(obj.get("apiVersion", ""), obj.get("kind", ""),
                        name_of(obj), namespace_of(obj) or None)
        with self._lock:
            cur = self._store.get(key)
            if cur is None:
                raise NotFoundError(f"{key[1]} {key[2]}/{key[3]} not found")
            new_status = deepcopy_obj(obj.get("status") or {})
            if (cur.get("status") or {}) == new_status:
                return cur  # no-op: no RV bump, no event
            cur = thaw_obj(cur)
            cur["status"] = new_status
            cur["metadata"]["resourceVersion"] = self._next_rv()
            cur = freeze_obj(cur)
            self._store[key] = cur
        self._publish("MODIFIED", cur)
        return cur

    def patch(self, api_version, kind, name, patch, namespace=None):
        self._count("patch")
        key = self._key(api_version, kind, name, namespace)
        with self._lock:
            cur = self._store.get(key)
            if cur is None:
                raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
            merged = merge_patch(deepcopy_obj(cur), patch)
            # uid is immutable on a real apiserver; forcing it from the
            # stored object (like update() does) also keeps _live_uids
            # in sync with the store
            merged.setdefault("metadata", {})["uid"] = get_nested(
                cur, "metadata", "uid")
            if merged == cur:
                return cur  # no-op patch
            merged["metadata"]["resourceVersion"] = self._next_rv()
            if merged.get("spec") != cur.get("spec"):
                merged["metadata"]["generation"] = (
                    get_nested(cur, "metadata", "generation", default=1) or 1) + 1
            merged = freeze_obj(merged)
            self._store[key] = merged
        self._publish("MODIFIED", merged)
        return merged

    def delete(self, api_version, kind, name, namespace=None):
        self._count("delete")
        key = self._key(api_version, kind, name, namespace)
        with self._lock:
            obj = self._store.pop(key, None)
            if obj is not None:
                # deletion gets its own RV (real apiserver semantics) so a
                # since_rv resume positioned before it replays the DELETED
                self._tombstones[key] = int(self._next_rv())
                gone = get_nested(obj, "metadata", "uid")
                left = self._live_uids.get(gone, 0) - 1
                if left > 0:
                    self._live_uids[gone] = left
                else:
                    self._live_uids.pop(gone, None)
        if obj is None:
            raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
        self._publish("DELETED", obj)
        # ownerReference garbage collection (background-policy approximation)
        uid = get_nested(obj, "metadata", "uid")
        if uid:
            with self._lock:
                owned = [
                    o for o in self._store.values()
                    if any(r.get("uid") == uid for r in
                           get_nested(o, "metadata", "ownerReferences", default=[]) or [])
                ]
            for o in owned:
                try:
                    self.delete(o.get("apiVersion", ""), o.get("kind", ""),
                                name_of(o), namespace_of(o) or None)
                except NotFoundError:
                    pass

    def watch(self, api_version, kind, handler, since_rv=None):
        # Hold the store lock across replay + subscribe so a concurrent
        # create can't land between them and lose its ADDED event. (A
        # duplicate ADDED is possible and harmless — the workqueue dedups.)
        if since_rv is None:
            with self._lock:
                existing = self.list(api_version, kind)
                cancel = self.hub.subscribe(api_version, kind, handler)
            for obj in existing:
                handler(WatchEvent("ADDED", obj))
            return cancel
        # resume: replay only what moved after since_rv — changed objects
        # as MODIFIED plus tombstoned deletions as metadata-only DELETED
        # stubs — in RV order, so the subscriber heals O(delta) instead of
        # relisting the world.
        since = int(since_rv)
        with self._lock:
            self._count("watch")
            if (self.watch_window is not None
                    and self._rv - since > self.watch_window):
                raise WatchGoneError(
                    f"resourceVersion {since} is too old "
                    f"(head {self._rv}, window {self.watch_window})")
            replay = []
            for (av, k, ns, name), obj in self._store.items():
                if av != api_version or k != kind:
                    continue
                rv = int(get_nested(obj, "metadata", "resourceVersion"))
                if rv > since:
                    replay.append((rv, WatchEvent("MODIFIED", obj)))
            for (av, k, ns, name), trv in self._tombstones.items():
                if av != api_version or k != kind or trv <= since:
                    continue
                meta = {"name": name, "resourceVersion": str(trv)}
                if ns:
                    meta["namespace"] = ns
                replay.append((trv, WatchEvent("DELETED", freeze_obj(
                    {"apiVersion": av, "kind": k, "metadata": meta}))))
            cancel = self.hub.subscribe(api_version, kind, handler)
        for _, event in sorted(replay, key=lambda e: e[0]):
            handler(event)
        return cancel

    # -- cluster simulation ------------------------------------------------

    def add_node(self, name: str, labels: Optional[Mapping[str, str]] = None,
                 allocatable: Optional[Mapping[str, str]] = None,
                 runtime: str = "containerd://1.7.0") -> dict:
        """Fabricate a Node (the fake analog of a GPU VM joining)."""
        node = {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or {})},
            "spec": {},
            "status": {
                "allocatable": dict(allocatable or {}),
                "capacity": dict(allocatable or {}),
                "nodeInfo": {"containerRuntimeVersion": runtime},
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }
        return self.create(node)

    def _ds_scheduled_nodes(self, ds: Mapping) -> list:
        return ds_scheduled_nodes(self, ds)

    def simulate_kubelet(self, ready: bool = True, stale_hash: bool = False) -> None:
        simulate_kubelet(self, ready=ready, stale_hash=stale_hash)

    def simulate_pod_phase(self, name: str, namespace: str, phase: str) -> None:
        """Flip a standalone pod's phase (used to drive validator workload
        pods to Succeeded, the analog of validator/main.go:1173 waitForPod)."""
        pod = thaw_obj(self.get("v1", "Pod", name, namespace))
        set_nested(pod, phase, "status", "phase")
        self.update_status(pod)


# ---------------------------------------------------------------------------
# client-generic scheduler/kubelet simulation
# ---------------------------------------------------------------------------
# These operate through the abstract Client interface only, so the same
# simulation drives any Client implementation.


def ds_scheduled_nodes(client: Client, ds: Mapping) -> list:
    """Nodes a DaemonSet's pods land on, honoring nodeSelector + required
    node affinity (the scheduling surface the operator actually uses)."""
    tmpl_spec = get_nested(ds, "spec", "template", "spec", default={}) or {}
    node_selector = tmpl_spec.get("nodeSelector") or {}
    terms = get_nested(
        tmpl_spec, "affinity", "nodeAffinity",
        "requiredDuringSchedulingIgnoredDuringExecution", "nodeSelectorTerms",
        default=[]) or []
    out = []
    for node in client.list("v1", "Node"):
        nl = labels_of(node)
        if not match_labels(nl, node_selector):
            continue
        if terms and not match_node_selector_terms(nl, terms):
            continue
        out.append(node)
    return out


def simulate_kubelet(client: Client, ready: bool = True,
                     stale_hash: bool = False) -> None:
    """Advance every DaemonSet's status as a scheduler+kubelet would.

    Update-strategy-faithful: under ``OnDelete`` an existing pod keeps
    its controller-revision-hash label until something deletes it (only
    then does the recreated pod pick up the current template revision);
    under ``RollingUpdate`` pods move to the current revision on the
    next tick. ``updatedNumberScheduled`` is computed from actual pod
    hashes — this is what the OnDelete readiness check and the upgrade
    controller's per-node FSM key off (object_controls.go:3526-3602
    semantics).

    ``ready=True`` marks scheduled pods available; ``stale_hash=True``
    forces pods onto a fake outdated revision.

    Contention-safe: writes are skipped client-side when nothing would
    change (a steady-state tick is read-only), and a 409 on one
    DaemonSet — the operator wrote it between our list and our status
    write — abandons only that DaemonSet's tick, like a real kubelet
    catching up on its next sync, instead of aborting the whole pass.
    """
    for ds in client.list("apps/v1", "DaemonSet"):
        try:
            _kubelet_tick_ds(client, ds, ready=ready, stale_hash=stale_hash)
        except (ConflictError, NotFoundError, AlreadyExistsError):
            # the operator raced us on this DS (wrote it, deleted a pod,
            # or created one first); catch up on the next tick
            continue


def _kubelet_tick_ds(client: Client, ds: Mapping, ready: bool,
                     stale_hash: bool) -> None:
    # NB: DaemonSet pods tolerate the unschedulable taint, so cordoned
    # nodes still receive daemon pods — required for driver-pod
    # restarts during cordon+drain upgrades.
    nodes = ds_scheduled_nodes(client, ds)
    desired = len(nodes)
    revision = object_hash(get_nested(ds, "spec", "template", default={}))
    on_delete = get_nested(ds, "spec", "updateStrategy", "type",
                           default="RollingUpdate") == "OnDelete"
    ns = namespace_of(ds) or "default"
    tmpl_labels = get_nested(ds, "spec", "template", "metadata", "labels",
                             default={}) or {}
    updated = 0
    n_ready = 0
    base_hash = "stale" if stale_hash else revision
    phase = "Running" if ready else "Pending"
    ready_conds = [{"type": "Ready",
                    "status": "True" if ready else "False"}]
    for node in nodes:
        pod_name = f"{name_of(ds)}-{name_of(node)}"
        existing = client.get_or_none("v1", "Pod", pod_name, ns)
        if existing is not None:
            # OnDelete: the pod keeps its revision until deleted
            pod_hash = (get_nested(existing, "metadata", "labels",
                                   "controller-revision-hash")
                        if on_delete and not stale_hash else base_hash)
            new_labels = {**tmpl_labels,
                          "controller-revision-hash": pod_hash}
            if (existing["metadata"].get("labels") != new_labels
                    or get_nested(existing, "status", "phase") != phase
                    or get_nested(existing, "status",
                                  "conditions") != ready_conds):
                existing = thaw_obj(existing)
                existing["metadata"]["labels"] = new_labels
                set_nested(existing, phase, "status", "phase")
                set_nested(existing, ready_conds, "status", "conditions")
                client.update(existing)
        else:
            pod_hash = base_hash
            client.create({
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": pod_name,
                    "namespace": ns,
                    "labels": {**tmpl_labels,
                               "controller-revision-hash": pod_hash},
                    "ownerReferences": [{
                        "apiVersion": "apps/v1", "kind": "DaemonSet",
                        "name": name_of(ds),
                        "uid": get_nested(ds, "metadata", "uid"),
                        "controller": True,
                    }],
                },
                "spec": {"nodeName": name_of(node)},
                "status": {"phase": phase,
                           "conditions": list(ready_conds)},
            })
        if pod_hash == revision:
            updated += 1
        if ready:
            n_ready += 1
    status = {
        "desiredNumberScheduled": desired,
        "currentNumberScheduled": desired,
        "numberMisscheduled": 0,
        "numberReady": n_ready,
        "numberAvailable": n_ready,
        "updatedNumberScheduled": updated,
        "observedGeneration": get_nested(ds, "metadata", "generation",
                                         default=1),
    }
    cur = ds.get("status") or {}
    if any(cur.get(k) != v for k, v in status.items()):
        ds = thaw_obj(ds)
        ds["status"] = {**cur, **status}
        client.update_status(ds)

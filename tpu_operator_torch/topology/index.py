"""Incremental placement index: O(delta) fleet state for the scorer.

The port's counterpart of ``tpu_operator/topology/index.py``, over the
GPU domain model of ``placement.py``: a node is in the index when it
carries feature discovery's ``gpu.product`` label, its pool is its
(``gpu.product``, ``gpu.topology``), and its structural fingerprint has
no worker index (GPU nodes carry none; hosts are in name order).

``FleetState`` (placement.py) is rebuilt from a full node list on every
placement decision — at 10k nodes that is an O(fleet) re-partition per
request, and a storm of queued SliceRequests pays it thousands of times
over. ``FleetIndex`` is the long-lived alternative: built once from the
informer cache and thereafter maintained in O(delta) from watch events
(node add/delete, label flip, cordon/NotReady, lease annotation writes)
and from ``book``/``release`` calls.

Structure:

- node metadata (chips, generation, lease owner) is refreshed per
  delta'd node, never rescanned;
- NVLink-domain structure (the ``SliceGroup`` partitioning, the
  one-host chunking of a fabric that ends at the host included) is
  rebuilt only for the *pool* a changed
  node belongs to — a lease write that leaves the node's structural
  fingerprint alone skips even that;
- free runs are cached per domain and invalidated only when that
  domain's occupancy changes;
- per request-shape, scored candidates are cached per domain with the
  domain's best on a lazy-deletion heap. Occupancy edits (book,
  release, lease-annotation echoes) are folded into every cached shape
  *at write time* — a couple of domains re-scored behind an admission
  cache that skips incompatible domains at dict-lookup speed — so a
  ``best()`` query is a heap peek plus repair of whatever structural
  churn (pool rebuilds) happened since the shape was last asked. Query
  p99 is flat in fleet size; the write side absorbs the churn.

Candidates come from the same ``_group_candidates`` scoring path
``rank_candidates`` uses, so index-served rankings are byte-identical
to a from-scratch rescan (``tests/test_torch_placement_index.py`` holds
the two equal under interleavings of churn and booking).

``OPERATOR_PLACEMENT_INDEX=0`` (or false/no/off) is the kill switch:
the placement controller falls back to the per-request ``FleetState``
rescan path, restoring the previous behavior exactly.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Set, Tuple

from ..api import labels as L
from ..api.slicerequest import SliceRequestSpec
from ..runtime.objects import annotations_of, labels_of, name_of
from ..state.nodepool import NodePool
from ..workloads.hardware import CHIPS
from .placement import (
    Candidate,
    FleetState,
    Host,
    SliceGroup,
    _admitted_hosts,
    _group_candidates,
    _node_chips,
    _node_ready,
    _node_telemetry_ok,
    pool_generation,
    rank_candidates,
    unschedulable_reason,
)

# request-shape cache bound: oldest-inserted shapes are evicted first
_MAX_SPEC_ENTRIES = 64

_GroupKey = Tuple[str, str, str]  # (pool, slice_id, product)


def env_placement_index_enabled(env=None) -> bool:
    """The incremental index defaults ON; OPERATOR_PLACEMENT_INDEX=0
    (or false/no/off) restores the per-request FleetState rescan — same
    spelling as the other kill switches."""
    import os

    val = (env or os.environ).get("OPERATOR_PLACEMENT_INDEX", "1")
    return str(val).strip().lower() not in ("0", "false", "no", "off")


class PlacementIndexGate:
    """Process-wide switch for the incremental placement index.
    Disabled, the placement controller rebuilds FleetState per request
    exactly as before — the escape hatch when an index bug is
    suspected."""

    def __init__(self):
        self.enabled = env_placement_index_enabled()


PLACEMENT_INDEX_GATE = PlacementIndexGate()


def _pool_name(product: str, topology: str) -> str:
    """NodePool.name for a node's labels, without building the pool."""
    return NodePool(product=product, topology=topology).name


class _SpecEntry:
    """Cached candidate state for one request shape: per-domain scored
    fragments plus a lazy-deletion heap of domain bests."""

    __slots__ = ("spec", "dirty", "fragments", "heap", "admitted")

    def __init__(self, spec: SliceRequestSpec):
        # representative spec; any spec with this key scores identically
        self.spec = spec
        self.dirty: Set[_GroupKey] = set()  # domains to refragment
        self.fragments: Dict[_GroupKey, List[Candidate]] = {}
        self.heap: List[tuple] = []        # (sort_key, group_key, stamp)
        # (group object, admitted host count): _admitted_hosts is pure in
        # (spec, group structure), and groups are never mutated in place —
        # an identity hit means the count is still exact, so occupancy
        # dirties skip the admission math entirely
        self.admitted: Dict[_GroupKey, tuple] = {}


class FleetIndex:
    """Long-lived, incrementally-maintained bookable fleet view.

    Duck-types FleetState's read interface (``slices``, ``free_runs``,
    ``owner_of``, ``chip_totals``, ``utilization``) so the pure scoring
    functions — ``rank_candidates``, ``first_fit``,
    ``unschedulable_reason`` — run against it unchanged.
    """

    def __init__(self, nodes=()):
        # watch threads apply deltas while reconcile workers query;
        # reentrant because the scoring path re-enters free_runs/slices
        self._lock = threading.RLock()
        self.updates: Dict[str, int] = {}  # event kind -> applied count
        # fair-share admission registry: owner key -> quota-class name.
        # Registered by the placement controller at bind/adopt time and
        # deliberately NOT reset by replace()/resync() — a relist heal
        # must not wipe what the controller told us about its requests.
        self._owner_class: Dict[str, str] = {}
        self.replace(nodes)

    # -- full resync --------------------------------------------------------

    def replace(self, nodes) -> None:
        """Rebuild from a full node list (initial construction, or a
        relist heal). Everything incremental is derived from here."""
        with self._lock:
            self._replace(nodes)

    def _replace(self, nodes) -> None:
        self._nodes: Dict[str, dict] = {}
        self._struct: Dict[str, tuple] = {}
        self._pool_name_of: Dict[str, str] = {}
        self._pool_nodes: Dict[str, Set[str]] = {}
        self._groups: Dict[_GroupKey, SliceGroup] = {}
        self._groups_by_pool: Dict[str, Set[_GroupKey]] = {}
        self._group_of_node: Dict[str, _GroupKey] = {}
        self._runs: Dict[_GroupKey, List[List[Host]]] = {}
        self._group_ver: Dict[_GroupKey, int] = {}
        self._entries: Dict[tuple, _SpecEntry] = {}
        self._slices_cache: Optional[List[SliceGroup]] = None
        self.owner_of: Dict[str, str] = {}
        self._owner_nodes: Dict[str, Set[str]] = {}
        self._chips: Dict[str, int] = {}
        self._gen: Dict[str, str] = {}
        # per-class usage, folded O(delta): node -> (class, chips
        # counted) so removal never needs a live _chips lookup, and the
        # class -> chips rollup the admission layer reads per gang pass
        self._class_contrib: Dict[str, Tuple[str, int]] = {}
        self._class_usage: Dict[str, int] = {}
        pools: Set[str] = set()
        for node in nodes:
            name = name_of(node)
            nl = labels_of(node)
            if L.GPU_PRODUCT not in nl:
                continue
            self._nodes[name] = node
            self._struct[name] = self._fingerprint(node, nl)
            pn = _pool_name(nl.get(L.GPU_PRODUCT, ""),
                            nl.get(L.GPU_TOPOLOGY, ""))
            self._pool_name_of[name] = pn
            self._pool_nodes.setdefault(pn, set()).add(name)
            self._refresh_meta(name, node, dirty=False)
            pools.add(pn)
        self._rebuild_pools(pools)
        self.updates["replace"] = self.updates.get("replace", 0) + 1

    # -- O(delta) maintenance -----------------------------------------------

    @staticmethod
    def _fingerprint(node: dict, nl: Dict[str, str]) -> tuple:
        """Everything the *structure* (pool membership, slice identity,
        host eligibility) depends on. A delta that leaves this alone —
        e.g. a lease annotation write — only refreshes the node's
        occupancy, never re-partitions the pool. Host order is the
        name's, which a delta cannot move."""
        return (nl.get(L.GPU_PRODUCT, ""),
                nl.get(L.GPU_TOPOLOGY, ""),
                nl.get(L.GKE_NODEPOOL),
                _node_chips(node), _node_ready(node),
                _node_telemetry_ok(node))

    def resync(self, nodes) -> None:
        """Delta-feed from a full node list: diff against the held
        objects by resourceVersion and fold only the changes — the
        refresh path for clients without a delta-listener hook.
        Unchanged nodes cost one fingerprint compare; nothing is
        re-partitioned unless structure actually moved."""
        with self._lock:
            self.updates["resync"] = self.updates.get("resync", 0) + 1
            seen: Set[str] = set()
            for node in nodes:
                name = name_of(node)
                seen.add(name)
                prev = self._nodes.get(name)
                if prev is node:
                    continue
                prv = (prev or {}).get("metadata", {}).get("resourceVersion")
                nrv = node.get("metadata", {}).get("resourceVersion")
                if prev is not None and prv is not None and prv == nrv:
                    continue
                self.apply("MODIFIED" if prev is not None else "ADDED",
                           node)
            for name in [n for n in self._nodes if n not in seen]:
                self.apply("DELETED",
                           {"metadata": {"name": name}})

    def export_nodes(self) -> List[dict]:
        """Snapshot source: the held node objects (frozen cache views,
        shared zero-copy), sorted by name. ``FleetIndex(export_nodes())``
        rebuilds an equivalent index offline, and ``resync()`` then
        folds whatever changed since — the crash-restart warm path."""
        with self._lock:
            return [self._nodes[n] for n in sorted(self._nodes)]

    def apply(self, event_type: str, node: dict) -> None:
        """Fold one watch delta (ADDED/MODIFIED/DELETED) into the index."""
        with self._lock:
            self._apply(event_type, node)

    def _apply(self, event_type: str, node: dict) -> None:
        kind = str(event_type).lower()
        self.updates[kind] = self.updates.get(kind, 0) + 1
        name = name_of(node)
        nl = labels_of(node)
        if kind == "deleted" or L.GPU_PRODUCT not in nl:
            self._forget(name)
            return
        new_struct = self._fingerprint(node, nl)
        old_struct = self._struct.get(name)
        old_pool = self._pool_name_of.get(name)
        self._nodes[name] = node
        self._struct[name] = new_struct
        if new_struct == old_struct:
            # occupancy-only delta (lease annotation flip): refresh the
            # owner ledger, dirty just this node's domain, and propagate
            # eagerly — write-side work keeps query p99 flat
            touched: Set[_GroupKey] = set()
            self._refresh_meta(name, node, touched=touched)
            self._propagate(touched)
            return
        new_pool = _pool_name(new_struct[0], new_struct[1])
        self._pool_name_of[name] = new_pool
        if old_pool and old_pool != new_pool:
            self._pool_nodes.get(old_pool, set()).discard(name)
        self._pool_nodes.setdefault(new_pool, set()).add(name)
        self._refresh_meta(name, node, dirty=False)
        self._rebuild_pools({p for p in (old_pool, new_pool) if p})

    def _forget(self, name: str) -> None:
        self._nodes.pop(name, None)
        self._struct.pop(name, None)
        pn = self._pool_name_of.pop(name, None)
        if pn:
            self._pool_nodes.get(pn, set()).discard(name)
        self._chips.pop(name, None)
        self._gen.pop(name, None)
        self._set_owner(name, None, dirty=False)
        if pn:
            self._rebuild_pools({pn})

    def _refresh_meta(self, name: str, node: dict, dirty=True,
                      touched: Optional[Set[_GroupKey]] = None) -> None:
        """Per-node metadata. Chips/generation are gated on the same
        eligibility FleetState ingestion applies (known generation,
        chips > 0, Ready, not cordoned); the lease ledger records the
        annotation even on ineligible nodes — inert for scoring (hosts
        only exist for eligible nodes) but it lets ``owned_nodes`` find
        every lease the O(fleet) annotation scan would."""
        nl = labels_of(node)
        gen = pool_generation(nl.get(L.GPU_PRODUCT, ""))
        chips = _node_chips(node)
        if gen in CHIPS and chips > 0 and _node_ready(node) \
                and _node_telemetry_ok(node):
            self._chips[name] = chips
            self._gen[name] = gen
        else:
            self._chips.pop(name, None)
            self._gen.pop(name, None)
        owner = annotations_of(node).get(L.PLACED_BY) or None
        self._set_owner(name, owner, dirty=dirty, touched=touched)
        # chips can change while the owner stays put (capacity relabel,
        # eligibility flip) — re-fold the class contribution either way
        self._account(name)

    def _set_owner(self, name: str, owner: Optional[str], dirty=True,
                   touched: Optional[Set[_GroupKey]] = None) -> None:
        prev = self.owner_of.get(name)
        if prev == owner:
            return
        if prev is not None:
            held = self._owner_nodes.get(prev)
            if held is not None:
                held.discard(name)
                if not held:
                    self._owner_nodes.pop(prev, None)
            self.owner_of.pop(name, None)
        if owner is not None:
            self.owner_of[name] = owner
            self._owner_nodes.setdefault(owner, set()).add(name)
        self._account(name)
        if dirty:
            gk = self._group_of_node.get(name)
            if gk is not None:
                self._dirty(gk)
                if touched is not None:
                    touched.add(gk)

    def _dirty(self, gk: _GroupKey) -> None:
        self._group_ver[gk] = self._group_ver.get(gk, 0) + 1
        self._runs.pop(gk, None)
        for entry in self._entries.values():
            entry.dirty.add(gk)

    def _propagate(self, gks: Set[_GroupKey]) -> None:
        """Eagerly fold occupancy dirties into every cached shape.
        Occupancy edits (book/release, lease-annotation echoes) are the
        steady-state churn; paying their refragmentation on the write
        side — where the admission cache skips incompatible domains at
        dict-lookup speed — keeps ``best()`` a heap peek regardless of
        how long a shape sat idle. Structural edits stay lazy: a pool
        rebuild dirties every domain in the pool, and eagerly chasing
        those across all shapes would stall the watch thread."""
        if not gks:
            return
        for entry in self._entries.values():
            for gk in gks:
                if gk in entry.dirty:
                    self._refragment(entry, entry.spec, gk)
                    entry.dirty.discard(gk)

    def _rebuild_pools(self, pool_names: Set[str]) -> None:
        """Re-partition only the named pools into SliceGroups — the
        structural delta path. Cost is O(pool), not O(fleet)."""
        for pn in pool_names:
            for gk in self._groups_by_pool.pop(pn, set()):
                grp = self._groups.pop(gk, None)
                if grp is not None:
                    for h in grp.hosts:
                        if self._group_of_node.get(h.name) == gk:
                            self._group_of_node.pop(h.name, None)
                self._dirty(gk)
            members = [self._nodes[n]
                       for n in sorted(self._pool_nodes.get(pn, ()))]
            if not members:
                continue
            # a pool-sized FleetState produces exactly the groups the
            # full rebuild would for this pool (partitioning is
            # label-local), the one-host chunking included
            sub = FleetState(members)
            for grp in sub.slices:
                gk = (grp.pool, grp.slice_id, grp.product)
                self._groups[gk] = grp
                self._groups_by_pool.setdefault(pn, set()).add(gk)
                for h in grp.hosts:
                    self._group_of_node[h.name] = gk
                self._dirty(gk)
        self._slices_cache = None

    # -- lease ledger (FleetState-compatible) --------------------------------

    def book(self, node_names, owner: str) -> None:
        with self._lock:
            self.updates["book"] = self.updates.get("book", 0) + 1
            touched: Set[_GroupKey] = set()
            for n in node_names:
                self._set_owner(n, owner, touched=touched)
            self._propagate(touched)

    def release(self, node_names=None, owner: Optional[str] = None) -> None:
        with self._lock:
            self.updates["release"] = self.updates.get("release", 0) + 1
            touched: Set[_GroupKey] = set()
            if node_names is not None:
                for n in node_names:
                    self._set_owner(n, None, touched=touched)
            if owner is not None:
                for n in list(self._owner_nodes.get(owner, ())):
                    self._set_owner(n, None, touched=touched)
            self._propagate(touched)

    def owned_nodes(self, owner: str) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._owner_nodes.get(owner, ())))

    # -- per-class usage accounting (fair-share admission) -------------------

    def _account(self, name: str) -> None:
        """Re-fold one node's chip contribution into the per-class
        rollup. The stored (class, chips) pair is what gets removed, so
        ``_forget`` popping ``_chips`` before ``_set_owner`` can never
        leak usage."""
        prev = self._class_contrib.pop(name, None)
        if prev is not None:
            cls, chips = prev
            left = self._class_usage.get(cls, 0) - chips
            if left > 0:
                self._class_usage[cls] = left
            else:
                self._class_usage.pop(cls, None)
        owner = self.owner_of.get(name)
        if owner is None:
            return
        chips = self._chips.get(name, 0)
        if chips <= 0:
            return
        cls = self._owner_class.get(owner, "default")
        self._class_contrib[name] = (cls, chips)
        self._class_usage[cls] = self._class_usage.get(cls, 0) + chips

    def set_owner_class(self, owner: str, cls: Optional[str]) -> None:
        """Register (or with None, forget) which quota class an owner
        key charges. Re-folds only that owner's held nodes — O(lease),
        not O(fleet)."""
        with self._lock:
            if cls is None:
                if self._owner_class.pop(owner, None) is None:
                    return
            else:
                if self._owner_class.get(owner) == cls:
                    return
                self._owner_class[owner] = cls
            for n in list(self._owner_nodes.get(owner, ())):
                self._account(n)

    def class_usage(self) -> Dict[str, int]:
        """Chips currently leased per quota class (O(1) copy of the
        incrementally-maintained rollup)."""
        with self._lock:
            return dict(self._class_usage)

    def class_tflops(self) -> Dict[str, float]:
        """Peak-bf16-TFLOPs leased per class (throughput-normalized
        allocation input): chips x generation peak, summed over the
        contribution ledger — O(leases), called once per gang pass."""
        with self._lock:
            out: Dict[str, float] = {}
            for name, (cls, chips) in self._class_contrib.items():
                gen = self._gen.get(name, "")
                spec = CHIPS.get(gen)
                rate = spec.peak_bf16_tflops if spec is not None else 1.0
                out[cls] = out.get(cls, 0.0) + chips * rate
            return out

    def snapshot_state(self) -> FleetState:
        """A FleetState twin sharing this index's (immutable-in-place)
        group structure with an independent lease ledger — the trial
        board for preemption feasibility checks."""
        with self._lock:
            twin = FleetState.__new__(FleetState)
            twin.slices = list(self.slices)
            twin.owner_of = dict(self.owner_of)
            twin._owner_nodes = {o: set(ns)
                                 for o, ns in self._owner_nodes.items()}
            twin._chips = dict(self._chips)
            twin._gen = dict(self._gen)
            return twin

    # -- FleetState read interface ------------------------------------------

    @property
    def slices(self) -> List[SliceGroup]:
        with self._lock:
            if self._slices_cache is None:
                self._slices_cache = sorted(
                    self._groups.values(),
                    key=lambda s: (s.pool, s.slice_id))
            return self._slices_cache

    def free_runs(self, group: SliceGroup,
                  reclaim: Optional[str] = None) -> List[List[Host]]:
        with self._lock:
            return self._free_runs(group, reclaim)

    def _free_runs(self, group: SliceGroup,
                   reclaim: Optional[str] = None) -> List[List[Host]]:
        gk = (group.pool, group.slice_id, group.product)
        if reclaim is not None:
            owned = self._owner_nodes.get(reclaim)
            if owned and any(self._group_of_node.get(n) == gk
                             for n in owned):
                # reclaim touches this domain: compute live (rare —
                # only a request re-placing over its own stale leases)
                return FleetState.free_runs(self, group, reclaim=reclaim)
        runs = self._runs.get(gk)
        if runs is None:
            runs = FleetState.free_runs(self, group)
            self._runs[gk] = runs
        return runs

    def chip_totals(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return FleetState.chip_totals(self)

    def utilization(self) -> float:
        with self._lock:
            return FleetState.utilization(self)

    def digest_stats(self) -> Dict[str, object]:
        """The cell-digest source (the reference's federation/digest.py):
        one locked pass distilling this index into the handful of numbers
        a global router scores cells by — free/placed chips, per-generation
        free-chip headroom, a fragmentation score (1 - largest
        contiguous free run / total free: 0.0 is one solid block, →1.0
        is confetti), and the condemned-node count. O(domains) over the
        cached free-run structure, cheap enough for a per-publish call."""
        with self._lock:
            totals = FleetState.chip_totals(self)
            free = sum(b["free"] for b in totals.values())
            placed = sum(b["placed"] for b in totals.values())
            largest = 0
            for group in self.slices:
                for run in self._free_runs(group):
                    chips = sum(h.chips for h in run)
                    if chips > largest:
                        largest = chips
            condemned = sum(
                1 for node in self._nodes.values()
                if not _node_telemetry_ok(node))
            return {
                "hosts": len(self._chips),
                "chips_free": free,
                "chips_placed": placed,
                "utilization": (round(placed / (free + placed), 4)
                                if free + placed else 0.0),
                "headroom": {g: b["free"] for g, b in sorted(totals.items())},
                "fragmentation": (round(1.0 - largest / free, 4)
                                  if free else 0.0),
                "condemned": condemned,
            }

    # -- queries ------------------------------------------------------------

    @staticmethod
    def _spec_key(spec: SliceRequestSpec) -> tuple:
        return (spec.chips_needed(), spec.topology or "",
                spec.accelerator or "",
                tuple(spec.preferred_generations or ()))

    def _entry(self, spec: SliceRequestSpec) -> _SpecEntry:
        key = self._spec_key(spec)
        entry = self._entries.get(key)
        if entry is None:
            if len(self._entries) >= _MAX_SPEC_ENTRIES:
                self._entries.pop(next(iter(self._entries)))
            entry = _SpecEntry(spec)
            self._entries[key] = entry
            for gk in self._groups:
                self._refragment(entry, spec, gk)
        else:
            self._sync(entry)
        return entry

    def _sync(self, entry: _SpecEntry) -> None:
        # only structural leftovers live here — occupancy dirties were
        # propagated at write time — so the query path is a heap peek
        # plus however many pool rebuilds happened since the last look
        if entry.dirty:
            for gk in tuple(entry.dirty):
                self._refragment(entry, entry.spec, gk)
            entry.dirty.clear()
        # lazy-deletion garbage bound: when stale heap entries dominate,
        # rebuild from the live fragments (amortized O(1) per push)
        if len(entry.heap) > 64 + 4 * len(entry.fragments):
            ver = self._group_ver
            entry.heap = [(frag[0].sort_key(), gk, ver.get(gk, 0))
                          for gk, frag in entry.fragments.items()]
            heapq.heapify(entry.heap)

    def _refragment(self, entry: _SpecEntry, spec: SliceRequestSpec,
                    gk: _GroupKey) -> None:
        group = self._groups.get(gk)
        if group is None:
            entry.fragments.pop(gk, None)
            entry.admitted.pop(gk, None)
            return
        cached = entry.admitted.get(gk)
        if cached is not None and cached[0] is group:
            h = cached[1]
        else:
            chips_needed = spec.chips_needed()
            h = _admitted_hosts(spec, group, chips_needed) \
                if chips_needed > 0 else 0
            entry.admitted[gk] = (group, h)
        if not h:
            entry.fragments.pop(gk, None)
            return
        frag: List[Candidate] = []
        runs = self.free_runs(group)
        if runs:
            frag = _group_candidates(spec, group, runs, h)
            frag.sort(key=Candidate.sort_key)
        if frag:
            entry.fragments[gk] = frag
            heapq.heappush(entry.heap, (frag[0].sort_key(), gk,
                                        self._group_ver.get(gk, 0)))
        else:
            entry.fragments.pop(gk, None)

    def best(self, spec: SliceRequestSpec,
             reclaim: Optional[str] = None) -> Optional[Candidate]:
        """The top-ranked candidate — identical to
        ``rank_candidates(spec, fleet)[0]`` — served from the per-shape
        heap: O(dirtied domains) since the last query, flat in fleet
        size."""
        with self._lock:
            if spec.chips_needed() <= 0:
                return None
            if reclaim is not None and self._owner_nodes.get(reclaim):
                ranked = rank_candidates(spec, self, reclaim=reclaim)
                return ranked[0] if ranked else None
            entry = self._entry(spec)
            heap = entry.heap
            while heap:
                sk, gk, stamp = heap[0]
                frag = entry.fragments.get(gk)
                if (frag and stamp == self._group_ver.get(gk, 0)
                        and frag[0].sort_key() == sk):
                    return frag[0]
                heapq.heappop(heap)
            return None

    def rank(self, spec: SliceRequestSpec,
             reclaim: Optional[str] = None) -> List[Candidate]:
        """Full ranked candidate list, byte-identical to
        ``rank_candidates`` over a from-scratch FleetState."""
        with self._lock:
            return rank_candidates(spec, self, reclaim=reclaim)

    def unschedulable_reason(self, spec: SliceRequestSpec) -> str:
        with self._lock:
            return unschedulable_reason(spec, self)

    # -- introspection -------------------------------------------------------

    def index_stats(self) -> Dict[str, object]:
        """Deterministic snapshot for the debug surfaces and the
        placement benchmarks."""
        with self._lock:
            return self._index_stats()

    def _index_stats(self) -> Dict[str, object]:
        return {
            "nodes": len(self._nodes),
            "eligible_hosts": len(self._chips),
            "pools": len(self._pool_nodes),
            "domains": len(self._groups),
            "leases": len(self.owner_of),
            "owners": len(self._owner_nodes),
            "quota_classes": len(self._class_usage),
            "cached_runs": len(self._runs),
            "spec_shapes": len(self._entries),
            "heap_entries": sum(len(e.heap)
                                for e in self._entries.values()),
            "dirty_pending": sum(len(e.dirty)
                                 for e in self._entries.values()),
            "updates": dict(sorted(self.updates.items())),
        }

"""Heterogeneity-aware slice placement engine.

The port's counterpart of ``tpu_operator/topology/placement.py``: the
policy layer of Gavel (*Heterogeneity-Aware Cluster Scheduling Policies
for Deep Learning Workloads*, PAPERS.md) reconciled as Kubernetes state.
A ``SliceRequest`` asks for cards, the engine bin-packs it onto the
fleet's GPU pools and the controller (controllers/placement_controller.py)
binds the decision via node leases.

The GPU domain model (the reference models a TPU torus):

- a pool is one (``gpu.product``, ``gpu.topology``) of nodes
  (``state/nodepool.py``); its generation is ``chip_spec_for(product)``;
- an NVLink domain is one slice (GKE's nodepool, ``slices_of``) of an
  ``mnnvl`` pool, whose NVLink spans hosts: its capacity is its hosts'
  cards. Every other fabric's domain is one host: NVLink (through
  NVSwitches or bridges) or PCIe ends at the host;
- hosts are in name order (GPU nodes carry no worker index), and the
  host grid is one row, since NVSwitch is all-to-all: a contiguous
  window of hosts scores adjacency 1.0.

Scoring combines three normalized terms plus a preference bonus:

- **throughput** — the pool generation's per-card bf16 peak from the
  ChipSpec table, normalized against the fastest known generation;
- **adjacency** — the fraction of grid-neighbor links the chosen hosts
  realize on the domain's host grid;
- **fragmentation** — domain tightness: prefer the placement that
  consumes its NVLink domain most completely (filling a whole domain is
  perfect), so a small request lands on the smallest domain that fits
  and the largest domains are left standing for the requests that need
  them.

Validity is strict: all hosts of a placement come from ONE NVLink domain
and form a contiguous run in host order: the engine never stitches a
domain across hosts that share no NVLink. A naive ``first_fit`` baseline
shares the validity rule but takes the first fitting window; the
utilization gap between the two is measured by ``run_placement_bench``.

Everything here is pure and deterministic: no clocks, no RNG, total
ordering on every ranking.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import labels as L
from ..api.slicerequest import SliceRequestSpec
from ..runtime.objects import (
    annotations_of,
    get_nested,
    labels_of,
    name_of,
)
from ..state.nodepool import NodePool, fabric_of, get_node_pools, slices_of
from ..workloads.hardware import CHIPS, chip_spec_for

# scoring weights; they sum to 1.0 so the composite (before the preference
# bonus) stays in [0, 1] and the explainer's per-term columns are comparable
W_THROUGHPUT = 0.45
W_FRAGMENTATION = 0.30
W_ADJACENCY = 0.25
# bonus ceiling for spec.preferredGenerations (rank-scaled, additive).
# Kept below W_FRAGMENTATION's typical exact-fit-vs-nibble gap so a soft
# preference steers between equally tight domains but never overrides
# big-domain protection
PREFERENCE_BONUS = 0.10

# the normalization anchor for the throughput term: fastest known card
_MAX_PEAK = max(c.peak_bf16_tflops for c in CHIPS.values())


def _node_ready(node: dict) -> bool:
    if get_nested(node, "spec", "unschedulable", default=False):
        return False
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in get_nested(node, "status", "conditions",
                                   default=[]) or [])


def _node_telemetry_ok(node: dict) -> bool:
    """False only when the telemetry scorer has *condemned* the node
    (GPUTelemetryHealthy condition at status False, raised after
    sustained FAIL digests). Absent condition means healthy: telemetry
    is advisory until it has evidence, and a node that merely stops
    reporting keeps its placements."""
    for c in get_nested(node, "status", "conditions", default=[]) or []:
        if c.get("type") == L.TELEMETRY_CONDITION:
            return c.get("status") != "False"
    return True


def _node_chips(node: dict) -> int:
    nl = labels_of(node)
    raw = nl.get(L.GKE_ACCELERATOR_COUNT) or get_nested(
        node, "status", "allocatable", L.GPU_RESOURCE, default="") or "0"
    try:
        return int(str(raw))
    except ValueError:
        return 0


def pool_generation(product: str) -> str:
    """The hardware table's key for a ``gpu.product`` value, or ``""``
    when the table does not know the card."""
    spec = chip_spec_for(product)
    return spec.generation if spec is not None else ""


def _coords(index: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for size in reversed(shape):
        out.append(index % size)
        index //= size
    return tuple(reversed(out))


@dataclass(frozen=True)
class Host:
    name: str
    index: int           # position within the domain (host name order)
    chips: int


def _partition_slice(slice_id: str, hosts: List["Host"],
                     expected: int = 0):
    """Split one slice of a pool into NVLink domains. ``expected`` is
    the hosts a domain holds: 1 for a fabric that ends at the host, 0
    for an ``mnnvl`` slice, which is one domain whatever its size. The
    name-ordered hosts are chunked into consecutive ``expected``-host
    domains (the reference's unlabeled path: GPU nodes carry no worker
    index)."""
    if not hosts:
        return []
    if expected and len(hosts) > expected:
        out = []
        ordered = sorted(hosts, key=lambda h: h.name)
        for j in range(0, len(ordered), expected):
            chunk = [Host(name=h.name, index=k, chips=h.chips)
                     for k, h in enumerate(ordered[j:j + expected])]
            out.append((f"{slice_id}/{j // expected}", chunk))
        return out
    return [(slice_id, sorted(hosts, key=lambda h: (h.index, h.name)))]


@dataclass
class SliceGroup:
    """One NVLink domain of one pool: the unit placements never cross."""

    pool: str            # NodePool.name, e.g. nvidia-gb200-mnnvl-4
    slice_id: str
    product: str
    generation: str
    topology: str
    hosts: List[Host] = field(default_factory=list)
    host_grid: Tuple[int, ...] = (1,)
    capacity: int = 0    # cards the domain holds, eligible or not

    @property
    def chips_per_host(self) -> int:
        return self.hosts[0].chips if self.hosts else 0

    @property
    def total_chips(self) -> int:
        return sum(h.chips for h in self.hosts)


@dataclass(frozen=True)
class Candidate:
    """One scored placement option: a contiguous host window in a domain."""

    pool: str
    slice_id: str
    product: str
    generation: str
    nodes: Tuple[str, ...]
    chips: int
    score: float
    breakdown: Dict[str, float]

    def sort_key(self) -> tuple:
        return (-self.score, self.pool, self.slice_id, self.nodes)


class FleetState:
    """Bookable view of the fleet: pools -> domains -> hosts, with a lease
    ledger. Built once from a node LIST (CachedClient-served in the
    controller) and updated incrementally via book/release so a bench can
    stream thousands of requests without rebuilding."""

    def __init__(self, nodes: List[dict]):
        self.slices: List[SliceGroup] = []
        self.owner_of: Dict[str, str] = {}     # node -> lease key
        self._owner_nodes: Dict[str, set] = {}  # lease key -> node names
        self._chips: Dict[str, int] = {}       # node -> cards
        self._gen: Dict[str, str] = {}         # node -> generation
        nodes_by_name = {name_of(n): n for n in nodes}
        for pool in get_node_pools(nodes):
            self._ingest_pool(pool, nodes_by_name)
        self.slices.sort(key=lambda s: (s.pool, s.slice_id))

    def _ingest_pool(self, pool: NodePool, nodes_by_name: Dict[str, dict]):
        gen = pool_generation(pool.product)
        if gen not in CHIPS:
            return
        for slice_id, members in sorted(slices_of(pool,
                                                  nodes_by_name).items()):
            hosts = []
            capacity = 0
            for i, node_name in enumerate(sorted(members)):
                node = nodes_by_name[node_name]
                chips = _node_chips(node)
                capacity += max(0, chips)
                if chips <= 0 or not _node_ready(node) \
                        or not _node_telemetry_ok(node):
                    continue
                hosts.append(Host(name=node_name, index=i, chips=chips))
                self._chips[node_name] = chips
                self._gen[node_name] = gen
                lease = annotations_of(node).get(L.PLACED_BY)
                if lease:
                    self.owner_of[node_name] = lease
                    self._owner_nodes.setdefault(lease, set()).add(node_name)
            expected = 0 if pool.multi_host else 1
            for sub_id, sub_hosts in _partition_slice(
                    slice_id, hosts, expected=expected):
                self.slices.append(SliceGroup(
                    pool=pool.name, slice_id=sub_id,
                    product=pool.product, generation=gen,
                    topology=pool.topology, hosts=sub_hosts,
                    host_grid=(max(len(sub_hosts), 1),),
                    capacity=(capacity if pool.multi_host
                              else sub_hosts[0].chips)))

    # -- lease ledger -------------------------------------------------------

    def book(self, node_names, owner: str) -> None:
        for n in node_names:
            prev = self.owner_of.get(n)
            if prev is not None and prev != owner:
                self._drop_owned(prev, n)
            self.owner_of[n] = owner
            self._owner_nodes.setdefault(owner, set()).add(n)

    def release(self, node_names=None, owner: Optional[str] = None) -> None:
        if node_names is not None:
            for n in node_names:
                prev = self.owner_of.pop(n, None)
                if prev is not None:
                    self._drop_owned(prev, n)
        if owner is not None:
            # reverse index: O(nodes this owner holds), not O(all leases)
            for n in self._owner_nodes.pop(owner, ()):
                self.owner_of.pop(n, None)

    def _drop_owned(self, owner: str, node_name: str) -> None:
        held = self._owner_nodes.get(owner)
        if held is not None:
            held.discard(node_name)
            if not held:
                self._owner_nodes.pop(owner, None)

    def owned_nodes(self, owner: str) -> Tuple[str, ...]:
        """Nodes currently leased to ``owner``, name-sorted."""
        return tuple(sorted(self._owner_nodes.get(owner, ())))

    def clone(self) -> "FleetState":
        """Cheap trial copy: the immutable domain structure is shared,
        only the lease ledger is copied — what a preemption feasibility
        gate needs without re-ingesting the fleet."""
        twin = FleetState.__new__(FleetState)
        twin.slices = self.slices
        twin.owner_of = dict(self.owner_of)
        twin._owner_nodes = {o: set(ns)
                             for o, ns in self._owner_nodes.items()}
        twin._chips = self._chips
        twin._gen = self._gen
        return twin

    def free_runs(self, group: SliceGroup,
                  reclaim: Optional[str] = None) -> List[List[Host]]:
        """Maximal runs of free hosts in host order. ``reclaim`` treats
        hosts leased to that owner as free (a request re-placing itself)."""
        runs: List[List[Host]] = []
        cur: List[Host] = []
        prev_index = None
        for h in group.hosts:
            owner = self.owner_of.get(h.name)
            free = owner is None or owner == reclaim
            contiguous = prev_index is not None and h.index == prev_index + 1
            if free and (contiguous or not cur):
                cur.append(h)
            elif free:
                if cur:
                    runs.append(cur)
                cur = [h]
            else:
                if cur:
                    runs.append(cur)
                cur = []
            prev_index = h.index
        if cur:
            runs.append(cur)
        return runs

    # -- totals (gauges / bench) -------------------------------------------

    def chip_totals(self) -> Dict[str, Dict[str, int]]:
        """{generation: {"free": cards, "placed": cards}} over eligible
        nodes — the gpu_operator_fleet_chips gauge feed."""
        out: Dict[str, Dict[str, int]] = {}
        for node, chips in self._chips.items():
            gen = self._gen[node]
            bucket = out.setdefault(gen, {"free": 0, "placed": 0})
            bucket["placed" if node in self.owner_of else "free"] += chips
        return out

    def utilization(self) -> float:
        total = sum(self._chips.values())
        if not total:
            return 0.0
        placed = sum(c for n, c in self._chips.items() if n in self.owner_of)
        return placed / total


# -- scoring ----------------------------------------------------------------


def _hosts_needed(chips: int, chips_per_host: int) -> int:
    return max(1, -(-chips // max(1, chips_per_host)))


def _slice_capacity(group: SliceGroup) -> int:
    """Cards one NVLink domain of this pool can offer: an ``mnnvl``
    domain's hosts' cards, else one host's."""
    return group.capacity or group.chips_per_host


def _adjacency(window: List[Host], group: SliceGroup) -> float:
    """Fraction of realizable grid-neighbor links the window achieves:
    1.0 for a single host or a contiguous run on the domain's one-row
    grid. Normalized by (n-1), the links of a path — the minimum for any
    connected shape — so the score rewards compactness without needing
    the optimal-block link count."""
    n = len(window)
    if n <= 1:
        return 1.0
    coords = [_coords(h.index, group.host_grid) for h in window]
    links = 0
    for i in range(n):
        for j in range(i + 1, n):
            if sum(abs(a - b) for a, b in zip(coords[i], coords[j])) == 1:
                links += 1
    return min(1.0, links / (n - 1))


def _fragmentation(domain_hosts: int, h: int) -> float:
    """Domain tightness: how completely the placement consumes its
    NVLink domain. Filling a whole domain scores 1.0; carving h hosts out
    of a much larger domain scores h/domain_hosts. Measured against the
    domain — not the free run — so a small request refilling a churn
    hole inside a big domain still scores low, and the biggest domains
    survive for the requests that need them."""
    return h / domain_hosts if domain_hosts > 0 else 0.0


def _preference(spec: SliceRequestSpec, generation: str) -> float:
    prefs = [g for g in (spec.preferred_generations or []) if g]
    if not prefs or generation not in prefs:
        return 0.0
    rank = prefs.index(generation)
    return PREFERENCE_BONUS * (len(prefs) - rank) / len(prefs)


def _topology_fits(spec: SliceRequestSpec, group: SliceGroup) -> bool:
    """``spec.topology`` names a fabric (``mnnvl``) or a whole topology
    value (``mnnvl-4``); the domain's pool must have it."""
    want = str(spec.topology or "").strip().lower()
    if not want:
        return True
    have = str(group.topology or "").lower()
    return want in (have, fabric_of(have))


def _windows(run_len: int, h: int, row: int) -> List[int]:
    """Candidate window start offsets inside a free run: both edges (the
    fragmentation-optimal picks) plus grid-row-aligned interior starts
    (the adjacency-optimal picks)."""
    starts = {0, run_len - h}
    if row > 1:
        starts.update(s for s in range(0, run_len - h + 1)
                      if (s % row) == 0)
    return sorted(s for s in starts if 0 <= s <= run_len - h)


def _admitted_hosts(spec: SliceRequestSpec, group: SliceGroup,
                    chips_needed: int) -> int:
    """Hosts ``spec`` needs inside ``group``, or 0 when the domain cannot
    admit the request at all (pin mismatch, fabric misfit, capacity). Pure
    function of spec and group structure — independent of occupancy, so
    the incremental index caches it per (spec, domain)."""
    if spec.accelerator and group.product != spec.accelerator:
        return 0
    if not _topology_fits(spec, group):
        return 0
    if chips_needed > _slice_capacity(group):
        return 0  # a request never spans NVLink domains
    h = _hosts_needed(chips_needed, group.chips_per_host)
    if h > len(group.hosts):
        return 0
    return h


def _group_candidates(spec: SliceRequestSpec, group: SliceGroup,
                      runs: List[List[Host]], h: int) -> List[Candidate]:
    """Every scored window for ``spec`` inside one NVLink domain, given
    the domain's free runs and the admitted host count ``h``. The single
    shared scoring path: rank_candidates and the incremental FleetIndex
    both call this, so index-served candidates are the rescan candidates
    by construction."""
    out: List[Candidate] = []
    throughput = CHIPS[group.generation].peak_bf16_tflops / _MAX_PEAK
    pref = _preference(spec, group.generation)
    row = group.host_grid[-1] if group.host_grid else 1
    for run in runs:
        if len(run) < h:
            continue
        for s in _windows(len(run), h, row):
            window = run[s:s + h]
            adj = _adjacency(window, group)
            frag = _fragmentation(len(group.hosts), h)
            score = (W_THROUGHPUT * throughput + W_ADJACENCY * adj
                     + W_FRAGMENTATION * frag + pref)
            out.append(Candidate(
                pool=group.pool, slice_id=group.slice_id,
                product=group.product,
                generation=group.generation,
                nodes=tuple(host.name for host in window),
                chips=sum(host.chips for host in window),
                score=round(score, 6),
                breakdown={
                    "throughput": round(throughput, 6),
                    "adjacency": round(adj, 6),
                    "fragmentation": round(frag, 6),
                    "preference": round(pref, 6),
                }))
    return out


def rank_candidates(spec: SliceRequestSpec, fleet: FleetState,
                    reclaim: Optional[str] = None) -> List[Candidate]:
    """All valid placements for ``spec``, best first, with per-term score
    breakdown. Deterministic total order."""
    chips_needed = spec.chips_needed()
    if chips_needed <= 0:
        return []
    out: List[Candidate] = []
    for group in fleet.slices:
        h = _admitted_hosts(spec, group, chips_needed)
        if not h:
            continue
        runs = fleet.free_runs(group, reclaim=reclaim)
        if not runs:
            continue
        out.extend(_group_candidates(spec, group, runs, h))
    out.sort(key=Candidate.sort_key)
    return out


def place(spec: SliceRequestSpec, fleet: FleetState,
          reclaim: Optional[str] = None) -> Optional[Candidate]:
    ranked = rank_candidates(spec, fleet, reclaim=reclaim)
    return ranked[0] if ranked else None


def first_fit(spec: SliceRequestSpec, fleet: FleetState,
              reclaim: Optional[str] = None) -> Optional[Candidate]:
    """Naive baseline: same validity rule (one domain, contiguous run),
    zero scoring — the first window in (pool, domain, run) order wins. The
    bench's utilization comparison point."""
    chips_needed = spec.chips_needed()
    if chips_needed <= 0:
        return None
    for group in fleet.slices:
        if not _admitted_hosts(spec, group, chips_needed):
            continue
        h = _hosts_needed(chips_needed, group.chips_per_host)
        for run in fleet.free_runs(group, reclaim=reclaim):
            if len(run) < h:
                continue
            window = run[:h]
            return Candidate(
                pool=group.pool, slice_id=group.slice_id,
                product=group.product, generation=group.generation,
                nodes=tuple(host.name for host in window),
                chips=sum(host.chips for host in window),
                score=0.0, breakdown={})
    return None


def unschedulable_reason(spec: SliceRequestSpec, fleet: FleetState) -> str:
    """Deterministic operator-readable reason for a failed placement."""
    chips_needed = spec.chips_needed()
    if chips_needed <= 0:
        return "request asks for 0 chips"
    eligible = [g for g in fleet.slices
                if (not spec.accelerator
                    or g.product == spec.accelerator)
                and _topology_fits(spec, g)]
    if spec.accelerator and not eligible:
        return f"no pools match accelerator pin {spec.accelerator!r}"
    if not eligible:
        return (f"no pool topology admits requested topology "
                f"{spec.topology!r}")
    max_cap = 0
    cap_pool = ""
    for g in eligible:
        cap = _slice_capacity(g)
        if cap > max_cap:
            max_cap, cap_pool = cap, g.pool
    if chips_needed > max_cap:
        return (f"{chips_needed} chips requested; largest NVLink domain "
                f"offers {max_cap} chips (pool {cap_pool})")
    best_free = 0
    best_pool = ""
    for g in eligible:
        if chips_needed > _slice_capacity(g):
            continue
        for run in fleet.free_runs(g):
            free = sum(host.chips for host in run)
            if free > best_free:
                best_free, best_pool = free, g.pool
    if best_free == 0:
        return f"{chips_needed} chips requested; no free capacity"
    return (f"{chips_needed} chips requested; largest free contiguous "
            f"run in an admitting domain is {best_free} chips "
            f"(pool {best_pool})")

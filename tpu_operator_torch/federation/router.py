"""The global router: digest-scored cell choice behind circuit breakers.

The port's copy of ``tpu_operator/federation/router.py``. A request's
generation, where it pins one, is its ``gpu.product`` pin's generation
in the port's hardware table (:func:`request_generation`); the reference
reads a GKE TPU accelerator label's.

One router instance owns the federation's *coarse* decision — which
cell a SliceRequest lands in — and nothing else: the chosen cell's own
placement engine does the fine placement. Three design rules keep the
global plane robust to exactly the failures that kill naive federations:

- **Per-cell circuit breaker** (Healthy → Suspect → Open): a failure
  streak against a cell's apiserver opens the breaker; an Open cell is
  never routed to, and is re-contacted only by capped-exponential-
  backoff probes — a partitioned cell costs the router one cheap probe
  per backoff window, not a timeout per request.
- **Age-discounted digests**: a stale digest is discounted toward
  zero, never trusted at face value — a cell that went quiet fades out
  of the score race instead of absorbing traffic its last words said
  it could take.
- **Arrival-order independence**: digests dedupe by (cell, seq), so
  the router's decision is a pure function of the digest set it holds
  and the clock — two routers fed the same digests in any order agree
  (the split-brain-router chaos scenario and the seeded permutation
  test both pin this).

Requests already bound in a partitioned cell are left alone — partition
is not death. Only past ``condemnation_horizon_s`` of continuous Open
does the federation condemn the cell and migrate its slices out by
replaying the elastic handshake (runtime/multicell.py).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

from ..api import labels as L
from ..api.slicerequest import KIND_SLICE_REQUEST, V1ALPHA1
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.client import ListOptions
from ..runtime.objects import annotations_of, get_nested, name_of
from ..topology.placement import pool_generation
from .digest import parse_cell_digest

CELL_HEALTHY = "Healthy"
CELL_SUSPECT = "Suspect"
CELL_OPEN = "Open"

# breaker tuning (same shape as the cache's degraded-mode breaker:
# streak threshold, then capped exponential backoff between probes)
FAILURE_THRESHOLD = 3
PROBE_BACKOFF_BASE_S = 10.0
PROBE_BACKOFF_CAP_S = 300.0
# a digest this old scores at half weight; twice this, a third; ...
DIGEST_HALF_LIFE_S = 60.0
# continuous-Open time before a cell's bound slices are condemned to
# cross-cell migration
CONDEMNATION_HORIZON_S = 600.0
# a locality-preferred cell wins while it scores at least this fraction
# of the best cell — locality steers between comparable cells, it never
# overrides a collapsed one
LOCALITY_TOLERANCE = 0.5
# Suspect cells stay routable (one blip must not drain a cell) but at a
# discount, so a healthy twin wins ties
SUSPECT_PENALTY = 0.5

ROUTER_STATE_VERSION = 1


def request_generation(accelerator: Optional[str]) -> Optional[str]:
    """The generation a request's ``spec.accelerator`` pin (a
    ``gpu.product``) routes by, or None for an unpinned request."""
    return pool_generation(accelerator) or None if accelerator else None


class CellState:
    """One cell's breaker + digest view. Plain mutable record; all
    transitions go through the router so the ledger stays consistent."""

    __slots__ = ("name", "state", "failure_streak", "open_since",
                 "last_probe_at", "probes", "digest", "booked",
                 "booked_by_gen", "routed_total")

    def __init__(self, name: str):
        self.name = name
        self.state = CELL_HEALTHY
        self.failure_streak = 0
        self.open_since: Optional[float] = None
        self.last_probe_at: Optional[float] = None
        self.probes = 0
        self.digest: Optional[dict] = None
        # chips routed here since the held digest's seq — the router's
        # own book against over-committing a cell between publishes
        self.booked = 0
        self.booked_by_gen: Dict[str, int] = {}
        self.routed_total = 0

    def to_dict(self) -> dict:
        return {
            "state": self.state,
            "failure_streak": self.failure_streak,
            "open_since": self.open_since,
            "last_probe_at": self.last_probe_at,
            "probes": self.probes,
            "digest": self.digest,
            "booked": self.booked,
            "booked_by_gen": dict(sorted(self.booked_by_gen.items())),
            "routed_total": self.routed_total,
        }

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "CellState":
        cs = cls(name)
        cs.state = d.get("state", CELL_HEALTHY)
        cs.failure_streak = int(d.get("failure_streak", 0) or 0)
        cs.open_since = d.get("open_since")
        cs.last_probe_at = d.get("last_probe_at")
        cs.probes = int(d.get("probes", 0) or 0)
        cs.digest = parse_cell_digest(d.get("digest"))
        cs.booked = int(d.get("booked", 0) or 0)
        cs.booked_by_gen = {str(g): int(v) for g, v in
                            (d.get("booked_by_gen") or {}).items()}
        cs.routed_total = int(d.get("routed_total", 0) or 0)
        return cs


class GlobalRouter:
    def __init__(self, cells: Iterable[str], now: Callable[[], float],
                 failure_threshold: int = FAILURE_THRESHOLD,
                 probe_base_s: float = PROBE_BACKOFF_BASE_S,
                 probe_cap_s: float = PROBE_BACKOFF_CAP_S,
                 digest_half_life_s: float = DIGEST_HALF_LIFE_S,
                 condemnation_horizon_s: float = CONDEMNATION_HORIZON_S):
        self.now = now
        self.failure_threshold = max(1, int(failure_threshold))
        self.probe_base_s = float(probe_base_s)
        self.probe_cap_s = float(probe_cap_s)
        self.digest_half_life_s = float(digest_half_life_s)
        self.condemnation_horizon_s = float(condemnation_horizon_s)
        self.cells: Dict[str, CellState] = {
            name: CellState(name) for name in sorted(cells)}

    # -- digest ingest ------------------------------------------------------

    def observe_digest(self, raw) -> bool:
        """Fold one published digest. Dedupe is by (cell, seq): an echo
        or an out-of-order older publish is dropped, which is what makes
        the held view — and therefore every decision — independent of
        arrival order. Returns True when the view advanced."""
        d = parse_cell_digest(raw)
        if d is None:
            return False
        cs = self.cells.get(d["cell"])
        if cs is None:
            return False
        if cs.digest is not None and d["seq"] <= cs.digest["seq"]:
            return False
        cs.digest = d
        # a fresh publish supersedes the router's own booking ledger:
        # the cell has since counted its own leases
        cs.booked = 0
        cs.booked_by_gen = {}
        return True

    # -- breaker ------------------------------------------------------------

    def record_success(self, cell: str) -> None:
        cs = self.cells.get(cell)
        if cs is None:
            return
        healed = cs.state != CELL_HEALTHY
        cs.state = CELL_HEALTHY
        cs.failure_streak = 0
        cs.open_since = None
        cs.last_probe_at = None
        cs.probes = 0
        if healed:
            self._export_state(cs)

    def record_failure(self, cell: str) -> None:
        cs = self.cells.get(cell)
        if cs is None:
            return
        now = self.now()
        if cs.state == CELL_OPEN:
            # a failed probe: back off further, stay Open
            cs.probes += 1
            cs.last_probe_at = now
            OPERATOR_METRICS.federation_breaker_probes.labels(
                cell=cell).inc()
            return
        cs.failure_streak += 1
        if cs.failure_streak >= self.failure_threshold:
            cs.state = CELL_OPEN
            cs.open_since = now
            cs.last_probe_at = now
            cs.probes = 0
        else:
            cs.state = CELL_SUSPECT
        self._export_state(cs)

    def probe_due(self, cell: str) -> bool:
        """Whether an Open cell's next backoff probe has come due:
        base * 2^probes, capped — the breaker's only path back."""
        cs = self.cells.get(cell)
        if cs is None or cs.state != CELL_OPEN:
            return True
        wait = min(self.probe_cap_s,
                   self.probe_base_s * (2 ** min(cs.probes, 16)))
        anchor = cs.last_probe_at if cs.last_probe_at is not None \
            else (cs.open_since or 0.0)
        return self.now() >= anchor + wait

    def cells_to_contact(self) -> List[str]:
        """Which cells this pass should talk to: every non-Open cell,
        plus any Open cell whose probe is due."""
        return [name for name in sorted(self.cells)
                if self.cells[name].state != CELL_OPEN
                or self.probe_due(name)]

    def condemned_cells(self) -> List[str]:
        """Cells Open continuously past the condemnation horizon —
        their bound slices are cross-cell migration candidates."""
        now = self.now()
        return [name for name in sorted(self.cells)
                if self.cells[name].state == CELL_OPEN
                and self.cells[name].open_since is not None
                and now - self.cells[name].open_since
                >= self.condemnation_horizon_s]

    # -- scoring ------------------------------------------------------------

    def _age_discount(self, cs: CellState) -> float:
        if cs.digest is None:
            return 0.0
        age = max(0.0, self.now() - float(cs.digest.get("at", 0.0)))
        return 1.0 / (1.0 + age / self.digest_half_life_s)

    def _free_for(self, cs: CellState, chips: int,
                  generation: Optional[str]) -> int:
        if cs.digest is None:
            return 0
        if generation:
            free = int((cs.digest.get("headroom") or {})
                       .get(generation, 0))
            free -= cs.booked_by_gen.get(generation, 0)
        else:
            free = int(cs.digest.get("chips_free", 0)) - cs.booked
        return max(0, free)

    def score(self, cell: str, chips: int = 0,
              generation: Optional[str] = None) -> float:
        """Digest score for one cell: gen-aware free headroom, shaved by
        fragmentation and condemned count, discounted by digest age and
        the Suspect penalty. Pure function of (held digest, booking,
        breaker state, now) — no RNG, no iteration order."""
        cs = self.cells.get(cell)
        if cs is None or cs.state == CELL_OPEN or cs.digest is None:
            return 0.0
        free = self._free_for(cs, chips, generation)
        if free < max(1, chips):
            return 0.0
        frag = float(cs.digest.get("fragmentation", 0.0))
        condemned = int(cs.digest.get("condemned", 0))
        hosts = max(1, int(cs.digest.get("hosts", 1)))
        s = free * (1.0 - 0.5 * frag) * (1.0 - min(1.0, condemned / hosts))
        s *= self._age_discount(cs)
        if cs.state == CELL_SUSPECT:
            s *= SUSPECT_PENALTY
        return s

    def route(self, chips: int, generation: Optional[str] = None,
              locality: Optional[str] = None) -> Optional[dict]:
        """Choose a cell for a request of ``chips`` (optionally pinned
        to a generation, optionally carrying a data-locality preferred
        cell). Open cells never score. Returns the decision record, or
        None when no cell can take the request right now (it stays on
        the global queue). Books the routed chips against the winner's
        digest so back-to-back routes between publishes don't stampede
        one cell."""
        best_name, best_score = None, 0.0
        scores = {}
        for name in sorted(self.cells):
            s = self.score(name, chips=chips, generation=generation)
            scores[name] = s
            if s > best_score:
                best_name, best_score = name, s
        if best_name is None:
            OPERATOR_METRICS.federation_route_decisions.labels(
                outcome="no-cell").inc()
            return None
        reason = "digest-score"
        chosen = best_name
        if locality and locality != best_name:
            ls = scores.get(locality, 0.0)
            if ls >= LOCALITY_TOLERANCE * best_score and ls > 0.0:
                chosen, reason = locality, "locality"
        cs = self.cells[chosen]
        cs.booked += max(1, chips)
        if generation:
            cs.booked_by_gen[generation] = \
                cs.booked_by_gen.get(generation, 0) + max(1, chips)
        cs.routed_total += 1
        OPERATOR_METRICS.federation_route_decisions.labels(
            outcome="routed").inc()
        return {
            "cell": chosen,
            "score": round(scores[chosen], 4),
            "state": cs.state,
            "seq": cs.digest["seq"] if cs.digest else -1,
            "reason": reason,
        }

    # -- state persistence (runtime/snapshot.py federation section) ---------

    def snapshot(self) -> dict:
        """JSON-able router state: breaker ledgers + held digests. What
        a successor needs to keep partition decisions coherent across a
        router crash — in-flight migrations recover from the requests'
        own status, not from here."""
        return {
            "v": ROUTER_STATE_VERSION,
            "cells": {name: self.cells[name].to_dict()
                      for name in sorted(self.cells)},
        }

    def adopt(self, state: Optional[dict]) -> bool:
        """Warm-restore from :meth:`snapshot` output. Unknown versions
        and malformed payloads are refused (cold breaker state is safe;
        a half-parsed one is not)."""
        if not isinstance(state, dict) \
                or state.get("v") != ROUTER_STATE_VERSION:
            return False
        cells = state.get("cells")
        if not isinstance(cells, dict):
            return False
        for name, d in cells.items():
            if name in self.cells and isinstance(d, dict):
                self.cells[name] = CellState.from_dict(name, d)
        return True

    @classmethod
    def restore(cls, state: dict, cells: Iterable[str],
                now: Callable[[], float], **kwargs) -> "GlobalRouter":
        router = cls(cells, now=now, **kwargs)
        router.adopt(state)
        return router

    # -- observability ------------------------------------------------------

    def _export_state(self, cs: CellState) -> None:
        OPERATOR_METRICS.federation_cell_state.labels(cell=cs.name).set(
            {CELL_HEALTHY: 0, CELL_SUSPECT: 1, CELL_OPEN: 2}[cs.state])

    def export_metrics(self) -> None:
        now = self.now()
        for cs in self.cells.values():
            self._export_state(cs)
            age = (now - float(cs.digest.get("at", 0.0))
                   if cs.digest is not None else -1.0)
            OPERATOR_METRICS.federation_digest_age.labels(
                cell=cs.name).set(age)

    def report(self) -> dict:
        """The cells.json / `gpuop-cfg cells` payload: one row per cell
        with its breaker state, probe ledger, and held digest."""
        now = self.now()
        rows = {}
        for name in sorted(self.cells):
            cs = self.cells[name]
            rows[name] = {
                "state": cs.state,
                "failure_streak": cs.failure_streak,
                "open_for_s": (round(now - cs.open_since, 1)
                               if cs.open_since is not None else None),
                "probes": cs.probes,
                "routed_total": cs.routed_total,
                "digest_age_s": (round(now - float(cs.digest["at"]), 1)
                                 if cs.digest is not None else None),
                "digest": cs.digest,
            }
        return {"cells": rows,
                "condemnation_horizon_s": self.condemnation_horizon_s}


def cells_report(client, namespace: str,
                 router: Optional[GlobalRouter] = None) -> dict:
    """Cluster-derived federation report (the must-gather
    ``federation/cells.json`` source): SliceRequests grouped by their
    cell pin, merged with the live router's breaker view when one is
    reachable. Works against any client — a cluster with no federation
    plane yields an empty, well-formed report."""
    cells: Dict[str, dict] = {}
    unrouted = []
    for cr in sorted(client.list(V1ALPHA1, KIND_SLICE_REQUEST,
                                 ListOptions(namespace=namespace)),
                     key=name_of):
        pin = annotations_of(cr).get(L.CELL_PIN)
        row = {
            "name": name_of(cr),
            "phase": get_nested(cr, "status", "phase") or "Pending",
            "chips": get_nested(cr, "spec", "chips", default=0) or 0,
        }
        if pin:
            ent = cells.setdefault(pin, {"requests": [], "chips": 0})
            ent["requests"].append(row)
            ent["chips"] += int(row["chips"])
        else:
            unrouted.append(row)
    out = {"cells": {k: cells[k] for k in sorted(cells)},
           "unrouted": unrouted}
    if router is not None:
        out["router"] = router.report()
    return out

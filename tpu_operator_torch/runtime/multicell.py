"""Multi-cell harness: N operator cells under one global router.

The port's copy of ``tpu_operator/runtime/multicell.py``; a pinned
request's generation is read through ``federation.router.request_generation``
(a ``gpu.product`` pin).

Each :class:`Cell` is a full single-cluster control plane — its own
apiserver (FakeClient in tests/chaos), its own placement reconciler
pinned to the cell (``PlacementReconciler(cell=...)``), its own elastic
workload shims. The :class:`MultiCellHarness` runs the federation plane
over them:

- **contact/digest pass** — per breaker schedule
  (``router.cells_to_contact``), touch each cell's apiserver; success
  delivers that cell's fleet digest to the router, failure feeds its
  breaker. An Open cell is only touched when its backoff probe is due.
- **route pass** — drain the global queue through ``router.route``;
  a routed request is created in the chosen cell pre-pinned
  (``gpu.graft.dev/cell``), so the cell's placement rider picks it up.
- **migration pass** — slices bound in a *condemned* cell (Open past
  the condemnation horizon) are migrated cross-cell by replaying the
  elastic handshake: intent + checkpoint in the source cell, a pinned
  twin created in the destination, capacity rebound there, the shim's
  checkpoint store carried across so the workload resumes from its last
  acked step (the no-lost-work-cross-cell invariant). Every hop records
  a ``Cause(origin="cell/<src>")`` so ``gpuop-cfg why`` tells the
  cross-cluster story.

Every pass iterates cells and requests in sorted order and takes time
from the injected clock — the harness adds no nondeterminism of its
own, which is what lets chaos verdicts stay byte-identical per seed.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from ..api import labels as L
from ..api.slicerequest import (
    INTENT_MIGRATE,
    KIND_SLICE_REQUEST,
    MIG_CHECKPOINTED,
    MIG_MIGRATING,
    MIG_REBOUND,
    MIG_RESUMED,
    PHASE_PLACED,
    PHASE_UNSCHEDULABLE,
    V1ALPHA1,
)
from ..controllers.slices import (
    abort_migration,
    migration_of,
    post_intent,
    request_key,
)
from ..federation.digest import cell_digest
from ..federation.router import GlobalRouter, request_generation
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.client import ApiError, ListOptions
from ..runtime.objects import (
    annotations_of,
    get_nested,
    name_of,
    namespace_of,
    set_nested,
    thaw_obj,
)
from ..runtime.timeline import TIMELINE
from ..runtime.workqueue import Cause

log = logging.getLogger("tpu_operator_torch.multicell")

# how long a source cell gets to produce the checkpoint ack before the
# cross-cell attempt is abandoned (and retried from scratch later)
MIGRATE_DEADLINE_S = 240.0


class Cell:
    """One cell's control plane, as the harness sees it: a name, an
    apiserver client (possibly chaos-wrapped), the cell-pinned placement
    reconciler, and the cell's workload shims."""

    def __init__(self, name: str, client, reconciler=None,
                 namespace: str = "default"):
        self.name = name
        self.client = client
        self.reconciler = reconciler
        self.namespace = namespace
        self.shims: Dict[str, object] = {}

    def fleet_index(self):
        """The digest source: the reconciler's live index when it has
        one, else a fresh build from the cell's node list."""
        idx = getattr(self.reconciler, "fleet_index", None)
        if idx is not None:
            return idx
        from ..topology.index import FleetIndex

        return FleetIndex(self.client.list("v1", "Node"))


class MultiCellHarness:
    def __init__(self, router: GlobalRouter, cells: Dict[str, Cell],
                 now: Callable[[], float],
                 shim_factory: Optional[Callable] = None):
        self.router = router
        self.cells = dict(sorted(cells.items()))
        self.now = now
        # builds the destination-cell shim on a migration hop:
        # (cell, name, namespace, store) -> workload shim. None disables
        # shim portage (the CR-level handshake still completes).
        self.shim_factory = shim_factory
        self._seq = {name: 0 for name in self.cells}
        # global queue: submitted-but-unrouted SliceRequest bodies
        self.pending: list = []
        # in-flight cross-cell migrations, key -> {src, dst, stage}
        self.migrations: Dict[str, dict] = {}

    # -- digest / breaker pass ---------------------------------------------

    def contact_pass(self) -> None:
        """Touch every cell the breaker schedule allows; deliver digests
        on success, feed the breaker on failure. The *list itself* is
        the probe — a partitioned cell fails here and nowhere else."""
        for name in self.router.cells_to_contact():
            cell = self.cells.get(name)
            if cell is None:
                continue
            try:
                index = cell.fleet_index()
                self._seq[name] += 1
                digest = cell_digest(index, name, self._seq[name],
                                     self.now())
            except ApiError:
                self.router.record_failure(name)
                continue
            self.router.record_success(name)
            self.router.observe_digest(digest)
        self.router.export_metrics()

    # -- global queue -------------------------------------------------------

    def submit(self, cr: dict) -> None:
        """Enqueue a SliceRequest body on the global queue; the next
        route pass owns it."""
        self.pending.append(thaw_obj(cr))

    def route_pass(self) -> int:
        """Drain what the router can place right now; the rest stays
        queued (no cell, or every candidate Open). Returns how many
        requests were routed."""
        routed = 0
        keep = []
        for cr in self.pending:
            anns = annotations_of(cr)
            spec = cr.get("spec") or {}
            gen = request_generation(spec.get("accelerator"))
            chips = int(spec.get("chips") or 0)
            decision = self.router.route(
                chips, generation=gen,
                locality=anns.get(L.CELL_AFFINITY) or None)
            if decision is None:
                keep.append(cr)
                continue
            cell = self.cells[decision["cell"]]
            body = thaw_obj(cr)
            body.setdefault("metadata", {}).setdefault(
                "annotations", {})[L.CELL_PIN] = cell.name
            try:
                cell.client.create(body)
            except ApiError:
                # the chosen cell failed between digest and create:
                # feed the breaker, requeue, let the next pass rescore
                self.router.record_failure(cell.name)
                keep.append(cr)
                continue
            routed += 1
            if TIMELINE.enabled:
                key = (f"{namespace_of(cr) or 'default'}"
                       f"/{name_of(cr)}")
                TIMELINE.record(
                    "SliceRequest", key, "routed",
                    {"cell": cell.name, "score": decision["score"],
                     "why": decision["reason"]},
                    causes=(Cause(reason="federation-route",
                                  origin=f"cell/{cell.name}"),))
        self.pending = keep
        return routed

    # -- cross-cell migration ----------------------------------------------

    def migration_pass(self) -> None:
        """Advance every in-flight cross-cell migration one stage, and
        open new ones for slices bound in condemned cells. Each stage is
        one idempotent step; an ApiError (the source cell is, after all,
        partitioned) leaves the stage unchanged for the next pass."""
        condemned = set(self.router.condemned_cells())
        for cell_name in sorted(condemned):
            cell = self.cells.get(cell_name)
            if cell is None:
                continue
            try:
                placed = [
                    cr for cr in cell.client.list(
                        V1ALPHA1, KIND_SLICE_REQUEST,
                        ListOptions(namespace=cell.namespace))
                    if get_nested(cr, "status", "phase") == PHASE_PLACED]
            except ApiError:
                continue
            for cr in sorted(placed, key=request_key):
                key = request_key(cr)
                if key not in self.migrations:
                    self._open_migration(cell, thaw_obj(cr), cr)
        for key in sorted(self.migrations):
            self._advance(key)

    def recover_migrations(self) -> int:
        """Rebuild the in-flight migration table from the requests' own
        status after a router restart — the table itself is process
        memory; the CRs are the durable record. Source-side copies with
        ``toCell`` set restore at the intent stage; a destination twin
        (``from: cell/<src>``) overrides with the later stage its
        migration phase proves it reached. Returns the table size."""
        recovered: Dict[str, dict] = {}
        for cell_name in sorted(self.cells):
            cell = self.cells[cell_name]
            try:
                rows = cell.client.list(
                    V1ALPHA1, KIND_SLICE_REQUEST,
                    ListOptions(namespace=cell.namespace))
            except ApiError:
                continue  # partitioned; its half of the story waits
            for cr in sorted(rows, key=request_key):
                key = request_key(cr)
                mig = migration_of(cr)
                phase = mig.get("phase") or ""
                to_cell = mig.get("toCell")
                origin = str(mig.get("from") or "")
                if origin.startswith("cell/"):
                    # destination twin: the hop already happened
                    src = origin[len("cell/"):]
                    if phase == MIG_CHECKPOINTED:
                        stage = "hop"
                    elif phase in (MIG_REBOUND, MIG_RESUMED):
                        stage = "rebound"
                    else:
                        continue
                    recovered[key] = {"src": src, "dst": cell_name,
                                      "stage": stage}
                elif to_cell and phase in (MIG_MIGRATING,
                                           MIG_CHECKPOINTED):
                    recovered.setdefault(
                        key, {"src": cell_name, "dst": to_cell,
                              "stage": "intent"})
        self.migrations = recovered
        return len(recovered)

    def _open_migration(self, src: Cell, cr: dict, live) -> None:
        spec = cr.get("spec") or {}
        gen = request_generation(spec.get("accelerator"))
        decision = self.router.route(int(spec.get("chips") or 0),
                                     generation=gen)
        if decision is None or decision["cell"] == src.name:
            return
        key = request_key(cr)
        try:
            post_intent(src.client, cr, live, INTENT_MIGRATE,
                        deadline=self.now() + MIGRATE_DEADLINE_S,
                        now=self.now(),
                        extra={"toCell": decision["cell"]})
        except ApiError:
            return
        self.migrations[key] = {"src": src.name,
                                "dst": decision["cell"],
                                "stage": "intent"}
        log.info("cross-cell migration opened: %s %s -> %s", key,
                 src.name, decision["cell"])

    def _advance(self, key: str) -> None:
        mig = self.migrations[key]
        src, dst = self.cells[mig["src"]], self.cells[mig["dst"]]
        ns, _, name = key.partition("/")
        try:
            if mig["stage"] == "intent":
                live = src.client.get_or_none(
                    V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
                if live is None:
                    del self.migrations[key]
                    return
                state = migration_of(live)
                if state.get("phase") == MIG_MIGRATING:
                    return  # shim hasn't acked the checkpoint yet
                if state.get("phase") != MIG_CHECKPOINTED:
                    # the source aborted the attempt itself (intent
                    # deadline expired behind the partition): the
                    # workload keeps training where it is
                    del self.migrations[key]
                    OPERATOR_METRICS.federation_cross_cell_migrations \
                        .labels(outcome="aborted").inc()
                    return
                self._hop(key, ns, name, src, dst, thaw_obj(live),
                          state)
                mig["stage"] = "hop"
            elif mig["stage"] == "hop":
                twin = dst.client.get_or_none(
                    V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
                if twin is None:
                    del self.migrations[key]
                    return
                if get_nested(twin, "status",
                              "phase") == PHASE_UNSCHEDULABLE:
                    # the router's coarse pick didn't survive the
                    # cell's fine placement: abort the hop, retire the
                    # twin, leave the source alone — it never stopped
                    # training, and if its cell is still condemned the
                    # next pass opens a fresh attempt (rescored, so
                    # likely a different destination)
                    self._abort_hop(key, ns, name, src, dst)
                    return
                if get_nested(twin, "status",
                              "phase") != PHASE_PLACED:
                    return  # destination cell still placing
                self._rebound(key, ns, name, src, dst, thaw_obj(twin),
                              twin)
                mig["stage"] = "rebound"
            elif mig["stage"] == "rebound":
                twin = dst.client.get_or_none(
                    V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
                if twin is None:
                    del self.migrations[key]
                    return
                if migration_of(twin).get("phase") != MIG_RESUMED:
                    return  # shim hasn't restored on the new binding
                self._cleanup(key, ns, name, src)
        except ApiError:
            return  # the cell is unreachable; retry next pass

    def _abort_hop(self, key: str, ns: str, name: str, src: Cell,
                   dst: Cell) -> None:
        """The destination's fine placement refused the twin: retire it,
        abort the source's intent (its workload never stopped), and
        forget the attempt. A still-condemned source cell gets a fresh,
        rescored attempt on the next pass."""
        dst.client.delete(V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
        live = src.client.get_or_none(
            V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
        if live is not None:
            abort_migration(src.client, thaw_obj(live), live,
                            reason="destination-unschedulable",
                            outcome="cross-cell-aborted")
        del self.migrations[key]
        OPERATOR_METRICS.federation_cross_cell_migrations.labels(
            outcome="aborted").inc()
        log.warning("cross-cell migration of %s aborted: %s could not "
                    "place the twin", key, dst.name)

    def _hop(self, key: str, ns: str, name: str, src: Cell, dst: Cell,
             cr: dict, state: dict) -> None:
        """The hop itself: a pinned twin in the destination carrying the
        acked checkpoint step and the source-cell provenance."""
        body = {
            "apiVersion": V1ALPHA1,
            "kind": KIND_SLICE_REQUEST,
            "metadata": {
                "name": name, "namespace": ns,
                "annotations": {L.CELL_PIN: dst.name},
            },
            "spec": thaw_obj(cr.get("spec") or {}),
        }
        anns = annotations_of(cr)
        if anns.get(L.CELL_AFFINITY):
            body["metadata"]["annotations"][L.CELL_AFFINITY] = \
                anns[L.CELL_AFFINITY]
        # idempotent: a router restarted mid-hop re-enters this stage
        # with the twin already created — don't 409 forever
        if dst.client.get_or_none(
                V1ALPHA1, KIND_SLICE_REQUEST, name, ns) is None:
            dst.client.create(body)
        twin_live = dst.client.get_or_none(
            V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
        twin = thaw_obj(twin_live)
        set_nested(twin, {
            "phase": MIG_CHECKPOINTED,
            "intent": INTENT_MIGRATE,
            "from": f"cell/{src.name}",
            "ackedStep": state.get("ackedStep"),
        }, "status", "migration")
        from ..api.conditions import update_status_with_retry

        update_status_with_retry(dst.client, twin, live=twin_live)
        if TIMELINE.enabled:
            TIMELINE.record(
                "SliceRequest", key, "migration:CrossCellHop",
                {"fromCell": src.name, "toCell": dst.name,
                 "ackedStep": state.get("ackedStep")},
                causes=(Cause(reason="cross-cell-migrate",
                              origin=f"cell/{src.name}"),))

    def _rebound(self, key: str, ns: str, name: str, src: Cell,
                 dst: Cell, twin: dict, twin_live) -> None:
        """Destination placed the twin: flip it to Rebound so the shim
        (moved here with its checkpoint store) restores, and carry the
        shim across cells."""
        state = migration_of(twin)
        state["phase"] = MIG_REBOUND
        set_nested(twin, state, "status", "migration")
        from ..api.conditions import update_status_with_retry

        update_status_with_retry(dst.client, twin, live=twin_live)
        old = src.shims.pop(key, None)
        if old is not None and self.shim_factory is not None:
            dst.shims[key] = self.shim_factory(
                dst, name, ns, getattr(old, "store", None))

    def _cleanup(self, key: str, ns: str, name: str, src: Cell) -> None:
        """The workload resumed in the destination: retire the source
        copy. Its lease release rides the source cell's own reconcile of
        the deletion — the standard drain path."""
        try:
            src.client.delete(V1ALPHA1, KIND_SLICE_REQUEST, name, ns)
        except ApiError:
            return  # source still partitioned; retry next pass
        del self.migrations[key]
        OPERATOR_METRICS.federation_cross_cell_migrations.labels(
            outcome="migrated").inc()
        if TIMELINE.enabled:
            TIMELINE.record(
                "SliceRequest", key, "migration:CrossCellDone",
                {"fromCell": src.name},
                causes=(Cause(reason="cross-cell-migrate",
                              origin=f"cell/{src.name}"),))
        log.info("cross-cell migration done: %s left %s", key, src.name)

"""Federation router reconciler — the global queue's decision loop.

The port's copy of ``tpu_operator/controllers/federation_controller.py``.
As in the reference, ``gpu-operator`` does not register it
(``cli/operator.py``'s ``wire_manager`` registers four reconcilers; ROADMAP
§C, C10): a deployment that federates adds it to its Manager.

Runs the :class:`~tpu_operator_torch.federation.router.GlobalRouter` as a
controller over the global SliceRequest queue: an UNPINNED request is a
queue entry the router owes a decision; routing it means stamping
``gpu.graft.dev/cell`` — after which the chosen cell's own placement
reconciler (the cell rider in placement_controller.py) does the fine
placement and this controller never touches the request again. A
request pinned to a cell whose breaker later opens is deliberately left
alone: partition is not death, and a placed slice keeps training behind
the partition. Only the condemnation path (runtime/multicell.py) ever
moves it.

Rides the HEALTH lane: a routing decision is global-queue admission, and
it must preempt the bulk/placement churn of whatever single cell this
process also happens to reconcile — a starved router turns a healthy
fleet into N isolated cells.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from ..api import labels as L
from ..api.slicerequest import (
    KIND_SLICE_REQUEST,
    V1ALPHA1,
    SliceRequestSpec,
)
from ..federation.router import GlobalRouter, request_generation
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime import (
    LANE_HEALTH,
    Controller,
    Manager,
    Reconciler,
    Request,
    Result,
    generation_changed,
)
from ..runtime.objects import annotations_of, name_of, thaw_obj
from ..runtime.timeline import TIMELINE
from ..runtime.workqueue import Cause

log = logging.getLogger("tpu_operator_torch.federation")

# an unroutable request (every cell Open or over-committed) retries on
# this cadence — fresh digests or a closed breaker unblock it
ROUTE_RETRY_S = 30.0


class FederationReconciler(Reconciler):
    name = "federation-router"
    primary_kind = "SliceRequest"

    def __init__(self, client, router: GlobalRouter,
                 namespace: Optional[str] = None,
                 submit: Optional[Callable[[str, dict], None]] = None,
                 perf=time.perf_counter):
        self.client = client
        self.router = router
        self.namespace = namespace
        # multi-cell harness hook: deliver the routed request to the
        # chosen cell's apiserver (runtime/multicell.py). None means the
        # pin annotation alone is the delivery (shared-apiserver mode).
        self.submit = submit
        self._perf = perf

    # -- wiring ------------------------------------------------------------

    def setup_controller(self, controller: Controller, manager: Manager):
        controller.watch(V1ALPHA1, KIND_SLICE_REQUEST,
                         predicate=generation_changed,
                         lane=LANE_HEALTH)

    # -- snapshot plane (runtime/manager.py find_federation) ---------------

    def router_snapshot(self) -> dict:
        """The router's breaker ledgers + held digests for the durable
        snapshot's ``federation`` section (schema v4)."""
        return self.router.snapshot()

    def adopt_router_state(self, state: Optional[dict]) -> bool:
        """Warm-restore the router from a snapshot section, so a crash
        mid-partition keeps its Open/backoff decisions."""
        return self.router.adopt(state)

    def federation_report(self) -> dict:
        """The live cells explainer (CLI ``gpuop-cfg cells --url``,
        must-gather ``federation/cells.json``)."""
        from ..federation.router import cells_report

        return cells_report(self.client, self.namespace or "default",
                            router=self.router)

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, request: Request) -> Result:
        live = self.client.get_or_none(
            V1ALPHA1, KIND_SLICE_REQUEST, request.name,
            request.namespace or None)
        if live is None:
            return Result()
        anns = annotations_of(live)
        if anns.get(L.CELL_PIN):
            # already routed; the cell owns it from here
            return Result()
        cr = thaw_obj(live)
        spec = SliceRequestSpec.from_obj(cr)
        generation = request_generation(spec.accelerator)
        started = self._perf()
        decision = self.router.route(
            spec.chips_needed(), generation=generation,
            locality=anns.get(L.CELL_AFFINITY) or None)
        OPERATOR_METRICS.federation_route_latency.observe(
            self._perf() - started)
        key = f"{request.namespace or 'default'}/{request.name}"
        if decision is None:
            # no routable cell right now (all Open, or none with
            # headroom): stay on the global queue and retry
            if TIMELINE.enabled:
                TIMELINE.record(
                    "SliceRequest", key, "route-deferred",
                    {"controller": self.name},
                    causes=(Cause(reason="no-routable-cell"),))
            return Result(requeue_after=ROUTE_RETRY_S)
        cell = decision["cell"]
        self.client.patch(
            V1ALPHA1, KIND_SLICE_REQUEST, name_of(live),
            {"metadata": {"annotations": {L.CELL_PIN: cell}}},
            namespace=request.namespace or None)
        if TIMELINE.enabled:
            TIMELINE.record(
                "SliceRequest", key, "routed",
                {"controller": self.name, "cell": cell,
                 "score": decision["score"],
                 "why": decision["reason"]},
                causes=(Cause(reason="federation-route",
                              origin=f"cell/{cell}"),))
        if self.submit is not None:
            self.submit(cell, cr)
        log.info("request %s routed to %s (%s, score=%s)", key, cell,
                 decision["reason"], decision["score"])
        return Result()

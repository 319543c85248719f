"""Partition-tolerant multi-cluster federation (the port's copy of
``tpu_operator/federation/``).

A fleet is N operator *cells* (one apiserver + operator each). Each
cell distills its FleetIndex into a cheap, schema-stamped fleet digest
(federation/digest.py) published on a jittered cadence; a global router
(federation/router.py) places SliceRequests onto cells by digest score
plus data-locality preference and lets the cell's own placement engine
do the fine placement. Every cell sits behind a Healthy → Suspect →
Open circuit breaker, so a partitioned or browned-out cell is routed
around — its stale digest age-discounted rather than trusted, its
bound requests left alone (partition ≠ dead) until a configurable
condemnation horizon, past which they are migrated cross-cell by
replaying the elastic handshake (runtime/multicell.py).
"""

from .digest import (
    CELL_DIGEST_SCHEMA_VERSION,
    cell_digest,
    cell_digest_json,
    parse_cell_digest,
    publish_wait,
)
from .router import (
    CELL_HEALTHY,
    CELL_OPEN,
    CELL_SUSPECT,
    GlobalRouter,
    cells_report,
    request_generation,
)

__all__ = [
    "CELL_DIGEST_SCHEMA_VERSION",
    "cell_digest",
    "cell_digest_json",
    "parse_cell_digest",
    "publish_wait",
    "CELL_HEALTHY",
    "CELL_SUSPECT",
    "CELL_OPEN",
    "GlobalRouter",
    "cells_report",
    "request_generation",
]

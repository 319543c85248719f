"""Cell fleet digests — the federation plane's currency.

The port's copy of ``tpu_operator/federation/digest.py``, over the
port's ``FleetIndex.digest_stats()``: ``headroom`` is keyed by the
port's generations (``a100-sxm``, ``h100-sxm``, ``gb200``).

Each cell distills its :class:`~tpu_operator_torch.topology.index.FleetIndex`
into one small schema-stamped dict (``FleetIndex.digest_stats`` does
the locked pass) and publishes it on a jittered cadence, exactly the
discipline the node health digests established (metrics/health_engine):

- schema-stamped (``v``): a router never guesses at an old producer's
  field meanings — unknown versions parse to None and the cell scores
  as digest-less (age-discounted to the floor), never wrongly.
- sequence-stamped (``seq``): watch echoes and out-of-order delivery
  dedupe by seq, so a router's view is a pure function of the digest
  SET it has seen, not the arrival order — the property the seeded
  permutation test pins.
- age-stamped (``at``): the router discounts by age instead of
  trusting a partitioned cell's last words forever.
"""

from __future__ import annotations

import json
import random
from typing import Optional

CELL_DIGEST_SCHEMA_VERSION = 1

# publish cadence defaults: same shape as the node health engine's
# (interval * (1 ± jitter)), seeded per cell so a fleet of cells never
# publishes in lockstep yet each cell's cadence is reproducible
PUBLISH_INTERVAL_S = 15.0
PUBLISH_JITTER = 0.2


def cell_digest(index, cell: str, seq: int, now: float) -> dict:
    """One publish: the index distilled + the federation envelope."""
    stats = index.digest_stats()
    return {
        "v": CELL_DIGEST_SCHEMA_VERSION,
        "cell": str(cell),
        "seq": int(seq),
        "at": float(now),
        "hosts": stats["hosts"],
        "chips_free": stats["chips_free"],
        "chips_placed": stats["chips_placed"],
        "utilization": stats["utilization"],
        "headroom": dict(stats["headroom"]),
        "fragmentation": stats["fragmentation"],
        "condemned": stats["condemned"],
    }


def cell_digest_json(digest: dict) -> str:
    """Compact, key-sorted wire form (annotation/report payload)."""
    return json.dumps(digest, sort_keys=True, separators=(",", ":"))


def parse_cell_digest(raw) -> Optional[dict]:
    """Parse a published digest; None on absent, malformed, or a schema
    version this consumer doesn't speak — the caller treats all three
    as 'no digest', never as a half-understood one."""
    if raw is None:
        return None
    if isinstance(raw, dict):
        d = raw
    else:
        try:
            d = json.loads(raw)
        except (TypeError, ValueError):
            return None
    if not isinstance(d, dict) or d.get("v") != CELL_DIGEST_SCHEMA_VERSION:
        return None
    if not d.get("cell") or not isinstance(d.get("seq"), int):
        return None
    return d


def publish_wait(cell: str, interval: float = PUBLISH_INTERVAL_S,
                 jitter: float = PUBLISH_JITTER) -> float:
    """Jittered wait before this cell's next publish — seeded per cell
    (reproducible) and spread ±jitter so N cells desynchronize."""
    rng = random.Random(f"cell-digest:{cell}")
    return max(0.0, interval * (1.0 + jitter * (2.0 * rng.random() - 1.0)))

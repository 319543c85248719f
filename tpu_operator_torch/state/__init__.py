"""Node-pool partitioning (``tpu_operator/state/nodepool.py``'s counterpart)."""

from .nodepool import (  # noqa: F401
    NodePool,
    get_node_pools,
    slices_of,
    topology_of,
)

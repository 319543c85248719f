"""The operand states (``operands``), their apply/readiness skeleton
(``skel``), dependency DAG (``scheduler``) and node pools (``nodepool``)."""

from .nodepool import (  # noqa: F401
    NodePool,
    get_node_pools,
    slices_of,
    topology_of,
)

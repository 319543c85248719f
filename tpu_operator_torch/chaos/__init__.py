"""Chaos plane: deterministic fault injection + cluster invariant
checking for the control plane (the port's copy of
``tpu_operator/chaos/``).

Three pieces:

- ``faults``: a seeded :class:`FaultPlan` (RNG -> reproducible fault
  schedule) and a :class:`ChaosClient` wrapper that injects apiserver
  faults (409 storms, 429 Retry-After, transient 5xx, latency, dropped
  watch streams) into any :class:`~tpu_operator_torch.runtime.client.Client`.
- ``invariants``: an :class:`InvariantChecker` asserted continuously
  while the controllers run under fire.
- ``runner``: named scenarios against the mock cluster, emitting a
  deterministic JSON verdict (the ``gpuop-chaos`` CLI front-end).
"""

from .faults import ChaosClient, Fault, FaultPlan, VirtualClock  # noqa: F401
from .invariants import InvariantChecker, Violation  # noqa: F401
from .runner import SCENARIOS, run_scenario  # noqa: F401

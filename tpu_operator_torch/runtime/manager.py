"""The reconcile contract: ``Request`` in, ``Result`` out.

The port's own copy of the types of ``tpu_operator/runtime/manager.py``
(:111-130). The manager, its workqueue and its informer cache are not
ported yet: the port's reconcilers are driven directly, one
``reconcile(Request(...))`` call a pass, as the reference's tests and
benchmarks drive its own.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Request:
    name: str
    namespace: str = ""

    def __str__(self):
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0


class Reconciler:
    """Implement ``reconcile(request) -> Result``."""

    name = "reconciler"

    def reconcile(self, request: Request) -> Result:  # pragma: no cover
        raise NotImplementedError

"""Admission-style validation for GPUDriver CRs.

The port's counterpart of ``tpu_operator/controllers/validation.py``, the
NodeSelectorValidator analog (internal/validator/validator.go:31-110):
two GPUDriver CRs must never select the same node — a node can only run
one driver flavor.
"""

from __future__ import annotations

from typing import List

from ..api.gpudriver import KIND_GPU_DRIVER, V1ALPHA1, GPUDriverSpec
from ..runtime.client import Client
from ..runtime.objects import labels_of, match_labels, name_of


class ValidationError(Exception):
    pass


def validate_node_selectors(client: Client, cr: dict) -> None:
    """Raise when ``cr`` selects a node that another GPUDriver already
    selects. An empty nodeSelector selects ALL GPU nodes, so at most one CR
    may omit it."""
    from ..runtime.tracing import TRACER

    # the span context records the ValidationError (and re-raises it):
    # a rejected CR shows up in the reconcile trace as this span
    with TRACER.span("validate:node-selectors", target=name_of(cr)):
        spec = GPUDriverSpec.from_obj(cr)
        others: List[dict] = [
            c for c in client.list(V1ALPHA1, KIND_GPU_DRIVER)
            if name_of(c) != name_of(cr)
        ]
        nodes = client.list("v1", "Node")
        for other in others:
            other_spec = GPUDriverSpec.from_obj(other)
            for node in nodes:
                nl = labels_of(node)
                mine = match_labels(nl, spec.node_selector or {})
                theirs = match_labels(nl, other_spec.node_selector or {})
                if mine and theirs:
                    raise ValidationError(
                        f"GPUDriver {name_of(cr)!r} and {name_of(other)!r} "
                        f"both select node {name_of(node)!r}; nodeSelectors "
                        f"must be disjoint")

"""Accessors of Kubernetes objects as plain dicts.

The port's own copy of the parts of ``tpu_operator/runtime/objects.py``
that the node agents and the topology manager read.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional


def get_nested(obj: Mapping, *path: str, default: Any = None) -> Any:
    """Walk ``path`` through nested mappings, ``default`` on a miss."""
    cur: Any = obj
    for key in path:
        if not isinstance(cur, Mapping) or key not in cur:
            return default
        cur = cur[key]
    return cur


def name_of(obj: Mapping) -> str:
    return (obj.get("metadata") or {}).get("name", "")


def labels_of(obj: Mapping) -> dict:
    return (obj.get("metadata") or {}).get("labels") or {}


def label_delta(have: Mapping, want: Mapping) -> dict:
    """The patch-worthy subset of ``want`` against ``have``: keys whose
    value changed, plus removals (value None) only for keys present — a
    removal patch for an absent key would be a no-op write that still
    bumps the object's resourceVersion."""
    return {k: v for k, v in want.items()
            if have.get(k) != v and not (v is None and k not in have)}


def match_labels(labels: Mapping[str, str],
                 selector: Optional[Mapping]) -> bool:
    """Evaluate a LabelSelector ({matchLabels, matchExpressions}) or a
    plain matchLabels-style dict against ``labels``."""
    if not selector:
        return True
    if "matchLabels" in selector or "matchExpressions" in selector:
        wanted = selector.get("matchLabels") or {}
        exprs = selector.get("matchExpressions") or []
    else:
        wanted = selector
        exprs = []
    for k, v in wanted.items():
        if labels.get(k) != v:
            return False
    for expr in exprs:
        key, op = expr.get("key"), expr.get("operator")
        values = expr.get("values") or []
        present = key in labels
        if op == "In":
            if not present or labels[key] not in values:
                return False
        elif op == "NotIn":
            if present and labels[key] in values:
                return False
        elif op == "Exists":
            if not present:
                return False
        elif op == "DoesNotExist":
            if present:
                return False
        else:
            raise ValueError(f"unknown matchExpressions operator: {op!r}")
    return True

"""Accessors of Kubernetes objects as plain dicts.

The port's own copy of the parts of ``tpu_operator/runtime/objects.py``
that the node agents read.
"""

from __future__ import annotations

from typing import Mapping


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

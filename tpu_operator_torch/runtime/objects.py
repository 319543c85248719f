"""Kubernetes objects as plain nested dicts.

The port's own copy of ``tpu_operator/runtime/objects.py``: nested access,
metadata accessors, label-selector matching, owner references, and the
frozen views the clients hand out (a read is a shared, recursively
immutable snapshot; a caller that edits one ``thaw_obj()``s it first).
"""

from __future__ import annotations

import copy
from collections.abc import Mapping as _ABCMapping
from typing import Any, Iterable, Mapping, Optional


def deepcopy_obj(obj: dict) -> dict:
    return copy.deepcopy(obj)


class FrozenObjectError(TypeError):
    """In-place mutation of a cached read. The object is a shared
    zero-copy snapshot; ``thaw_obj()`` it (or deepcopy) before editing."""


def _frozen(*_a, **_k):
    raise FrozenObjectError(
        "object is a shared frozen snapshot from the client cache; "
        "thaw_obj() it before mutating")


class FrozenDict(dict):
    """A dict whose mutators raise. Equality/iteration/json/yaml behave
    exactly like dict (same storage); only writes are refused."""

    __slots__ = ()
    __setitem__ = __delitem__ = _frozen
    setdefault = pop = popitem = clear = update = __ior__ = _frozen

    def __deepcopy__(self, memo):
        return {k: copy.deepcopy(v, memo) for k, v in self.items()}

    def __copy__(self):
        return dict(self)

    def __reduce__(self):  # pickle round-trips to a plain dict
        return (dict, (dict(self),))


class FrozenList(list):
    __slots__ = ()
    __setitem__ = __delitem__ = __iadd__ = __imul__ = _frozen
    append = extend = insert = pop = remove = clear = sort = reverse = _frozen

    def __deepcopy__(self, memo):
        return [copy.deepcopy(v, memo) for v in self]

    def __copy__(self):
        return list(self)

    def __reduce__(self):
        return (list, (list(self),))


def freeze_obj(obj: Any) -> Any:
    """Recursively convert dicts/lists to frozen views (shared leaves)."""
    t = type(obj)
    if t is FrozenDict or t is FrozenList:
        return obj
    if t is dict:
        return FrozenDict((k, freeze_obj(v)) for k, v in obj.items())
    if t is list:
        return FrozenList(freeze_obj(v) for v in obj)
    if t is tuple:
        return FrozenList(freeze_obj(v) for v in obj)
    if isinstance(obj, dict):
        return FrozenDict((k, freeze_obj(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return FrozenList(freeze_obj(v) for v in obj)
    return obj


def thaw_obj(obj: Any) -> Any:
    """Deep mutable copy of a (possibly frozen) object tree."""
    return copy.deepcopy(obj)


def get_nested(obj: Mapping, *path: str, default: Any = None) -> Any:
    """Walk ``path`` through nested mappings, returning ``default`` on miss.

    Hot path for the whole framework (tens of millions of calls in the
    scale tier): plain dicts — and the clients' FrozenDict views — take
    a ``type() is`` fast path; anything else falls back to the abc
    Mapping check (NOT ``typing.Mapping``, whose ``__instancecheck__``
    costs ~2µs/call and dominated the 500-node install profile)."""
    cur: Any = obj
    for key in path:
        t = type(cur)
        if t is dict or t is FrozenDict:
            if key not in cur:
                return default
        elif not isinstance(cur, _ABCMapping) or key not in cur:
            return default
        cur = cur[key]
    return cur


def set_nested(obj: dict, value: Any, *path: str) -> None:
    """Set a nested value, creating intermediate dicts."""
    cur = obj
    for key in path[:-1]:
        nxt = cur.get(key)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[key] = nxt
        cur = nxt
    cur[path[-1]] = value


# Kinds that are cluster-scoped (no namespace) in the fake client.
CLUSTER_SCOPED_KINDS = {
    "Node",
    "Namespace",
    "ClusterRole",
    "ClusterRoleBinding",
    "CustomResourceDefinition",
    "RuntimeClass",
    "PriorityClass",
    "GPUClusterPolicy",
    "GPUDriver",
}


def is_namespaced(kind: str) -> bool:
    return kind not in CLUSTER_SCOPED_KINDS


def name_of(obj: Mapping) -> str:
    return get_nested(obj, "metadata", "name", default="")


def namespace_of(obj: Mapping) -> str:
    return get_nested(obj, "metadata", "namespace", default="")


def labels_of(obj: Mapping) -> dict:
    return get_nested(obj, "metadata", "labels", default={}) or {}


def annotations_of(obj: Mapping) -> dict:
    return get_nested(obj, "metadata", "annotations", default={}) or {}


def label_delta(have: Mapping, want: Mapping) -> dict:
    """The patch-worthy subset of ``want`` against ``have``: keys whose
    value changed, plus removals (value None) only for keys actually
    present — a removal patch for an absent key would be a no-op write
    that still churns resourceVersions."""
    return {k: v for k, v in want.items()
            if have.get(k) != v and not (v is None and k not in have)}


def set_label(obj: dict, key: str, value: str) -> None:
    set_nested(obj, value, "metadata", "labels", key)


def set_annotation(obj: dict, key: str, value: str) -> None:
    set_nested(obj, value, "metadata", "annotations", key)


def obj_key(obj: Mapping) -> tuple:
    """(apiVersion, kind, namespace, name) — unique identity in a cluster."""
    return (
        obj.get("apiVersion", ""),
        obj.get("kind", ""),
        namespace_of(obj),
        name_of(obj),
    )


def set_owner_reference(obj: dict, owner: Mapping, controller: bool = True) -> None:
    """Stamp ``obj`` with a controller owner reference to ``owner``.

    Plays the role of controllerutil.SetControllerReference in the reference
    (controllers/object_controls.go:4242).
    """
    ref = {
        "apiVersion": owner.get("apiVersion", ""),
        "kind": owner.get("kind", ""),
        "name": name_of(owner),
        "uid": get_nested(owner, "metadata", "uid", default=""),
        "controller": controller,
        "blockOwnerDeletion": True,
    }
    refs = [
        r
        for r in get_nested(obj, "metadata", "ownerReferences", default=[]) or []
        if not (r.get("controller") and controller)
    ]
    refs.append(ref)
    set_nested(obj, refs, "metadata", "ownerReferences")


def match_labels(labels: Mapping[str, str], selector: Optional[Mapping]) -> bool:
    """Evaluate a LabelSelector ({matchLabels, matchExpressions}) or a plain
    matchLabels-style dict against ``labels``."""
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


def match_node_selector_terms(labels: Mapping[str, str], terms: Iterable[Mapping]) -> bool:
    """nodeAffinity requiredDuringScheduling terms: OR of ANDed expressions."""
    terms = list(terms)
    if not terms:
        return True
    for term in terms:
        exprs = term.get("matchExpressions") or []
        if match_labels(labels, {"matchExpressions": exprs}):
            return True
    return False


def pod_ready(pod: Mapping) -> bool:
    """kubectl's Ready-condition test (shared by the upgrade controller's
    validation gate and status.slices grouped readiness)."""
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in get_nested(pod, "status", "conditions",
                                   default=[]) or [])

"""Kubernetes Event recording (the port's own copy of
``tpu_operator/runtime/events.py``; the controller-runtime EventRecorder
slot).

`kubectl describe node/cr` visibility for operator decisions: Events are
the one surface cluster users actually look at when a node misbehaves.
Best-effort by design — an apiserver hiccup while recording must never
fail the reconcile that triggered it."""

from __future__ import annotations

import datetime
import logging

from .client import Client, ConflictError
from .objects import name_of, namespace_of, thaw_obj

log = logging.getLogger("tpu_operator_torch.events")

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


class EventRecorder:
    """Create-or-count Event objects like client-go's correlator: a
    repeat of the same (object, reason, message) bumps ``count`` and
    ``lastTimestamp`` instead of flooding new objects."""

    def __init__(self, client: Client, component: str = "gpu-operator",
                 namespace: str = "gpu-operator"):
        self.client = client
        self.component = component
        self.namespace = namespace

    def _event_name(self, involved: dict, reason: str, message: str) -> str:
        import hashlib

        key = (f"{involved.get('kind')}/{involved.get('name')}"
               f"/{reason}/{message}")
        digest = hashlib.sha256(key.encode()).hexdigest()[:12]
        # Node names can approach the 253-char object-name limit; an
        # overlong Event name fails creation and the event is silently
        # dropped. 240 leaves room for "." + 12-hex digest.
        prefix = (involved.get("name") or "obj")[:240]
        return f"{prefix}.{digest}"

    def event(self, obj: dict, type_: str, reason: str,
              message: str) -> None:
        """Record one event against ``obj`` (best-effort)."""
        try:
            involved = {
                "kind": obj.get("kind", ""),
                "name": name_of(obj),
                "namespace": namespace_of(obj),
                "apiVersion": obj.get("apiVersion", ""),
                "uid": (obj.get("metadata") or {}).get("uid", ""),
            }
            # Events live in a namespace: the involved object's, else the
            # operator's (cluster-scoped objects like Nodes)
            ns = involved["namespace"] or self.namespace
            name = self._event_name(involved, reason, message)
            existing = self.client.get_or_none("v1", "Event", name, ns)
            now = _now()
            if existing is not None:
                existing = thaw_obj(existing)  # cached reads are frozen
                existing["count"] = int(existing.get("count", 1)) + 1
                existing["lastTimestamp"] = now
                try:
                    self.client.update(existing)
                except ConflictError:
                    # concurrent workers race this read-modify-update;
                    # retry once on a fresh read so the other worker's
                    # count bump is not lost (beyond one retry, the
                    # best-effort discipline applies)
                    existing = self.client.get_or_none("v1", "Event",
                                                       name, ns)
                    if existing is None:
                        raise
                    existing = thaw_obj(existing)
                    existing["count"] = int(existing.get("count", 1)) + 1
                    existing["lastTimestamp"] = _now()
                    self.client.update(existing)
                return
            self.client.create({
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {"name": name, "namespace": ns},
                "involvedObject": involved,
                "reason": reason,
                "message": message,
                "type": type_,
                "count": 1,
                "firstTimestamp": now,
                "lastTimestamp": now,
                "source": {"component": self.component},
            })
        except Exception as e:  # never fail the reconcile for an event
            from .tracing import TRACER

            # a dropped event is invisible in logs at default level; at
            # least the reconcile's trace says it happened
            TRACER.tag("event_dropped", f"{reason}: {e}")
            log.debug("event %s/%s not recorded: %s", reason,
                      name_of(obj), e)

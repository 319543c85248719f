"""Client abstraction over the Kubernetes API.

The port's own copy of ``tpu_operator/runtime/client.py``: one error
hierarchy for every client of the port. Two implementations exist:

- ``tpu_operator_torch.runtime.fake.FakeClient`` — an in-memory apiserver
  with resourceVersions, label selectors, watches and a kubelet/DaemonSet
  simulator: the substrate the reconcile path is driven on.
- ``tpu_operator_torch.runtime.kubeclient.HTTPClient`` — a real apiserver
  client over ``urllib`` (kubeconfig or in-cluster service account);
  ``InClusterClient`` is the pod's own apiserver, with the verbs the node
  agents use.

Objects are plain dicts shaped like Kubernetes JSON. All methods raise
``ApiError`` subclasses on failure, mirroring apierrors.IsNotFound-style
handling in the reference controllers.
"""

from __future__ import annotations

import abc
import threading
from collections.abc import Mapping  # abc check: typing.Mapping's
# __instancecheck__ is ~2µs/call and merge_patch recurses per key
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional


class ApiError(Exception):
    """Base error for API operations; carries an HTTP-ish status code."""

    code = 500

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        if code is not None:
            self.code = code


class NotFoundError(ApiError):
    code = 404


class AlreadyExistsError(ApiError):
    code = 409


class ConflictError(ApiError):
    """resourceVersion conflict on update."""

    code = 409


class InvalidError(ApiError):
    code = 422


class EvictionBlockedError(ApiError):
    """Eviction denied by a PodDisruptionBudget (HTTP 429 from the
    pods/eviction subresource)."""

    code = 429


class TooManyRequestsError(ApiError):
    """HTTP 429 with a Retry-After hint — apiserver overload /
    priority-and-fairness rejection; callers treat it like any
    retryable ApiError."""

    code = 429

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = retry_after


class ServerUnavailableError(ApiError):
    """Transient 5xx — the apiserver (or a webhook in front of it) is
    briefly unable to serve the request."""

    code = 503


class WatchGoneError(ApiError):
    """HTTP 410 Gone: the requested watch start resourceVersion has
    fallen out of the server's watch window and cannot be resumed from.
    Callers fall back to a full list/replay — the informer's classic
    relist — so a too-old resume point costs a cold sync, never a gap."""

    code = 410


@dataclass(frozen=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    obj: dict


def env_spec_hash_enabled(env=None) -> bool:
    """Spec-hash write avoidance defaults ON; OPERATOR_SPEC_HASH=0 (or
    false/no/off) disables it — same spelling as the tracing kill switch."""
    import os

    val = (env or os.environ).get("OPERATOR_SPEC_HASH", "1")
    return str(val).strip().lower() not in ("0", "false", "no", "off")


class SpecHashGate:
    """Process-wide switch for spec-hash write avoidance (state/skel.py
    skip-on-match + api/conditions.py status-write skip). Disabled, the
    control plane issues exactly the pre-optimization writes — the
    debugging escape hatch when a suspected skip masks drift."""

    def __init__(self):
        self.enabled = env_spec_hash_enabled()


SPEC_HASH_GATE = SpecHashGate()


@dataclass
class ListOptions:
    namespace: Optional[str] = None
    label_selector: Optional[Mapping] = None  # LabelSelector or matchLabels dict
    field_selector: Optional[Mapping[str, str]] = None  # only metadata.name/.namespace
    # apiserver-style pagination: at most ``limit`` objects per call;
    # ``continue_`` resumes after the previous page (the token from that
    # page's ``PagedList.continue_``). Clients that don't support chunking
    # (``supports_chunked_list`` False) may ignore both and return the
    # full set — callers must tolerate an over-full page.
    limit: Optional[int] = None
    continue_: Optional[str] = None


class PagedList(list):
    """One page of a chunked list. ``continue_`` is the opaque token for
    the next page (None/"" on the final page) — the analog of
    ``metadata.continue`` on a real apiserver list response."""

    continue_: Optional[str] = None


class Client(abc.ABC):
    """Minimal typed-by-convention CRUD + watch client."""

    #: True when ``list`` honors ``ListOptions.limit``/``continue_`` and
    #: returns :class:`PagedList` pages — lets the informer relist a 10k
    #: node fleet in chunks instead of materializing it all at once.
    supports_chunked_list = False

    #: True when ``watch`` accepts ``since_rv`` and can replay only the
    #: events after that resourceVersion (the apiserver watch-cache
    #: resume). A snapshot-seeded informer uses this to heal O(delta)
    #: on the wire instead of re-receiving the whole fleet; servers that
    #: cannot serve the resume point raise :class:`WatchGoneError` and
    #: the caller falls back to the full replay + prune path.
    supports_watch_resume = False

    @abc.abstractmethod
    def get(self, api_version: str, kind: str, name: str,
            namespace: Optional[str] = None,
            metadata_only: bool = False) -> dict:
        """Fetch one object. ``metadata_only`` is an optimization hint
        (PartialObjectMetadata negotiation): implementations MAY return
        the full object; callers must only rely on ``metadata``."""
        ...

    @abc.abstractmethod
    def list(self, api_version: str, kind: str, opts: Optional[ListOptions] = None) -> list:
        ...

    @abc.abstractmethod
    def create(self, obj: dict) -> dict:
        ...

    @abc.abstractmethod
    def update(self, obj: dict) -> dict:
        """Full replace; enforces resourceVersion if present on ``obj``."""
        ...

    @abc.abstractmethod
    def update_status(self, obj: dict) -> dict:
        """Status-subresource write (spec changes are ignored)."""
        ...

    @abc.abstractmethod
    def patch(self, api_version: str, kind: str, name: str,
              patch: dict, namespace: Optional[str] = None) -> dict:
        """Strategic-merge-ish patch: dicts merge recursively, None deletes,
        lists replace."""
        ...

    @abc.abstractmethod
    def delete(self, api_version: str, kind: str, name: str, namespace: Optional[str] = None) -> None:
        ...

    @abc.abstractmethod
    def watch(self, api_version: str, kind: str,
              handler: Callable[[WatchEvent], None]) -> Callable[[], None]:
        """Register ``handler`` for events on a kind; returns an unsubscribe
        callable. Handlers receive ADDED events for pre-existing objects."""
        ...

    # -- convenience -------------------------------------------------------

    def get_or_none(self, api_version: str, kind: str, name: str,
                    namespace: Optional[str] = None) -> Optional[dict]:
        try:
            return self.get(api_version, kind, name, namespace)
        except NotFoundError:
            return None

    def evict(self, name: str, namespace: Optional[str] = None) -> None:
        """Evict a pod through the Eviction API semantics: the eviction is
        DENIED (EvictionBlockedError, 429) while a PodDisruptionBudget
        selecting the pod has no disruptions left. The base implementation
        enforces PDBs client-side (what the apiserver's eviction
        subresource does server-side); HTTPClient overrides with a real
        POST to pods/eviction."""
        pod = self.get("v1", "Pod", name, namespace)
        blocker = _blocking_pdb(self, pod)
        if blocker is not None:
            raise EvictionBlockedError(
                f"cannot evict pod {namespace or ''}/{name}: disruption "
                f"budget {blocker} needs more healthy pods")
        self.delete("v1", "Pod", name, namespace)

    def apply(self, obj: dict) -> dict:
        """Create-or-replace (last-write-wins), used by bootstrap paths. The
        state engine uses its own hash-gated create-or-update instead
        (state/skel.py), mirroring state_skel.go:223-285."""
        from .objects import name_of, namespace_of

        existing = self.get_or_none(
            obj.get("apiVersion", ""), obj.get("kind", ""), name_of(obj),
            namespace_of(obj) or None)
        if existing is None:
            return self.create(obj)
        merged = dict(obj)
        meta = dict(merged.get("metadata") or {})
        meta["resourceVersion"] = existing["metadata"].get("resourceVersion")
        meta.setdefault("uid", existing["metadata"].get("uid"))
        merged["metadata"] = meta
        return self.update(merged)


def _resolve_budget_count(value, total: int) -> int:
    """minAvailable/maxUnavailable may be an absolute int or "N%" of the
    matching pod count; percentages round UP for both fields, matching the
    disruption controller's scale-with-round-up behavior."""
    if isinstance(value, str) and value.endswith("%"):
        pct = int(value[:-1])
        return (total * pct + 99) // 100
    return int(value)


def _blocking_pdb(client: "Client", pod: dict) -> Optional[str]:
    """Name of a PodDisruptionBudget that currently blocks evicting
    ``pod``, or None. Uses status.disruptionsAllowed when the disruption
    controller maintains it; else computes from spec the way the
    controller would (healthy = Ready pods matching the selector)."""
    from .objects import get_nested, labels_of, match_labels, name_of, namespace_of

    ns = namespace_of(pod)
    try:
        pdbs = client.list("policy/v1", "PodDisruptionBudget",
                           ListOptions(namespace=ns))
    except NotFoundError:
        return None
    if not pdbs:
        return None
    pod_labels = labels_of(pod)

    def is_ready(p: dict) -> bool:
        return any(c.get("type") == "Ready" and c.get("status") == "True"
                   for c in get_nested(p, "status", "conditions",
                                       default=[]) or [])

    for pdb in pdbs:
        # full LabelSelector (matchLabels AND matchExpressions), like the
        # real disruption controller
        sel = get_nested(pdb, "spec", "selector", default=None)
        if not sel or not match_labels(pod_labels, sel):
            continue
        allowed = get_nested(pdb, "status", "disruptionsAllowed")
        if allowed is None:
            matching = [p for p in client.list("v1", "Pod",
                                               ListOptions(namespace=ns))
                        if match_labels(labels_of(p), sel)
                        and not get_nested(p, "metadata", "deletionTimestamp")]
            healthy = sum(1 for p in matching if is_ready(p))
            spec = pdb.get("spec") or {}
            if spec.get("minAvailable") is not None:
                need = _resolve_budget_count(spec["minAvailable"],
                                             len(matching))
                allowed = healthy - need
            elif spec.get("maxUnavailable") is not None:
                cap = _resolve_budget_count(spec["maxUnavailable"],
                                            len(matching))
                allowed = cap - (len(matching) - healthy)
            else:
                allowed = 1
        if allowed <= 0:
            return name_of(pdb)
    return None


def merge_patch(base: dict, patch: Mapping) -> dict:
    """RFC 7386 merge-patch used by Client.patch implementations.

    A Mapping patch value always recurses — against the existing member
    when it is a Mapping, else against an empty object — so nulls inside
    a freshly-introduced section are STRIPPED (delete markers), never
    stored as literal None. A real apiserver behaves this way; storing
    the None would be a mock/real divergence (fuzz-pinned in
    tests/test_fuzz_runtime.py)."""
    out = dict(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, Mapping):
            cur = out.get(k)
            out[k] = merge_patch(dict(cur) if isinstance(cur, Mapping)
                                 else {}, v)
        else:
            out[k] = v
    return out


@dataclass
class WatchHub:
    """Shared fan-out of watch events to subscribers, keyed by kind."""

    _lock: threading.Lock = field(default_factory=threading.Lock)
    _subs: dict = field(default_factory=dict)  # (api_version, kind) -> list[handler]

    def subscribe(self, api_version: str, kind: str,
                  handler: Callable[[WatchEvent], None]) -> Callable[[], None]:
        key = (api_version, kind)
        with self._lock:
            self._subs.setdefault(key, []).append(handler)

        def unsubscribe():
            with self._lock:
                try:
                    self._subs[key].remove(handler)
                except (KeyError, ValueError):
                    pass

        return unsubscribe

    def publish(self, event: WatchEvent) -> None:
        key = (event.obj.get("apiVersion", ""), event.obj.get("kind", ""))
        with self._lock:
            handlers = list(self._subs.get(key, ()))
        for h in handlers:
            h(event)

    def handlers_for(self, api_version: str, kind: str) -> Iterable[Callable]:
        with self._lock:
            return list(self._subs.get((api_version, kind), ()))

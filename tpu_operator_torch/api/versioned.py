"""Typed clientset for the operator's own CRDs.

The port's counterpart of ``tpu_operator/api/versioned.py``: the
group/version accessors are ``gpu_v1()`` and ``gpu_v1alpha1()``, the
driver CR ``GPUDriver`` through ``gpu_drivers()``.

The analog of the reference's generated clientset + fakes
(api/versioned/, ~900 LoC of client-gen output: ``versioned.Clientset``
with per-group/version accessors and ``fake.NewSimpleClientset``).
Python needs no codegen — the dataclass CR types (clusterpolicy.py,
gpudriver.py) already carry wire names and conversion — so this module
derives the same surface by hand: a ``Clientset`` whose group/version
accessors return typed resource interfaces, and a seeded in-memory fake.

Semantics mirrored from the generated Go client:

- typed get/list/create/update/delete/watch per resource;
- ``update_status`` hits the status subresource only (spec ignored),
  matching the ``UpdateStatus`` method client-gen emits for CRDs with a
  status subresource;
- updates serialize the whole typed spec — fields the types don't model
  are dropped, exactly as the apiserver's structural-schema pruning
  would drop them for the Go client;
- ``new_simple_clientset(*objs)`` is the fake.NewSimpleClientset slot:
  a Clientset over FakeClient pre-seeded with objects, sharing the fake
  so untyped test helpers and the typed surface see one store.

The dynamic client (runtime/client.py) stays the substrate underneath —
controllers keep using it directly; this typed facade is the *consumer*
API, like the reference's clientset is for operand code and tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Generic, List, Optional, Type, TypeVar

from ..runtime.client import Client, ListOptions, WatchEvent
from ..runtime.objects import FrozenDict, thaw_obj
from .clusterpolicy import (
    KIND_CLUSTER_POLICY,
    V1,
    GPUClusterPolicySpec,
    new_cluster_policy,
)
from .convert import field, from_dict, to_dict
from .gpudriver import KIND_GPU_DRIVER, V1ALPHA1, GPUDriverSpec, new_gpu_driver

S = TypeVar("S")  # spec dataclass
T = TypeVar("T", bound="TypedObject")


# -- typed status shapes ----------------------------------------------------
# The controllers write status as plain dicts (status.state, conditions,
# clusterInfo, slices); these dataclasses are the read-side typing, the
# analog of the Status structs in clusterpolicy_types.go:1658-1681.


@dataclass
class Condition:
    """metav1.Condition shape (internal/conditions/conditions.go:31-35)."""

    type: Optional[str] = None
    status: Optional[str] = None
    reason: Optional[str] = None
    message: Optional[str] = None
    last_transition_time: Optional[str] = None


@dataclass
class SliceStatus:
    """One multi-host slice row (controllers/slices.py; VERDICT r4 #4)."""

    id: Optional[str] = None
    accelerator: Optional[str] = None
    topology: Optional[str] = None
    hosts: Optional[int] = None
    hosts_validated: Optional[int] = None
    validated: Optional[bool] = None
    upgrade_state: Optional[str] = None


@dataclass
class ClusterPolicyStatus:
    state: Optional[str] = None
    namespace: Optional[str] = None
    conditions: Optional[List[Condition]] = None
    cluster_info: Optional[dict] = field(
        description="facts published by the reconcile loop")
    slices: Optional[List[SliceStatus]] = None


@dataclass
class GPUDriverStatus:
    state: Optional[str] = None
    conditions: Optional[List[Condition]] = None


# -- typed object wrappers --------------------------------------------------


class TypedObject(Generic[S]):
    """A CR as (typed spec, typed status, raw metadata).

    Holds the raw wire dict; ``spec`` parses lazily and caches. Spec
    edits are made on the typed object and serialized back on
    create/update — the wrapper is the unit of round-tripping, like a
    typed Go struct is for the generated client.
    """

    api_version: str = ""
    kind: str = ""
    spec_type: Type[S] = dict  # type: ignore[assignment]
    status_type: type = dict

    def __init__(self, raw: dict):
        if raw.get("kind") not in (None, self.kind):
            raise ValueError(
                f"expected kind {self.kind}, got {raw.get('kind')}")
        # client reads hand out frozen views; the wrapper is an editing
        # unit, so take a private mutable copy on ingest
        self.raw = thaw_obj(raw) if isinstance(raw, FrozenDict) else raw
        self._spec: Optional[S] = None

    # metadata ------------------------------------------------------------
    @property
    def metadata(self) -> dict:
        return self.raw.setdefault("metadata", {})

    @property
    def name(self) -> str:
        return self.metadata.get("name", "")

    @property
    def resource_version(self) -> Optional[str]:
        return self.metadata.get("resourceVersion")

    @property
    def labels(self) -> dict:
        return self.metadata.setdefault("labels", {})

    @property
    def annotations(self) -> dict:
        return self.metadata.setdefault("annotations", {})

    # spec / status -------------------------------------------------------
    @property
    def spec(self) -> S:
        if self._spec is None:
            self._spec = from_dict(self.spec_type, self.raw.get("spec") or {})
        return self._spec

    @spec.setter
    def spec(self, value: S) -> None:
        self._spec = value

    @property
    def status(self):
        """Typed read-only view of ``.status`` (controllers own writes;
        consumers read). Re-parsed per access: status churns under the
        reconcile loop and a stale cache here would hide transitions."""
        return from_dict(self.status_type, self.raw.get("status") or {})

    def to_wire(self) -> dict:
        """Raw dict with the (possibly edited) typed spec serialized in."""
        out = dict(self.raw)
        out.setdefault("apiVersion", self.api_version)
        out.setdefault("kind", self.kind)
        if self._spec is not None:
            out["spec"] = to_dict(self._spec)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{self.kind} {self.name}>"


class ClusterPolicy(TypedObject[GPUClusterPolicySpec]):
    api_version = V1
    kind = KIND_CLUSTER_POLICY
    spec_type = GPUClusterPolicySpec
    status_type = ClusterPolicyStatus

    @classmethod
    def new(cls, name: str = "gpu-cluster-policy",
            spec: Optional[dict] = None) -> "ClusterPolicy":
        return cls(new_cluster_policy(name, spec))


class GPUDriver(TypedObject[GPUDriverSpec]):
    api_version = V1ALPHA1
    kind = KIND_GPU_DRIVER
    spec_type = GPUDriverSpec
    status_type = GPUDriverStatus

    @classmethod
    def new(cls, name: str, spec: Optional[dict] = None) -> "GPUDriver":
        return cls(new_gpu_driver(name, spec))


# -- typed resource interface ----------------------------------------------


@dataclass(frozen=True)
class TypedWatchEvent(Generic[T]):
    type: str  # ADDED | MODIFIED | DELETED
    obj: T


class ResourceInterface(Generic[T]):
    """Typed CRUD+watch for one cluster-scoped CR kind — the per-resource
    interface client-gen emits (Get/List/Create/Update/UpdateStatus/
    Delete/Watch), over the dynamic client."""

    def __init__(self, client: Client, wrapper: Type[T]):
        self._client = client
        self._w = wrapper

    def get(self, name: str) -> T:
        return self._w(self._client.get(
            self._w.api_version, self._w.kind, name))

    def get_or_none(self, name: str) -> Optional[T]:
        raw = self._client.get_or_none(self._w.api_version, self._w.kind, name)
        return self._w(raw) if raw is not None else None

    def list(self, label_selector: Optional[dict] = None) -> List[T]:
        opts = ListOptions(label_selector=label_selector) \
            if label_selector else None
        return [self._w(o) for o in self._client.list(
            self._w.api_version, self._w.kind, opts)]

    def create(self, obj: T) -> T:
        return self._w(self._client.create(obj.to_wire()))

    def update(self, obj: T) -> T:
        return self._w(self._client.update(obj.to_wire()))

    def update_status(self, obj: T) -> T:
        """Status-subresource write; typed-spec edits are NOT persisted
        (the subresource ignores spec), matching UpdateStatus."""
        return self._w(self._client.update_status(obj.to_wire()))

    def delete(self, name: str) -> None:
        self._client.delete(self._w.api_version, self._w.kind, name)

    def watch(self, handler: Callable[[TypedWatchEvent[T]], None]
              ) -> Callable[[], None]:
        def _typed(ev: WatchEvent) -> None:
            handler(TypedWatchEvent(type=ev.type, obj=self._w(ev.obj)))

        return self._client.watch(self._w.api_version, self._w.kind, _typed)


# -- clientset --------------------------------------------------------------


class GpuV1:
    """Group/version accessor, the NvidiaV1() slot on the clientset."""

    def __init__(self, client: Client):
        self._client = client

    def cluster_policies(self) -> ResourceInterface[ClusterPolicy]:
        return ResourceInterface(self._client, ClusterPolicy)


class GpuV1alpha1:
    """Group/version accessor for the v1alpha1 driver CR."""

    def __init__(self, client: Client):
        self._client = client

    def gpu_drivers(self) -> ResourceInterface[GPUDriver]:
        return ResourceInterface(self._client, GPUDriver)


class Clientset:
    """versioned.Clientset analog: one handle, per-group/version accessors.

    Wraps any dynamic ``Client`` (fake or HTTP), so the typed surface
    works identically against tests and a real apiserver.
    """

    def __init__(self, client: Client):
        self.dynamic = client

    def gpu_v1(self) -> GpuV1:
        return GpuV1(self.dynamic)

    def gpu_v1alpha1(self) -> GpuV1alpha1:
        return GpuV1alpha1(self.dynamic)


def new_clientset(client: Client) -> Clientset:
    return Clientset(client)


def new_simple_clientset(*objects) -> Clientset:
    """fake.NewSimpleClientset analog: a Clientset over an in-memory
    apiserver pre-seeded with ``objects`` (typed wrappers or raw dicts).
    The underlying FakeClient is reachable as ``.dynamic`` so tests can
    mix typed and untyped access against one store."""
    from ..runtime.fake import FakeClient

    client = FakeClient()
    for obj in objects:
        raw = obj.to_wire() if isinstance(obj, TypedObject) else obj
        client.create(raw)
    return Clientset(client)


__all__ = [
    "ClusterPolicy",
    "ClusterPolicyStatus",
    "Clientset",
    "Condition",
    "ResourceInterface",
    "SliceStatus",
    "GPUDriver",
    "GPUDriverStatus",
    "GpuV1",
    "GpuV1alpha1",
    "TypedObject",
    "TypedWatchEvent",
    "new_clientset",
    "new_simple_clientset",
]

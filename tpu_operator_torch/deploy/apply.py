"""Take the rendered install stream to a cluster — the Helm-verb slot.

The port's counterpart of ``tpu_operator/deploy/apply.py``.

The reference's primary install path is its chart
(deployments/gpu-operator/values.yaml, templates/clusterpolicy.yaml):
`helm install/upgrade --wait` and `helm uninstall` with pre-upgrade /
pre-delete hook Jobs (templates/upgrade_crd.yaml, cleanup_crd.yaml).
This framework renders the same stream offline (deploy/values.py); this
module supplies the verbs so ONE command takes an empty cluster to
all-operands-ready:

    gpuop-cfg install  --values f.yaml --wait
    gpuop-cfg upgrade  --values f.yaml --wait     # re-applies CRDs first
    gpuop-cfg uninstall [--purge-crds]

Create-or-update carries the live resourceVersion (optimistic
concurrency); uninstall sequences the cleanup the way the pre-delete
hook does: CRs first (operands tear down through owner GC while the
operator still runs), then the operator stream, then optionally the
CRDs.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from ..api.clusterpolicy import KIND_CLUSTER_POLICY, V1
from ..runtime.client import Client, NotFoundError
from ..runtime.objects import name_of, namespace_of

Log = Callable[[str], None]


def _ident(doc: dict) -> Tuple[str, str, str, Optional[str]]:
    return (doc.get("apiVersion", ""), doc.get("kind", ""),
            name_of(doc), namespace_of(doc) or None)


def apply_docs(client: Client, docs: List[dict],
               log: Log = lambda s: None) -> List[Tuple[str, str, str]]:
    """Create-or-update every document, in stream order (render_bundle
    already emits install order: CRDs -> Namespace -> RBAC -> operator
    -> CR, matching Helm's kind ordering). Returns (verb, kind, name)
    per document."""
    # groups whose CRDs ship in this very stream: only their CRs can hit
    # the establishment window and deserve the create retry
    stream_groups = {d.get("spec", {}).get("group", "")
                     for d in docs
                     if d.get("kind") == "CustomResourceDefinition"}
    out: List[Tuple[str, str, str]] = []
    for doc in docs:
        av, kind, name, ns = _ident(doc)
        existing = client.get_or_none(av, kind, name, ns)
        if existing is None:
            _create_with_establish_retry(client, doc, stream_groups)
            verb = "created"
        else:
            # never mutate the caller's rendered doc: the stream may be
            # reused (reinstall, delete) and a stamped resourceVersion
            # would then poison a later create
            merged = dict(doc)
            merged["metadata"] = dict(doc.get("metadata") or {})
            merged["metadata"]["resourceVersion"] = (
                existing.get("metadata") or {}).get("resourceVersion")
            client.update(merged)
            verb = "configured"
        log(f"{verb} {kind}/{name}")
        out.append((verb, kind, name))
    return out


def _create_with_establish_retry(client: Client, doc: dict,
                                 stream_groups: set,
                                 attempts: int = 10,
                                 backoff_s: float = 1.0) -> None:
    """Create, riding out the CRD-establishment window: on a real
    apiserver a CR POSTed right after its CRD returns 404 'no matches
    for kind' until the discovery cache catches up (a few seconds). Only
    CRs of groups whose CRD ships in the SAME stream get the retry — a
    404 on anything else (built-in kinds, dotted built-in groups like
    rbac.authorization.k8s.io, absent third-party CRDs) is a genuine
    error and fails immediately."""
    last: Optional[Exception] = None
    group = doc.get("apiVersion", "").split("/")[0]
    n = attempts if group in stream_groups else 1
    for attempt in range(n):
        try:
            client.create(doc)
            return
        except NotFoundError as e:
            last = e
            if attempt < n - 1:
                time.sleep(backoff_s)
    raise last  # type: ignore[misc]


def delete_docs(client: Client, docs: List[dict], log: Log = lambda s: None,
                keep_kinds: Tuple[str, ...] = ()) -> int:
    """Delete the stream in reverse order (CR before its CRD, workloads
    before RBAC), ignoring already-gone objects. ``keep_kinds`` skips
    kinds the caller wants to survive (Namespace by default at the CLI:
    deleting a shared namespace is not an uninstaller's call)."""
    deleted = 0
    for doc in reversed(docs):
        av, kind, name, ns = _ident(doc)
        if kind in keep_kinds:
            continue
        try:
            client.delete(av, kind, name, ns)
            log(f"deleted {kind}/{name}")
            deleted += 1
        except NotFoundError:
            pass
    return deleted


def sweep_operands(client: Client, log: Log = lambda s: None,
                   settle_s: float = 0.5, max_s: float = 30.0,
                   namespace: str = "") -> int:
    """Delete any operand object still carrying the state label after CR
    teardown. Owner GC removes almost everything, but a reconcile pass
    that fetched the CR just before deletion keeps applying states for
    several seconds afterward, re-creating operands with dangling
    ownerRefs (cluster GC would collect them eventually — an uninstaller
    shouldn't leave that to chance). Sweep repeatedly until two
    consecutive passes find nothing, so the in-flight pass has drained."""
    from ..api.labels import STATE_LABEL
    from ..runtime.client import ListOptions
    from ..runtime.objects import is_namespaced, labels_of
    from ..state.skel import SWEEPABLE_KINDS

    selector = {"matchExpressions": [
        {"key": STATE_LABEL, "operator": "Exists"}]}

    def one_pass() -> int:
        n = 0
        for av, kind in SWEEPABLE_KINDS:
            # namespaced kinds sweep within the install namespace (the
            # operator's RBAC write scope); cluster kinds cluster-wide
            opts = ListOptions(label_selector=selector,
                               namespace=namespace
                               if namespace and is_namespaced(kind)
                               else None)
            try:
                objs = client.list(av, kind, opts)
            except NotFoundError:
                continue
            for obj in objs:
                if STATE_LABEL not in labels_of(obj):
                    continue
                try:
                    client.delete(av, kind, name_of(obj),
                                  namespace_of(obj) or None)
                    log(f"swept leftover {kind}/{name_of(obj)}")
                    n += 1
                except NotFoundError:
                    pass
        return n

    swept = 0
    clean = 0
    deadline = time.monotonic() + max_s
    while clean < 2 and time.monotonic() < deadline:
        n = one_pass()
        swept += n
        clean = clean + 1 if n == 0 else 0
        if clean < 2:
            time.sleep(settle_s)
    return swept


def wait_policy_ready(client: Client, timeout_s: float = 300.0,
                      poll_s: float = 2.0,
                      log: Log = lambda s: None) -> bool:
    """Block until every GPUClusterPolicy AND every GPUDriver reports
    status.state == ready — the `helm install --wait` contract, with the
    reference e2e's 5-minute default budget
    (tests/e2e/gpu_operator_test.go:83-88). GPUDrivers matter because
    their presence stands the policy's built-in driver state down: a
    policy can be 'ready' while per-pool driver rollout is still
    pending."""
    from ..api.gpudriver import KIND_GPU_DRIVER, V1ALPHA1

    deadline = time.monotonic() + timeout_s
    last = "no GPUClusterPolicy observed yet"
    while time.monotonic() < deadline:
        states = {}
        any_policy = False
        for av, kind in ((V1, KIND_CLUSTER_POLICY),
                         (V1ALPHA1, KIND_GPU_DRIVER)):
            try:
                crs = client.list(av, kind)
            except NotFoundError:
                crs = []
            for c in crs:
                any_policy = any_policy or kind == KIND_CLUSTER_POLICY
                states[f"{kind}/{name_of(c)}"] = (
                    (c.get("status") or {}).get("state") or "unset")
        if any_policy:
            if all(s == "ready" for s in states.values()):
                log(f"ready: {states}")
                return True
            last = str(states)
        time.sleep(poll_s)
    log(f"timed out after {timeout_s:.0f}s waiting for ready; last: {last}")
    return False

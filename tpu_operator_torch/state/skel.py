"""Apply/readiness skeleton shared by all states (the port's own copy of
``tpu_operator/state/skel.py``).

The stateSkel core of the reference's engine B
(internal/state/state_skel.go:223-285 createOrUpdateObjs,
:313-342 label-based stale deletion, :383-444 readiness), keeping the two
hard-won behaviors SURVEY.md section 7 calls out:

- **hash-skip updates**: every applied object carries an annotation with a
  hash of its desired spec; an unchanged hash skips the update entirely
  (object_controls.go:4303-4346 analog). Without this, every reconcile
  rewrites every DaemonSet and churns pods.
- **update-strategy-aware readiness**: a DaemonSet is ready only when the
  apiserver has observed its latest generation and all scheduled pods are
  both available and on the current revision (updatedNumberScheduled);
  this is what makes OnDelete driver-style operands safe
  (object_controls.go:3526-3602 analog).
"""

from __future__ import annotations

import logging
import threading
import weakref
from typing import Iterable, List, Optional, Tuple

from ..api.labels import LAST_APPLIED_HASH, SPEC_HASH, STATE_LABEL
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..runtime.client import SPEC_HASH_GATE, Client, ListOptions, NotFoundError
from ..runtime.objects import (
    annotations_of,
    get_nested,
    is_namespaced,
    name_of,
    namespace_of,
    set_annotation,
    set_label,
    set_owner_reference,
)
from ..runtime.timeline import TIMELINE
from ..utils.hash import object_hash

log = logging.getLogger("tpu_operator_torch.state")


def _subset_match(desired, live) -> bool:
    """Recursive desired⊆live: every desired dict key must match in the
    live object (live-only extras are tolerated — apiserver defaulting
    only ADDS fields); lists and scalars compare exactly. This is the
    drift check behind the spec-hash skip: an out-of-band edit to a live
    object leaves its spec-hash annotation intact, so the annotation
    alone cannot be trusted."""
    if isinstance(desired, dict):
        if not isinstance(live, dict):
            return False
        return all(k in live and _subset_match(v, live[k])
                   for k, v in desired.items())
    if isinstance(desired, list):
        return (isinstance(live, list) and len(desired) == len(live)
                and all(_subset_match(d, l) for d, l in zip(desired, live)))
    return desired == live


def _live_matches_desired(desired: dict, live: dict) -> bool:
    """True when ``live`` still embodies ``desired``: every non-metadata
    top-level section subset-matches, and the desired labels/annotations
    are a subset of the live ones (live metadata legitimately carries
    uid/resourceVersion/creationTimestamp on top)."""
    for k, v in desired.items():
        if k in ("status", "metadata"):
            continue
        if not _subset_match(v, live.get(k)):
            return False
    dmeta = desired.get("metadata") or {}
    lmeta = live.get("metadata") or {}
    for mk in ("labels", "annotations"):
        if not _subset_match(dmeta.get(mk) or {}, lmeta.get(mk) or {}):
            return False
    return True


# per-client state names that have had a full sweep since that client's
# manager started — see the first-reconcile widening below. Keyed by
# client identity (weakly, so test clients don't accumulate): a second
# manager/cluster in the same process gets its own first-start sweep.
_fully_swept: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_swept_lock = threading.Lock()


def apply_objects(client: Client, owner: Optional[dict], state_name: str,
                  objects: Iterable[dict], namespace: str,
                  sweep_kinds: Optional[set] = None) -> List[dict]:
    """Create-or-update the desired objects for a state; returns the live
    objects. Also deletes stale objects still labeled for this state but no
    longer desired (cleanupStale analog). ``sweep_kinds`` — the
    (apiVersion, kind) set this state's templates can possibly emit —
    bounds the stale sweep; None sweeps every known kind.

    The bound is ignored on each state's FIRST reconcile after operator
    start: ``sweep_kinds`` is scanned from the templates on disk, so a
    kind an older operator version emitted but this version's templates
    dropped entirely would otherwise never be swept — the 'stale grant
    survives forever' failure, reintroduced across operator upgrades.
    Steady-state reconciles keep the bounded (cheap) sweep."""
    with _swept_lock:
        full_sweep = state_name not in _fully_swept.setdefault(client, set())
    if full_sweep:
        sweep_kinds = None
    applied: List[dict] = []
    desired_keys = set()
    for obj in objects:
        if is_namespaced(obj.get("kind", "")):
            obj.setdefault("metadata", {}).setdefault("namespace", namespace)
        set_label(obj, STATE_LABEL, state_name)
        if owner is not None:
            set_owner_reference(obj, owner)
        desired_hash = object_hash(
            {k: v for k, v in obj.items() if k != "status"})
        set_annotation(obj, LAST_APPLIED_HASH, desired_hash)
        # the spec-hash contract (OPERATIONS.md): same stable hash, the
        # annotation the zero-write skip below keys on. Stamped before
        # create/update so every live operand carries it.
        set_annotation(obj, SPEC_HASH, desired_hash)
        desired_keys.add((obj.get("apiVersion", ""), obj.get("kind", ""),
                          namespace_of(obj), name_of(obj)))
        existing = client.get_or_none(obj.get("apiVersion", ""),
                                      obj.get("kind", ""), name_of(obj),
                                      namespace_of(obj) or None)
        if existing is None:
            applied.append(client.create(obj))
            log.info("[%s] created %s/%s", state_name, obj["kind"], name_of(obj))
            continue
        if SPEC_HASH_GATE.enabled:
            # zero-write skip: annotation match alone is not enough — an
            # out-of-band spec edit keeps the stamp, so the live object
            # must also still subset-match the rendered desired state.
            # Both checks run on the cached read: skipping costs the
            # apiserver nothing.
            if (annotations_of(existing).get(SPEC_HASH) == desired_hash
                    and _live_matches_desired(obj, existing)):
                OPERATOR_METRICS.writes_avoided.labels(
                    kind=obj.get("kind", "")).inc()
                if TIMELINE.enabled:
                    TIMELINE.record(obj.get("kind", ""), name_of(obj),
                                    "write-avoided",
                                    {"state": state_name,
                                     "specHash": desired_hash[:12]})
                applied.append(existing)  # hash-skip
                continue
        elif annotations_of(existing).get(LAST_APPLIED_HASH) == desired_hash:
            applied.append(existing)  # hash-skip (pre-spec-hash behavior)
            continue
        merged = dict(obj)
        merged.setdefault("metadata", {})
        merged["metadata"]["resourceVersion"] = get_nested(
            existing, "metadata", "resourceVersion")
        if "status" in existing:
            merged["status"] = existing["status"]
        applied.append(client.update(merged))
        log.info("[%s] updated %s/%s", state_name, obj["kind"], name_of(obj))
    _delete_stale(client, state_name, desired_keys, namespace, sweep_kinds)
    if full_sweep:
        # only after the widened sweep actually ran: an exception during
        # apply or sweep must leave the state unmarked so the reconcile
        # retry still performs the full first-start sweep
        with _swept_lock:
            _fully_swept.setdefault(client, set()).add(state_name)
    return applied


# every kind any state template can emit — especially the conditionally-
# rendered ones (ServiceMonitor/PrometheusRule behind serviceMonitor
# knobs, the plugin-config ClusterRole behind devicePlugin.configMap):
# those go stale by flipping a knob off, and a kind missing here survives
# as a live grant/scrape forever
SWEEPABLE_KINDS = (("apps/v1", "DaemonSet"),
                   ("v1", "Service"),
                   ("v1", "ConfigMap"),
                   ("v1", "ServiceAccount"),
                   ("node.k8s.io/v1", "RuntimeClass"),
                   ("rbac.authorization.k8s.io/v1", "Role"),
                   ("rbac.authorization.k8s.io/v1", "RoleBinding"),
                   ("rbac.authorization.k8s.io/v1", "ClusterRole"),
                   ("rbac.authorization.k8s.io/v1", "ClusterRoleBinding"),
                   ("monitoring.coreos.com/v1", "ServiceMonitor"),
                   ("monitoring.coreos.com/v1", "PrometheusRule"))


def _delete_stale(client: Client, state_name: str, desired_keys: set,
                  namespace: str, sweep_kinds: Optional[set] = None) -> None:
    """Delete objects labeled for this state that are no longer rendered
    (state_skel.go:313-342 handleStateObjectsDeletion analog). The sweep
    is bounded to ``sweep_kinds`` when the caller knows which kinds its
    templates can emit — listing all nine known kinds for every state on
    every reconcile would be steady wasted apiserver load.

    Namespaced kinds are swept within ``namespace`` only: the operator
    renders every namespaced operand into its own namespace, and its
    RBAC write grants are namespace-scoped to match (packaging.py
    namespaced_role) — a cross-namespace delete would 403 on a real
    cluster. Cluster-scoped kinds sweep cluster-wide."""
    for api_version, kind in SWEEPABLE_KINDS:
        if sweep_kinds is not None and (api_version, kind) not in sweep_kinds:
            continue
        opts = ListOptions(label_selector={STATE_LABEL: state_name})
        if namespace and is_namespaced(kind):
            opts = ListOptions(label_selector={STATE_LABEL: state_name},
                               namespace=namespace)
        try:
            stale = client.list(api_version, kind, opts)
        except NotFoundError:
            continue
        for obj in stale:
            key = (api_version, kind, namespace_of(obj), name_of(obj))
            if key in desired_keys:
                continue
            try:
                client.delete(api_version, kind, name_of(obj),
                              namespace_of(obj) or None)
                log.info("[%s] deleted stale %s/%s", state_name, kind,
                         name_of(obj))
            except NotFoundError:
                pass


def delete_state_objects(client: Client, state_name: str,
                         namespace: str = "") -> None:
    """Remove everything a state ever applied (used when a state flips to
    disabled — the reference deletes on disable too,
    object_controls.go:4167-4174). Pass the operator namespace so the
    sweep stays inside the RBAC write scope."""
    _delete_stale(client, state_name, set(), namespace)


def daemonset_ready(ds: dict) -> Tuple[bool, str]:
    """Update-strategy-aware DaemonSet readiness.

    desired==0 counts as ready: no matching nodes means nothing to prove
    (matches isDaemonSetReady's treatment; stale-DS cleanup is a separate
    concern handled by node pools)."""
    status = ds.get("status") or {}
    gen = get_nested(ds, "metadata", "generation", default=1)
    if status.get("observedGeneration", 0) < gen:
        return False, "generation not observed"
    desired = status.get("desiredNumberScheduled", 0)
    if desired == 0:
        return True, "no nodes scheduled"
    if status.get("numberAvailable", 0) != desired:
        return False, (f"{status.get('numberAvailable', 0)}/{desired} "
                       f"pods available")
    if status.get("updatedNumberScheduled", 0) != desired:
        # pods still on an old revision — critical for OnDelete operands
        return False, (f"{status.get('updatedNumberScheduled', 0)}/{desired} "
                       f"pods on current revision")
    return True, "ready"


def deployment_ready(dep: dict) -> Tuple[bool, str]:
    status = dep.get("status") or {}
    gen = get_nested(dep, "metadata", "generation", default=1)
    if status.get("observedGeneration", 0) < gen:
        return False, "generation not observed"
    want = get_nested(dep, "spec", "replicas", default=1)
    if status.get("availableReplicas", 0) != want:
        return False, f"{status.get('availableReplicas', 0)}/{want} replicas"
    return True, "ready"


def objects_ready(client: Client, objects: Iterable[dict]) -> Tuple[bool, str]:
    """Aggregate readiness over applied objects (getSyncState analog,
    state_skel.go:383-444): workload kinds gate, config kinds are ready on
    existence."""
    for obj in objects:
        kind = obj.get("kind", "")
        live = client.get_or_none(obj.get("apiVersion", ""), kind,
                                  name_of(obj), namespace_of(obj) or None)
        if live is None:
            return False, f"{kind}/{name_of(obj)} missing"
        if kind == "DaemonSet":
            ok, msg = daemonset_ready(live)
        elif kind == "Deployment":
            ok, msg = deployment_ready(live)
        elif kind == "Pod":
            ok = get_nested(live, "status", "phase") in ("Running", "Succeeded")
            msg = get_nested(live, "status", "phase", default="Unknown")
        else:
            continue
        if not ok:
            return False, f"{kind}/{name_of(obj)}: {msg}"
    return True, "all objects ready"

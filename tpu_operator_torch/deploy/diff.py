"""Live-vs-rendered drift detection — the `kubectl diff` / helm-diff
slot for the install stream.

The port's counterpart of ``tpu_operator/deploy/diff.py``; PyYAML is
imported where a diff is dumped.

`gpuop-cfg generate` says what the cluster SHOULD run; this module asks
the cluster what it DOES run and reports, per rendered object: missing,
match, or drift (with a unified diff of normalized YAML). Server-owned
noise (status, resourceVersion/uid/timestamps, the operator's own
last-applied-hash annotation) is stripped before comparing, and fields
the desired doc doesn't set are ignored — an admission-defaulted field
is not drift.
"""

from __future__ import annotations

import copy
import difflib
from typing import List, Optional, Tuple

from ..api.labels import LAST_APPLIED_HASH
from ..runtime.client import Client
from ..runtime.objects import name_of, namespace_of, yaml_module

# metadata keys the apiserver owns; never drift
_SERVER_META = {"resourceVersion", "uid", "creationTimestamp",
                "generation", "managedFields", "selfLink",
                "ownerReferences", "finalizers"}
_OPERATOR_ANNOTATIONS = {LAST_APPLIED_HASH}


def _strip(obj: dict) -> dict:
    out = copy.deepcopy(obj)
    out.pop("status", None)
    meta = out.get("metadata") or {}
    for key in _SERVER_META:
        meta.pop(key, None)
    anns = meta.get("annotations")
    if isinstance(anns, dict):
        for key in _OPERATOR_ANNOTATIONS:
            anns.pop(key, None)
        if not anns:
            meta.pop("annotations", None)
    return out


def _project(live, desired):
    """Reduce ``live`` to the shape ``desired`` actually specifies:
    dict keys absent from desired are dropped — an admission-defaulted
    field is not drift — recursively, INCLUDING inside list items
    (apiservers default container fields like terminationMessagePath and
    ports[].protocol on every pod spec). Scalars and list length/order
    compare whole: those are part of what the manifest says."""
    if isinstance(desired, dict) and isinstance(live, dict):
        return {k: _project(live[k], v)
                for k, v in desired.items() if k in live}
    if isinstance(desired, list) and isinstance(live, list):
        # project the common prefix even when lengths differ (an added
        # sidecar must not pollute the diff with the ORIGINAL items'
        # server defaults); extra live items stay whole
        return [_project(lv, dv) for lv, dv in zip(live, desired)] \
            + live[len(desired):]
    return live


def _dump(obj: dict) -> List[str]:
    yaml = yaml_module()

    class _NoAliasDumper(yaml.SafeDumper):
        """Rendered docs reuse sub-dicts (one labels dict in two places);
        anchors/aliases in the dump would show identical blocks as
        changed against the live side, which never has them."""

        def ignore_aliases(self, data):
            return True

    return yaml.dump(obj, Dumper=_NoAliasDumper,
                     sort_keys=True).splitlines(keepends=True)


def diff_object(client: Client, desired: dict) -> Tuple[str, Optional[str]]:
    """('missing'|'match'|'drift', unified diff text or None)."""
    av = desired.get("apiVersion", "")
    kind = desired.get("kind", "")
    name = name_of(desired)
    ns = namespace_of(desired) or None
    live = client.get_or_none(av, kind, name, ns)
    if live is None:
        return "missing", None
    want = _strip(desired)
    have = _project(_strip(live), want)
    if have == want:
        return "match", None
    ident = f"{kind}/{(ns + '/') if ns else ''}{name}"
    text = "".join(difflib.unified_diff(
        _dump(have), _dump(want),
        fromfile=f"live/{ident}", tofile=f"rendered/{ident}"))
    return "drift", text


def diff_bundle(client: Client, docs: List[dict]) -> List[dict]:
    """One verdict dict per rendered object, cluster order preserved."""
    results = []
    for doc in docs:
        if not doc:
            continue
        verdict, text = diff_object(client, doc)
        results.append({
            "kind": doc.get("kind", ""),
            "name": name_of(doc),
            "namespace": namespace_of(doc),
            "verdict": verdict,
            "diff": text,
        })
    return results


def render_report(results: List[dict]) -> Tuple[str, bool]:
    """(human-readable report, clean) — clean means nothing missing or
    drifted (kubectl-diff exit-code semantics)."""
    lines = []
    clean = True
    for r in results:
        ident = (f"{r['kind']}/"
                 f"{(r['namespace'] + '/') if r['namespace'] else ''}"
                 f"{r['name']}")
        if r["verdict"] == "match":
            lines.append(f"  OK      {ident}")
            continue
        clean = False
        if r["verdict"] == "missing":
            lines.append(f"  MISSING {ident}")
        else:
            lines.append(f"  DRIFT   {ident}")
            lines.append(r["diff"] or "")
    counts = {"match": 0, "missing": 0, "drift": 0}
    for r in results:
        counts[r["verdict"]] += 1
    lines.append(f"{counts['match']} in sync, {counts['missing']} missing, "
                 f"{counts['drift']} drifted")
    return "\n".join(lines), clean

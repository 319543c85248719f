"""Offline CR validation — schema + image resolvability.

The port's counterpart of ``tpu_operator/api/validate.py``, over the
port's CRDs (``api/crd.py``) and ``api/image.py``. Library core of the
gpuop-cfg validation path (cmd/gpuop-cfg/validate/clusterpolicy
analog): used by the ``gpuop-cfg`` CLI and by the deploy bundle
renderer (a values file that renders an invalid CR must fail at render
time).
"""

from __future__ import annotations

import copy
from typing import Any, List, Optional, Tuple

from . import cel
from .clusterpolicy import KIND_CLUSTER_POLICY, V1
from .crd import cluster_policy_crd, gpu_driver_crd
from .gpudriver import KIND_GPU_DRIVER, V1ALPHA1


def _schema_errors(obj: Any, schema: dict, path: str = "") -> List[str]:
    """Minimal openAPIV3Schema checker: types, enums, unknown properties."""
    errs: List[str] = []
    if schema.get("x-kubernetes-preserve-unknown-fields"):
        return errs
    t = schema.get("type")
    if t == "object":
        if not isinstance(obj, dict):
            return [f"{path or '.'}: expected object, got {type(obj).__name__}"]
        props = schema.get("properties")
        addl = schema.get("additionalProperties")
        for k, v in obj.items():
            if v is None:
                continue
            sub = None
            if props and k in props:
                sub = props[k]
            elif addl:
                sub = addl
            elif props is not None:
                errs.append(f"{path}/{k}: unknown field")
                continue
            if sub:
                errs.extend(_schema_errors(v, sub, f"{path}/{k}"))
    elif t == "array":
        if not isinstance(obj, list):
            return [f"{path}: expected array, got {type(obj).__name__}"]
        for i, v in enumerate(obj):
            errs.extend(_schema_errors(v, schema.get("items", {}),
                                       f"{path}[{i}]"))
    elif t == "string":
        if not isinstance(obj, str):
            errs.append(f"{path}: expected string, got {type(obj).__name__}")
        elif "enum" in schema and obj not in schema["enum"]:
            errs.append(f"{path}: {obj!r} not in {schema['enum']}")
    elif t == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            errs.append(f"{path}: expected integer, got {type(obj).__name__}")
    elif t == "number":
        if not isinstance(obj, (int, float)) or isinstance(obj, bool):
            errs.append(f"{path}: expected number, got {type(obj).__name__}")
    elif t == "boolean":
        if not isinstance(obj, bool):
            errs.append(f"{path}: expected boolean, got {type(obj).__name__}")
    return errs


def _image_errors(cr: dict) -> List[str]:
    """Every operand with explicit image fields must resolve."""
    from .image import image_path

    errs = []
    spec = cr.get("spec") or {}
    for component, body in spec.items():
        if not isinstance(body, dict):
            continue
        fields = {k: body.get(k) for k in ("repository", "image", "version")}
        if not any(fields.values()):
            continue  # built-in defaults apply
        try:
            image_path(component, fields["repository"], fields["image"],
                       fields["version"])
        except ValueError as e:
            errs.append(f"/spec/{component}: {e}")
    return errs


def validate_cr(cr: dict) -> Tuple[List[str], str]:
    kind = cr.get("kind", "")
    if kind == KIND_CLUSTER_POLICY:
        crd, want_av = cluster_policy_crd(), V1
    elif kind == KIND_GPU_DRIVER:
        crd, want_av = gpu_driver_crd(), V1ALPHA1
    else:
        return ([f"unsupported kind {kind!r}"], kind)
    errs = []
    if cr.get("apiVersion") != want_av:
        errs.append(f"apiVersion: want {want_av}, got {cr.get('apiVersion')}")
    if not (cr.get("metadata") or {}).get("name"):
        errs.append("metadata.name: required")
    schema = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
    # validate what the apiserver would persist: the defaulted spec
    spec = apply_schema_defaults(copy.deepcopy(cr.get("spec") or {}),
                                 schema["properties"]["spec"])
    errs.extend(_schema_errors(spec, schema["properties"]["spec"], "/spec"))
    errs.extend(cel.schema_cel_errors(spec, None,
                                      schema["properties"]["spec"], "/spec"))
    errs.extend(_image_errors(cr))
    errs.extend(_semantic_errors(cr, kind))
    return errs, kind


def apply_schema_defaults(obj: Any, schema: dict) -> Any:
    """Structural-schema defaulting, the apiserver's write-time pass:
    an absent (or null) field whose schema carries ``default:`` is filled
    in before validation runs. Defaults apply only inside objects that
    are present — an absent parent object is not conjured (matching the
    apiserver, which defaults within existing structure only). Mutates
    and returns ``obj``."""
    if not isinstance(obj, dict) or schema.get("type") != "object":
        return obj
    for key, sub in (schema.get("properties") or {}).items():
        if obj.get(key) is None and "default" in sub:
            obj[key] = copy.deepcopy(sub["default"])
        if isinstance(obj.get(key), dict):
            apply_schema_defaults(obj[key], sub)
        elif isinstance(obj.get(key), list) and \
                (sub.get("items") or {}).get("type") == "object":
            for item in obj[key]:
                apply_schema_defaults(item, sub["items"])
    return obj


def admission_errors(new: dict, old: Optional[dict],
                     schema: dict) -> List[str]:
    """What a real apiserver checks on create/update of a CR whose CRD
    carries this openAPIV3Schema: structural defaulting first (mutates
    ``new`` in place, so callers persist the defaulted object exactly as
    the apiserver does), then structural types + enums, then every CEL
    x-kubernetes-validations rule (transition rules only on update).
    Defaulting before CEL is what makes transition rules on defaulted
    fields sound: oldSelf always exists, so an in-place flip of e.g.
    `driverType` cannot slip past `self == oldSelf` by having been created
    without the field. Used by the mock apiserver so admission-time
    rejection is testable `kubectl apply`-shaped
    (nvidiadriver_types.go:40-186 parity)."""
    spec_schema = (schema.get("properties") or {}).get("spec") or {}
    new_spec = new.get("spec")
    if isinstance(new_spec, dict):
        apply_schema_defaults(new_spec, spec_schema)
    new_spec = new_spec or {}
    old_spec = (old or {}).get("spec") if old is not None else None
    if isinstance(old_spec, dict):
        # stored objects were defaulted at their own write time on a real
        # apiserver; fixture-injected mock objects may predate that, so
        # default a copy rather than trusting the store
        old_spec = apply_schema_defaults(copy.deepcopy(old_spec),
                                         spec_schema)
    errs = _schema_errors(new_spec, spec_schema, "/spec")
    errs.extend(cel.schema_cel_errors(new_spec, old_spec, spec_schema,
                                      "/spec"))
    return errs


def _semantic_errors(cr: dict, kind: str) -> List[str]:
    """Rules neither the type schema nor the CRD CEL rules express.
    (The core-proof disable rejection moved into the ClusterPolicy CRD's
    x-kubernetes-validations — crd.py CORE_PROOFS — so it now also
    bounces at admission; schema_cel_errors above enforces the same rule
    text offline.)"""
    return []

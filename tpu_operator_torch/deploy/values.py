"""Values-driven bundle rendering — the Helm values.yaml slot.

The port's counterpart of ``tpu_operator/deploy/values.py``, over the
port's own ``values.yaml`` (its defaults are ``new_cluster_policy()``'s
policy) and the values key ``gpuDrivers`` (the reference's
``gpuDrivers``). PyYAML is imported where a function reads YAML.

The reference's chart (deployments/gpu-operator/values.yaml, 546 lines)
renders the ClusterPolicy CR plus the operator Deployment/RBAC from one
values file, and CI keeps values and CRD schema consistent
(``make validate-helm-values``/``validate-csv``, Makefile:233-243). Here
the same contract is code:

- ``deploy/values.yaml`` is the documented default values file,
- ``load_values()`` deep-merges a user file over the defaults and rejects
  unknown top-level keys,
- ``render_bundle()`` produces the full install stream (CRDs, namespace,
  RBAC, Deployment, ClusterPolicy) and **validates the rendered CR
  against the CRD schema before emitting it** — the drift gate runs at
  render time, not in a separate CI step.

CLI: ``gpuop-cfg generate all --values my-values.yaml``.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, List, Optional

from .. import __version__
from ..api.clusterpolicy import new_cluster_policy
from ..runtime.objects import yaml_module
from .packaging import (
    cleanup_crd_hook,
    cluster_role,
    cluster_role_binding,
    namespace_manifest,
    namespaced_role,
    operator_deployment,
    role_binding,
    service_account,
    upgrade_crd_hook,
)

# shipped as package data so pip installs carry it (see pyproject
# [tool.setuptools.package-data])
VALUES_FILE = pathlib.Path(__file__).resolve().parent / "values.yaml"

TOP_LEVEL_KEYS = {"namespace", "operator", "clusterPolicy", "pluginConfig",
                  "gpuDrivers"}


def default_values() -> Dict[str, Any]:
    yaml = yaml_module()

    with open(VALUES_FILE) as f:
        return yaml.safe_load(f) or {}


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Helm-style merge: maps merge recursively, scalars/lists replace."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_values(path: Optional[str] = None) -> Dict[str, Any]:
    yaml = yaml_module()

    values = default_values()
    if path:
        with open(path) as f:
            user = yaml.safe_load(f) or {}
        if not isinstance(user, dict):
            raise ValueError(f"{path}: values file must be a mapping")
        unknown = set(user) - TOP_LEVEL_KEYS
        if unknown:
            raise ValueError(
                f"{path}: unknown top-level keys {sorted(unknown)} "
                f"(known: {sorted(TOP_LEVEL_KEYS)})")
        values = deep_merge(values, user)
    return values


def operator_image(values: Dict[str, Any]) -> str:
    op = values.get("operator") or {}
    if not isinstance(op, dict):
        raise ValueError("operator: must be a mapping")
    # `or` (not dict defaults) so explicit nulls fall back too; reject
    # non-string scalars (a YAML float version would otherwise crash or
    # render a bogus image reference)
    repo = op.get("repository") or "ghcr.io/gpu-operator"
    image = op.get("image") or "gpu-operator"
    version = op.get("version") or f"v{__version__}"
    for name, val in (("repository", repo), ("image", image),
                      ("version", version)):
        if not isinstance(val, str):
            raise ValueError(
                f"operator.{name}: expected string, got {val!r} "
                f"(quote it in the values file)")
    if version.startswith("sha256:"):
        return f"{repo}/{image}@{version}"
    return f"{repo}/{image}:{version}"


def render_cluster_policy(values: Dict[str, Any]) -> Optional[dict]:
    cp = values.get("clusterPolicy") or {}
    if not cp.get("enabled", True):
        return None
    cr = new_cluster_policy(name=cp.get("name", "gpu-cluster-policy"),
                            spec=cp.get("spec") or {})
    # the validate-helm-values gate, inline: a values file that renders an
    # invalid CR fails at render time with the schema errors
    from ..api.validate import validate_cr

    errs, _ = validate_cr(cr)
    if errs:
        raise ValueError("values render an invalid GPUClusterPolicy:\n  " +
                         "\n  ".join(errs))
    return cr


def render_gpu_drivers(values: Dict[str, Any]) -> List[dict]:
    """Per-pool GPUDriver CRs from values (the chart's nvidiadriver.yaml
    slot: `driver.nvidiaDriverCRD` renders an NVIDIADriver CR alongside
    the ClusterPolicy). Each entry is {name, spec}; every rendered CR is
    schema+CEL validated at render time like the ClusterPolicy."""
    from ..api.gpudriver import new_gpu_driver
    from ..api.validate import validate_cr

    out: List[dict] = []
    seen: set = set()
    for i, entry in enumerate(values.get("gpuDrivers") or []):
        if not isinstance(entry, dict) or not entry.get("name"):
            raise ValueError(f"gpuDrivers[{i}]: each entry needs a name "
                             f"(and optionally a spec mapping)")
        if entry["name"] in seen:
            raise ValueError(
                f"gpuDrivers[{i}]: duplicate name {entry['name']!r} — the "
                f"later spec would silently overwrite the earlier one")
        seen.add(entry["name"])
        cr = new_gpu_driver(entry["name"], spec=entry.get("spec") or {})
        errs, _ = validate_cr(cr)
        if errs:
            raise ValueError(
                f"values render an invalid GPUDriver {entry['name']!r}:"
                "\n  " + "\n  ".join(errs))
        out.append(cr)
    # an empty nodeSelector selects ALL GPU nodes, so two selector-less
    # entries can never be valid — catch it at render time instead of
    # leaving both CRs NotReady (controllers/validation.py enforces the
    # full per-node disjointness at reconcile, which needs the cluster)
    selectorless = [d["metadata"]["name"] for d in out
                    if not (d.get("spec") or {}).get("nodeSelector")]
    if len(selectorless) > 1:
        raise ValueError(
            f"gpuDrivers: entries {selectorless} all omit nodeSelector; "
            f"an empty selector matches every GPU node, so at most one "
            f"entry may omit it")
    return out


def render_plugin_config_map(values: Dict[str, Any]) -> Optional[dict]:
    """Ship the per-node plugin-config ConfigMap from values
    (devicePlugin.config.create/data slot, templates/plugin_config.yaml).
    Every entry is parsed with the plugin's own loader at render time, so
    a config the plugin would reject fails the install render instead of
    being silently kept-out at reload time."""
    pc = values.get("pluginConfig") or {}
    if not pc.get("create") or not pc.get("data"):
        return None
    cp = values.get("clusterPolicy") or {}
    name = ((cp.get("spec") or {}).get("devicePlugin") or {}).get("configMap")
    if not name:
        raise ValueError(
            "pluginConfig.create is true but "
            "clusterPolicy.spec.devicePlugin.configMap names no ConfigMap")
    from ..deviceplugin.plugin import parse_plugin_config

    data = {}
    for key, text in pc["data"].items():
        if not isinstance(text, str):
            raise ValueError(f"pluginConfig.data.{key}: must be a YAML "
                             f"string (use a block scalar)")
        try:
            parse_plugin_config(key, text)
        except Exception as e:  # surface WITH the key, whatever the type
            raise ValueError(f"pluginConfig.data.{key}: {e}")
        data[key] = text
    # the most common typo: a defaultConfig that names no shipped entry
    # would strand every unlabeled node on the built-in sharing policy at
    # reload time — both values are in hand here, so fail the render
    default = ((cp.get("spec") or {}).get("devicePlugin")
               or {}).get("defaultConfig")
    if default and default not in data:
        raise ValueError(
            f"clusterPolicy.spec.devicePlugin.defaultConfig {default!r} "
            f"is not a key of pluginConfig.data {sorted(data)}")
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name,
                         "namespace": values.get("namespace",
                                                 "gpu-operator")},
            "data": data}


def render_bundle(values: Dict[str, Any], include_crds: bool = True) -> List[dict]:
    from ..api.crd import all_crds

    ns = values.get("namespace", "gpu-operator")
    docs: List[dict] = []
    if include_crds:
        docs.extend(all_crds())
    docs.extend([
        namespace_manifest(ns),
        service_account(ns),
        cluster_role(),
        cluster_role_binding(ns),
        namespaced_role(ns),
        role_binding(ns),
        operator_deployment(ns, operator_image(values),
                            values.get("operator") or {}),
    ])
    # lifecycle hooks: only the idempotent pre-upgrade CRD-apply rides in
    # the install stream (operator.upgradeCRD slot). The pre-delete
    # cleanup Job is NEVER part of the install bundle — plain `kubectl
    # apply` ignores helm.sh/hook annotations and would run it at install
    # time, deleting the freshly created CRs and CRDs. It is emitted only
    # by the explicit `gpuop-cfg generate cleanup` target (see
    # render_cleanup).
    op = values.get("operator") or {}
    if op.get("upgradeCRD"):
        docs.extend(upgrade_crd_hook(ns, operator_image(values), op))
    pc = render_plugin_config_map(values)
    if pc is not None:
        docs.append(pc)
    cr = render_cluster_policy(values)
    if cr is not None:
        docs.append(cr)
    docs.extend(render_gpu_drivers(values))
    return docs


def render_cleanup(values: Dict[str, Any]) -> List[dict]:
    """The pre-delete cleanup hook (cleanup_crd.yaml slot), emitted as a
    standalone stream for the explicit uninstall step:

        gpuop-cfg generate cleanup | kubectl apply -f -
        kubectl wait --for=condition=complete job/gpu-operator-cleanup-crd
        gpuop-cfg generate all | kubectl delete -f -

    Deliberately excluded from render_bundle: applied plainly at install
    time it would delete the CRs/CRDs it finds (helm.sh/hook annotations
    are inert outside Helm). A Helm-wrapped chart can include this stream
    and get true pre-delete sequencing from the annotations."""
    ns = values.get("namespace", "gpu-operator")
    return cleanup_crd_hook(ns, operator_image(values),
                            values.get("operator") or {})


# the former render_bundle_metadata (a custom BundleMetadata blob) is
# replaced by deploy/csv.py's real ClusterServiceVersion bundle

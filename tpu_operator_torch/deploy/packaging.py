"""Deployment manifest generation — the Helm-chart slot.

The port's counterpart of ``tpu_operator/deploy/packaging.py``: the
operator's own objects are ``gpu-operator`` (its command the port's
``gpu-operator`` script, its hooks ``gpu-operator-maintenance``), its
image ``ghcr.io/gpu-operator/gpu-operator``.

The reference packages via a 546-line values.yaml Helm chart rendering the
ClusterPolicy CR plus operator Deployment/RBAC
(deployments/gpu-operator/). Here the same artifacts are generated from
code, so they cannot drift from the API types:

    gpuop-cfg generate crds     # both CRDs (from the dataclass schemas)
    gpuop-cfg generate operator # namespace + RBAC + Deployment + sample CR
    gpuop-cfg generate all
"""

from __future__ import annotations

from typing import List, Optional

from .. import __version__
from ..api.crd import all_crds


def namespace_manifest(namespace: str) -> dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": namespace}}


def service_account(namespace: str) -> dict:
    return {"apiVersion": "v1", "kind": "ServiceAccount",
            "metadata": {"name": "gpu-operator", "namespace": namespace}}


# the reference's chart splits RBAC into a ClusterRole for what is
# genuinely cluster-scoped and a namespaced Role for the write-heavy
# operand management (deployments/gpu-operator/templates/clusterrole.yaml
# + role.yaml); same shape here. The stale/uninstall sweeps scope their
# namespaced-kind passes to the operator namespace to match (skel.py
# _delete_stale, deploy/apply.py sweep_operands); the ClusterRole keeps
# cluster-wide READ on those kinds for observability and drift checks,
# WRITES on them are namespace-scoped.

_RW = ["get", "list", "watch", "create", "update", "patch", "delete"]
_RO = ["get", "list", "watch"]


def cluster_role() -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": {"name": "gpu-operator"},
        "rules": [
            {"apiGroups": ["gpu.graft.dev"],
             "resources": ["gpuclusterpolicies", "gpudrivers",
                           "gpuclusterpolicies/status", "gpudrivers/status"],
             "verbs": ["get", "list", "watch", "update", "patch"]},
            {"apiGroups": [""],
             "resources": ["nodes"],
             "verbs": ["get", "list", "watch", "patch"]},
            # drain evicts GPU workload pods from ANY namespace
            {"apiGroups": [""],
             "resources": ["pods", "pods/eviction"],
             "verbs": list(_RW)},
            # PSA enforcement labels on the operator namespace
            {"apiGroups": [""],
             "resources": ["namespaces"],
             "verbs": ["get", "list", "watch", "patch"]},
            # cluster-wide read for the stale/uninstall sweeps; writes on
            # these kinds live in the namespaced Role below
            {"apiGroups": [""],
             "resources": ["services", "serviceaccounts", "configmaps",
                           "endpoints"],
             "verbs": list(_RO)},
            {"apiGroups": ["apps"],
             "resources": ["daemonsets", "deployments",
                           "controllerrevisions"],
             "verbs": list(_RO)},
            {"apiGroups": ["rbac.authorization.k8s.io"],
             "resources": ["roles", "rolebindings"],
             "verbs": list(_RO)},
            {"apiGroups": ["monitoring.coreos.com"],
             "resources": ["servicemonitors", "prometheusrules"],
             "verbs": list(_RO)},
            # genuinely cluster-scoped operand kinds
            {"apiGroups": ["rbac.authorization.k8s.io"],
             "resources": ["clusterroles", "clusterrolebindings"],
             "verbs": list(_RW)},
            {"apiGroups": ["node.k8s.io"],
             "resources": ["runtimeclasses"],
             "verbs": list(_RW)},
        ],
    }


def namespaced_role(namespace: str) -> dict:
    """Write grants for operand management, confined to the operator
    namespace (templates/role.yaml analog: the operator renders every
    namespaced operand object into its own namespace)."""
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "Role",
        "metadata": {"name": "gpu-operator", "namespace": namespace},
        "rules": [
            {"apiGroups": [""],
             "resources": ["pods", "services", "serviceaccounts",
                           "configmaps", "endpoints", "events"],
             "verbs": list(_RW)},
            {"apiGroups": ["apps"],
             "resources": ["daemonsets", "deployments",
                           "controllerrevisions"],
             "verbs": list(_RW)},
            {"apiGroups": ["rbac.authorization.k8s.io"],
             "resources": ["roles", "rolebindings"],
             "verbs": list(_RW)},
            {"apiGroups": ["coordination.k8s.io"],
             "resources": ["leases"],
             "verbs": ["get", "list", "watch", "create", "update",
                       "patch"]},
            {"apiGroups": ["monitoring.coreos.com"],
             "resources": ["servicemonitors", "prometheusrules"],
             "verbs": list(_RW)},
        ],
    }


def role_binding(namespace: str) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {"name": "gpu-operator", "namespace": namespace},
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                    "kind": "Role", "name": "gpu-operator"},
        "subjects": [{"kind": "ServiceAccount", "name": "gpu-operator",
                      "namespace": namespace}],
    }


def cluster_role_binding(namespace: str) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {"name": "gpu-operator"},
        "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                    "kind": "ClusterRole", "name": "gpu-operator"},
        "subjects": [{"kind": "ServiceAccount", "name": "gpu-operator",
                      "namespace": namespace}],
    }


def operator_deployment(namespace: str, image: str,
                        op: Optional[dict] = None) -> dict:
    """The manager Deployment, shaped by the values `operator:` section
    (the chart-level operator config of the reference's values.yaml:
    scheduling, resources, leader election, health port)."""
    op = op or {}
    port = int(op["healthPort"] if op.get("healthPort") is not None else 8080)
    command = ["gpu-operator", "--health-port", str(port)]
    if op.get("leaderElect"):
        command.append("--leader-elect")
    container = {
        "name": "gpu-operator",
        "image": image,
        "imagePullPolicy": op.get("imagePullPolicy") or "IfNotPresent",
        "command": command,
        "env": [{"name": "OPERATOR_NAMESPACE",
                 "valueFrom": {"fieldRef": {
                     "fieldPath": "metadata.namespace"}}}]
        + list(op.get("env") or []),
        "ports": [{"name": "metrics", "containerPort": port}],
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": port},
            "initialDelaySeconds": 10,
            "periodSeconds": 20},
        "readinessProbe": {
            "httpGet": {"path": "/readyz", "port": port},
            "initialDelaySeconds": 5,
            "periodSeconds": 10},
    }
    if op.get("resources"):
        container["resources"] = op["resources"]
    pod_spec = _pod_spec_passthrough(op, {
        "serviceAccountName": "gpu-operator",
        "priorityClassName": op.get("priorityClassName")
        or "system-cluster-critical",
        "containers": [container],
    })
    # "app" is the selector identity — user labels must not break
    # spec.selector/template agreement (same protection operand renders
    # give their selector labels)
    labels = {**(op.get("labels") or {}), "app": "gpu-operator"}
    meta = {"name": "gpu-operator", "namespace": namespace,
            "labels": dict(labels)}
    # fresh dict: sharing one labels object across metadata and the pod
    # template makes yaml.safe_dump emit anchors/aliases, which strict
    # consumers and text-diff GitOps pipelines choke on
    pod_meta: dict = {"labels": dict(labels)}
    if op.get("annotations"):
        meta["annotations"] = dict(op["annotations"])
        pod_meta["annotations"] = dict(op["annotations"])
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta,
        "spec": {
            "replicas": int(op["replicas"]
                            if op.get("replicas") is not None else 1),
            "selector": {"matchLabels": {"app": "gpu-operator"}},
            "template": {"metadata": pod_meta, "spec": pod_spec},
        },
    }


def _hook_annotations(hook: str, weight: str) -> dict:
    """Helm hook metadata (upgrade_crd.yaml/cleanup_crd.yaml carry the
    same): meaningful when the stream is wrapped in a chart. Applied
    plainly, Jobs are immutable run-once objects — which is why the
    upgrade hook Job's NAME is versioned by image (a re-apply with a new
    version creates a fresh Job instead of failing on spec immutability)
    and finished Jobs self-clean via ttlSecondsAfterFinished."""
    return {"helm.sh/hook": hook,
            "helm.sh/hook-weight": weight,
            "helm.sh/hook-delete-policy":
                "hook-succeeded,before-hook-creation"}


def _pod_spec_passthrough(op: dict, pod_spec: dict) -> dict:
    """Shared operator-values -> pod-spec plumbing for the manager
    Deployment and the hook Jobs: one copy, so a new knob cannot reach
    operator pods but miss hook pods (whose unschedulability would hang
    a release operation)."""
    if op.get("imagePullSecrets"):
        pod_spec["imagePullSecrets"] = [
            {"name": s} if isinstance(s, str) else s
            for s in op["imagePullSecrets"]]
    for key in ("nodeSelector", "affinity", "tolerations",
                "priorityClassName"):
        if op.get(key):
            pod_spec[key] = op[key]
    return pod_spec


def _hook_rbac(name: str, namespace: str, hook: str, rules: list) -> list:
    meta = lambda: {"name": name,  # noqa: E731
                    "annotations": _hook_annotations(hook, "0")}
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount",
         "metadata": {**meta(), "namespace": namespace}},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
         "metadata": meta(), "rules": rules},
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "ClusterRoleBinding",
         "metadata": meta(),
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "ClusterRole", "name": name},
         "subjects": [{"kind": "ServiceAccount", "name": name,
                       "namespace": namespace}]},
    ]


def _hook_job(name: str, namespace: str, hook: str, image: str,
              command: list, op: dict,
              job_name: Optional[str] = None) -> dict:
    pod_spec = _pod_spec_passthrough(op, {
        "serviceAccountName": name,
        "restartPolicy": "OnFailure",
        "containers": [{
            "name": name,
            "image": image,
            "imagePullPolicy": op.get("imagePullPolicy") or "IfNotPresent",
            "command": command,
        }],
    })
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": job_name or name, "namespace": namespace,
                     "annotations": _hook_annotations(hook, "1")},
        "spec": {"backoffLimit": 6,
                 # plain-apply installs have no Helm hook-delete; finished
                 # hook Jobs clean themselves up
                 "ttlSecondsAfterFinished": 3600,
                 "template": {"metadata": {"labels": {"app": name}},
                              "spec": pod_spec}},
    }


def upgrade_crd_hook(namespace: str, image: str,
                     op: Optional[dict] = None) -> List[dict]:
    """Pre-upgrade CRD-apply Job (upgrade_crd.yaml slot): package
    managers don't upgrade CRDs, so schema changes in a new version must
    be applied by an explicit hook before the operator rolls."""
    op = op or {}
    name = "gpu-operator-upgrade-crd"
    docs = _hook_rbac(name, namespace, "pre-upgrade", [
        {"apiGroups": ["apiextensions.k8s.io"],
         "resources": ["customresourcedefinitions"],
         "verbs": ["create", "get", "list", "watch", "patch", "update"]},
    ])
    # Jobs are immutable and run-once: version the name by image so a
    # plain re-apply after a version bump creates a FRESH Job (and thus
    # actually re-applies the CRDs) instead of erroring on the completed
    # one; ttlSecondsAfterFinished reaps the old names
    import hashlib

    suffix = hashlib.sha256(image.encode()).hexdigest()[:8]
    docs.append(_hook_job(name, namespace, "pre-upgrade", image,
                          ["gpu-operator-maintenance", "apply-crds"], op,
                          job_name=f"{name}-{suffix}"))
    return docs


def cleanup_crd_hook(namespace: str, image: str,
                     op: Optional[dict] = None) -> List[dict]:
    """Pre-delete cleanup Job (cleanup_crd.yaml slot): delete the CRs
    while the operator still runs (operands tear down via owner GC),
    wait, then drop the CRDs."""
    op = op or {}
    name = "gpu-operator-cleanup-crd"
    docs = _hook_rbac(name, namespace, "pre-delete", [
        {"apiGroups": ["gpu.graft.dev"],
         "resources": ["gpuclusterpolicies", "gpudrivers"],
         "verbs": ["get", "list", "delete"]},
        {"apiGroups": ["apiextensions.k8s.io"],
         "resources": ["customresourcedefinitions"],
         "verbs": ["get", "list", "delete"]},
    ])
    docs.append(_hook_job(name, namespace, "pre-delete", image,
                          ["gpu-operator-maintenance", "cleanup"], op))
    return docs


def sample_cluster_policy() -> dict:
    from ..api.clusterpolicy import new_cluster_policy

    cr = new_cluster_policy()
    # the reference pins libtpu's "stable" channel; the port's driver
    # state has no channel, and an unset driverVersion accepts any
    cr["spec"] = {
        "driver": {"installDir": "/usr/local/nvidia/lib64"},
        "metricsExporter": {"serviceMonitor": False},
        "validator": {"matmulSize": 4096, "nvlinkBandwidthThreshold": 0.8},
        "upgradePolicy": {"autoUpgrade": False, "maxParallelUpgrades": 1},
    }
    return cr


def generate(what: str, namespace: str = "gpu-operator",
             image: str = "") -> List[dict]:
    image = image or f"ghcr.io/gpu-operator/gpu-operator:v{__version__}"
    crds = all_crds()
    operator = [
        namespace_manifest(namespace),
        service_account(namespace),
        cluster_role(),
        cluster_role_binding(namespace),
        namespaced_role(namespace),
        role_binding(namespace),
        operator_deployment(namespace, image),
        sample_cluster_policy(),
    ]
    if what == "crds":
        return crds
    if what == "operator":
        return operator
    if what == "all":
        return crds + operator
    raise ValueError(f"unknown target {what!r} (crds|operator|all)")

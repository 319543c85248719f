"""Helm chart generation + offline rendering.

The port's counterpart of ``tpu_operator/deploy/helmchart.py``: the
chart is ``deployments/gpu-operator/``, written by ``write_chart`` beside
the reference's ``deployments/tpu-operator/``, and rendered offline with
the port's ``render/engine.py``. PyYAML is imported where a function
reads or writes YAML.

The reference's primary install UX is its chart
(deployments/gpu-operator/values.yaml:1, templates/clusterpolicy.yaml:1,
hook Jobs templates/upgrade_crd.yaml:1). This module gives the GPU
operator the same surface WITHOUT forking the install logic:

- ``deployments/gpu-operator/`` is a real Helm v2 chart a helm shop can
  ``helm install``: ``crds/`` carries the CRDs (helm applies them before
  templates), ``values.yaml`` is byte-identical to the canonical
  ``deploy/values.yaml``, and ``templates/`` renders the same objects
  ``gpuop-cfg generate all`` emits.
- The RBAC/namespace templates are DERIVED from packaging.py at chart
  generation time (rendered with a sentinel namespace, then
  ``{{ .Release.Namespace }}`` substituted) — they cannot drift by
  construction. The parameterized templates (deployment, CRs, hooks)
  are authored here and pinned by tests/test_torch_helm_chart.py's
  matrix: chart-render == render_bundle for a spread of values files.
- ``render_chart()`` renders the chart with the in-repo go-template
  engine (render/engine.py — the same subset helm's text/template+sprig
  implements), so the equality is proven in CI without a helm binary,
  and users without helm can still preview the chart.

Split from the reference's layout: the pre-delete cleanup hook IS part
of the chart (helm gives it true pre-delete sequencing) but stays out of
the plain-apply bundle, where helm.sh/hook annotations are inert and the
Job would fire at install time (deploy/values.py render_cleanup).
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, List, Optional

from .. import __version__
from . import values as values_mod
from ..runtime.objects import yaml_module
from .packaging import (
    cluster_role,
    cluster_role_binding,
    namespaced_role,
    role_binding,
    service_account,
)

CHART_DIR = pathlib.Path(__file__).resolve().parents[2] / \
    "deployments" / "gpu-operator"

_NS_SENTINEL = "HELM-RELEASE-NAMESPACE-SENTINEL"
_NS_EXPR = "{{ .Release.Namespace }}"

# one image expression, used verbatim for image: fields and (hashed) for
# the versioned upgrade-hook Job name — keep in lockstep with
# values.operator_image(): repository/image joined with ':' for tags and
# '@' for digests, falling back to the packaged version
_REPO = '(.Values.operator.repository | default "ghcr.io/gpu-operator")'
_IMG = '(.Values.operator.image | default "gpu-operator")'
_VER = f'(.Values.operator.version | default "v{__version__}")'
_SEP = f'(ternary "@" ":" (hasPrefix "sha256:" {_VER}))'
IMAGE_EXPR = f'printf "%s/%s%s%s" {_REPO} {_IMG} {_SEP} {_VER}'

# nil-aware defaults for knobs whose python renderer uses `is not None`
# (a plain sprig `default` would swallow the legitimate value 0)
_REPLICAS_EXPR = ('ternary 1 .Values.operator.replicas '
                  '(eq .Values.operator.replicas nil) | int')
_PORT_EXPR = ('ternary 8080 .Values.operator.healthPort '
              '(eq .Values.operator.healthPort nil) | int')

# pod-spec passthrough shared by the operator Deployment and the hook
# Jobs (packaging._pod_spec_passthrough parity). Indent levels differ per
# consumer, so this is a format template over {ind}. imagePullSecrets
# entries may be bare Secret names or {{name: ...}} maps, exactly like
# the python renderer normalizes.
_POD_PASSTHROUGH = """\
{{{{- if .Values.operator.imagePullSecrets }}}}
{ind}imagePullSecrets:
{{{{- range .Values.operator.imagePullSecrets }}}}
{{{{- if (kindIs "string" .) }}}}
{ind}- name: {{{{ . }}}}
{{{{- else }}}}
{ind}-
{{{{ toYaml . | indent {m} }}}}
{{{{- end }}}}
{{{{- end }}}}
{{{{- end }}}}
{{{{- if .Values.operator.nodeSelector }}}}
{ind}nodeSelector:
{{{{ toYaml .Values.operator.nodeSelector | indent {n} }}}}
{{{{- end }}}}
{{{{- if .Values.operator.affinity }}}}
{ind}affinity:
{{{{ toYaml .Values.operator.affinity | indent {n} }}}}
{{{{- end }}}}
{{{{- if .Values.operator.tolerations }}}}
{ind}tolerations:
{{{{ toYaml .Values.operator.tolerations | indent {n} }}}}
{{{{- end }}}}"""


def _pod_passthrough(indent: int) -> str:
    return _POD_PASSTHROUGH.format(ind=" " * indent, n=indent + 2,
                                   m=indent + 4)


DEPLOYMENT_TEMPLATE = f"""\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: gpu-operator
  namespace: {_NS_EXPR}
  labels:
{{{{- if .Values.operator.labels }}}}
{{{{ toYaml .Values.operator.labels | indent 4 }}}}
{{{{- end }}}}
    app: gpu-operator
{{{{- if .Values.operator.annotations }}}}
  annotations:
{{{{ toYaml .Values.operator.annotations | indent 4 }}}}
{{{{- end }}}}
spec:
  replicas: {{{{ {_REPLICAS_EXPR} }}}}
  selector:
    matchLabels:
      app: gpu-operator
  template:
    metadata:
      labels:
{{{{- if .Values.operator.labels }}}}
{{{{ toYaml .Values.operator.labels | indent 8 }}}}
{{{{- end }}}}
        app: gpu-operator
{{{{- if .Values.operator.annotations }}}}
      annotations:
{{{{ toYaml .Values.operator.annotations | indent 8 }}}}
{{{{- end }}}}
    spec:
      serviceAccountName: gpu-operator
      priorityClassName: {{{{ .Values.operator.priorityClassName | default "system-cluster-critical" }}}}
{_pod_passthrough(6)}
      containers:
      - name: gpu-operator
        image: {{{{ {IMAGE_EXPR} }}}}
        imagePullPolicy: {{{{ .Values.operator.imagePullPolicy | default "IfNotPresent" }}}}
        command:
        - gpu-operator
        - --health-port
        - {{{{ {_PORT_EXPR} | quote }}}}
{{{{- if .Values.operator.leaderElect }}}}
        - --leader-elect
{{{{- end }}}}
        env:
        - name: OPERATOR_NAMESPACE
          valueFrom:
            fieldRef:
              fieldPath: metadata.namespace
{{{{- if .Values.operator.env }}}}
{{{{ toYaml .Values.operator.env | indent 8 }}}}
{{{{- end }}}}
        ports:
        - name: metrics
          containerPort: {{{{ {_PORT_EXPR} }}}}
        livenessProbe:
          httpGet:
            path: /healthz
            port: {{{{ {_PORT_EXPR} }}}}
          initialDelaySeconds: 10
          periodSeconds: 20
        readinessProbe:
          httpGet:
            path: /readyz
            port: {{{{ {_PORT_EXPR} }}}}
          initialDelaySeconds: 5
          periodSeconds: 10
{{{{- if .Values.operator.resources }}}}
        resources:
{{{{ toYaml .Values.operator.resources | indent 10 }}}}
{{{{- end }}}}
"""

# `clusterPolicy:` may be nulled wholesale in a values file (deep_merge
# scalar-replaces); the python renderer treats that as `{}` (enabled,
# all defaults) — the chart must match, hence the get-over-defaulted-map
# accesses instead of direct member paths
_CP = '(.Values.clusterPolicy | default (dict))'
CLUSTERPOLICY_TEMPLATE = f"""\
{{{{- if (ne (get {_CP} "enabled") false) }}}}
apiVersion: gpu.graft.dev/v1
kind: GPUClusterPolicy
metadata:
  name: {{{{ get {_CP} "name" | default "gpu-cluster-policy" }}}}
spec:
{{{{- if (get {_CP} "spec") }}}}
{{{{ toYaml (get {_CP} "spec") | indent 2 }}}}
{{{{- else }}}}
  {{}}
{{{{- end }}}}
{{{{- end }}}}
"""

GPUDRIVERS_TEMPLATE = """\
{{- range .Values.gpuDrivers }}
---
apiVersion: gpu.graft.dev/v1alpha1
kind: GPUDriver
metadata:
  name: {{ .name }}
spec:
{{- if (get . "spec") }}
{{ toYaml (get . "spec") | indent 2 }}
{{- else }}
  {}
{{- end }}
{{- end }}
"""

_PC = '(.Values.pluginConfig | default (dict))'
PLUGINCONFIG_TEMPLATE = f"""\
{{{{- if (get {_PC} "create") }}}}
{{{{- if (get {_PC} "data") }}}}
apiVersion: v1
kind: ConfigMap
metadata:
  name: {{{{ .Values.clusterPolicy.spec.devicePlugin.configMap }}}}
  namespace: {_NS_EXPR}
data:
{{{{ toYaml (get {_PC} "data") | indent 2 }}}}
{{{{- end }}}}
{{{{- end }}}}
"""


def _hook_templates() -> Dict[str, str]:
    """The pre-upgrade CRD-apply and pre-delete cleanup hooks
    (packaging.upgrade_crd_hook / cleanup_crd_hook parity)."""

    def rbac(name: str, hook: str, rules_yaml: str) -> str:
        ann = (f'    helm.sh/hook: {hook}\n'
               f'    helm.sh/hook-weight: "0"\n'
               f'    helm.sh/hook-delete-policy: '
               f'hook-succeeded,before-hook-creation')
        return f"""\
apiVersion: v1
kind: ServiceAccount
metadata:
  name: {name}
  namespace: {_NS_EXPR}
  annotations:
{ann}
---
apiVersion: rbac.authorization.k8s.io/v1
kind: ClusterRole
metadata:
  name: {name}
  annotations:
{ann}
rules:
{rules_yaml}
---
apiVersion: rbac.authorization.k8s.io/v1
kind: ClusterRoleBinding
metadata:
  name: {name}
  annotations:
{ann}
roleRef:
  apiGroup: rbac.authorization.k8s.io
  kind: ClusterRole
  name: {name}
subjects:
- kind: ServiceAccount
  name: {name}
  namespace: {_NS_EXPR}
"""

    def job(name: str, hook: str, command_yaml: str,
            job_name_expr: str) -> str:
        return f"""\
apiVersion: batch/v1
kind: Job
metadata:
  name: {job_name_expr}
  namespace: {_NS_EXPR}
  annotations:
    helm.sh/hook: {hook}
    helm.sh/hook-weight: "1"
    helm.sh/hook-delete-policy: hook-succeeded,before-hook-creation
spec:
  backoffLimit: 6
  ttlSecondsAfterFinished: 3600
  template:
    metadata:
      labels:
        app: {name}
    spec:
      serviceAccountName: {name}
      restartPolicy: OnFailure
{{{{- if .Values.operator.priorityClassName }}}}
      priorityClassName: {{{{ .Values.operator.priorityClassName }}}}
{{{{- end }}}}
{_pod_passthrough(6)}
      containers:
      - name: {name}
        image: {{{{ {IMAGE_EXPR} }}}}
        imagePullPolicy: {{{{ .Values.operator.imagePullPolicy | default "IfNotPresent" }}}}
        command:
{command_yaml}
"""

    upgrade = ("{{- if .Values.operator.upgradeCRD }}\n"
               + rbac("gpu-operator-upgrade-crd", "pre-upgrade", """\
- apiGroups: ["apiextensions.k8s.io"]
  resources: ["customresourcedefinitions"]
  verbs: ["create", "get", "list", "watch", "patch", "update"]""")
               + "---\n"
               + job("gpu-operator-upgrade-crd", "pre-upgrade", """\
        - gpu-operator-maintenance
        - apply-crds""",
                     "gpu-operator-upgrade-crd-"
                     f"{{{{ {IMAGE_EXPR} | sha256sum | trunc 8 }}}}")
               + "{{- end }}\n")
    cleanup = ("{{- if .Values.operator.cleanupCRD }}\n"
               + rbac("gpu-operator-cleanup-crd", "pre-delete", """\
- apiGroups: ["gpu.graft.dev"]
  resources: ["gpuclusterpolicies", "gpudrivers"]
  verbs: ["get", "list", "delete"]
- apiGroups: ["apiextensions.k8s.io"]
  resources: ["customresourcedefinitions"]
  verbs: ["get", "list", "delete"]""")
               + "---\n"
               + job("gpu-operator-cleanup-crd", "pre-delete", """\
        - gpu-operator-maintenance
        - cleanup""",
                     "gpu-operator-cleanup-crd")
               + "{{- end }}\n")
    return {"templates/hooks-upgrade-crd.yaml": upgrade,
            "templates/hooks-cleanup-crd.yaml": cleanup}


def _derived_template(obj: dict) -> str:
    """A template mechanically derived from a packaging.py object: render
    with the sentinel namespace, substitute the Release expression."""
    yaml = yaml_module()

    text = yaml.safe_dump(obj, default_flow_style=False, sort_keys=False)
    return text.replace(_NS_SENTINEL, _NS_EXPR)


def generate_chart() -> Dict[str, str]:
    """relpath -> content for the whole chart."""
    yaml = yaml_module()

    from ..api.crd import all_crds

    ns = _NS_SENTINEL
    files: Dict[str, str] = {
        "Chart.yaml": yaml.safe_dump({
            "apiVersion": "v2",
            "name": "gpu-operator",
            "description": "GPU operator: installs and lifecycle-manages "
                           "the GPU software stack on GKE GPU nodes",
            "type": "application",
            "version": __version__,
            "appVersion": f"v{__version__}",
            "kubeVersion": ">=1.24.0-0",
        }, sort_keys=False),
        # the chart values ARE the canonical values — one file, two
        # consumers (helm and gpuop-cfg), zero drift.
        # NO templates/namespace.yaml: helm owns the release namespace
        # (`--create-namespace`); a templated Namespace object would fail
        # helm 3's release-ownership check on install. The plain-apply
        # bundle (`generate all`) still carries the Namespace.
        "values.yaml": values_mod.VALUES_FILE.read_text(),
        "templates/serviceaccount.yaml": _derived_template(
            service_account(ns)),
        "templates/clusterrole.yaml": _derived_template(cluster_role()),
        "templates/clusterrolebinding.yaml": _derived_template(
            cluster_role_binding(ns)),
        "templates/role.yaml": _derived_template(namespaced_role(ns)),
        "templates/rolebinding.yaml": _derived_template(role_binding(ns)),
        "templates/deployment.yaml": DEPLOYMENT_TEMPLATE,
        "templates/clusterpolicy.yaml": CLUSTERPOLICY_TEMPLATE,
        "templates/gpudrivers.yaml": GPUDRIVERS_TEMPLATE,
        "templates/pluginconfig.yaml": PLUGINCONFIG_TEMPLATE,
        **_hook_templates(),
        ".helmignore": "*.tgz\n",
    }
    for i, crd in enumerate(all_crds()):
        files[f"crds/{crd['metadata']['name'].split('.')[0]}.yaml"] = \
            yaml.safe_dump(crd, default_flow_style=False, sort_keys=False)
    return files


def write_chart(directory: Optional[pathlib.Path] = None) -> pathlib.Path:
    directory = pathlib.Path(directory or CHART_DIR)
    files = generate_chart()
    # the directory is chart-owned: files the generator no longer emits
    # (renamed/removed templates) must not survive as stale manifests a
    # helm install would still apply
    if directory.exists():
        for p in directory.rglob("*"):
            if p.is_file() and \
                    p.relative_to(directory).as_posix() not in files:
                p.unlink()
    for rel, content in files.items():
        path = directory / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content)
    return directory


def render_chart(values: Optional[Dict[str, Any]] = None,
                 chart_files: Optional[Dict[str, str]] = None,
                 include_crds: bool = True) -> List[dict]:
    """Render the chart the way ``helm template`` would: user values
    deep-merged over the chart's values.yaml, ``.Release.Namespace``
    bound (here from values.namespace — the offline stand-in for
    ``helm -n``), every templates/*.yaml rendered and the object stream
    parsed. The tests pin this equal to render_bundle()."""
    yaml = yaml_module()

    from ..render.engine import render_string

    files = chart_files or generate_chart()
    defaults = yaml.safe_load(files["values.yaml"]) or {}
    merged = values_mod.deep_merge(defaults, values or {})
    data = {
        "Values": merged,
        "Release": {"Namespace": merged.get("namespace", "gpu-operator"),
                    "Name": "gpu-operator"},
        "Chart": yaml.safe_load(files["Chart.yaml"]),
    }
    docs: List[dict] = []
    if include_crds:
        for rel in sorted(files):
            if rel.startswith("crds/"):
                docs.extend(d for d in yaml.safe_load_all(files[rel]) if d)
    for rel in sorted(files):
        if not rel.startswith("templates/"):
            continue
        rendered = render_string(files[rel], data, name=rel)
        docs.extend(d for d in yaml.safe_load_all(rendered) if d)
    return docs

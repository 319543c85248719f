"""The GPU operand states and their render data.

The port's counterpart of ``tpu_operator/state/operands.py``: the same 15
states, in the same order and with the same ``requires`` edges, under the
naming rule of ROADMAP.md §C (``libtpu-driver`` -> ``gpu-driver``,
``tpu-*`` -> ``gpu-*``, ``vtpu-device-manager`` -> ``vgpu-device-manager``):

| order | state                  | NVIDIA operator slot              |
|-------|------------------------|-----------------------------------|
| 1     | pre-requisites         | pre-requisites (RuntimeClasses)   |
| 2     | operator-metrics       | state-operator-metrics            |
| 3     | gpu-driver             | state-driver                      |
| 4     | gpu-runtime            | state-container-toolkit           |
| 5     | operator-validation    | state-operator-validation         |
| 6     | gpu-device-plugin      | state-device-plugin               |
| 7     | gpu-health             | state-dcgm (standalone engine)    |
| 8     | metrics-exporter       | state-dcgm-exporter               |
| 9     | feature-discovery      | gpu-feature-discovery             |
| 10    | node-status-exporter   | state-node-status-exporter        |
| 11    | topology-manager       | state-mig-manager                 |
| 12    | chip-fencing           | state-vfio-manager                |
| 13    | vgpu-device-manager    | state-vgpu-device-manager         |
| 14    | isolated-validation    | state-sandbox-validation          |
| 15    | isolated-device-plugin | state-sandbox-device-plugin       |

States 12-15 form the isolated-workload plane, deployed only when
``sandboxWorkloads.enabled`` and routed to nodes whose workload config is
``isolated`` (whole fenced cards) or ``virtual`` (fractional vGPUs).

Each state renders ``manifests/state-<name>/*.yaml`` of this package with
data built here, applies via the skel, and reports readiness. Every
``command:`` in those manifests names one of the port's agents
(``[project.scripts]`` in pyproject.toml). Per-node deploy labels
(gpu.graft.dev/deploy.<state>) select which nodes run which operand — the
node-labelling side lives in controllers/state_manager.py.
"""

from __future__ import annotations

import collections
import functools
import os
import pathlib
import re
import threading
from typing import Callable, List, Optional

from .. import __version__
from ..api.clusterpolicy import ComponentSpec
from ..api.image import image_path
from ..api.labels import deploy_label
from ..metrics.operator_metrics import OPERATOR_METRICS
from ..render import Renderer
from ..runtime.objects import deepcopy_obj
from ..utils.hash import object_hash
from .skel import apply_objects, delete_state_objects, objects_ready
from .state import State, SyncContext, SyncResult, SyncStatus

# the package's own manifests, overridable for deployments that bake them
# elsewhere
MANIFESTS_ROOT = pathlib.Path(
    os.environ.get("GPU_OPERATOR_MANIFESTS", "")
    or pathlib.Path(__file__).resolve().parents[1] / "manifests")

DEFAULT_REPOSITORY = "ghcr.io/gpu-operator"
DEFAULT_VERSION = f"v{__version__}"

# GPU nodes carry this taint; every operand must tolerate it.
DEFAULT_TOLERATIONS = [
    {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"},
    {"key": "node-role.kubernetes.io/master", "operator": "Exists",
     "effect": "NoSchedule"},
]


def resolve_image(component: str, comp: Optional[ComponentSpec],
                  default_image: str) -> str:
    """spec fields -> $<COMPONENT>_IMAGE env -> built-in default."""
    try:
        return image_path(component,
                          comp.repository if comp else None,
                          comp.image if comp else None,
                          comp.version if comp else None)
    except ValueError:
        return f"{DEFAULT_REPOSITORY}/{default_image}:{DEFAULT_VERSION}"


def _split_ref(ref: str):
    """'repo/prefix/name:tag' -> (repo/prefix, name, tag); handles
    @sha256 digests, registry ports, and bare 'name:tag' refs."""
    if "@" in ref:
        base, version = ref.rsplit("@", 1)
    elif ":" in ref.rsplit("/", 1)[-1]:
        base, version = ref.rsplit(":", 1)
    else:
        base, version = ref, None
    if "/" in base:
        repo, image = base.rsplit("/", 1)
    else:
        repo, image = None, base
    return repo, image, version


def _override_image(sub: ComponentSpec, base_ref: str) -> str:
    """Per-field image coordinates: the sub-spec's fields win, absent
    fields inherit from the RESOLVED base reference (spec fields or the
    env fallback — whatever resolve_image produced), so a partial
    override (just `version:`) never silently flips registries (the
    reference resolves per-field the same way, internal/image/image.go:25)."""
    # a fully-qualified image: passes through verbatim, like image_path's
    # first branch does for every other image field
    if sub.image and "/" in sub.image and (
            ":" in sub.image.split("/")[-1] or "@" in sub.image):
        return sub.image
    repo, image, version = _split_ref(base_ref)
    repo = sub.repository or repo or DEFAULT_REPOSITORY
    image = sub.image or image
    version = sub.version or version or DEFAULT_VERSION
    sep = "@" if version.startswith("sha256:") else ":"
    return f"{repo}/{image}{sep}{version}"


def operator_init_image(ctx: SyncContext, operand_image: str) -> Optional[str]:
    """Image of operator.initContainer when explicitly configured — it
    overrides the image of utility preflight initContainers (the
    reference's operator.initContainer cuda-base slot); None = use the
    operand's own image. A partial override inherits the missing
    coordinates from the operand's RESOLVED image, so a bare `version:`
    keeps a private registry whether it came from spec fields or the
    *_IMAGE env fallback."""
    init_ctr = ctx.spec.operator.init_container
    if init_ctr is not None and any((init_ctr.repository, init_ctr.image,
                                     init_ctr.version)):
        return _override_image(init_ctr, operand_image)
    return None


def common_data(ctx: SyncContext, comp: Optional[ComponentSpec],
                state: str, default_image: str) -> dict:
    ds = ctx.spec.daemonsets
    hp = ctx.spec.host_paths
    validator = ctx.spec.validator
    op = ctx.spec.operator
    operand_image = resolve_image(state, comp, default_image)
    init_image = operator_init_image(ctx, operand_image)
    return {
        "Namespace": ctx.namespace,
        "StateName": state,
        "DeployLabel": deploy_label(state),
        "Image": operand_image,
        "InitContainerImage": init_image or operand_image,
        "ImagePullPolicy": (comp.image_pull_policy if comp else None)
        or "IfNotPresent",
        # every operand pod also pulls ValidatorImage for its barrier
        # initContainer, so the validator's pull secrets must ride along
        # (imagePullSecrets are pod-scoped)
        "ImagePullSecrets": _dedup(
            ((comp.image_pull_secrets if comp else None) or [])
            + (validator.image_pull_secrets or [])),
        "PriorityClassName": (comp.priority_class_name if comp else None)
        or ds.priority_class_name or "system-node-critical",
        "Tolerations": (ds.tolerations or [])
        + ((comp.tolerations if comp else None) or [])
        + DEFAULT_TOLERATIONS,
        "UpdateStrategy": ds.update_strategy or "RollingUpdate",
        "MaxUnavailable": ds.rolling_update_max_unavailable or "1",
        # precedence: operator-wide < daemonsets defaults < per-operand
        "CommonLabels": {**(op.labels or {}), **(ds.labels or {}),
                         **((comp.labels if comp else None) or {})},
        "CommonAnnotations": {**(op.annotations or {}),
                              **(ds.annotations or {}),
                              **((comp.annotations if comp else None) or {})},
        "NodeSelector": (comp.node_selector if comp else None) or {},
        "Affinity": comp.affinity if comp else None,
        "Env": (comp.env if comp else None) or [],
        "Args": (comp.args if comp else None) or [],
        "Resources": comp.resources if comp else None,
        "RuntimeClass": ctx.spec.operator.runtime_class or "nvidia",
        # clusterinfo facts for template decisions (the reference's
        # clusterinfo-picks-manifests role, clusterinfo.go:42-55): e.g.
        # the runtime state records the control-plane-detected container
        # runtime so the node-side proof can compare belief vs reality
        "Cluster": {"containerRuntime": "containerd",
                    **(ctx.cluster or {})},
        "ValidatorImage": resolve_image("operator-validation",
                                        validator, "gpu-validator"),
        "HostPaths": {
            "RootFS": hp.root_fs or "/",
            "ValidationDir": hp.validation_dir or "/run/nvidia/validations",
            "DevDir": hp.dev_dir or "/dev",
        },
    }


def _dedup(items: List[str]) -> List[str]:
    return list(dict.fromkeys(items))


def _merge_keep_existing(target: Optional[dict], extra: dict) -> dict:
    """Merge ``extra`` under ``target``: keys the template already set win
    (the app selector label and deploy-label nodeSelector must never be
    clobbered by user config)."""
    return {**extra, **(target or {})}


def apply_common_config(objects: List[dict], data: dict) -> List[dict]:
    """Post-render application of the config surface every operand shares.

    The reference does this programmatically per DaemonSet
    (applyCommonDaemonsetConfig + applyCommonDaemonsetMetadata,
    object_controls.go:689-741) so no template can silently drop a knob;
    same here: labels/annotations go on every rendered object and its pod
    template, scheduling + image-pull + resource knobs go on DaemonSet pod
    specs. Identity keys the template set (selector labels, the
    deploy-label nodeSelector) win on conflict; env and args are
    deliberately user-wins (setContainerEnv override semantics,
    object_controls.go:2351) — overriding a template-set env var is the
    point of the knob.
    """
    labels = data.get("CommonLabels") or {}
    annotations = data.get("CommonAnnotations") or {}
    for obj in objects:
        meta = obj.setdefault("metadata", {})
        if labels:
            meta["labels"] = _merge_keep_existing(meta.get("labels"), labels)
        if annotations:
            meta["annotations"] = _merge_keep_existing(
                meta.get("annotations"), annotations)
        if obj.get("kind") != "DaemonSet":
            continue
        tmpl = obj.setdefault("spec", {}).setdefault("template", {})
        tmeta = tmpl.setdefault("metadata", {})
        if labels:
            tmeta["labels"] = _merge_keep_existing(tmeta.get("labels"), labels)
        if annotations:
            tmeta["annotations"] = _merge_keep_existing(
                tmeta.get("annotations"), annotations)
        pod = tmpl.setdefault("spec", {})
        if data.get("NodeSelector"):
            pod["nodeSelector"] = _merge_keep_existing(
                pod.get("nodeSelector"), data["NodeSelector"])
        if data.get("Affinity") and "affinity" not in pod:
            pod["affinity"] = data["Affinity"]
        if data.get("ImagePullSecrets"):
            pod["imagePullSecrets"] = (pod.get("imagePullSecrets") or []) + [
                {"name": s} for s in data["ImagePullSecrets"]]
        # env/resources apply on every operand (non-init) container; args
        # replace only the first (primary) container's. The validation
        # initContainers' barrier args are part of the protocol, not user
        # surface.
        for i, ctr in enumerate(pod.get("containers") or []):
            if data.get("Resources") is not None:
                ctr["resources"] = data["Resources"]
            for var in data.get("Env") or []:
                _set_container_env(ctr, var)
            if i == 0 and data.get("Args"):
                ctr["args"] = list(data["Args"])
        # per-proof overrides target validation initContainers by name
        # (transformValidatorComponent slot, object_controls.go:2129)
        overrides = data.get("ProofOverrides") or {}
        for ctr in pod.get("initContainers") or []:
            sub = overrides.get(ctr.get("name"))
            if not sub:
                continue
            for key in ("image", "imagePullPolicy", "resources"):
                if key in sub:
                    ctr[key] = sub[key]
            for var in sub.get("env") or []:
                _set_container_env(ctr, var)
    return objects


def _set_container_env(ctr: dict, var: dict) -> None:
    """Replace-or-append an EnvVar by name (setContainerEnv semantics,
    object_controls.go:2351 analog); supports full EnvVar shapes
    (valueFrom etc.), which the old per-template range could not."""
    env = ctr.setdefault("env", [])
    for i, existing in enumerate(env):
        if existing.get("name") == var.get("name"):
            env[i] = var
            return
    env.append(var)


@functools.lru_cache(maxsize=None)
def template_kinds(state_dir: str) -> frozenset:
    """(apiVersion, kind) pairs a state dir's templates can emit —
    including conditionally-rendered docs, since the scan is textual
    (the resource_manager.go:89 regex-the-kind-out-of-assets move).
    Bounds the stale sweep to kinds this state could ever have created."""
    kinds = set()
    for path in sorted(pathlib.Path(state_dir).glob("*.yaml")):
        for doc in re.split(r"(?m)^---\s*$", path.read_text()):
            av = re.search(r"(?m)^apiVersion:\s*([^\s{]+)", doc)
            kd = re.search(r"(?m)^kind:\s*([^\s{]+)", doc)
            if av and kd:
                kinds.add((av.group(1), kd.group(1)))
    return frozenset(kinds)


# render memoization: a steady reconcile rebuilds identical render data
# for every state every pass — re-running the template engine and YAML
# parse on identical inputs is the second-largest steady-state cost
# after apiserver traffic. Keyed on (state, manifest dir, template
# fingerprint, data hash) so both a spec change AND a template edit on
# disk miss. Entries store a private deepcopy and hits return one:
# apply_objects and apply_common_config mutate rendered objects in
# place, so handing out the cached instance would poison the cache.
_RENDER_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_RENDER_CACHE_MAX = 256
_render_cache_lock = threading.Lock()


def _render_memoized(state_name: str, renderer: Renderer,
                     data: dict) -> List[dict]:
    try:
        key = (state_name, str(renderer.dir), renderer.fingerprint,
               object_hash(data))
    except TypeError:
        # non-JSON-able render data (never true of the built-in states,
        # but data_fn is user surface) — render uncached
        key = None
    if key is not None:
        with _render_cache_lock:
            cached = _RENDER_CACHE.get(key)
            if cached is not None:
                _RENDER_CACHE.move_to_end(key)
        if cached is not None:
            OPERATOR_METRICS.render_cache_hits.inc()
            return deepcopy_obj(cached)
    OPERATOR_METRICS.render_cache_misses.inc()
    objects = apply_common_config(renderer.render_objects(data), data)
    if key is not None:
        with _render_cache_lock:
            _RENDER_CACHE[key] = deepcopy_obj(objects)
            while len(_RENDER_CACHE) > _RENDER_CACHE_MAX:
                _RENDER_CACHE.popitem(last=False)
    return objects


class OperandState(State):
    """A state fully described by (manifest dir, data builder, enable flag)."""

    def __init__(self, name: str, description: str,
                 data_fn: Callable[[SyncContext], dict],
                 enabled_fn: Optional[Callable[[SyncContext], bool]] = None,
                 manifests_root: Optional[pathlib.Path] = None,
                 requires: Optional[List[str]] = None,
                 watches: Optional[List[tuple]] = None):
        self.name = name
        self.description = description
        self._data_fn = data_fn
        self._enabled_fn = enabled_fn
        self._root = manifests_root or MANIFESTS_ROOT
        # DAG edges (None = chain to list-order predecessor) and extra
        # watch sources beyond the DaemonSet default
        self._requires = requires
        self._watches = watches

    def enabled(self, ctx: SyncContext) -> bool:
        return self._enabled_fn(ctx) if self._enabled_fn else True

    def requires(self) -> Optional[List[str]]:
        return None if self._requires is None else list(self._requires)

    def watch_sources(self) -> List[tuple]:
        out = super().watch_sources()
        for src in self._watches or ():
            if src not in out:
                out.append(src)
        return out

    def renderer(self) -> Renderer:
        return Renderer(self._root / f"state-{self.name}")

    def render(self, ctx: SyncContext) -> List[dict]:
        """Render the state's manifests with the shared config surface
        applied — the one render path sync, goldens and the everything-
        overridden test all go through. Memoized on (state, templates,
        data): identical inputs skip the template engine and YAML parse
        entirely."""
        data = self._data_fn(ctx)
        return _render_memoized(self.name, self.renderer(), data)

    def sweep_kinds(self) -> frozenset:
        return template_kinds(str(self._root / f"state-{self.name}"))

    def sync(self, ctx: SyncContext) -> SyncResult:
        if not self.enabled(ctx):
            delete_state_objects(ctx.client, self.name, ctx.namespace)
            return SyncResult(SyncStatus.DISABLED, "disabled by spec")
        objects = self.render(ctx)
        applied = apply_objects(ctx.client, ctx.policy, self.name, objects,
                                ctx.namespace,
                                sweep_kinds=self.sweep_kinds())
        ok, msg = objects_ready(ctx.client, applied)
        return SyncResult(SyncStatus.READY if ok else SyncStatus.NOT_READY, msg)


# ---------------------------------------------------------------------------
# Per-state render data
# ---------------------------------------------------------------------------


def _prerequisites_data(ctx: SyncContext) -> dict:
    return common_data(ctx, None, "pre-requisites", "gpu-operator")


def _operator_metrics_data(ctx: SyncContext) -> dict:
    data = common_data(ctx, None, "operator-metrics", "gpu-operator")
    data["MetricsPort"] = 8080
    data["ServiceMonitor"] = bool(ctx.spec.operator.service_monitor)
    data["Interval"] = ctx.spec.operator.service_monitor_interval_seconds or 30
    return data


def _gpu_driver_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.driver
    data = common_data(ctx, spec, "gpu-driver", "gpu-driver-installer")
    # driver replacement must never roll automatically across all nodes:
    # OnDelete + the upgrade controller owns the rollout
    # (SURVEY.md section 7 hard parts; object_controls.go:3545 analog)
    data["UpdateStrategy"] = "OnDelete"
    data["InstallDir"] = spec.install_dir or "/usr/local/nvidia/lib64"
    data["DriverVersion"] = spec.driver_version or ""
    # a driver CRD's controller re-renders this template per node pool
    # with its own Name/NodeSelector (internal/state/driver.go:211 analog)
    data["Name"] = "gpu-driver-daemonset"
    data["NodeSelector"] = {**data["NodeSelector"],
                            data["DeployLabel"]: "true"}
    return data


def _gpu_runtime_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.gpu_runtime
    data = common_data(ctx, spec, "gpu-runtime", "gpu-runtime")
    data["DevicePathGlob"] = spec.device_path_glob or "/dev/nvidia*"
    return data


def _validation_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.validator
    data = common_data(ctx, spec, "operator-validation", "gpu-validator")
    data["MatmulSize"] = spec.matmul_size or 4096
    data["NvlinkThreshold"] = spec.nvlink_bandwidth_threshold or 0.8
    # aux proofs honor their per-proof enabled knob; runtime-validation
    # additionally follows the gpu-runtime operand. The CORE proofs
    # (driver/cuda/nvlink, and plugin under devicePlugin) cannot be disabled
    # here — validate_cr rejects that, because their barrier files gate
    # every operand and a missing proof would wedge the node.
    data["RuntimeEnabled"] = ctx.spec.gpu_runtime.is_enabled() and (
        spec.runtime.is_enabled() if spec.runtime else True)
    data["PluginEnabled"] = ctx.spec.device_plugin.is_enabled()
    data["HbmEnabled"] = spec.hbm.is_enabled() if spec.hbm else True
    data["DcnEnabled"] = spec.dcn.is_enabled() if spec.dcn else True
    # per-proof ComponentSpec overrides (validator.plugin.env slot of the
    # reference: transformValidatorComponent, object_controls.go:2129) —
    # applied to the matching validation initContainer post-render
    data["ProofOverrides"] = _proof_overrides(data["Image"], {
        "driver-validation": spec.driver,
        "runtime-validation": spec.runtime,
        "plugin-validation": spec.plugin,
        "cuda-validation": spec.cuda,
        "nvlink-validation": spec.nvlink,
        "hbm-validation": spec.hbm,
        "dcn-validation": spec.dcn,
    })
    return data


def _proof_overrides(validator_image: str, mapping: dict) -> dict:
    """Resolve per-proof ComponentSpec overrides into concrete container
    patches. Image coordinates merge per-field against the validator's
    RESOLVED image (a bare `version:` override keeps the custom
    registry, whether it came from spec fields or the env fallback)."""
    out = {}
    for name, sub in mapping.items():
        if sub is None:
            continue
        patch: dict = {}
        if any((sub.repository, sub.image, sub.version)):
            patch["image"] = _override_image(sub, validator_image)
        if sub.image_pull_policy:
            patch["imagePullPolicy"] = sub.image_pull_policy
        if sub.resources is not None:
            patch["resources"] = sub.resources
        if sub.env:
            patch["env"] = sub.env
        if patch:
            out[name] = patch
    return out


def _device_plugin_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.device_plugin
    data = common_data(ctx, spec, "gpu-device-plugin", "gpu-device-plugin")
    data["ResourceName"] = spec.resource_name or "nvidia.com/gpu"
    data["SharingPolicy"] = spec.sharing_policy or "exclusive"
    # replication only takes effect under time-shared; exclusive pins 1
    data["SharingReplicas"] = (spec.sharing_replicas or 1) \
        if data["SharingPolicy"] == "time-shared" else 1
    # per-node config ConfigMap (handleDevicePluginConfig slot,
    # object_controls.go:2442): mounted read-only; the plugin process
    # itself selects + live-reloads, so no config-manager sidecar exists
    data["PluginConfigMap"] = spec.config_map or ""
    data["PluginConfigDefault"] = spec.default_config or ""
    return data


def _gpu_health_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.gpu_health
    data = common_data(ctx, spec, "gpu-health", "gpu-health-engine")
    data["Port"] = spec.port or 9402
    data["Interval"] = spec.collection_interval_seconds or 15
    return data


def _metrics_exporter_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.metrics_exporter
    data = common_data(ctx, spec, "metrics-exporter", "gpu-metrics-exporter")
    data["Port"] = spec.port or 9400
    data["Interval"] = spec.collection_interval_seconds or 15
    data["ServiceMonitor"] = bool(spec.service_monitor)
    # standalone health engine enabled -> exporter presents its samples
    # (DCGM_REMOTE_HOSTENGINE_INFO split, object_controls.go:113-116)
    health = ctx.spec.gpu_health
    data["HealthEngineInfo"] = (
        f"$(NODE_IP):{health.port or 9402}" if health.is_enabled() else "")
    return data


def _feature_discovery_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.feature_discovery
    data = common_data(ctx, spec, "feature-discovery", "gpu-feature-discovery")
    data["Interval"] = spec.interval_seconds or 60
    return data


def _node_status_exporter_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.node_status_exporter
    data = common_data(ctx, spec, "node-status-exporter", "gpu-validator")
    data["Port"] = spec.port or 9401
    return data


def _topology_manager_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.topology_manager
    data = common_data(ctx, spec, "topology-manager", "gpu-topology-manager")
    data["ConfigMapName"] = spec.config_map or "default-slice-config"
    data["DefaultProfile"] = spec.default_profile or "full"
    return data


def _sandbox_enabled(ctx: SyncContext) -> bool:
    return ctx.spec.sandbox_workloads.is_enabled()


def _chip_fencing_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.chip_fencing
    data = common_data(ctx, spec, "chip-fencing", "gpu-chip-fencing")
    data["FencingConfig"] = spec.config or "all"
    # agents on unlabeled nodes must resolve the same workload config the
    # operator routed them by (the label is never stamped)
    data["DefaultWorkload"] = \
        ctx.spec.sandbox_workloads.default_workload or "container"
    return data


def _vgpu_device_manager_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.vgpu_device_manager
    data = common_data(ctx, spec, "vgpu-device-manager",
                       "gpu-vgpu-device-manager")
    data["ConfigMapName"] = spec.config_map or "default-vgpu-config"
    data["DefaultProfile"] = spec.default_profile or "vgpu-2"
    return data


def _isolated_validation_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.validator
    data = common_data(ctx, spec, "isolated-validation", "gpu-validator")
    # vgpu proof only gates nodes that actually carve vGPUs (the virtual
    # workload config); the manifest keys the initContainer off this flag
    data["VGPUEnabled"] = ctx.spec.vgpu_device_manager.is_enabled()
    data["DefaultWorkload"] = \
        ctx.spec.sandbox_workloads.default_workload or "container"
    # the driver proof runs on isolated nodes too — its override must
    # apply to both validation states, not just the container plane
    data["ProofOverrides"] = _proof_overrides(data["Image"], {
        "driver-validation": spec.driver,
    })
    return data


def _isolated_device_plugin_data(ctx: SyncContext) -> dict:
    spec = ctx.spec.isolated_device_plugin
    data = common_data(ctx, spec, "isolated-device-plugin",
                       "gpu-device-plugin")
    data["ResourceName"] = spec.resource_name or "nvidia.com/gpu-isolated"
    data["VGPUResourceName"] = spec.vgpu_resource_name or "nvidia.com/vgpu"
    return data


def build_states(manifests_root: Optional[pathlib.Path] = None) -> List[State]:
    """Ordered state list (addState registrations,
    state_manager.go:791-810 analog).

    ``requires`` declares the real dependency edges the serial order was
    a linearization of: only chains the validation barrier actually
    enforces on-node (driver before validation before plugin, fencing
    before vGPU carving) are edges; everything else may sync in the same
    wave. The declaration ORDER is still the canonical serial sequence —
    the OPERATOR_DAG=0 kill switch walks it verbatim."""
    mk = lambda *a, **kw: OperandState(*a, manifests_root=manifests_root, **kw)
    return [
        mk("pre-requisites", "RuntimeClass registration",
           _prerequisites_data, requires=[]),
        mk("operator-metrics", "operator metrics Service",
           _operator_metrics_data, requires=[],
           watches=[("v1", "Service")]),
        mk("gpu-driver", "user-space driver check on GPU nodes",
           _gpu_driver_data,
           enabled_fn=lambda ctx: ctx.spec.driver.is_enabled()
           and not ctx.extra.get("gpudriver_crd_mode", False),
           requires=["pre-requisites"]),
        mk("gpu-runtime", "GPU device/runtime hookup",
           _gpu_runtime_data,
           enabled_fn=lambda ctx: ctx.spec.gpu_runtime.is_enabled(),
           requires=["pre-requisites"]),
        mk("operator-validation", "per-node validation gate",
           _validation_data,
           enabled_fn=lambda ctx: ctx.spec.validator.is_enabled(),
           requires=["gpu-driver", "gpu-runtime"],
           watches=[("v1", "Pod")]),
        mk("gpu-device-plugin", "nvidia.com/gpu device plugin",
           _device_plugin_data,
           enabled_fn=lambda ctx: ctx.spec.device_plugin.is_enabled(),
           requires=["operator-validation"]),
        mk("gpu-health", "standalone telemetry/health engine",
           _gpu_health_data,
           enabled_fn=lambda ctx: ctx.spec.gpu_health.is_enabled(),
           requires=["gpu-driver"]),
        mk("metrics-exporter", "NVML metrics exporter",
           _metrics_exporter_data,
           enabled_fn=lambda ctx: ctx.spec.metrics_exporter.is_enabled(),
           requires=["gpu-driver"]),
        mk("feature-discovery", "GPU property labels",
           _feature_discovery_data,
           enabled_fn=lambda ctx: ctx.spec.feature_discovery.is_enabled(),
           requires=[]),
        mk("node-status-exporter", "validation status metrics",
           _node_status_exporter_data,
           enabled_fn=lambda ctx: ctx.spec.node_status_exporter.is_enabled(),
           requires=["operator-validation"]),
        mk("topology-manager", "GPU card grouping",
           _topology_manager_data,
           enabled_fn=lambda ctx: ctx.spec.topology_manager.is_enabled(),
           requires=["pre-requisites"]),
        # --- isolated-workload plane (sandbox stack analog): deployed only
        # when sandboxWorkloads.enabled, routed to isolated/virtual nodes
        # by the workload-config deploy labels -------------------------------
        mk("chip-fencing", "fence cards out of the shared pool",
           _chip_fencing_data,
           enabled_fn=lambda ctx: _sandbox_enabled(ctx)
           and ctx.spec.chip_fencing.is_enabled(),
           requires=["pre-requisites"]),
        mk("vgpu-device-manager", "fractional vGPU device inventory",
           _vgpu_device_manager_data,
           enabled_fn=lambda ctx: _sandbox_enabled(ctx)
           and ctx.spec.vgpu_device_manager.is_enabled(),
           requires=["chip-fencing"]),
        mk("isolated-validation", "fencing/vGPU validation gate",
           _isolated_validation_data,
           enabled_fn=lambda ctx: _sandbox_enabled(ctx)
           and ctx.spec.validator.is_enabled(),
           requires=["gpu-driver", "chip-fencing", "vgpu-device-manager"],
           watches=[("v1", "Pod")]),
        mk("isolated-device-plugin", "fenced/vGPU pool device plugin",
           _isolated_device_plugin_data,
           enabled_fn=lambda ctx: _sandbox_enabled(ctx)
           and ctx.spec.isolated_device_plugin.is_enabled(),
           requires=["isolated-validation"]),
    ]

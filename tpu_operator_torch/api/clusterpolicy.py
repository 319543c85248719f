"""GPUClusterPolicy: the singleton, cluster-scoped, whole-stack CRD.

The port's counterpart of ``tpu_operator/api/clusterpolicy.py``
(TPUClusterPolicy), itself the analog of the NVIDIA operator's
ClusterPolicy: one sub-spec per operand, a coarse status state enum and
conditions. Fields follow the naming rule of ROADMAP.md §C: ``libtpu`` ->
``driver``, ``tpuRuntime`` -> ``gpuRuntime``, ``tpuHealth`` ->
``gpuHealth``, ``vtpuDeviceManager`` -> ``vgpuDeviceManager``, the
validator's ``jax``/``ici`` proofs -> ``cuda``/``nvlink``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .convert import field, from_dict, to_dict

GROUP = "gpu.graft.dev"
V1 = f"{GROUP}/v1"

KIND_CLUSTER_POLICY = "GPUClusterPolicy"

# status.state values (clusterpolicy_types.go:1658-1670 analog)
STATE_IGNORED = "ignored"
STATE_READY = "ready"
STATE_NOT_READY = "notReady"
STATE_DISABLED = "disabled"


@dataclass
class ComponentSpec:
    """Config surface shared by every operand (enable flag + image +
    scheduling + env), mirroring the per-operand field set repeated through
    clusterpolicy_types.go."""

    enabled: Optional[bool] = field(description="Deploy this operand")
    repository: Optional[str] = field(description="Image registry+path prefix")
    image: Optional[str] = field(description="Image name")
    version: Optional[str] = field(description="Image tag or sha256: digest")
    image_pull_policy: Optional[str] = field(description="IfNotPresent|Always|Never")
    image_pull_secrets: Optional[List[str]] = None
    args: Optional[List[str]] = field(
        description="Replace the operand container's args")
    env: Optional[List[Any]] = field(description="corev1 EnvVar list")
    resources: Optional[Any] = field(description="corev1 ResourceRequirements")
    labels: Optional[Dict[str, str]] = field(
        description="Extra labels on this operand's objects and pods "
                    "(merged over daemonsets.labels)")
    annotations: Optional[Dict[str, str]] = field(
        description="Extra annotations on this operand's objects and pods "
                    "(merged over daemonsets.annotations)")
    node_selector: Optional[Dict[str, str]] = field(
        description="Extra nodeSelector terms merged into this operand's "
                    "DaemonSet (the per-state deploy label always applies)")
    affinity: Optional[Any] = field(description="corev1 Affinity for the pod")
    tolerations: Optional[List[Any]] = field(
        description="Extra tolerations appended after daemonsets.tolerations")
    priority_class_name: Optional[str] = field(
        description="Overrides daemonsets.priorityClassName for this operand")

    def is_enabled(self, default: bool = True) -> bool:
        return default if self.enabled is None else bool(self.enabled)


@dataclass
class OperatorSpec:
    """Operator-global knobs (OperatorSpec analog,
    clusterpolicy_types.go Operator section)."""

    runtime_class: Optional[str] = field(
        default="nvidia", description="RuntimeClass registered by pre-requisites")
    init_container: Optional[ComponentSpec] = None
    labels: Optional[Dict[str, str]] = None
    annotations: Optional[Dict[str, str]] = None
    service_monitor: Optional[bool] = field(
        default=False,
        description="Deploy a ServiceMonitor + PrometheusRule for the "
                    "operator's own metrics (requires prometheus-operator "
                    "CRDs; assets/state-operator-metrics/0300 analog)")
    service_monitor_interval_seconds: Optional[int] = field(
        default=30, description="Operator metrics scrape interval")


@dataclass
class PSASpec:
    """Pod Security Admission opt-in (PSASpec analog,
    clusterpolicy_types.go:208-212): when enabled the reconciler stamps
    pod-security.kubernetes.io/{enforce,audit,warn}=privileged on the
    operand namespace so privileged driver/validator pods admit."""

    enabled: Optional[bool] = field(
        default=False, description="Label the operand namespace for PSA")

    def is_enabled(self, default: bool = False) -> bool:
        return default if self.enabled is None else bool(self.enabled)


@dataclass
class DaemonsetsSpec:
    """Defaults applied to every operand DaemonSet
    (DaemonsetsSpec analog)."""

    labels: Optional[Dict[str, str]] = None
    annotations: Optional[Dict[str, str]] = None
    tolerations: Optional[List[Any]] = None
    priority_class_name: Optional[str] = field(default="system-node-critical")
    update_strategy: Optional[str] = field(
        default="RollingUpdate", description="RollingUpdate|OnDelete")
    rolling_update_max_unavailable: Optional[str] = field(
        name="rollingUpdateMaxUnavailable", default="1")


@dataclass
class DriverSpec(ComponentSpec):
    """state-gpu-driver: find, load and version the user-space driver on
    the node (the driver-container slot). ``gpu-driver-install`` reads
    INSTALL_DIR and GPU_DRIVER_VERSION; it installs nothing, since the
    host installs the user-space driver with its kernel module."""

    install_dir: Optional[str] = field(
        default="/usr/local/nvidia/lib64",
        description="Host dir holding libcuda.so.1")
    driver_version: Optional[str] = field(
        default=None, description="NVML driver version the node must "
        "run (GPU_DRIVER_VERSION); empty accepts any")


@dataclass
class GPURuntimeSpec(ComponentSpec):
    """state-gpu-runtime: device exposure + env hookup
    (container-toolkit slot)."""

    device_path_glob: Optional[str] = field(
        name="devicePathGlob", default="/dev/nvidia*")


@dataclass
class DevicePluginSpec(ComponentSpec):
    """state-gpu-device-plugin: advertise nvidia.com/gpu to kubelet
    (k8s-device-plugin slot)."""

    resource_name: Optional[str] = field(default="nvidia.com/gpu")
    sharing_policy: Optional[str] = field(
        default="exclusive", description="exclusive|time-shared")
    sharing_replicas: Optional[int] = field(
        default=1, description="Advertised replicas per card when "
        "time-shared (MPS/time-slicing slot)")
    config_map: Optional[str] = field(
        default=None,
        description="ConfigMap of named per-node plugin configs; a node "
        "picks one via the gpu.graft.dev/device-plugin.config label "
        "(devicePlugin.config slot; the config-manager sidecar is folded "
        "into the plugin process, which watches the label and "
        "live-reloads)")
    default_config: Optional[str] = field(
        default=None,
        description="Config key applied to nodes without the selection "
        "label (DEFAULT_CONFIG env of the reference's config-manager)")


@dataclass
class GPUHealthSpec(ComponentSpec):
    """state-gpu-health: standalone node-local telemetry/health engine
    (the standalone-DCGM slot). Disabled by default: the metrics exporter
    samples locally unless this engine owns the session
    (DCGM_REMOTE_HOSTENGINE_INFO split)."""

    port: Optional[int] = field(default=9402)
    collection_interval_seconds: Optional[int] = field(default=15)

    def is_enabled(self, default: bool = False) -> bool:
        return super().is_enabled(default)


@dataclass
class MetricsExporterSpec(ComponentSpec):
    """state-metrics-exporter: NVML card metrics -> Prometheus
    (DCGM + dcgm-exporter slot)."""

    port: Optional[int] = field(default=9400)
    service_monitor: Optional[bool] = field(default=False)
    collection_interval_seconds: Optional[int] = field(default=15)


@dataclass
class NodeStatusExporterSpec(ComponentSpec):
    """state-node-status-exporter: per-node validation status gauges."""

    port: Optional[int] = field(default=9401)


@dataclass
class FeatureDiscoverySpec(ComponentSpec):
    """state-feature-discovery: on-node card property labels
    (gpu-feature-discovery slot): product, memory, NVLink rate, driver
    version, topology, multi-host membership."""

    interval_seconds: Optional[int] = field(
        default=60, description="Re-discovery period (GFD sleep-interval)")


@dataclass
class TopologyManagerSpec(ComponentSpec):
    """state-topology-manager: card groups from node labels (the
    MIG-manager slot; config label gpu.graft.dev/slice.config)."""

    config_map: Optional[str] = field(
        default="default-slice-config",
        description="ConfigMap of named slice profiles")
    default_profile: Optional[str] = field(default="full")


@dataclass
class SandboxWorkloadsSpec:
    """Gate for the isolated/virtual workload plane (SandboxWorkloads
    analog: the reference deploys its vm-passthrough/vm-vgpu operand set
    only when sandboxWorkloads.enabled). ``defaultWorkload`` is the
    workload config assumed for nodes that carry no
    gpu.graft.dev/workload.config label."""

    enabled: Optional[bool] = field(default=False)
    default_workload: Optional[str] = field(
        default="container", description="container|isolated|virtual")

    def is_enabled(self, default: bool = False) -> bool:
        return default if self.enabled is None else bool(self.enabled)


@dataclass
class ChipFencingSpec(ComponentSpec):
    """state-chip-fencing: take cards out of the shared pool (the
    vfio-manager slot: the agent publishes a fence list the shared device
    plugin honors and the isolated plugin serves)."""

    config: Optional[str] = field(
        default="all", description="Default fence set when the node has no "
        "gpu.graft.dev/fencing.config label: all|none|comma card list")


@dataclass
class VGPUDeviceManagerSpec(ComponentSpec):
    """state-vgpu-device-manager: build fractional vGPU devices from a
    named profile (the vgpu-device-manager slot; config label
    gpu.graft.dev/vgpu.config)."""

    config_map: Optional[str] = field(
        default="default-vgpu-config",
        description="ConfigMap of named vGPU profiles")
    default_profile: Optional[str] = field(default="vgpu-2")


@dataclass
class IsolatedDevicePluginSpec(ComponentSpec):
    """state-isolated-device-plugin: advertise fenced cards
    (nvidia.com/gpu-isolated) or vGPU devices (nvidia.com/vgpu) — the
    sandbox-device-plugin slot."""

    resource_name: Optional[str] = field(default="nvidia.com/gpu-isolated")
    vgpu_resource_name: Optional[str] = field(default="nvidia.com/vgpu")


@dataclass
class ValidatorSpec(ComponentSpec):
    """state-operator-validation: the readiness gate (validator/ slot)."""

    plugin: Optional[ComponentSpec] = None
    driver: Optional[ComponentSpec] = None
    cuda: Optional[ComponentSpec] = None
    nvlink: Optional[ComponentSpec] = None
    hbm: Optional[ComponentSpec] = None
    dcn: Optional[ComponentSpec] = None
    runtime: Optional[ComponentSpec] = None
    matmul_size: Optional[int] = field(
        default=4096, description="N for the NxN bf16 matmul tensor-core "
        "proof")
    nvlink_bandwidth_threshold: Optional[float] = field(
        name="nvlinkBandwidthThreshold", default=0.8,
        description="Fraction of one-way NVLink bandwidth required")


@dataclass
class DriverUpgradePolicySpec:
    """Rolling driver upgrade policy (UpgradePolicy analog)."""

    auto_upgrade: Optional[bool] = field(default=False)
    max_parallel_upgrades: Optional[int] = field(
        default=1, description="Concurrent upgrade units: single-host "
        "nodes count 1 each, a multi-host pool counts as one unit")
    max_unavailable: Optional[str] = field(default="25%")
    wait_for_completion_timeout_seconds: Optional[int] = field(default=0)
    pod_deletion_timeout_seconds: Optional[int] = field(default=300)
    drain_enable: Optional[bool] = field(name="drainEnable", default=True)
    drain_timeout_seconds: Optional[int] = field(
        default=300, description="Seconds before an in-progress drain "
        "fails the node (eviction can block forever on a PDB)")
    drain_delete_emptydir: Optional[bool] = field(
        name="drainDeleteEmptyDir", default=False)
    drain_force: Optional[bool] = field(
        default=False, description="Fall back to pod deletion when the "
        "eviction API is blocked by a PodDisruptionBudget at the drain "
        "timeout")
    validation_timeout_seconds: Optional[int] = field(
        default=300, description="Seconds a node may sit in "
        "validation-required before the upgrade FSM marks it failed")
    failed_retry_backoff_seconds: Optional[int] = field(
        default=60, description="Backoff before a failed node re-enters "
        "the upgrade FSM")
    migration_timeout_seconds: Optional[int] = field(
        default=120, description="Seconds the migrate stage waits for a "
        "placed slice to checkpoint-and-rebind before degrading to the "
        "hard drain; 0 disables the elastic migrate stage entirely")


@dataclass
class HostPathsSpec:
    """Host filesystem anchor points (HostPathsSpec analog)."""

    root_fs: Optional[str] = field(name="rootFS", default="/")
    validation_dir: Optional[str] = field(
        default="/run/nvidia/validations",
        description="hostPath dir for the status-file barrier protocol")
    dev_dir: Optional[str] = field(default="/dev")


@dataclass
class GPUClusterPolicySpec:
    operator: Optional[OperatorSpec] = field(default_factory=OperatorSpec)
    daemonsets: Optional[DaemonsetsSpec] = field(default_factory=DaemonsetsSpec)
    driver: Optional[DriverSpec] = field(default_factory=DriverSpec)
    gpu_runtime: Optional[GPURuntimeSpec] = field(
        name="gpuRuntime", default_factory=GPURuntimeSpec)
    device_plugin: Optional[DevicePluginSpec] = field(default_factory=DevicePluginSpec)
    gpu_health: Optional[GPUHealthSpec] = field(
        name="gpuHealth", default_factory=GPUHealthSpec)
    metrics_exporter: Optional[MetricsExporterSpec] = field(
        default_factory=MetricsExporterSpec)
    node_status_exporter: Optional[NodeStatusExporterSpec] = field(
        default_factory=NodeStatusExporterSpec)
    feature_discovery: Optional[FeatureDiscoverySpec] = field(
        default_factory=FeatureDiscoverySpec)
    topology_manager: Optional[TopologyManagerSpec] = field(
        default_factory=TopologyManagerSpec)
    sandbox_workloads: Optional[SandboxWorkloadsSpec] = field(
        default_factory=SandboxWorkloadsSpec)
    chip_fencing: Optional[ChipFencingSpec] = field(
        default_factory=ChipFencingSpec)
    vgpu_device_manager: Optional[VGPUDeviceManagerSpec] = field(
        name="vgpuDeviceManager", default_factory=VGPUDeviceManagerSpec)
    isolated_device_plugin: Optional[IsolatedDevicePluginSpec] = field(
        default_factory=IsolatedDevicePluginSpec)
    validator: Optional[ValidatorSpec] = field(default_factory=ValidatorSpec)
    upgrade_policy: Optional[DriverUpgradePolicySpec] = field(
        default_factory=DriverUpgradePolicySpec)
    host_paths: Optional[HostPathsSpec] = field(default_factory=HostPathsSpec)
    psa: Optional[PSASpec] = field(default_factory=PSASpec)

    @classmethod
    def from_obj(cls, cr: dict) -> "GPUClusterPolicySpec":
        spec = from_dict(cls, cr.get("spec") or {})
        # default_factory only fires for absent keys at the dataclass level;
        # normalize explicit nulls too
        for f_name, factory in (("operator", OperatorSpec),
                                ("daemonsets", DaemonsetsSpec),
                                ("driver", DriverSpec),
                                ("gpu_runtime", GPURuntimeSpec),
                                ("device_plugin", DevicePluginSpec),
                                ("gpu_health", GPUHealthSpec),
                                ("metrics_exporter", MetricsExporterSpec),
                                ("node_status_exporter", NodeStatusExporterSpec),
                                ("feature_discovery", FeatureDiscoverySpec),
                                ("topology_manager", TopologyManagerSpec),
                                ("sandbox_workloads", SandboxWorkloadsSpec),
                                ("chip_fencing", ChipFencingSpec),
                                ("vgpu_device_manager", VGPUDeviceManagerSpec),
                                ("isolated_device_plugin",
                                 IsolatedDevicePluginSpec),
                                ("validator", ValidatorSpec),
                                ("upgrade_policy", DriverUpgradePolicySpec),
                                ("host_paths", HostPathsSpec),
                                ("psa", PSASpec)):
            if getattr(spec, f_name) is None:
                setattr(spec, f_name, factory())
        return spec

    def to_obj(self) -> dict:
        return to_dict(self)


def new_cluster_policy(name: str = "gpu-cluster-policy",
                       spec: Optional[dict] = None) -> dict:
    return {
        "apiVersion": V1,
        "kind": KIND_CLUSTER_POLICY,
        "metadata": {"name": name},
        "spec": spec or {},
    }

"""The naming rule between the JAX package and the port, as one explicit
map (ROADMAP.md §C holds the same rows). Every name the reconcile path
renders or stamps is mapped here row by row; there is no blind
``tpu`` -> ``gpu`` replace. ``name`` maps one reference string, ``obj``
a whole rendered object tree, ``spec`` a TPUClusterPolicy spec into the
GPUClusterPolicy spec it stands for. JAX-free: the map is data."""

from __future__ import annotations

# --- the CRD ----------------------------------------------------------------
CRD = {
    "TPUClusterPolicy": "GPUClusterPolicy",
    "tpuclusterpolicies": "gpuclusterpolicies",  # the plural in the path
    "tpu.graft.dev/v1": "gpu.graft.dev/v1",
    "tpu-cluster-policy": "gpu-cluster-policy",
    "TPUDriver": "GPUDriver",
    "tpu.graft.dev/v1alpha1": "gpu.graft.dev/v1alpha1",
}
# the CRDs' plurals, singulars and short names (SliceRequest's unchanged)
CRD_NAMES = {
    "tpuclusterpolicies": "gpuclusterpolicies",
    "tpuclusterpolicy": "gpuclusterpolicy",
    "tcp": "gcp", "tpucp": "gpucp",
    "tpudrivers": "gpudrivers", "tpudriver": "gpudriver", "tpud": "gpud",
}
# the install surface: the values key of the driver CRs, and the chart's
# files (deployments/tpu-operator -> deployments/gpu-operator)
VALUES_KEYS = {"tpuDrivers": "gpuDrivers"}
CHART_DIR = ("deployments/tpu-operator", "deployments/gpu-operator")
CHART_FILES = {"templates/tpudrivers.yaml": "templates/gpudrivers.yaml",
               "crds/tpuclusterpolicies.yaml": "crds/gpuclusterpolicies.yaml",
               "crds/tpudrivers.yaml": "crds/gpudrivers.yaml"}
# the CLIs ([project.scripts]) and the typed clientset's accessors
CLIS = {"tpuop-cfg": "gpuop-cfg", "tpuop-must-gather": "gpuop-must-gather",
        "tpu-operator-maintenance": "gpu-operator-maintenance"}
CLIENTSET = {"TpuV1": "GpuV1", "TpuV1alpha1": "GpuV1alpha1",
             "tpu_v1": "gpu_v1", "tpu_v1alpha1": "gpu_v1alpha1",
             "tpu_drivers": "gpu_drivers", "TPUDriver": "GPUDriver",
             "TPUDriverStatus": "GPUDriverStatus"}
# the fleet fold's goodput bar, by generation: the reference's TPU
# generations as build_cluster's mix maps them (v5e's pool is an H100's,
# so its bar of 0.12 becomes 0.15; the others keep theirs)
GOODPUT_GENERATIONS = {"v4": ("a100-sxm",), "v5e": ("h100-sxm",),
                       "v5p": ("h100-sxm", "gb200")}
# the SliceRequest CRD's rule message: a GPU request names a fabric
CRD_TEXT = (("topology grid", "topology fabric"),)
# spec fields renamed (the key at any depth: each occurs at one place)
SPEC_FIELDS = {
    "libtpu": "driver",
    "tpuRuntime": "gpuRuntime",
    "tpuHealth": "gpuHealth",
    "vtpuDeviceManager": "vgpuDeviceManager",
    "vtpuResourceName": "vgpuResourceName",
    "jax": "cuda",                       # validator.jax
    "ici": "nvlink",                     # validator.ici
    "iciBandwidthThreshold": "nvlinkBandwidthThreshold",
    # libtpu's release channel -> the NVML driver version the node must
    # run (gpu-driver-install reads GPU_DRIVER_VERSION; §C)
    "channel": "driverVersion",
}

# --- operand states ---------------------------------------------------------
STATES = {
    "libtpu-driver": "gpu-driver",
    "tpu-runtime": "gpu-runtime",
    "tpu-device-plugin": "gpu-device-plugin",
    "tpu-health": "gpu-health",
    "vtpu-device-manager": "vgpu-device-manager",
}

# --- objects: namespace, DaemonSets, ServiceAccounts, RBAC, Services -------
OBJECTS = {
    "tpu-operator": "gpu-operator",
    "tpu-libtpu-driver-daemonset": "gpu-driver-daemonset",
    "tpu-libtpu-driver": "gpu-driver",
    "tpu-runtime-daemonset": "gpu-runtime-daemonset",
    "tpu-operator-validator": "gpu-operator-validator",
    "tpu-operator-validator-nodes": "gpu-operator-validator-nodes",
    "tpu-device-plugin-daemonset": "gpu-device-plugin-daemonset",
    "tpu-health-engine": "gpu-health-engine",
    "libtpu-metrics-exporter": "gpu-metrics-exporter",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-node-status-exporter": "gpu-node-status-exporter",
    "tpu-topology-manager": "gpu-topology-manager",
    "tpu-chip-fencing": "gpu-chip-fencing",
    "tpu-vtpu-device-manager": "gpu-vgpu-device-manager",
    "tpu-isolated-validator": "gpu-isolated-validator",
    "tpu-isolated-device-plugin": "gpu-isolated-device-plugin",
    "tpu-operator-metrics": "gpu-operator-metrics",
    "tpu-operator-rules": "gpu-operator-rules",
    "default-vtpu-config": "default-vgpu-config",
    "tpu": "nvidia",                     # the RuntimeClass
}
# --- containers, volumes, mounts --------------------------------------------
CONTAINERS = {
    "tpu-driver-manager": "gpu-driver-manager",   # also its command
    "libtpu-installer": "gpu-driver-installer",
    "tpu-runtime": "gpu-runtime",
    "tpu-device-plugin": "gpu-device-plugin",
    "jax-validation": "cuda-validation",
    "ici-validation": "nvlink-validation",
    "vtpu-validation": "vgpu-validation",
    "run-tpu": "run-nvidia",
}
PATHS = {
    "/run/tpu": "/run/nvidia",
    "/run/tpu/validations": "/run/nvidia/validations",
    "/etc/tpu-device-plugin/configs": "/etc/gpu-device-plugin/configs",
    "/home/kubernetes/bin": "/usr/local/nvidia/lib64",  # the driver's dir
    "/dev/accel*": "/dev/nvidia*",
}
# --- images: ghcr.io/tpu-operator/<image> -> ghcr.io/gpu-operator/<image> --
IMAGE_REPOSITORY = ("ghcr.io/tpu-operator", "ghcr.io/gpu-operator")
IMAGES = {
    "tpu-operator": "gpu-operator",
    "libtpu-installer": "gpu-driver-installer",
    "tpu-runtime": "gpu-runtime",
    "tpu-validator": "gpu-validator",
    "tpu-device-plugin": "gpu-device-plugin",
    "tpu-health-engine": "gpu-health-engine",
    "libtpu-metrics-exporter": "gpu-metrics-exporter",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-topology-manager": "gpu-topology-manager",
    "tpu-chip-fencing": "gpu-chip-fencing",
    "tpu-vtpu-device-manager": "gpu-vgpu-device-manager",
}
# --- commands: each names a port agent ([project.scripts]) ------------------
COMMANDS = {
    "tpu-validator": "gpu-validator",
    "tpu-driver-manager": "gpu-driver-manager",
    "libtpu-install": "gpu-driver-install",
    "tpu-runtime-setup": "gpu-runtime-setup",
    "tpu-device-plugin": "gpu-device-plugin",
    "tpu-isolated-device-plugin": "gpu-isolated-device-plugin",
    "tpu-chip-fencing": "gpu-chip-fencing",
    "tpu-vtpu-device-manager": "gpu-vgpu-device-manager",
    "tpu-health-engine": "gpu-health-engine",
    "libtpu-metrics-exporter": "gpu-metrics-exporter",
    "tpu-feature-discovery": "gpu-feature-discovery",
    "tpu-topology-manager": "gpu-topology-manager",
}
# validator components and status files in args
ARGS = {"jax": "cuda", "ici": "nvlink", "vtpu": "vgpu",
        "jax-ready": "cuda-ready", "ici-ready": "nvlink-ready",
        "vtpu-ready": "vgpu-ready"}
# --- env --------------------------------------------------------------------
ENV = {
    "ICI_THRESHOLD": "NVLINK_THRESHOLD",
    "LIBTPU_CHANNEL": "GPU_DRIVER_VERSION",
    "TPU_DEFAULT_WORKLOAD_CONFIG": "GPU_DEFAULT_WORKLOAD_CONFIG",
    "TPU_HEALTH_ENGINE_INFO": "GPU_HEALTH_ENGINE_INFO",
    "TPU_PLUGIN_CONFIG_DIR": "GPU_PLUGIN_CONFIG_DIR",
    "TPU_PLUGIN_CONFIG_DEFAULT": "GPU_PLUGIN_CONFIG_DEFAULT",
    "VTPU_RESOURCE_NAME": "VGPU_RESOURCE_NAME",
}
# an operand's image from the env when the spec names none
# (api/image.py env_var_for: the state's name, upper-cased, + _IMAGE)
IMAGE_ENV = {"LIBTPU_DRIVER_IMAGE": "GPU_DRIVER_IMAGE"}
# the property tiers' depth knob (tests/test_fuzz_*.py)
FUZZ_ENV = {"TPU_FUZZ_EXAMPLES": "GPU_FUZZ_EXAMPLES"}
# an env value whose default differs: libtpu's default channel "stable"
# stands for "any driver version" (GPU_DRIVER_VERSION empty)
ENV_VALUE_DEFAULTS = {("LIBTPU_CHANNEL", "stable"): ""}
# --- resources, vGPU profiles, card ids --------------------------------------
RESOURCES = {"google.com/tpu": "nvidia.com/gpu",
             "google.com/tpu-isolated": "nvidia.com/gpu-isolated",
             "google.com/vtpu": "nvidia.com/vgpu"}
PROFILES = {f"vtpu-{n}": f"vgpu-{n}" for n in (1, 2, 4, 8)}
CARDS = {"accel0,accel2": "gpu0,gpu2"}
# --- label keys: tpu.graft.dev/<suffix> -> gpu.graft.dev/<suffix> -----------
LABEL_SUFFIX_RULES = (("tpu.accelerator", "gpu.product"),
                      ("libtpu.version", "driver.version"),
                      ("ici-gbps", "nvlink-gbps"),
                      ("vtpu", "vgpu"),
                      ("tpu.", "gpu."))
# --- the operator's alerts ---------------------------------------------------
ALERTS = {"TPUOperatorNoTPUNodes": "GPUOperatorNoGPUNodes",
          "TPUOperatorReconcileFailing": "GPUOperatorReconcileFailing",
          "TPUSliceNotValidated": "GPUSliceNotValidated"}
# --- free text: alert expressions and help, profile descriptions, probes ----
# (strings with a space or a newline), these tokens in this order
TEXT = (
    ("/run/tpu/validations/", "/run/nvidia/validations/"),
    ("tpu_operator_tpu_nodes_total", "gpu_operator_gpu_nodes_total"),
    ("tpu_operator_", "gpu_operator_"),
    ("TPU operator", "GPU operator"),
    ("no TPU nodes", "no GPU nodes"),
    ("TPU accelerator labels or google.com/tpu",
     "nvidia- accelerator labels or nvidia.com/gpu"),
    ("multi-host TPU slice", "multi-host GPU pool"),
    ("`tpuop-cfg status` shows which slice",
     "the policy's status.slices[] shows which pool"),
    ("vtpusPerChip", "vgpusPerCard"),
    ("one vTPU per chip (whole-chip units under the vTPU resource)",
     "one vGPU per card (whole-card units under the vGPU resource)"),
    ("half-HBM vTPUs per chip", "half-memory vGPUs per card"),
    ("quarter-HBM vTPUs per chip", "quarter-memory vGPUs per card"),
    ("vtpu-", "vgpu-"),
)

# --- the operator's runtime ------------------------------------------------
# the Lease and the CLI's default namespace are OBJECTS' "tpu-operator"
RUNTIME = {
    "tpu-operator": "gpu-operator",          # the CLI's prog and its script
    "tpuclusterpolicy": "gpuclusterpolicy",  # the controller, metric label
    "UNLABELED_TPU": "UNLABELED_GPU",        # the cache's node bucket
    "--fake-tpu-nodes": "--fake-gpu-nodes",  # the CLI's flag
    # a fake node: a GKE TPU v5p host of 4 chips <-> a GKE H100 host of 4
    # cards; GKE's TPU topology label has no GPU counterpart (dropped)
    "cloud.google.com/gke-tpu-accelerator":
        "cloud.google.com/gke-accelerator",
    "tpu-v5p-slice": "nvidia-h100-80gb",
    "tpu-node-0": "gpu-node-0",
}
# the labels the policy's Node watch fires on: feature discovery's
# gpu.topology stands for GKE's TPU topology label (GKE names no GPU
# topology), and the port also watches GKE's accelerator count, which
# feeds gpu.chips
NODE_WATCH = {
    "cloud.google.com/gke-tpu-accelerator":
        "cloud.google.com/gke-accelerator",
    "cloud.google.com/gke-tpu-topology": "gpu.graft.dev/gpu.topology",
}
NODE_WATCH_ADDED = ("cloud.google.com/gke-accelerator-count",)

# --- the driver CR, its pools and its rollout ------------------------------
# the pool key: GKE's TPU accelerator x topology -> feature discovery's
# product x topology (state/nodepool.py); slice identity inside a pool
# stays GKE's nodepool label
POOL_KEY = {"cloud.google.com/gke-tpu-accelerator": "gpu.graft.dev/gpu.product",
            "cloud.google.com/gke-tpu-topology": "gpu.graft.dev/gpu.topology"}
# a per-pool driver DaemonSet: tpu-libtpu-driver-<pool> ->
# gpu-driver-<pool>, and its state label on the objects
DRIVER_DS_PREFIX = ("tpu-libtpu-driver-", "gpu-driver-")
DRIVER_STATE_PREFIX = ("tpu-driver-", "gpu-driver-")
# the driver CR's spec: the renamed field (libtpu's channel -> the NVML
# driver version) and the defaults that change; every other field keeps
# its name and default
DRIVER_SPEC_FIELDS = {"channel": "driverVersion"}
DRIVER_SPEC_DEFAULTS = {
    "driverType": ("libtpu", "driver"),
    "image": ("libtpu-installer", "gpu-driver-installer"),
    "installDir": ("/home/kubernetes/bin", "/usr/local/nvidia/lib64"),
    "channel": ("stable", None),
}
# the upgrade FSM's labels and annotations (each under label_key's rule:
# the domain alone changes)
UPGRADE_LABELS = ("tpu.graft.dev/upgrade.state",
                  "tpu.graft.dev/upgrade.skip-drain",
                  "tpu.graft.dev/upgrade.stage-started",
                  "tpu.graft.dev/upgrade.failed-at",
                  "tpu.graft.dev/upgrade.failed-reason",
                  "tpu.graft.dev/driver-upgrade-enabled")
UPGRADE = {
    "tpu-upgrade": "gpu-upgrade",              # the controller, metric label
    "_tpu_workload_pods_by_node": "_gpu_workload_pods_by_node",
    "_tpu_workload_pods_on": "_gpu_workload_pods_on",
}
# the FSM's event and failure texts
UPGRADE_TEXT = (("New libtpu revision validated",
                 "New driver revision validated"),
                ("remaining TPU pods", "remaining GPU pods"))

# --- placement, quota and the elastic handshake -----------------------------
# the placement labels keep their suffixes (label_key's rule: the domain
# alone changes); the names outside the label domain, row by row
PLACEMENT = {
    "TPUTelemetryHealthy": "GPUTelemetryHealthy",  # the Node condition
    "TPUQuota": "GPUQuota",                        # the quota CRD's kind
    "tpu-operator-quota": "gpu-operator-quota",    # the quota ConfigMap
    "sliceplacement": "sliceplacement",            # the controller
}
# an NVLink domain is what the reference calls an ICI domain, and a GPU
# request names a fabric where a TPU request names a grid
PLACEMENT_TEXT = (("ICI domain", "NVLink domain"),
                  ("requested grid", "requested topology"))
# the operator's metric series (placement, fleet cards, migrations and the
# rest): the prefix alone changes
METRIC_PREFIX = ("tpu_operator_", "gpu_operator_")
# the series whose names say TPU past the prefix: the fleet gauges and
# three of the node-status exporter's
METRIC_SERIES = {
    "tpu_operator_tpu_nodes_total": "gpu_operator_gpu_nodes_total",
    "tpu_operator_tpu_chips_total": "gpu_operator_gpu_chips_total",
    "tpu_operator_node_tpu_chips": "gpu_operator_node_gpus",
    "tpu_operator_node_matmul_mxu_utilization":
        "gpu_operator_node_matmul_tensor_core_utilization",
    "tpu_operator_node_ici_fraction_of_peak":
        "gpu_operator_node_nvlink_fraction_of_peak",
}


def metric(series: str) -> str:
    """A reference metric series under the rule."""
    if series in METRIC_SERIES:
        return METRIC_SERIES[series]
    a, b = METRIC_PREFIX
    return b + series[len(a):] if series.startswith(a) else series


# --- the benchmarks -----------------------------------------------------------
# the headline's env knobs that the port has (the rest name benchmarks
# of modules not ported, or the reference's child process)
BENCH_ENV = {"TPUOP_BENCH_SKIP_SCALE": "GPUOP_BENCH_SKIP_SCALE",
             "TPUOP_BENCH_SCALE_NODES": "GPUOP_BENCH_SCALE_NODES",
             "TPUOP_BENCH_FLEET_NODES": "GPUOP_BENCH_FLEET_NODES",
             "TPUOP_BENCH_SKIP_FLEET": "GPUOP_BENCH_SKIP_FLEET",
             "TPUOP_BENCH_SKIP_RESHARD": "GPUOP_BENCH_SKIP_RESHARD",
             "TPUOP_BENCH_PLACEMENT_FLEET_NODES":
                 "GPUOP_BENCH_PLACEMENT_FLEET_NODES",
             "TPUOP_BENCH_SKIP_PLACEMENT_FLEET":
                 "GPUOP_BENCH_SKIP_PLACEMENT_FLEET",
             "TPUOP_BENCH_RESTART_NODES": "GPUOP_BENCH_RESTART_NODES",
             "TPUOP_BENCH_SKIP_RESTART": "GPUOP_BENCH_SKIP_RESTART",
             "TPUOP_BENCH_FAIRNESS_NODES": "GPUOP_BENCH_FAIRNESS_NODES",
             "TPUOP_BENCH_SKIP_FAIRNESS": "GPUOP_BENCH_SKIP_FAIRNESS",
             "TPUOP_BENCH_TELEMETRY_NODES": "GPUOP_BENCH_TELEMETRY_NODES",
             "TPUOP_BENCH_SKIP_TELEMETRY": "GPUOP_BENCH_SKIP_TELEMETRY",
             "TPUOP_BENCH_FEDERATION_CELLS": "GPUOP_BENCH_FEDERATION_CELLS",
             "TPUOP_BENCH_FEDERATION_NODES_PER_CELL":
                 "GPUOP_BENCH_FEDERATION_NODES_PER_CELL",
             "TPUOP_BENCH_SKIP_FEDERATION": "GPUOP_BENCH_SKIP_FEDERATION"}
# result keys and metric names
BENCH_KEYS = {"n_tpu_nodes": "n_gpu_nodes", "n_tpu": "n_gpu",
              "baseline_tpu": "baseline_gpu",
              "baseline_tpu_nodes": "baseline_gpu_nodes"}
BENCH_METRICS = {
    "validator_matmul_mxu_utilization":
        "validator_matmul_tensor_core_utilization",
    "validator_ici_allreduce_fraction_of_peak":
        "validator_nvlink_allreduce_fraction_of_peak",
    "validator_ici_allreduce_bus_bandwidth":
        "validator_nvlink_allreduce_bus_bandwidth",
    "fraction_of_ici_peak": "fraction_of_nvlink_peak",
}
# build_cluster's pool mix, row by row, shares and CPU_FRACTION unchanged:
# (accelerator, topology, chips) -> (accelerator, product, topology, cards)
POOL_MIX = {
    ("tpu-v5p-slice", "2x2x1", 4):
        ("nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3", "nvswitch-8", 8),
    ("tpu-v5p-slice", "4x4x4", 4):          # the multi-host pool
        ("nvidia-gb200", "NVIDIA-GB200", "mnnvl-4", 4),
    ("tpu-v5e-slice", "2x4", 4):
        ("nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3", "nvswitch-4", 4),
    ("tpu-v4-podslice", "2x2x1", 4):
        ("nvidia-a100-80gb", "NVIDIA-A100-SXM4-80GB", "nvswitch-8", 8),
}

# --- chaos and federation ----------------------------------------------------
# the CLI, the settled state's fleet count, the bench's knobs; the cell
# annotations keep their suffixes (label_key's rule), as do the fault
# kinds and scenario names (generic words: chip-loss, chip-degrade)
CHAOS = {"tpuop-chaos": "gpuop-chaos", "tpu_nodes": "gpu_nodes"}
# the runner's namespace and policy are OBJECTS' and CRD's rows
# ("tpu-operator", "tpu-cluster-policy"); the rollout markers name a
# driver install dir where the reference's name libtpu's
CHAOS_MARKERS = (("-libtpu-", "-driver-"),)
# the node a NODE_ADD joins and the index-coherence probes: the
# reference's v5p host and pin in the port's mix (chaos/runner.py
# NODE_ADD_LABELS, chaos/invariants.py PROBE_*)
CHAOS_NODE_ADD = {
    ("tpu-v5p-slice", "2x2x1", 4):
        ("nvidia-h100-80gb", "NVIDIA-H100-80GB-HBM3", "nvswitch-4", 4)}
CHAOS_PROBES = {"tpu-v5p-slice": "NVIDIA-H100-80GB-HBM3",
                "v5p": "h100-sxm"}
# the federation bench's knobs are BENCH_ENV's rows

EXACT = {**CRD, **STATES, **OBJECTS, **CONTAINERS, **PATHS, **COMMANDS,
         **ARGS, **ENV, **RESOURCES, **PROFILES, **CARDS, **ALERTS,
         **RUNTIME, **UPGRADE, **PLACEMENT, **CHAOS}


def label_key(value: str) -> str:
    _, sep, suffix = value.partition("/")
    if suffix.startswith("deploy."):
        state = suffix[len("deploy."):]
        return "gpu.graft.dev/deploy." + STATES.get(state, state)
    for a, b in LABEL_SUFFIX_RULES:
        suffix = suffix.replace(a, b)
    return "gpu.graft.dev" + sep + suffix


def name(value):
    """One reference string under the rule (anything else unchanged)."""
    if not isinstance(value, str):
        return value
    if value in EXACT:
        return EXACT[value]
    if value.startswith("tpu.graft.dev/"):
        return label_key(value)
    if value.startswith(IMAGE_REPOSITORY[0] + "/"):
        image, sep, version = value[len(IMAGE_REPOSITORY[0]) + 1:] \
            .partition(":")
        return f"{IMAGE_REPOSITORY[1]}/{IMAGES[image]}{sep}{version}"
    if value.startswith("/run/tpu/"):
        return "/run/nvidia/" + value[len("/run/tpu/"):].replace("vtpu",
                                                                 "vgpu")
    if " " in value or "\n" in value:
        for a, b in TEXT:
            value = value.replace(a, b)
    return value


def obj(tree):
    """A rendered object (or any tree) under the rule: keys and string
    values by ``name``; an EnvVar by its name and ENV_VALUE_DEFAULTS."""
    if isinstance(tree, dict):
        if set(tree) == {"name", "value"} and tree["name"] in ENV:
            value = ENV_VALUE_DEFAULTS.get((tree["name"], tree["value"]),
                                           name(tree["value"]))
            return {"name": ENV[tree["name"]], "value": value}
        return {name(k): obj(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [obj(v) for v in tree]
    return name(tree)


def spec(tree):
    """A TPUClusterPolicy spec as the GPUClusterPolicy spec it stands
    for: renamed fields, values by ``name``."""
    if isinstance(tree, dict):
        return {SPEC_FIELDS.get(k, k): spec(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec(v) for v in tree]
    return name(tree)

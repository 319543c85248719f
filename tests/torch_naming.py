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
    "tpu.graft.dev/v1": "gpu.graft.dev/v1",
    "tpu-cluster-policy": "gpu-cluster-policy",
    "TPUDriver": "GPUDriver",
    "tpu.graft.dev/v1alpha1": "gpu.graft.dev/v1alpha1",
}
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

EXACT = {**CRD, **STATES, **OBJECTS, **CONTAINERS, **PATHS, **COMMANDS,
         **ARGS, **ENV, **RESOURCES, **PROFILES, **CARDS, **ALERTS}


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

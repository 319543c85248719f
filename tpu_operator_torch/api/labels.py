"""Well-known labels, annotations, resources and paths of the port.

Counterpart of ``tpu_operator/api/labels.py``. One naming rule maps the
reference's names onto the port's (ROADMAP.md §C holds the table):

- label domain ``tpu.graft.dev/<suffix>`` -> ``gpu.graft.dev/<suffix>``;
  inside a suffix ``tpu.`` -> ``gpu.``, ``vtpu`` -> ``vgpu``,
  ``ici-gbps`` -> ``nvlink-gbps``, ``tpu.accelerator`` -> ``gpu.product``,
  ``libtpu.version`` -> ``driver.version``;
- operand state names ``tpu-`` -> ``gpu-``, ``libtpu-driver`` ->
  ``gpu-driver``, ``vtpu-device-manager`` -> ``vgpu-device-manager``;
- resources ``google.com/tpu`` -> ``nvidia.com/gpu``,
  ``google.com/tpu-isolated`` -> ``nvidia.com/gpu-isolated``,
  ``google.com/vtpu`` -> ``nvidia.com/vgpu``;
- paths ``/run/tpu/*`` -> ``/run/nvidia/*``.

Only what the ported modules read is here. The GKE TPU node labels and
the placement, quota and federation constants wait for the modules that
read them.
"""

# --- GKE's node labels (discovery inputs) ----------------------------------
GKE_ACCELERATOR = "cloud.google.com/gke-accelerator"  # e.g. nvidia-h100-80gb
GKE_ACCELERATOR_COUNT = "cloud.google.com/gke-accelerator-count"
GKE_NODEPOOL = "cloud.google.com/gke-nodepool"        # pool identity

# --- labels stamped by the operator and its node agents --------------------
DOMAIN = "gpu.graft.dev"
PRESENT = f"{DOMAIN}/present"                     # a GPU node
DEPLOY_PREFIX = f"{DOMAIN}/deploy."               # per-operand deploy label
WORKLOAD_CONFIG = f"{DOMAIN}/workload.config"     # container | isolated | virtual
SLICE_CONFIG = f"{DOMAIN}/slice.config"           # slice profile name
SLICE_CONFIG_STATE = f"{DOMAIN}/slice.config.state"  # pending|success|failed
FENCING_CONFIG = f"{DOMAIN}/fencing.config"       # all | none | card list
FENCING_STATE = f"{DOMAIN}/fencing.state"         # success | failed
VGPU_CONFIG = f"{DOMAIN}/vgpu.config"             # vGPU profile name
VGPU_CONFIG_STATE = f"{DOMAIN}/vgpu.config.state"  # pending|success|failed
DEVICE_PLUGIN_CONFIG = f"{DOMAIN}/device-plugin.config"  # per-node plugin config
GPU_GENERATION = f"{DOMAIN}/gpu.generation"      # hardware.CHIPS key, h100-sxm
GPU_CHIP_COUNT = f"{DOMAIN}/gpu.chips"            # cards on the node
UPGRADE_STATE = f"{DOMAIN}/upgrade.state"         # upgrade controller FSM label
UPGRADE_SKIP_DRAIN = f"{DOMAIN}/upgrade.skip-drain"

# --- feature-discovery labels (stamped by the on-node agent only) ----------
GPU_TOPOLOGY = f"{DOMAIN}/gpu.topology"           # <fabric>-<cards>, nvswitch-8
GPU_PRODUCT = f"{DOMAIN}/gpu.product"             # e.g. NVIDIA-H100-80GB-HBM3
GPU_MEMORY_GB = f"{DOMAIN}/gpu.memory-gb"         # memory per card
GPU_NVLINK_GBPS = f"{DOMAIN}/gpu.nvlink-gbps"     # one-way link rate per card
GPU_MULTIHOST = f"{DOMAIN}/gpu.multihost"         # NVLink domain spans hosts
DRIVER_VERSION = f"{DOMAIN}/driver.version"       # NVML's driver version
FEATURE_LABELS = (GPU_TOPOLOGY, GPU_PRODUCT, GPU_MEMORY_GB, GPU_NVLINK_GBPS,
                  GPU_MULTIHOST, DRIVER_VERSION)

# --- annotations -----------------------------------------------------------
# upgrade FSM bookkeeping (deadlines survive operator restarts)
UPGRADE_STAGE_STARTED = f"{DOMAIN}/upgrade.stage-started"
UPGRADE_FAILED_AT = f"{DOMAIN}/upgrade.failed-at"       # epoch of failure
UPGRADE_FAILED_REASON = f"{DOMAIN}/upgrade.failed-reason"
LAST_APPLIED_HASH = f"{DOMAIN}/last-applied-hash"
# stable hash of the rendered desired object: a live object carrying it
# AND matching the desired spec is skipped without any apiserver verb
SPEC_HASH = f"{DOMAIN}/spec-hash"
STATE_LABEL = f"{DOMAIN}/state"                    # which state owns an object
# per-node driver auto-upgrade opt-in, stamped "true" by the policy
# reconciler; any other value set on a node pauses that node
DRIVER_UPGRADE_ENABLED = f"{DOMAIN}/driver-upgrade-enabled"
# the node health engine's digest: compact JSON {"v": 1, "status",
# "grades": {chip_id: ok|warn|fail}, "duty_pct", "hbm_free_frac",
# "temp_max_c", "gen", "seq"}
HEALTH_DIGEST = f"{DOMAIN}/health-digest"

# --- Pod Security Admission (namespace labels) ----------------------------
PSA_LABEL_PREFIX = "pod-security.kubernetes.io/"
PSA_MODES = ("enforce", "audit", "warn")
PSA_LEVEL_PRIVILEGED = "privileged"

# --- extended resources ----------------------------------------------------
GPU_RESOURCE = "nvidia.com/gpu"
GPU_ISOLATED_RESOURCE = "nvidia.com/gpu-isolated"  # whole fenced cards
VGPU_RESOURCE = "nvidia.com/vgpu"                  # fractional vGPUs

# --- barrier protocol ------------------------------------------------------
DEFAULT_VALIDATION_DIR = "/run/nvidia/validations"

# deploy-label sets per workload config: container nodes run the shared
# plugin and telemetry; isolated nodes trade them for the fence and the
# isolated plugin (whole fenced cards); virtual nodes add the vGPU
# manager (fractions of fenced cards)
CONTAINER_WORKLOAD_STATES = (
    "gpu-driver",
    "gpu-runtime",
    "operator-validation",
    "gpu-device-plugin",
    "gpu-health",
    "metrics-exporter",
    "feature-discovery",
    "node-status-exporter",
    "topology-manager",
)
ISOLATED_WORKLOAD_STATES = (
    "gpu-driver",
    "chip-fencing",
    "isolated-validation",
    "isolated-device-plugin",
    "node-status-exporter",
)
VIRTUAL_WORKLOAD_STATES = (
    "gpu-driver",
    "chip-fencing",
    "vgpu-device-manager",
    "isolated-validation",
    "isolated-device-plugin",
    "node-status-exporter",
)
WORKLOAD_STATE_SETS = {
    "container": CONTAINER_WORKLOAD_STATES,
    "isolated": ISOLATED_WORKLOAD_STATES,
    "virtual": VIRTUAL_WORKLOAD_STATES,
}
ALL_DEPLOY_STATES = tuple(dict.fromkeys(
    CONTAINER_WORKLOAD_STATES + ISOLATED_WORKLOAD_STATES
    + VIRTUAL_WORKLOAD_STATES))

# GKE's accelerator label values -> ``workloads/hardware.py`` CHIPS keys
# (the reference maps GKE's TPU accelerator to a TPU generation)
_GKE_GENERATIONS = {
    "nvidia-h100-80gb": "h100-sxm",
    "nvidia-h100-mega-80gb": "h100-sxm",
}


def deploy_label(state: str) -> str:
    return DEPLOY_PREFIX + state


def accelerator_generation(accelerator_label: str) -> str:
    """Map a GKE accelerator label value to the hardware table's key;
    ``""`` for a value the table does not know."""
    return _GKE_GENERATIONS.get(accelerator_label, "")


def is_gpu_node(node) -> bool:
    """A node is a GPU node when GKE stamped an ``nvidia-`` accelerator
    label on it or it exposes ``nvidia.com/gpu`` capacity."""
    meta = node.get("metadata") or {}
    if ((meta.get("labels") or {}).get(GKE_ACCELERATOR, "")
            .startswith("nvidia-")):
        return True
    return GPU_RESOURCE in ((node.get("status") or {}).get("allocatable")
                            or {})

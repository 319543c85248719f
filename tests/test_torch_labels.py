"""The naming rule between the JAX package and the port, held constant by
constant: every label, annotation, resource, operand state, hostPath and
status file the allocation plane reads is the reference's under the rule
recorded in ROADMAP.md §C, and nothing else."""

import pytest

from tpu_operator.api import labels as RL
from tpu_operator.deviceplugin import plugin as rplugin
from tpu_operator.isolation import fencing as rfencing
from tpu_operator.isolation import vtpu as rvtpu
from tpu_operator.metrics import health_engine as rhe
from tpu_operator.validator import barrier as rbarrier
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.deviceplugin import plugin
from tpu_operator_torch.isolation import fencing, vgpu
from tpu_operator_torch.metrics import health_engine as he
from tpu_operator_torch.topology import manager
from tpu_operator_torch.validator import barrier

# inside a label's suffix, in this order
SUFFIX_RULES = (("tpu.accelerator", "gpu.product"),
                ("libtpu.version", "driver.version"),
                ("ici-gbps", "nvlink-gbps"),
                ("vtpu", "vgpu"),
                ("tpu.", "gpu."))
RESOURCES = {"google.com/tpu": "nvidia.com/gpu",
             "google.com/tpu-isolated": "nvidia.com/gpu-isolated",
             "google.com/vtpu": "nvidia.com/vgpu"}
# the proofs' own renames (ported with the validator chain)
STATUS_RULES = {"jax-ready": "cuda-ready", "ici-ready": "nvlink-ready",
                "vtpu-ready": "vgpu-ready"}


def rename(value: str) -> str:
    """The naming rule applied to one reference value."""
    if value in RESOURCES:
        return RESOURCES[value]
    if value.startswith("tpu.graft.dev"):
        _, sep, suffix = value.partition("/")
        for a, b in SUFFIX_RULES:
            suffix = suffix.replace(a, b)
        return "gpu.graft.dev" + sep + suffix
    if value.startswith("/run/tpu/"):
        return "/run/nvidia/" + rename_file(value[len("/run/tpu/"):])
    return value


def rename_file(name: str) -> str:
    return name.replace("vtpu", "vgpu")


def rename_state(state: str) -> str:
    if state == "libtpu-driver":
        return "gpu-driver"
    if state == "vtpu-device-manager":
        return "vgpu-device-manager"
    return "gpu-" + state[4:] if state.startswith("tpu-") else state


# (reference constant, port constant)
CONSTANTS = [
    ("DOMAIN", "DOMAIN"),
    ("DEPLOY_PREFIX", "DEPLOY_PREFIX"),
    ("WORKLOAD_CONFIG", "WORKLOAD_CONFIG"),
    ("SLICE_CONFIG", "SLICE_CONFIG"),
    ("SLICE_CONFIG_STATE", "SLICE_CONFIG_STATE"),
    ("TPU_CHIP_COUNT", "GPU_CHIP_COUNT"),
    ("TPU_TOPOLOGY", "GPU_TOPOLOGY"),
    ("TPU_MULTIHOST", "GPU_MULTIHOST"),
    ("GKE_NODEPOOL", "GKE_NODEPOOL"),
    ("FENCING_CONFIG", "FENCING_CONFIG"),
    ("FENCING_STATE", "FENCING_STATE"),
    ("VTPU_CONFIG", "VGPU_CONFIG"),
    ("VTPU_CONFIG_STATE", "VGPU_CONFIG_STATE"),
    ("DEVICE_PLUGIN_CONFIG", "DEVICE_PLUGIN_CONFIG"),
    ("TPU_ACCELERATOR", "GPU_PRODUCT"),
    ("TPU_MEMORY_GB", "GPU_MEMORY_GB"),
    ("TPU_ICI_GBPS", "GPU_NVLINK_GBPS"),
    ("LIBTPU_VERSION", "DRIVER_VERSION"),
    ("HEALTH_DIGEST", "HEALTH_DIGEST"),
    ("TPU_RESOURCE", "GPU_RESOURCE"),
    ("TPU_ISOLATED_RESOURCE", "GPU_ISOLATED_RESOURCE"),
    ("VTPU_RESOURCE", "VGPU_RESOURCE"),
    ("DEFAULT_VALIDATION_DIR", "DEFAULT_VALIDATION_DIR"),
    # the reconcile path's (the state manager, the skel, the upgrade
    # opt-in, Pod Security Admission)
    ("TPU_PRESENT", "PRESENT"),
    ("TPU_GENERATION", "GPU_GENERATION"),
    ("GKE_ACCELERATOR_COUNT", "GKE_ACCELERATOR_COUNT"),
    ("LAST_APPLIED_HASH", "LAST_APPLIED_HASH"),
    ("SPEC_HASH", "SPEC_HASH"),
    ("STATE_LABEL", "STATE_LABEL"),
    ("UPGRADE_STATE", "UPGRADE_STATE"),
    ("DRIVER_UPGRADE_ENABLED", "DRIVER_UPGRADE_ENABLED"),
    # the upgrade FSM's
    ("UPGRADE_SKIP_DRAIN", "UPGRADE_SKIP_DRAIN"),
    ("UPGRADE_STAGE_STARTED", "UPGRADE_STAGE_STARTED"),
    ("UPGRADE_FAILED_AT", "UPGRADE_FAILED_AT"),
    ("UPGRADE_FAILED_REASON", "UPGRADE_FAILED_REASON"),
    ("PSA_LABEL_PREFIX", "PSA_LABEL_PREFIX"),
    ("PSA_LEVEL_PRIVILEGED", "PSA_LEVEL_PRIVILEGED"),
    # placement, quota and the elastic handshake's
    ("PLACED_BY", "PLACED_BY"),
    ("SLICE_INTENT", "SLICE_INTENT"),
    ("SLICE_INTENT_DEADLINE", "SLICE_INTENT_DEADLINE"),
    ("SLICE_INTENT_ACK", "SLICE_INTENT_ACK"),
    ("SLICE_ELASTIC", "SLICE_ELASTIC"),
    ("QUOTA_CLASS", "QUOTA_CLASS"),
    # the federation plane's cell annotations
    ("CELL_PIN", "CELL_PIN"),
    ("CELL_AFFINITY", "CELL_AFFINITY"),
]
# constants outside the label domain, renamed row by row
# (torch_naming.PLACEMENT)
NAMED = [("TELEMETRY_CONDITION", "TELEMETRY_CONDITION")]


@pytest.mark.parametrize("ref_name, port_name", CONSTANTS,
                         ids=[p for _, p in CONSTANTS])
def test_constant_follows_the_rule(ref_name, port_name):
    assert getattr(L, port_name) == rename(getattr(RL, ref_name))


@pytest.mark.parametrize("ref_name, port_name", NAMED,
                         ids=[p for _, p in NAMED])
def test_named_constant_follows_the_rule(ref_name, port_name):
    import torch_naming as N

    assert getattr(L, port_name) == N.name(getattr(RL, ref_name))
    assert getattr(L, port_name) != getattr(RL, ref_name)


def test_the_port_has_no_other_label():
    """Every upper-case string constant of the port's labels module is in
    the tables above, or is GKE's accelerator label (a discovery input;
    GKE's nodepool label is the reference's, unchanged)."""
    names = {n for n, v in vars(L).items()
             if n.isupper() and isinstance(v, str)}
    assert names == ({p for _, p in CONSTANTS} | {p for _, p in NAMED}
                     | {"GKE_ACCELERATOR"})
    assert L.GKE_ACCELERATOR == "cloud.google.com/gke-accelerator"


def test_feature_labels():
    assert L.FEATURE_LABELS == tuple(rename(k) for k in RL.FEATURE_LABELS)


@pytest.mark.parametrize("config", ["container", "isolated", "virtual"])
def test_workload_state_sets(config):
    ref = RL.WORKLOAD_STATE_SETS[config]
    assert L.WORKLOAD_STATE_SETS[config] == tuple(rename_state(s)
                                                  for s in ref)
    for state in ref:
        assert RL.deploy_label(state) == RL.DEPLOY_PREFIX + state
        assert L.deploy_label(rename_state(state)) == \
            rename(RL.DEPLOY_PREFIX) + rename_state(state)
    assert set(L.WORKLOAD_STATE_SETS) == set(RL.WORKLOAD_STATE_SETS)


@pytest.mark.parametrize("ref, ours", [
    (rfencing.DEFAULT_FENCING_FILE, fencing.DEFAULT_FENCING_FILE),
    (rvtpu.DEFAULT_VTPU_FILE, vgpu.DEFAULT_VGPU_FILE),
    (rbarrier.DEFAULT_DIR, barrier.DEFAULT_DIR),
    ("/run/tpu/slice-config.json", manager.DEFAULT_SLICE_FILE),
], ids=["fencing", "vgpu", "validations", "slices"])
def test_host_paths(ref, ours):
    assert ours == rename(ref)


def test_plugin_names():
    assert plugin.DEFAULT_RESOURCE == rename(rplugin.DEFAULT_RESOURCE)
    assert plugin.PLUGIN_SOCKET == rplugin.PLUGIN_SOCKET.replace("tpu-",
                                                                 "gpu-")
    iso, riso = plugin.IsolatedGpuDevicePlugin, rplugin.IsolatedTPUDevicePlugin
    assert (iso.ISOLATED_RESOURCE, iso.VGPU_RESOURCE) == (
        rename(riso.ISOLATED_RESOURCE), rename(riso.VTPU_RESOURCE))
    assert iso.ISOLATED_SOCKET == riso.ISOLATED_SOCKET.replace("tpu-", "gpu-")
    assert (plugin.KUBELET_SOCKET_DIR, plugin.KUBELET_SOCKET,
            plugin.API_VERSION) == (rplugin.KUBELET_SOCKET_DIR,
                                    rplugin.KUBELET_SOCKET,
                                    rplugin.API_VERSION)


def test_status_files_are_the_references():
    assert barrier.KNOWN_STATUS_FILES == tuple(
        STATUS_RULES.get(f, f) for f in rbarrier.KNOWN_STATUS_FILES)


def test_health_engine_constants():
    assert (he.DEFAULT_PORT, he.TEMP_WARN_C, he.TEMP_FAIL_C,
            he.HBM_WARN_FRACTION, he.DIGEST_SCHEMA_VERSION) == (
        rhe.DEFAULT_PORT, rhe.TEMP_WARN_C, rhe.TEMP_FAIL_C,
        rhe.HBM_WARN_FRACTION, rhe.DIGEST_SCHEMA_VERSION)


def test_reconcile_path_tuples():
    assert L.PSA_MODES == RL.PSA_MODES
    assert L.ALL_DEPLOY_STATES == tuple(rename_state(st)
                                        for st in RL.ALL_DEPLOY_STATES)


# GKE's accelerator label values -> the hardware table's keys; the
# reference maps GKE's TPU accelerator to a TPU generation the same way
GENERATIONS = {"nvidia-h100-80gb": "h100-sxm",
               "nvidia-h100-mega-80gb": "h100-sxm",
               "nvidia-a100-80gb": "a100-sxm", "nvidia-gb200": "gb200",
               "nvidia-tesla-a100": "", "tpu-v5p-slice": "", "": ""}


@pytest.mark.parametrize("value", sorted(GENERATIONS))
def test_accelerator_generation(value):
    from tpu_operator_torch.workloads.hardware import CHIPS

    got = L.accelerator_generation(value)
    assert got == GENERATIONS[value]
    assert got == "" or got in CHIPS


def test_install_surface_names():
    """The rows of ROADMAP.md §C for fleet telemetry and the install
    surface: CRD plurals and short names, the CLIs, the typed clientset,
    the chart's tree, the values key, the bench knobs and the goodput
    bar's generations."""
    import pathlib

    import torch_naming as N
    from tpu_operator.api import crd as rcrd
    from tpu_operator.api import versioned as rver
    from tpu_operator.deploy import helmchart as rhelm
    from tpu_operator.deploy import values as rvalues
    from tpu_operator.metrics import fleet as rfleet
    from tpu_operator_torch.api import crd, versioned
    from tpu_operator_torch.deploy import helmchart, values
    from tpu_operator_torch.metrics import fleet

    for rc, c in zip(rcrd.all_crds(), crd.all_crds()):
        rnames, names = rc["spec"]["names"], c["spec"]["names"]
        for key in ("plural", "singular"):
            assert names[key] == N.CRD_NAMES.get(rnames[key], rnames[key])
        assert names["shortNames"] == [N.CRD_NAMES.get(s, s)
                                       for s in rnames["shortNames"]]
    for ref, port in N.CLIENTSET.items():
        assert hasattr(rver, ref) or hasattr(rver.Clientset, ref) or \
            hasattr(rver.TpuV1alpha1, ref), ref
        assert hasattr(versioned, port) or hasattr(versioned.Clientset,
                                                   port) or \
            hasattr(versioned.GpuV1alpha1, port), port
        assert not hasattr(versioned, ref)
    root = pathlib.Path(__file__).resolve().parent.parent
    assert rhelm.CHART_DIR == root / N.CHART_DIR[0]
    assert helmchart.CHART_DIR == root / N.CHART_DIR[1]
    assert values.TOP_LEVEL_KEYS == {N.VALUES_KEYS.get(k, k)
                                     for k in rvalues.TOP_LEVEL_KEYS}
    text = (root / "pyproject.toml").read_text()
    for ref, port in N.CLIS.items():
        assert f"\n{ref} = " in text and f"\n{port} = " in text
    for ref, port in N.BENCH_ENV.items():
        assert ref.replace("TPUOP_", "GPUOP_") == port
    assert set(fleet.IDEAL_STEPS_PER_S) == {
        g for gens in N.GOODPUT_GENERATIONS.values() for g in gens}
    for ref_gen, gens in N.GOODPUT_GENERATIONS.items():
        for gen in gens:
            if ref_gen == "v5e":   # an H100 pool's bar, declared
                assert fleet.ideal_steps_per_s(gen) == 0.15
            else:
                assert fleet.ideal_steps_per_s(gen) == \
                    rfleet.ideal_steps_per_s(ref_gen)

"""The port's isolated plane (tpu_operator_torch.isolation: card fencing and
the vGPU manager, and the validator's fencing/vgpu proofs) against the
JAX package's (fencing, the vTPU manager, validate_fencing/validate_vtpu),
case for case on one fake host: four chips on each side (TPU_FAKE_CHIPS /
GPU_FAKE_CHIPS), both agents driven by the reference's ``FakeClient``.
Results are compared under accel<i> -> gpu<i>, vtpu -> vgpu and the label
renames of ``tpu_operator_torch.api.labels``."""

import json

import pytest

from tpu_operator.api import labels as RL
from tpu_operator.isolation import fencing as rfencing
from tpu_operator.isolation import vtpu as rvtpu
from tpu_operator.runtime import FakeClient
from tpu_operator.validator import barrier as rbarrier
from tpu_operator.validator import components as rcomponents
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.isolation import fencing, vgpu
from tpu_operator_torch.validator import barrier, components

NODE = "node-0"
REF_PROFILES = """
profiles:
  vtpu-2:
    description: halves
    vtpusPerChip: 2
  vtpu-4:
    vtpusPerChip: 4
    hbmMbPerVtpu: 3000
"""
PORT_PROFILES = """
profiles:
  vgpu-2:
    description: halves
    vgpusPerCard: 2
  vgpu-4:
    vgpusPerCard: 4
    memMbPerVgpu: 3000
"""
# reference label -> port label (the label keys these cases set)
LABEL_KEYS = {RL.FENCING_CONFIG: L.FENCING_CONFIG,
              RL.FENCING_STATE: L.FENCING_STATE,
              RL.WORKLOAD_CONFIG: L.WORKLOAD_CONFIG,
              RL.VTPU_CONFIG: L.VGPU_CONFIG,
              RL.VTPU_CONFIG_STATE: L.VGPU_CONFIG_STATE,
              RL.TPU_MEMORY_GB: L.GPU_MEMORY_GB}


def port(value):
    """A reference value under the port's names."""
    if isinstance(value, str):
        return value.replace("accel", "gpu").replace("vtpu", "vgpu") \
            .replace("vTPU", "vGPU")
    if isinstance(value, list):
        return [port(v) for v in value]
    if isinstance(value, dict):
        return {port(k): port(v) for k, v in value.items()}
    return value


@pytest.fixture
def host(tmp_path, monkeypatch):
    """Four fake chips a side and each package's hostPath files."""
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    env = {"TPU_FAKE_CHIPS": "4", "GPU_FAKE_CHIPS": "4",
           "TPU_FENCING_FILE": str(tmp_path / "ref" / "fencing.json"),
           "GPU_FENCING_FILE": str(tmp_path / "port" / "fencing.json"),
           "TPU_VTPU_FILE": str(tmp_path / "ref" / "vtpu-config.json"),
           "GPU_VGPU_FILE": str(tmp_path / "port" / "vgpu-config.json"),
           "TPU_VALIDATION_DIR": str(tmp_path / "ref" / "validations"),
           "GPU_VALIDATION_DIR": str(tmp_path / "port" / "validations")}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k in ("TPU_WORKLOAD_CONFIG", "GPU_WORKLOAD_CONFIG", "NODE_NAME",
              "TPU_DEFAULT_WORKLOAD_CONFIG", "GPU_DEFAULT_WORKLOAD_CONFIG",
              "TPU_CHIP_HBM_MB", "GPU_CARD_MEMORY_MB"):
        monkeypatch.delenv(k, raising=False)
    (tmp_path / "ref" / "profiles.yaml").write_text(REF_PROFILES)
    (tmp_path / "port" / "profiles.yaml").write_text(PORT_PROFILES)
    return tmp_path


def clients(labels):
    """One FakeClient a side, its node labelled ``labels`` (reference
    keys; the port's copy is renamed)."""
    ref, ours = FakeClient(), FakeClient()
    ref.add_node(NODE, labels=dict(labels))
    ours.add_node(NODE, labels={LABEL_KEYS[k]: port(v)
                                for k, v in labels.items()})
    return ref, ours


def node_labels(client):
    return client.get("v1", "Node", NODE)["metadata"].get("labels") or {}


# --- fence resolution -------------------------------------------------------


@pytest.mark.parametrize("config", ["all", "none", "", "accel1, accel2",
                                    "accel3,accel0", "accel9",
                                    "accel0,accel7"])
def test_resolve_fence_set(config):
    chips = [f"accel{i}" for i in range(4)]
    try:
        want = port(rfencing.resolve_fence_set(config, chips))
    except ValueError:
        with pytest.raises(ValueError, match=port(config.split(",")[-1])
                           .strip()):
            fencing.resolve_fence_set(port(config), port(chips))
        return
    assert fencing.resolve_fence_set(port(config), port(chips)) == want


# --- the fencing agent ------------------------------------------------------


@pytest.mark.parametrize("labels, default_workload, vtpu_left", [
    ({}, "isolated", False),
    ({RL.FENCING_CONFIG: "accel0,accel1"}, "isolated", False),
    ({RL.FENCING_CONFIG: "accel77"}, "isolated", True),
    ({RL.FENCING_CONFIG: "none"}, "isolated", False),
    ({RL.WORKLOAD_CONFIG: "isolated"}, "virtual", False),
    ({RL.WORKLOAD_CONFIG: "virtual"}, "isolated", True),
    ({}, "virtual", True),
], ids=["default-all", "explicit", "unknown-chip", "none",
        "isolated-withdraws-vtpu", "virtual-keeps-vtpu",
        "unlabelled-virtual-keeps-vtpu"])
def test_fencing_agent(host, labels, default_workload, vtpu_left):
    ref_c, port_c = clients(labels)
    ref_fence = str(host / "ref" / "fencing.json")
    port_fence = str(host / "port" / "fencing.json")
    for side in ("ref", "port"):
        (host / side / f"{'vtpu' if side == 'ref' else 'vgpu'}-config.json"
         ).write_text('{"profile": "x", "devices": []}')
    ref = rfencing.FencingAgent(ref_c, NODE, fencing_file=ref_fence,
                                default_workload=default_workload)
    ours = fencing.FencingAgent(port_c, NODE, fencing_file=port_fence,
                                default_workload=default_workload)
    state = ref.apply_once()
    assert ours.apply_once() == state
    assert node_labels(port_c)[L.FENCING_STATE] == \
        node_labels(ref_c)[RL.FENCING_STATE] == state
    assert fencing.read_fencing_file() == port(rfencing.read_fencing_file())
    assert fencing.fenced_chips() == port(rfencing.fenced_chips())
    assert (host / "port" / "vgpu-config.json").exists() == \
        (host / "ref" / "vtpu-config.json").exists() == vtpu_left


def test_cleanup_withdraws_fence_and_inventory(host):
    ref_c, port_c = clients({})
    agents = (rfencing.FencingAgent(ref_c, NODE, fencing_file=str(
                  host / "ref" / "fencing.json")),
              fencing.FencingAgent(port_c, NODE, fencing_file=str(
                  host / "port" / "fencing.json")))
    for agent, side, inv in zip(agents, ("ref", "port"), ("vtpu", "vgpu")):
        agent.apply_once()
        (host / side / f"{inv}-config.json").write_text("{}")
        agent.cleanup()
        assert not (host / side / "fencing.json").exists()
        assert not (host / side / f"{inv}-config.json").exists()
    assert fencing.read_fencing_file() is rfencing.read_fencing_file() is None


# --- the vGPU manager -------------------------------------------------------


def managers(host, ref_c, port_c, default="vtpu-2"):
    ref = rvtpu.VTPUDeviceManager(ref_c, NODE,
                                  str(host / "ref" / "profiles.yaml"),
                                  default_profile=default,
                                  vtpu_file=str(host / "ref" /
                                                "vtpu-config.json"))
    ours = vgpu.VGPUDeviceManager(port_c, NODE,
                                  str(host / "port" / "profiles.yaml"),
                                  default_profile=port(default),
                                  vgpu_file=str(host / "port" /
                                                "vgpu-config.json"))
    return ref, ours


def port_inventory(inv):
    """The reference's vTPU file under the port's keys."""
    if inv is None:
        return None
    out = port({k: v for k, v in inv.items() if k != "devices"})
    out["vgpus_per_card"] = out.pop("vgpus_per_chip")
    out["devices"] = [{"id": port(d["id"]), "chip": port(d["chip"]),
                       "mem_mb": d["hbm_mb"], "fraction": d["fraction"]}
                      for d in inv["devices"]]
    return out


def fence_both(host, chips):
    rfencing.write_fencing_file(str(host / "ref" / "fencing.json"), chips,
                                ",".join(chips))
    fencing.write_fencing_file(str(host / "port" / "fencing.json"),
                               port(chips), port(",".join(chips)))


def test_profiles_load(host):
    ref = rvtpu.load_vtpu_profiles(str(host / "ref" / "profiles.yaml"))
    ours = vgpu.load_vgpu_profiles(str(host / "port" / "profiles.yaml"))
    assert {port(k): (p.vtpus_per_chip, p.hbm_mb_per_vtpu, p.description)
            for k, p in ref.items()} == {
        k: (p.vgpus_per_card, p.mem_mb_per_vgpu, p.description)
        for k, p in ours.items()}
    (host / "empty.yaml").write_text("profiles: {}\n")
    with pytest.raises(ValueError, match="no profiles"):
        vgpu.load_vgpu_profiles(str(host / "empty.yaml"))


@pytest.mark.parametrize("profile, mem_mb", [
    (("vtpu-2", 2, None), 16384), (("vtpu-4", 4, 3000), 16384),
    (("vtpu-3", 3, None), 81920), (("vtpu-2", 2, None), None)])
def test_build_devices(profile, mem_mb):
    name, n, per = profile
    ref = rvtpu.build_vtpu_devices(["accel0", "accel2"],
                                   rvtpu.VTPUProfile(name, n, per), mem_mb)
    ours = vgpu.build_vgpu_devices(["gpu0", "gpu2"],
                                   vgpu.VGPUProfile(port(name), n, per),
                                   mem_mb)
    assert ours == [{"id": port(d["id"]), "chip": port(d["chip"]),
                     "mem_mb": d["hbm_mb"], "fraction": d["fraction"]}
                    for d in ref]


@pytest.mark.parametrize("labels, env, want", [
    ({}, "12000", 12000),
    ({RL.TPU_MEMORY_GB: "16"}, None, 16384),
    ({RL.TPU_MEMORY_GB: "95.5"}, None, 97792),
    ({}, None, None),
])
def test_card_memory_mb_follows_chip_hbm_mb(monkeypatch, labels, env, want):
    if env:
        monkeypatch.setenv("TPU_CHIP_HBM_MB", env)
        monkeypatch.setenv("GPU_CARD_MEMORY_MB", env)
    else:
        monkeypatch.delenv("TPU_CHIP_HBM_MB", raising=False)
        monkeypatch.delenv("GPU_CARD_MEMORY_MB", raising=False)
    assert rvtpu.chip_hbm_mb(labels) == want
    assert vgpu.card_memory_mb({LABEL_KEYS[k]: v for k, v in labels.items()}
                               ) == want


@pytest.mark.parametrize("labels, card_name", [
    ({L.GKE_ACCELERATOR: "nvidia-h100-80gb"}, ""),
    ({L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3"}, ""),
    ({}, "NVIDIA H100 80GB HBM3"),
    ({}, "NVIDIA H100 PCIe"),
])
def test_card_memory_mb_from_the_product(monkeypatch, labels, card_name):
    # the reference keys its table by GKE's TPU accelerator label; the
    # port by the product: its label, GKE's accelerator label, or NVML's
    # name of the node's cards
    monkeypatch.delenv("GPU_CARD_MEMORY_MB", raising=False)
    assert vgpu.card_memory_mb(labels, card_name) == 80 * 1024


def test_manager_pending_then_success(host):
    ref_c, port_c = clients({RL.TPU_MEMORY_GB: "16"})
    ref, ours = managers(host, ref_c, port_c)
    assert ours.apply_once() == ref.apply_once() == "pending"
    assert node_labels(port_c)[L.VGPU_CONFIG_STATE] == "pending"
    fence_both(host, ["accel0", "accel1"])
    assert ours.apply_once() == ref.apply_once() == "success"
    assert vgpu.read_vgpu_file() == port_inventory(rvtpu.read_vtpu_file())
    assert len(vgpu.read_vgpu_file()["devices"]) == 4
    assert node_labels(port_c)[L.VGPU_CONFIG_STATE] == \
        node_labels(ref_c)[RL.VTPU_CONFIG_STATE] == "success"


def test_manager_profile_from_label(host):
    ref_c, port_c = clients({RL.VTPU_CONFIG: "vtpu-4"})
    ref, ours = managers(host, ref_c, port_c)
    fence_both(host, ["accel3"])
    assert ours.apply_once() == ref.apply_once() == "success"
    inv = vgpu.read_vgpu_file()
    assert inv == port_inventory(rvtpu.read_vtpu_file())
    assert [d["id"] for d in inv["devices"]] == [f"gpu3-vgpu{j}"
                                                 for j in range(4)]
    assert {d["mem_mb"] for d in inv["devices"]} == {3000}


def test_empty_fence_withdraws_stale_inventory(host):
    ref_c, port_c = clients({})
    ref, ours = managers(host, ref_c, port_c)
    fence_both(host, ["accel0"])
    assert ours.apply_once() == ref.apply_once() == "success"
    fence_both(host, [])
    assert ours.apply_once() == ref.apply_once() == "pending"
    assert vgpu.read_vgpu_file() is rvtpu.read_vtpu_file() is None


def test_unknown_profile_fails(host):
    ref_c, port_c = clients({RL.VTPU_CONFIG: "nope"})
    ref, ours = managers(host, ref_c, port_c)
    fence_both(host, ["accel0"])
    assert ours.apply_once() == ref.apply_once() == "failed"
    assert node_labels(port_c)[L.VGPU_CONFIG_STATE] == "failed"
    assert vgpu.read_vgpu_file() is None


# --- the validator's proofs -------------------------------------------------


def prove(ref_fn, port_fn):
    """(reference's info or its failure, the port's), both status files."""
    out = []
    for fn, failure in ((ref_fn, rcomponents.ValidationFailed),
                        (port_fn, components.ValidationFailed)):
        try:
            out.append(fn())
        except failure as e:
            out.append(("failed", str(e)))
    return out


@pytest.mark.parametrize("fence", [None, [], ["accel0", "accel2"], ["accel9"],
                                   ["accel0", "accel1", "accel2", "accel3"]],
                         ids=["no-file", "empty", "two", "unknown", "all"])
def test_validate_fencing(host, fence):
    if fence is not None:
        fence_both(host, fence)
    ref, ours = prove(rcomponents.validate_fencing,
                      components.validate_fencing)
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple) and ours[1] == port(ref[1])
        assert not barrier.is_ready("fencing-ready")
        return
    assert ours == port(ref)
    assert barrier.read_status("fencing-ready") == port(
        rbarrier.read_status("fencing-ready"))


def vgpu_renamed(info):
    if isinstance(info, tuple):
        return info[0], port(info[1])
    return {("VGPU_COUNT" if k == "VTPU_COUNT" else k): port(v)
            for k, v in info.items()}


@pytest.mark.parametrize("config, fence, backing", [
    ("isolated", ["accel0"], ["accel0"]),
    ("virtual", ["accel0", "accel1"], ["accel0", "accel1"]),
    ("virtual", ["accel0"], ["accel0", "accel1"]),
    ("virtual", ["accel0"], None),
    ("", ["accel0"], None),
    ("", ["accel0"], ["accel0"]),
], ids=["isolated-skips", "virtual", "stray-backing", "no-inventory",
        "unknown-config", "unknown-config-with-inventory"])
def test_validate_vgpu_against_validate_vtpu(host, monkeypatch, config,
                                             fence, backing):
    if config:
        monkeypatch.setenv("TPU_WORKLOAD_CONFIG", config)
        monkeypatch.setenv("GPU_WORKLOAD_CONFIG", config)
    fence_both(host, fence)
    if backing is not None:
        devs = rvtpu.build_vtpu_devices(backing, rvtpu.VTPUProfile(
            "vtpu-2", 2), 16384)
        inv = {"profile": "vtpu-2", "vtpus_per_chip": 2, "devices": devs}
        (host / "ref" / "vtpu-config.json").write_text(json.dumps(inv))
        (host / "port" / "vgpu-config.json").write_text(
            json.dumps(port_inventory(inv)))
    ref, ours = prove(rcomponents.validate_vtpu, components.validate_vgpu)
    assert vgpu_renamed(ref) == ours
    assert barrier.is_ready("vgpu-ready") == rbarrier.is_ready("vtpu-ready")

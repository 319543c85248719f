"""The port's feature discovery (tpu_operator_torch.featurediscovery)
against the JAX package's: the labels it owns under the renames
(tpu.accelerator -> gpu.product, tpu.memory-gb -> gpu.memory-gb,
tpu.ici-gbps -> gpu.nvlink-gbps, libtpu.version -> driver.version,
tpu.topology -> gpu.topology, tpu.multihost -> gpu.multihost), stale keys
removed, and both agents patching only the delta on the reference's
``FakeClient``. The values are each package's hardware: a v5e or v5p
slice for the reference, an H100 for the port, whose topology comes from
the NVLink facts of its inventory (or GPU_TOPOLOGY, as the reference
reads TPU_TOPOLOGY)."""

import pytest

from tpu_operator.api import labels as RL
from tpu_operator.featurediscovery import agent as ragent
from tpu_operator.runtime import FakeClient
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.deviceplugin.plugin import Card, Fabric, Inventory
from tpu_operator_torch.featurediscovery import agent

RENAMES = {RL.TPU_ACCELERATOR: L.GPU_PRODUCT,
           RL.TPU_MEMORY_GB: L.GPU_MEMORY_GB,
           RL.TPU_ICI_GBPS: L.GPU_NVLINK_GBPS,
           RL.LIBTPU_VERSION: L.DRIVER_VERSION,
           RL.TPU_TOPOLOGY: L.GPU_TOPOLOGY,
           RL.TPU_MULTIHOST: L.GPU_MULTIHOST}
SWITCHED = tuple((ln, "nvswitch") for ln in range(18))
ONE_HOST = Fabric("00000000-0000-0000-0000-000000000000", 0, "completed", 0)
CLUSTER = Fabric("5b0e8f3c-1d2a-4c6e-9f70-0a1b2c3d4e5f", 7, "completed", 0)


def inventory(name="", driver="", nvlink=None, fabric=None):
    return Inventory(tuple(Card(f"gpu{i}", i, f"GPU-{i}", i, name,
                                nvlink=nvlink, fabric=fabric)
                           for i in range(4)), driver)


def renamed_keys(want):
    return {RENAMES[k]: v is None for k, v in want.items()}


@pytest.fixture(autouse=True)
def fake_chips(monkeypatch):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "4")
    monkeypatch.delenv("TPU_TOPOLOGY", raising=False)
    monkeypatch.delenv("GPU_TOPOLOGY", raising=False)


@pytest.mark.parametrize("ref_case, port_case, want", [
    (({RL.GKE_TPU_ACCELERATOR: "tpu-v5-lite-podslice",
       RL.GKE_TPU_TOPOLOGY: "2x4"}, {"count": 4}),
     ({L.GKE_ACCELERATOR: "nvidia-h100-80gb"},
      inventory(nvlink=SWITCHED, fabric=ONE_HOST)),
     {L.GPU_PRODUCT: "nvidia-h100-80gb", L.GPU_MEMORY_GB: "80",
      L.GPU_NVLINK_GBPS: "450", L.GPU_TOPOLOGY: "nvswitch-4",
      L.GPU_MULTIHOST: "false"}),
    (({RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
       RL.GKE_TPU_TOPOLOGY: "4x4x4"}, {"count": 4}),
     ({}, inventory("NVIDIA H100 80GB HBM3", nvlink=SWITCHED,
                    fabric=CLUSTER)),
     {L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3", L.GPU_MEMORY_GB: "80",
      L.GPU_NVLINK_GBPS: "450", L.GPU_TOPOLOGY: "mnnvl-4",
      L.GPU_MULTIHOST: "true"}),
    (({RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice"},
      {"count": 4, "libtpu_version": "2.9.0"}),
     ({}, inventory("NVIDIA H100 80GB HBM3", "580.159.03")),
     {L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3", L.GPU_MEMORY_GB: "80",
      L.GPU_NVLINK_GBPS: "450", L.DRIVER_VERSION: "580.159.03"}),
    (({RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice"}, {"count": 4}),
     ({}, inventory("NVIDIA H100 PCIe")),
     {L.GPU_PRODUCT: "NVIDIA-H100-PCIe", L.GPU_MEMORY_GB: "80",
      L.GPU_NVLINK_GBPS: "64"}),
    (({RL.GKE_TPU_ACCELERATOR: "tpu-v9-unknown"}, {"count": 4}),
     ({}, inventory("NVIDIA A100-SXM4-80GB")),
     {L.GPU_PRODUCT: "NVIDIA-A100-SXM4-80GB"}),
], ids=["gke-label", "multi-host", "nvml-name-and-driver", "pcie",
        "unknown-product"])
def test_compute_feature_labels(ref_case, port_case, want):
    ref = ragent.compute_feature_labels(*ref_case)
    got = agent.compute_feature_labels(*port_case)
    assert got == want
    assert renamed_keys(ref) == {k: v is None for k, v in got.items()}


@pytest.mark.parametrize("have", [
    {RL.TPU_TOPOLOGY: "2x2", RL.LIBTPU_VERSION: "old"},
    {RL.TPU_ACCELERATOR: "x", RL.TPU_MEMORY_GB: "16", RL.TPU_ICI_GBPS: "1"},
    {RL.TPU_MULTIHOST: "true", RL.TPU_TOPOLOGY: "4x4x4"},
    {"unrelated/label": "kept"},
])
def test_stale_labels_removed(have):
    ref = ragent.compute_feature_labels(have, {"count": 0})
    got = agent.compute_feature_labels(
        {RENAMES.get(k, k): v for k, v in have.items()}, Inventory())
    assert got == {k: None for k in renamed_keys(ref)}
    assert all(v is None for v in got.values())


@pytest.mark.parametrize("text, want", [
    ("NVIDIA H100 80GB HBM3", "NVIDIA-H100-80GB-HBM3"),
    ("  spaced  out ", "spaced-out"),
    ("a/b:c", "a-b-c"),
    ("x" * 70, "x" * 63),
    ("580.159.03", "580.159.03"),
])
def test_label_value(text, want):
    assert agent.label_value(text) == want


def test_agents_patch_the_delta_and_converge(monkeypatch):
    from tpu_operator_torch.deviceplugin import plugin

    monkeypatch.setattr(plugin, "card_inventory",
                        lambda: inventory("NVIDIA H100 80GB HBM3", "580.1",
                                          nvlink=SWITCHED, fabric=ONE_HOST))
    ref_c, port_c = FakeClient(), FakeClient()
    ref_c.add_node("n1", labels={RL.GKE_TPU_ACCELERATOR:
                                 "tpu-v5-lite-podslice",
                                 RL.GKE_TPU_TOPOLOGY: "2x4",
                                 RL.LIBTPU_VERSION: "stale"})
    port_c.add_node("n1", labels={L.DRIVER_VERSION: "stale"})
    ref = ragent.FeatureDiscovery(client=ref_c, node_name="n1")
    ours = agent.FeatureDiscovery(client=port_c, node_name="n1")
    ref_c.reset_verb_counts()
    port_c.reset_verb_counts()
    rdelta, delta = ref.apply_once(), ours.apply_once()
    assert set(delta) == {RENAMES[k] for k in rdelta}
    assert delta[L.DRIVER_VERSION] == "580.1"
    assert ref.apply_once() == ours.apply_once() == {}
    # a get each apply, and one patch: the first delta
    assert port_c.reset_verb_counts() == ref_c.reset_verb_counts() == {
        "get": 2, "patch": 1}
    labels = port_c.get("v1", "Node", "n1")["metadata"]["labels"]
    assert labels[L.GPU_PRODUCT] == "NVIDIA-H100-80GB-HBM3"
    assert (labels[L.GPU_TOPOLOGY], labels[L.GPU_MULTIHOST]) == (
        "nvswitch-4", "false")


@pytest.mark.parametrize("ref_topo, port_topo, multihost", [
    ("2x2x1", "nvswitch-8", "false"),
    ("4x4x4", "mnnvl-4", "true"),
])
def test_topology_env_overrides_nvml(monkeypatch, ref_topo, port_topo,
                                     multihost):
    """GPU_TOPOLOGY wins over NVML's fabric, as TPU_TOPOLOGY stands in
    where GKE names none; multihost follows the value stamped."""
    monkeypatch.setenv("TPU_TOPOLOGY", ref_topo)
    monkeypatch.setenv("GPU_TOPOLOGY", port_topo)
    ref = ragent.compute_feature_labels(
        {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice"}, {"count": 4})
    got = agent.compute_feature_labels(
        {}, inventory("NVIDIA H100 80GB HBM3", nvlink=SWITCHED,
                      fabric=ONE_HOST))
    assert got[L.GPU_TOPOLOGY] == port_topo
    assert got[L.GPU_MULTIHOST] == multihost == ref[RL.TPU_MULTIHOST]
    assert renamed_keys(ref) == {k: v is None for k, v in got.items()}

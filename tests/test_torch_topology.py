"""The port's card-group manager (tpu_operator_torch.topology.manager)
against the JAX package's slice manager, both on the reference's
``FakeClient`` over fleets that map one to one (a TPU node of
``tpu-v5p-slice`` to an H100 node; topology 2x2x1, a single host, to
``nvswitch-4``; 4x4x4, a multi-host slice, to ``mnnvl-4``; GKE's nodepool
label as it is; chip IDs ``accel<i>`` to ``gpu<i>``): the states, the
slice files, the verbs; the profiles' errors; the contiguous split; and
the port's device plugin reading the file the manager writes."""

import json

import pytest

from tpu_operator.api import labels as RL
from tpu_operator.deviceplugin import plugin as rplugin
from tpu_operator.runtime import FakeClient
from tpu_operator.topology import manager as rmanager
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.deviceplugin import plugin
from tpu_operator_torch.topology import manager

# the reference's ConfigMap (manifests/state-topology-manager/0300_config_map.yaml)
PROFILES_YAML = """
version: v1
profiles:
  full:
    description: one slice spanning all chips on the node
    subslices: 1
  split-2:
    description: two equal sub-slices
    subslices: 2
  split-4:
    description: four equal sub-slices
    subslices: 4
"""
TOPOLOGIES = {"2x2x1": "nvswitch-4", "4x4x4": "mnnvl-4"}


@pytest.fixture
def config_file(tmp_path):
    p = tmp_path / "config.yaml"
    p.write_text(PROFILES_YAML)
    return str(p)


@pytest.fixture(params=["nvml-finds-none", "nvml-finds-four"])
def discovery(request, monkeypatch, tmp_path):
    """Discovery that finds no card (the managers synthesize IDs from the
    count), or four (TPU_FAKE_CHIPS / GPU_FAKE_CHIPS)."""
    for k in ("TPU_FAKE_CHIPS", "GPU_FAKE_CHIPS", "GPU_TOPOLOGY"):
        monkeypatch.delenv(k, raising=False)
    if request.param == "nvml-finds-four":
        monkeypatch.setenv("TPU_FAKE_CHIPS", "4")
        monkeypatch.setenv("GPU_FAKE_CHIPS", "4")
    else:
        monkeypatch.setenv("GPU_TELEMETRY_BIN", str(tmp_path / "absent"))
    return request.param


class Fleet:
    """One fleet on two FakeClients: the reference's TPU nodes and the
    port's GPU nodes."""

    def __init__(self):
        self.ref, self.port = FakeClient(), FakeClient()

    def add(self, name, topology="2x2x1", slice_config=None, chips="4",
            nodepool=None):
        rl = {RL.GKE_TPU_ACCELERATOR: "tpu-v5p-slice",
              RL.GKE_TPU_TOPOLOGY: topology, RL.TPU_CHIP_COUNT: chips}
        pl = {L.GPU_PRODUCT: "NVIDIA-H100-80GB-HBM3",
              L.GPU_TOPOLOGY: TOPOLOGIES[topology], L.GPU_CHIP_COUNT: chips}
        if slice_config:
            rl[RL.SLICE_CONFIG] = pl[L.SLICE_CONFIG] = slice_config
        if nodepool:
            rl[RL.GKE_NODEPOOL] = pl[L.GKE_NODEPOOL] = nodepool
        self.ref.add_node(name, labels=rl,
                          allocatable={"google.com/tpu": chips})
        self.port.add_node(name, labels=pl,
                           allocatable={"nvidia.com/gpu": chips})

    def ask(self, name, profile):
        self.ref.patch("v1", "Node", name, {"metadata": {"labels": {
            RL.SLICE_CONFIG: profile}}})
        self.port.patch("v1", "Node", name, {"metadata": {"labels": {
            L.SLICE_CONFIG: profile}}})

    def states(self, name):
        r = self.ref.get("v1", "Node", name)["metadata"]["labels"]
        p = self.port.get("v1", "Node", name)["metadata"]["labels"]
        return r.get(RL.SLICE_CONFIG_STATE), p.get(L.SLICE_CONFIG_STATE)


def gpu_ids(doc):
    """A reference slice file under the card-ID rename."""
    if doc is None:
        return None
    return dict(doc, groups=[[c.replace("accel", "gpu") for c in g]
                             for g in doc["groups"]])


def managers(fleet, name, config_file, tmp_path):
    return (rmanager.TopologyManager(fleet.ref, name, config_file,
                                     slice_file=str(tmp_path / "ref.json")),
            manager.TopologyManager(fleet.port, name, config_file,
                                    slice_file=str(tmp_path / "port.json")))


# (nodes, the node managed, [(peer asks profile) before a pass, ...]):
# tests/test_topology.py's cases, and the peers' and counts' edges
CASES = {
    "apply-profile": ([("tpu-0", "2x2x1", "split-2", "4", None)], "tpu-0",
                      [None]),
    "default-profile": ([("tpu-0", "2x2x1", None, "4", None)], "tpu-0",
                        [None]),
    "unknown-profile": ([("tpu-0", "2x2x1", "nope", "4", None)], "tpu-0",
                        [None]),
    "indivisible": ([("tpu-0", "2x2x1", "split-4", "2", None)], "tpu-0",
                    [None]),
    "no-cards": ([("tpu-0", "2x2x1", "full", "0", None)], "tpu-0", [None]),
    "independent-pools": ([("a-0", "4x4x4", "split-2", "4", "pool-a"),
                           ("b-0", "4x4x4", "full", "4", "pool-b")], "a-0",
                          [None]),
    "multi-host-waits": ([("host-0", "4x4x4", "split-2", "4", None),
                          ("host-1", "4x4x4", "full", "4", None)], "host-0",
                         [None, ("host-1", "split-2")]),
    "multi-host-default": ([("host-0", "4x4x4", None, "4", "p"),
                            ("host-1", "4x4x4", "split-4", "4", "p"),
                            ("host-2", "4x4x4", "split-4", "4", "q")],
                           "host-0", [None, ("host-1", "full")]),
    "one-host-ignores-peers": ([("s-0", "2x2x1", "split-2", "4", None),
                                ("s-1", "2x2x1", "full", "4", None)], "s-0",
                               [None]),
    "peer-without-nodepool": ([("m-0", "4x4x4", "split-2", "4", "p"),
                               ("m-1", "4x4x4", "full", "4", None)], "m-0",
                              [None]),
    "unknown-then-agree": ([("h-0", "4x4x4", "split-4", "4", None),
                            ("h-1", "4x4x4", "split-2", "4", None)], "h-0",
                           [None, ("h-0", "nope"), ("h-0", "split-2")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_manager_matches_the_reference(case, discovery, config_file,
                                       tmp_path):
    nodes, name, steps = CASES[case]
    fleet = Fleet()
    for spec in nodes:
        fleet.add(*spec)
    ref, port = managers(fleet, name, config_file, tmp_path)
    for step in steps:
        if step:
            fleet.ask(*step)
        fleet.ref.reset_verb_counts()
        fleet.port.reset_verb_counts()
        want = ref.apply_once()
        assert port.apply_once() == want
        assert fleet.states(name) == (want, want)
        assert fleet.port.reset_verb_counts() == \
            fleet.ref.reset_verb_counts()
        assert manager.read_slice_file(port.slice_file) == \
            gpu_ids(rmanager.read_slice_file(ref.slice_file))
    assert want in (manager.STATE_SUCCESS, manager.STATE_PENDING,
                    manager.STATE_FAILED)


def test_the_reference_cases_states(discovery, config_file, tmp_path):
    """The states tests/test_topology.py pins, on the port alone."""
    want = {"apply-profile": ["success"], "default-profile": ["success"],
            "unknown-profile": ["failed"], "independent-pools": ["success"],
            "multi-host-waits": ["pending", "success"],
            "indivisible": ["failed" if discovery == "nvml-finds-none"
                            else "success"]}
    for case, states in want.items():
        nodes, name, steps = CASES[case]
        fleet = Fleet()
        for spec in nodes:
            fleet.add(*spec)
        port = managers(fleet, name, config_file, tmp_path / case)[1]
        got = []
        for step in steps:
            if step:
                fleet.ask(*step)
            got.append(port.apply_once())
        assert got == states, case
    doc = manager.read_slice_file(str(tmp_path / "apply-profile" /
                                      "port.json"))
    assert doc == {"profile": "split-2", "subslices": 2,
                   "groups": [["gpu0", "gpu1"], ["gpu2", "gpu3"]]}


def test_card_count_falls_back_to_allocatable(config_file, tmp_path,
                                              monkeypatch):
    monkeypatch.delenv("GPU_FAKE_CHIPS", raising=False)
    monkeypatch.setenv("GPU_TELEMETRY_BIN", str(tmp_path / "absent"))
    c = FakeClient()
    c.add_node("n", labels={L.SLICE_CONFIG: "split-2"},
               allocatable={"nvidia.com/gpu": "2"})
    m = manager.TopologyManager(c, "n", config_file,
                                slice_file=str(tmp_path / "s.json"))
    assert m.apply_once() == manager.STATE_SUCCESS
    assert manager.read_slice_file(m.slice_file)["groups"] == [["gpu0"],
                                                               ["gpu1"]]


# --- the profiles, the split and the file ------------------------------------


@pytest.mark.parametrize("text", [
    "profiles:\n  good:\n    subslices: 2\n  broken:\n    subslices: two\n",
    "profiles:\n  good:\n    subslices: 1\n  scalar: 3\n",
    "profiles:\n  empty:\n    subslices: 0\n",
    "profiles:\n  flag:\n    subslices: true\n",
    "profiles: {}\n",
    "version: v1\n",
], ids=["non-integer", "non-mapping", "zero", "bool", "none", "no-key"])
def test_profile_errors_match(tmp_path, text):
    p = tmp_path / "config.yaml"
    p.write_text(text)
    with pytest.raises(ValueError) as want:
        rmanager.load_profiles(str(p))
    with pytest.raises(ValueError) as got:
        manager.load_profiles(str(p))
    assert str(got.value) == str(want.value)


def test_profiles_match(config_file):
    ref = rmanager.load_profiles(config_file)
    got = manager.load_profiles(config_file)
    assert {k: vars(v) for k, v in got.items()} == \
        {k: vars(v) for k, v in ref.items()}


@pytest.mark.parametrize("n", range(1, 17))
def test_chip_groups_match(n):
    ids = [f"gpu{i}" for i in range(n)]
    for k in range(1, 9):
        try:
            want = rmanager.chip_groups([f"accel{i}" for i in range(n)], k)
        except ValueError:
            with pytest.raises(ValueError, match=f"cannot split {n} cards"):
                manager.chip_groups(ids, k)
            continue
        assert manager.chip_groups(ids, k) == gpu_ids(
            {"groups": want})["groups"]


def test_slice_file_round_trip(tmp_path):
    path = str(tmp_path / "run" / "slice-config.json")
    profile = manager.Profile("split-2", 2)
    manager.write_slice_file(path, profile, [["gpu0"], ["gpu1"]])
    rmanager.write_slice_file(str(tmp_path / "ref.json"),
                              rmanager.Profile("split-2", 2),
                              [["gpu0"], ["gpu1"]])
    assert open(path).read() == (tmp_path / "ref.json").read_text()
    assert not (tmp_path / "run" / "slice-config.tmp").exists()
    assert manager.read_slice_file(path) == rmanager.read_slice_file(path)
    (tmp_path / "bad.json").write_text("{")
    assert manager.read_slice_file(str(tmp_path / "bad.json")) is None
    assert manager.read_slice_file(str(tmp_path / "absent.json")) is None


# --- the device plugin reads what the manager writes -------------------------


def test_plugin_serves_the_managers_groups(config_file, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("TPU_SLICE_FILE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("GPU_SLICE_FILE", str(tmp_path / "port.json"))
    monkeypatch.delenv("SHARING_REPLICAS", raising=False)
    monkeypatch.setenv("GPU_FENCING_FILE", str(tmp_path / "no-fence.json"))
    monkeypatch.setenv("TPU_FENCING_FILE", str(tmp_path / "no-fence.json"))
    fleet = Fleet()
    fleet.add("n", slice_config="split-2")
    ref, port = managers(fleet, "n", config_file, tmp_path)
    assert ref.apply_once() == port.apply_once() == manager.STATE_SUCCESS
    assert [d.ID for d in plugin.discover_devices()] == \
        [d.ID for d in rplugin.discover_devices()] == ["slice0", "slice1"]
    assert plugin.slice_groups() == {
        k: [c.replace("accel", "gpu") for c in v]
        for k, v in rplugin.slice_groups().items()}
    alloc = plugin.GpuDevicePlugin(socket_dir="/nonexistent").allocate(
        ["slice1"])
    assert alloc.envs["NVIDIA_VISIBLE_DEVICES"] == ",".join(
        [plugin.fake_uuid(2), plugin.fake_uuid(3)])
    assert [d.host_path for d in alloc.devices][:2] == ["/dev/nvidia2",
                                                         "/dev/nvidia3"]
    assert rplugin.expand_to_chips(["slice1"]) == ["accel2", "accel3"]
    # back to full: the plugin advertises each card again
    fleet.ask("n", "full")
    assert port.apply_once() == manager.STATE_SUCCESS
    assert [d.ID for d in plugin.discover_devices()] == [
        f"gpu{i}" for i in range(4)]
    assert json.loads((tmp_path / "port.json").read_text())["groups"] == [
        [f"gpu{i}" for i in range(4)]]

"""The port's node agents (tpu_operator_torch.cli.node_agents), its NVML
card inventory (``gpu-telemetry --inventory``) and the in-cluster client's
node verbs, on the CPU.

``gpu-telemetry`` is built with the host compiler against a fake
``libnvidia-ml.so.1`` this file compiles from C (cards with UUIDs, minor
numbers that are not their indices, a driver version), and the driver
agent loads a fake ``libcuda.so.1`` exporting ``cuDriverGetVersion``,
built with ``gcc`` as the reference's tests build their fake
``libtpu.so``. The agents are held to the reference's: the driver agent
opens the same gate as ``libtpu-install``, preflight closes every gate
of each package, and the runtime contract lists the same cards under
/dev/accel<i> -> /dev/nvidia<minor>."""

import json
import os
import subprocess
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tpu_operator.cli import node_agents as ragents
from tpu_operator.validator import barrier as rbarrier
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.cli import node_agents as agents
from tpu_operator_torch.deviceplugin import plugin
from tpu_operator_torch.kernels import build
from tpu_operator_torch.runtime import kubeclient
from tpu_operator_torch.validator import barrier

# a fake NVML with the inventory's entry points: FAKE_NVML_CARDS cards
# (default 2), minor number 4 + index, UUID GPU-fake-<i> (refused for the
# index in FAKE_NVML_NO_UUID), driver FAKE_NVML_DRIVER (refused under
# FAKE_NVML_NO_DRIVER); FAKE_NVML_INIT_FAIL fails nvmlInit_v2
FAKE_NVML_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
typedef struct { unsigned long long total, free, used; } mem_t;
typedef struct { unsigned int gpu, memory; } util_t;
static unsigned int index_of(void* h) { return (unsigned) (unsigned long) h - 1; }
int nvmlInit_v2(void) { return getenv("FAKE_NVML_INIT_FAIL") ? 9 : 0; }
const char* nvmlErrorString(int rc) { return rc ? "Not Supported" : "Success"; }
int nvmlDeviceGetCount_v2(unsigned int* n) {
  const char* s = getenv("FAKE_NVML_CARDS");
  *n = s ? (unsigned) atoi(s) : 2;
  return 0;
}
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** h) {
  *h = (void*) (unsigned long) (i + 1);
  return 0;
}
int nvmlDeviceGetMemoryInfo(void* h, mem_t* m) {
  m->total = 80ULL << 30; m->used = 1ULL << 30; m->free = m->total - m->used;
  return 0;
}
int nvmlDeviceGetUtilizationRates(void* h, util_t* u) { u->gpu = 0; return 0; }
int nvmlDeviceGetTemperature(void* h, int s, unsigned int* t) { *t = 40; return 0; }
int nvmlSystemGetDriverVersion(char* v, unsigned int n) {
  if (getenv("FAKE_NVML_NO_DRIVER")) return 3;
  const char* s = getenv("FAKE_NVML_DRIVER");
  snprintf(v, n, "%s", s ? s : "550.54.15");
  return 0;
}
int nvmlDeviceGetUUID(void* h, char* v, unsigned int n) {
  const char* s = getenv("FAKE_NVML_NO_UUID");
  if (s && (unsigned) atoi(s) == index_of(h)) return 3;
  snprintf(v, n, "GPU-fake-%u", index_of(h));
  return 0;
}
int nvmlDeviceGetMinorNumber(void* h, unsigned int* m) {
  *m = 4 + index_of(h);
  return 0;
}
int nvmlDeviceGetName(void* h, char* v, unsigned int n) {
  snprintf(v, n, "NVIDIA H100 80GB HBM3");
  return 0;
}
"""
# a fake user-space driver: cuDriverGetVersion gives 12040, or returns
# FAKE_CUDA_RC when that is set
FAKE_LIBCUDA_C = r"""
#include <stdlib.h>
int cuDriverGetVersion(int* v) {
  const char* rc = getenv("FAKE_CUDA_RC");
  if (rc) return atoi(rc);
  *v = 12040;
  return 0;
}
"""


def compile_c(code, src, out):
    src.write_text(code)
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(out), str(src)],
                   check=True, capture_output=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(gpu-telemetry, fake NVML, a directory holding a fake libcuda)."""
    d = tmp_path_factory.mktemp("nvml")
    nvml = d / "libnvidia-ml.so.1"
    compile_c(FAKE_NVML_C, d / "fake_nvml.c", nvml)
    drv = d / "driver"
    drv.mkdir()
    compile_c(FAKE_LIBCUDA_C, d / "fake_cuda.c", drv / "libcuda.so.1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "BUILD_DIR", d / "kernels")
        binary = build.build_host("gpu_telemetry").path
    return str(binary), str(nvml), drv


@pytest.fixture
def nvml(monkeypatch, built, tmp_path):
    binary, lib, drv = built
    for k in ("GPU_FAKE_CHIPS", "TPU_FAKE_CHIPS", "FAKE_NVML_CARDS",
              "FAKE_NVML_INIT_FAIL", "FAKE_NVML_NO_DRIVER",
              "FAKE_NVML_NO_UUID", "FAKE_NVML_DRIVER", "FAKE_CUDA_RC",
              "GPU_DRIVER_VERSION", "DEVICE_PATH_GLOB", "GPU_TOPOLOGY",
              "TPU_TOPOLOGY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GPU_TELEMETRY_BIN", binary)
    monkeypatch.setenv("GPU_TELEMETRY_NVML", lib)
    monkeypatch.setenv("INSTALL_DIR", str(drv))
    monkeypatch.setenv("GPU_VALIDATION_DIR", str(tmp_path / "port" / "v"))
    monkeypatch.setenv("TPU_VALIDATION_DIR", str(tmp_path / "ref" / "v"))
    return drv


# --- the NVML inventory -----------------------------------------------------


def test_inventory_json(nvml):
    out = subprocess.run([os.environ["GPU_TELEMETRY_BIN"], "--inventory"],
                         capture_output=True, text=True, timeout=10)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["driver_version"] == "550.54.15"
    # this fake NVML has no NVLink entry points: their fields are missing,
    # and the calls named as absent
    assert doc["cards"] == [
        {"chip_id": f"gpu{i}", "index": i, "uuid": f"GPU-fake-{i}",
         "minor": 4 + i, "name": "NVIDIA H100 80GB HBM3",
         "memory_total_bytes": 80 << 30, "nvlink": None,
         "nvlink_peers": None, "fabric": None,
         "refused": {"nvmlDeviceGetNvLinkState": None,
                     "nvmlDeviceGetP2PStatus": None,
                     "nvmlDeviceGetGpuFabricInfoV": None}}
        for i in range(2)]


def test_inventory_names_cards_by_index_and_mounts_by_minor(nvml,
                                                             monkeypatch):
    monkeypatch.setenv("FAKE_NVML_CARDS", "3")
    inv = plugin.card_inventory()
    assert [(c.id, c.uuid, c.minor) for c in inv.cards] == [
        (f"gpu{i}", f"GPU-fake-{i}", 4 + i) for i in range(3)]
    assert plugin.discover_chips() == ["gpu0", "gpu1", "gpu2"]
    alloc = plugin.GpuDevicePlugin(socket_dir="/nonexistent").allocate(
        ["gpu2", "gpu0"])
    assert [d.host_path for d in alloc.devices] == [
        "/dev/nvidia6", "/dev/nvidia4", *plugin.CONTROL_NODES]
    assert alloc.envs == {"NVIDIA_VISIBLE_DEVICES": "GPU-fake-2,GPU-fake-0"}


def test_a_card_without_a_uuid_is_listed_but_not_allocated(nvml,
                                                           monkeypatch):
    monkeypatch.setenv("FAKE_NVML_NO_UUID", "1")
    inv = plugin.card_inventory()
    assert [c.uuid for c in inv.cards] == ["GPU-fake-0", None]
    p = plugin.GpuDevicePlugin(socket_dir="/nonexistent")
    with pytest.raises(plugin.DeviceNotFound, match="no UUID"):
        p.allocate(["gpu1"])
    assert p.allocate(["gpu0"]).envs["NVIDIA_VISIBLE_DEVICES"] == \
        "GPU-fake-0"


@pytest.mark.parametrize("broken", ["init-fails", "no-library"])
def test_no_nvml_no_cards(nvml, monkeypatch, tmp_path, broken):
    if broken == "init-fails":
        monkeypatch.setenv("FAKE_NVML_INIT_FAIL", "1")
    else:
        monkeypatch.setenv("GPU_TELEMETRY_NVML", str(tmp_path / "none.so"))
    assert plugin.card_inventory() == plugin.Inventory()
    assert plugin.discover_chips() == []
    assert agents.runtime_setup_main(["run", "--no-park"]) == 1


# --- gpu-driver-install (libtpu-install's slot) ----------------------------


def fake_libtpu(tmp_path, monkeypatch):
    src = tmp_path / "bundle" / "stable"
    src.mkdir(parents=True)
    (src / "lib.c").write_text("int libtpu_fake_symbol(void){return 42;}\n")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(src / "libtpu.so"),
                    str(src / "lib.c")], check=True)
    monkeypatch.setenv("LIBTPU_SRC", str(tmp_path / "bundle"))
    monkeypatch.setenv("LIBTPU_CHANNEL", "stable")


def test_driver_install_opens_the_gate(nvml, monkeypatch, tmp_path):
    fake_libtpu(tmp_path, monkeypatch)
    with monkeypatch.context() as m:
        m.setenv("INSTALL_DIR", str(tmp_path / "host-bin"))
        assert ragents.libtpu_install_main(["run", "--no-park"]) == 0
    assert agents.main(["gpu-driver-install", "run", "--no-park"]) == 0
    assert rbarrier.is_ready(".driver-ctr-ready")
    assert barrier.read_status(".driver-ctr-ready") == {
        "LIBCUDA_PATH": str(nvml / "libcuda.so.1"),
        "DRIVER_VERSION": "550.54.15", "CUDA_DRIVER_VERSION": "12040"}


@pytest.mark.parametrize("env, ok", [
    ({"GPU_DRIVER_VERSION": "550.54.15"}, True),
    ({"GPU_DRIVER_VERSION": "535.1"}, False),
    ({"FAKE_CUDA_RC": "3"}, False),
    ({"FAKE_NVML_NO_DRIVER": "1"}, False),
    ({"FAKE_NVML_INIT_FAIL": "1"}, False),
], ids=["pinned-match", "pinned-other", "cuDriverGetVersion-fails",
        "nvml-no-version", "nvml-down"])
def test_driver_verify(nvml, monkeypatch, env, ok):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert agents.driver_install_main(["verify"]) == (0 if ok else 1)
    assert barrier.is_ready(".driver-ctr-ready") == ok


def test_driver_found_under_lib64(nvml, monkeypatch, tmp_path):
    (tmp_path / "root" / "lib64").mkdir(parents=True)
    os.link(nvml / "libcuda.so.1", tmp_path / "root" / "lib64" /
            "libcuda.so.1")
    monkeypatch.setenv("INSTALL_DIR", str(tmp_path / "root"))
    assert agents.driver_install_main(["verify"]) == 0
    assert barrier.read_status(".driver-ctr-ready")["LIBCUDA_PATH"] == str(
        tmp_path / "root" / "lib64" / "libcuda.so.1")


def test_no_driver_fails_like_no_libtpu(nvml, monkeypatch, tmp_path):
    monkeypatch.setenv("INSTALL_DIR", str(tmp_path / "empty"))
    monkeypatch.setenv("LIBTPU_SRC", str(tmp_path / "nothing"))
    monkeypatch.setattr(agents, "LIBCUDA", "libcuda-not-here.so.1")
    assert ragents.libtpu_install_main(["run", "--no-park"]) == 1
    assert agents.driver_install_main(["run", "--no-park"]) == 1
    assert not rbarrier.is_ready(".driver-ctr-ready")
    assert not barrier.is_ready(".driver-ctr-ready")


# --- gpu-driver-manager ------------------------------------------------------


def test_preflight_closes_every_gate(nvml):
    for b in (rbarrier, barrier):
        for name in b.KNOWN_STATUS_FILES:
            b.write_status(name, {"X": "1"})
    assert ragents.driver_manager_main(["preflight"]) == 0
    assert agents.main(["gpu-driver-manager", "preflight"]) == 0
    for b in (rbarrier, barrier):
        assert [n for n in b.KNOWN_STATUS_FILES if b.is_ready(n)] == []


# --- gpu-runtime-setup -------------------------------------------------------


def env_file(b):
    return dict(line.split("=", 1) for line in
                (b.validation_dir().parent / ("tpu-env" if b is rbarrier
                                              else "gpu-env"))
                .read_text().splitlines())


@pytest.mark.parametrize("pattern", [None, "/dev/accel[13]", "/dev/accel0"])
def test_runtime_setup_on_the_fake_host(nvml, monkeypatch, pattern):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "4")
    monkeypatch.setenv("TPU_TOPOLOGY", "2x2x1")
    monkeypatch.setenv("GPU_TOPOLOGY", "2x2x1")
    if pattern:
        monkeypatch.setenv("DEVICE_PATH_GLOB", pattern)
    assert ragents.runtime_setup_main(["run", "--no-park"]) == 0
    if pattern:
        monkeypatch.setenv("DEVICE_PATH_GLOB",
                           pattern.replace("accel", "nvidia"))
    assert agents.main(["gpu-runtime-setup", "verify"]) == 0
    ref, ours = env_file(rbarrier), env_file(barrier)
    assert ours == {
        "GPU_DEVICES": ref["TPU_DEVICES"].replace("accel", "nvidia"),
        "GPU_CONTROL_DEVICES": ",".join(plugin.CONTROL_NODES),
        "GPU_TOPOLOGY": ref["TPU_TOPOLOGY"]}


def test_device_glob_never_widens(nvml, monkeypatch):
    # a glob matching no card but a file on disk: the reference falls
    # back to the glob's matches, the port lists nothing and fails
    monkeypatch.setenv("TPU_FAKE_CHIPS", "2")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "2")
    monkeypatch.setenv("DEVICE_PATH_GLOB", "/dev/nul*")
    assert ragents.runtime_setup_main(["run", "--no-park"]) == 0
    assert env_file(rbarrier)["TPU_DEVICES"] == "/dev/null"
    assert agents.runtime_setup_main(["run", "--no-park"]) == 1


def test_runtime_verify_opens_the_nodes(nvml):
    # the fake NVML's cards are /dev/nvidia4 and /dev/nvidia5, which this
    # host lacks: run writes the contract, verify refuses it
    assert agents.runtime_setup_main(["run", "--no-park"]) == 0
    assert env_file(barrier)["GPU_DEVICES"] == "/dev/nvidia4,/dev/nvidia5"
    assert agents.runtime_setup_main(["verify"]) == 1


# --- the entry point ---------------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["nope"], ["libtpu-install", "run"]])
def test_main_refuses_an_unknown_agent(argv, capsys):
    assert agents.main(argv) == 2
    assert "gpu-driver-install" in capsys.readouterr().err


def test_main_dispatches_on_argv0(nvml, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["/usr/bin/gpu-driver-manager"])
    assert agents.main(["preflight"]) == 0


# --- the in-cluster client's node verbs -------------------------------------


class StubApiserver:
    """One Node: GET (the metadata alone under the PartialObjectMetadata
    Accept), the collection's GET (a ``labelSelector`` of key=value
    terms) and merge-PATCH; records method, path, Accept and
    Content-Type."""

    def __init__(self):
        self.node = {"apiVersion": "v1", "kind": "Node",
                     "metadata": {"name": "n0", "labels": {"a": "1"}},
                     "status": {"capacity": {"nvidia.com/gpu": "8"}}}
        self.requests = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                accept = self.headers.get("Accept")
                stub.requests.append(("GET", self.path, accept))
                url = urllib.parse.urlsplit(self.path)
                if url.path == "/api/v1/nodes":
                    query = urllib.parse.parse_qs(url.query)
                    terms = [t.split("=", 1) for t in ",".join(
                        query.get("labelSelector", [])).split(",") if t]
                    labels = stub.node["metadata"]["labels"]
                    items = [stub.node] if all(
                        labels.get(k) == v for k, v in terms) else []
                    return self._reply(200, {"kind": "NodeList",
                                             "items": items})
                if self.path != "/api/v1/nodes/n0":
                    return self._reply(404, {"reason": "NotFound"})
                if "as=PartialObjectMetadata" in accept:
                    return self._reply(200, {
                        "kind": "PartialObjectMetadata",
                        "metadata": stub.node["metadata"]})
                self._reply(200, stub.node)

            def do_PATCH(self):
                ctype = self.headers.get("Content-Type")
                patch = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                stub.requests.append(("PATCH", self.path, ctype))
                if self.path != "/api/v1/nodes/n0":
                    return self._reply(404, {"reason": "NotFound"})
                labels = stub.node["metadata"]["labels"]
                for k, v in patch["metadata"]["labels"].items():
                    if v is None:
                        labels.pop(k, None)
                    else:
                        labels[k] = v
                self._reply(200, stub.node)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def apiserver():
    stub = StubApiserver()
    yield stub
    stub.close()


def test_client_patch_and_metadata_only_get(apiserver):
    c = kubeclient.InClusterClient(apiserver.url)
    out = c.patch("v1", "Node", "n0", {"metadata": {"labels": {
        L.FENCING_STATE: "success", "a": None}}})
    assert out["metadata"]["labels"] == {L.FENCING_STATE: "success"}
    meta = c.get("v1", "Node", "n0", metadata_only=True)
    assert meta == {"kind": "PartialObjectMetadata",
                    "metadata": apiserver.node["metadata"]}
    assert "status" in c.get("v1", "Node", "n0")
    assert apiserver.requests == [
        ("PATCH", "/api/v1/nodes/n0", "application/merge-patch+json"),
        ("GET", "/api/v1/nodes/n0", kubeclient.InClusterClient
         .METADATA_ACCEPT),
        ("GET", "/api/v1/nodes/n0", "application/json")]
    with pytest.raises(kubeclient.NotFoundError):
        c.patch("v1", "Node", "gone", {"metadata": {"labels": {}}})


def test_node_config_selector_reads_one_label(apiserver, monkeypatch):
    monkeypatch.delenv("NODE_NAME", raising=False)
    assert agents._node_config_selector() is None
    monkeypatch.setenv("NODE_NAME", "n0")
    monkeypatch.setattr(kubeclient.InClusterClient, "from_env", classmethod(
        lambda cls: cls(apiserver.url)))
    selector = agents._node_config_selector()
    assert selector() is None
    apiserver.node["metadata"]["labels"][L.DEVICE_PLUGIN_CONFIG] = "gold"
    assert selector() == "gold"
    assert {r[2] for r in apiserver.requests} == {
        kubeclient.InClusterClient.METADATA_ACCEPT}


@pytest.mark.parametrize("selector, found", [
    (None, True), ({"a": "1"}, True), ({"a": "2"}, False),
    ({"a": "1", L.GPU_TOPOLOGY: "nvswitch-8"}, False),
])
def test_client_lists_nodes(apiserver, selector, found):
    c = kubeclient.InClusterClient(apiserver.url)
    items = c.list("v1", "Node", label_selector=selector)
    assert items == ([apiserver.node] if found else [])
    method, path, accept = apiserver.requests[-1]
    assert (method, accept) == ("GET", "application/json")
    if selector:
        query = urllib.parse.parse_qs(urllib.parse.urlsplit(path).query)
        assert query == {"labelSelector": [",".join(
            f"{k}={v}" for k, v in selector.items())]}
    else:
        assert path == "/api/v1/nodes"


def test_topology_manager_agent(nvml, apiserver, monkeypatch, tmp_path):
    """``gpu-topology-manager`` runs topology.manager.main: the node's
    profile from its label, the cards from NVML, the file where
    GPU_SLICE_FILE says, the state patched through the client."""
    from tpu_operator_torch.topology import manager

    config = tmp_path / "config.yaml"
    config.write_text("profiles:\n  split-2:\n    subslices: 2\n")
    monkeypatch.setenv("NODE_NAME", "n0")
    monkeypatch.setenv("CONFIG_FILE", str(config))
    monkeypatch.setenv("DEFAULT_PROFILE", "split-2")
    monkeypatch.setenv("GPU_SLICE_FILE", str(tmp_path / "slices.json"))
    monkeypatch.setattr(kubeclient.InClusterClient, "from_env", classmethod(
        lambda cls: cls(apiserver.url)))
    monkeypatch.setattr(manager.TopologyManager, "run_forever",
                        lambda self: self.apply_once())
    apiserver.node["metadata"]["labels"][L.GPU_CHIP_COUNT] = "2"
    assert agents.main(["gpu-topology-manager"]) == 0
    assert apiserver.node["metadata"]["labels"][L.SLICE_CONFIG_STATE] == \
        "success"
    assert manager.read_slice_file(str(tmp_path / "slices.json")) == {
        "profile": "split-2", "subslices": 2, "groups": [["gpu0"], ["gpu1"]]}

"""The port's device plugins (tpu_operator_torch.deviceplugin.plugin)
against the JAX package's, case for case: both served over gRPC on unix
sockets in temporary directories, registered with a fake kubelet, on one
fake host of four chips a side (TPU_FAKE_CHIPS / GPU_FAKE_CHIPS). The
device lists, preferred allocations and allocations are compared under
accel<i> -> gpu<i> and the allocation contract's map:

- a reference device node /dev/accel<i> -> the card's /dev/nvidia<minor>
  (minor = index on the fake host), followed by the control nodes;
- TPU_VISIBLE_CHIPS (indices) -> NVIDIA_VISIBLE_DEVICES (the cards'
  UUIDs); TPU_WORKLOAD_ISOLATION -> GPU_WORKLOAD_ISOLATION;
  TPU_HBM_LIMIT_MB -> GPU_MEM_LIMIT_MB; XLA_PYTHON_CLIENT_MEM_FRACTION=f
  -> PYTORCH_CUDA_ALLOC_CONF=per_process_memory_fraction:f;
- TPU_CHIPS_PER_PROCESS_BOUNDS and TPU_RUNTIME_METRICS_PORTS have no
  CUDA counterpart and are dropped."""

import json
import os
import pathlib
import shutil
import tempfile
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import grpc
import pytest

from tpu_operator.deviceplugin import api_pb2 as rpb
from tpu_operator.deviceplugin import plugin as rplugin
from tpu_operator.isolation import fencing as rfencing
from tpu_operator.isolation import vtpu as rvtpu
from tpu_operator_torch.deviceplugin import api_pb2 as pb
from tpu_operator_torch.deviceplugin import plugin
from tpu_operator_torch.isolation import fencing, vgpu

DROPPED_ENVS = ("TPU_CHIPS_PER_PROCESS_BOUNDS", "TPU_RUNTIME_METRICS_PORTS")


def port(value):
    if isinstance(value, str):
        return value.replace("accel", "gpu").replace("vtpu", "vgpu")
    if isinstance(value, (list, tuple)):
        return type(value)(port(v) for v in value)
    if isinstance(value, dict):
        return {port(k): port(v) for k, v in value.items()}
    return value


def port_contract(devices, envs):
    """A reference allocation (device host paths, envs) under the port's
    contract."""
    out_paths = [f"/dev/nvidia{p.removeprefix('/dev/accel')}"
                 for p in devices] + list(plugin.CONTROL_NODES)
    out = {}
    for k, v in envs.items():
        if k in DROPPED_ENVS:
            continue
        if k == "TPU_VISIBLE_CHIPS":
            out["NVIDIA_VISIBLE_DEVICES"] = ",".join(
                plugin.fake_uuid(int(i)) for i in v.split(","))
        elif k == "TPU_WORKLOAD_ISOLATION":
            out["GPU_WORKLOAD_ISOLATION"] = v
        elif k == "TPU_HBM_LIMIT_MB":
            out["GPU_MEM_LIMIT_MB"] = v
        elif k == "XLA_PYTHON_CLIENT_MEM_FRACTION":
            out["PYTORCH_CUDA_ALLOC_CONF"] = \
                f"per_process_memory_fraction:{v}"
        else:
            raise AssertionError(f"unmapped env {k}")
    return out_paths, out


class FakeKubelet:
    """kubelet's v1beta1.Registration on <dir>/kubelet.sock."""

    def __init__(self, socket_dir):
        self.registrations = []
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))

        def register(request, context):
            self.registrations.append(request)
            return pb.Empty()

        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler("v1beta1.Registration", {
                "Register": grpc.unary_unary_rpc_method_handler(
                    register,
                    request_deserializer=pb.RegisterRequest.FromString,
                    response_serializer=pb.Empty.SerializeToString)}),))
        self._server.add_insecure_port(
            f"unix://{os.path.join(socket_dir, 'kubelet.sock')}")
        self._server.start()

    def stop(self):
        self._server.stop(grace=0.2)


def call(p, method, req, req_cls, resp_cls):
    with grpc.insecure_channel(f"unix://{p.socket_path}") as ch:
        rpc = ch.unary_unary(
            f"/v1beta1.DevicePlugin/{method}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)
        return rpc(req, timeout=5)


def allocate(p, ids):
    req = rpb.AllocateRequest()
    req.container_requests.add(devicesIDs=list(ids))
    [c] = call(p, "Allocate", req, rpb.AllocateRequest,
               rpb.AllocateResponse).container_responses
    return [d.host_path for d in c.devices], dict(c.envs)


def listed(p):
    return [(d.ID, d.health) for d in p._devices]


@pytest.fixture
def host(monkeypatch):
    """A short temporary directory: a unix socket's path must fit in 108
    bytes, which pytest's per-test directories can exceed."""
    tmp_path = pathlib.Path(tempfile.mkdtemp(prefix="dp"))
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    env = {"TPU_FAKE_CHIPS": "4", "GPU_FAKE_CHIPS": "4",
           "TPU_FENCING_FILE": str(tmp_path / "ref" / "fencing.json"),
           "GPU_FENCING_FILE": str(tmp_path / "port" / "fencing.json"),
           "TPU_VTPU_FILE": str(tmp_path / "ref" / "vtpu-config.json"),
           "GPU_VGPU_FILE": str(tmp_path / "port" / "vgpu-config.json"),
           "TPU_SLICE_FILE": str(tmp_path / "ref" / "slices.json"),
           "GPU_SLICE_FILE": str(tmp_path / "port" / "slices.json")}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k in ("SHARING_REPLICAS", "TPU_HEALTH_ENGINE_INFO",
              "GPU_HEALTH_ENGINE_INFO", "TPU_PLUGIN_CONFIG_DIR",
              "GPU_PLUGIN_CONFIG_DIR", "TPU_PLUGIN_CONFIG_DEFAULT",
              "GPU_PLUGIN_CONFIG_DEFAULT", "TPU_PLUGIN_CONFIG_SELECT",
              "GPU_PLUGIN_CONFIG_SELECT"):
        monkeypatch.delenv(k, raising=False)
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def pair(host, shared=True, **kw):
    """(reference plugin, port plugin), each on its own socket directory."""
    if shared:
        return (rplugin.TPUDevicePlugin(socket_dir=str(host / "ref"), **kw),
                plugin.GpuDevicePlugin(socket_dir=str(host / "port"), **kw))
    return (rplugin.IsolatedTPUDevicePlugin(socket_dir=str(host / "ref"),
                                            **kw),
            plugin.IsolatedGpuDevicePlugin(socket_dir=str(host / "port"),
                                           **kw))


@pytest.fixture
def served(host):
    plugins = pair(host, health_interval_s=0.1)
    for p in plugins:
        p.start()
    yield plugins
    for p in plugins:
        p.stop()


# --- discovery --------------------------------------------------------------


@pytest.mark.parametrize("chips, replicas", [("4", None), ("2", "3"),
                                             ("1", "1"), ("3", "junk")])
def test_discover_devices(host, monkeypatch, chips, replicas):
    monkeypatch.setenv("TPU_FAKE_CHIPS", chips)
    monkeypatch.setenv("GPU_FAKE_CHIPS", chips)
    if replicas:
        monkeypatch.setenv("SHARING_REPLICAS", replicas)
    assert [(d.ID, d.health) for d in plugin.discover_devices()] == port(
        [(d.ID, d.health) for d in rplugin.discover_devices()])


def test_fake_inventory_names_cards_by_index_and_uuid(host):
    inv = plugin.card_inventory()
    assert [c.id for c in inv.cards] == plugin.discover_chips() == port(
        rplugin.discover_chips())
    assert [c.minor for c in inv.cards] == [0, 1, 2, 3]
    assert len({c.uuid for c in inv.cards}) == 4
    assert all(c.uuid.startswith("GPU-") for c in inv.cards)


def test_slice_groups_and_expansion(host):
    cfg = {"subslices": 2, "groups": [["accel0", "accel1"],
                                      ["accel2", "accel3"]]}
    (host / "ref" / "slices.json").write_text(json.dumps(cfg))
    (host / "port" / "slices.json").write_text(json.dumps(port(cfg)))
    assert plugin.slice_groups() == port(rplugin.slice_groups())
    assert [d.ID for d in plugin.discover_devices()] == ["slice0", "slice1"]
    ids = ["slice1", "accel0::r1", "accel0::r0"]
    assert plugin.expand_to_chips(port(ids)) == port(
        rplugin.expand_to_chips(ids))
    # a full profile (one subslice) advertises per card
    (host / "port" / "slices.json").write_text(json.dumps(
        {"subslices": 1, "groups": [["gpu0"]]}))
    assert plugin.slice_groups() is None


# --- the RPCs over gRPC -----------------------------------------------------


def test_options(served):
    for p in served:
        opts = call(p, "GetDevicePluginOptions", rpb.Empty(), rpb.Empty,
                    rpb.DevicePluginOptions)
        assert opts.get_preferred_allocation_available
        assert not opts.pre_start_required


def test_list_and_watch_and_a_vanished_unit(served):
    streams = []
    for p in served:
        ch = grpc.insecure_channel(f"unix://{p.socket_path}")
        rpc = ch.unary_stream(
            "/v1beta1.DevicePlugin/ListAndWatch",
            request_serializer=rpb.Empty.SerializeToString,
            response_deserializer=rpb.ListAndWatchResponse.FromString)
        streams.append((ch, rpc(rpb.Empty(), timeout=10)))

    def lists():
        return [[(d.ID, d.health) for d in next(s).devices]
                for _, s in streams]

    try:
        ref, ours = lists()
        assert ours == port(ref) and len(ours) == 4
        # two cards fall off the bus: advertised Unhealthy, not dropped
        os.environ["TPU_FAKE_CHIPS"] = os.environ["GPU_FAKE_CHIPS"] = "2"
        ref, ours = lists()
        assert ours == port(ref)
        assert dict(ours) == {"gpu0": "Healthy", "gpu1": "Healthy",
                              "gpu2": "Unhealthy", "gpu3": "Unhealthy"}
        os.environ["TPU_FAKE_CHIPS"] = os.environ["GPU_FAKE_CHIPS"] = "4"
        ref, ours = lists()
        assert ours == port(ref)
        assert all(h == "Healthy" for _, h in ours)
    finally:
        for ch, s in streams:
            s.cancel()
            ch.close()


@pytest.mark.parametrize("available, must, size", [
    (["accel3", "accel1", "accel0", "accel2"], [], 2),
    (["accel3", "accel1", "accel0", "accel2"], ["accel3"], 2),
    (["accel0::r0", "accel0::r1", "accel1::r0", "accel1::r1"], [], 2),
    (["accel1::r1", "accel0::r2", "accel2::rx"], [], 3),
    (["accel2"], [], 4),
])
def test_preferred_allocation(served, available, must, size):
    picks = []
    for p, ids in zip(served, (available, port(available))):
        req = rpb.PreferredAllocationRequest()
        req.container_requests.add(
            available_deviceIDs=ids,
            must_include_deviceIDs=must if p is served[0] else port(must),
            allocation_size=size)
        resp = call(p, "GetPreferredAllocation", req,
                    rpb.PreferredAllocationRequest,
                    rpb.PreferredAllocationResponse)
        picks.append(list(resp.container_responses[0].deviceIDs))
    assert picks[1] == port(picks[0])


@pytest.mark.parametrize("ids", [["accel0"], ["accel0", "accel1"],
                                 ["accel3", "accel1"]])
def test_allocate(served, ids):
    ref, ours = served
    assert allocate(ours, port(ids)) == port_contract(*allocate(ref, ids))
    assert ours.allocations == [{"devices": port(ids), "chips": port(ids)}]


def test_allocate_of_a_card_not_on_the_node_fails(served):
    # the reference hands out /dev/accel9 regardless; the port's
    # allocation names a card of its inventory or the RPC fails
    with pytest.raises(grpc.RpcError) as e:
        allocate(served[1], ["gpu9"])
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_register_with_kubelet(served, host):
    kubelets = [FakeKubelet(str(host / side)) for side in ("ref", "port")]
    try:
        for p in served:
            p.register_with_kubelet()
        [ref], [ours] = [k.registrations for k in kubelets]
        assert (ours.version, ours.resource_name, ours.endpoint) == (
            ref.version, "nvidia.com/gpu", "gpu-device-plugin.sock")
        assert (ref.resource_name, ref.endpoint) == (
            "google.com/tpu", "tpu-device-plugin.sock")
        assert ours.options.get_preferred_allocation_available
    finally:
        for k in kubelets:
            k.stop()


def wait_until(cond, limit_s=15.0):
    deadline = time.monotonic() + limit_s
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_serve_forever_rebinds_and_reregisters(host):
    """kubelet restarted: the plugin's socket is gone and kubelet.sock is
    new; the plugin re-binds first, then registers again."""
    kubelet = FakeKubelet(str(host / "port"))
    p = plugin.GpuDevicePlugin(socket_dir=str(host / "port"),
                               health_interval_s=3600)
    t = threading.Thread(target=p.serve_forever, kwargs={"poll_s": 0.05},
                         daemon=True)
    t.start()
    try:
        wait_until(lambda: kubelet.registrations)
        assert len(kubelet.registrations) == 1
        kubelet.stop()
        os.unlink(p.socket_path)
        (host / "port" / "kubelet.sock").unlink(missing_ok=True)
        kubelet = FakeKubelet(str(host / "port"))
        wait_until(lambda: kubelet.registrations
                   and os.path.exists(p.socket_path))
        assert len(kubelet.registrations) == 1
    finally:
        p.stop()
        t.join(timeout=10)
        kubelet.stop()
    assert not t.is_alive()


# --- sharing and the per-node config ---------------------------------------


def test_replicas_allocate_to_one_card(host, monkeypatch):
    monkeypatch.setenv("SHARING_REPLICAS", "2")
    plugins = pair(host)
    for p in plugins:
        p.start()
    try:
        ref, ours = plugins
        ids = ["accel0::r0", "accel0::r1"]
        assert allocate(ours, port(ids)) == port_contract(*allocate(ref, ids))
        assert listed(ours) == port(listed(ref))
    finally:
        for p in plugins:
            p.stop()


def configs(host):
    for side in ("ref", "port"):
        d = host / side / "configs"
        d.mkdir()
        (d / "standard").write_text("sharingPolicy: exclusive\n")
        (d / "gold").write_text(
            "sharingPolicy: time-shared\nsharingReplicas: 3\n")
        (d / "broken").write_text("sharingPolicy: mps\n")
    return str(host / "ref" / "configs"), str(host / "port" / "configs")


@pytest.mark.parametrize("default, selections", [
    ("standard", [None, "gold", None]),
    ("standard", ["gold", "broken", "no-such-config", "standard"]),
    ("gold", [None, "standard"]),
    (None, [None]),
], ids=["label-flip", "bad-configs-keep-last-good", "default-gold",
        "nothing-selected"])
def test_config_reload(host, monkeypatch, default, selections):
    monkeypatch.setenv("TPU_FAKE_CHIPS", "2")
    monkeypatch.setenv("GPU_FAKE_CHIPS", "2")
    dirs = configs(host)
    selected = {"name": None}
    ref, ours = (cls(socket_dir=str(host / side), config_dir=d,
                     default_config=default,
                     config_selector=lambda: selected["name"])
                 for cls, side, d in ((rplugin.TPUDevicePlugin, "ref",
                                       dirs[0]),
                                      (plugin.GpuDevicePlugin, "port",
                                       dirs[1])))
    for name in selections:
        selected["name"] = name
        ref.refresh_devices()
        ours.refresh_devices()
        assert listed(ours) == port(listed(ref))
        assert vars(ours.plugin_config or ref) == vars(ref.plugin_config
                                                       or ref)


def test_selector_failure_keeps_the_config(host):
    dirs = configs(host)
    state = {"fail": False}

    def flaky():
        if state["fail"]:
            raise RuntimeError("apiserver down")
        return "gold"

    ref, ours = (cls(socket_dir=str(host / side), config_dir=d,
                     default_config="standard", config_selector=flaky)
                 for cls, side, d in ((rplugin.TPUDevicePlugin, "ref",
                                       dirs[0]),
                                      (plugin.GpuDevicePlugin, "port",
                                       dirs[1])))
    for fail in (False, True):
        state["fail"] = fail
        ref.refresh_devices()
        ours.refresh_devices()
        assert listed(ours) == port(listed(ref))
        assert ours.plugin_config.name == "gold" and len(listed(ours)) == 12


def test_env_names_select_the_config(host, monkeypatch):
    dirs = configs(host)
    monkeypatch.setenv("TPU_PLUGIN_CONFIG_DIR", dirs[0])
    monkeypatch.setenv("GPU_PLUGIN_CONFIG_DIR", dirs[1])
    monkeypatch.setenv("TPU_PLUGIN_CONFIG_DEFAULT", "standard")
    monkeypatch.setenv("GPU_PLUGIN_CONFIG_DEFAULT", "standard")
    monkeypatch.setenv("TPU_PLUGIN_CONFIG_SELECT", "gold")
    monkeypatch.setenv("GPU_PLUGIN_CONFIG_SELECT", "gold")
    ref, ours = pair(host)
    ref.refresh_devices()
    ours.refresh_devices()
    assert listed(ours) == port(listed(ref)) and len(listed(ours)) == 12
    # a live ConfigMap update is seen by the next reload
    for d in dirs:
        with open(os.path.join(d, "gold"), "w") as f:
            f.write("sharingPolicy: time-shared\nsharingReplicas: 2\n")
    ref.refresh_devices()
    ours.refresh_devices()
    assert listed(ours) == port(listed(ref)) and len(listed(ours)) == 8


@pytest.mark.parametrize("text", ["sharingPolicy: time-shared\n"
                                  "sharingReplicas: 4\n",
                                  "sharingPolicy: exclusive\n"
                                  "sharingReplicas: 4\n",
                                  "sharingPolicy: mps\n",
                                  "sharingReplicas: many\n",
                                  "- a list\n", ""])
def test_parse_plugin_config(text):
    try:
        want = rplugin.parse_plugin_config("c", text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            plugin.parse_plugin_config("c", text)
        assert str(got.value) == str(e)
        return
    got = plugin.parse_plugin_config("c", text)
    assert vars(got) == vars(want)
    assert got.effective_replicas == want.effective_replicas


# --- per-device health ------------------------------------------------------


@pytest.mark.parametrize("verdicts, replicas", [
    ({"accel1": "fail"}, None), ({"accel0": "warn"}, None),
    ({"accel0": "fail"}, "2"), ({}, None),
    ({"accel0": "fail", "accel3": "fail"}, None)])
def test_health_verdicts(host, monkeypatch, verdicts, replicas):
    if replicas:
        monkeypatch.setenv("SHARING_REPLICAS", replicas)
    ref, ours = pair(host, health_source=lambda: dict(verdicts))
    ours.health_source = lambda: port(dict(verdicts))
    ref.refresh_devices()
    ours.refresh_devices()
    assert listed(ours) == port(listed(ref))


def test_health_from_one_engine(host, monkeypatch):
    """One stub engine answering 503 with per-card verdicts for both
    packages' IDs: the body of a 503 is the verdict, not an outage."""
    doc = {"status": "fail", "reasons": [], "chips": [
        {"chip_id": c, "status": s} for c, s in (
            ("accel0", "fail"), ("accel1", "ok"),
            ("gpu0", "fail"), ("gpu1", "ok"))]}

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(doc).encode()
            self.send_response(503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        info = f"127.0.0.1:{srv.server_address[1]}"
        monkeypatch.setenv("TPU_HEALTH_ENGINE_INFO", info)
        monkeypatch.setenv("GPU_HEALTH_ENGINE_INFO", info)
        ref, ours = pair(host)
        ref.refresh_devices()
        ours.refresh_devices()
        assert listed(ours) == port(listed(ref))
        assert dict(listed(ours))["gpu0"] == "Unhealthy"
        # an unreachable engine gives no verdicts: every card Healthy
        monkeypatch.setenv("TPU_HEALTH_ENGINE_INFO", "127.0.0.1:1")
        monkeypatch.setenv("GPU_HEALTH_ENGINE_INFO", "127.0.0.1:1")
        ref.refresh_devices()
        ours.refresh_devices()
        assert listed(ours) == port(listed(ref))
        assert all(h == "Healthy" for _, h in listed(ours))
    finally:
        srv.shutdown()
        srv.server_close()


def test_fenced_unit_leaves_without_going_unhealthy(host, monkeypatch):
    ref, ours = pair(host, health_source=lambda: {})
    for p in (ref, ours):
        p.refresh_devices()
    rfencing.write_fencing_file(os.environ["TPU_FENCING_FILE"], ["accel1"],
                                "accel1")
    fencing.write_fencing_file(os.environ["GPU_FENCING_FILE"], ["gpu1"],
                               "gpu1")
    monkeypatch.setenv("TPU_FAKE_CHIPS", "3")  # accel3 falls off the bus
    monkeypatch.setenv("GPU_FAKE_CHIPS", "3")
    for p in (ref, ours):
        p.refresh_devices()
    assert listed(ours) == port(listed(ref))
    assert listed(ours) == [("gpu0", "Healthy"), ("gpu2", "Healthy"),
                            ("gpu3", "Unhealthy")]


def test_shared_plugin_withdraws_stale_isolation_files(host):
    for side, inv in (("ref", "vtpu"), ("port", "vgpu")):
        (host / side / "fencing.json").write_text('{"fenced": []}')
        (host / side / f"{inv}-config.json").write_text("{}")
    iso = pair(host, shared=False)
    for p in iso:
        p._converge_node_regime()  # the fence belongs where it runs
    assert (host / "port" / "fencing.json").exists()
    for p in pair(host):
        p._converge_node_regime()
    for side, inv in (("ref", "vtpu"), ("port", "vgpu")):
        assert not (host / side / "fencing.json").exists()
        assert not (host / side / f"{inv}-config.json").exists()


# --- the isolated pool ------------------------------------------------------


def publish(host, fenced, vtpu_chips=None, n=2):
    rfencing.write_fencing_file(os.environ["TPU_FENCING_FILE"], fenced,
                                ",".join(fenced))
    fencing.write_fencing_file(os.environ["GPU_FENCING_FILE"], port(fenced),
                               port(",".join(fenced)))
    if vtpu_chips is None:
        return
    devs = rvtpu.build_vtpu_devices(vtpu_chips, rvtpu.VTPUProfile(
        f"vtpu-{n}", n), 16384)
    rvtpu.write_vtpu_file(os.environ["TPU_VTPU_FILE"],
                          rvtpu.VTPUProfile(f"vtpu-{n}", n), devs)
    vgpu.write_vgpu_file(os.environ["GPU_VGPU_FILE"],
                         vgpu.VGPUProfile(f"vgpu-{n}", n),
                         vgpu.build_vgpu_devices(port(vtpu_chips),
                                                 vgpu.VGPUProfile(
                                                     f"vgpu-{n}", n), 16384))


RESOURCES = {"google.com/tpu-isolated": "nvidia.com/gpu-isolated",
             "google.com/vtpu": "nvidia.com/vgpu"}


def test_isolated_pool_follows_the_fence_and_reregisters(host):
    iso = pair(host, shared=False, health_source=lambda: {})
    assert [RESOURCES[iso[0].resource_name]] == [iso[1].resource_name] == [
        "nvidia.com/gpu-isolated"]
    for p in iso:
        p.refresh_devices()
    assert listed(iso[1]) == listed(iso[0]) == []
    publish(host, ["accel0", "accel2"])
    for p in iso:
        p.refresh_devices()
    assert listed(iso[1]) == port(listed(iso[0])) == [
        ("gpu0", "Healthy"), ("gpu2", "Healthy")]
    publish(host, ["accel0", "accel2"], ["accel0", "accel2"])
    for p in iso:
        p.refresh_devices()
        assert p._reregister.is_set()
    assert RESOURCES[iso[0].resource_name] == iso[1].resource_name == \
        "nvidia.com/vgpu"
    assert listed(iso[1]) == port(listed(iso[0]))
    assert len(listed(iso[1])) == 4


@pytest.mark.parametrize("ids", [
    ["accel0-vtpu0"], ["accel0-vtpu0", "accel0-vtpu1"],
    ["accel0-vtpu0", "accel1-vtpu0", "accel1-vtpu1"],
    ["accel1-vtpu1", "accel0-vtpu0"]],
    ids=["half", "whole-card", "min-fraction", "order"])
def test_isolated_allocate_vgpus(host, ids):
    publish(host, ["accel0", "accel1"], ["accel0", "accel1"])
    iso = pair(host, shared=False)
    for p in iso:
        p.start()
    try:
        ref = port_contract(*allocate(iso[0], ids))
        assert allocate(iso[1], port(ids)) == ref
    finally:
        for p in iso:
            p.stop()


def test_isolated_allocate_whole_fenced_cards(host):
    publish(host, ["accel1", "accel3"])
    iso = pair(host, shared=False)
    for p in iso:
        p.start()
    try:
        ids = ["accel3", "accel1"]
        assert allocate(iso[1], port(ids)) == port_contract(
            *allocate(iso[0], ids))
    finally:
        for p in iso:
            p.stop()


@pytest.mark.parametrize("ids", [["accel0-vtpu7"], ["accel2"]],
                         ids=["withdrawn-vgpu", "unfenced-card"])
def test_isolated_allocate_not_found(host, ids):
    publish(host, ["accel0"], ["accel0"])
    iso = pair(host, shared=False)
    for p in iso:
        p.start()
    try:
        codes = []
        for p, want in zip(iso, (ids, port(ids))):
            with pytest.raises(grpc.RpcError) as e:
                allocate(p, want)
            codes.append(e.value.code())
        assert codes == [grpc.StatusCode.NOT_FOUND] * 2
    finally:
        for p in iso:
            p.stop()


def test_isolated_health_follows_the_backing_card(host):
    publish(host, ["accel0", "accel1"], ["accel0", "accel1"])
    ref, ours = pair(host, shared=False,
                     health_source=lambda: {"accel1": "fail"})
    ours.health_source = lambda: {"gpu1": "fail"}
    ref.refresh_devices()
    ours.refresh_devices()
    assert listed(ours) == port(listed(ref))
    assert dict(listed(ours))["gpu1-vgpu0"] == "Unhealthy"

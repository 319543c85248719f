"""The port's pod proofs (tpu_operator_torch.validator.workload) against
the JAX package's, both driven by the reference's in-memory apiserver
(``tpu_operator.runtime.fake.FakeClient``): a node that never advertises
its resource, a pod that goes Failed, and the success path with equal
barrier keys. Then the port's in-cluster client's verbs and its 404
mapping, against a stub apiserver on 127.0.0.1, and the CLI's dispatch
of ``plugin``, ``metrics`` and ``cuda --pod-mode``."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tpu_operator.runtime import FakeClient
from tpu_operator.validator import barrier as jax_barrier
from tpu_operator.validator import workload as jax_workload
from tpu_operator.validator.components import ValidationFailed as JaxFailed
from tpu_operator_torch.api import labels
from tpu_operator_torch.cli import validator as cli
from tpu_operator_torch.runtime import kubeclient
from tpu_operator_torch.validator import barrier, workload
from tpu_operator_torch.validator.components import ValidationFailed

NS = "gpu-operator"
# (reference, port): resource, plugin pod, matmul pod
RESOURCE = ("google.com/tpu", labels.GPU_RESOURCE)
PLUGIN_POD = ("tpu-plugin-validator", "gpu-plugin-validator")
MATMUL_POD = ("tpu-jax-validator-nores", "gpu-cuda-validator-nores")


@pytest.fixture
def valdirs(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_VALIDATION_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("GPU_VALIDATION_DIR", str(tmp_path / "port"))
    return tmp_path


def kubelet(client, phase):
    """The node's kubelet, at once: each pod the proof creates reaches
    ``phase`` before the proof's first poll. Returns the created pods."""
    created = []
    real_create = client.create

    def create(obj):
        out = real_create(obj)
        meta = obj["metadata"]
        client.simulate_pod_phase(meta["name"], meta["namespace"], phase)
        created.append(obj)
        return out

    client.create = create
    return created


def node_client(resource, count="4"):
    c = FakeClient()
    c.add_node("node-0", labels={}, allocatable={resource: count})
    return c


# --- the proofs against the reference's ------------------------------------


@pytest.mark.parametrize("side", [0, 1], ids=["jax", "port"])
def test_node_never_advertising_the_resource_fails(valdirs, side):
    c = FakeClient()
    c.add_node("bare-0")
    proof = (jax_workload.validate_plugin, workload.validate_plugin)[side]
    failed = (JaxFailed, ValidationFailed)[side]
    with pytest.raises(failed, match="never advertised " + RESOURCE[side]):
        proof(c, "bare-0", NS, "img", attempts=2, interval=0.01)
    assert not (jax_barrier, barrier)[side].is_ready("plugin-ready")


def test_a_node_advertising_only_the_tpu_fails_the_port(valdirs):
    c = node_client(RESOURCE[0])
    with pytest.raises(ValidationFailed, match="nvidia.com/gpu"):
        workload.validate_plugin(c, "node-0", NS, "img", attempts=2,
                                 interval=0.01)


@pytest.mark.parametrize("side", [0, 1], ids=["jax", "port"])
def test_failed_pod_fails_the_plugin_proof(valdirs, side):
    c = node_client(RESOURCE[side])
    created = kubelet(c, "Failed")
    proof = (jax_workload.validate_plugin, workload.validate_plugin)[side]
    failed = (JaxFailed, ValidationFailed)[side]
    with pytest.raises(failed, match=f"workload pod {PLUGIN_POD[side]} failed"):
        proof(c, "node-0", NS, "img", attempts=3, interval=0.01)
    assert [p["metadata"]["name"] for p in created] == [PLUGIN_POD[side]]
    # the failed pod was cleaned up and no barrier was written
    assert c.get_or_none("v1", "Pod", PLUGIN_POD[side], NS) is None
    assert not (jax_barrier, barrier)[side].is_ready("plugin-ready")


def test_plugin_success_writes_the_reference_keys(valdirs):
    infos, pods = [], []
    for side, proof in enumerate((jax_workload.validate_plugin,
                                  workload.validate_plugin)):
        c = node_client(RESOURCE[side])
        created = kubelet(c, "Succeeded")
        infos.append(proof(c, "node-0", NS, "img:1", attempts=3,
                           interval=0.01))
        assert c.get_or_none("v1", "Pod", PLUGIN_POD[side], NS) is None
        pods.append(created[0])
    assert infos[0] == infos[1] == {"ALLOCATABLE": "4",
                                    "WORKLOAD_PHASE": "Succeeded"}
    assert jax_barrier.read_status("plugin-ready") == \
        barrier.read_status("plugin-ready") == infos[1]
    ref, port = pods
    assert port["metadata"]["name"] == "gpu-plugin-validator"
    ref_c, port_c = ref["spec"]["containers"][0], port["spec"]["containers"][0]
    assert port_c["resources"] == {"limits": {labels.GPU_RESOURCE: "1"}}
    assert ref_c["resources"] == {"limits": {RESOURCE[0]: "1"}}
    assert port_c["command"] == ["python", "-m",
                                 "tpu_operator_torch.workloads.matmul"]
    assert port_c["env"] == ref_c["env"]
    assert port["spec"]["tolerations"][0]["key"] == labels.GPU_RESOURCE


def test_cuda_pod_success_writes_the_reference_keys(valdirs):
    infos = []
    for side, proof in enumerate((jax_workload.validate_jax_pod,
                                  workload.validate_cuda_pod)):
        c = node_client(RESOURCE[side])
        created = kubelet(c, "Succeeded")
        infos.append(proof(c, "node-0", NS, "img", matmul_size=2048))
        assert [p["metadata"]["name"] for p in created] == [MATMUL_POD[side]]
        assert c.get_or_none("v1", "Pod", MATMUL_POD[side], NS) is None
    assert infos[0] == infos[1] == {"WORKLOAD_PHASE": "Succeeded",
                                    "MATMUL_SIZE": "2048"}
    assert jax_barrier.read_status("jax-ready") == \
        barrier.read_status("cuda-ready") == infos[1]


def test_workload_pods_match_under_the_renames():
    ref = jax_workload.jax_workload_pod("ns", "n0", "img", matmul_size=1024,
                                        request_tpu=False)
    port = workload.cuda_workload_pod("ns", "n0", "img", matmul_size=1024,
                                      request_gpu=False)
    assert port["metadata"]["name"] == "gpu-cuda-validator-nores"
    assert port["metadata"]["labels"] == {"app": "gpu-cuda-validator"}
    assert port["spec"]["containers"][0]["name"] == "cuda-matmul"
    for k in ("restartPolicy", "nodeName"):
        assert port["spec"][k] == ref["spec"][k]
    assert port["spec"]["containers"][0]["env"] == \
        ref["spec"]["containers"][0]["env"] == [
            {"name": "MATMUL_SIZE", "value": "1024"}]
    assert port["spec"]["containers"][0]["resources"] == {}


@pytest.mark.parametrize("side", [0, 1], ids=["jax", "port"])
def test_pod_that_never_finishes_times_out(valdirs, side):
    c = node_client(RESOURCE[side])
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "wl", "namespace": "default"}, "spec": {}}
    spawn = (jax_workload.spawn_and_wait, workload.spawn_and_wait)[side]
    failed = (JaxFailed, ValidationFailed)[side]
    with pytest.raises(failed, match="did not reach"):
        spawn(c, pod, attempts=3, interval=0.01)
    assert c.get_or_none("v1", "Pod", "wl", "default") is None


def test_get_nested_is_the_references():
    from tpu_operator.runtime.objects import get_nested

    obj = {"a": {"b": {"c": 3}}, "x": 1}
    for path in (("a", "b", "c"), ("a", "b"), ("a", "z"), ("x", "y"), ()):
        assert workload.get_nested(obj, *path, default="d") == \
            get_nested(obj, *path, default="d")


# --- the in-cluster client against a stub apiserver ------------------------


class StubApiserver:
    """Pods in one dict; records each request's method, path and auth."""

    def __init__(self):
        self.objects = {}
        self.requests = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, body):
                raw = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _record(self):
                stub.requests.append((self.command, self.path,
                                      self.headers.get("Authorization")))

            def do_GET(self):
                self._record()
                if self.path in stub.objects:
                    self._reply(200, stub.objects[self.path])
                else:
                    self._reply(404, {"kind": "Status", "reason": "NotFound"})

            def do_POST(self):
                self._record()
                obj = json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))
                stub.objects[f"{self.path}/{obj['metadata']['name']}"] = obj
                self._reply(201, obj)

            def do_DELETE(self):
                self._record()
                if stub.objects.pop(self.path, None) is None:
                    self._reply(404, {"kind": "Status", "reason": "NotFound"})
                else:
                    self._reply(200, {"kind": "Status", "status": "Success"})

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def apiserver():
    stub = StubApiserver()
    yield stub
    stub.close()


def test_client_verbs_against_a_stub(apiserver, tmp_path):
    token = tmp_path / "token"
    token.write_text("t0\n")
    c = kubeclient.InClusterClient(apiserver.url, token_file=str(token),
                                   namespace="ns")
    pod = workload.cuda_workload_pod("ns", "n0", "img")
    c.create(pod)
    assert c.get("v1", "Pod", "gpu-cuda-validator")["spec"]["nodeName"] == "n0"
    apiserver.objects["/api/v1/nodes/n0"] = {"status": {"allocatable": {
        labels.GPU_RESOURCE: "8"}}}
    assert c.get("v1", "Node", "n0")["status"]["allocatable"] == {
        labels.GPU_RESOURCE: "8"}
    token.write_text("t1\n")  # a rotated token is read on the next request
    c.delete("v1", "Pod", "gpu-cuda-validator", "ns")
    assert [r[:2] for r in apiserver.requests] == [
        ("POST", "/api/v1/namespaces/ns/pods"),
        ("GET", "/api/v1/namespaces/ns/pods/gpu-cuda-validator"),
        ("GET", "/api/v1/nodes/n0"),
        ("DELETE", "/api/v1/namespaces/ns/pods/gpu-cuda-validator")]
    assert [r[2] for r in apiserver.requests] == ["Bearer t0"] * 3 + [
        "Bearer t1"]


def test_client_maps_404_to_not_found(apiserver):
    c = kubeclient.InClusterClient(apiserver.url, namespace="ns")
    with pytest.raises(kubeclient.NotFoundError) as e:
        c.get("v1", "Pod", "missing")
    assert e.value.code == 404
    assert c.get_or_none("v1", "Pod", "missing") is None
    with pytest.raises(kubeclient.NotFoundError):
        c.delete("v1", "Pod", "missing", "ns")
    with pytest.raises(ValueError, match="no verbs for kind"):
        c.get("v1", "ConfigMap", "x")


def test_proofs_run_on_the_client_against_a_stub(apiserver, valdirs):
    """spawn_and_wait's clean-up delete meets a 404 (nothing to clear)
    and the pod reads Succeeded: the port's client drives the proof."""
    c = kubeclient.InClusterClient(apiserver.url, namespace=NS)
    real_post = c.create

    def create(obj):
        out = real_post(obj)
        path = f"/api/v1/namespaces/{NS}/pods/{obj['metadata']['name']}"
        apiserver.objects[path] = dict(obj, status={"phase": "Succeeded"})
        return out

    c.create = create
    info = workload.validate_cuda_pod(c, "n0", NS, "img")
    assert info == {"WORKLOAD_PHASE": "Succeeded", "MATMUL_SIZE": "4096"}
    assert not apiserver.objects  # deleted after the wait
    assert barrier.read_status("cuda-ready") == info


def test_client_from_env_reads_the_service_account(tmp_path, monkeypatch):
    (tmp_path / "token").write_text("tok")
    (tmp_path / "namespace").write_text("ops\n")
    (tmp_path / "ca.crt").write_text("")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "fd00::1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "6443")
    monkeypatch.setattr(kubeclient.ssl, "create_default_context",
                        lambda cafile: ("ctx", cafile))
    c = kubeclient.InClusterClient.from_env(str(tmp_path))
    assert c.server == "https://[fd00::1]:6443"
    assert c.namespace == "ops"
    assert c.token_file == str(tmp_path / "token")
    assert c._ssl == ("ctx", str(tmp_path / "ca.crt"))
    assert c._url("v1", "Pod", "p", None) == \
        "https://[fd00::1]:6443/api/v1/namespaces/ops/pods/p"


# --- the CLI ----------------------------------------------------------------


@pytest.mark.parametrize("argv, want", [
    (["-c", "plugin"], ("plugin", False)),
    (["-c", "cuda", "--pod-mode"], ("cuda", True)),
    (["-c", "metrics"], ("metrics", False)),
])
def test_cli_parses_the_new_components(argv, want):
    args = cli.build_parser().parse_args(argv)
    assert (args.component, args.pod_mode) == want


@pytest.mark.parametrize("comp, proof", [
    (["-c", "plugin"], "validate_plugin"),
    (["-c", "cuda", "--pod-mode"], "validate_cuda_pod"),
])
def test_cli_dispatches_pod_proofs(valdirs, monkeypatch, comp, proof):
    calls = []
    monkeypatch.setattr(cli, "_client_and_identity",
                        lambda: ("client", "node-0", NS, "img"))
    monkeypatch.setattr(workload, proof,
                        lambda *a: calls.append(a) or {"OK": "1"})
    assert cli.main(comp) == 0
    assert calls == [("client", "node-0", NS, "img")]


def test_cli_pod_proof_failure_exits_1(valdirs, monkeypatch):
    def fail(*a):
        raise ValidationFailed("node node-0 never advertised nvidia.com/gpu")

    monkeypatch.setattr(cli, "_client_and_identity",
                        lambda: ("client", "node-0", NS, "img"))
    monkeypatch.setattr(workload, "validate_plugin", fail)
    assert cli.main(["-c", "plugin"]) == 1


def test_cli_identity_defaults(monkeypatch, tmp_path):
    for k in ("NODE_NAME", "OPERATOR_NAMESPACE", "VALIDATOR_IMAGE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(kubeclient.InClusterClient, "from_env",
                        classmethod(lambda cls: "in-cluster"))
    assert cli._client_and_identity() == (
        "in-cluster", "", "gpu-operator",
        "ghcr.io/gpu-operator/gpu-validator:latest")


def test_cli_metrics_serves_on_metrics_port(valdirs, monkeypatch):
    served = []
    from tpu_operator_torch.validator import metrics

    def fake_serve(port, node_name=""):
        served.append((port, node_name))

    def stop(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(metrics, "serve", fake_serve)
    monkeypatch.setattr(cli.time, "sleep", stop)
    monkeypatch.setenv("NODE_NAME", "node-0")
    monkeypatch.delenv("METRICS_PORT", raising=False)
    assert cli.main(["-c", "metrics"]) == 130
    assert served == [(9401, "node-0")]

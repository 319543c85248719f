"""``evict`` in the port against the reference: the client-side
PodDisruptionBudget check every ``FakeClient`` inherits (a budget with no
disruptions left blocks with ``EvictionBlockedError``, a 429; headroom,
percentages, ``maxUnavailable``, the controller-maintained
``disruptionsAllowed`` and ``matchExpressions`` selectors; a missing pod
is a 404), each scenario on each package's own ``FakeClient``; and
``HTTPClient.evict`` against a stub apiserver: the request each client
sent and the 429 surfaced as ``EvictionBlockedError``, once, not retried
as throttling."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tpu_operator.runtime import client as rclient
from tpu_operator.runtime import kubeclient as rkube
from tpu_operator.runtime.fake import FakeClient as RFake
from tpu_operator_torch import runtime as port_runtime
from tpu_operator_torch.runtime import client
from tpu_operator_torch.runtime import kubeclient as kube
from tpu_operator_torch.runtime.fake import FakeClient

SIDES = {"reference": (RFake, rclient, rkube), "port": (FakeClient, client,
                                                        kube)}


def pod(name, labels, ready=True, node="n0", deleting=False):
    meta = {"name": name, "namespace": "default", "labels": labels}
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
            "spec": {"nodeName": node, "containers": [{"name": "c"}]},
            "status": {"phase": "Running", "conditions": [
                {"type": "Ready", "status": "True" if ready else "False"}]}}


def pdb(selector, status=None, **spec):
    out = {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
           "metadata": {"name": "guard", "namespace": "default"},
           "spec": {"selector": selector, **spec}}
    if status is not None:
        out["status"] = status
    return out


APP = {"matchLabels": {"app": "a"}}
# scenario -> (pods, budgets, the pod evicted)
SCENARIOS = {
    "no budget": ([pod("p0", {"app": "a"})], [], "p0"),
    "min available blocks": ([pod("p0", {"app": "a"})],
                             [pdb(APP, minAvailable=1)], "p0"),
    "min available headroom": (
        [pod("p0", {"app": "a"}), pod("p1", {"app": "a"}, node="n1")],
        [pdb(APP, minAvailable=1)], "p0"),
    "unready replica gives no headroom": (
        [pod("p0", {"app": "a"}), pod("p1", {"app": "a"}, ready=False)],
        [pdb(APP, minAvailable=1)], "p0"),
    "terminating replica is not counted": (
        [pod("p0", {"app": "a"}), pod("p1", {"app": "a"}, deleting=True)],
        [pdb(APP, minAvailable=1)], "p0"),
    "percentage rounds up": (
        [pod(f"p{i}", {"app": "a"}) for i in range(3)],
        [pdb(APP, minAvailable="50%")], "p0"),
    "percentage headroom": (
        [pod(f"p{i}", {"app": "a"}) for i in range(4)],
        [pdb(APP, minAvailable="50%")], "p0"),
    "max unavailable zero": ([pod("p0", {"app": "a"})],
                             [pdb(APP, maxUnavailable=0)], "p0"),
    "max unavailable spent": (
        [pod("p0", {"app": "a"}), pod("p1", {"app": "a"}, ready=False)],
        [pdb(APP, maxUnavailable=1)], "p0"),
    "max unavailable headroom": ([pod("p0", {"app": "a"})],
                                 [pdb(APP, maxUnavailable=1)], "p0"),
    "status says none allowed": (
        [pod("p0", {"app": "a"}), pod("p1", {"app": "a"})],
        [pdb(APP, {"disruptionsAllowed": 0}, minAvailable=1)], "p0"),
    "status says one allowed": (
        [pod("p0", {"app": "a"})],
        [pdb(APP, {"disruptionsAllowed": 1}, minAvailable=1)], "p0"),
    "empty budget spec allows one": ([pod("p0", {"app": "a"})],
                                     [pdb(APP)], "p0"),
    "other selector": ([pod("p0", {"app": "b"})],
                       [pdb(APP, minAvailable=1)], "p0"),
    "match expressions In": (
        [pod("p0", {"app": "a"})],
        [pdb({"matchExpressions": [{"key": "app", "operator": "In",
                                    "values": ["a", "x"]}]},
             minAvailable=1)], "p0"),
    "match expressions NotIn": (
        [pod("p0", {"app": "a"})],
        [pdb({"matchExpressions": [{"key": "app", "operator": "NotIn",
                                    "values": ["a"]}]},
             minAvailable=1)], "p0"),
    "match expressions Exists with labels": (
        [pod("p0", {"app": "a", "tier": "t"})],
        [pdb({"matchLabels": {"tier": "t"}, "matchExpressions": [
            {"key": "app", "operator": "Exists"}]}, minAvailable=1)], "p0"),
    "missing pod": ([pod("p0", {"app": "a"})], [], "absent"),
}


def evict_outcome(side, scenario):
    fake_cls, mod, _ = SIDES[side]
    pods, budgets, victim = SCENARIOS[scenario]
    c = fake_cls()
    for obj in pods + budgets:
        c.create(json.loads(json.dumps(obj)))
    try:
        c.evict(victim, "default")
        outcome = ["evicted"]
    except mod.EvictionBlockedError as e:
        outcome = ["blocked", e.code, str(e)]
    except mod.NotFoundError as e:
        outcome = ["not found", e.code]
    left = sorted(p["metadata"]["name"] for p in c.list("v1", "Pod"))
    return outcome, left


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_evict_agrees(scenario):
    ref = evict_outcome("reference", scenario)
    port = evict_outcome("port", scenario)
    assert port == ref


def test_evict_outcomes():
    """The scenarios say what they are named for."""
    assert evict_outcome("port", "min available blocks")[0][:2] == [
        "blocked", 429]
    assert evict_outcome("port", "min available headroom") == (
        ["evicted"], ["p1"])
    assert evict_outcome("port", "match expressions In")[0][0] == "blocked"
    assert evict_outcome("port", "match expressions NotIn")[0] == ["evicted"]
    assert evict_outcome("port", "missing pod")[0] == ["not found", 404]


def test_eviction_blocked_error_exported():
    assert port_runtime.EvictionBlockedError is client.EvictionBlockedError
    assert issubclass(client.EvictionBlockedError, client.ApiError)
    assert client.EvictionBlockedError.code == 429


class EvictionStub:
    """An apiserver that answers the pods/eviction subresource: each
    POST recorded (path, headers that matter, body), then the status
    queued for it (201 by default)."""

    def __init__(self, statuses=()):
        self.seen = []
        self.statuses = list(statuses)
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                stub.seen.append([
                    self.path, self.headers.get("Content-Type"),
                    self.headers.get("Authorization"), json.loads(body)])
                code = stub.statuses.pop(0) if stub.statuses else 201
                if code == 429:
                    reply = {"kind": "Status", "reason": "TooManyRequests",
                             "message": "Cannot evict pod as it would "
                                        "violate the pod's disruption "
                                        "budget."}
                elif code == 404:
                    reply = {"kind": "Status", "reason": "NotFound"}
                else:
                    reply = {"kind": "Status", "status": "Success"}
                data = json.dumps(reply).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if code == 429:
                    self.send_header("Retry-After", "0")
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def http_evictions(side):
    """Three evictions against a fresh stub: accepted, blocked (429),
    missing (404); what the server saw and what each call gave."""
    _, mod, kmod = SIDES[side]
    stub = EvictionStub([201, 429, 404])
    c = kmod.HTTPClient(kmod.KubeConfig(server=stub.url, token="t",
                                        namespace="ops"))
    out = []
    try:
        for name, ns in (("a", "default"), ("b", None), ("c", "default")):
            try:
                c.evict(name, ns)
                out.append("evicted")
            except mod.EvictionBlockedError as e:
                out.append(["blocked", e.code, "disruption budget" in str(e)])
            except mod.NotFoundError as e:
                out.append(["not found", e.code])
    finally:
        c.close()
        stub.stop()
    return out, stub.seen


def test_http_evict_agrees():
    ref = http_evictions("reference")
    port = http_evictions("port")
    assert port == ref
    outcomes, seen = port
    assert outcomes == ["evicted", ["blocked", 429, True], ["not found", 404]]
    # one POST a call: the 429 is the budget's answer, not throttling
    assert [s[0] for s in seen] == [
        "/api/v1/namespaces/default/pods/a/eviction",
        "/api/v1/namespaces/ops/pods/b/eviction",
        "/api/v1/namespaces/default/pods/c/eviction"]
    assert seen[1][3] == {"apiVersion": "policy/v1", "kind": "Eviction",
                          "metadata": {"name": "b", "namespace": "ops"}}
    assert all(s[1] == "application/json" and s[2] == "Bearer t"
               for s in seen)

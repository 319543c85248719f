"""The port's operator over HTTP, as its e2e tiers drive it: the
``tests/mock_apiserver.py`` apiserver, GPU nodes mapped one to one from
the reference's tier (a GKE H100 host of 4 cards on an ``nvswitch-4``
fabric for a ``tpu-v5p-slice`` ``2x2x1`` host), the Manager wired as
``gpu-operator`` wires it (``cli.operator.wire_manager``: the
GPUClusterPolicy, GPUDriver, upgrade and placement reconcilers), and a
kubelet ticked through a second ``HTTPClient``. The counterparts of the
reference's helpers in ``tests/test_http_e2e.py`` (``tpu_node``,
``wait_for``, ``cr_state``, ``install``, ``update_spec``)."""

from __future__ import annotations

import contextlib
import time

import pytest

from conftest import load_factor
from mock_apiserver import MockApiServer
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.clusterpolicy import (KIND_CLUSTER_POLICY, V1,
                                                  new_cluster_policy)
from tpu_operator_torch.cli.operator import build_parser, wire_manager
from tpu_operator_torch.runtime.client import ConflictError
from tpu_operator_torch.runtime.fake import simulate_kubelet
from tpu_operator_torch.runtime.kubeclient import HTTPClient, KubeConfig
from tpu_operator_torch.runtime.objects import get_nested

NS = "gpu-operator"
POLICY = "gpu-cluster-policy"
DEVICE_PLUGIN_DS = "gpu-device-plugin-daemonset"
DRIVER_DS = "gpu-driver-daemonset"
EXPORTER_DS = "gpu-metrics-exporter"
DRIVER_COMPONENT = {"gpu.graft.dev/component": "gpu-driver"}


def gpu_node(name, topology="nvswitch-4"):
    """A GKE H100 host of 4 cards, the reference tier's 4-chip host."""
    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": {"name": name, "labels": {
            L.GKE_ACCELERATOR: "nvidia-h100-80gb",
            L.GPU_TOPOLOGY: topology,
            L.GKE_ACCELERATOR_COUNT: "4"}},
        "spec": {},
        "status": {"allocatable": {L.GPU_RESOURCE: "4"},
                   "capacity": {L.GPU_RESOURCE: "4"},
                   "nodeInfo": {"containerRuntimeVersion":
                                "containerd://1.7.0"},
                   "conditions": [{"type": "Ready", "status": "True"}]},
    }


@pytest.fixture(autouse=True)
def operator_globals():
    """``wire_manager`` sets the process-wide tracer and the spec-hash and
    DAG gates from its flags; each test leaves them as it found them."""
    from tpu_operator_torch.runtime.client import SPEC_HASH_GATE
    from tpu_operator_torch.runtime.tracing import TRACER
    from tpu_operator_torch.state.scheduler import DAG_GATE

    saved = (TRACER.enabled, SPEC_HASH_GATE.enabled, DAG_GATE.enabled)
    yield
    TRACER.enabled, SPEC_HASH_GATE.enabled, DAG_GATE.enabled = saved


def config(srv, token="e2e-token"):
    return KubeConfig(server=srv.url, token=token, namespace=NS)


def boot(srv, cache=False):
    """The Manager over its own ``HTTPClient`` as ``gpu-operator`` wires
    it, started: read-through (``--no-cache``) as the reference's tier
    runs its Manager on the raw client, or over the informer cache, the
    default. Returns (manager, client)."""
    client = HTTPClient(config(srv, "op"))
    mgr = wire_manager(client, build_parser().parse_args(
        [] if cache else ["--no-cache"]), snapshot_dir="")
    mgr.start()
    return mgr, client


def shutdown(mgr, client):
    mgr.stop()
    client.close()


@contextlib.contextmanager
def cluster():
    """(server, ops client) with the whole operator running over HTTP,
    read-through, on two GPU nodes."""
    srv = MockApiServer().start()
    ops = HTTPClient(config(srv))
    for i in range(2):
        ops.create(gpu_node(f"gpu-{i}"))
    mgr, client = boot(srv)
    try:
        yield srv, ops
    finally:
        shutdown(mgr, client)
        ops.close()
        srv.stop()


def wait_for(ops, pred, desc, timeout=60.0):
    """Wait for ``pred`` while ticking the HTTP kubelet; ``pred`` runs
    every pass even when the tick loses a write race."""
    end = time.time() + timeout * load_factor()
    kubelet_err = None
    pred_err = None
    while time.time() < end:
        try:
            simulate_kubelet(ops, ready=True)
        except Exception as e:  # transient races while converging
            kubelet_err = e
        try:
            if pred():
                return
        except Exception as e:
            pred_err = e
        time.sleep(0.25)
    raise AssertionError(f"timed out waiting for {desc} "
                         f"(kubelet error: {kubelet_err}; "
                         f"pred error: {pred_err})")


def cr_state(ops):
    cr = ops.get_or_none(V1, KIND_CLUSTER_POLICY, POLICY)
    return ((cr or {}).get("status") or {}).get("state")


def install(ops, spec=None):
    ops.create(new_cluster_policy(spec=spec or {}))


def update_spec(ops, mutate):
    """Read-modify-write the CR spec with conflict retry, to a deadline."""
    from tpu_operator_torch.runtime.objects import thaw_obj

    end = time.time() + 10.0 * load_factor()
    last = None
    while time.time() < end:
        cr = thaw_obj(ops.get(V1, KIND_CLUSTER_POLICY, POLICY))
        mutate(cr.setdefault("spec", {}))
        try:
            ops.update(cr)
            return
        except ConflictError as e:  # anything else (e.g. a 422) is final
            last = e
            time.sleep(0.1)
    raise AssertionError(f"could not update CR (last error: {last})")


def plugin_env(ops):
    ds = ops.get_or_none("apps/v1", "DaemonSet", DEVICE_PLUGIN_DS, NS)
    return get_nested(ds or {}, "spec", "template", "spec", "containers",
                      default=[{}])[0].get("env") or []


def env_present(ops, name):
    return lambda: any(e.get("name") == name for e in plugin_env(ops))


def set_plugin_env(name, value="1"):
    return lambda spec: spec.setdefault("devicePlugin", {}).update(
        {"env": [{"name": name, "value": value}]})


def daemonset_rvs(ops):
    from tpu_operator_torch.runtime.client import ListOptions

    return {d["metadata"]["name"]: d["metadata"]["resourceVersion"]
            for d in ops.list("apps/v1", "DaemonSet",
                              ListOptions(namespace=NS))}


class Answers:
    """Every answer a ``MockApiServer`` gives, as (method, path, code,
    the policy's ``status.state`` where a write answered it)."""

    def __init__(self, srv):
        self.entries = []
        handler = srv.http.RequestHandlerClass  # this server's own class
        send = handler._send

        def _send(h, code, doc):
            state = None
            if h.command in ("PUT", "PATCH") and code == 200 and \
                    "clusterpolicies/" in h.path:
                state = (doc.get("status") or {}).get("state")
            self.entries.append((h.command, h.path.split("?")[0], code,
                                 state))
            return send(h, code, doc)

        handler._send = _send

    def take(self) -> list:
        entries, self.entries = self.entries, []
        return entries

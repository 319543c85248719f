"""The whole operator over HTTP: the port's Manager, on its
``HTTPClient``, drives its GPUClusterPolicy to ``ready`` beside the
reference's Manager on the reference's client, each over its own
``tests/mock_apiserver.py`` with its package's simulated kubelet ticking
through a second client. The two are held to the same state changes as
each package's TIMELINE records them (a poll of the status could miss
one). Both read through to the apiserver, as the
reference's HTTP e2e tier does: over an HTTP client the informer cache
has a start-up race, kept by the port and pinned here in both packages
(ROADMAP C5)."""

import concurrent.futures
import time

import pytest

from mock_apiserver import MockApiServer

from conftest import load_factor
from tpu_operator.api.clusterpolicy import KIND_CLUSTER_POLICY as RKIND
from tpu_operator.api.clusterpolicy import V1 as RV1
from tpu_operator.api.clusterpolicy import new_cluster_policy as rnew
from tpu_operator.controllers.clusterpolicy_controller import (
    ClusterPolicyReconciler as RReconciler)
from tpu_operator.runtime import Manager as RManager
from tpu_operator.runtime import TracingClient as RTracing
from tpu_operator.runtime import cache as rcache
from tpu_operator.runtime import kubeclient as rkube
from tpu_operator.runtime import timeline as rtl
from tpu_operator.runtime.fake import simulate_kubelet as rkubelet
from tpu_operator.runtime.kubeclient import HTTPClient as RHTTP
from tpu_operator.runtime.kubeclient import KubeConfig as RConfig
from tpu_operator_torch.api.clusterpolicy import (KIND_CLUSTER_POLICY, V1,
                                                  new_cluster_policy)
from tpu_operator_torch.cli.operator import build_parser, wire_manager
from tpu_operator_torch.runtime import cache, kubeclient, timeline
from tpu_operator_torch.runtime.fake import simulate_kubelet
from tpu_operator_torch.runtime.kubeclient import HTTPClient, KubeConfig

NS = "gpu-operator"


def node(res, labels):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "accel-0", "labels": labels}, "spec": {},
            "status": {"allocatable": {res: "4"}, "capacity": {res: "4"},
                       "nodeInfo": {"containerRuntimeVersion":
                                    "containerd://1.7.0"},
                       "conditions": [{"type": "Ready", "status": "True"}]}}


@pytest.fixture()
def state_changes(monkeypatch):
    """Every state change each package's TIMELINE records, in order, as
    (name, from, to): a spy on ``record``, so the ring's bound of 64
    events a key cannot drop the first of them."""
    seen = {True: [], False: []}
    for ref, tlm in ((True, rtl.TIMELINE), (False, timeline.TIMELINE)):
        def spy(kind, name, event, detail=None, causes=(),
                _record=tlm.record, _seen=seen[ref]):
            if event == "state":
                _seen.append((name, detail["from"], detail["to"]))
            _record(kind, name, event, detail, causes)

        monkeypatch.setattr(tlm, "enabled", True)
        monkeypatch.setattr(tlm, "record", spy)
    return seen


def run_operator(ref: bool) -> dict:
    srv = MockApiServer().start()
    if ref:
        cfg = RConfig(server=srv.url, token="t", namespace="tpu-operator")
        ops, inner = RHTTP(config=cfg), RHTTP(config=cfg)
        ops.create(node("google.com/tpu", {
            "cloud.google.com/gke-tpu-accelerator": "tpu-v5p-slice",
            "cloud.google.com/gke-tpu-topology": "2x2x1"}))
        # read-through, as the reference's HTTP e2e runs: over HTTP the
        # cache has the start-up race pinned below
        api = RTracing(inner)
        mgr = RManager(api, namespace="tpu-operator", snapshot_dir="")
        mgr.add_reconciler(RReconciler(client=api, namespace="tpu-operator"),
                           workers=2)
        v1, kind, name = RV1, RKIND, "tpu-cluster-policy"
        tick, policy = rkubelet, rnew()
    else:
        cfg = KubeConfig(server=srv.url, token="t", namespace=NS)
        ops, inner = HTTPClient(cfg), HTTPClient(cfg)
        ops.create(node("nvidia.com/gpu", {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}))
        mgr = wire_manager(inner, build_parser().parse_args(
            ["--workers", "2", "--no-cache"]), snapshot_dir="")
        v1, kind, name = V1, KIND_CLUSTER_POLICY, "gpu-cluster-policy"
        tick, policy = simulate_kubelet, new_cluster_policy()
    mgr.start()
    try:
        t0 = time.monotonic()
        ops.create(policy)
        state = None
        deadline = time.monotonic() + 30.0 * load_factor()
        while time.monotonic() < deadline:
            cr = ops.get(v1, kind, name)
            state = (cr.get("status") or {}).get("state")
            if state == "ready":
                break
            try:  # the kubelet marks whatever DaemonSets exist by now
                tick(ops, ready=True)
            except Exception:  # a write race with the operator
                pass
            time.sleep(0.3)
        seconds = time.monotonic() - t0
        dss = sorted(d["metadata"]["name"]
                     for d in ops.list("apps/v1", "DaemonSet"))
        return {"state": state, "seconds": seconds,
                "daemonsets": dss, "cached": mgr.find_cache() is not None,
                "reconciles": mgr.controllers[0].reconcile_total}
    finally:
        mgr.stop()
        ops.close() if not ref else ops._stop.set()
        srv.stop()


def test_manager_over_http_reaches_ready_beside_the_reference(state_changes):
    import torch_naming as N

    # side by side: the reference's read-through passes take seconds each
    # over requests, the port's a fraction of one
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(run_operator, (True, False))
    assert ref["state"] == port["state"] == "ready"
    changes = [(N.name(n), a, b) for n, a, b in state_changes[True]]
    assert changes == state_changes[False] == [
        ("gpu-cluster-policy", "new", "notReady"),
        ("gpu-cluster-policy", "notReady", "ready")]
    assert sorted(N.name(d) for d in ref["daemonsets"]) == port["daemonsets"]
    assert port["reconciles"] >= 2 and not port["cached"]


@pytest.mark.parametrize("ref", [True, False], ids=["reference", "port"])
def test_cache_over_http_serves_not_found_before_its_list_lands(ref):
    """C5, kept: the informer's first list runs in its watch thread, so a
    read right after subscribing finds an empty store even though the
    object exists. A controller whose own watch stream delivers first
    reconciles a NotFound and drops the key."""
    kube, cache_mod = (rkube, rcache) if ref else (kubeclient, cache)
    srv = MockApiServer().start()
    cfg = kube.KubeConfig(server=srv.url, token="t", namespace=NS)
    inner = kube.HTTPClient(cfg)
    inner.create({"apiVersion": "v1", "kind": "ConfigMap",
                  "metadata": {"name": "there", "namespace": NS}})
    slow = inner._list_raw

    def late_list(*a, **kw):  # the informer's list, a beat late
        time.sleep(0.3)
        return slow(*a, **kw)

    inner._list_raw = late_list
    c = cache_mod.CachedClient(inner)
    try:
        with pytest.raises(Exception) as err:
            c.get("v1", "ConfigMap", "there", NS)
        assert type(err.value).__name__ == "NotFoundError"
        deadline = time.monotonic() + 10.0 * load_factor()
        while time.monotonic() < deadline:
            if c.get_or_none("v1", "ConfigMap", "there", NS) is not None:
                break
            time.sleep(0.05)
        assert c.get("v1", "ConfigMap", "there", NS)["metadata"]["name"] \
            == "there"
    finally:
        c.close()
        (inner.close if not ref else inner._stop.set)()
        srv.stop()

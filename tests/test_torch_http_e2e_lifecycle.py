"""The port's operator over a real HTTP apiserver: the lifecycle half of
the reference's HTTP e2e tier (``tests/test_http_e2e.py``,
``TestHTTPLifecycle``). The Manager is wired as ``gpu-operator`` wires it
(all four reconcilers, ``--no-cache``: read-through, as the reference's
tier runs its Manager on the raw client) over its ``HTTPClient`` against
``tests/mock_apiserver.py``; the kubelet is ticked through a second
client. No FakeClient appears here.

The install-to-uninstall test runs the reference's tier beside the port
and holds the two to the same state changes, as each package's TIMELINE
records them, and the same DaemonSets under ``tests/torch_naming.py``."""

import concurrent.futures
import time

import pytest

import torch_naming as N
from conftest import load_factor
from torch_http_e2e import (DEVICE_PLUGIN_DS, DRIVER_COMPONENT, DRIVER_DS,
                            EXPORTER_DS, NS, POLICY, cluster, cr_state,
                            env_present, install,
                            operator_globals,  # noqa: F401
                            set_plugin_env, update_spec, wait_for)
from tpu_operator_torch.api import labels as L
from tpu_operator_torch.api.clusterpolicy import KIND_CLUSTER_POLICY, V1
from tpu_operator_torch.controllers.upgrade_controller import STATE_DONE
from tpu_operator_torch.runtime.client import ListOptions
from tpu_operator_torch.runtime.objects import get_nested, labels_of


@pytest.fixture()
def state_changes(monkeypatch):
    """Every state change each package's TIMELINE records, in order, as
    (name, from, to): a spy on ``record``."""
    from tpu_operator.runtime import timeline as rtl
    from tpu_operator_torch.runtime import timeline

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


def reference_lifecycle(seen: list) -> dict:
    """The reference's ``test_install_to_ready_and_uninstall``, on its own
    fixture's Manager (three reconcilers on the raw client)."""
    import test_http_e2e as R
    from tpu_operator.api import KIND_CLUSTER_POLICY as RKIND
    from tpu_operator.api import V1 as RV1
    from tpu_operator.api import labels as RL
    from tpu_operator.controllers.clusterpolicy_controller import (
        ClusterPolicyReconciler)
    from tpu_operator.controllers.tpudriver_controller import (
        TPUDriverReconciler)
    from tpu_operator.controllers.upgrade_controller import UpgradeReconciler
    from tpu_operator.runtime.kubeclient import HTTPClient, KubeConfig
    from tpu_operator.runtime.manager import Manager

    srv = R.MockApiServer().start()
    cfg = KubeConfig(server=srv.url, token="e2e-token", namespace=R.NS)
    ops, client = HTTPClient(config=cfg), HTTPClient(config=cfg)
    for i in range(2):
        ops.create(R.tpu_node(f"tpu-{i}"))
    mgr = Manager(client, namespace=R.NS)
    for rec in (ClusterPolicyReconciler, TPUDriverReconciler,
                UpgradeReconciler):
        mgr.add_reconciler(rec(client, namespace=R.NS))
    mgr.start()
    try:
        R.install(ops)
        R.wait_for(ops, lambda: R.cr_state(ops) == "ready",
                   "ClusterPolicy ready over HTTP")
        cr = ops.get(RV1, RKIND, "tpu-cluster-policy")
        node = labels_of(ops.get("v1", "Node", "tpu-0"))
        out = {"facts": cr["status"]["clusterInfo"],
               "daemonsets": sorted(d["metadata"]["name"] for d in
                                    ops.list("apps/v1", "DaemonSet")),
               "present": node.get(RL.TPU_PRESENT),
               "deploy": node.get(RL.deploy_label("tpu-device-plugin")),
               "changes": list(seen)}
        ops.delete(RV1, RKIND, "tpu-cluster-policy")
        R.wait_for(ops, lambda: not ops.list("apps/v1", "DaemonSet"),
                   "owned DaemonSets garbage-collected")
        return out
    finally:
        mgr.stop()
        ops._stop.set()
        client._stop.set()
        srv.stop()


def port_lifecycle(seen: list) -> dict:
    from tpu_operator_torch.metrics.operator_metrics import OPERATOR_METRICS

    OPERATOR_METRICS.install_to_ready.clear()
    with cluster() as (srv, ops):
        t_install = time.time()
        install(ops)
        wait_for(ops, lambda: cr_state(ops) == "ready",
                 "GPUClusterPolicy ready over HTTP")
        elapsed = time.time() - t_install
        # the status write lands a beat before the gauge is set
        gauge = OPERATOR_METRICS.install_to_ready.labels(policy=POLICY)
        deadline = time.time() + 10.0 * load_factor()
        while gauge._value.get() == 0 and time.time() < deadline:
            time.sleep(0.1)
        cr = ops.get(V1, KIND_CLUSTER_POLICY, POLICY)
        node = labels_of(ops.get("v1", "Node", "gpu-0"))
        out = {"facts": cr["status"]["clusterInfo"], "elapsed": elapsed,
               "gauge": gauge._value.get(),
               "daemonsets": sorted(d["metadata"]["name"] for d in
                                    ops.list("apps/v1", "DaemonSet")),
               "present": node.get(L.PRESENT),
               "deploy": node.get(L.deploy_label("gpu-device-plugin")),
               "changes": list(seen)}
        # uninstall: deleting the CR cascades to every owned object
        ops.delete(V1, KIND_CLUSTER_POLICY, POLICY)
        wait_for(ops, lambda: not ops.list("apps/v1", "DaemonSet"),
                 "owned DaemonSets garbage-collected")
        return out


def test_install_to_ready_and_uninstall_beside_the_reference(state_changes):
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref_job = pool.submit(reference_lifecycle, state_changes[True])
        port = port_lifecycle(state_changes[False])
        ref = ref_job.result()
    # the reference's budget: install to all-operands-ready in 5 minutes
    # (gpu_operator_test.go:83-88), and the gauge records it
    assert port["elapsed"] < 300.0
    assert 0 < port["gauge"] < 300.0
    facts = port["facts"]
    assert facts["containerRuntime"] == ref["facts"]["containerRuntime"] \
        == "containerd"
    assert facts["gpuTopologies"] == {"nvswitch-4": 2}
    assert ref["facts"]["tpuTopologies"] == {"2x2x1": 2}
    assert facts["gpuGenerations"] == {"h100-sxm": 2}
    assert "v5p" in ref["facts"]["tpuGenerations"]
    assert DEVICE_PLUGIN_DS in port["daemonsets"]
    assert DRIVER_DS in port["daemonsets"]
    assert sorted(N.name(d) for d in ref["daemonsets"]) == port["daemonsets"]
    assert port["present"] == ref["present"] == "true"
    assert port["deploy"] == ref["deploy"] == "true"
    # up to the uninstall: a reconcile in flight while the cascade deletes
    # the operands may record ready -> notReady in either package
    changes = [(N.name(n), a, b) for n, a, b in ref["changes"]]
    assert changes == port["changes"] == [(POLICY, "new", "notReady"),
                                          (POLICY, "notReady", "ready")]


def test_mutation_propagates_through_watch():
    with cluster() as (srv, ops):
        install(ops)
        wait_for(ops, lambda: cr_state(ops) == "ready", "initial ready")
        update_spec(ops, set_plugin_env("E2E_PROBE", "on"))
        wait_for(ops, env_present(ops, "E2E_PROBE"),
                 "CR mutation re-rendered the DS")


def test_disable_then_enable_operand():
    with cluster() as (srv, ops):
        install(ops)
        wait_for(ops, lambda: cr_state(ops) == "ready", "initial ready")
        update_spec(ops, lambda spec: spec.setdefault(
            "metricsExporter", {}).update({"enabled": False}))
        wait_for(ops, lambda: ops.get_or_none(
            "apps/v1", "DaemonSet", EXPORTER_DS, NS) is None,
            "disabled operand deleted")
        update_spec(ops, lambda spec: spec.setdefault(
            "metricsExporter", {}).update({"enabled": True}))
        wait_for(ops, lambda: ops.get_or_none(
            "apps/v1", "DaemonSet", EXPORTER_DS, NS) is not None,
            "re-enabled operand recreated")


def test_rolling_upgrade_over_http():
    with cluster() as (srv, ops):
        install(ops, spec={"upgradePolicy": {"autoUpgrade": True,
                                             "maxParallelUpgrades": 1}})
        wait_for(ops, lambda: cr_state(ops) == "ready", "initial ready")
        wait_for(ops, lambda: len(ops.list("v1", "Pod", ListOptions(
            namespace=NS, label_selector=DRIVER_COMPONENT))) == 2,
            "driver pods on both nodes")
        update_spec(ops, lambda spec: spec.update(
            {"driver": {"installDir": "/opt/e2e-new"}}))

        def all_upgraded():
            nodes = ops.list("v1", "Node")
            return all(labels_of(n).get(L.UPGRADE_STATE) == STATE_DONE
                       for n in nodes) and not any(
                get_nested(n, "spec", "unschedulable", default=False)
                for n in nodes)

        wait_for(ops, all_upgraded, "rolling upgrade completed over HTTP",
                 timeout=120.0)


def test_watch_reconnect_still_drives_reconcile():
    with cluster() as (srv, ops):
        install(ops)
        wait_for(ops, lambda: cr_state(ops) == "ready", "initial ready")
        # kill every open watch stream; clients must resume and re-watch
        srv.drop_watch_streams()
        update_spec(ops, set_plugin_env("AFTER_RECONNECT"))
        wait_for(ops, env_present(ops, "AFTER_RECONNECT"),
                 "reconcile resumed after watch streams dropped")

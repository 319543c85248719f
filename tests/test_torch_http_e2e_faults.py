"""The port's operator over HTTP under faults: the fault half of the
reference's HTTP e2e tier (``tests/test_http_e2e.py:268-563``) with the
reference's assertions. Leader failover over the apiserver's Lease, a
409 storm in the middle of a reconcile (every injected conflict
consumed), a watch resuming across a dropped stream by resourceVersion
replay, ``/metrics`` and ``/debug/traces`` scraped while reconciles run,
and ``/debug/traces?outcome=error`` returning a failing reconciler's
traces."""

import json
import threading
import time
import urllib.error
import urllib.request

from conftest import load_factor
from mock_apiserver import MockApiServer
from torch_http_e2e import (NS, cluster, config, cr_state,
                            env_present, gpu_node, install,
                            operator_globals,  # noqa: F401
                            set_plugin_env, update_spec, wait_for)
from tpu_operator_torch.api.clusterpolicy import new_cluster_policy
from tpu_operator_torch.cli.operator import build_parser, wire_manager
from tpu_operator_torch.runtime.kubeclient import HTTPClient, KubeConfig
from tpu_operator_torch.runtime.manager import Manager, Reconciler


def test_leader_election_failover_over_http():
    """Two electors on the HTTP apiserver's Lease: one wins; when it stops
    (releasing the Lease) the standby takes over, and the operator keeps
    converging (gpu-operator --leader-elect)."""
    from tpu_operator_torch.runtime.leaderelection import LeaderElector

    with cluster() as (srv, ops):
        events = []
        electors = []
        for ident in ("op-a", "op-b"):
            electors.append(LeaderElector(
                HTTPClient(KubeConfig(server=srv.url, token="t",
                                      namespace=NS)),
                identity=ident, lease_duration_s=2.0, renew_interval_s=0.2,
                on_started_leading=lambda i=ident: events.append(i)))
        try:
            electors[0].start()
            deadline = time.time() + 20
            while time.time() < deadline and not electors[0].is_leader:
                time.sleep(0.1)
            assert electors[0].is_leader
            electors[1].start()
            time.sleep(1.0)
            assert not electors[1].is_leader  # the Lease is op-a's
            # the leader steps down (releases): the standby takes over
            electors[0].stop()
            deadline = time.time() + 20
            while time.time() < deadline and not electors[1].is_leader:
                time.sleep(0.1)
            electors[1].stop()
        finally:
            for el in electors:
                el.stop()
                el.client.close()
        assert events == ["op-a", "op-b"]
        # the operator itself kept working throughout the handoff
        install(ops)
        wait_for(ops, lambda: cr_state(ops) == "ready",
                 "converged across leadership handoff")


def test_mid_reconcile_conflict_is_retried():
    with cluster() as (srv, ops):
        install(ops)
        wait_for(ops, lambda: cr_state(ops) == "ready", "initial ready")
        # the operator's next writes bounce with 409; the workqueue must
        # retry until the mutation lands
        srv.fail_next_writes = 5
        update_spec(ops, set_plugin_env("AFTER_CONFLICT"))
        wait_for(ops, env_present(ops, "AFTER_CONFLICT"),
                 "mutation applied despite 409s")
        assert srv.fail_next_writes == 0  # the injected conflicts were hit


def test_watch_resume_replays_events_missed_during_drop():
    """A watch resumes across a forced stream drop: a mutation made while
    it was disconnected arrives by resourceVersion replay, with no second
    list."""
    srv = MockApiServer().start()
    client = HTTPClient(KubeConfig(server=srv.url, token="t",
                                   namespace="default"))
    try:
        path = "/api/v1/namespaces/default/configmaps/cm1"
        srv.put_object(path, {"apiVersion": "v1", "kind": "ConfigMap",
                              "metadata": {"name": "cm1",
                                           "namespace": "default"},
                              "data": {"k": "v0"}})
        got = []
        seen_v1 = threading.Event()

        def handler(evt):
            got.append((evt.type, (evt.obj.get("data") or {}).get("k")))
            if (evt.obj.get("data") or {}).get("k") == "v1":
                seen_v1.set()

        unsub = client.watch("v1", "ConfigMap", handler)
        try:
            deadline = time.monotonic() + 10
            while not got and time.monotonic() < deadline:
                time.sleep(0.05)
            assert got and got[0][0] == "ADDED"
            # kill every stream, mutate while nobody is connected
            srv.drop_watch_streams()
            srv.put_object(path, {"apiVersion": "v1", "kind": "ConfigMap",
                                  "metadata": {"name": "cm1",
                                               "namespace": "default"},
                                  "data": {"k": "v1"}}, event="MODIFIED")
            assert seen_v1.wait(15), f"events: {got}"
        finally:
            unsub()
        # resumed, not re-listed: exactly one ADDED ever
        assert [e for e in got if e[0] == "ADDED"] == [("ADDED", "v0")]
        assert ("MODIFIED", "v1") in got
    finally:
        client.close()
        srv.stop()


def http_get(port, path, timeout=10.0):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout) as resp:
        return resp.status, resp.read()


def test_concurrent_scrapes_during_active_reconciles():
    """``/metrics`` and ``/debug/traces`` scraped from three threads while
    the manager reconciles: no 500s, the exposition parses, the traces
    parse. As in the reference, the apiserver side is a FakeClient (the
    HTTP surface under test is the manager's own server) and node-label
    churn drives a steady stream of real reconciles."""
    from prometheus_client.parser import text_string_to_metric_families

    from tpu_operator_torch.runtime import FakeClient

    fake = FakeClient()
    for i in range(2):
        fake.create(gpu_node(f"gpu-{i}"))
    # port 0: the OS picks an ephemeral port
    mgr = wire_manager(fake, build_parser().parse_args(
        ["--no-cache", "--health-port", "0"]), snapshot_dir="")
    mgr.start()
    port = mgr._http.server_address[1]
    try:
        fake.create(new_cluster_policy())
        failures = []
        stop = threading.Event()

        def scrape(path, check):
            while not stop.is_set():
                try:
                    status, body = http_get(port, path)
                    if status != 200:
                        failures.append((path, status))
                    else:
                        check(body)
                except Exception as e:
                    failures.append((path, repr(e)))
                time.sleep(0.02)  # concurrent, not adversarial

        def check_metrics(body):
            assert list(text_string_to_metric_families(body.decode()))

        def check_traces(body):
            doc = json.loads(body)
            assert doc["count"] == len(doc["traces"])

        threads = [threading.Thread(target=scrape, args=a) for a in (
            ("/metrics", check_metrics),
            ("/debug/traces", check_traces),
            ("/debug/traces?min_ms=0.1&limit=5", check_traces))]
        for t in threads:
            t.start()

        def traced_count():
            _, body = http_get(port,
                               "/debug/traces?controller=gpuclusterpolicy")
            return json.loads(body)["count"]

        try:
            fake.simulate_kubelet(ready=True)
            deadline = time.time() + 30.0 * load_factor()
            tick = 0
            while traced_count() < 3 and time.time() < deadline:
                # label churn: a watch event, another live reconcile
                fake.patch("v1", "Node", "gpu-0", {"metadata": {
                    "labels": {"e2e-tick": str(tick)}}})
                tick += 1
                time.sleep(0.05)
            assert traced_count() >= 3, "reconciles never got traced"
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10.0)
        assert not failures, failures[:5]
        status, body = http_get(port,
                                "/debug/traces?controller=gpuclusterpolicy")
        doc = json.loads(body)
        assert doc["count"] > 0
        root = doc["traces"][0]["root"]
        assert root["name"] == "reconcile"
        assert root["children"], "no child spans in a worker trace"
        # a bad filter value is a 400, not a 500
        try:
            http_get(port, "/debug/traces?min_ms=bogus")
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        mgr.stop()


def test_debug_traces_outcome_error_returns_failed_reconciles():
    """A reconciler that always raises leaves error traces, each carrying
    the exception; ``outcome=error`` returns only those."""
    from tpu_operator_torch.runtime.tracing import TRACER

    class BoomReconciler(Reconciler):
        name = "boom"

        def __init__(self, client):
            self.client = client

        def reconcile(self, request):
            raise RuntimeError("injected reconcile failure")

        def setup_controller(self, controller, manager):
            controller.watch("v1", "ConfigMap")

    srv = MockApiServer().start()
    TRACER.enabled = True
    ops = HTTPClient(config(srv))
    mgr_client = HTTPClient(config(srv))
    mgr = Manager(mgr_client, namespace=NS, health_port=0)
    ctrl = mgr.add_reconciler(BoomReconciler(mgr_client))
    mgr.start()
    port = mgr._http.server_address[1]
    try:
        ops.create({"apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": "trigger", "namespace": NS},
                    "data": {}})
        deadline = time.time() + 30.0 * load_factor()
        while ctrl.reconcile_errors < 3 and time.time() < deadline:
            time.sleep(0.05)
        errors_seen = ctrl.reconcile_errors
        assert errors_seen >= 3, "reconciler never failed"
        _, body = http_get(port, "/debug/traces?outcome=error&controller=boom")
        doc = json.loads(body)
        # every failed reconcile so far is pinned and returned
        assert doc["count"] >= min(errors_seen, 3)
        for tr in doc["traces"]:
            assert tr["outcome"] == "error"
            assert tr["controller"] == "boom"
            assert "injected reconcile failure" in tr["error"]
        _, body = http_get(port, "/debug/traces?outcome=ok&controller=boom")
        assert json.loads(body)["count"] == 0
    finally:
        mgr.stop()
        mgr_client.close()
        ops.close()
        srv.stop()

